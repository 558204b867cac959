"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Each CUDA kernel is held against its plain PyTorch version on the card
(lo/hi atol 1e-5, pushes and translations atol 1e-4, normals atol 1e-5,
integer outputs exact; the fused and single-substep kernels' poses and
stashes atol 1e-4, velocities atol 1e-3, and two launches on one input
bit-identical; the single-substep kernel's node launch (integrate, solve,
joints, writeback) bit for bit its plain version, with live joints and
with work past its shared window, the node one device op;
the fused kernel's options (contact refresh, sleep, the in-kernel
broadphase, persistent manifolds) likewise, their integer outputs exact
and the manifold cache and AABBs atol 1e-4; the world flags kernel equal
to its plain version, and kernel 9's launch with the cache and anchors
updated in place bit for bit;
the render kernel's hit mask exact, depth and float rgb atol 1e-5, a
repeat bit-identical), and the collisions, simple_jobs, rigid_bench (also
its settled pile) and simple_taskgraph slices on the card against the
same slices on the CPU (plain versions), positions atol 1e-4.
"""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch.core.state import entity_rows
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem

from test_torch_joint_scenes import joint_world, random_joints


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    sk.fused_simple_jobs_step.launches = 0
    subk.FusedSubstepKernel.launches = 0
    subk.SubstepKernel.launches = 0
    subk.WorldFlags.launches = 0
    subk.AsleepSurface.launches = 0
    rk.RenderKernel.launches = 0
    return torch.device("cuda")


def inputs(seed, W, n, half, dead, dev):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (W, n, 3)).astype(np.float32)
    q = rng.normal(size=(W, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((W, n), bool)
    mask[:, n - dead:] = False
    return (torch.from_numpy(pos).to(dev), torch.from_numpy(q).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("W,n", [(64, 108), (3, 300)])
def test_fused_collisions_step_matches_plain(card, W, n):
    pos, rot, mask = inputs(7, W, n, 10.0, 8, card)
    delta, lo, hi = ck.fused_collisions_step(pos, rot, mask)
    torch.cuda.synchronize()
    assert ck.fused_collisions_step.launches == 1
    plo, phi = ck.aabb_plain(pos, rot)
    torch.testing.assert_close(lo, plo, atol=1e-5, rtol=0)
    torch.testing.assert_close(hi, phi, atol=1e-5, rtol=0)
    want = ck.pushes_plain(pos, lo, hi, mask, center=False)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W,n,tile", [(64, 108, 0), (4, 700, 32), (2, 1500, 1024)])
def test_collision_pushes_matches_plain(card, W, n, tile):
    pos, _, mask = inputs(9, W, n, n ** (1 / 3) * 2.0, 5, card)
    lo, hi = pos - 1.0, pos + 1.0
    delta = ck.collision_pushes(pos, lo, hi, mask, force_tile=tile)
    torch.cuda.synchronize()
    assert ck.collision_pushes.launches == 1
    want = ck.collision_pushes_plain(pos, lo, hi, mask)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()


@pytest.mark.cuda
def test_wrappers_reject_bad_input(card):
    pos, rot, mask = inputs(1, 2, 16, 3.0, 2, card)
    with pytest.raises(ValueError):
        ck.fused_collisions_step(pos.double(), rot, mask)
    with pytest.raises(ValueError):
        ck.collision_pushes(pos.transpose(0, 1).contiguous().transpose(0, 1),
                            pos - 1, pos + 1, mask)
    with pytest.raises(ValueError):
        ck.collision_pushes(pos, pos - 1, pos + 1, mask.cpu())
    assert ck.collision_pushes.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused,use_kernel", [(True, False), (False, True), (False, False)],
                         ids=["fused", "pushes", "gram"])
def test_slice_on_card_matches_cpu(card, fused, use_kernel):
    """Five steps of the collisions slice on the card and on the CPU from
    the same state; kernel launches = steps on the card."""
    cfg = col.CollisionsConfig(num_worlds=8, num_objects=40, max_pairs=512, seed=5,
                               fused=fused, use_kernel=use_kernel)
    cpu = col.make_executor(cfg, device="cpu")
    gpu = col.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(5):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    launches = ck.fused_collisions_step.launches + ck.collision_pushes.launches
    assert launches == (5 if (fused or use_kernel) else 0)
    a, b = state_to_numpy(cpu.state), state_to_numpy(gpu.state)
    got = b["arch"]["CubeObject"]["comps"]["Translation"]["value"]
    want = a["arch"]["CubeObject"]["comps"]["Translation"]["value"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for name in ("CubeObject", "CollisionCandidate", "Contact"):
        np.testing.assert_array_equal(b["overflow"][name], a["overflow"][name])
        np.testing.assert_array_equal(b["arch"][name]["mask"], a["arch"][name]["mask"])


def sj_inputs(seed, W, n0, half, dev):
    """Bodies around the middle of the simple_jobs bounds, some outside
    them (the kernel clamps)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (W, n0, 3)).astype(np.float32)
    pos[..., 2] += 5.0
    q = rng.normal(size=(W, n0, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return torch.from_numpy(pos).to(dev), torch.from_numpy(q).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("W,n0,K,D,half", [(64, 100, 1600, 32, 10.0), (3, 37, 128, 4, 4.0),
                                           (2, 1000, 4096, 32, 11.0)],
                         ids=["main", "cap_and_truncation", "near_bound"])
def test_fused_simple_jobs_step_matches_plain(card, W, n0, K, D, half):
    pos, rot = sj_inputs(3, W, n0, half, card)
    bounds = (sj.BOUNDS_LO, sj.BOUNDS_HI)
    got = sk.fused_simple_jobs_step(pos, rot, n0=n0, K=K, degree_cap=D, bounds=bounds)
    torch.cuda.synchronize()
    assert sk.fused_simple_jobs_step.launches == 1
    want = sk.fused_simple_jobs_step_plain(pos, rot, n0=n0, K=K, degree_cap=D, bounds=bounds)
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "lo": 1e-5, "hi": 1e-5, "normals": 1e-5}
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in atol:
            torch.testing.assert_close(g, w, atol=atol[name], rtol=0, msg=name)
            assert torch.isfinite(g).all(), name
        else:
            assert torch.equal(g, w), name
    assert int(want[5].sum()) > 0
    if D == 4:
        assert (want[6] > 0).any() and (want[5] > K).any()


@pytest.mark.cuda
def test_simple_jobs_wrapper_rejects_bad_input(card):
    pos, rot = sj_inputs(1, 2, 16, 3.0, card)
    kw = dict(n0=16, K=64, degree_cap=8, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    with pytest.raises(ValueError):
        sk.fused_simple_jobs_step(pos.double(), rot, **kw)
    with pytest.raises(ValueError):
        sk.fused_simple_jobs_step(pos, rot.cpu(), **kw)
    with pytest.raises(ValueError):
        sk.fused_simple_jobs_step(pos, rot[:, :, :3].contiguous(), **kw)
    with pytest.raises(ValueError):
        sk.fused_simple_jobs_step(pos.transpose(0, 1).contiguous().transpose(0, 1), rot, **kw)
    assert sk.fused_simple_jobs_step.launches == 0


@pytest.mark.cuda
def test_simple_jobs_on_card_matches_cpu(card):
    """Five fused steps on the card (the kernel) and on the CPU (its plain
    version) from the same state; one launch a step."""
    cfg = sj.SimpleJobsConfig(num_worlds=8, num_objects=40, max_pairs=512, seed=5,
                              fused=True)
    cpu = sj.make_executor(cfg, device="cpu")
    gpu = sj.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(5):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    assert sk.fused_simple_jobs_step.launches == 5
    a, b = state_to_numpy(cpu.state)["user"], state_to_numpy(gpu.state)["user"]
    for key in ("candidates", "contacts_ab", "num_candidates", "num_contacts"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    np.testing.assert_allclose(b["translation"], a["translation"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(b["contacts_normal"], a["contacts_normal"], atol=1e-4, rtol=0)


def fused_inputs(sim):
    """The fused substep kernel's inputs for sim's next step."""
    return RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body, rb.RigidBenchWorld.objmgr)


POSE_KEYS = ("pos", "rot", "prev_pos", "prev_rot", "ps_pos", "ps_rot")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 128])
def test_fused_substep_matches_plain(card, K):
    """The kernel against its plain version at a mid-pile state (the
    K > 128 and K <= 128 TPU routes), and bit-identical when repeated."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=64, contact_mode="pallas",
                                               max_candidates=K, spawn_xy=4.0, spawn_h=6.0,
                                               seed=3), device="cuda")
    sim.run(3)
    kw = fused_inputs(sim)
    assert int(kw["kvalid"].sum()) > 64
    kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    subk.FusedSubstepKernel.launches = 0
    got, again = kern(**kw), kern(**kw)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    want = subk.fused_substep_plain(**kw, tables=kern.tables, num_substeps=4, relaxation=0.7)
    for k in subk.OUT_KEYS:
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), k
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-4 if k in POSE_KEYS else 1e-3, msg=k)
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
def test_fused_substep_rejects_bad_input(card):
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=2, num_bodies=8, contact_mode="pallas"),
                           device="cuda")
    kw = fused_inputs(sim)
    kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4)
    args = dict(kw, tables=kern.tables, num_substeps=4)
    with pytest.raises(ValueError):
        subk.fused_substep(**dict(args, pos=kw["pos"].double()))
    with pytest.raises(ValueError):
        subk.fused_substep(**dict(args, rows_i=kw["rows_i"].cpu()))
    om = dict(rb.RigidBenchWorld.objmgr)
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    with pytest.raises(NotImplementedError, match="general-hull"):
        subk.fused_substep(**dict(args, tables=subk.pk.ObjTables(om)))
    assert subk.FusedSubstepKernel.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 1000])
def test_substep_matches_plain(card, K):
    """The single-substep kernel against its plain version at a mid-pile
    state, and bit-identical when repeated."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=64, contact_mode="pallas",
                                               max_candidates=K, spawn_xy=4.0, spawn_h=6.0,
                                               seed=3), device="cuda")
    sim.run(3)
    a = RigidBodyPhysicsSystem.substep_kernel_inputs(fused_inputs(sim))
    assert int(a["kvalid"].sum()) > 64
    tables = subk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    got, again = (subk.substep(**a, tables=tables, relaxation=0.7) for _ in range(2))
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 2
    want = subk.substep_plain(**a, tables=tables, relaxation=0.7)
    for k in subk.SUBSTEP_KEYS:
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), k
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-4 if k in POSE_KEYS else 1e-3, msg=k)
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
def test_substep_rejects_bad_input(card):
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=2, num_bodies=8, contact_mode="pallas"),
                           device="cuda")
    a = RigidBodyPhysicsSystem.substep_kernel_inputs(fused_inputs(sim))
    args = dict(a, tables=subk.pk.ObjTables(rb.RigidBenchWorld.objmgr))
    with pytest.raises(ValueError):
        subk.substep(**dict(args, prev_rot=a["prev_rot"].double()))
    with pytest.raises(ValueError):
        subk.substep(**dict(args, kvalid=a["kvalid"].cpu()))
    om = dict(rb.RigidBenchWorld.objmgr)
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    with pytest.raises(NotImplementedError, match="general-hull"):
        subk.substep(**dict(args, tables=subk.pk.ObjTables(om)))
    assert subk.SubstepKernel.launches == 0


def node_case(case, dev):
    """(SubstepKernel, node inputs) of kernel 5's node launch: "stg",
    simple_taskgraph's state (100 spheres, K = 1000, 64 dead joint rows,
    dead body rows); "joints", the joint world (live Fixed and Hinge
    joints, static bodies); "overflow", simple_taskgraph's state with all
    1000 slots of world 0 valid (every pair of its rows in order: past the
    shared window, so the global scratch is used) and every other slot of
    world 1; "random_joints", simple_taskgraph's state with random live
    Fixed and Hinge joints (several on one body and side, a null handle, a
    handle into another archetype: test_torch_joint_scenes.random_joints)."""
    if case == "joints":
        sim = joint_world("pallas", num_worlds=8, device=dev)
        sim.run(5)
        arch = sim.world_cls.Body
    else:
        sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=8, num_objects=100, seed=3),
                                device=dev)
        sim.run(3)
        arch = stg.Sphere
    kern = RigidBodyPhysicsSystem.substep_kernel(sim)
    kw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, arch, None, node=True)
    if case == "overflow":
        n, K = kw["obj"].shape[1], kw["rows_i"].shape[1]
        pairs = torch.combinations(torch.arange(n, device=dev), 2)[:K].int()
        ri, rj, kv = kw["rows_i"].clone(), kw["rows_j"].clone(), kw["kvalid"].clone()
        ri[0], rj[0], kv[0] = pairs[:, 0], pairs[:, 1], True
        kv[1] &= torch.arange(K, device=dev) % 2 == 0
        kw.update(rows_i=ri, rows_j=rj, kvalid=kv)
    if case == "random_joints":
        kw = random_joints(sim, kw, num_spheres=100)
    return kern, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stg", "joints", "overflow", "random_joints"])
def test_substep_node_matches_plain_bit_for_bit(card, case):
    """Kernel 5's node launch against its plain version (the route:
    integrate, steps 2-9, joint solve, writeback) on the same inputs: every
    output 0.0 apart, two launches bit-identical, one launch a call."""
    kern, kw = node_case(case, card)
    rows = [entity_rows(kw["eid"], kw["joints"][e], kw["arch_index"]) for e in ("e1", "e2")]
    live = kw["jmask"] & (rows[0] >= 0) & (rows[1] >= 0)
    if case in ("joints", "random_joints"):
        assert bool(live.any())
    if case == "random_joints":
        # several live joints on one body and side, and masked-in joints
        # whose handle is null or in another archetype
        world = torch.arange(live.shape[0], device=card)[:, None].expand_as(live)
        body = (world * kw["obj"].shape[1] + rows[0])[live]
        assert int(torch.unique(body, return_counts=True)[1].max()) > 1
        assert bool((kw["jmask"] & ((rows[0] < 0) | (rows[1] < 0))).any())
    if case == "overflow":
        assert int(kw["kvalid"].sum(1).max()) > subk.SUBSTEP_WINDOW
    subk.SubstepKernel.launches = 0
    got, again = kern.step(**kw), kern.step(**kw)
    want = kern.step_plain(**kw)
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 2
    for k in subk.NODE_KEYS:
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], again[k]), k
        assert float((got[k] - want[k]).abs().max()) == 0.0, k


@pytest.mark.cuda
def test_substep_node_is_one_device_op(card):
    """simple_taskgraph's kernel-mode substep node queues one device
    operation, kernel 5's launch (torch.profiler, as chip_smoke.py's
    node_time counts them); at most 12 is the bound kept."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_ecs_madrona_tpu_torch.core.context import Context
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=16, num_objects=100),
                            device="cuda")
    sim.run(2)
    torch.cuda.synchronize()
    ctx = Context(sim.mgr, sim.state)
    nodes = iter(sim.graph.nodes)
    for node in nodes:
        if node.name == "physics_substep_0":
            break
        node.run(ctx)
    node.run(ctx)                                 # warm: the scratch, the tables
    torch.cuda.synchronize()
    subk.SubstepKernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        node.run(ctx)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
              and e.self_device_time_total > 0)
    assert subk.SubstepKernel.launches == 1
    assert 1 <= ops <= 12, ops


@pytest.mark.cuda
def test_substep_node_rejects_bad_input(card):
    kern, kw = node_case("joints", card)
    args, opts = kern._node_args(**kw)
    subk.SubstepKernel.launches = 0
    with pytest.raises(ValueError):
        subk.substep_node(*((args[0].double(),) + args[1:]), **opts)
    with pytest.raises(ValueError):
        subk.substep_node(*args, **dict(opts, jmask=opts["jmask"].cpu()))
    with pytest.raises(ValueError):
        bad = dict(opts["joints"], attach_rot1=opts["joints"]["attach_rot1"][..., :3].contiguous())
        subk.substep_node(*args, **dict(opts, joints=bad))
    om = dict(kern.tables.om)
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    with pytest.raises(NotImplementedError, match="general-hull"):
        subk.substep_node(*args, **dict(opts, tables=subk.pk.ObjTables(om)))
    assert subk.SubstepKernel.launches == 0


@pytest.mark.cuda
def test_joint_world_step_waits_for_nothing(card):
    """A step of the joint world in kernel mode queues its work and
    returns: the joints' rows are looked up in the launch, no operation
    makes the host wait for the card; one launch a substep."""
    sim = joint_world("pallas", num_worlds=8, device="cuda")
    sim.step()
    torch.cuda.synchronize()
    subk.SubstepKernel.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 3 * 4


@pytest.mark.cuda
def test_rigid_bench_on_card_matches_cpu(card):
    """Two fused-mode steps on the card (the kernel) and on the CPU (its
    plain version) from the same state; one launch a step."""
    cfg = rb.RigidBenchConfig(num_worlds=8, num_bodies=20, contact_mode="pallas",
                              max_candidates=128, spawn_xy=3.0, spawn_h=4.0, seed=5)
    cpu = rb.make_executor(cfg, device="cpu")
    gpu = rb.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(2):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    a, b = state_to_numpy(cpu.state), state_to_numpy(gpu.state)
    for comp in ("Position", "Rotation"):
        np.testing.assert_allclose(b["arch"]["RigidBenchBody"]["comps"][comp]["value"],
                                   a["arch"]["RigidBenchBody"]["comps"][comp]["value"],
                                   atol=1e-4, rtol=0, err_msg=comp)


@pytest.mark.cuda
def test_fused_substep_plain_repeats_on_card(card):
    """The plain version's segment sums add in a fixed order on the card
    too (no atomics), so two runs from one state are bit-identical."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=64, contact_mode="pallas",
                                               spawn_xy=4.0, spawn_h=6.0, seed=3),
                           device="cuda")
    sim.run(3)
    kw = fused_inputs(sim)
    tables = subk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    a, b = (subk.fused_substep_plain(**kw, tables=tables, num_substeps=4, relaxation=0.7)
            for _ in range(2))
    for k in subk.OUT_KEYS:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_rigid_bench_step_waits_for_nothing(card):
    """A fused-mode step queues its work and returns: no operation in it
    makes the host wait for the card (after the first step, which copies
    the object tables to the card)."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=16, contact_mode="pallas"),
                           device="cuda")
    sim.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 4


# the fused kernel's options, each on its rigid_bench configuration (rows
# given unless the broadphase is fused); sleep and stable flags are set to
# mixes before the call
OPTION_CASES = {
    "refresh_K256": dict(contact_refresh=True, max_candidates=256),
    "refresh_K128": dict(contact_refresh=True, max_candidates=128),
    "sleep": dict(sleep_threshold=0.02),
    "bp": dict(broadphase_mode="fused"),
    "bp_refresh": dict(broadphase_mode="fused", contact_refresh=True),
    "persist_sleep": dict(rb.SETTLED_PILE, spawn="uniform"),
}
INT_KEYS = ("rows_i", "rows_j", "kvalid", "bp_count", "bp_dropped")


def option_case(case, dev, W=64):
    """(kernel, inputs) of an option case at a mid-pile state, with every
    branch taken: awake and asleep, stable and rebuilding worlds."""
    cfg = dict(dict(contact_mode="pallas", spawn_xy=4.0, spawn_h=6.0, seed=3),
               **OPTION_CASES[case])
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=W, **cfg), device=dev)
    sim.run(6)
    kw = fused_inputs(sim)
    worlds = torch.arange(W, device=dev)
    if "active" in kw:
        kw["active"] = worlds % 3 != 1
    if "stable" in kw:
        kw["stable"] = worlds % 2 == 0
    return RigidBodyPhysicsSystem.fused_kernel(sim), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_fused_substep_options_match_plain(card, case):
    """Each option's kernel specialisation against the plain version on the
    same inputs: integers exact, poses, stashes, AABBs and the manifold
    cache atol 1e-4, velocities atol 1e-3; two launches bit-identical."""
    kern, kw = option_case(case, card)
    subk.FusedSubstepKernel.launches = 0
    got, again = kern(**kw), kern(**kw)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    want = kern.plain(**kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], again[k]), k
        if k in INT_KEYS:
            assert torch.equal(got[k], want[k]), k
            continue
        assert torch.isfinite(got[k]).all(), k
        atol = 1e-4 if k in POSE_KEYS or k in ("aabb_lo", "aabb_hi", "mcache") else 1e-3
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=atol, msg=k)
    if "bp_count" in got:
        assert int(got["bp_count"].sum()) > 64


@pytest.mark.cuda
def test_settled_step_waits_for_nothing(card):
    """A step of the settled pile's configuration (the broadphase in the
    kernel, refresh, sleep, persistent manifolds) queues its work and
    returns: the stable and sleep flags, the list of awake worlds and its
    length stay on the card.  Each step launches the world flags kernel,
    the asleep worlds' kernel and the fused kernel once; the steps of a
    settled pile, where worlds sleep, do too."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=16, **rb.SETTLED_PILE), device="cuda")
    for settle in (1, 150):
        sim.run(settle)
        torch.cuda.synchronize()
        for counter in (subk.FusedSubstepKernel, subk.WorldFlags, subk.AsleepSurface):
            counter.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                sim.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert subk.FusedSubstepKernel.launches == 3
        assert subk.WorldFlags.launches == 3 and subk.AsleepSurface.launches == 3
    assert int(sim.state["singleton"]["SleepState"]["asleep"].sum()) > 0


def flags_case(case, dev, W=48):
    """world_flags' arguments on a rigid_bench pile with sleep and
    persistence: "settled" after SETTLE_STEPS (worlds asleep and stable),
    "moving" after 20 (falling), "kicked" the settled pile with an external
    force on one body of world 3, "invalid" with world 5's cache not
    valid."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=W, num_bodies=24, spawn_xy=3.0,
                                               seed=11, **rb.SETTLED_PILE), device=dev)
    sim.run(20 if case == "moving" else rb.SETTLE_STEPS)
    fkw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body, None, flags=True)
    if case == "kicked":
        ext_f = fkw["ext_f"].clone()
        ext_f[3, 5] = torch.tensor([0.0, 0.0, 2.0], device=dev)
        fkw["ext_f"] = ext_f
    if case == "invalid":
        valid = fkw["valid"].clone()
        valid[5] = 0
        fkw["valid"] = valid
    return fkw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["settled", "moving", "kicked", "invalid"])
def test_world_flags_match_plain_bit_for_bit(card, case):
    """The world flags kernel against its plain version on the same
    inputs: quiet steps, asleep, active and stable equal, with each option
    alone and both; the settled pile has asleep and stable worlds, the
    kicked and the invalid world are neither stable nor (kicked) quiet."""
    fkw = flags_case(case, card)
    subk.WorldFlags.launches = 0
    both = subk.world_flags(**fkw)
    want = subk.world_flags_plain(**fkw)
    torch.cuda.synchronize()
    assert set(both) == set(want) == {"quiet_steps", "asleep", "active", "stable"}
    for k in want:
        assert torch.equal(both[k], want[k]), (case, k)
    for alone in (dict(persist_margin=0.0), dict(sleep_threshold=0.0)):
        kw = dict(fkw, **alone)
        got, exp = subk.world_flags(**kw), subk.world_flags_plain(**kw)
        assert set(got) == set(exp) and all(torch.equal(got[k], exp[k]) for k in exp)
    assert subk.WorldFlags.launches == 3
    if case == "settled":
        assert bool(want["stable"].any()) and bool((want["asleep"] == 1).any())
    if case in ("kicked", "invalid"):
        wld = 3 if case == "kicked" else 5
        assert not bool(want["stable"][wld])
        if case == "kicked":
            assert int(want["quiet_steps"][wld]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_bodies", [24, 64])
def test_persistent_launch_in_place_matches_plain_bit_for_bit(card, n_bodies):
    """Kernel 9's launch (the asleep worlds' kernel, then the fused kernel
    over the listed awake worlds) with the cache and the anchors updated
    in place, against the plain version's in-place path, with asleep,
    kept and rebuilding worlds mixed (and the tables' per-object constants
    read by the kernel): every output, the cache and the anchors equal; a
    repeated call on the same inputs, into the same cache, is bit-identical
    and leaves the cache as it was; the functional call (a fresh cache)
    gives the same outputs."""
    W = 36
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=W, num_bodies=n_bodies, spawn_xy=3.0,
                                               seed=13, **rb.SETTLED_PILE), device=card)
    sim.run(40)
    kern = RigidBodyPhysicsSystem.fused_kernel(sim)
    kw = fused_inputs(sim)
    for k in ("im", "ii", "mu_s", "mu_d"):
        kw.pop(k)
    worlds = torch.arange(W, device=card)
    kw.update(active=worlds % 3 != 1, stable=worlds % 2 == 0)
    mp = sim.state["singleton"]["ManifoldPersist"]

    def call(fn):
        mc = kw["mcache"].clone()
        anchors = tuple(mp[k].clone() for k in ("apos", "arot", "valid"))
        out = fn(**kw, mcache_out=mc, anchors=anchors, keep_velocity=True)
        assert out["mcache"] is mc
        return out, mc, anchors

    subk.AsleepSurface.launches = 0
    got, mc, anchors = call(kern)
    first = {k: x.clone() for k, x in got.items()}
    want, mc_p, anchors_p = call(kern.plain)
    again = kern(**kw, mcache_out=mc, keep_velocity=True)
    fresh = kern(**kw, keep_velocity=True)
    torch.cuda.synchronize()
    assert subk.AsleepSurface.launches == 3
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(first[k], again[k]), k
        assert torch.equal(first[k], fresh[k]), k
        if k in INT_KEYS:
            assert torch.equal(got[k], want[k]), k
        else:
            assert float((got[k] - want[k]).abs().max()) == 0.0, k
    for a, b in zip(anchors, anchors_p):
        assert torch.equal(a, b)
    # the rebuilding worlds (awake, unstable) moved their anchors and rows
    rebuilt = (worlds % 3 != 1) & (worlds % 2 != 0)
    assert not torch.equal(mc[rebuilt], kw["mcache"][rebuilt])
    assert torch.equal(mc[~rebuilt], kw["mcache"][~rebuilt])
    assert torch.equal(anchors[0][rebuilt], kw["pos"][rebuilt])


@pytest.mark.cuda
def test_settled_pile_on_card_matches_cpu(card):
    """Six steps of the settled pile's configuration on the card (the
    kernel) and on the CPU (its plain version) from one state: positions,
    the manifold cache's rows and the sleep state alike."""
    cfg = rb.RigidBenchConfig(num_worlds=8, num_bodies=20, spawn_xy=3.0, seed=5,
                              **rb.SETTLED_PILE)
    cpu = rb.make_executor(cfg, device="cpu")
    gpu = rb.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(6):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 6
    a, b = state_to_numpy(cpu.state), state_to_numpy(gpu.state)
    np.testing.assert_allclose(b["arch"]["RigidBenchBody"]["comps"]["Position"]["value"],
                               a["arch"]["RigidBenchBody"]["comps"]["Position"]["value"],
                               atol=1e-4, rtol=0)
    for key in ("ManifoldPersist", "SleepState"):
        for f, x in a["singleton"][key].items():
            if f == "mc":
                np.testing.assert_array_equal(b["singleton"][key][f][:, :3], x[:, :3])
            else:
                np.testing.assert_allclose(b["singleton"][key][f], x, atol=1e-4, rtol=0,
                                           err_msg=f"{key}.{f}")


RENDER_INPUTS = ("ro", "rd", "pos", "rot", "scale", "obj", "mask")


def render_case(scene, dev):
    """(RenderKernel, rays, inst) of a tests/test_torch_render_scenes.py scene."""
    import test_torch_render_scenes as scenes
    sc = scenes.SCENES[scene]()
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(dev) for key in RENDER_INPUTS))
    return k, rays, inst, sc["img_w"]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["pallas_scene", "two_views", "inside", "sphere_mesh"])
def test_render_kernel_matches_plain(card, scene):
    """The kernel against its plain version: hit exact, depth and float rgb
    atol 1e-5, a repeated launch bit-identical (the inside scene's one
    8 x 16 tile spans both of its views, so its cone wraps)."""
    k, rays, inst, img_w = render_case(scene, card)
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, img_w=img_w)
    got, again = rk.render(rays, inst, **kw), rk.render(rays, inst, **kw)
    torch.cuda.synchronize()
    assert rk.RenderKernel.launches == 2
    want = rk.render_plain(rays, inst, tables=k.tables, light=k.light, ambient=k.ambient)
    assert torch.equal(got[:, rk.O_HIT], want[:, rk.O_HIT]) and bool(want[:, rk.O_HIT].any())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_render_wrapper_rejects_bad_input_on_card(card):
    k, rays, inst, img_w = render_case("pallas_scene", card)
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, img_w=img_w)
    with pytest.raises(ValueError):
        rk.render(rays.double(), inst, **kw)
    with pytest.raises(ValueError):
        rk.render(rays, inst.cpu(), **kw)
    with pytest.raises(ValueError):
        rk.render(rays.transpose(1, 2).contiguous().transpose(1, 2), inst, **kw)
    big = torch.zeros((1, rk.C_INST, 5000), device=card)
    with pytest.raises(NotImplementedError, match="shared memory"):
        rk.render(rays[:1], big, **kw)
    assert rk.RenderKernel.launches == 0


STG = dict(num_worlds=4, num_objects=48, num_substeps=2, seed=5, render=True,
           render_width=32, render_height=32)


@pytest.mark.cuda
def test_simple_taskgraph_on_card_matches_cpu(card):
    """Three steps on the card (the single-substep and render kernels) and
    on the CPU (their plain versions) from one state: poses atol 1e-4,
    velocities 1e-3; one single-substep launch a substep and one render
    launch a step; the card's observations equal the plain render of the
    card's own state."""
    cpu = stg.make_executor(stg.SimpleTaskgraphConfig(**STG), device="cpu")
    gpu = stg.make_executor(stg.SimpleTaskgraphConfig(**STG), device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(3):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    assert (subk.FusedSubstepKernel.launches, subk.SubstepKernel.launches,
            rk.RenderKernel.launches) == (0, 3 * 2, 3)
    a, b = state_to_numpy(cpu.state), state_to_numpy(gpu.state)
    for comp, atol in (("Position", 1e-4), ("Rotation", 1e-4)):
        np.testing.assert_allclose(b["arch"]["StgSphere"]["comps"][comp]["value"],
                                   a["arch"]["StgSphere"]["comps"][comp]["value"],
                                   atol=atol, rtol=0, err_msg=comp)
    for key in ("linear", "angular"):
        np.testing.assert_allclose(b["arch"]["StgSphere"]["comps"]["Velocity"][key],
                                   a["arch"]["StgSphere"]["comps"]["Velocity"][key],
                                   atol=1e-3, rtol=0, err_msg=key)
    rend = gpu.world_cls.renderer()
    rays, inst = rend.kernel_inputs(gpu.state["user"]["render"], [stg.Sphere])
    k = rend._kernel
    want = rk.render_plain(rays.cpu(), inst.cpu(), tables=k.tables, light=k.light,
                           ambient=k.ambient)
    depth = gpu.depth_observations().reshape(4, -1).cpu()
    hit = want[:, rk.O_HIT, :32 * 32] > 0.5
    assert torch.equal(torch.isfinite(depth), hit) and bool(hit.any())
    torch.testing.assert_close(depth[hit], want[:, rk.O_DEPTH, :32 * 32][hit], atol=1e-5, rtol=0)
    rgb = gpu.rgb_observations()
    assert torch.equal(rgb[..., 3] == 255, torch.isfinite(gpu.depth_observations()))


@pytest.mark.cuda
def test_render_step_waits_for_nothing(card):
    """A simple_taskgraph step with rendering queues its work and returns:
    no operation in it makes the host wait for the card (after the first
    step, which copies the object tables to the card)."""
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=16, num_objects=60,
                                                      render=True), device="cuda")
    sim.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (subk.FusedSubstepKernel.launches, subk.SubstepKernel.launches,
            rk.RenderKernel.launches) == (0, 4 * 4, 4)


# -- the fused kernel's work list, broadphase masks and scans: every
# specialisation bit for bit against its plain version on piles that stress
# them ----------------------------------------------------------------------

SPECIALISATIONS = ("none", "refresh", "sleep", "refresh+sleep", "bp", "refresh+bp",
                   "refresh+bp+persist", "refresh+sleep+bp+persist")
BODY_KEYS = ("pos", "rot", "v", "w", "im", "ii", "mu_s", "mu_d", "obj", "ext_f", "ext_t", "dyn")


def slot_kinds(kw):
    """Each slot's contact kind, as the kernel's work list groups them."""
    prim = torch.as_tensor(rb.RigidBenchWorld.objmgr["prim_type"], device=kw["obj"].device)
    pa = prim[torch.gather(kw["obj"], 1, kw["rows_i"].long()).long()]
    pb = prim[torch.gather(kw["obj"], 1, kw["rows_j"].long()).long()]
    return torch.minimum(pa, pb) * 3 + torch.maximum(pa, pb)


def pile_inputs(pile, n, K, dev, W=6):
    """The no-option kernel's inputs for a pile of n rows (the plane and
    n - 1 bodies: boxes, spheres or both alternating) at K slots, from the
    dense broadphase of a compact rigid_bench pile; world 0 keeps the
    valid slots of one contact kind only, world 1 has none, world 2 fills
    all K slots with the pairs of its rows in order (most of them apart)."""
    nb = max(n - 1, 8)
    sim = rb.make_executor(rb.RigidBenchConfig(
        num_worlds=W, num_bodies=nb, contact_mode="pallas", max_candidates=K,
        body_mix="boxes" if pile == "boxes" else "alternate", spawn_xy=3.0, spawn_h=5.0,
        seed=7), device=dev)
    sim.run(4)
    kw = fused_inputs(sim)
    kw.update({k: kw[k][:, :n].contiguous() for k in BODY_KEYS})
    if pile == "spheres":
        kw["obj"] = torch.where(torch.arange(n, device=dev) > 0, rb.OBJ_SPHERE,
                                kw["obj"]).to(torch.int32).contiguous()
    kvalid = kw["kvalid"] & (kw["rows_i"] < n) & (kw["rows_j"] < n)
    kinds = slot_kinds(dict(kw, rows_i=kw["rows_i"].clamp(max=n - 1),
                            rows_j=kw["rows_j"].clamp(max=n - 1)))
    if bool(kvalid[0].any()):
        first = kinds[0][kvalid[0]][0]
        kvalid[0] &= kinds[0] == first
    kvalid[1] = False
    pairs = torch.combinations(torch.arange(n, device=dev), 2)[:K]
    rows_i, rows_j = kw["rows_i"].clone(), kw["rows_j"].clone()
    rows_i[2], rows_j[2], kvalid[2] = 0, 0, False
    rows_i[2, :len(pairs)], rows_j[2, :len(pairs)] = pairs[:, 0].int(), pairs[:, 1].int()
    kvalid[2, :len(pairs)] = True
    rows_i = torch.where(kvalid, rows_i, 0)
    rows_j = torch.where(kvalid, rows_j, 0)
    kw.update(rows_i=rows_i.contiguous(), rows_j=rows_j.contiguous(),
              kvalid=kvalid.contiguous())
    return kw


def specialised(spec, kw, K, D):
    """(kernel, inputs) of specialisation ``spec`` on a pile's inputs: mixed
    sleep flags; the broadphase with degree cap D over live rows with two
    dead ones; the persistent cache built by a first plain call, then half
    the worlds stable."""
    W, n = kw["im"].shape
    dev = kw["im"].device
    opts = set(spec.split("+"))
    kern = subk.FusedSubstepKernel(
        rb.RigidBenchWorld.objmgr, 4, relaxation=0.7, contact_refresh="refresh" in opts,
        bp_degree=D if "bp" in opts else 0, bp_capacity=K if "bp" in opts else 0,
        persist_margin=0.05 if "persist" in opts else 0.0)
    kw = dict(kw)
    worlds = torch.arange(W, device=dev)
    if "bp" in opts:
        for k in ("rows_i", "rows_j", "kvalid"):
            kw.pop(k)
        live = torch.ones((W, n), dtype=torch.bool, device=dev)
        live[:, n // 2] = False
        live[:, -1] = n < 3
        kw.update(scale=torch.ones((W, n, 3), device=dev), live=live,
                  dtv=torch.full((W,), 1 / 60, device=dev))
    if "persist" in opts:
        first = subk.FusedSubstepKernel(
            rb.RigidBenchWorld.objmgr, 4, relaxation=0.7, contact_refresh=True, bp_degree=D,
            bp_capacity=K, persist_margin=0.05).plain(
                **kw, mcache=torch.zeros((W, subk.MC_CHANNELS, K), device=dev),
                stable=torch.zeros(W, dtype=torch.bool, device=dev),
                aabb_lo=torch.zeros((W, n, 3), device=dev),
                aabb_hi=torch.zeros((W, n, 3), device=dev))
        kw.update(mcache=first["mcache"], stable=worlds % 2 == 0, aabb_lo=first["aabb_lo"],
                  aabb_hi=first["aabb_hi"])
    if "sleep" in opts:
        kw["active"] = worlds % 3 != 1
    return kern, kw


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 128])
@pytest.mark.parametrize("n", [1, 65, 127])
@pytest.mark.parametrize("pile", ["boxes", "spheres", "alternate"])
def test_every_specialisation_matches_plain_bit_for_bit(card, pile, n, K):
    """Each of the eight specialisations against its plain version on the
    same inputs: every output 0.0 apart (integers equal), and two launches
    bit-identical.  The piles put one contact kind in a world, none in
    another, and all K slots in a third; the broadphase runs over rows
    with dead ones."""
    kw0 = pile_inputs(pile, n, K, card)
    for spec in SPECIALISATIONS:
        kern, kw = specialised(spec, kw0, K, 12)
        subk.FusedSubstepKernel.launches_by_options.clear()
        got, again = kern(**kw), kern(**kw)
        want = kern.plain(**kw)
        torch.cuda.synchronize()
        assert dict(subk.FusedSubstepKernel.launches_by_options) == {spec: 2}
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], again[k]), (spec, k)
            if k in INT_KEYS:
                assert torch.equal(got[k], want[k]), (spec, k)
            else:
                assert torch.isfinite(got[k]).all(), (spec, k)
                assert float((got[k] - want[k]).abs().max()) == 0.0, (spec, k)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 128])
def test_broadphase_rows_with_a_degree_cap_that_drops(card, K):
    """The in-kernel broadphase's rows, counts and drops equal the plain
    version's rank compaction exactly when the degree cap drops pairs."""
    kw0 = pile_inputs("alternate", 65, K, card)
    for spec in ("bp", "refresh+bp"):
        kern, kw = specialised(spec, kw0, K, 2)
        got, want = kern(**kw), kern.plain(**kw)
        torch.cuda.synchronize()
        assert int(want["bp_dropped"].sum()) > 0
        for k in INT_KEYS:
            assert torch.equal(got[k], want[k]), (spec, k)
        for k in subk.OUT_KEYS:
            assert float((got[k] - want[k]).abs().max()) == 0.0, (spec, k)


@pytest.mark.cuda
def test_occupancy_is_exported(card):
    """Every specialisation reports its launch shape and CTAs an SM at the
    main shape (8192 x 65 rows, K = 256)."""
    occ = subk.occupancy(65, 256)
    assert set(occ) == set(SPECIALISATIONS)
    for spec, (threads, blocks) in occ.items():
        assert threads % 32 == 0 and 32 <= threads <= 1024 and blocks >= 1, (spec, occ)
    threads, blocks = subk.occupancy(104, 1000, single=True)
    assert threads % 32 == 0 and blocks >= 1
    # kernel 5's node launch at simple_taskgraph's shape: three worlds an SM
    threads, blocks = subk.occupancy(104, 1000, single=True, joints=64)
    assert threads == subk.substep_threads(104, 1000) and blocks >= 3
