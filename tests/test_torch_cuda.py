"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Each CUDA kernel is held against its plain PyTorch version on the card
(lo/hi atol 1e-5, pushes and translations atol 1e-4, normals atol 1e-5,
integer outputs exact; the fused and single-substep kernels' poses and
stashes atol 1e-4, velocities atol 1e-3, and two launches on one input
bit-identical;
the fused kernel's options (contact refresh, sleep, the in-kernel
broadphase, persistent manifolds) likewise, their integer outputs exact
and the manifold cache and AABBs atol 1e-4;
the render kernel's hit mask exact, depth and float rgb atol 1e-5, a
repeat bit-identical), and the collisions, simple_jobs, rigid_bench (also
its settled pile) and simple_taskgraph slices on the card against the
same slices on the CPU (plain versions), positions atol 1e-4.
"""

import numpy as np
import pytest
import torch

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    sk.fused_simple_jobs_step.launches = 0
    subk.FusedSubstepKernel.launches = 0
    subk.SubstepKernel.launches = 0
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
    returns: the stable and sleep flags stay on the card."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=16, **rb.SETTLED_PILE), device="cuda")
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
