"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Each CUDA kernel is held against its plain PyTorch version on the card
(lo/hi atol 1e-5, pushes and translations atol 1e-4, normals atol 1e-5,
integer outputs exact; the fused substep kernel's poses and stashes atol
1e-4, velocities atol 1e-3, and two launches on one input bit-identical),
and the collisions, simple_jobs and rigid_bench slices on the card
against the same slices on the CPU (plain versions), positions atol 1e-4.
"""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
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
