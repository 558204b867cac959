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
repeat bit-identical; its views mode bit for bit the node's route through
the rays mode, the node one launch), and the collisions, simple_jobs, rigid_bench (also
its settled pile) and simple_taskgraph slices on the card against the
same slices on the CPU (plain versions), positions atol 1e-4.  The sap
broadphase's node on the card exactly equal to the CPU's (a pile and a
tie grid), kernel 7 on sap's candidates against its plain version, a
dense-mode step on the card against the CPU (poses 1e-4, velocities 1e-3)
and bit-identical when repeated, and a dense and a sap step waiting for
nothing.  The RL training path: one PPO train step on the card against
the CPU from the same parameters and draws (tests/test_torch_rl_cases.py's
tolerances), a train step waiting for nothing, the exported columns
handed off zero-copy, and the reset worlds on the card equal to the CPU.
Past one block's shared memory: every non-broadphase fused specialisation
in its windowed layout (rigid_bench at 240, 256 and 512 rows, the prism
pile at 240 and 256) bit for bit its plain version; past the windowed
layout's body ceiling (rigid_bench at 970 rows, the prism pile at 372) and
kernel 5's (816 rows; 1,068 with joints) the bodies in a global scratch,
bit for bit; kernel 5's joint lookup under 64-bit handles (a process of
its own) bit for bit the int32 one; the render kernel's blocked modes at
4,096 instance rows bit for bit their plain versions and, forced on scenes
that fit, bit for bit the single-stage kernel.  Across ranks and the
tooling: the autotuner's lookup keyed "cuda" and its consumer, profile_nodes
and trace_step on collisions (the state untouched), and a one-rank NCCL
train step within LEARNER_TOL of the learner without a mesh.
"""

import os

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch.bindings import Tensor, exported_tensor
from gpu_ecs_madrona_tpu_torch.core.state import entity_rows
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl
from gpu_ecs_madrona_tpu_torch.parallel import (initialize_distributed, make_world_mesh,
                                                shard_state)
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem
from gpu_ecs_madrona_tpu_torch.tooling import autotuner, profiler

import test_torch_render_scenes as scenes
import test_torch_rank_cases as rank_cases
import test_torch_rl_cases as rl_cases
import test_torch_sap_cases as sap_cases
import test_torch_simple_jobs_cases as sj_cases
import test_torch_hull_scenes as hull_scenes
from test_torch_joint_scenes import chain_world, joint_world, random_joints


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    sk.fused_simple_jobs_step.launches = 0
    subk.FusedSubstepKernel.launches = 0
    subk.SubstepKernel.launches = 0
    subk.SubstepKernel.hull_launches = 0
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


def shaped(pos, rot, mask, kind):
    """A collision case's inputs made ``kind``: "all_dead" kills every row
    of world 0; "coincident" puts each odd row on the even row before it
    (d2 = 0: the push's clamp at 1e-30); "cluster" packs every world into
    a 0.6-wide cube, so every live pair overlaps."""
    if kind == "all_dead":
        mask = mask.clone()
        mask[0] = False
    elif kind == "coincident":
        pos = pos.clone()
        pos[:, 1::2] = pos[:, 0:pos.shape[1] - 1:2]
    elif kind == "cluster":
        pos = pos * (0.3 / pos.abs().max())
    elif kind in ("touching", "near_miss"):
        # unit cubes unrotated on shuffled points of a line 2 (+ 1e-4) apart:
        # neighbours' faces touch (an overlap, by <=) or miss by 1e-4, well
        # inside the half-precision prefilter's rounding, which the float
        # test must then drop
        W, n = mask.shape
        step = 2.0 + (1e-4 if kind == "near_miss" else 0.0)
        x = torch.arange(n, dtype=torch.float32, device=pos.device) * step - n
        order = torch.argsort(pos[..., 0], dim=1)
        pos = torch.zeros_like(pos)
        pos[..., 0] = x[order]
        rot = torch.zeros_like(rot)
        rot[..., 0] = 1.0
    return pos, rot, mask


# name: (seed, W, n, half, dead rows, kind); the first two are the cases
# the grid path's parent was held to.
FUSED_CASES = {"64-108": (7, 64, 108, 10.0, 8, None), "3-300": (7, 3, 300, 10.0, 8, None),
               "n37": (11, 8, 37, 3.0, 3, None), "n1": (12, 4, 1, 1.0, 0, None),
               "all_dead": (13, 3, 108, 10.0, 8, "all_dead"),
               "coincident": (14, 4, 60, 4.0, 4, "coincident"),
               "cluster": (15, 4, 64, 1.0, 2, "cluster"),
               "n640": (16, 2, 640, 12.0, 10, None),
               "touching": (24, 2, 90, 1.0, 0, "touching"),
               "near_miss": (25, 2, 90, 1.0, 0, "near_miss")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_collisions_step_matches_plain(card, case):
    """lo/hi atol 1e-5, delta atol 1e-4, dead rows 0, a second launch
    bit-identical; n = 640 is fused_fits's bound, where the bit grid
    passes 48 KB of shared memory."""
    seed, W, n, half, dead, kind = FUSED_CASES[case]
    pos, rot, mask = shaped(*inputs(seed, W, n, half, dead, card), kind)
    delta, lo, hi = ck.fused_collisions_step(pos, rot, mask)
    again = ck.fused_collisions_step(pos, rot, mask)
    torch.cuda.synchronize()
    assert ck.fused_collisions_step.launches == 2
    plo, phi = ck.aabb_plain(pos, rot)
    torch.testing.assert_close(lo, plo, atol=1e-5, rtol=0)
    torch.testing.assert_close(hi, phi, atol=1e-5, rtol=0)
    want = ck.pushes_plain(pos, lo, hi, mask, center=False)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()
    assert bool(torch.isfinite(delta).all())
    for a, b in zip((delta, lo, hi), again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if kind == "cluster":
        assert bool((want[mask].norm(dim=-1) > 0).all())   # every live row pushed
    if kind in ("touching", "near_miss"):
        assert bool(want.any()) == (kind == "touching")     # the ends are pushed


# name: (seed, W, n, AABB half-width, dead rows, force_tile, kind, offset)
PUSH_CASES = {"64-108-0": (9, 64, 108, 1.0, 5, 0, None, 0.0),
              "4-700-32": (9, 4, 700, 1.0, 5, 32, None, 0.0),
              "2-1500-1024": (9, 2, 1500, 1.0, 5, 1024, None, 0.0),
              "n37": (17, 8, 37, 1.0, 3, 0, None, 0.0),
              "n37-tiled": (17, 8, 37, 1.0, 3, 32, None, 0.0),
              "n1": (18, 4, 1, 1.0, 0, 0, None, 0.0),
              "all_dead": (19, 3, 108, 1.0, 8, 0, "all_dead", 0.0),
              "coincident": (20, 4, 60, 1.0, 4, 0, "coincident", 0.0),
              "cluster": (21, 4, 64, 1.0, 2, 0, "cluster", 0.0),
              "cluster-tiled": (21, 4, 64, 1.0, 2, 128, "cluster", 0.0),
              "offset_1e4": (22, 8, 108, 1.0, 8, 0, None, 1e4),
              "offset_1e4-tiled": (22, 8, 108, 1.0, 8, 128, None, 1e4),
              "touching": (26, 2, 90, 1.0, 0, 0, "touching", 0.0),
              "near_miss": (27, 2, 90, 1.0, 0, 0, "near_miss", 0.0),
              "near_miss-tiled": (27, 2, 90, 1.0, 0, 32, "near_miss", 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PUSH_CASES))
def test_collision_pushes_matches_plain(card, case):
    """delta atol 1e-4 against the plain version (which centres with
    pos.mean), dead rows 0, a second launch bit-identical; the 1e4 offset
    is where only the centring keeps the push right."""
    seed, W, n, ext, dead, tile, kind, offset = PUSH_CASES[case]
    pos, _, mask = shaped(*inputs(seed, W, n, n ** (1 / 3) * 2.0, dead, card), kind)
    pos = pos + offset
    lo, hi = pos - ext, pos + ext
    delta = ck.collision_pushes(pos, lo, hi, mask, force_tile=tile)
    again = ck.collision_pushes(pos, lo, hi, mask, force_tile=tile)
    torch.cuda.synchronize()
    assert ck.collision_pushes.launches == 2
    want = ck.collision_pushes_plain(pos, lo, hi, mask)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()
    assert bool(torch.isfinite(delta).all())
    assert torch.equal(delta.view(torch.int32), again.view(torch.int32))
    if kind in ("touching", "near_miss"):
        assert bool(delta.any()) == (kind == "touching")


def graph_nodes(fn):
    """The device operations one call of fn queues: the nodes of a CUDA
    graph that captures the call (cuGraphGetNodes).  No torch.profiler
    session, which would disturb the profiler counts of later tests."""
    import ctypes

    fn()                                          # warm: the build, the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert rc == 0, rc
    return count.value


@pytest.mark.cuda
@pytest.mark.parametrize("W,n", [(64, 108), (16, 1500)], ids=["grid", "tiled"])
def test_collision_pushes_is_one_device_op(card, W, n):
    """The centring runs in the launch: a collision_pushes call queues one
    device operation, on both paths."""
    pos, _, mask = inputs(23, W, n, n ** (1 / 3) * 2.0, 5, card)
    lo, hi = pos - 1.0, pos + 1.0
    assert graph_nodes(lambda: ck.collision_pushes(pos, lo, hi, mask)) == 1
    assert ck.collision_pushes.launches == 2


@pytest.mark.cuda
def test_collision_launch_shapes_on_card(card):
    """The occupancy API takes each launch shape: the main path's grid
    launch, the bound's, the tiled timing's."""
    for W, n, kernel, tile in ((8192, 108, "fused", 0), (8192, 108, "pushes", 0),
                               (2, 640, "fused", 0), (16, 1500, "pushes", 0),
                               (16, 1500, "pushes", 1024)):
        occ = ck.occupancy(W, n, kernel, tile)
        assert occ["ctas_per_sm"] >= 1, occ


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
    return tuple(torch.from_numpy(a).to(dev) for a in sj_cases.bodies(seed, W, n0, half))


SJ_CASES = {
    # name: (inputs (numpy), K, D)
    "main": (lambda: sj_cases.bodies(3, 64, 100, 10.0), 1600, 32),
    "cap_and_truncation": (lambda: sj_cases.bodies(3, 3, 37, 4.0), 128, 4),
    "near_bound": (lambda: sj_cases.bodies(3, 2, 1000, 11.0), 4096, 32),
    # AABBs meeting on closed slabs: the half-precision filter's outward
    # rounding and the float32 re-test decide every lattice neighbour pair
    "touching_grid": (lambda: sj_cases.touching_grid(4, 5, 5, 4), 1600, 32),
    # every body overlaps 99 others: D = 32 drops pairs and 3200 slots pass K
    "dense_cluster": (lambda: sj_cases.dense_cluster(4, 8, 100), 1600, 32),
    # odd K: no world's ab or normals span starts on a 16-byte boundary
    "odd_K": (lambda: sj_cases.bodies(5, 16, 100, 6.0), 1601, 32),
}


def sj_case(case, dev):
    make, K, D = SJ_CASES[case]
    pos, rot = (torch.from_numpy(a).to(dev) for a in make())
    return pos, rot, dict(n0=pos.shape[1], K=K, degree_cap=D,
                          bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SJ_CASES))
def test_fused_simple_jobs_step_matches_plain(card, case):
    """Integers, lo and hi exact (tails included), translation atol 1e-4,
    normals atol 1e-5."""
    pos, rot, kw = sj_case(case, card)
    got = sk.fused_simple_jobs_step(pos, rot, **kw)
    torch.cuda.synchronize()
    assert sk.fused_simple_jobs_step.launches == 1
    want = sk.fused_simple_jobs_step_plain(pos, rot, **kw)
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "normals": 1e-5}
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in atol:
            torch.testing.assert_close(g, w, atol=atol[name], rtol=0, msg=name)
            assert torch.isfinite(g).all(), name
        else:
            assert torch.equal(g, w), name
    K, counts, dropped = kw["K"], want[5], want[6]
    assert int(counts.sum()) > 0
    if case in ("cap_and_truncation", "dense_cluster"):
        assert (dropped > 0).any() and (counts > K).any()
    if case == "touching_grid":
        # world 0's lattice is exact in half precision: every neighbour pair
        # ties and is kept; the others' coordinates round off the tie
        d = (pos[0, :, None] - pos[0, None]).abs().amax(-1)
        assert int(counts[0]) == int(((d <= 2.0) & (d > 0)).sum())
        assert (counts[1:] != counts[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "dense_cluster", "odd_K"])
def test_fused_simple_jobs_step_repeats_bit_for_bit(card, case):
    """Two launches on one input give the same bits, floats included."""
    pos, rot, kw = sj_case(case, card)
    first = sk.fused_simple_jobs_step(pos, rot, **kw)
    again = sk.fused_simple_jobs_step(pos, rot, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert sk.fused_simple_jobs_step.launches == 2


@pytest.mark.cuda
def test_simple_jobs_node_is_one_device_op(card):
    """simple_jobs' fused node is one launch, its reset counters included:
    one device operation (the nodes of a CUDA graph capturing the node),
    and the state it leaves as before (counters 0, candidates and contacts
    the same slots)."""
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    sim = sj.make_executor(sj.SimpleJobsConfig(num_worlds=16, num_objects=100, fused=True),
                           device="cuda")
    sim.run(2)
    torch.cuda.synchronize()
    assert sim.graph.node_names == ["fused_step"]
    node, state = sim.graph.nodes[0], sim.state
    sk.fused_simple_jobs_step.launches = 0
    assert graph_nodes(lambda: node.run(Context(sim.mgr, state))) == 1
    assert sk.fused_simple_jobs_step.launches == 2
    user = sim.state["user"]
    assert int(user["num_candidates"].abs().sum()) == 0 == int(user["num_contacts"].abs().sum())
    assert user["num_candidates"].dtype == torch.int32
    assert user["candidates"] is user["contacts_ab"]


@pytest.mark.cuda
def test_simple_jobs_occupancy_is_exported(card):
    """The occupancy API takes the main path's launch (4 compute warps and
    the producer warp; one wave of 1024 worlds: at least 8 CTAs an SM) and
    the bound's."""
    occ = sk.occupancy(1024, 100, 1600)
    assert occ["threads"] == 160 and occ["ctas_per_sm"] >= 8, occ
    assert sk.occupancy(2, 1024, 4096)["ctas_per_sm"] >= 1


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
    return RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body, sim.world_cls.objmgr)


def over_the_budget(om=None):
    """An object manager (rigid_bench's by default) with its box taken as a
    general hull of 4096 table verts (zero rows past its 8): staged hull
    rows past the shared memory the kernels leave them, at any row count
    the tests launch (refused with the in-kernel broadphase; the other
    launches take them with the bodies in a global scratch)."""
    om = dict(rb.RigidBenchWorld.objmgr if om is None else om)
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    om["verts"] = np.pad(om["verts"], ((0, 0), (0, 4096 - om["verts"].shape[1]), (0, 0)))
    return om


def padded_boxes(om=None, vm=9):
    """An object manager (rigid_bench's by default) whose all-box table has
    vm verts a hull: wider than a box's 8, which every launch takes, bit
    for bit the box table's result."""
    return hull_scenes.padded_verts(rb.RigidBenchWorld.objmgr if om is None else om, vm)


def bp_args(kw, K=128):
    """fused_substep's keyword arguments for its in-kernel broadphase over
    kw's bodies (degree cap 4, K slots, every row live, no expansion)."""
    W, n = kw["obj"].shape
    dev = kw["pos"].device
    return dict(bp_degree=4, K=K, scale=torch.ones((W, n, 3), device=dev),
                live=torch.ones((W, n), dtype=torch.bool, device=dev),
                dtv=torch.zeros((W,), device=dev))


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
    with pytest.raises(NotImplementedError, match="4096 verts.*hull-row budget"):
        subk.fused_substep(**dict(args, tables=subk.pk.ObjTables(over_the_budget())),
                           **bp_args(kw))
    assert subk.FusedSubstepKernel.launches == 0
    # an all-box table of 9 verts a hull is no bad input: it launches, bit
    # for bit the box table's launch
    wide = subk.fused_substep(**dict(args, tables=subk.pk.ObjTables(padded_boxes())))
    own = subk.fused_substep(**args)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    for k in subk.OUT_KEYS:
        assert torch.equal(wide[k], own[k]), k


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
    assert subk.SubstepKernel.launches == 0
    # an all-box table of 9 verts a hull launches, bit for bit the box table
    wide = subk.substep(**dict(args, tables=subk.pk.ObjTables(padded_boxes())))
    own = subk.substep(**args)
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 2
    for k in subk.SUBSTEP_KEYS:
        assert torch.equal(wide[k], own[k]), k


def node_case(case, dev):
    """(SubstepKernel, node inputs) of kernel 5's node launch: "stg",
    simple_taskgraph's state (100 spheres, K = 1000, 64 dead joint rows,
    dead body rows); "joints", the joint world (live Fixed and Hinge
    joints, static bodies) after 5 steps, "joints_landed" after 30 (its
    free box on the plane); "overflow", simple_taskgraph's state with all
    1000 slots of world 0 valid (every pair of its rows in order: past the
    shared window, so the global scratch is used) and every other slot of
    world 1; "random_joints", simple_taskgraph's state with random live
    Fixed and Hinge joints (several on one body and side, a null handle, a
    handle into another archetype: test_torch_joint_scenes.random_joints)."""
    if case.startswith("joints"):
        sim = joint_world("pallas", num_worlds=8, device=dev)
        sim.run(5 if case == "joints" else 30)
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
    operation, kernel 5's launch (the nodes of a CUDA graph capturing the
    node, as chip_smoke.py's node_time counts them); at most 12 is the
    bound kept."""
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
    state = ctx.state
    node.run(Context(sim.mgr, state))             # warm: the scratch, the tables
    torch.cuda.synchronize()
    subk.SubstepKernel.launches = 0
    node.run(Context(sim.mgr, state))
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 1
    ops = graph_nodes(lambda: node.run(Context(sim.mgr, state)))
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
    assert subk.SubstepKernel.launches == 0
    # an all-box table of 9 verts a hull launches, bit for bit the box table
    om = padded_boxes(kern.tables.om)
    wide = subk.substep_node(*args, **dict(opts, tables=subk.pk.ObjTables(om)))
    own = subk.substep_node(*args, **opts)
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == 2
    for k in subk.NODE_KEYS:
        assert torch.equal(wide[k], own[k]), k


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
    sc = scenes.CARD_SCENES[scene]()
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(dev) for key in RENDER_INPUTS))
    return k, rays, inst, sc["img_w"]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["pallas_scene", "two_views", "inside", "sphere_mesh",
                                   "inside_wrapping"])
def test_render_kernel_matches_plain(card, scene):
    """The kernel against its plain version: hit exact, depth and float rgb
    atol 1e-5, a repeated launch bit-identical (inside_wrapping's 8 x 4
    tile over rows 4-7 spans both of its views, so its cone wraps)."""
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
    # no instance rows at all (any count past one block's shared memory is
    # staged in blocks: test_render_blocked_matches_plain_bit_for_bit)
    empty = torch.zeros((1, rk.C_INST, 0), device=card)
    with pytest.raises(NotImplementedError, match="at least one"):
        rk.render(rays[:1], empty, **kw)
    assert rk.RenderKernel.launches == 0


def views_case(case, dev):
    """A views-mode case: simple_taskgraph's main state (1024 worlds x 100
    spheres, 64 x 64, after 3 steps) or a tests/test_torch_render_scenes.py
    VIEW_CASES case (two views, dead views, 24 x 40 and 18 x 30 images, a
    triangle-mesh scene).
    Returns (RenderKernel, views, instances, V, H, Wpx)."""
    if case != "main_state":
        return scenes.view_case(case, dev)
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=1024, num_objects=100,
                                                      render=True), device="cuda")
    sim.run(3)
    rend = sim.world_cls.renderer()
    render_in = sim.state["user"]["render"]
    return (rend._kernel, render_in["__views__"], rend.instances(render_in, [stg.Sphere]),
            1, 64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main_state", *scenes.VIEW_CASES])
def test_render_views_matches_the_old_route_bit_for_bit(card, case):
    """The kernel's views mode (the render node's one launch) against the
    node's route before it on the card (camera_rays, pack, the rays-mode
    kernel, the RGBA8/depth epilogue): RGBA8 equal and depth equal as int32
    bits, a repeated launch bit-identical; against its plain version alpha
    exact, depth atol 1e-5 where both hit, RGBA8 within 1."""
    k, views, inst, V, H, Wpx = views_case(case, card)
    kw = dict(height=H, width=Wpx, max_views=V)
    rk.RenderKernel.launches = 0
    got, again = k.render_views(views, *inst, **kw), k.render_views(views, *inst, **kw)
    torch.cuda.synchronize()
    assert rk.RenderKernel.launches == 2
    want = scenes.node_route(k, views, inst, V, H, Wpx)
    plain = rk.render_views_plain(views, *inst, tables=k.tables, light=k.light,
                                  ambient=k.ambient, **kw)
    for a in (want, again):
        assert torch.equal(got[0], a[0])
        assert torch.equal(got[1].view(torch.int32), a[1].view(torch.int32))
    hit = torch.isfinite(got[1])
    assert bool(hit.any()) and torch.equal(got[0][..., 3] == 255, hit)
    assert torch.equal(got[0][..., 3], plain[0][..., 3])
    both = hit & torch.isfinite(plain[1])
    torch.testing.assert_close(got[1][both], plain[1][both], atol=1e-5, rtol=0)
    assert int((got[0].int() - plain[0].int()).abs().max()) <= 1
    dead = ~views["mask"][:, :V]
    assert (got[0][dead] == 0).all() and torch.isinf(got[1][dead]).all()


@pytest.mark.cuda
def test_render_views_rejects_bad_input_on_card(card):
    k, views, inst, V, H, Wpx = scenes.view_case("two_views_dead", card)
    kw = dict(height=H, width=Wpx, max_views=V)
    with pytest.raises(ValueError):
        k.render_views(dict(views, eye=views["eye"].cpu()), *inst, **kw)
    with pytest.raises(ValueError):
        k.render_views(views, inst[0].transpose(0, 1).contiguous().transpose(0, 1), *inst[1:],
                       **kw)
    empty = [torch.zeros((3, 0) + x.shape[2:], dtype=x.dtype, device=card) for x in inst]
    with pytest.raises(NotImplementedError, match="at least one"):
        k.render_views(views, *empty, **kw)
    assert rk.RenderKernel.launches == 0


@pytest.mark.cuda
def test_render_node_is_one_launch(card):
    """simple_taskgraph's render node is one views-mode launch: at most 3
    device operations (the nodes of a CUDA graph capturing the node)."""
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=16, num_objects=100,
                                                      render=True), device="cuda")
    sim.run(2)
    torch.cuda.synchronize()
    ctx = Context(sim.mgr, sim.state)
    for node in sim.graph.nodes:
        if node.name == "batch_render":
            break
        node.run(ctx)
    state = ctx.state
    rk.RenderKernel.launches = 0
    node.run(Context(sim.mgr, state))
    torch.cuda.synchronize()
    assert rk.RenderKernel.launches == 1
    ops = graph_nodes(lambda: node.run(Context(sim.mgr, state)))
    assert 1 <= ops <= 3, ops


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


# -- the sap broadphase and the dense contact mode ------------------------------


def sap_pair(card, W=64, n=200, grid=False):
    """rigid_bench with the sap broadphase ("auto" above 192 rows) on the
    card and on the CPU, the card's from the CPU's initial state (on a
    grid with ``grid``) after 3 steps on the CPU."""
    cfg = rb.RigidBenchConfig(num_worlds=W, num_bodies=n, contact_mode="pallas", seed=3)
    cpu = rb.make_executor(cfg, device="cpu")
    if grid:
        cpu.state = state_from_numpy(sap_cases.set_grid(state_to_numpy(cpu.state)), "cpu")
    cpu.run(3)
    gpu = rb.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    return cpu, gpu


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True], ids=["pile", "tie_grid"])
def test_sap_on_card_matches_cpu(card, grid):
    """The sap node on the card and on the CPU from one state (the AABBs
    made on the card): candidate rows, handles, masks and overflow
    exactly equal, the tie grid too."""
    cpu, gpu = sap_pair(card, grid=grid)
    state = sap_cases.aabb_state(gpu)
    a, b = sap_cases.sap_outputs(cpu, state), sap_cases.sap_outputs(gpu, state)
    assert int(a["rows"]["mask"].sum()) > 64
    assert sap_cases.differing(a, b) == 0


@pytest.mark.cuda
def test_fused_substep_matches_plain_at_sap_state(card):
    """Kernel 7 (K = 800 > 128) on sap's candidates, in sap's order,
    against its plain version, bit for bit (the slot layout leaves one CTA
    an SM there, so the windowed twin runs it); a repeat bit-identical."""
    _, gpu = sap_pair(card, W=32)
    kw = fused_inputs(gpu)
    assert kw["rows_i"].shape[1] == 800 and int(kw["kvalid"].sum()) > 32 * 100
    kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    subk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    want = kern.plain(**kw)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    assert dict(subk.FusedSubstepKernel.launches_by_options) == {"win": 2}
    for k in subk.OUT_KEYS:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))
        assert torch.equal(got[k], again[k]), k


# the shapes whose slot layout leaves one CTA an SM, which take the windowed
# twin's block: kernel 7 at sap's state (201 rows, K = 800) and the 24-sided
# prism's pile (65 rows, K = 256), without and with an option
ONE_CTA_CASES = {"sap": ("sap", {}, "win"), "sap_sleep": ("sap", {"sleep": True}, "sleep+win"),
                 "large_prism": ("large", {}, "win+hull"),
                 "large_prism_refresh": ("large", {"contact_refresh": True},
                                         "refresh+win+hull")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ONE_CTA_CASES))
def test_one_cta_shapes_take_the_twin_bit_for_bit(card, case):
    """Each shape whose slot layout leaves one CTA an SM launches the
    windowed twin (counted under its name), its window every slot, in a
    block of WIN_THREADS threads at one CTA an SM; bit for bit the plain
    version, and a repeat bit-identical."""
    pile, opts, name = ONE_CTA_CASES[case]
    opts = dict(opts)
    sleep = opts.pop("sleep", False)
    if pile == "sap":
        _, sim = sap_pair(card, W=32)
    else:
        sim = hull_scenes.hull_pile(rb.RigidBenchConfig(**dict(hull_scenes.HULL_PILE,
                                                               num_worlds=64)),
                                    device=card, large=True)
        sim.run(3)
    kw = fused_inputs(sim)
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    if sleep:
        kw["active"] = torch.arange(W, device=card) % 3 != 1
    kern = subk.FusedSubstepKernel(sim.world_cls.objmgr, 4, relaxation=0.7, **opts)
    refresh = kern.contact_refresh
    assert subk.windowed(kern.tables, n, K, cache=refresh)
    assert subk.fused_layout_window(kern.tables, n, K, refresh) == K
    hull = None if kern.tables.all_box else kern.tables
    code = subk.OPT_REFRESH if refresh else 0
    assert subk.occupancy(n, K, codes=(code,), hull=hull) == {
        name.replace("sleep+", ""): (subk.WIN_THREADS, 1)}
    subk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    want = kern.plain(**kw)
    torch.cuda.synchronize()
    assert dict(subk.FusedSubstepKernel.launches_by_options) == {name: 2}
    for k in subk.OUT_KEYS:
        assert torch.isfinite(got[k]).all() and torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


def dense_pair(card, W=64, n=32):
    """rigid_bench in the dense contact mode ("auto" at 33 rows) on the CPU
    after 3 steps, and on the card from that state."""
    cfg = rb.RigidBenchConfig(num_worlds=W, num_bodies=n, contact_mode="auto", seed=3,
                              spawn_xy=3.0, spawn_h=4.0)
    cpu = rb.make_executor(cfg, device="cpu")
    cpu.run(3)
    gpu = rb.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    return cpu, gpu


@pytest.mark.cuda
def test_dense_step_on_card_matches_cpu(card):
    """One dense-mode step on the card and on the CPU from one state:
    poses 1e-4, velocities 1e-3; the step repeated on the card from that
    state bit-identical; no kernel launched."""
    cpu, gpu = dense_pair(card)
    start = state_to_numpy(gpu.state)
    cpu.step()
    gpu.step()
    first = state_to_numpy(gpu.state)
    gpu.state = state_from_numpy(start, card)
    gpu.step()
    again = state_to_numpy(gpu.state)
    assert subk.FusedSubstepKernel.launches == 0 and subk.SubstepKernel.launches == 0
    a = state_to_numpy(cpu.state)["arch"]["RigidBenchBody"]["comps"]
    b = first["arch"]["RigidBenchBody"]["comps"]
    for comp, tol in (("Position", 1e-4), ("Rotation", 1e-4), ("Velocity", 1e-3)):
        for f in a[comp]:
            np.testing.assert_allclose(b[comp][f], a[comp][f], atol=tol, rtol=0,
                                       err_msg=f"{comp}.{f}")
    for x, y in zip(sap_cases.leaves(first["arch"]), sap_cases.leaves(again["arch"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "sap"])
def test_dense_and_sap_steps_wait_for_nothing(card, mode):
    """A dense-mode step and a sap step (with the fused kernel) queue their
    work and return: no operation makes the host wait for the card."""
    if mode == "dense":
        cfg = rb.RigidBenchConfig(num_worlds=16, num_bodies=32, contact_mode="auto")
    else:
        cfg = rb.RigidBenchConfig(num_worlds=16, num_bodies=200, contact_mode="pallas")
    sim = rb.make_executor(cfg, device="cuda")
    sim.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == (0 if mode == "dense" else 4)


# -- the RL training path --------------------------------------------------


@pytest.mark.cuda
def test_learner_on_card_matches_cpu(card):
    """One train step of the scripted RL world on the card and on the CPU
    from the same parameters and draws: loss, mean reward, parameters,
    Adam state and observation statistics within the train step's
    tolerances against JAX (tests/test_torch_rl_cases.py LEARNER_TOL)."""
    cpu = rl_cases.rl_train_step("cpu")
    card_ = rl_cases.rl_train_step("cuda")
    diff = rl_cases.rl_card_vs_cpu(card_, cpu)
    assert not rl_cases.within(diff, rl_cases.LEARNER_TOL), diff
    assert cpu[1] > 0                   # rewards were dealt


@pytest.mark.cuda
def test_train_step_waits_for_nothing(card):
    """A train step (rollout, GAE, minibatched epochs, Adam, observation
    statistics) queues its work and returns: no operation in it makes the
    host wait for the card."""
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(
        fvs.FantasyVsConfig(num_worlds=16, num_dragons=3, num_knights=6, seed=4),
        device="cuda")
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl_cases.RL_PPO),
                            sim.graph.step, obs_fn, inject_fn, reward_fn,
                            done_fn=rl_cases.done_fn, device="cuda")
    state, _, _ = learner.train_step(sim.state)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in learner.params.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, loss, rew = learner.train_step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert loss.device.type == "cuda" and torch.isfinite(loss) and torch.isfinite(rew)
    assert any(not torch.equal(before[k], v) for k, v in learner.params.items())
    assert float(learner.norm["count"]) == pytest.approx(1e-4 + 3 * 4 * 16, rel=1e-6)


@pytest.mark.cuda
def test_bindings_zero_copy_on_card(card):
    """exported_tensor(...).to_torch() on the card is the column itself;
    an injected action round-trips through set_exported and a step."""
    sim = col.make_executor(col.CollisionsConfig(num_worlds=4, num_objects=8, max_pairs=64,
                                                 seed=1), device="cuda")
    t = exported_tensor(sim, 0)
    tt = t.to_torch()
    column = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    assert tt.device.type == "cuda" and tt.data_ptr() == column.data_ptr()
    host = t.sync().to_numpy()
    np.testing.assert_array_equal(host, column.cpu().numpy())
    actions = tt.clone()
    actions[:, :, 2] = 5.0
    sim.set_exported(0, Tensor.from_torch(actions))
    sim.step()
    t2 = exported_tensor(sim, 0).sync()
    assert ((t2.values[t2.mask][:, 2] - 5.0).abs() < 2.0).all()
    hp = exported_tensor(fvs.make_executor(fvs.FantasyVsConfig(num_worlds=2, num_dragons=3,
                                                               num_knights=5), device="cuda"), 1)
    assert hp.to_torch()["hp"].device.type == "cuda" and hp.shape == (2, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["table", "random"])
def test_reset_on_card_matches_cpu(card, which):
    """40 steps of a reset world (several resets a world) on the card and
    on the CPU: positions, masks and ticks equal (the generator's integer
    stream and the float32 subtractions are the same on both)."""
    world = rl_cases.PORT_TABLE if which == "table" else rl_cases.PORT_RANDOM
    cpu = rl_cases.reset_run(world, "cpu", 40, num_worlds=64)
    gpu = rl_cases.reset_run(world, "cuda", 40, num_worlds=64)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a, b)
    assert int((cpu[2][1:] == 1).sum()) >= 64 * 3    # resets happened


# -- general hulls: the imported prism of tests/test_torch_hull_scenes.py -----

# the general-hull specialisations, each on a hull pile (prisms and spheres)
# with its options, on prisms stacked face on face ("stacked_...": prisms
# only) and on the pile of the 24-sided prism ("large_...": tables past
# PhysicsLoader()'s defaults); mixes of sleep and stable flags set
HULL_CASES = {"none_K256": dict(max_candidates=256), "none_K128": dict(max_candidates=128),
              "stacked": dict(body_mix="boxes", stacked=True), **OPTION_CASES,
              "large_K256": dict(max_candidates=256, large=True),
              **{f"stacked_{k}": dict(v, body_mix="boxes", stacked=True)
                 for k, v in OPTION_CASES.items()},
              **{f"large_{k}": dict(v, large=True) for k, v in OPTION_CASES.items()}}


def hull_case(case, dev, W=64):
    """(kernel, inputs) of a hull pile case at a mid-pile state (or, for the
    stacked cases, prisms resting face on face in columns), every branch
    taken."""
    cfg = dict(dict(contact_mode="pallas", spawn_xy=3.0, spawn_h=5.0, seed=3, num_worlds=W),
               **HULL_CASES[case])
    large, stacked = cfg.pop("large", False), cfg.pop("stacked", False)
    sim = hull_scenes.hull_pile(rb.RigidBenchConfig(**cfg), device=dev, large=large)
    if stacked:
        hull_scenes.stack_prisms(sim)
    sim.run(0 if stacked else 6)
    kw = fused_inputs(sim)
    worlds = torch.arange(W, device=dev)
    if "active" in kw:
        kw["active"] = worlds % 3 != 1
    if "stable" in kw:
        kw["stable"] = worlds % 2 == 0
    return RigidBodyPhysicsSystem.fused_kernel(sim), kw


def hull_pairs(kw, tables):
    """The valid candidate slots [W, K] whose two rows are hulls (the
    kernels' lane groups take them)."""
    prim = torch.as_tensor(tables.om["prim_type"], device=kw["obj"].device)
    pa = prim[torch.gather(kw["obj"], 1, kw["rows_i"].long()).long()]
    pb = prim[torch.gather(kw["obj"], 1, kw["rows_j"].long()).long()]
    return kw["kvalid"] & (pa == 1) & (pb == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HULL_CASES))
def test_fused_substep_hull_matches_plain(card, case):
    """Each fused specialisation on general-hull tables (its "+hull" launch)
    against the plain version, bit for bit (integers, poses, stashes, AABBs,
    the cache and velocities); two launches bit-identical.  Where the
    candidate rows are inputs, hull pairs are among them (the lane-group
    path runs)."""
    kern, kw = hull_case(case, card)
    assert not kern.tables.all_box
    if kw.get("rows_i") is not None:
        assert int(hull_pairs(kw, kern.tables).sum()) > 0
    subk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    torch.cuda.synchronize()
    (name, count), = subk.FusedSubstepKernel.launches_by_options.items()
    assert count == 2 and name.endswith("hull"), name
    want = kern.plain(**kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], again[k]), k
        assert k in INT_KEYS or torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), (k, float((got[k].float() - want[k].float()).abs()
                                                    .max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pile", "stacked", "joints", "large"])
def test_substep_hull_matches_plain(card, case):
    """Kernel 5 on general-hull tables: without FULL on a hull pile's first
    substep (a mid-pile state, stacked prisms, the 24-sided prism's pile),
    and its node launch on the joint world with the prism for its boxes;
    bit for bit the plain version, two launches bit-identical."""
    if case == "joints":
        sim = joint_world("pallas", num_worlds=8, device=card, body=hull_scenes.prism_object())
        sim.run(5)
        kern = RigidBodyPhysicsSystem.substep_kernel(sim)
        kw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, None, None, node=True)
        torch.cuda.synchronize()
        subk.SubstepKernel.launches = subk.SubstepKernel.hull_launches = 0
        got, again = kern.step(**kw), kern.step(**kw)
        want = kern.step_plain(**kw)
    else:
        fkern, fkw = hull_case({"pile": "none_K256", "large": "large_K256"}.get(case, case),
                               card)
        kw = RigidBodyPhysicsSystem.substep_kernel_inputs(fkw)
        tables = fkern.tables
        got, again = (subk.substep(**kw, tables=tables, relaxation=0.7) for _ in range(2))
        want = subk.substep_plain(**kw, tables=tables, relaxation=0.7)
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == subk.SubstepKernel.hull_launches == 2
    for k in want:
        assert torch.isfinite(got[k]).all() and torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


@pytest.mark.cuda
def test_hull_tables_over_the_caps_are_refused(card):
    """A general-hull table whose staged rows pass the shared-memory budget
    is refused by name on the card, before any launch, by the in-kernel
    broadphase (whose rows stay in shared memory), and taken by the other
    launches with the bodies and hull rows in a global scratch; past
    PhysicsLoader()'s default caps (17 edge directions, 33 verts) it
    launches, bit for bit the plain version."""
    kern, kw = hull_case("none_K256", card, W=4)
    tables = kern.tables
    wide = dict(tables.om)
    wide["edge_dirs"] = np.pad(wide["edge_dirs"], ((0, 0), (0, 17 - wide["edge_dirs"].shape[1]),
                                                   (0, 0)))
    wide["verts"] = np.pad(wide["verts"], ((0, 0), (0, 33 - wide["verts"].shape[1]), (0, 0)))
    subk.FusedSubstepKernel.launches = 0
    out = subk.fused_substep(**kw, tables=subk.pk.ObjTables(wide), num_substeps=4)
    want = subk.fused_substep_plain(**kw, tables=tables, num_substeps=4)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 1
    for k in subk.OUT_KEYS:
        assert torch.equal(out[k], want[k]), k
    wide["verts"] = np.pad(wide["verts"], ((0, 0), (0, 4096 - 33), (0, 0)))
    over = subk.pk.ObjTables(wide)
    with pytest.raises(NotImplementedError, match="4096 verts.*hull-row budget"):
        subk.fused_substep(**kw, tables=over, num_substeps=4, **bp_args(kw))
    assert subk.FusedSubstepKernel.launches == 1
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    assert subk.kernel_fits(over, n, K) == "" and subk.fused_bodies(over, n, K)


# -- kernels 7 and 10 past one block's shared memory ----------------------------

# rigid_bench piles whose fused-kernel slot layout passes 227 KB (n = 240,
# 256 and 512 rows, K = 4 x bodies; the prism pile at 240 and 256 rows),
# dropped close together so that their worlds' valid slots pass the
# window: the windowed layout and its global scratch run
WINDOW_PILES = {"boxes_239": (239, False), "boxes_255": (255, False), "boxes_511": (511, False),
                "prisms_239": (239, True), "prisms_255": (255, True)}
WINDOW_OPTIONS = {"none": (False, False), "refresh": (True, False), "sleep": (False, True),
                  "refresh_sleep": (True, True)}
_window_states = {}


def window_pile(name, dev, W=16):
    """(sim, the fused kernel's inputs) of a WINDOW_PILES pile after 3
    steps on the card, made once."""
    if name not in _window_states:
        bodies, prisms = WINDOW_PILES[name]
        cfg = rb.RigidBenchConfig(num_worlds=W, num_bodies=bodies, contact_mode="pallas",
                                  spawn_xy=4.0, spawn_h=6.0, seed=5)
        sim = (hull_scenes.hull_pile(cfg, device=dev) if prisms
               else rb.make_executor(cfg, device=dev))
        sim.run(3)
        _window_states[name] = (sim, fused_inputs(sim))
    return _window_states[name]


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(WINDOW_OPTIONS))
@pytest.mark.parametrize("pile", sorted(WINDOW_PILES))
def test_fused_substep_windowed_matches_plain_bit_for_bit(card, pile, option):
    """Each non-broadphase specialisation of the fused kernel at shapes
    past one block's shared memory (its "...win" launch: the window in
    shared memory, the rest in a global scratch) against the plain version,
    bit for bit; two launches bit-identical; the valid slots pass the
    window wherever it is below K (at 239 and 255 boxes without the cache
    it holds every slot)."""
    sim, kw = window_pile(pile, card)
    refresh, sleep = WINDOW_OPTIONS[option]
    kern = subk.FusedSubstepKernel(sim.world_cls.objmgr, 4, relaxation=0.7,
                                   contact_refresh=refresh)
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    assert subk.windowed(kern.tables, n, K, cache=refresh) and subk.kernel_fits(
        kern.tables, n, K, cache=refresh) == ""
    window = subk.fused_window(n, K, refresh, subk.hull_stage_bytes(kern.tables, n))
    assert window == K or int(kw["kvalid"].sum(1).max()) > window
    if pile == "boxes_511" or WINDOW_PILES[pile][1] or refresh:
        assert window < K
    if sleep:
        kw = dict(kw, active=torch.arange(W, device=card) % 3 != 1)
    subk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    torch.cuda.synchronize()
    (name, count), = subk.FusedSubstepKernel.launches_by_options.items()
    assert count == 2 and "win" in name and name.endswith("hull") == WINDOW_PILES[pile][1], name
    want = kern.plain(**kw)
    for k in subk.OUT_KEYS:
        assert torch.isfinite(got[k]).all() and torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


@pytest.mark.cuda
def test_fused_substep_past_the_window_budget_is_refused(card):
    """The windowed layout's ceiling (the most rigid_bench bodies whose
    smallest window, a round of the twin's block, fits beside them), and one
    body past it, which a window budget once refused: the ceiling's shape
    launches the windowed twin, the next the twin with the bodies in a
    global scratch ("win+bodies"), both bit for bit the plain version."""
    kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    ceiling = 200
    while subk.fused_window(ceiling + 2, 4 * (ceiling + 1)) > 0:
        ceiling += 1
    assert 700 < ceiling < 969
    for bodies, name in ((ceiling, "win"), (ceiling + 1, "win+bodies")):
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=2, num_bodies=bodies,
                                                   contact_mode="pallas"), device=card)
        kw = fused_inputs(sim)
        subk.FusedSubstepKernel.launches_by_options.clear()
        out = kern(**kw)
        torch.cuda.synchronize()
        assert dict(subk.FusedSubstepKernel.launches_by_options) == {name: 1}
        want = kern.plain(**kw)
        for k in subk.OUT_KEYS:
            assert torch.equal(out[k], want[k]), k


# -- kernels 5 and 7 past their body-row ceilings (the bodies in a global
# scratch) ------------------------------------------------------------------

# rigid_bench piles past the windowed layout's body ceiling (969 bodies; 895
# with contact refresh), the prism pile past its own (371; 342), dropped
# close together so that their worlds' valid slots pass the window
BODY_PILES = {"boxes_969": (969, False), "prisms_371": (371, True)}
_body_states = {}


def body_pile(name, dev, W=4):
    """(sim, the fused kernel's inputs) of a BODY_PILES pile after 3 steps
    on the card, made once."""
    if name not in _body_states:
        bodies, prisms = BODY_PILES[name]
        cfg = rb.RigidBenchConfig(num_worlds=W, num_bodies=bodies, contact_mode="pallas",
                                  spawn_xy=6.0, spawn_h=9.0, seed=5)
        sim = (hull_scenes.hull_pile(cfg, device=dev) if prisms
               else rb.make_executor(cfg, device=dev))
        sim.run(3)
        _body_states[name] = (sim, fused_inputs(sim))
    return _body_states[name]


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(WINDOW_OPTIONS))
@pytest.mark.parametrize("pile", sorted(BODY_PILES))
def test_fused_substep_bodies_in_scratch_matches_plain_bit_for_bit(card, pile, option):
    """Each windowed specialisation of the fused kernel past its body
    ceiling (its "...win+bodies" launch: the bodies, lists and hull rows in
    a global scratch beside the work entries past the window) against the
    plain version, bit for bit; two launches bit-identical; the valid slots
    pass the window."""
    sim, kw = body_pile(pile, card)
    refresh, sleep = WINDOW_OPTIONS[option]
    kern = subk.FusedSubstepKernel(sim.world_cls.objmgr, 4, relaxation=0.7,
                                   contact_refresh=refresh)
    W, n = kw["obj"].shape
    K = kw["rows_i"].shape[1]
    assert subk.fused_bodies(kern.tables, n, K, cache=refresh)
    assert subk.kernel_fits(kern.tables, n, K, cache=refresh) == ""
    window = subk.fused_layout_window(kern.tables, n, K, refresh)
    assert int(kw["kvalid"].sum(1).max()) > window
    if sleep:
        kw = dict(kw, active=torch.arange(W, device=card) % 3 != 1)
    subk.FusedSubstepKernel.launches_by_options.clear()
    got, again = kern(**kw), kern(**kw)
    torch.cuda.synchronize()
    (name, count), = subk.FusedSubstepKernel.launches_by_options.items()
    assert count == 2 and "win+bodies" in name
    assert name.endswith("hull") == BODY_PILES[pile][1], name
    want = kern.plain(**kw)
    for k in subk.OUT_KEYS:
        assert torch.isfinite(got[k]).all() and torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["substep_n816", "node_n1068_J64"])
def test_substep_bodies_in_scratch_matches_plain_bit_for_bit(card, case):
    """Kernel 5 past its window layout's 227 KB, with the bodies in a global
    scratch: its JAX contract (no integrate, no joints) on rigid_bench at
    815 bodies + the plane, and its node launch on simple_taskgraph at
    1,064 objects (1,068 rows, K = 10,640) with random live joints among
    its 64 joint rows; bit for bit the plain version, two launches
    bit-identical, each counted in body_launches."""
    subk.SubstepKernel.launches = subk.SubstepKernel.body_launches = 0
    if case == "substep_n816":
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=4, num_bodies=815,
                                                   contact_mode="pallas"), device=card)
        sim.run(3)
        a = RigidBodyPhysicsSystem.substep_kernel_inputs(fused_inputs(sim))
        tables = subk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
        n, K = a["im"].shape[1], a["rows_i"].shape[1]
        assert subk.substep_bodies(tables, n, K)
        assert int(a["kvalid"].sum(1).max()) > subk.SUBSTEP_WINDOW
        subk.SubstepKernel.launches = subk.SubstepKernel.body_launches = 0
        got, again = (subk.substep(**a, tables=tables, relaxation=0.7) for _ in range(2))
        want = subk.substep_plain(**a, tables=tables, relaxation=0.7)
        keys = subk.SUBSTEP_KEYS
    else:
        sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=4, num_objects=1064,
                                                          seed=3), device=card)
        sim.run(1)
        kern = RigidBodyPhysicsSystem.substep_kernel(sim)
        kw = random_joints(sim, RigidBodyPhysicsSystem.next_step_kernel_inputs(
            sim, stg.Sphere, None, node=True), num_spheres=1064)
        n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
        assert subk.substep_bodies(kern.tables, n, K, J) and J == 64
        rows = [entity_rows(kw["eid"], kw["joints"][e], kw["arch_index"]) for e in ("e1", "e2")]
        assert bool((kw["jmask"] & (rows[0] >= 0) & (rows[1] >= 0)).any())
        subk.SubstepKernel.launches = subk.SubstepKernel.body_launches = 0
        got, again = kern.step(**kw), kern.step(**kw)
        want = kern.step_plain(**kw)
        keys = subk.NODE_KEYS
    torch.cuda.synchronize()
    assert subk.SubstepKernel.launches == subk.SubstepKernel.body_launches == 2
    for k in keys:
        assert torch.isfinite(got[k]).all() and torch.equal(got[k], again[k]), k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


# the rows' state past shared memory from this count on
SJ_ROWS_PAST = 1 + max(n for n in range(1025, 4097) if sk.rounds_rows_shared(n))
# case: (n0, worlds, K, D)
SJ_LARGE = {"1025": (1025, 8, 16 * 1025, 32), "2048": (2048, 8, 16 * 2048, 32),
            "rows_past_shared": (SJ_ROWS_PAST, 2, 16 * SJ_ROWS_PAST, 32),
            "4096": (4096, 2, 16 * 4096, 32), "cap_100_cut": (2048, 4, 20000, 100)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SJ_LARGE))
def test_fused_simple_jobs_step_past_one_block_matches_plain(card, case):
    """Kernel 4's rounds layout past 1,024 bodies (one past
    rounds_rows_shared and at 4,096 the rows' state in the global scratch),
    dense worlds over the example's bounds, K = 16 n0, D = 32, and at 2,048
    rows kept up to a cap of 100 with the slots cut at K = 20,000:
    integers, lo and hi exact (tails included), translation atol 1e-4,
    normals atol 1e-5, as the one-block cases; a repeated launch
    bit-identical."""
    n0, W, K, D = SJ_LARGE[case]
    pos, rot = sj_inputs(7, W, n0, 10.0, card)
    kw = dict(n0=n0, K=K, degree_cap=D, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    assert sk.rounds(n0) and sk.rounds_rows_shared(n0) == (n0 < SJ_ROWS_PAST)
    got = sk.fused_simple_jobs_step(pos, rot, **kw)
    again = sk.fused_simple_jobs_step(pos, rot, **kw)
    torch.cuda.synchronize()
    assert sk.fused_simple_jobs_step.launches == 2
    want = sk.fused_simple_jobs_step_plain(pos, rot, **kw)
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "normals": 1e-5}
    for name, g, g2, w in zip(names, got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), g2.view(torch.int32)), name
        if name in atol:
            torch.testing.assert_close(g, w, atol=atol[name], rtol=0, msg=name)
            assert torch.isfinite(g).all(), name
        else:
            assert torch.equal(g, w), name
    assert (want[6] > 0).all() and (want[5] > 1000).all()
    if case in ("4096", "cap_100_cut"):
        assert (want[5] > kw["K"]).all()        # slots cut
    if case == "cap_100_cut":                   # rows past 64 partners kept, and at the cap
        deg = sk.overlap_grid(want[1], want[2]).sum(-1)
        assert bool((deg > 64).any()) and bool((deg > D).any())


# kernel 4's stepped translation against the push in float64: chip_smoke.py's
# SJL_F64_ATOL (about twice the plain version's distance on an H100)
SJ_STEPPED_F64_ATOL = 1.5e-4


def sj_push_f64(pos, rot, bounds):
    """The fused step's translation evaluated in float64 (the plain
    version's formula on the float32 AABBs' overlaps)."""
    p = sk.clamp_to_bounds(pos, bounds)
    lo, hi = sk.aabb_plain(p, rot)
    ok = sk.overlap_grid(lo, hi)
    p64 = p.double()
    pc = p64 - p64.mean(dim=1, keepdim=True)
    diff = pc[:, None, :, :] - pc[:, :, None, :]
    d2 = (diff * diff).sum(-1)
    m = torch.where(ok & (d2 > 1e-12), torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
    return p64 - 2.0 * (m[..., None] * diff).sum(dim=2)


@pytest.mark.cuda
def test_fused_simple_jobs_stepped_translation_near_float64(card):
    """Kernel 4's rounds layout at simple_jobs' 2,048 objects after 3 steps
    of the executor (8 worlds, K = 32,768, D = 32: bodies pressed against
    the bounds, rows summing ~110-190 pushes to |sum| ~180), which sums a
    row's pushes in a fixed tree: the translation within
    SJ_STEPPED_F64_ATOL of the push in float64, the integers and normals as
    its plain version's, a repeated launch bit-identical."""
    sim = sj.make_executor(sj.SimpleJobsConfig(num_worlds=8, num_objects=2048,
                                               max_pairs=32768, degree_cap=32), device=card)
    sim.run(3)
    user = sim.state["user"]
    pos, rot = user["translation"], user["rotation"]
    kw = dict(n0=2048, K=32768, degree_cap=32, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    got, again = (sk.fused_simple_jobs_step(pos, rot, **kw) for _ in range(2))
    want = sk.fused_simple_jobs_step_plain(pos, rot, **kw)
    exact = sj_push_f64(pos, rot, kw["bounds"])
    torch.cuda.synchronize()
    for g, g2 in zip(got, again):
        assert torch.equal(g.view(torch.int32), g2.view(torch.int32))
    err = float((got[0].double() - exact).abs().max())
    assert err <= SJ_STEPPED_F64_ATOL, err
    for name, i in (("lo", 1), ("hi", 2), ("ab", 3), ("counts", 5), ("dropped", 6)):
        assert torch.equal(got[i], want[i]), name
    torch.testing.assert_close(got[4], want[4], atol=1e-5, rtol=0)


def chain_node_case(dev, W=4):
    """(SubstepKernel, node inputs) of the chains' world (4,096 joint rows,
    60 live Fixed and Hinge joints a world) two steps in: kernel 5 with its
    joint rows in the body scratch."""
    sim = chain_world("pallas", num_worlds=W, device=dev)
    sim.run(2)
    kern = RigidBodyPhysicsSystem.substep_kernel(sim)
    kw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, sim.world_cls.Body, None,
                                                        node=True)
    return kern, kw


@pytest.mark.cuda
def test_substep_node_joint_rows_in_scratch_matches_plain_bit_for_bit(card):
    """Kernel 5's node launch with 4,096 joint rows (past what fits beside
    its window: the rows in the body scratch), four successive launches (a
    step's substep nodes) bit for bit as many of its plain version, two
    launches on one input bit-identical, each counted."""
    kern, kw = chain_node_case(card)
    n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
    assert J == 4096 and subk.substep_joints_in_scratch(kern.tables, n, K, J)
    assert int(kw["jmask"].sum(1).min()) == 60
    subk.SubstepKernel.launches = subk.SubstepKernel.joint_scratch_launches = 0
    again = kern.step(**kw)
    got_kw, want_kw = dict(kw), dict(kw)
    for t in range(4):
        got, want = kern.step(**got_kw), kern.step_plain(**want_kw)
        torch.cuda.synchronize()
        for k in subk.NODE_KEYS:
            assert torch.isfinite(got[k]).all(), k
            assert torch.equal(got[k], want[k]), (t, k, float((got[k] - want[k]).abs().max()))
            if t == 0:
                assert torch.equal(got[k], again[k]), k
        got_kw.update({k: got[k] for k in subk.SUBSTEP_KEYS})
        want_kw.update({k: want[k] for k in subk.SUBSTEP_KEYS})
    assert subk.SubstepKernel.launches == subk.SubstepKernel.joint_scratch_launches == 5


@pytest.mark.cuda
def test_substep_node_joint_lists_in_scratch_matches_plain_bit_for_bit(card):
    """Kernel 5's bodies-in-scratch twin with 32,768 joint rows: the joint
    rows and the per-body joint lists past its shared memory (both in the
    body scratch), every body channel in shared memory; two successive
    launches bit for bit as many of its plain version, a repeat
    bit-identical."""
    sim = chain_world("pallas", num_worlds=2, device=card, max_joints=32768)
    sim.run(2)
    kern = RigidBodyPhysicsSystem.substep_kernel(sim)
    kw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, sim.world_cls.Body, None,
                                                        node=True)
    n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
    assert J == 32768 and subk.substep_joints_in_scratch(kern.tables, n, K, J)
    plan = subk.substep_body_plan(n, K, J, True)
    assert not plan["joint_lists"] and plan["hot"] == subk.BODY_CH
    again = kern.step(**kw)
    got_kw, want_kw = dict(kw), dict(kw)
    for t in range(2):
        got, want = kern.step(**got_kw), kern.step_plain(**want_kw)
        torch.cuda.synchronize()
        for k in subk.NODE_KEYS:
            assert torch.equal(got[k], want[k]), (t, k, float((got[k] - want[k]).abs().max()))
            if t == 0:
                assert torch.equal(got[k], again[k]), k
        got_kw.update({k: got[k] for k in subk.SUBSTEP_KEYS})
        want_kw.update({k: want[k] for k in subk.SUBSTEP_KEYS})


WIDE_BOX_CASES = ["none", *sorted(OPTION_CASES)]
# the all-box tables wider than a box's 8 verts: padded to 9 and 32 verts a
# hull (bit for bit the box table), and the first box carrying 12 and 20
# live verts (its corners and edge midpoints: more live hull-plane
# candidates than 8 and than pairs.py's 12, merged by the wide path)
WIDE_BOX_TABLES = [9, 32, "12 live", "20 live"]


def wide_box_table(om, table):
    if isinstance(table, int):
        return padded_boxes(om, table)
    return hull_scenes.live_vert_box(om, int(table.split()[0]))


def box_plane_pairs(tables, kw):
    """Valid candidate slots of kw that pair the first box with a plane."""
    o = int(np.flatnonzero(tables.om["prim_type"] == 1)[0])
    obj = kw["obj"].long()
    oi, oj = torch.gather(obj, 1, kw["rows_i"].long()), torch.gather(obj, 1, kw["rows_j"].long())
    plane = torch.as_tensor(tables.om["prim_type"] == 2, device=obj.device)
    return int((kw["kvalid"].bool() & (((oi == o) & plane[oj]) | ((oj == o) & plane[oi])))
               .sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_BOX_CASES)
@pytest.mark.parametrize("vm", WIDE_BOX_TABLES)
def test_wide_box_tables_match_plain_bit_for_bit(card, vm, case):
    """All-box tables wider than 8 verts a hull through every fused option
    set (each specialisation of kernels 6-9) and kernel 5's node: bit for
    bit the plain version; the padded tables also bit for bit the same
    launch on the box table (the padding changes nothing).  Outside the
    in-kernel broadphase's cases the first box meets the plane in some
    valid slot."""
    import copy
    if case == "none":
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=64, contact_mode="pallas",
                                                   spawn_xy=4.0, spawn_h=6.0, seed=3),
                               device=card)
        sim.run(6)
        kern, kw = RigidBodyPhysicsSystem.fused_kernel(sim), fused_inputs(sim)
    else:
        kern, kw = option_case(case, card)
    wide = copy.copy(kern)
    wide.tables = subk.pk.ObjTables(wide_box_table(kern.tables.om, vm))
    assert wide.tables.all_box and subk.wide_box(wide.tables)
    if "kvalid" in kw and "bp" not in case:
        assert box_plane_pairs(wide.tables, kw) > 0
    subk.FusedSubstepKernel.launches = 0
    got, own = wide(**kw), kern(**kw)
    torch.cuda.synchronize()
    assert subk.FusedSubstepKernel.launches == 2
    want = wide.plain(**kw)
    for k in want:
        assert torch.equal(got[k], want[k]), (k, float((got[k].float() - want[k].float())
                                                       .abs().max()))
        if isinstance(vm, int):
            assert torch.equal(got[k], own[k]), k
    # kernel 5's node on the joint world (its free box on the plane, tilted
    # 40 degrees about x and sunk to z = 0.25, so that edge midpoints are
    # among its deepest 4 and below the plane), the table widened likewise
    kern5, kw5 = node_case("joints_landed", card)
    kw5["pos"], kw5["rot"] = kw5["pos"].clone(), kw5["rot"].clone()
    kw5["pos"][:, 5, 2] = 0.25
    kw5["rot"][:, 5] = torch.tensor([np.cos(np.radians(20)), np.sin(np.radians(20)), 0, 0])
    wide5 = copy.copy(kern5)
    wide5.tables = subk.pk.ObjTables(wide_box_table(kern5.tables.om, vm))
    assert box_plane_pairs(wide5.tables, kw5) > 0
    got, own, want = wide5.step(**kw5), kern5.step(**kw5), wide5.step_plain(**kw5)
    torch.cuda.synchronize()
    for k in subk.NODE_KEYS:
        assert torch.equal(got[k], want[k]), k
        if isinstance(vm, int):
            assert torch.equal(got[k], own[k]), k
    # the live verts past 8 change the tilted box's contacts
    assert isinstance(vm, int) or not all(torch.equal(got[k], own[k]) for k in subk.NODE_KEYS)


ENTITY64_NODE = """
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from gpu_ecs_madrona_tpu_torch.core.component import ENTITY_64, Entity
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem
from test_torch_joint_scenes import random_joints
if sys.argv[2] == "chain":
    from test_torch_joint_scenes import chain_world
    sim = chain_world("pallas", num_worlds=4, device="cuda")
    sim.run(2)
    kern = RigidBodyPhysicsSystem.substep_kernel(sim)
    kw = RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, sim.world_cls.Body, None,
                                                        node=True)
    n, K, J = kw["obj"].shape[1], kw["rows_i"].shape[1], kw["jmask"].shape[1]
    assert subk.substep_joints_in_scratch(kern.tables, n, K, J)
    entities = sim.mgr.entity_column(sim.state, sim.world_cls.Body)
else:
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=8, num_objects=100, seed=3),
                            device="cuda")
    sim.run(3)
    kern = RigidBodyPhysicsSystem.substep_kernel(sim)
    kw = random_joints(sim, RigidBodyPhysicsSystem.next_step_kernel_inputs(
        sim, stg.Sphere, None, node=True), num_spheres=100)
    entities = sim.mgr.entity_column(sim.state, stg.Sphere)
subk.SubstepKernel.launches = 0
got, want = kern.step(**kw), kern.step_plain(**kw)
torch.cuda.synchronize()
for k in subk.NODE_KEYS:
    assert torch.equal(got[k], want[k]), k
assert subk.SubstepKernel.launches == 1
np.savez(sys.argv[1], dtype=str(entities.dtype),
         wide=ENTITY_64, **{k: got[k].cpu().numpy() for k in subk.NODE_KEYS})
print("OK")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["stg", "chain"])
def test_joint_lookup_under_64_bit_handles(card, tmp_path, scene):
    """Kernel 5's in-kernel joint lookup with GEM_TPU_ENTITY_64=1 (32 id
    bits: its masks built in 64 bits), in a process of its own (the flag is
    read at import): simple_taskgraph's node launch with random live joints
    bit for bit its plain version, and bit for bit the same launch under
    int32 handles (a handle of generation 0 has one value at either
    width).  "chain": the chains' world, its 4,096 joint rows in the body
    scratch."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for wide in (False, True):
        env = dict(os.environ)
        env.pop("GEM_TPU_ENTITY_64", None)
        if wide:
            env["GEM_TPU_ENTITY_64"] = "1"
        path = tmp_path / f"node_{int(wide)}.npz"
        r = subprocess.run([sys.executable, "-c", ENTITY64_NODE, str(path), scene], cwd=root,
                           env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr[-3000:]
        out[wide] = np.load(path)
    assert str(out[True]["dtype"]) == "torch.int64" and bool(out[True]["wide"])
    assert str(out[False]["dtype"]) == "torch.int32" and not bool(out[False]["wide"])
    for k in subk.NODE_KEYS:
        assert np.array_equal(out[True][k], out[False][k]), k


def blocked_views_case(dev, W=4, H=24, Wpx=40):
    """tests/test_torch_render_scenes.py's large view case (4,096 instance
    rows a world, past one block's shared memory in the views mode)."""
    return scenes.large_view_case(W=W, H=H, Wpx=Wpx, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rays", "views"])
def test_render_blocked_matches_plain_bit_for_bit(card, mode):
    """4,096 instance rows a world (staged in blocks; hulls, spheres, the
    plane and triangle meshes, a SourceMesh's among them): the rays mode
    against render_plain and the views mode against render_views_plain, bit
    for bit (rgb, hit and depth; RGBA8 and depth bits); a repeat
    bit-identical; the stages a CTA fills at most as stage_blocks says."""
    rk.RenderKernel.launches = 0
    if mode == "rays":
        sc = scenes.large_scene(W=4, res=24)
        k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                            mesh_tables=sc["mesh_tables"])
        rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(card) for key in RENDER_INPUTS))
        # 640 rays in rows of 24: 27 rows, 21 tiles, three strips of 7
        # tiles and stages of 1,120 survivors
        assert rk.blocked(inst.shape[2]) and rk.stage_blocks(inst.shape[2], False, 27, 24) == 4
        kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
        got, again = (rk.render(rays, inst, img_w=sc["img_w"], **kw) for _ in range(2))
        want = rk.render_plain(rays, inst, **kw)
        torch.cuda.synchronize()
        assert bool(want[:, rk.O_HIT].any()) and torch.equal(got, again)
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        k, views, inst, V, H, Wpx = blocked_views_case(card)
        assert rk.blocked(inst[0].shape[1], views=True)
        kw = dict(height=H, width=Wpx, max_views=V)
        got, again = (k.render_views(views, *inst, **kw) for _ in range(2))
        plain = rk.render_views_plain(views, *inst, tables=k.tables, light=k.light,
                                      ambient=k.ambient, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got[1]).any())
        for a in (again, plain):
            assert torch.equal(got[0], a[0])
            assert torch.equal(got[1].view(torch.int32), a[1].view(torch.int32))
    assert rk.RenderKernel.launches == 2


# views-mode blocked cases: (W, H, Wpx, N, the stage forced, or None)
VIEWS_BLOCKED = {"n_2422": (3, 24, 40, 2422, None), "n_4096": (2, 32, 32, 4096, None),
                 "stages_of_96": (2, 24, 40, 4096, 96),
                 "carry_in_outputs": (1, 256, 160, 4096, None),
                 "no_survivors": (2, 24, 40, 4096, None),
                 "tie_across_stages": (2, 24, 40, 4096, 96)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VIEWS_BLOCKED))
def test_render_views_blocked_twin_matches_plain(card, case, monkeypatch):
    """The views mode's blocked twin (one CTA an image, stages of the view's
    survivors) at the edges of its layout: just past one block (2,422
    rows), 4,096 rows in one or two stages, stages forced to 96 survivors
    (dozens of stages, the hits carried in shared memory), a 256 x 160
    image (the hits carried in its outputs), views that see no instance (looking
    away, the plane dead), and a tie of t between rows 3 and 3,000 in
    different stages (the first row in index order wins, in either order
    of the two objects): RGBA8 and depth bits equal to render_views_plain,
    a repeated launch bit-identical."""
    W, H, Wpx, N, stage = VIEWS_BLOCKED[case]
    if stage is not None:
        monkeypatch.setattr(rk, "views_blocked_stage", lambda H, Wpx: stage)
    cases = [scenes.large_view_case(W=W, H=H, Wpx=Wpx, N=N, device=card)]
    if case == "no_survivors":
        k, views, inst, V, _, _ = cases[0]
        views["rot"][:] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=card)   # looking -y
        inst[4][:, 0] = False                                                 # the plane
        cases = [(k, views, inst, V, H, Wpx)]
    if case == "tie_across_stages":
        cases = [scenes.large_tie_case(W=W, H=H, Wpx=Wpx, N=N, swap=swap, device=card)
                 for swap in (False, True)]
    outs = []
    for k, views, inst, V, H, Wpx in cases:
        assert rk.blocked(inst[0].shape[1], views=True)
        kw = dict(height=H, width=Wpx, max_views=V)
        got, again = (k.render_views(views, *inst, **kw) for _ in range(2))
        plain = rk.render_views_plain(views, *inst, tables=k.tables, light=k.light,
                                      ambient=k.ambient, **kw)
        torch.cuda.synchronize()
        for other in (again, plain):
            assert torch.equal(got[0], other[0])
            assert torch.equal(got[1].view(torch.int32), other[1].view(torch.int32))
        outs.append(got)
    hits = torch.isfinite(outs[0][1])
    if case == "no_survivors":
        assert not bool(hits.any())
    else:
        assert bool(hits.any())
    if case == "tie_across_stages":   # the tied sphere's colour follows the first row's object
        assert not torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1].view(torch.int32), outs[1][1].view(torch.int32))
    if case == "carry_in_outputs":
        assert rk.views_carry_bytes(H, Wpx) == 0 < rk.views_carry_bytes(64, 64)
        assert rk.stage_blocks(4096, True, H, Wpx) > 1


# rays-mode blocked cases: (W, res, N, the stage forced or None, the CTAs an
# image forced or None)
RAYS_BLOCKED = {"n_1615": (3, 24, 1615, None, None), "n_4096": (2, 32, 4096, None, None),
                "sweep": (2, 32, 4096, None, None), "tie_across_stages": (2, 0, 4096, 96, None),
                "no_survivors": (2, 24, 4096, None, None),
                "padded_partial_row": (2, 24, 4096, None, None),
                "stages_of_96": (2, 32, 4096, 96, None), "five_strips": (2, 32, 4096, None, 5),
                "many_origins": (2, 32, 4096, 96, None)}


def rays_blocked_inputs(case, card):
    """[(RenderKernel, rays, inst, img_w)] of a RAYS_BLOCKED case: the large
    scene under its camera (tie_across_stages: large_tie_case's views, in
    both orders, as camera rays; sweep: sweep_rays from its eye; no_survivors:
    looking -y, away from every row, the plane dead; padded_partial_row: the
    last 5 rays dropped, so that the zero rays pack adds fill the last row
    but one and a partial last row; many_origins: each ray from its own
    point within 0.3)."""
    W, res, N, _, _ = RAYS_BLOCKED[case]
    if case == "tie_across_stages":
        out = []
        for swap in (False, True):
            k, views, inst, V, H, Wpx = scenes.large_tie_case(W=W, N=N, swap=swap, device=card)
            ro, d = rk.camera_rays(views, V, H, Wpx)
            out.append((k, *k.pack(ro.reshape(W, -1, 3), d.reshape(W, -1, 3), *inst), Wpx))
        return out
    sc = scenes.large_scene(W=W, res=res, N=N)
    ro, rd = sc["ro"], sc["rd"]
    if case == "sweep":
        ro, rd = scenes.sweep_rays(sc["ro"][:, 0], res, res)
    if case == "no_survivors":
        rd = -rd
        sc["mask"][:, 0] = False
    if case == "padded_partial_row":
        ro, rd = ro[:, :-5], rd[:, :-5]
    if case == "many_origins":
        ro = ro + np.random.default_rng(5).uniform(-0.3, 0.3, ro.shape).astype(np.float32)
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    arrays = (ro, rd) + tuple(sc[key] for key in RENDER_INPUTS[2:])
    return [(k, *k.pack(*(torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in arrays)),
             res)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RAYS_BLOCKED))
def test_render_rays_blocked_twin_matches_plain(card, case, monkeypatch):
    """The rays mode's blocked twin (strips of tiles, stages of the survivors
    of each strip's cone) at the edges of its layout: just past one block
    (1,615 rows), 4,096 rows, a 360-degree sweep, a tie of t between rows 3
    and 3,000 in different stages (either order of the two objects), rays
    that see no instance, padded rays with a partial last row, stages forced
    to 96 survivors, five strips forced, and rays from many origins (the
    spread widens the cull; spheres take trace's own test): rgb, hit and
    depth bit for bit render_plain's, a repeated launch bit-identical, one
    launch a call."""
    W, res, N, stage, splits = RAYS_BLOCKED[case]
    if stage is not None:
        monkeypatch.setattr(rk, "rays_blocked_stage", lambda cta_tiles: stage)
    if splits is not None:
        monkeypatch.setattr(rk, "rays_blocked_splits", lambda tiles: splits)
    outs = []
    for k, rays, inst, img_w in rays_blocked_inputs(case, card):
        assert rk.blocked(inst.shape[2])
        kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
        rk.RenderKernel.launches = 0
        got, again = (rk.render(rays, inst, img_w=img_w, **kw) for _ in range(2))
        assert rk.RenderKernel.launches == 2
        want = rk.render_plain(rays, inst, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got, want), float((got - want).abs().max())
        outs.append(got)
    hits = outs[0][:, rk.O_HIT] > 0.5
    assert bool(hits.any()) != (case == "no_survivors")
    if case == "tie_across_stages":   # the tied sphere's colour follows the first row's object
        assert not torch.equal(outs[0][:, :3], outs[1][:, :3])
        assert torch.equal(outs[0][:, 3:], outs[1][:, 3:])
    if case == "padded_partial_row":
        assert rays.shape[2] % img_w != 0 and not bool(hits[:, -69:].any())


@pytest.mark.cuda
def test_render_rays_call_runs_the_twin(card):
    """RenderKernel.__call__ (the JAX class's entry) on 4,096 rows: one
    launch of the rays twin a call, its (rgb, hit, depth) bit for bit what
    render_plain gives on the same packed inputs, cut to the caller's
    rays."""
    sc = scenes.large_scene(W=2, res=24)
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    args = [torch.from_numpy(sc[key]).to(card) for key in RENDER_INPUTS]
    rk.RenderKernel.launches = 0
    rgb, hit, depth = k(*args, img_w=24)
    assert rk.RenderKernel.launches == 1
    rays, inst = k.pack(*args)
    want = rk.render_plain(rays, inst, tables=k.tables, light=k.light,
                           ambient=k.ambient)[:, :, :24 * 24]
    torch.cuda.synchronize()
    assert torch.equal(rgb, want[:, :3].transpose(1, 2))
    assert torch.equal(hit, want[:, rk.O_HIT] > 0.5) and torch.equal(depth, want[:, rk.O_DEPTH])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pallas_scene", "sphere_mesh", "inside_wrapping", "large",
                                  "views_main_state", "views_mesh", "views_source_mesh",
                                  "views_two_views_dead"])
def test_render_blocked_equals_the_single_stage(card, case, monkeypatch):
    """The blocked twins forced (rk.blocked patched to say every count is
    staged in stages) on scenes whose instances fit one stage (the large
    scene cut to 1,024 rows), bit for bit the single-stage kernel in both
    modes: the twins change nothing but what is staged and where."""
    def forced(launch):
        with monkeypatch.context() as m:
            m.setattr(rk, "blocked", lambda N, views=False: True)
            return launch()
    if case.startswith("views_"):
        k, views, inst, V, H, Wpx = views_case(case[len("views_"):], card)
        kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, height=H, width=Wpx,
                  max_views=V)
        a = rk.render_views(views, *inst, **kw)
        b = forced(lambda: rk.render_views(views, *inst, **kw))
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
        return
    if case == "large":
        sc = scenes.large_scene(W=4, res=24, N=1024)
    else:
        sc = scenes.CARD_SCENES[case]()
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    rays, inst = k.pack(*(torch.from_numpy(sc[key]).to(card) for key in RENDER_INPUTS))
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, img_w=sc["img_w"])
    a, b = rk.render(rays, inst, **kw), forced(lambda: rk.render(rays, inst, **kw))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# -- across ranks and the tooling ---------------------------------------------


@pytest.mark.cuda
def test_lookup_is_keyed_cuda_on_the_card(card, tmp_path, monkeypatch):
    """On the card the autotuner's backend is "cuda": a validated "cuda"
    entry {"fused": false, "use_kernel": true} (tune_collisions' unfused
    candidate) makes the default CollisionsConfig(fused=None) run the
    unfused tick with kernel 2 and never kernel 1; a "cpu" entry is not
    taken (the fixed rule: kernel 1); the repository's gem_tune.json
    (entries "tpu") gives None."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    assert autotuner.backend() == "cuda"
    cfg = col.CollisionsConfig(num_worlds=4, num_objects=8, max_pairs=64, seed=1)
    for backend, fused in (("cuda", False), ("cpu", False), ("cuda", True)):
        autotuner.save([{"kind": "collisions", "key": {"num_worlds": 4, "num_objects": 8},
                         "config": {"fused": fused, "use_kernel": True}, "backend": backend,
                         "validated": True}], path)
        ck.fused_collisions_step.launches = ck.collision_pushes.launches = 0
        col.make_executor(cfg, device="cuda").run(2)
        took = fused or backend == "cpu"
        assert (ck.fused_collisions_step.launches, ck.collision_pushes.launches) == \
            ((2, 0) if took else (0, 2)), (backend, fused)
    repo = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "gem_tune.json")
    for kind in ("collisions", "physics_substep", "physics_capacity"):
        assert autotuner.lookup(kind, path=repo, num_worlds=8192, num_objects=100,
                                bodies=64) is None


@pytest.mark.cuda
def test_profile_nodes_on_collisions(card, tmp_path):
    """profile_nodes on the card (CUDA events) at small W: every node and the
    step timed, the executor's state untouched; trace_step's timeline read
    back with its node segments inside their steps."""
    sim = col.make_executor(col.CollisionsConfig(num_worlds=64, num_objects=100, fused=True),
                            device="cuda")
    sim.run(2)
    before = state_to_numpy(sim.state)
    rows = profiler.profile_nodes(sim, iters=5)
    assert [r["node"] for r in rows] == sim.graph.node_names + ["__full_step__"]
    assert all(r["clock"] == "cuda_events" and r["mean_ms"] >= 0 for r in rows)
    assert rows[-1]["mean_ms"] > 0
    tl = profiler.node_timeline(profiler.trace_step(sim, str(tmp_path), steps=3))
    assert len(tl["steps"]) == 3 and tl["nodes"]
    for step in tl["steps"]:
        assert all(0 <= s["start_us"] and s["start_us"] + s["dur_us"] <= step["dur_us"] + 1e-3
                   for s in step["segments"])
    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, tree

    after = dict(leaves(state_to_numpy(sim.state)))
    assert after.keys() == dict(leaves(before)).keys()
    for path, leaf in leaves(before):
        np.testing.assert_array_equal(after[path], leaf, err_msg=str(path))


@pytest.mark.cuda
def test_one_rank_nccl_train_step_matches_unranked(card):
    """The learner over a one-rank NCCL group (the ranked path: the draws
    sliced by worlds, the minibatch statistics, losses and gradients summed
    over the group) against the learner without a mesh, on the card from
    the same parameters and draws: within LEARNER_TOL."""
    env = rank_cases.rl_env("cuda")
    cfg = pl.PPOConfig(obs_dim=env[4], act_dim=env[5], **rl_cases.RL_PPO)
    params = rl_cases.rl_params(cfg)
    eps, perms = rl_cases.rl_draws(cfg, rl_cases.RL_WORLDS)
    plain = rank_cases.rl_update(env, "cuda", params, eps, perms)
    initialize_distributed(f"127.0.0.1:{rank_cases.free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_world_mesh("cuda:0")
        assert torch.distributed.get_backend() == "nccl" and mesh.world_size == 1
        ranked = rank_cases.rl_update(env, "cuda", params, eps, perms, mesh=mesh,
                                      state=shard_state(env[0].state, mesh))
    finally:
        torch.distributed.destroy_process_group()
    diff = rl_cases.learner_differences(ranked, plain, params)
    diff["loss_rel"] = abs(ranked["loss"] - plain["loss"]) / abs(plain["loss"])
    diff["mean_reward"] = abs(ranked["mean_reward"] - plain["mean_reward"])
    assert not rl_cases.within(diff, rl_cases.LEARNER_TOL), diff
    assert ranked["opt_t"] == plain["opt_t"] == 8


@pytest.mark.cuda
def test_rollout_policy_rows_on_card_do_not_depend_on_the_row_count(card):
    """On the card the plain products of 2048 and 4096 rows part (the BLAS
    kernel is picked by shape); the rollout's policy_rows gives each row the
    same result for any row count (main_ppo_fantasy_vs's widths), from one
    block's rows to eight blocks'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = pl.PPOConfig(obs_dim=1250, act_dim=600)
    g = torch.Generator(device=card).manual_seed(0)
    params = pl.init_params(cfg, g)
    obs = torch.randn((8 * pl.ROLLOUT_BLOCK, 1250), generator=g, device=card)
    whole = pl.policy_rows(params, obs)
    half = pl.ROLLOUT_BLOCK // 2
    for lo, hi in ((0, half), (half, pl.ROLLOUT_BLOCK + 3), (pl.ROLLOUT_BLOCK, 3 * pl.ROLLOUT_BLOCK),
                   (0, 4 * pl.ROLLOUT_BLOCK)):
        part = pl.policy_rows(params, obs[lo:hi])
        assert torch.equal(part[0], whole[0][lo:hi]) and torch.equal(part[2], whole[2][lo:hi])
