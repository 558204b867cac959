"""The collisions slice of the PyTorch port against the JAX package.

Same inputs, carried as numpy arrays: the JAX executor's state is
converted leaf by leaf into the port's (interop.state_from_numpy), both
step, and every leaf but ``rng`` is compared after each step.  Tolerances:
positions and the fused push stash atol 1e-4 (tests/test_ops.py:94-111),
AABB columns atol 1e-5, everything else (masks, handles, id tables, tick,
overflow counters, untouched floats) exact.  The port runs on the CPU and
so through its kernels' plain versions; the JAX package's fused path runs
its Pallas kernel in interpret mode.
"""

import os
import struct

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.core.executor import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu.core.executor import TaskGraphExecutor as JExecutor
from gpu_ecs_madrona_tpu.core.taskgraph import NodeID as JNodeID
from gpu_ecs_madrona_tpu.models import collisions as jcol
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.utils import math as m

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
W, N, MAX_PAIRS, SEED = 4, 24, 256, 3


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


POS_ATOL, AABB_ATOL = 1e-4, 1e-5


def tolerance(path):
    if "Translation" in path or path == ("user", "push_delta"):
        return POS_ATOL
    if "PhysicsAABB" in path:
        # an AABB is the pre-push position -+ the extent: it carries the
        # positions' drift, and its own arithmetic is held to AABB_ATOL on
        # the extent (hi - lo) below
        return POS_ATOL + AABB_ATOL
    return 0.0


def assert_states_match(jstate, pstate, where=""):
    jl = dict(leaves(jax.tree_util.tree_map(np.asarray, jstate)))
    pl = dict(leaves(state_to_numpy(pstate)))
    jl.pop(("rng",))
    pl.pop(("rng",))
    assert jl.keys() == pl.keys(), where
    for path, want in jl.items():
        got = pl[path]
        assert got.dtype == want.dtype and got.shape == want.shape, (where, path)
        tol = tolerance(path)
        if tol:
            np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                       err_msg=f"{where} {path}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {path}")
    aabb = ("arch", "CubeObject", "comps", "PhysicsAABB")
    extent = [d[aabb + ("hi",)] - d[aabb + ("lo",)] for d in (pl, jl)]
    finite = np.isfinite(extent[1])
    np.testing.assert_allclose(extent[0][finite], extent[1][finite], atol=AABB_ATOL,
                               rtol=0, err_msg=f"{where} AABB extent")


def cfgs(fused, use_kernel=False):
    kw = dict(num_worlds=W, num_objects=N, max_pairs=MAX_PAIRS, seed=SEED, fused=fused)
    return (jcol.CollisionsConfig(use_pallas=False, **kw),
            col.CollisionsConfig(use_kernel=use_kernel, **kw))


def converted(jsim):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")


@pytest.mark.parametrize("fused,use_kernel", [(False, False), (True, False),
                                              (False, True)],
                         ids=["gram", "fused", "pushes"])
def test_trajectory_parity(fused, use_kernel):
    """Five steps from the same (converted) state, every leaf compared.
    use_kernel runs the port's collision_pushes (plain on the CPU) against
    the JAX package's XLA solver: the same pushes by another formula."""
    jcfg, pcfg = cfgs(fused, use_kernel)
    jsim = jcol.make_executor(jcfg, donate=False)
    psim = col.make_executor(pcfg, device="cpu")
    psim.state = converted(jsim)
    assert_states_match(jsim.state, psim.state, "init")
    for t in range(5):
        jsim.step()
        psim.step()
        assert_states_match(jsim.state, psim.state, f"step {t + 1}")


def _observed(mod, cfg, node_id_cls, sink):
    """mod's collisions world with a node between narrowphase and the
    candidate clear that records both temporary tables (the clear waits
    for it)."""
    world_cls = mod.CollisionsWorld.with_config(cfg)

    def observe(ctx):
        out = {}
        for arch, comp in ((mod.CollisionCandidate, mod.CandidatePair),
                           (mod.Contact, mod.ContactData)):
            out[arch.name] = {"mask": np.asarray(ctx.row_mask(arch)),
                              "rows": np.asarray(ctx.num_rows(arch)),
                              **{f: np.asarray(v) for f, v in ctx.column(arch, comp).items()}}
        sink.append(out)

    class Observed(world_cls):
        @classmethod
        def setup_tasks(cls, builder):
            super().setup_tasks(builder)
            names = [nd.name for nd in builder._nodes]
            obs = builder.add_node(observe, deps=[node_id_cls(names.index("narrowphase"))],
                                   name="observe")
            clear = builder._nodes[names.index("clear_CollisionCandidate")]
            clear.deps = clear.deps + (obs.idx,)

    return Observed


@pytest.mark.parametrize("fused", [False, True], ids=["gram", "fused"])
def test_observed_temporaries(fused):
    """Candidate and contact rows, when observed, match the JAX package's:
    handles, masks and counts exact, normals atol 1e-5."""
    jcfg, pcfg = cfgs(fused)
    jseen, pseen = [], []
    jworld = _observed(jcol, jcfg, JNodeID, jseen)
    pworld = _observed(col, pcfg, NodeID, pseen)
    jsim = JExecutor(jworld, JExecutorConfig(num_worlds=W, max_entities_per_world=N + 8,
                                             seed=SEED, donate=False))
    psim = TaskGraphExecutor(pworld, ExecutorConfig(num_worlds=W, max_entities_per_world=N + 8,
                                                    seed=SEED, device="cpu"))
    psim.state = converted(jsim)
    state = jsim.state
    for _ in range(2):
        state = jsim.graph.step(state)  # eager, so the observer sees values
        psim.step()
    assert len(jseen) == len(pseen) == 2
    for j, p in zip(jseen, pseen):
        assert j["CollisionCandidate"]["rows"].sum() > 0
        for arch in j:
            for key, want in j[arch].items():
                if key == "normal":
                    np.testing.assert_allclose(p[arch][key], want, atol=1e-5, rtol=0)
                else:
                    np.testing.assert_array_equal(p[arch][key], want, err_msg=f"{arch}.{key}")
    # unobserved in the next step's state: cleared
    assert (psim.mgr.num_rows(psim.state, col.Contact) == 0).all()


# -- the reference binary's golden, through the port alone ------------------


def load_job_golden(name="job_collisions"):
    """tests/goldens/job_collisions.bin: the reference JobManager running
    examples/collisions (positions and contact counts per tick)."""
    path = os.path.join(GOLDEN_DIR, name + ".bin")
    d = open(path, "rb").read()
    assert d[:4] == b"GLDJ"
    T1, n, _, _ = struct.unpack("<4i", d[4:20])
    off = 24 + n * 4 * 4
    rot0 = np.frombuffer(d[24:off], np.float32).reshape(n, 4).copy()
    rec = n * 3 * 4 + 4
    pos = np.zeros((T1, n, 3), np.float32)
    cnt = np.zeros(T1, np.int32)
    for t in range(T1):
        b = d[off + t * rec: off + (t + 1) * rec]
        pos[t] = np.frombuffer(b[:n * 12], np.float32).reshape(n, 3)
        cnt[t] = struct.unpack("<i", b[n * 12:])[0]
    return pos, rot0, cnt


def overlap_count(pos, rot):
    """Ordered-pair AABB overlap count of the 2-unit cubes, in float64."""
    corners = m.UNIT_CUBE_CORNERS.double().numpy()
    n = pos.shape[0]
    lo = np.empty((n, 3))
    hi = np.empty((n, 3))
    for i in range(n):
        w, x, y, z = rot[i]
        u = np.array([x, y, z], np.float64)
        pts = (corners + 2.0 * w * np.cross(u, corners)
               + 2.0 * np.cross(u, np.cross(u, corners))) + pos[i]
        lo[i] = pts.min(axis=0)
        hi[i] = pts.max(axis=0)
    ok = np.all(lo[:, None] <= hi[None, :], -1) & np.all(lo[None, :] <= hi[:, None], -1)
    np.fill_diagonal(ok, False)
    return int(ok.sum())


@pytest.mark.parametrize("fused", [False, True], ids=["gram", "fused"])
def test_golden_job_system_collisions(fused):
    """Counts exact every tick, <= 1e-3 at t=3, <= 0.02 over the horizon
    (the bounds of tests/test_reference_golden.py:339-402)."""
    g_pos, g_rot0, g_cnt = load_job_golden()
    T, n = g_pos.shape[0] - 1, g_pos.shape[1]
    cfg = col.CollisionsConfig(num_worlds=1, num_objects=n, max_pairs=1600, seed=0,
                               fused=fused)

    class GoldenWorld(col.CollisionsWorld.with_config(cfg)):
        @classmethod
        def init(cls, ctx, init_data=None):
            ctx.data = {
                "bounds_lo": torch.tensor([[-10.0, -10.0, 0.0]]),
                "bounds_hi": torch.tensor([[10.0, 10.0, 10.0]]),
                "push_delta": torch.zeros((1, n + 8, 3)),
            }
            inv_lo, inv_hi = m.aabb_invalid((1, n))
            ctx.make_entities(col.CubeObject, counts=n, max_new=n, values={
                col.Translation: torch.from_numpy(g_pos[0])[None],
                col.Rotation: torch.from_numpy(g_rot0)[None],
                col.PhysicsAABB: {"lo": inv_lo, "hi": inv_hi},
            })

    sim = TaskGraphExecutor(GoldenWorld, ExecutorConfig(num_worlds=1, seed=0, device="cpu"))
    rot64 = g_rot0.astype(np.float64)
    max_err = err_t3 = 0.0
    for t in range(1, T + 1):
        pre = sim.get_exported(0)[0][0, :n].double().numpy()
        assert overlap_count(pre, rot64) == g_cnt[t], t
        sim.step()
        mine = sim.get_exported(0)[0][0, :n].numpy()
        max_err = max(max_err, float(np.abs(mine - g_pos[t]).max()))
        if t == 3:
            err_t3 = max_err
    assert err_t3 <= 1e-3, err_t3
    assert max_err <= 0.02, max_err
    assert g_cnt[-1] == 0
    assert overlap_count(sim.get_exported(0)[0][0, :n].double().numpy(), rot64) == 0


# -- behaviour (tests/test_collisions.py, on the port) ----------------------


def small_cfg(fused, **kw):
    d = dict(num_worlds=4, num_objects=16, max_pairs=256, seed=3, fused=fused)
    d.update(kw)
    return col.CollisionsConfig(**d)


def place(sim, positions):
    """Put cubes 0..k-1 at ``positions`` with identity rotation."""
    k = len(positions)
    pos = sim.mgr.column(sim.state, col.CubeObject, col.Translation).clone()
    pos[:, :k] = torch.tensor(positions)
    state = sim.mgr.set_column(sim.state, col.CubeObject, col.Translation, pos)
    rot = sim.mgr.column(state, col.CubeObject, col.Rotation).clone()
    rot[:, :k] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    sim.state = sim.mgr.set_column(state, col.CubeObject, col.Rotation, rot)


FUSED = pytest.mark.parametrize("fused", [False, True], ids=["gram", "fused"])


@FUSED
def test_init_matches_reference_shape(fused):
    sim = col.make_executor(small_cfg(fused), device="cpu")
    pos, mask = sim.get_exported(0)
    assert (mask.sum(dim=1) == 16).all()
    p = pos[mask]
    assert (p[:, 0] >= -10).all() and (p[:, 0] <= 10).all()
    assert (p[:, 2] >= 0).all() and (p[:, 2] <= 10).all()
    ang = 2 * torch.acos(sim.get_exported(1)[0][mask][:, 0])
    assert (ang >= 0).all() and (ang <= torch.pi).all()


@FUSED
def test_step_pushes_overlapping_apart(fused):
    sim = col.make_executor(small_cfg(fused, num_worlds=2, num_objects=3), device="cpu")
    place(sim, [[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [8.0, 8.0, 9.0]])
    sim.step()
    new_pos = sim.get_exported(0)[0].numpy()
    assert new_pos[0, 0, 0] < -1.0
    assert new_pos[0, 1, 0] > 2.0
    np.testing.assert_allclose(new_pos[0, 2], [8.0, 8.0, 9.0], atol=1e-6)
    assert (sim.mgr.num_rows(sim.state, col.CollisionCandidate) == 0).all()
    assert (sim.mgr.num_rows(sim.state, col.Contact) == 0).all()


@FUSED
def test_push_magnitude_matches_reference(fused):
    """Each ordered pair contributes one unit push: an isolated overlapping
    pair separates by exactly 4 per step."""
    sim = col.make_executor(small_cfg(fused, num_worlds=1, num_objects=2), device="cpu")
    place(sim, [[0.0, 0.0, 5.0], [1.0, 0.0, 5.0]])
    sim.step()
    new_pos = sim.get_exported(0)[0].numpy()
    np.testing.assert_allclose(new_pos[0, 0], [-2.0, 0.0, 5.0], atol=1e-5)
    np.testing.assert_allclose(new_pos[0, 1], [3.0, 0.0, 5.0], atol=1e-5)


@FUSED
def test_determinism_and_divergence(fused):
    sim1 = col.make_executor(small_cfg(fused), device="cpu")
    sim2 = col.make_executor(small_cfg(fused), device="cpu")
    sim1.run(10)
    sim2.run(10)
    p1, mask = sim1.get_exported(0)
    p2, _ = sim2.get_exported(0)
    assert torch.equal(p1, p2)
    assert not torch.allclose(p1[0], p1[1])
    assert torch.isfinite(p1[mask]).all()
    assert (sim1.state["tick"] == 10).all()
