"""The sweep-and-prune broadphase (``broadphase_mode="sap"``) against the
JAX package (CPU).

The cases of tests/test_broadphase_sap.py: rigid_bench worlds whose graph
holds only the broadphase (so the candidate temporaries stay visible
after the step), each started from one JAX-initialised state, one step:
  - 4 worlds x 24 bodies with the whole window (no saturation);
  - 2 worlds x 16 bodies stacked at the origin with window 2 (the window
    saturates: overflow counted);
  - a degree cap of 2 under a window of 8 on the same stack (rows dropped);
  - a tie case: an unrotated grid of equal boxes, so every box has the
    same x extent (the globals' top-k ties) and each column the same
    lower x (the sort's ties).
The candidate rows, the row masks, the counts and the overflow counters
must equal JAX's exactly.  With the whole window the candidate set is the
dense broadphase's.  Then a trajectory: 3 steps of rigid_bench with the
sap broadphase and the fused kernel's plain version against JAX's "pairs"
mode on the same candidates (poses 1e-4, velocities 1e-3, as
test_torch_physics.py).  And "auto" above 192 body rows takes sap.
"""

import numpy as np
import pytest

import jax

from gpu_ecs_madrona_tpu.core.executor import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu.core.executor import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import RigidBodyPhysicsSystem as JPhysics

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem

from test_torch_sap_cases import set_grid

BODY = "RigidBenchBody"
ROWS = "CandidateRowsTemporary"
# name: (worlds, bodies, window, degree, spawn_xy, spawn_h, mode)
CASES = {
    "window_whole": (4, 24, 0, 16, 2.5, 3.0, "sap"),
    "window_saturated": (2, 16, 2, 16, 0.01, 1.2, "sap"),
    "degree_cap": (2, 16, 8, 2, 0.01, 1.2, "sap"),
    "tie_grid": (2, 24, 0, 16, 2.5, 3.0, "sap"),
    "dense_whole": (4, 24, 0, 16, 2.5, 3.0, "dense"),
}


def bp_world(pkg_rb, physics, name, seed=3):
    """rigid_bench's world with only the broadphase in its graph."""
    W, n, window, degree, xy, h, mode = CASES[name]
    cfg = pkg_rb.RigidBenchConfig(num_worlds=W, num_bodies=n, max_candidates=(n + 1) ** 2,
                                  broadphase_mode=mode, sap_window=window, seed=seed,
                                  spawn_xy=xy, spawn_h=h, dense_degree=0)
    base_world = pkg_rb.RigidBenchWorld.with_config(cfg)

    class BPOnly(base_world):
        @classmethod
        def setup_tasks(cls, builder):
            physics.setup_broadphase_tasks(builder, [], pkg_rb.Body, cls.objmgr, mode=mode,
                                           sap_window=window, sap_degree=degree)

    return BPOnly, cfg


def run_both(name):
    """One broadphase step of both packages from JAX's initial state:
    (JAX state, port state), numpy."""
    jworld, jcfg = bp_world(jrb, JPhysics, name)
    pworld, _ = bp_world(rb, RigidBodyPhysicsSystem, name)
    jsim = JTaskGraphExecutor(jworld, JExecutorConfig(
        num_worlds=jcfg.num_worlds, max_entities_per_world=jcfg.num_bodies + 8, seed=3,
        donate=False))
    init = jax.tree_util.tree_map(np.array, jsim.state)
    if name == "tie_grid":
        init = set_grid(init)
        jsim.state = jax.tree_util.tree_map(jax.numpy.asarray, init)
    psim = TaskGraphExecutor(pworld, ExecutorConfig(
        num_worlds=jcfg.num_worlds, max_entities_per_world=jcfg.num_bodies + 8, seed=3,
        device="cpu"))
    psim.state = state_from_numpy(init, "cpu")
    jsim.step()
    psim.step()
    return jax.tree_util.tree_map(np.asarray, jsim.state), state_to_numpy(psim.state)


@pytest.fixture(scope="module")
def runs():
    return {name: run_both(name) for name in CASES}


def candidate_sets(state):
    arch = state["arch"][ROWS]
    rows = arch["comps"]["CandidatePairRows"]
    return [{(int(a), int(b)) for a, b in zip(rows["i"][w][m], rows["j"][w][m])}
            for w, m in enumerate(arch["mask"])]


@pytest.mark.parametrize("name", sorted(CASES))
def test_candidates_match_jax_exactly(runs, name):
    want, got = runs[name]
    for arch in (ROWS, "CandidateTemporary"):
        w, g = want["arch"][arch], got["arch"][arch]
        np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=arch)
        np.testing.assert_array_equal(g["entity"], w["entity"], err_msg=arch)
        for comp, fields in w["comps"].items():
            for f in fields:
                live = w["mask"]
                np.testing.assert_array_equal(g["comps"][comp][f][live], fields[f][live],
                                              err_msg=f"{arch} {comp}.{f}")
    for k in want["overflow"]:
        np.testing.assert_array_equal(got["overflow"][k], want["overflow"][k], err_msg=k)
    np.testing.assert_array_equal(got["arch"][ROWS]["comps"]["CandidatePairRows"]["i"],
                                  want["arch"][ROWS]["comps"]["CandidatePairRows"]["i"])
    np.testing.assert_array_equal(got["arch"][ROWS]["comps"]["CandidatePairRows"]["j"],
                                  want["arch"][ROWS]["comps"]["CandidatePairRows"]["j"])
    assert want["arch"][ROWS]["mask"].sum() > 10, "degenerate case: few candidates"


def test_whole_window_gives_the_dense_candidate_set(runs):
    sap, dense = runs["window_whole"][1], runs["dense_whole"][1]
    assert candidate_sets(sap) == candidate_sets(dense)
    assert not any(v.any() for v in sap["overflow"].values())


def test_saturation_and_degree_cap_count_overflow(runs):
    """The saturated window and the degree cap count overflow in every
    world."""
    for name in ("window_saturated", "degree_cap"):
        got = runs[name][1]
        assert (got["overflow"][ROWS] > 0).all(), (name, got["overflow"][ROWS])


def test_tie_grid_is_a_grid(runs):
    """The tie case's premise: equal x extents and shared lower x values."""
    got = runs["tie_grid"][1]
    lo = got["arch"][BODY]["comps"]["CollisionAABB"]["lo"][:, 1:25]
    hi = got["arch"][BODY]["comps"]["CollisionAABB"]["hi"][:, 1:25]
    ext = hi[..., 0] - lo[..., 0]
    assert (ext == ext[0, 0]).all()
    assert len(np.unique(lo[0, :, 0])) == 4


PILE = dict(num_worlds=2, num_bodies=24, spawn_xy=3.0, spawn_h=4.0, seed=0,
            broadphase_mode="sap", max_candidates=128, dense_degree=12)


def test_sap_trajectory_matches_jax():
    jsim = jrb.make_executor(jrb.RigidBenchConfig(contact_mode="pairs", **PILE), donate=False)
    jsim.run(2)
    psim = rb.make_executor(rb.RigidBenchConfig(contact_mode="pallas", **PILE), device="cpu")
    assert "physics_substeps_fused" in psim.graph.node_names
    psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    for _ in range(3):
        jsim.step()
        psim.step()
    want = jax.tree_util.tree_map(np.asarray, jsim.state)["arch"][BODY]["comps"]
    got = state_to_numpy(psim.state)["arch"][BODY]["comps"]
    for comp, tol in (("Position", 1e-4), ("Rotation", 1e-4), ("Velocity", 1e-3)):
        for f in want[comp]:
            assert np.isfinite(got[comp][f]).all()
            np.testing.assert_allclose(got[comp][f], want[comp][f], atol=tol, rtol=0,
                                       err_msg=f"{comp}.{f}")


def test_auto_above_192_rows_takes_sap():
    """rigid_bench at 200 bodies (201 rows): "auto" takes sap, whose node
    runs; the fused kernel's plain version steps the world."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=1, num_bodies=200,
                                               contact_mode="pallas"), device="cpu")
    node = next(nd for nd in sim.graph.nodes if nd.name == "bp_find_overlaps")
    assert node.run.__name__ == "find_overlaps_sap"
    sim.step()
    pos, mask = sim.get_exported(0)
    assert bool(mask.all()) and bool(pos.isfinite().all())
