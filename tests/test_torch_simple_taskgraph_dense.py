"""simple_taskgraph at 20 spheres (24 body rows) against the JAX package
(CPU): at 48 body rows or fewer ``contact_mode="auto"`` takes the dense
contact mode in both packages, with the example's 64-row joint archetype
(no joint made: the joint solve runs between the dense grid's positional
and velocity passes over no live joint).

From one JAX-initialised state (2 worlds x 20 spheres, 2 substeps, no
render), 5 steps: poses within 1e-4 and velocities within 1e-3 (the
physics slice's tolerances), masks and overflow counters equal, the
spheres moved and stay above the floor.
"""

import jax
import numpy as np
import pytest

from gpu_ecs_madrona_tpu.models import simple_taskgraph as jstg

from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg

from test_torch_simple_taskgraph import comps, jax_executor

CFG = dict(num_worlds=2, num_objects=20, num_substeps=2, seed=5)
STEPS = 5


@pytest.fixture(scope="module")
def runs():
    jsim = jax_executor(jstg.SimpleTaskgraphConfig(**CFG))
    psim = stg.make_executor(stg.SimpleTaskgraphConfig(**CFG), device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jsim.state)
    psim.state = state_from_numpy(init, "cpu")
    for _ in range(STEPS):
        jsim.step()
        psim.step()
    return jsim, psim, init


def test_graph_takes_the_dense_contact_mode():
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(**CFG), device="cpu")
    assert sim.mgr.registry.archetypes["JointArchetype"].capacity == 64
    assert sim.graph.node_names == [
        "clamp", "bp_update_aabbs", "bp_find_overlaps", "physics_substep_0",
        "physics_substep_1", "clear_CandidateTemporary", "clear_CandidateRowsTemporary",
        "clear_ContactTemporary", "clear_CollisionEventTemporary", "render_pack"]
    node = next(nd for nd in sim.graph.nodes if nd.name == "physics_substep_0")
    assert node.run.world_block == 2 and not hasattr(node.run, "kernel")


def test_dense_trajectory_matches_jax(runs):
    jsim, psim, init = runs
    want = jax.tree_util.tree_map(np.asarray, jsim.state)
    got = state_to_numpy(psim.state)
    for arch in ("StgSphere", "StgAgent"):
        np.testing.assert_array_equal(got["arch"][arch]["mask"], want["arch"][arch]["mask"])
        for comp in ("Position", "Rotation"):
            np.testing.assert_allclose(comps(got, arch)[comp]["value"],
                                       comps(want, arch)[comp]["value"], atol=1e-4, rtol=0,
                                       err_msg=f"{arch} {comp}")
        for k in ("linear", "angular"):
            np.testing.assert_allclose(comps(got, arch)["Velocity"][k],
                                       comps(want, arch)["Velocity"][k], atol=1e-3, rtol=0,
                                       err_msg=f"{arch} velocity {k}")
    pos = comps(got, "StgSphere")["Position"]["value"][got["arch"]["StgSphere"]["mask"]]
    assert np.isfinite(pos).all() and (pos[:, 2] >= 0.0).all()
    assert not np.allclose(comps(init, "StgSphere")["Position"]["value"],
                           comps(got, "StgSphere")["Position"]["value"])
    for name, a in want["overflow"].items():
        np.testing.assert_array_equal(got["overflow"][name], a, err_msg=name)
