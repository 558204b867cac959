"""simple_taskgraph (models/simple_taskgraph.py) against the JAX package, on
the CPU.

From one JAX-initialised state (2 worlds x 48 spheres: 52 body rows, and
the example's joint archetype of 64 rows with no joint in it, so the port
takes the single-substep kernel's plain version and the joint solve each
substep, and JAX on the CPU its pairs mode with the joint solve; 2
substeps; render 16 x 16), 5 steps: poses within 1e-4 and velocities
within 1e-3 (the physics slice's tolerances); the port's render nodes on
JAX's state after those steps give JAX's observations with hit masks
equal, depth rtol 1e-4 / atol 1e-3 and RGBA8 within 1 (tests/
test_render_pallas.py's tolerances).
"""

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import simple_taskgraph as jstg

from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk

CFG = dict(num_worlds=2, num_objects=48, num_substeps=2, seed=3, render=True,
           render_width=16, render_height=16)
STEPS = 5


def jax_executor(cfg):
    return JTaskGraphExecutor(jstg.SimpleTaskgraphWorld.with_config(cfg), JExecutorConfig(
        num_worlds=cfg.num_worlds, max_entities_per_world=cfg.num_objects + 8, seed=cfg.seed,
        donate=False))


def comps(state, name):
    return state["arch"][name]["comps"]


@pytest.fixture(scope="module")
def runs():
    """(JAX executor, port executor, the initial state as numpy) after
    STEPS steps from JAX's initial state."""
    jsim = jax_executor(jstg.SimpleTaskgraphConfig(**CFG))
    psim = stg.make_executor(stg.SimpleTaskgraphConfig(**CFG), device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jsim.state)
    psim.state = state_from_numpy(init, "cpu")
    subk.FusedSubstepKernel.launches = subk.SubstepKernel.launches = 0
    for _ in range(STEPS):
        jsim.step()
        psim.step()
    return jsim, psim, init


def test_graph_takes_the_fused_kernel_route():
    """The kernel mode's route with joints, as in the JAX package: one node
    a substep (the single-substep kernel and the joint solve), not the
    fused kernel's one node a step."""
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(**CFG), device="cpu")
    assert sim.mgr.registry.archetypes["JointArchetype"].capacity == 64
    assert sim.graph.node_names == [
        "clamp", "bp_update_aabbs", "bp_find_overlaps", "physics_substep_0",
        "physics_substep_1", "clear_CandidateTemporary", "clear_CandidateRowsTemporary",
        "clear_ContactTemporary", "clear_CollisionEventTemporary", "render_pack", "batch_render"]
    assert sim.world_cls.renderer().route == "kernel"


def test_trajectory_matches_jax(runs):
    jsim, psim, init = runs
    want = jax.tree_util.tree_map(np.asarray, jsim.state)
    got = state_to_numpy(psim.state)
    assert (subk.FusedSubstepKernel.launches, subk.SubstepKernel.launches,
            rk.RenderKernel.launches) == (0, 0, 0)       # CPU: the plain versions
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
    # the spheres moved
    assert not np.allclose(comps(init, "StgSphere")["Position"]["value"],
                           comps(got, "StgSphere")["Position"]["value"])
    for name, a in want["overflow"].items():
        np.testing.assert_array_equal(got["overflow"][name], a, err_msg=name)


def test_render_matches_jax_at_the_same_state(runs):
    jsim, _, _ = runs
    want = jax.tree_util.tree_map(np.asarray, jsim.state)
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(**CFG), device="cpu")
    ctx = Context(sim.mgr, state_from_numpy(want, "cpu"))
    for node in sim.graph.nodes:
        if node.name in ("render_pack", "batch_render"):
            node.run(ctx)
    got = {k: v.numpy() for k, v in ctx.data["render_out"].items()}
    jr = want["user"]["render_out"]
    hit = np.isfinite(jr["depth"])
    assert 0 < hit.mean() < 1
    np.testing.assert_array_equal(np.isfinite(got["depth"]), hit)
    np.testing.assert_allclose(got["depth"][hit], jr["depth"][hit], rtol=1e-4, atol=1e-3)
    assert np.abs(got["rgb"].astype(int) - jr["rgb"].astype(int)).max() <= 1
    np.testing.assert_array_equal(got["rgb"][..., 3] == 255, hit)


def test_observations_and_exports(runs):
    """Export slots 0-2 (agent position and rotation, sphere positions) and
    the observation accessors."""
    jsim, psim, init = runs
    apos, amask = psim.get_exported(0)
    arot, _ = psim.get_exported(1)
    spos, smask = psim.get_exported(2)
    assert amask.sum(1).tolist() == [1, 1] and smask.sum(1).tolist() == [48, 48]
    assert torch.equal(apos[:, 0], torch.zeros(2, 3))
    assert torch.equal(arot[:, 0], torch.tensor([[1.0, 0, 0, 0]] * 2))
    np.testing.assert_allclose(spos.numpy(), np.asarray(jsim.get_exported(2)[0]), atol=1e-4)
    rgb, depth = psim.rgb_observations(), psim.depth_observations()
    assert rgb.shape == (2, 1, 16, 16, 4) and rgb.dtype == torch.uint8
    assert depth.shape == (2, 1, 16, 16) and depth.dtype == torch.float32
    hit = torch.isfinite(depth)
    assert hit.any() and (depth[hit] > 0).all()
    assert torch.equal(hit, rgb[..., 3] == 255)
    assert (rgb[~hit] == 0).all()


def test_port_spawn():
    """The port's own spawn: spheres inside the bounds with unit
    quaternions about y, the agent at the origin; the same from one seed,
    other from another."""
    def pos(seed):
        cfg = stg.SimpleTaskgraphConfig(num_worlds=3, num_objects=45, seed=seed)
        sim = stg.make_executor(cfg, device="cpu")
        return sim, sim.get_exported(2)[0][:, :45]
    sim, p = pos(0)
    assert torch.equal(p, pos(0)[1]) and not torch.equal(p, pos(1)[1])
    assert (p >= torch.tensor(stg.BOUNDS_LO)).all() and (p <= torch.tensor(stg.BOUNDS_HI)).all()
    rot = sim.mgr.column(sim.state, stg.Sphere, stg.base.Rotation)[:, :45]
    torch.testing.assert_close(rot.norm(dim=-1), torch.ones(3, 45))
    assert (rot[..., 1] == 0).all() and (rot[..., 3] == 0).all()
    assert "render_out" not in sim.state["user"]


@pytest.mark.parametrize("num_objects", [10, 44])
def test_dense_contact_mode_raises(num_objects):
    """At 48 body rows or fewer the example takes the dense contact mode,
    which raised NotImplementedError until it was ported: now it builds
    its dense substep nodes and steps (tests/test_torch_simple_taskgraph_
    dense.py holds it against JAX)."""
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=1, num_objects=num_objects),
                            device="cpu")
    nodes = [nd for nd in sim.graph.nodes if nd.name.startswith("physics_substep_")]
    assert len(nodes) == 4 and all(hasattr(nd.run, "world_block") for nd in nodes)
    sim.step()
    pos, mask = sim.get_exported(2)
    assert int(mask.sum()) == num_objects and bool(pos[mask].isfinite().all())
