"""The shapes past one block's shared memory, in the port against the JAX
package (CPU): the fused substep kernel's windowed layout and the render
kernel's instance blocks, as a user's configuration reaches them.

  - rigid_bench at 2 worlds x 255 boxes + the plane (256 rows, K = 1020),
    where the port's contact_mode and broadphase_mode "auto" take the fused
    kernel (its plain version on the CPU; on the card the windowed
    specialisation, bit for bit that plain version: tests/test_torch_cuda.py)
    and sap, against JAX's "pairs" mode from one JAX-initialised state: one
    step (positions, rotations and pose stashes atol 1e-4, velocities atol
    1e-3, AABBs 1e-5, overflow exact) and ten steps (positions atol 1e-3,
    velocities 1e-2).  One substep a step: the compile of JAX's pairs mode
    grows with the substeps it unrolls.  Boxes only: with the alternate mix
    a sphere whose centre starts inside a box meets an artefact of JAX's
    pairs mode as XLA compiles it on the CPU (its sphere-box normal comes
    out zero: the minimum of the face distances and their compare round
    apart by an ulp, so the one-hot of the nearest face is empty), which the
    port does not share (ROADMAP.md, Queue 3, "Seen in the JAX package, not
    chased").
  - the render kernel's plain version at 4,096 instance rows (1 world, one
    16 x 16 view; tests/test_torch_render_scenes.py's large instances, a
    quarter of them triangle meshes: the imported prism's SourceMesh and a
    lat-long sphere)
    against JAX's batched route (its render node on the "xla" route, run on
    the views and instances directly): RGBA8 within 1, depth rtol 1e-4 /
    atol 1e-3 where both hit, hit masks equal (tests/test_render_pallas.py's
    tolerances).

Past the body-row ceilings (the bodies in a global scratch on the card):

  - simple_taskgraph at 2 worlds x 1,000 spheres (1,004 rows, K = 10,000,
    its 64-row joint archetype: kernel 5's node, its plain version here)
    against JAX's pairs mode from one JAX-initialised state, 2 steps of 2
    substeps: the physics slice's gates (poses 1e-4, velocities 1e-3);
  - rigid_bench at 2 worlds x 1,023 boxes + the plane (1,024 rows, K =
    4,092; "auto": the fused kernel's plain version and sap) against JAX's
    "pairs" mode, one step, as at 255 boxes.

Both compile a JAX world at these shapes for tens of seconds, so they are
``slow``; their Tier-1 twins check the layout the port's executors take at
those shapes, with no JAX world.

One JAX executor serves the piles (one compile, module fixture).  The
contact-refresh pile past the window is tests/test_torch_large_refresh.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.models import simple_taskgraph as jstg
from gpu_ecs_madrona_tpu.render import renderer as jrenderer
from gpu_ecs_madrona_tpu.utils import importer as jimporter

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk

import test_torch_render_scenes as scenes

PILE = dict(num_worlds=2, num_bodies=255, num_substeps=1, body_mix="boxes", seed=0)
BODY = "RigidBenchBody"
STEPS = 10


def to_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


def port_sim(pile=PILE, **over):
    """The port's rigid_bench executor of ``pile`` under "auto" (CPU)."""
    cfg = rb.RigidBenchConfig(**{**pile, "contact_mode": "auto", **over})
    return TaskGraphExecutor(rb.RigidBenchWorld.with_config(cfg), ExecutorConfig(
        num_worlds=pile["num_worlds"], max_entities_per_world=pile["num_bodies"] + 8, seed=0,
        device="cpu"))


def jax_pile(pile=PILE, steps=STEPS):
    """JAX's pairs-mode pile: its initial state, after one step and after
    ``steps`` steps, from one executor (one compile)."""
    cfg = jrb.RigidBenchConfig(contact_mode="pairs", max_candidates=4 * pile["num_bodies"],
                               **pile)
    sim = JTaskGraphExecutor(jrb.RigidBenchWorld.with_config(cfg), JExecutorConfig(
        num_worlds=pile["num_worlds"], max_entities_per_world=pile["num_bodies"] + 8, seed=0,
        donate=False))
    out = {0: to_np(sim.state)}
    sim.step()
    out[1] = to_np(sim.state)
    sim.run(steps - 1)
    out[steps] = to_np(sim.state)
    return out


@pytest.fixture(scope="module")
def jax_run():
    return jax_pile()


def port_run(state, steps, pile=PILE, **over):
    """``steps`` steps of the port's pile (port_sim) from a JAX state; the
    fused node's plain version runs."""
    psim = port_sim(pile, **over)
    assert "physics_substeps_fused" in psim.graph.node_names
    psim.state = state_from_numpy(state, "cpu")
    sk.FusedSubstepKernel.launches = 0
    psim.run(steps)
    assert sk.FusedSubstepKernel.launches == 0       # CPU: the plain version
    return state_to_numpy(psim.state)


def assert_one_step(want, got):
    """One step's gates: poses and pose stashes atol 1e-4, velocities
    1e-3, AABBs 1e-5, overflow exact."""
    for comp, atol in (("Position", 1e-4), ("Rotation", 1e-4), ("SubstepPrevState", 1e-4),
                       ("PreSolvePositional", 1e-4), ("Velocity", 1e-3),
                       ("PreSolveVelocity", 1e-3), ("CollisionAABB", 1e-5)):
        ca, cb = want["arch"][BODY]["comps"][comp], got["arch"][BODY]["comps"][comp]
        err = {f: float(np.abs(ca[f] - cb[f]).max()) for f in ca}
        assert max(err.values()) <= atol, (comp, err)
    for name in want["overflow"]:
        np.testing.assert_array_equal(want["overflow"][name], got["overflow"][name])


def assert_steps(want, got):
    """Ten steps' gates: positions atol 1e-3, velocities 1e-2, finite."""
    for comp, atol in (("Position", 1e-3), ("Velocity", 1e-2)):
        for f, x in want["arch"][BODY]["comps"][comp].items():
            y = got["arch"][BODY]["comps"][comp][f]
            assert np.isfinite(y).all()
            np.testing.assert_allclose(y, x, rtol=0, atol=atol, err_msg=f"{comp}.{f}")


def test_auto_takes_the_fused_kernel_and_sap_past_one_block():
    """At 256 rows "auto" takes the fused kernel and sap; its shape passes
    one block's shared memory, so on the card the kernel runs its windowed
    layout, which kernel_fits takes."""
    sim = port_sim()
    names = sim.graph.node_names
    assert "physics_substeps_fused" in names
    node = next(nd for nd in sim.graph.nodes if nd.name == "bp_find_overlaps")
    assert node.run.__name__ == "find_overlaps_sap"
    tables = sk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    n, K = PILE["num_bodies"] + 1, 4 * PILE["num_bodies"]
    assert sk.smem_bytes(n, K) > sk.MAX_SMEM_BYTES
    assert sk.windowed(tables, n, K) and sk.kernel_fits(tables, n, K) == ""


def test_large_pile_one_step_matches_jax_pairs(jax_run):
    assert_one_step(jax_run[1], port_run(jax_run[0], 1))


def test_large_pile_ten_steps_match_jax_pairs(jax_run):
    got = port_run(jax_run[0], STEPS)
    assert_steps(jax_run[STEPS], got)
    # the boxes fell: the pile lower than its spawn
    spawn = jax_run[0]["arch"][BODY]["comps"]["Position"]["value"]
    pos = got["arch"][BODY]["comps"]["Position"]["value"]
    assert pos[:, 1:, 2].mean() < spawn[:, 1:, 2].mean()


def jax_batched_render(views, inst, res):
    """JAX's render node on its "xla" route (batched, dense) at one res x res
    view, run on the views and the instances directly, with the large
    scenes' objects and render meshes (the prism's SourceMesh from JAX's
    importer): (RGBA8, depth)."""
    rend = jrenderer.BatchRenderer(jrenderer.RendererConfig(
        width=res, height=res, max_views=1, backend="xla"), scenes.large_object_manager(),
        scenes.LARGE_ALBEDO, render_meshes=scenes.large_render_meshes(jimporter))
    nodes = []
    rend.setup_tasks(SimpleNamespace(add_node=lambda fn, deps, name: nodes.append(fn)), [],
                     [SimpleNamespace(name="LargeScene")])
    ctx = SimpleNamespace(num_worlds=views["eye"].shape[0], data={"render": {
        "__views__": {k: jnp.asarray(v.numpy()) for k, v in views.items()},
        "LargeScene": {k: jnp.asarray(t.numpy()) for k, t in zip(
            ("pos", "rot", "scale", "obj_id", "mask"), inst)}}})
    nodes[0](ctx)
    out = ctx.data["render_out"]
    return np.asarray(out["rgb"]), np.asarray(out["depth"])


def test_large_render_plain_matches_jax_batched_route():
    """4,096 instance rows (past one block's shared memory in both of the
    kernel's modes, so staged in blocks on the card; hulls, spheres, the
    plane and triangle meshes, a SourceMesh's among them): the plain
    version of the views mode against JAX's batched route."""
    k, views, inst, V, H, Wpx = scenes.large_view_case(W=1, H=16, Wpx=16)
    N = inst[0].shape[1]
    assert N == scenes.LARGE_ROWS and rk.blocked(N) and rk.blocked(N, views=True)
    assert k.tables.T_used > 0
    for o in (scenes.LARGE_PRISM, scenes.LARGE_MESH_SPHERE):
        assert bool((inst[3][inst[4]] == o).any())
    assert rk.kernel_fits(N) == "" and rk.kernel_fits(N, views=True) == ""
    rgba, depth = rk.render_views_plain(views, *inst, tables=k.tables, light=k.light,
                                        ambient=k.ambient, height=H, width=Wpx, max_views=V)
    want_rgba, want_depth = jax_batched_render(views, inst, H)
    got_rgba, got_depth = rgba.numpy(), depth.numpy()
    hit = np.isfinite(got_depth)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(hit, np.isfinite(want_depth))
    np.testing.assert_allclose(got_depth[hit], want_depth[hit], rtol=1e-4, atol=1e-3)
    assert np.abs(got_rgba.astype(int) - want_rgba.astype(int)).max() <= 1


# -- past the body-row ceilings -------------------------------------------------

XPILE = dict(PILE, num_bodies=1023)
STG_LARGE = dict(num_worlds=2, num_objects=1000, num_substeps=2, seed=3)


def test_auto_takes_the_bodies_in_scratch_past_the_window_ceiling():
    """rigid_bench at 1,023 boxes (1,024 rows, K = 4,092): "auto" takes the
    fused kernel and sap, and the shape passes the windowed layout's body
    ceiling, so on the card the bodies go to the global scratch, which
    kernel_fits takes."""
    sim = port_sim(XPILE)
    assert "physics_substeps_fused" in sim.graph.node_names
    node = next(nd for nd in sim.graph.nodes if nd.name == "bp_find_overlaps")
    assert node.run.__name__ == "find_overlaps_sap"
    tables = sk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    n, K = XPILE["num_bodies"] + 1, 4 * XPILE["num_bodies"]
    assert sk.fused_window(n, K) == 0 and sk.fused_bodies(tables, n, K)
    assert sk.kernel_fits(tables, n, K) == ""


def test_simple_taskgraph_at_1000_objects_takes_kernel_5_with_the_bodies_in_scratch():
    """simple_taskgraph at 1,000 objects: the kernel-mode substep nodes
    (its 64-row joint archetype) at 1,004 rows and K = 10,000, past kernel
    5's window layout, so on the card the bodies go to the global scratch,
    which kernel_fits takes (it refused them before)."""
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(**STG_LARGE), device="cpu")
    assert "physics_substep_0" in sim.graph.node_names
    assert "physics_substeps_fused" not in sim.graph.node_names
    kern = next(nd for nd in sim.graph.nodes if nd.name == "physics_substep_0").run.kernel
    n = sim.mgr.registry.archetypes["StgSphere"].capacity
    K = sim.mgr.registry.archetypes["CandidateRowsTemporary"].capacity
    J = sim.mgr.registry.archetypes["JointArchetype"].capacity
    assert (n, K, J) == (1004, 10000, 64)
    assert sk.substep_bodies(kern.tables, n, K, J)
    assert sk.substep_smem_bytes(n, K, J) > sk.MAX_SMEM_BYTES
    assert sk.kernel_fits(kern.tables, n, K, single=True, joints=J) == ""


@pytest.mark.slow
def test_large_simple_taskgraph_two_steps_match_jax_pairs():
    """simple_taskgraph at 2 worlds x 1,000 spheres from JAX's initial
    state, 2 steps of 2 substeps: the port's kernel-mode nodes (kernel 5's
    plain version) against JAX's pairs mode; after the first step the
    one-step gates (poses atol 1e-4, velocities 1e-3), after the second the
    gates of more steps (positions 1e-3, velocities 1e-2: the two routes
    sum in other orders, and 1,000 crowded spheres part faster than the
    48 of tests/test_torch_simple_taskgraph.py); masks and overflow exact."""
    jcfg = jstg.SimpleTaskgraphConfig(**STG_LARGE)
    jsim = JTaskGraphExecutor(jstg.SimpleTaskgraphWorld.with_config(jcfg), JExecutorConfig(
        num_worlds=jcfg.num_worlds, max_entities_per_world=jcfg.num_objects + 8,
        seed=jcfg.seed, donate=False))
    psim = stg.make_executor(stg.SimpleTaskgraphConfig(**STG_LARGE), device="cpu")
    psim.state = state_from_numpy(to_np(jsim.state), "cpu")
    sk.SubstepKernel.launches = 0
    for step, (pose_tol, vel_tol) in enumerate(((1e-4, 1e-3), (1e-3, 1e-2))):
        jsim.step()
        psim.step()
        want, got = to_np(jsim.state), state_to_numpy(psim.state)
        for arch in ("StgSphere", "StgAgent"):
            np.testing.assert_array_equal(got["arch"][arch]["mask"], want["arch"][arch]["mask"])
            cw, cg = want["arch"][arch]["comps"], got["arch"][arch]["comps"]
            comps = ("Position", "Rotation") if step == 0 else ("Position",)
            for comp in comps:
                np.testing.assert_allclose(cg[comp]["value"], cw[comp]["value"], atol=pose_tol,
                                           rtol=0, err_msg=f"step {step + 1} {arch} {comp}")
            for k in ("linear", "angular"):
                np.testing.assert_allclose(cg["Velocity"][k], cw["Velocity"][k], atol=vel_tol,
                                           rtol=0, err_msg=f"step {step + 1} {arch} {k}")
        for name, a in want["overflow"].items():
            np.testing.assert_array_equal(got["overflow"][name], a, err_msg=name)
    assert sk.SubstepKernel.launches == 0          # CPU: the plain version


@pytest.mark.slow
def test_xlarge_pile_one_step_matches_jax_pairs():
    """rigid_bench at 2 worlds x 1,023 boxes from JAX's initial state, one
    step: the port's fused plain version and sap under "auto" against JAX's
    pairs mode, the one-step gates of the 255-box pile."""
    run = jax_pile(XPILE, steps=1)
    assert_one_step(run[1], port_run(run[0], 1, XPILE))
