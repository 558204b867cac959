"""A pile of a large imported hull, past PhysicsLoader()'s default caps, in
the port against the JAX package (CPU).

The hull is tests/test_torch_hull_scenes.py's 24-sided prism (48 verts,
24-vertex caps, 13 SAT axes and edge directions, 72 full edges), written as
an .obj file and read by each package's importer and PhysicsLoader with its
caps raised to take it (LARGE_LOADER).  The scene is test_torch_hull_pile.py's
(rigid_bench, here 2 worlds x 8 bodies, the prism and spheres dropped
close together, one substep a step: the compile of JAX's pairs mode, whose
edge cross axes here are 169 pairs, grows with the substeps it unrolls)
with that prism for object 0, and the gates are that file's: the
port's fused-kernel mode (its plain version on the CPU) against JAX's
"pairs" mode from one JAX-initialised state, one step (positions, rotations
and pose stashes atol 1e-4, velocities atol 1e-3, AABBs 1e-5, overflow
exact) and ten steps (positions rtol 1e-4, atol 8e-2).  The kernels take
these tables (kernel_fits); on the card they run bit for bit their plain
version (tests/test_torch_cuda.py's "large" cases).  One JAX executor
serves the file (one compile, module fixture).
"""

import numpy as np
import pytest

import jax

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.utils import importer as jimporter

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk
from gpu_ecs_madrona_tpu_torch.utils import importer

import test_torch_hull_scenes as hs

PILE = dict(num_worlds=2, num_bodies=8, num_substeps=1, spawn_xy=1.5, spawn_h=4.0, seed=0)
BODY = "RigidBenchBody"
STEPS = 10


def to_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


def world(bench, assets_mod, importer_mod, **over):
    om = hs.large_hull_object_manager(assets_mod, importer_mod)
    return hs.hull_world(bench, om).with_config(bench.RigidBenchConfig(**{**PILE, **over}))


def port_sim():
    n = PILE["num_bodies"] + 8
    return TaskGraphExecutor(world(rb, assets, importer, contact_mode="pallas"),
                             ExecutorConfig(num_worlds=PILE["num_worlds"],
                                            max_entities_per_world=n, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's pairs-mode pile of the 24-sided prism: its initial state, after
    one step and after STEPS steps, from one executor (one compile)."""
    n = PILE["num_bodies"] + 8
    sim = JTaskGraphExecutor(world(jrb, jassets, jimporter, contact_mode="pairs"),
                             JExecutorConfig(num_worlds=PILE["num_worlds"],
                                             max_entities_per_world=n, seed=0, donate=False))
    out = {0: to_np(sim.state)}
    sim.step()
    out[1] = to_np(sim.state)
    sim.run(STEPS - 1)
    out[STEPS] = to_np(sim.state)
    return out


def body_err(a, b, comp):
    ca, cb = a["arch"][BODY]["comps"][comp], b["arch"][BODY]["comps"][comp]
    return {f: float(np.abs(ca[f] - cb[f]).max()) for f in ca}


def port_run(state, steps):
    psim = port_sim()
    psim.state = state_from_numpy(state, "cpu")
    sk.FusedSubstepKernel.launches = 0
    psim.run(steps)
    assert sk.FusedSubstepKernel.launches == 0       # CPU: the plain version
    assert "physics_substeps_fused" in psim.graph.node_names
    return state_to_numpy(psim.state)


def test_large_hull_tables_are_past_the_defaults():
    """Both packages pack the same tables; they are past PhysicsLoader()'s
    default caps (32 verts, 8 corners a face, 48 full edges), which refuse
    the hull, and the kernels take them."""
    om = hs.large_hull_object_manager(assets, importer)
    jom = hs.large_hull_object_manager(jassets, jimporter)
    for k, v in jom.items():
        np.testing.assert_array_equal(np.asarray(om[k]), np.asarray(v), err_msg=k)
    tables = pk.ObjTables(om)
    assert not tables.all_box
    assert (int(om["num_verts"][0]), tables.FVm, int(om["num_full_edges"][0])) == (48, 24, 72)
    assert tables.hull_dims()[1:] == (26, 13, 13, 24, 72)
    with pytest.raises(ValueError, match="max_verts=32"):
        assets.PhysicsLoader().load_objects(hs.hull_objects(assets, importer, hs.LARGE_SIDES))\
            .get_object_manager()
    assert sk.kernel_fits(tables, 65, 256) == ""


def test_large_hull_one_step_matches_jax_pairs(jax_run):
    want, got = jax_run[1], port_run(jax_run[0], 1)
    for comp, atol in (("Position", 1e-4), ("Rotation", 1e-4), ("SubstepPrevState", 1e-4),
                       ("PreSolvePositional", 1e-4), ("Velocity", 1e-3),
                       ("PreSolveVelocity", 1e-3), ("CollisionAABB", 1e-5)):
        err = body_err(want, got, comp)
        assert max(err.values()) <= atol, (comp, err)
    for name in want["overflow"]:
        np.testing.assert_array_equal(want["overflow"][name], got["overflow"][name])


def test_large_hull_ten_steps_match_jax_pairs(jax_run):
    want, got = jax_run[STEPS], port_run(jax_run[0], STEPS)
    wp = want["arch"][BODY]["comps"]["Position"]
    gp = got["arch"][BODY]["comps"]["Position"]
    (key,) = wp
    assert np.isfinite(gp[key]).all()
    np.testing.assert_allclose(gp[key], wp[key], rtol=1e-4, atol=8e-2)
    # the bodies fell and met: the pile is lower on average than its spawn
    spawn = jax_run[0]["arch"][BODY]["comps"]["Position"][key]
    assert gp[key][:, 1:, 2].mean() < spawn[:, 1:, 2].mean()
