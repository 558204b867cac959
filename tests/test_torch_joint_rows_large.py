"""A world with 4,096 joint rows in the port against the JAX package, on
the CPU: kernel 5's joint rows past one block.

The world (test_torch_joint_scenes.chain_scene): the plane and four
hanging chains of 16 boxes, their links joined by alternating Fixed and
Hinge joints, 60 live joints in a joint archetype of 4,096 rows (the JAX
package takes any max_joints; on the card the port's kernel 5 keeps such
rows in its body scratch).  From one JAX-initialised state, 25 steps of
the port's kernel mode (the single-substep kernel's plain version here)
against JAX's interpreted Pallas mode (its SubstepKernel route): poses
atol 1e-4, velocities atol 1e-3, as tests/test_torch_joint_world.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.physics import components as jcomp

from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem

import test_torch_joint_scenes as scenes

STEPS = 25


def jax_chain_world(num_worlds=2):
    def conv(x, dt=np.float32):
        return jnp.asarray(np.asarray(x, dt))
    World = scenes.chain_scene(jphys, jbase, jcomp, JArchetype, conv, "pallas")
    return JTaskGraphExecutor(World, JExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=World.num_rows + World.num_joints + 8,
        seed=0, donate=False))


def test_joint_rows_past_one_block_match_jax():
    jsim = jax_chain_world()
    init = jax.tree_util.tree_map(np.asarray, jsim.state)
    psim = scenes.chain_world(num_worlds=2, device="cpu")
    # the port's joint rows equal JAX's: 60 live of 4,096
    mine = state_to_numpy(psim.state)["arch"]["JointArchetype"]
    want_rows = init["arch"]["JointArchetype"]
    np.testing.assert_array_equal(mine["mask"], want_rows["mask"])
    assert mine["mask"].shape == (2, 4096) and int(mine["mask"][0].sum()) == 60
    for f, v in want_rows["comps"]["JointConstraint"].items():
        np.testing.assert_array_equal(mine["comps"]["JointConstraint"][f], v, err_msg=f)
    # on the card these shapes keep the joints' rows in the body scratch
    kern = RigidBodyPhysicsSystem.substep_kernel(psim)
    assert sk.substep_bodies(kern.tables, 65, 256, 4096)
    assert sk.substep_joints_in_scratch(kern.tables, 65, 256, 4096)
    assert sk.kernel_fits(kern.tables, 65, 256, single=True, joints=4096) == ""
    psim.state = state_from_numpy(init, "cpu")
    sk.SubstepKernel.launches = 0
    jsim.run(STEPS)
    psim.run(STEPS)
    assert sk.SubstepKernel.launches == 0        # CPU: the plain version
    want = jax.tree_util.tree_map(np.asarray, jsim.state)["arch"]["ChainBody"]["comps"]
    got = state_to_numpy(psim.state)["arch"]["ChainBody"]["comps"]
    for comp_name, field, atol in (("Position", "value", 1e-4), ("Rotation", "value", 1e-4),
                                   ("Velocity", "linear", 1e-3), ("Velocity", "angular", 1e-3)):
        np.testing.assert_allclose(got[comp_name][field], want[comp_name][field], rtol=0,
                                   atol=atol, err_msg=f"{comp_name} {field}")
    p = got["Position"]["value"]
    moved = np.abs(p - init["arch"]["ChainBody"]["comps"]["Position"]["value"]).max()
    assert np.isfinite(p).all() and moved > 0.1
