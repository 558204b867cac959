"""A world with joints in the port against the JAX package, on the CPU.

The world: the plane; a static anchor with a box hung from it by a Fixed
joint; a static pivot with a box swinging on a Hinge joint; a free box on
the plane (tests/test_physics.py:193-251's and
tests/test_contact_refresh.py:110-187's scenes in one world).

  - From one JAX-initialised state, 8 steps: the port's "pairs" mode (the
    joints solved between the positional and velocity phases) against
    JAX's, and its kernel mode (the single-substep kernel's plain version
    here, the joints solved after each launch) against JAX's interpreted
    Pallas mode (its SubstepKernel route): poses atol 1e-4, velocities
    atol 1e-3; the port's make_fixed_joint / make_hinge_joint rows equal
    JAX's.
  - 120 steps in the port: the joints hold.  "pairs" keeps the hinge's
    pivot distance within 0.01 (tests/test_contact_refresh.py's gate);
    the kernel mode, whose velocities do not see the joint correction (the
    JAX package's documented trade, physics/__init__.py:581-587), within
    0.1.  Both keep the hanging box within 0.3 of its rest height
    (tests/test_physics.py's gate) and the free box on the plane.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.physics import components as jcomp

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import components as comp

HINGE = np.array([0.0, 0.0, 5.4], np.float32)
SWING = 0.2


def joint_world(pkg, contact_mode, num_worlds=2):
    """Plane; a static anchor with a box hung from it by a Fixed joint; a
    static pivot with a box swinging on a Hinge joint; a free box on the
    plane.  Returns the executor."""
    if pkg == "jax":
        physics, bmod, cmod, Arch = jphys, jbase, jcomp, JArchetype

        def conv(x, dt=np.float32):
            return jnp.asarray(np.asarray(x, dt))
    else:
        physics, bmod, cmod, Arch = phys, base, comp, Archetype

        def conv(x, dt=np.float32):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dt)))
    loader = physics.assets.PhysicsLoader()
    loader.load_objects([physics.assets.make_plane(),
                         physics.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0)])
    om = loader.get_object_manager()
    Body = Arch("JointBody", physics.BODY_COMPONENTS)
    down = np.array([math.sin(SWING), 0.0, -math.cos(SWING)], np.float32)
    bodies = [  # (object, position, rotation, response)
        (0, (0, 0, 0), (1, 0, 0, 0), cmod.RESPONSE_STATIC),
        (1, (3.0, 0, 6.0), (1, 0, 0, 0), cmod.RESPONSE_STATIC),
        (1, (3.0, 0, 4.0), (1, 0, 0, 0), cmod.RESPONSE_DYNAMIC),
        (1, (0, 0, 6.0), (1, 0, 0, 0), cmod.RESPONSE_STATIC),
        (1, tuple(HINGE + 0.6 * down), (math.cos(SWING / 2), 0, math.sin(SWING / 2), 0),
         cmod.RESPONSE_DYNAMIC),
        (1, (-3.0, 0, 0.55), (1, 0, 0, 0), cmod.RESPONSE_DYNAMIC)]

    class World:
        @staticmethod
        def register_types(registry):
            physics.RigidBodyPhysicsSystem.register_types(registry, max_candidates=32,
                                                          max_contacts=32, max_joints=4)
            registry.register_archetype(Body, capacity=8)
            registry.export_column(Body, bmod.Position, 0)
            registry.export_column(Body, bmod.Rotation, 1)

        @staticmethod
        def init(ctx, init_data=None):
            W, nb = ctx.num_worlds, len(bodies)

            def tile(col, dt=np.float32):
                return conv(np.broadcast_to(np.asarray([b[col] for b in bodies], dt),
                                            (W, nb) + np.asarray(bodies[0][col]).shape), dt)
            ctx.data = {"_": conv(np.zeros((W, 1)))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)
            ents = ctx.make_entities(Body, counts=nb, max_new=nb, values={
                bmod.Position: tile(1), bmod.Rotation: tile(2),
                bmod.Scale: conv(np.ones((W, nb, 3))), bmod.ObjectID: tile(0, np.int32),
                cmod.ResponseType: tile(3, np.int32)})

            def vec(x, k=3):
                return conv(np.broadcast_to(np.asarray(x, np.float32), (W, 1, k)))
            ident = vec([1, 0, 0, 0], 4)
            physics.make_fixed_joint(ctx, ents[:, 1:2], ents[:, 2:3], ident, ident,
                                     r1=vec([0, 0, -1.0]), r2=vec([0, 0, 1.0]),
                                     separation=conv(np.zeros((W, 1))))
            physics.make_hinge_joint(ctx, ents[:, 3:4], ents[:, 4:5], vec([0, 1, 0]),
                                     vec([0, 1, 0]), vec([1, 0, 0]), vec([1, 0, 0]),
                                     vec([0, 0, -0.6]), vec([0, 0, 0.6]))

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, om)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], 4, Body, om, relaxation=0.7, contact_mode=contact_mode)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    if pkg == "jax":
        return JTaskGraphExecutor(World, JExecutorConfig(
            num_worlds=num_worlds, max_entities_per_world=16, seed=0, donate=False))
    return TaskGraphExecutor(World, ExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=16, seed=0, device="cpu"))


@pytest.mark.parametrize("mode", ["pairs", "pallas"])
def test_joint_world_matches_jax(mode):
    jsim = joint_world("jax", mode)
    init = jax.tree_util.tree_map(np.asarray, jsim.state)
    psim = joint_world("port", mode)
    mine = state_to_numpy(psim.state)["arch"]["JointArchetype"]
    # the port's make_*_joint rows equal JAX's
    np.testing.assert_array_equal(mine["mask"], init["arch"]["JointArchetype"]["mask"])
    for f, v in init["arch"]["JointArchetype"]["comps"]["JointConstraint"].items():
        np.testing.assert_array_equal(mine["comps"]["JointConstraint"][f], v, err_msg=f)
    psim.state = state_from_numpy(init, "cpu")
    kernel_nodes = [f"physics_substep_{i}" for i in range(4)]
    assert all(name in psim.graph.node_names for name in kernel_nodes)
    sk.SubstepKernel.launches = 0
    jsim.run(8)
    psim.run(8)
    assert sk.SubstepKernel.launches == 0        # CPU: the plain version
    want = jax.tree_util.tree_map(np.asarray, jsim.state)["arch"]["JointBody"]["comps"]
    got = state_to_numpy(psim.state)["arch"]["JointBody"]["comps"]
    for comp_name, field, atol in (("Position", "value", 1e-4), ("Rotation", "value", 1e-4),
                                   ("Velocity", "linear", 1e-3), ("Velocity", "angular", 1e-3)):
        np.testing.assert_allclose(got[comp_name][field], want[comp_name][field], rtol=0,
                                   atol=atol, err_msg=f"{comp_name} {field}")
    p = got["Position"]["value"]
    assert np.abs(p[:, 4] - (HINGE + 0.6 * np.array([math.sin(SWING), 0, -math.cos(SWING)]))
                  ).max() > 1e-3                   # the pendulum swings


@pytest.mark.parametrize("mode,pivot_tol", [("pairs", 0.01), ("pallas", 0.1)])
def test_joints_hold_in_the_port(mode, pivot_tol):
    """120 steps: the hinged box keeps 0.6 from its pivot and the hanging
    box stays near z = 4 (within 0.3); the free box rests on the plane;
    the static bodies do not move."""
    sim = joint_world("port", mode)
    sim.run(120)
    p = sim.get_exported(0)[0].numpy()
    assert np.isfinite(p).all()
    assert np.abs(np.linalg.norm(p[:, 4] - HINGE, axis=-1) - 0.6).max() < pivot_tol
    assert np.abs(p[:, 2, 2] - 4.0).max() < 0.3
    assert np.abs(p[:, 5, 2] - 0.5).max() < 0.05
    np.testing.assert_array_equal(p[:, 1], np.tile([3.0, 0, 6.0], (2, 1)))
