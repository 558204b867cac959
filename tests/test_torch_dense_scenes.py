"""More of tests/test_physics.py's dense-mode scenes, the port against the
JAX package (CPU): two spheres pushed apart, a box stacked on a box, two
boxes held by a Fixed joint (the joint solved between the dense grid's
positional and velocity passes) and a 1440 m/s bullet stopped by
speculative contacts (the near-miss clamp of the dense velocity pass).

As in test_torch_dense_world.py, each scene starts from the port's
initial state carried into the JAX executor; the gates are the scene's
own gates of tests/test_physics.py on the port, and the port's positions
against JAX's within 1e-4 over the first steps and within the scene's
tolerance at its end.
"""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.physics import components as jcomp

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
from gpu_ecs_madrona_tpu_torch.physics import components as comp

from test_torch_dense_world import DYNAMIC, EARLY, PLANE, graft, one_thread, run_scenes
from test_torch_physics_world import OBJ_BOX, OBJ_SPHERE, objmgr

STACK_SCENES = {
    "sphere_sphere": ([PLANE, (OBJ_SPHERE, (0.0, 0.0, 1.0), DYNAMIC),
                       (OBJ_SPHERE, (0.5, 0.0, 1.2), DYNAMIC)], 120, 0.05),
    "box_stack": ([PLANE, (OBJ_BOX, (0, 0, 1.0), DYNAMIC),
                   (OBJ_BOX, (0.1, 0.0, 3.2), DYNAMIC)], 180, 0.05),
}


@pytest.fixture(scope="module")
def stack_runs():
    """Both stack scenes run once, one world each, in one executor a
    package (test_torch_dense_world.run_scenes)."""
    return run_scenes(STACK_SCENES, num_worlds=1)


@pytest.mark.parametrize("name", sorted(STACK_SCENES))
def test_stack_scene_matches_jax(stack_runs, name):
    bodies, steps, tol = STACK_SCENES[name]
    got, want = stack_runs[name]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:EARLY], want[:EARLY], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[-1], want[-1], atol=tol, rtol=1e-4)
    p = got[-1][0]
    if name == "sphere_sphere":
        assert np.linalg.norm(p[1] - p[2]) > 1.6, p
    else:
        assert abs(p[1, 2] - 1.0) < 0.3 and 2.5 < p[2, 2] < 3.6, p


def packages(pkg):
    if pkg == "jax":
        return jphys, jbase, jcomp, jnp.asarray
    return phys, base, comp, torch.from_numpy


def joint_world(pkg):
    """tests/test_physics.py test_fixed_joint_holds_bodies for either
    package: a static box at z = 5 and a dynamic one hanging at z = 3,
    held by a Fixed joint (r1 at the anchor's bottom, r2 at the other's
    top); 8 body rows, so the dense contact mode."""
    physics, bmod, cmod, conv = packages(pkg)
    om = objmgr(physics.assets)
    Body = (JArchetype if pkg == "jax" else Archetype)("PhysBody", physics.BODY_COMPONENTS)

    def arr(x, dt=np.float32):
        return conv(np.array(x, dt))

    class JointWorld:
        @staticmethod
        def register_types(registry):
            physics.RigidBodyPhysicsSystem.register_types(registry, max_candidates=16,
                                                          max_contacts=16, max_joints=4)
            registry.register_archetype(Body, capacity=8)
            registry.export_column(Body, bmod.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            W = ctx.num_worlds

            def tile(x, dt=np.float32):
                x = np.asarray(x, dt)
                return arr(np.broadcast_to(x, (W,) + x.shape), dt)

            ctx.data = {"_": arr(np.zeros((W, 1)))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)
            ents = ctx.make_entities(Body, counts=2, max_new=2, values={
                bmod.Position: tile([[0.0, 0, 5.0], [0.0, 0, 3.0]]),
                bmod.Rotation: tile([[1.0, 0, 0, 0]] * 2),
                bmod.Scale: tile(np.ones((2, 3))),
                bmod.ObjectID: tile([0, 0], np.int32),
                cmod.ResponseType: tile([cmod.RESPONSE_STATIC, cmod.RESPONSE_DYNAMIC],
                                        np.int32)})
            ident = tile([[1.0, 0, 0, 0]])
            physics.make_fixed_joint(ctx, ents[:, 0:1], ents[:, 1:2], ident, ident,
                                     r1=tile([[0.0, 0, -1.0]]), r2=tile([[0.0, 0, 1.0]]),
                                     separation=tile([0.0]))

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, om)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], 4, Body, om,
                                                                    relaxation=0.7)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    return JointWorld


def bullet_world(pkg, speculative):
    """tests/test_physics.py _bullet_world for either package: a sphere
    at 1440 m/s (6 units a substep) aimed at a static sphere, 4 body rows
    (the dense contact mode)."""
    physics, bmod, cmod, conv = packages(pkg)
    om = objmgr(physics.assets)
    Body = (JArchetype if pkg == "jax" else Archetype)("PhysBody", physics.BODY_COMPONENTS)

    def tile(W, x, dt=np.float32):
        x = np.asarray(x, dt)
        return conv(np.array(np.broadcast_to(x, (W,) + x.shape)))

    class BulletWorld:
        @staticmethod
        def register_types(registry):
            physics.RigidBodyPhysicsSystem.register_types(registry, max_candidates=16,
                                                          max_contacts=16, max_joints=0)
            registry.register_archetype(Body, capacity=4)
            registry.export_column(Body, bmod.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            W = ctx.num_worlds
            ctx.data = {"_": tile(W, np.zeros(1))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)
            vel = np.zeros((4, 3), np.float32)
            vel[1, 0] = 1440.0
            ctx.make_entities(Body, counts=2, max_new=2, values={
                bmod.Position: tile(W, [[0.0, 0, 0.0], [-9.0, 0, 0.0]]),
                bmod.Rotation: tile(W, [[1.0, 0, 0, 0]] * 2),
                bmod.Scale: tile(W, np.ones((2, 3))),
                bmod.ObjectID: tile(W, [OBJ_SPHERE] * 2, np.int32),
                cmod.ResponseType: tile(W, [cmod.RESPONSE_STATIC, cmod.RESPONSE_DYNAMIC],
                                        np.int32)})
            cur = ctx.column(Body, cmod.Velocity)
            ctx.set_column(Body, cmod.Velocity, {"linear": tile(W, vel),
                                                 "angular": cur["angular"]})

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, om)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], 4, Body, om, relaxation=0.7, speculative_margin=speculative)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    return BulletWorld


def executors(world, num_worlds, max_entities):
    """(JAX executor, port executor), the JAX one holding the port's
    initial state."""
    jsim = JTaskGraphExecutor(world("jax"), JExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=max_entities, seed=0, donate=False))
    psim = TaskGraphExecutor(world("port"), ExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=max_entities, seed=0, device="cpu"))
    jsim.state = graft(jax.tree_util.tree_map(np.asarray, jsim.state),
                       state_to_numpy(psim.state))
    return jsim, psim


def trajectories(jsim, psim, steps):
    got, want = [], []
    with one_thread():
        for _ in range(steps):
            psim.step()
            jsim.step()
            got.append(psim.get_exported(0)[0].numpy())
            want.append(np.asarray(jsim.get_exported(0)[0]))
    return np.stack(got), np.stack(want)


def test_fixed_joint_holds_bodies_as_jax():
    jsim, psim = executors(joint_world, 2, 16)
    names = psim.graph.node_names
    assert "physics_substep_0" in names and phys.FUSED_NODE not in names
    got, want = trajectories(jsim, psim, 120)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:EARLY], want[:EARLY], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[-1], want[-1], atol=1e-3, rtol=0)
    p = got[-1]
    assert (np.abs(p[:, 1, 2] - 3.0) < 0.3).all(), p[:, 1]     # hangs at its attachment
    np.testing.assert_allclose(p[:, 0], np.tile([0, 0, 5.0], (2, 1)), atol=1e-6)


def test_speculative_contacts_stop_the_bullet_as_jax():
    """Without the margin the bullet tunnels (port alone); with a margin of
    3 it never passes the wall at x = -2, as in JAX."""
    psim = TaskGraphExecutor(bullet_world("port", 0.0), ExecutorConfig(
        num_worlds=1, max_entities_per_world=8, seed=0, device="cpu"))
    psim.run(2)
    assert float(psim.get_exported(0)[0][0, 1, 0]) > 2.0
    jsim, psim = executors(lambda pkg: bullet_world(pkg, 3.0), 1, 8)
    got, want = trajectories(jsim, psim, 6)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert got[:, 0, 1, 0].max() < -1.8, got[:, 0, 1, 0]
