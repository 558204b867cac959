"""The reference binary's joint golden, cube_chain_ss4, in the kernel mode:
the port against the JAX package.

In "pairs" mode the port holds the golden with the JAX package's gates
(test_torch_physics_golden.py::test_golden_fixed_joint_chain).  In the
kernel mode both engines solve the joints after the velocity pass (the
JAX package's documented trade, physics/__init__.py:581-587 there), and
both miss the golden's early gate (0.02 over the first 10 ticks) by the
same amount, ~0.048.  This test names that miss and holds the port's
kernel-mode trajectory to JAX's (positions atol 1e-5; ~1.2e-6 seen), in
place of loosening the golden's gate.  JAX's 4-substep physics in its
interpreted kernel mode compiles for minutes on a CPU: the test is slow.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.physics import components as jcomp

from test_torch_physics_golden import load_golden, run_equivalent


def run_jax(golden, W, K, substeps, dt, ticks, contact_mode):
    """tests/test_reference_golden.py's run_equivalent with its Fixed joint,
    in contact mode ``contact_mode``; returns [ticks + 1, W, K, 13]."""
    loader = jphys.assets.PhysicsLoader()
    loader.load_objects([jphys.assets.make_plane(mu_s=0.5, mu_d=0.5),
                         jphys.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.5,
                                               mu_d=0.5)])
    mgr = loader.get_object_manager()
    Body = JArchetype("GoldenBody", jphys.BODY_COMPONENTS)
    init0 = golden[0]

    class World:
        @staticmethod
        def register_types(r):
            jphys.RigidBodyPhysicsSystem.register_types(r, max_candidates=64, max_contacts=64,
                                                        max_joints=4)
            r.register_archetype(Body, capacity=K + 1)
            r.export_column(Body, jbase.Position, 0)
            r.export_column(Body, jbase.Rotation, 1)
            r.export_column(Body, jcomp.Velocity, 2)

        @staticmethod
        def init(ctx, init_data=None):
            Wn = ctx.num_worlds
            ctx.data = {"_": jnp.zeros((Wn, 1))}
            jphys.RigidBodyPhysicsSystem.init(ctx, delta_t=dt, num_substeps=substeps)
            pos = np.zeros((Wn, K + 1, 3), np.float32)
            rot = np.zeros((Wn, K + 1, 4), np.float32)
            rot[..., 0] = 1.0
            vel = np.zeros((Wn, K + 1, 3), np.float32)
            omega = np.zeros((Wn, K + 1, 3), np.float32)
            oid = np.zeros((Wn, K + 1), np.int32)
            resp = np.full((Wn, K + 1), jcomp.RESPONSE_STATIC, np.int32)
            pos[:, 1:], rot[:, 1:] = init0[..., 0:3], init0[..., 3:7]
            vel[:, 1:], omega[:, 1:] = init0[..., 7:10], init0[..., 10:13]
            oid[:, 1:] = 1
            resp[:, 1:] = jcomp.RESPONSE_DYNAMIC
            ents = ctx.make_entities(Body, counts=K + 1, max_new=K + 1, values={
                jbase.Position: jnp.asarray(pos), jbase.Rotation: jnp.asarray(rot),
                jbase.Scale: jnp.ones((Wn, K + 1, 3)), jbase.ObjectID: jnp.asarray(oid),
                jcomp.Velocity: {"linear": jnp.asarray(vel), "angular": jnp.asarray(omega)},
                jcomp.ResponseType: jnp.asarray(resp)})
            ident = jnp.broadcast_to(jnp.array([1.0, 0, 0, 0]), (Wn, 1, 4))
            jphys.make_fixed_joint(ctx, ents[:, 1:2], ents[:, 2:3], ident, ident,
                                   jnp.broadcast_to(jnp.array([0.0, 0, -0.6]), (Wn, 1, 3)),
                                   jnp.broadcast_to(jnp.array([0.0, 0, 0.6]), (Wn, 1, 3)),
                                   jnp.zeros((Wn, 1)))

        @staticmethod
        def setup_tasks(builder):
            bp = jphys.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, mgr)
            sub = jphys.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], substeps, Body, mgr, contact_mode=contact_mode)
            jphys.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [sub])

    sim = JTaskGraphExecutor(World, JExecutorConfig(num_worlds=W, max_entities_per_world=K + 8,
                                                    seed=0, donate=False))
    out = np.zeros((ticks + 1, W, K, 13), np.float32)
    out[0] = init0
    for t in range(1, ticks + 1):
        sim.run(1)
        vel = sim.get_exported(2)[0]
        out[t] = np.concatenate([np.asarray(sim.get_exported(0)[0])[:, 1:K + 1],
                                 np.asarray(sim.get_exported(1)[0])[:, 1:K + 1],
                                 np.asarray(vel["linear"])[:, 1:K + 1],
                                 np.asarray(vel["angular"])[:, 1:K + 1]], axis=-1)
    return out


@pytest.mark.slow
def test_kernel_mode_chain_misses_the_early_gate_as_jax_does():
    golden, W, K, ss, dt = load_golden("cube_chain_ss4")
    T = golden.shape[0] - 1
    mine = run_equivalent(golden, W, K, ss, dt, T, "pallas", joint=True)
    theirs = run_jax(golden, W, K, ss, dt, T, "pallas")
    np.testing.assert_allclose(mine[..., 0:3], theirs[..., 0:3], rtol=0, atol=1e-5)
    err_m = np.abs(mine[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
    err_j = np.abs(theirs[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
    # the known miss: both engines over the early gate, by the same amount
    assert err_m[:10].max() > 0.02 and err_j[:10].max() > 0.02, (err_m[:10], err_j[:10])
    assert abs(err_m[:10].max() - err_j[:10].max()) <= 1e-5
    # the rest of the golden's gates hold in the kernel mode too
    assert err_m.max() <= 1.5 and err_j.max() <= 1.5, (err_m.max(), err_j.max())
    assert (mine[-1, :, :, 2] < 2.0).all()
    assert np.isfinite(mine).all()
