"""Multi-step physics worlds of the port against the JAX package (CPU).

  - the four-body world of tests/test_physics.py:364-379 (plane, box,
    sphere, box dropped onto each other), 40 steps: the port's "pairs"
    and fused-kernel ("pallas", its plain version here) modes against each
    other, and (slow) each against JAX's "pairs" mode: rtol 1e-4, atol
    8e-2, that test's own tolerances (the restitution bounce amplifies
    reassociation differences);
  - the configuration of tests/test_physics.py:681-713 (2 worlds x 20
    bodies in a tight pile) at candidate capacities 256 and 128 — the
    chunked and the unchunked TPU routes, one kernel in the port — 8
    steps: the two capacities agree within 2e-3, and (slow) with JAX's
    "pairs" mode.
The comparisons with JAX are marked slow: each compiles a JAX physics
step on the CPU, 60-70 s on its own.  test_torch_physics.py holds one
step of both modes against JAX in the quick tier.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import components as jcomp

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics import components as comp

OBJ_BOX, OBJ_SPHERE, OBJ_PLANE = 0, 1, 2
FOUR_BODIES = [(OBJ_PLANE, (0, 0, 0.0), comp.RESPONSE_STATIC),
               (OBJ_BOX, (0, 0, 1.4), comp.RESPONSE_DYNAMIC),
               (OBJ_SPHERE, (0.4, 0.3, 3.0), comp.RESPONSE_DYNAMIC),
               (OBJ_BOX, (-0.5, 0.2, 5.0), comp.RESPONSE_DYNAMIC)]


def objmgr(assets):
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_box((1.0, 1.0, 1.0), inv_mass=1.0),
                         assets.make_sphere(1.0, inv_mass=1.0), assets.make_plane()])
    return loader.get_object_manager()


def make_world(pkg, contact_mode, bodies=FOUR_BODIES, num_worlds=2):
    """test_physics.make_world for either package (no joint archetype, so
    the two states convert 1:1); returns the executor."""
    if pkg == "jax":
        physics, bmod, cmod, Arch, lib = jphys, jbase, jcomp, JArchetype, jnp
    else:
        physics, bmod, cmod, Arch, lib = phys, base, comp, Archetype, None
    om = objmgr(physics.assets)
    Body = Arch("PhysBody", physics.BODY_COMPONENTS)

    class PhysWorld:
        @staticmethod
        def register_types(registry):
            physics.RigidBodyPhysicsSystem.register_types(registry, max_candidates=64,
                                                          max_contacts=64, max_joints=0)
            registry.register_archetype(Body, capacity=16)
            registry.export_column(Body, bmod.Position, 0)
            registry.export_column(Body, bmod.Rotation, 1)

        @staticmethod
        def init(ctx, init_data=None):
            W, nb = ctx.num_worlds, len(bodies)
            conv = (lambda x, dt=np.float32: lib.asarray(np.asarray(x, dt))) if lib else \
                (lambda x, dt=np.float32: __import__("torch").from_numpy(np.asarray(x, dt)))
            ctx.data = {"_": conv(np.zeros((W, 1)))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)
            tile = lambda a: np.broadcast_to(np.asarray(a), (W,) + np.asarray(a).shape)  # noqa
            ctx.make_entities(Body, counts=nb, max_new=nb, values={
                bmod.Position: conv(tile([b[1] for b in bodies])),
                bmod.Rotation: conv(tile([[1.0, 0, 0, 0]] * nb)),
                bmod.Scale: conv(np.ones((W, nb, 3))),
                bmod.ObjectID: conv(tile([b[0] for b in bodies]), np.int32),
                cmod.ResponseType: conv(tile([b[2] for b in bodies]), np.int32),
            })

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, om)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], 4, Body, om, relaxation=0.7, contact_mode=contact_mode)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    if pkg == "jax":
        return JTaskGraphExecutor(PhysWorld, JExecutorConfig(
            num_worlds=num_worlds, max_entities_per_world=32, seed=0, donate=False))
    return TaskGraphExecutor(PhysWorld, ExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=32, seed=0, device="cpu"))


def four_body_port(mode, init, steps=40):
    sim = make_world("port", mode)
    sim.state = state_from_numpy(init, "cpu")
    sim.run(steps)
    got = sim.get_exported(0)[0].numpy()
    assert np.isfinite(got).all()
    # the bodies did meet: the top box rests well below its drop height
    assert got[:, 3, 2].max() < 4.0
    return got


@pytest.fixture(scope="module")
def four_body_init():
    return jax.tree_util.tree_map(np.asarray, make_world("jax", "pairs").state)


def test_four_body_world_modes_agree(four_body_init):
    np.testing.assert_allclose(four_body_port("pallas", four_body_init),
                               four_body_port("pairs", four_body_init), rtol=1e-4, atol=8e-2)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["pairs", "pallas"])
def test_four_body_world_matches_jax_pairs(four_body_init, mode):
    sim = make_world("jax", "pairs")
    sim.run(40)
    want = np.asarray(sim.get_exported(0)[0])
    np.testing.assert_allclose(four_body_port(mode, four_body_init), want, rtol=1e-4,
                               atol=8e-2)


CHUNK_CFG = dict(num_worlds=2, num_bodies=20, broadphase_mode="dense", dense_degree=10,
                 seed=0, spawn_xy=3.0, spawn_h=4.0)


def capacity_runs(with_jax):
    """8 fused-mode steps of the port at K = 256 and 128 from the same
    JAX-initialised pile (and, with_jax, JAX's pairs mode at K = 256)."""
    out = {}
    for K in (256, 128):
        jsim = jrb.make_executor(jrb.RigidBenchConfig(contact_mode="pairs", max_candidates=K,
                                                      **CHUNK_CFG), donate=False)
        psim = rb.make_executor(rb.RigidBenchConfig(contact_mode="pallas", max_candidates=K,
                                                    **CHUNK_CFG), device="cpu")
        psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
        psim.run(8)
        pos, mask = psim.get_exported(0)
        assert bool(mask.all()) and np.isfinite(pos.numpy()).all()
        assert int(sum(v.sum() for v in state_to_numpy(psim.state)["overflow"].values())) == 0
        out[K] = pos.numpy()
        if with_jax and K == 256:
            jsim.run(8)
            out["jax"] = np.asarray(jsim.get_exported(0)[0])
    return out


def test_capacity_256_matches_128():
    """One kernel serves both TPU routes (K > 128 chunked, K <= 128 not)."""
    out = capacity_runs(with_jax=False)
    np.testing.assert_allclose(out[256], out[128], atol=2e-3, rtol=0)


@pytest.mark.slow
def test_capacity_256_matches_jax_pairs():
    out = capacity_runs(with_jax=True)
    np.testing.assert_allclose(out[256], out["jax"], atol=2e-3, rtol=0)
