"""Scenes with joints in the port (no JAX; the scenes only, no tests):
shared by tests/test_torch_joint_world.py, test_torch_substep_node.py,
test_torch_cuda.py and chip_smoke.py.

  - joint_world: the plane; a static anchor with a box hung from it by a
    Fixed joint; a static pivot with a box swinging on a Hinge joint; a
    free box on the plane.  BODIES and the joints' arguments are also what
    tests/test_torch_joint_world.py builds the JAX package's world from.
  - random_joints: random live joints on simple_taskgraph's spheres.
"""

import math

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch import physics
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.physics import components as comp

HINGE = np.array([0.0, 0.0, 5.4], np.float32)
SWING = 0.2


def joint_scene(physics, bmod, cmod, Arch, conv, contact_mode):
    """The joint scene's World class (its archetype at ``World.Body``), 4
    substeps, from a package's ``physics``, ``base`` and physics
    ``components`` modules, its Archetype class and ``conv(x, dtype)``
    (numpy to the package's array on its device): the port's, or the JAX
    package's in tests/test_torch_joint_world.py."""
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

    World.Body = Body
    return World


def joint_world(contact_mode="pallas", num_worlds=2, device="cpu"):
    """The joint scene's executor in the port on ``device``."""
    def conv(x, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dt))).to(device)
    World = joint_scene(physics, base, comp, Archetype, conv, contact_mode)
    return TaskGraphExecutor(World, ExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=16, seed=0, device=device))


def random_joints(sim, kw, seed=0, num_spheres=48):
    """The node launch's inputs ``kw`` of a simple_taskgraph executor with
    ``num_spheres`` spheres, given random live joints among the first 12
    spheres (several on one body and side), a null handle and a handle of
    the Agent; on kw's device."""
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    rng = np.random.default_rng(seed)
    W, J = kw["jmask"].shape
    dev = kw["jmask"].device

    def conv(x):
        return torch.from_numpy(x).to(dev)
    ents = sim.mgr.entity_column(sim.state, stg.Sphere)
    pick1 = conv(rng.integers(0, 12, (W, J)))
    pick2 = (pick1 + 1 + conv(rng.integers(0, 12, (W, J)))) % num_spheres
    e1 = torch.gather(ents, 1, pick1).int()
    e2 = torch.gather(ents, 1, pick2).int()
    e2[0, 3] = -1
    e1[1, 5] = sim.mgr.entity_column(sim.state, stg.Agent)[1, 0]
    q = rng.normal(size=(2, W, J, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    joints = dict(kw["joints"], e1=e1.contiguous(), e2=e2.contiguous(),
                  joint_type=conv(rng.integers(0, 2, (W, J)).astype(np.int32)),
                  attach_rot1=conv(q[0]), attach_rot2=conv(q[1]),
                  separation=conv(rng.uniform(0, 1, (W, J)).astype(np.float32)))
    for f in ("a1_local", "a2_local", "r1", "r2"):
        joints[f] = conv(rng.normal(size=(W, J, 3)).astype(np.float32))
    return dict(kw, joints=joints, jmask=conv(rng.random((W, J)) < 0.8))
