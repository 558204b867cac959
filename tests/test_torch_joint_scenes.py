"""Scenes with joints in the port (no JAX; the scenes only, no tests):
shared by tests/test_torch_joint_world.py, test_torch_substep_node.py,
test_torch_cuda.py and chip_smoke.py.

  - joint_world: the plane; a static anchor with a box hung from it by a
    Fixed joint; a static pivot with a box swinging on a Hinge joint; a
    free box on the plane.  BODIES and the joints' arguments are also what
    tests/test_torch_joint_world.py builds the JAX package's world from.
  - random_joints: random live joints on simple_taskgraph's spheres.
  - chain_scene / chain_world: hanging chains of boxes, their links joined
    by alternating Fixed and Hinge joints, in a joint archetype of many
    rows (4,096 by default: past what fits beside kernel 5's window).
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


def joint_scene(physics, bmod, cmod, Arch, conv, contact_mode, body=None):
    """The joint scene's World class (its archetype at ``World.Body``), 4
    substeps, from a package's ``physics``, ``base`` and physics
    ``components`` modules, its Archetype class and ``conv(x, dtype)``
    (numpy to the package's array on its device): the port's, or the JAX
    package's in tests/test_torch_joint_world.py.  ``body``: the object of
    every body but the plane (default a box of half extent 0.5; e.g. the
    imported prism of tests/test_torch_hull_scenes.py)."""
    loader = physics.assets.PhysicsLoader()
    loader.load_objects([physics.assets.make_plane(),
                         body or physics.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0)])
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


def joint_world(contact_mode="pallas", num_worlds=2, device="cpu", body=None):
    """The joint scene's executor in the port on ``device`` (``body`` as in
    joint_scene)."""
    def conv(x, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dt))).to(device)
    World = joint_scene(physics, base, comp, Archetype, conv, contact_mode, body)
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


CHAIN_LINKS = 16       # boxes a chain, the first a static anchor
CHAIN_TOP = 30.0       # the anchors' height
CHAIN_GAP = 3.0        # the chains' spacing along x
CHAIN_BEND = 0.05      # each link's x offset from the one above (the joints pull it back)


def chain_layout(num_chains, links=CHAIN_LINKS):
    """The chains' bodies and joints, in numpy: (positions [B, 3], static
    [B] bool, joints [(row 1, row 2, fixed)]) over B = num_chains x links
    boxes in chain order.  Link k hangs from link k - 1 by a Fixed joint
    (attachments 1 below and above the boxes' centres: 2.0 apart) for odd
    k, a Hinge joint about y (0.6 below and above: 1.2 apart) for even k,
    each link bent CHAIN_BEND further along x."""
    pos, static, joints = [], [], []
    for c in range(num_chains):
        x, z = CHAIN_GAP * (c - (num_chains - 1) / 2), CHAIN_TOP
        for k in range(links):
            if k:
                fixed = k % 2 == 1
                z -= 2.0 if fixed else 1.2
                x += CHAIN_BEND
                joints.append((len(pos) - 1, len(pos), fixed))
            pos.append((x, 0.0, z))
            static.append(k == 0)
    return np.asarray(pos, np.float32), np.asarray(static), joints


def chain_scene(physics, bmod, cmod, Arch, conv, contact_mode, num_chains=4,
                max_joints=4096, max_candidates=256, links=CHAIN_LINKS):
    """The chains' World class (its archetype at ``World.Body``), 4
    substeps, from a package's modules as joint_scene takes them: the
    plane and ``num_chains`` chains of ``links`` boxes (chain_layout), in a
    joint archetype of ``max_joints`` rows."""
    loader = physics.assets.PhysicsLoader()
    loader.load_objects([physics.assets.make_plane(),
                         physics.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0)])
    om = loader.get_object_manager()
    Body = Arch("ChainBody", physics.BODY_COMPONENTS)
    pos, static, joints = chain_layout(num_chains, links)
    nb = len(pos) + 1
    obj = np.concatenate([[0], np.ones(len(pos), np.int32)]).astype(np.int32)
    where = np.concatenate([np.zeros((1, 3), np.float32), pos])
    resp = np.where(np.concatenate([[True], static]), cmod.RESPONSE_STATIC,
                    cmod.RESPONSE_DYNAMIC).astype(np.int32)
    fixed = [(i + 1, j + 1) for i, j, f in joints if f]
    hinge = [(i + 1, j + 1) for i, j, f in joints if not f]

    class World:
        @staticmethod
        def register_types(registry):
            physics.RigidBodyPhysicsSystem.register_types(
                registry, max_candidates=max_candidates, max_contacts=max_candidates,
                max_joints=max_joints)
            registry.register_archetype(Body, capacity=nb)
            registry.export_column(Body, bmod.Position, 0)
            registry.export_column(Body, bmod.Rotation, 1)

        @staticmethod
        def init(ctx, init_data=None):
            W = ctx.num_worlds

            def tile(x, dt=np.float32):
                x = np.asarray(x, dt)
                return conv(np.broadcast_to(x, (W,) + x.shape), dt)
            ctx.data = {"_": conv(np.zeros((W, 1)))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)
            rot = np.zeros((nb, 4), np.float32)
            rot[:, 0] = 1.0
            ents = ctx.make_entities(Body, counts=nb, max_new=nb, values={
                bmod.Position: tile(where), bmod.Rotation: tile(rot),
                bmod.Scale: conv(np.ones((W, nb, 3))), bmod.ObjectID: tile(obj, np.int32),
                cmod.ResponseType: tile(resp, np.int32)})

            def vec(x, m, k=3):
                return conv(np.broadcast_to(np.asarray(x, np.float32), (W, m, k)))

            def side(pairs, s):
                return ents[:, [p[s] for p in pairs]]
            nf, nh = len(fixed), len(hinge)
            physics.make_fixed_joint(ctx, side(fixed, 0), side(fixed, 1), vec([1, 0, 0, 0], nf, 4),
                                     vec([1, 0, 0, 0], nf, 4), r1=vec([0, 0, -1.0], nf),
                                     r2=vec([0, 0, 1.0], nf),
                                     separation=conv(np.zeros((W, nf))), counts=nf, max_new=nf)
            physics.make_hinge_joint(ctx, side(hinge, 0), side(hinge, 1), vec([0, 1, 0], nh),
                                     vec([0, 1, 0], nh), vec([1, 0, 0], nh), vec([1, 0, 0], nh),
                                     vec([0, 0, -0.6], nh), vec([0, 0, 0.6], nh), counts=nh,
                                     max_new=nh)

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, om)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], 4, Body, om, relaxation=0.7, contact_mode=contact_mode)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    World.Body = Body
    World.num_joints = len(joints)
    World.num_rows = nb
    return World


def chain_world(contact_mode="pallas", num_worlds=2, device="cpu", **kw):
    """The chains' executor in the port on ``device`` (chain_scene's
    keywords)."""
    def conv(x, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dt))).to(device)
    World = chain_scene(physics, base, comp, Archetype, conv, contact_mode, **kw)
    return TaskGraphExecutor(World, ExecutorConfig(
        num_worlds=num_worlds, max_entities_per_world=World.num_rows + World.num_joints + 8,
        seed=0, device=device))
