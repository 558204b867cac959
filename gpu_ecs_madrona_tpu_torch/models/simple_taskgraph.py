"""simple_taskgraph example (PyTorch) — reference examples/simple_taskgraph/.

Counterpart of ``gpu_ecs_madrona_tpu/models/simple_taskgraph.py``: the
reference's flagship taskgraph (simple.cpp setupTasks:49-66) — a clamp
system, the rigid-body physics pipeline and the rendering system in one
graph; each world holds ``num_objects`` random spheres (100 in the
reference, init.cpp:34) and one agent with an active camera view
(simple.cpp:68-114); Agent Position/Rotation export at slots 0/1 and the
spheres' positions at slot 2.

A step runs the clamp node, the dense broadphase, the substeps
(relaxation 0.7), the cleanup, the render pack node and, with
``render=True``, the render node.  The body archetype holds
``num_objects + 4`` rows, so ``contact_mode="auto"`` takes the kernel
mode above 48 rows (``num_objects >= 45``) and the dense contact mode at
48 or fewer, as in the JAX package; the world registers the physics'
joint archetype (64 rows, none made), so each substep is one node: in
the kernel mode one launch of the single-substep kernel (the integrate,
the solve, the joint solve), in the dense mode the dense grid's solve
with the joint solve between its positional and velocity passes.  The
spawn draws
from the port's own per-world generator, so its numbers differ from the
JAX package's; parity tests start both from one JAX-initialised state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import uniform
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.physics import (
    BODY_COMPONENTS,
    RigidBodyPhysicsSystem,
    assets,
)
from gpu_ecs_madrona_tpu_torch.physics.components import (
    RESPONSE_DYNAMIC,
    RESPONSE_STATIC,
    ResponseType,
)
from gpu_ecs_madrona_tpu_torch.render.interop import ActiveView, RenderingSystem
from gpu_ecs_madrona_tpu_torch.utils import math as m

# Archetypes (reference simple.hpp:42-57): spheres + one agent with a view.
Sphere = Archetype("StgSphere", BODY_COMPONENTS)
Agent = Archetype("StgAgent", BODY_COMPONENTS + [ActiveView])

OBJ_SPHERE = 0
OBJ_PLANE = 1

BOUNDS_LO = (-10.0, -10.0, 0.0)
BOUNDS_HI = (10.0, 10.0, 10.0)


def _object_manager():
    loader = assets.PhysicsLoader()
    loader.load_objects([
        assets.make_sphere(1.0, inv_mass=1.0),
        assets.make_plane(),
    ])
    return loader.get_object_manager()


OBJMGR = _object_manager()


def _sphere_mesh(radius: float, n_lat: int = 6, n_lon: int = 8):
    """Lat-long triangle tessellation of a sphere (2 * n_lon * (n_lat - 1)
    triangles) for the render_mesh workload."""
    verts = [(0.0, 0.0, radius)]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append((radius * np.sin(th) * np.cos(ph),
                          radius * np.sin(th) * np.sin(ph),
                          radius * np.cos(th)))
    verts.append((0.0, 0.0, -radius))
    bot = len(verts) - 1
    tris = []
    for j in range(n_lon):
        tris.append((0, 1 + j, 1 + (j + 1) % n_lon))
    for i in range(n_lat - 2):
        r0 = 1 + i * n_lon
        r1 = r0 + n_lon
        for j in range(n_lon):
            j1 = (j + 1) % n_lon
            tris.append((r0 + j, r1 + j, r1 + j1))
            tris.append((r0 + j, r1 + j1, r0 + j1))
    r0 = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        tris.append((r0 + j, bot, r0 + (j + 1) % n_lon))
    return (np.asarray(verts, np.float32), np.asarray(tris, np.int32))


@dataclasses.dataclass
class SimpleTaskgraphConfig:
    num_worlds: int = 64
    num_objects: int = 100   # reference init.cpp:34 num_init_objs
    num_substeps: int = 4
    delta_t: float = 1.0 / 60.0
    seed: int = 0
    # RGB/depth observation rendering (reference BatchRenderer)
    render: bool = False
    render_width: int = 64
    render_height: int = 64
    render_backend: str = "auto"   # auto | pallas (the render kernel) | xla
    render_tile: int = 0           # "xla" route tile culling (RendererConfig.tile_size)
    render_tile_cap: int = 32      # max instances per tile
    # a lat-long triangle RENDER mesh on the sphere object: rays trace its
    # triangles instead of the analytic sphere
    render_mesh: bool = False


class SimpleTaskgraphWorld:
    config: SimpleTaskgraphConfig = SimpleTaskgraphConfig()

    @classmethod
    def with_config(cls, cfg: SimpleTaskgraphConfig):
        return type("SimpleTaskgraphWorld", (cls,), {"config": cfg})

    @classmethod
    def register_types(cls, registry: ECSRegistry):
        cfg = cls.config
        rows = cfg.num_objects + 4
        # reference simple.cpp registerTypes:37-47 (the joint archetype
        # keeps its default 64 rows, as in the JAX package: no joint is
        # made, but the substeps take the per-substep kernel that solves
        # them)
        RigidBodyPhysicsSystem.register_types(
            registry, max_candidates=cfg.num_objects * 10,
            max_contacts=cfg.num_objects * 10)
        RenderingSystem.register_types(registry)
        registry.register_archetype(Sphere, capacity=rows)
        registry.register_archetype(Agent, capacity=1)
        registry.export_column(Agent, base.Position, 0)
        registry.export_column(Agent, base.Rotation, 1)
        registry.export_column(Sphere, base.Position, 2)

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        cfg = cls.config
        W, n, dev = ctx.num_worlds, cfg.num_objects, ctx.device
        lo = torch.tensor(BOUNDS_LO, device=dev)
        hi = torch.tensor(BOUNDS_HI, device=dev)
        ctx.data = {"bounds_lo": lo.expand(W, 3).clone(), "bounds_hi": hi.expand(W, 3).clone()}
        RigidBodyPhysicsSystem.init(ctx, delta_t=cfg.delta_t, num_substeps=cfg.num_substeps)
        RenderingSystem.init(ctx, renderable_archetypes=[Sphere], view_archetype=Agent)
        if cfg.render:
            cls.renderer().init_buffers(ctx)

        # spheres: random positions and rotations about y (reference
        # init.cpp:20-53)
        kpos, kang = ctx.rng_one(), ctx.rng_one()
        pos = uniform(kpos, (n, 3), lo, hi)
        ang = uniform(kang, (n,), 0.0, math.pi)
        rot = m.quat_from_angle_axis(ang, [0.0, 1.0, 0.0])
        ctx.make_entities(Sphere, counts=n, max_new=n, values={
            base.Position: pos,
            base.Rotation: rot,
            base.Scale: torch.ones((W, n, 3), device=dev),
            base.ObjectID: torch.full((W, n), OBJ_SPHERE, dtype=torch.int32, device=dev),
            ResponseType: torch.full((W, n), RESPONSE_DYNAMIC, dtype=torch.int32, device=dev),
        })
        # the agent at the origin with a 90-degree view (reference
        # simple.cpp:101-107)
        ctx.make_entities(Agent, counts=1, max_new=1, values={
            base.Position: torch.zeros((W, 1, 3), device=dev),
            base.Rotation: torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(W, 1, 4),
            base.Scale: torch.ones((W, 1, 3), device=dev),
            base.ObjectID: torch.full((W, 1), OBJ_SPHERE, dtype=torch.int32, device=dev),
            ResponseType: torch.full((W, 1), RESPONSE_STATIC, dtype=torch.int32, device=dev),
            ActiveView: RenderingSystem.setup_view(ctx, 90.0),
        })

    @classmethod
    def renderer(cls):
        """The world's BatchRenderer (built once per configured class)."""
        from gpu_ecs_madrona_tpu_torch.render.renderer import BatchRenderer, RendererConfig
        if "_renderer_obj" not in cls.__dict__:
            cfg = cls.config
            cls._renderer_obj = BatchRenderer(
                RendererConfig(width=cfg.render_width, height=cfg.render_height, max_views=1,
                               backend=cfg.render_backend, tile_size=cfg.render_tile,
                               max_instances_per_tile=cfg.render_tile_cap),
                OBJMGR,
                render_meshes=({OBJ_SPHERE: _sphere_mesh(0.5)} if cfg.render_mesh else None))
        return cls._renderer_obj

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        cfg = cls.config

        # clamp system (reference simple.cpp:22-35)
        def clamp_system(rowctx, pos):
            return torch.clamp(pos, rowctx.data["bounds_lo"][:, None],
                               rowctx.data["bounds_hi"][:, None])

        n_clamp = builder.parallel_for_node(clamp_system, [base.Position],
                                            archetypes=[Sphere], name="clamp")

        # physics (reference simple.cpp:52-57)
        bp = RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [n_clamp], Sphere, OBJMGR)
        ss = RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], cfg.num_substeps,
                                                        Sphere, OBJMGR, relaxation=0.7)
        cl = RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

        # render packing (reference simple.cpp:59-62)
        pack = RenderingSystem.setup_tasks(builder, [cl], [Sphere], Agent)
        if cfg.render:
            cls.renderer().setup_tasks(builder, [pack], [Sphere])


def make_executor(cfg: SimpleTaskgraphConfig = SimpleTaskgraphConfig(), device: str = "cuda"):
    """The simple_taskgraph executor on ``device`` (the card unless the
    caller asks for the CPU; raises if there is no card)."""
    return TaskGraphExecutor(
        SimpleTaskgraphWorld.with_config(cfg),
        ExecutorConfig(num_worlds=cfg.num_worlds, max_entities_per_world=cfg.num_objects + 8,
                       seed=cfg.seed, device=device))
