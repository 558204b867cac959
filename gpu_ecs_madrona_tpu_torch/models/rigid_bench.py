"""Rigid-body pile benchmark (PyTorch) — the full physics pipeline at scale.

Counterpart of ``gpu_ecs_madrona_tpu/models/rigid_bench.py``: per world, a
ground plane (row 0) plus a pile of boxes and spheres dropped from random
poses, settling under gravity and friction, through RigidBodyPhysicsSystem
(velocity-expanded AABBs -> dense broadphase -> SAT narrowphase -> XPBD
substeps).  The default configuration is 8192 worlds x 64 bodies.

``contact_mode="pallas"`` runs the fused substep kernel (one launch a step
on the card), ``broadphase_mode="fused"`` the broadphase inside it, and
contact_refresh, sleep_threshold and manifold_persist its other options
(SETTLED_PILE); ``"pairs"`` the per-substep PyTorch path; ``"dense"``
the dense [W, n, n] contact grid (``"auto"`` takes it at 48 body rows or
fewer, the kernel above).  ``broadphase_mode="auto"`` is the dense
overlap grid up to 192 body rows and sweep and prune (``"sap"``) above.
The candidate capacity K is ``max_candidates`` or 4 x num_bodies (the JAX package's
autotuner artifact, written for the TPU, is not read).  The spawn draws
from the port's own per-world generator, so its numbers differ from the
JAX package's; parity tests start both from one JAX-initialised state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import normal, uniform
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.physics import BODY_COMPONENTS, RigidBodyPhysicsSystem, assets
from gpu_ecs_madrona_tpu_torch.physics.components import (
    RESPONSE_DYNAMIC,
    RESPONSE_STATIC,
    ResponseType,
)
from gpu_ecs_madrona_tpu_torch.utils import math as m

Body = Archetype("RigidBenchBody", BODY_COMPONENTS)

OBJ_BOX = 0
OBJ_SPHERE = 1
OBJ_PLANE = 2


def default_object_manager():
    loader = assets.PhysicsLoader(max_verts=8, max_faces=6, max_edges=3,
                                  max_face_verts=4, max_full_edges=12)
    loader.load_objects([
        assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.6, mu_d=0.4),
        assets.make_sphere(0.5, inv_mass=1.0, mu_s=0.6, mu_d=0.4),
        assets.make_plane(mu_s=0.8, mu_d=0.6),
    ])
    return loader.get_object_manager()


@dataclasses.dataclass
class RigidBenchConfig:
    """The JAX config's fields and defaults.  broadphase_mode 'sap' is
    sweep and prune (sap_window 0: min(n - 1, 64)); 'fused',
    contact_refresh, sleep_threshold > 0 and manifold_persist run the
    fused kernel's options.  The settled pile of the JAX package's
    bench_physics.py (BENCH_PHYS_SETTLE=1) is SETTLED_PILE."""

    num_worlds: int = 8192
    num_bodies: int = 64          # dynamic bodies per world (plus 1 plane)
    num_substeps: int = 4
    delta_t: float = 1 / 60
    max_candidates: int = 0       # 0 = 4 * num_bodies
    contact_mode: str = "pairs"   # pairs | pallas (the fused kernel) | dense | auto
    broadphase_mode: str = "auto"  # dense | sap | fused (in the kernel) | auto
    sap_window: int = 0
    # dense-broadphase rank-compaction degree cap (0 = every pair)
    dense_degree: int = 12
    contact_refresh: bool = False
    sleep_threshold: float = 0.0
    sleep_frames: int = 10
    manifold_persist: bool = False
    persist_margin: float = 0.05
    # "alternate": boxes and spheres interleaved; "boxes": boxes only
    body_mix: str = "alternate"
    # "uniform": i.i.d. uniform spawn (bodies interpenetrate at t=0);
    # "grid": jittered single layer at 1.85 spacing, no initial overlap
    spawn: str = "uniform"
    substep_wt: int = None        # the TPU kernel's world block; must stay None
    relaxation: float = 0.7
    spawn_xy: float = 8.0
    spawn_h: float = 12.0
    seed: int = 0

    def resolved_broadphase(self) -> str:
        return self.broadphase_mode

    def candidates(self) -> int:
        # a settled pile averages ~3 overlap pairs per body; 4x covers the
        # in-flight transient (overflow drops excess candidates, counted)
        return self.max_candidates or 4 * self.num_bodies


# The quasi-static settled pile (the JAX package's bench_physics.py:28-51,
# BENCH_PHYS_SETTLE=1): boxes only on a jittered grid, the broadphase in the
# fused kernel, contact refresh, persistent manifolds and world sleep; run
# 400 steps before timing.  Its A/B (BENCH_PHYS_PERSIST=0) drops the
# persistence and the sleep.
SETTLED_PILE = dict(contact_mode="pallas", body_mix="boxes", spawn="grid",
                    broadphase_mode="fused", contact_refresh=True, manifold_persist=True,
                    persist_margin=0.05, sleep_threshold=0.02)
SETTLE_STEPS = 400


class RigidBenchWorld:
    config: RigidBenchConfig = RigidBenchConfig()
    objmgr = default_object_manager()

    @classmethod
    def with_config(cls, cfg: RigidBenchConfig):
        return type("RigidBenchWorld", (cls,), {"config": cfg, "objmgr": cls.objmgr})

    @classmethod
    def register_types(cls, registry: ECSRegistry):
        cfg = cls.config
        RigidBodyPhysicsSystem.register_types(
            registry, max_candidates=cfg.candidates(), max_contacts=cfg.candidates(),
            max_joints=0)
        registry.register_archetype(Body, capacity=cfg.num_bodies + 1)
        if cfg.manifold_persist:
            RigidBodyPhysicsSystem.register_persistent_manifolds(registry, Body,
                                                                 cfg.candidates())
        registry.export_column(Body, base.Position, 0)
        registry.export_column(Body, base.Rotation, 1)

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        cfg = cls.config
        W, n, dev = ctx.num_worlds, cfg.num_bodies, ctx.device
        ctx.data = {"_": torch.zeros((W, 1), device=dev)}
        RigidBodyPhysicsSystem.init(ctx, delta_t=cfg.delta_t, num_substeps=cfg.num_substeps)
        kpos, kang, kax = ctx.rng_one(), ctx.rng_one(), ctx.rng_one()
        if cfg.spawn == "grid":
            side = 1
            while side * side < n:
                side += 1
            spacing = 1.85
            idx = torch.arange(n, device=dev)
            center = (side - 1) * 0.5
            gpos = torch.stack([((idx % side).float() - center) * spacing,
                                ((idx // side).float() - center) * spacing,
                                torch.full((n,), 1.2, device=dev)], -1)
            pos = gpos[None] + uniform(kpos, (n, 3), -0.15, 0.15)
        else:
            lo = torch.tensor([-cfg.spawn_xy, -cfg.spawn_xy, 1.0], device=dev)
            hi = torch.tensor([cfg.spawn_xy, cfg.spawn_xy, cfg.spawn_h], device=dev)
            pos = uniform(kpos, (n, 3), lo, hi)
        ang = uniform(kang, (n,), 0.0, math.pi)
        axis = normal(kax, (n, 3))
        axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
        rot = m.quat_from_angle_axis(ang, axis)
        if cfg.body_mix == "boxes":
            objs = torch.zeros((W, n), dtype=torch.int32, device=dev)
        else:
            objs = (torch.arange(n, dtype=torch.int32, device=dev) % 2).expand(W, n)
        # plane first (row 0), then the dynamic pile
        all_pos = torch.cat([torch.zeros((W, 1, 3), device=dev), pos], 1)
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(W, 1, 4)
        all_rot = torch.cat([ident, rot], 1)
        all_obj = torch.cat([torch.full((W, 1), OBJ_PLANE, dtype=torch.int32, device=dev),
                             objs], 1)
        all_resp = torch.cat([torch.full((W, 1), RESPONSE_STATIC, dtype=torch.int32, device=dev),
                              torch.full((W, n), RESPONSE_DYNAMIC, dtype=torch.int32,
                                         device=dev)], 1)
        ctx.make_entities(Body, counts=n + 1, max_new=n + 1, values={
            base.Position: all_pos,
            base.Rotation: all_rot,
            base.Scale: torch.ones((W, n + 1, 3), device=dev),
            base.ObjectID: all_obj,
            ResponseType: all_resp,
        })

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        cfg = cls.config
        bp = RigidBodyPhysicsSystem.setup_broadphase_tasks(
            builder, [], Body, cls.objmgr, mode=cfg.resolved_broadphase(),
            sap_window=cfg.sap_window, dense_degree=cfg.dense_degree)
        ss = RigidBodyPhysicsSystem.setup_substep_tasks(
            builder, [bp], cfg.num_substeps, Body, cls.objmgr,
            relaxation=cfg.relaxation, contact_mode=cfg.contact_mode,
            substep_wt=cfg.substep_wt, contact_refresh=cfg.contact_refresh,
            sleep_threshold=cfg.sleep_threshold, sleep_frames=cfg.sleep_frames,
            manifold_persist=cfg.manifold_persist, persist_margin=cfg.persist_margin)
        RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])


def make_executor(cfg: RigidBenchConfig = RigidBenchConfig(), device: str = "cuda"):
    """The rigid_bench executor on ``device`` (the card unless the caller
    asks for the CPU; raises if there is no card)."""
    return TaskGraphExecutor(
        RigidBenchWorld.with_config(cfg),
        ExecutorConfig(num_worlds=cfg.num_worlds, max_entities_per_world=cfg.num_bodies + 8,
                       seed=cfg.seed, device=device))
