"""Collisions example (PyTorch) — reference examples/collisions/.

Counterpart of ``gpu_ecs_madrona_tpu/models/collisions.py``: the same
components, archetypes, capacities, node names and node order.  The
reference's per-tick job chain (collisions.cpp: broadphaseSystem ->
narrowphaseSystem -> solverSystem) is a static taskgraph:

  1. aabb_preprocess (collisions.cpp:96-122): each cube's world-space AABB
     from its translation/rotation applied to the +-1 cube.
  2. broadphase (collisions.cpp:125-145): every ordered overlapping pair
     (a, b), a != b, becomes a CollisionCandidate row holding the two
     entity handles, in pair-index order.
  3. narrowphase (collisions.cpp:148-173): each candidate becomes a
     Contact with normal = normalize(b_pos - a_pos).
  4. solver (collisions.cpp:179-200): push a by -normal and b by +normal
     for every overlapping pair; candidates and contacts are cleared.

Eager PyTorch has no dead-code elimination, so the candidate and contact
rows are emitted lazily: they are built only if something reads them
before their clear node, and the push always uses every overlapping pair
(only the observable tables truncate at ``max_pairs``).

Initial state (collisions.cpp:39-88): 100 cubes per world, uniform random
positions in [-10,-10,0]..[10,10,10], rotation about +Y with angle in
[0, pi), drawn from the port's own per-world generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from gpu_ecs_madrona_tpu_torch.core.component import Archetype, component
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import uniform
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.ops.collision_kernel import (
    collision_pushes, fused_collisions_step, fused_fits)
from gpu_ecs_madrona_tpu_torch.tooling import autotuner
from gpu_ecs_madrona_tpu_torch.utils import math as m

f32, i32 = torch.float32, torch.int32

# Components (reference collisions.hpp:15-43)
Translation = component("Translation", ((3,), f32))
Rotation = component("Rotation", ((4,), f32))
PhysicsAABB = component("PhysicsAABB", lo=((3,), f32), hi=((3,), f32))
CandidatePair = component("CandidatePair", a=((), i32), b=((), i32))
ContactData = component("ContactData", normal=((3,), f32), a=((), i32), b=((), i32))

# Archetypes (reference collisions.hpp:45-48)
CubeObject = Archetype("CubeObject", [Translation, Rotation, PhysicsAABB])
CollisionCandidate = Archetype("CollisionCandidate", [CandidatePair])
Contact = Archetype("Contact", [ContactData])


@dataclasses.dataclass
class CollisionsConfig:
    num_worlds: int = 1024
    num_objects: int = 100  # reference collisions.cpp:72 init_num_objects
    # candidate/contact capacity per world (the observable tables; the
    # push itself never drops a pair)
    max_pairs: int = 1600
    seed: int = 0
    # fused=False only: the solver runs the collision_pushes kernel (on the
    # card; its plain version on the CPU) instead of the Gram form.  The
    # JAX package's field is ``use_pallas``.
    use_kernel: bool = False
    # One kernel for the whole tick (ops/collision_kernel.
    # fused_collisions_step): AABBs and push delta from the pre-push
    # positions; the delta is stashed and applied by the solver node.
    # None = on for a CUDA device when the bodies fit the kernel's
    # single-tile bound, off on the CPU.
    fused: Optional[bool] = None


@contextlib.contextmanager
def _strict_fp32():
    """TF32 off for the Gram products: in TF32 the cancellation in
    |xi|^2 + |xj|^2 - 2<xi, xj> loses close-pair d2, which goes negative
    and makes the rsqrt explode."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _compact(ok, k, grid_vals):
    """Compact grid channels [W, n*n, ...] where ok [W, n, n] holds to
    [W, k, ...] rows in pair-index order (rows past the count are zero)."""
    W = ok.shape[0]
    flat = ok.reshape(W, -1)
    ranks = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    dest = torch.where(flat & (ranks < k), ranks, k).long()  # k -> dropped
    outs = []
    for v in grid_vals:
        out = v.new_zeros((W, k + 1) + v.shape[2:])
        idx = dest.reshape(dest.shape + (1,) * (v.ndim - 2)).expand(v.shape)
        out.scatter_(1, idx, v)
        outs.append(out[:, :k])
    return outs


class CollisionsWorld:
    """World-class protocol implementation for the executor front door."""

    config: CollisionsConfig = CollisionsConfig()

    @classmethod
    def with_config(cls, cfg: CollisionsConfig):
        return type("CollisionsWorld", (cls,), {"config": cfg})

    # -- registration (reference collisions.cpp:53-66) ---------------------

    @classmethod
    def register_types(cls, registry: ECSRegistry):
        cfg = cls.config
        registry.register_archetype(CubeObject, capacity=cfg.num_objects + 8)
        registry.register_archetype(CollisionCandidate, capacity=cfg.max_pairs,
                                    temporary=True)
        registry.register_archetype(Contact, capacity=cfg.max_pairs, temporary=True)
        registry.export_column(CubeObject, Translation, 0)
        registry.export_column(CubeObject, Rotation, 1)

    # -- world ctor (reference collisions.cpp:39-88) ------------------------

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        cfg = cls.config
        W, n, dev = ctx.num_worlds, cfg.num_objects, ctx.device
        lo = torch.tensor([-10.0, -10.0, 0.0], device=dev)
        hi = torch.tensor([10.0, 10.0, 10.0], device=dev)
        ctx.data = {
            "bounds_lo": lo.expand(W, 3).clone(),
            "bounds_hi": hi.expand(W, 3).clone(),
            # fused-step stash, pre-created so the state keeps its keys
            "push_delta": torch.zeros((W, n + 8, 3), dtype=f32, device=dev),
        }
        kpos, kang = ctx.rng_one(), ctx.rng_one()
        pos = uniform(kpos, (n, 3), lo, hi)
        ang = uniform(kang, (n,), 0.0, math.pi)
        rot = m.quat_from_angle_axis(ang, [0.0, 1.0, 0.0])
        inv_lo, inv_hi = m.aabb_invalid((W, n), device=dev)
        ctx.make_entities(CubeObject, counts=n, max_new=n, values={
            Translation: pos,
            Rotation: rot,
            PhysicsAABB: {"lo": inv_lo, "hi": inv_hi},
        })

    # -- taskgraph (lowering of the reference's per-tick job chain) ---------

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        cfg = cls.config
        device = builder.mgr.device
        W = builder.mgr.num_worlds
        cap = cfg.num_objects + 8
        k_eff = min(cfg.max_pairs, cap * cap)
        fused, use_kernel = cfg.fused, cfg.use_kernel
        if fused is None:
            # the exec-config artifact first (tooling/autotuner.py, keyed by
            # this device's backend), its whole config as measured (the
            # tuner's unfused candidate is use_kernel=True), then the fixed
            # rule
            tuned = autotuner.lookup("collisions", backend_name=device.type,
                                     num_worlds=W, num_objects=cfg.num_objects)
            if tuned is not None and "fused" in tuned:
                fused = bool(tuned["fused"])
                use_kernel = bool(tuned.get("use_kernel", use_kernel))
            else:
                fused = device.type == "cuda" and fused_fits(cap)
        if fused and not fused_fits(cap):
            raise ValueError("fused=True: object count exceeds the fused "
                             "kernel's single-tile bound")
        eye = torch.eye(cap, dtype=torch.bool, device=device)
        memo = {}

        def pair_ok(mask, lo, hi):
            """Ordered-pair overlap grid [W, n, n] (live, overlapping,
            i != j).  The broadphase, narrowphase and solver of one step
            read the same AABB tensors, so the grid is built once and
            reused while its inputs are the same objects."""
            key = memo.get("key")
            if key is not None and key[0] is mask and key[1] is lo and key[2] is hi:
                return memo["ok"]
            ok = m.aabb_overlaps(lo[:, :, None, :], hi[:, :, None, :],
                                 lo[:, None, :, :], hi[:, None, :, :])
            ok = ok & mask[:, :, None] & mask[:, None, :] & ~eye
            memo.update(key=(mask, lo, hi), ok=ok)
            return ok

        def cube_pairs(ctx: Context):
            """(grid, counts, a_grid, b_grid) of this step's cubes, all
            deferred: nothing is computed until called."""
            mask = ctx.row_mask(CubeObject)
            aabb = ctx.column(CubeObject, PhysicsAABB)
            ents = ctx.entity_column(CubeObject)

            def grid():
                return pair_ok(mask, aabb["lo"], aabb["hi"])

            def counts():
                return grid().reshape(W, -1).sum(dim=1, dtype=torch.int32)

            def handles():
                return (ents[:, :, None].expand(W, cap, cap).reshape(W, -1),
                        ents[:, None, :].expand(W, cap, cap).reshape(W, -1))

            return grid, counts, handles

        if fused:
            def fused_pre(ctx: Context):
                # one kernel computes the AABBs AND the push delta from the
                # pre-push positions; the solver node applies the delta, so
                # broadphase/narrowphase still observe pre-push state
                pos = ctx.column(CubeObject, Translation)
                rot = ctx.column(CubeObject, Rotation)
                mask = ctx.row_mask(CubeObject)
                delta, lo, hi = fused_collisions_step(pos, rot, mask)
                ctx.set_column(CubeObject, PhysicsAABB, {"lo": lo, "hi": hi})
                ctx.data = dict(ctx.data, push_delta=delta)

            n_pre = builder.add_node(fused_pre, name="aabb_preprocess")
        else:
            corners = m.UNIT_CUBE_CORNERS.to(device)

            def aabb_preprocess(rowctx, pos, rot, aabb):
                # reference collisions.cpp:96-122 (unit-cube corner transform)
                lo, hi = m.aabb_from_points(m.transform_points(pos, rot, corners))
                return pos, rot, {"lo": lo, "hi": hi}

            n_pre = builder.parallel_for_node(
                aabb_preprocess, [Translation, Rotation, PhysicsAABB],
                name="aabb_preprocess")

        def broadphase(ctx: Context):
            # reference collisions.cpp:125-145: candidates = overlapping
            # ordered pairs, as entity-handle pairs
            grid, counts, handles = cube_pairs(ctx)

            def values():
                a_ent, b_ent = _compact(grid(), k_eff, handles())
                return {CandidatePair: {"a": a_ent, "b": b_ent}}

            # the counts are computed now only when the overflow counter
            # (state) needs them; fused mode solves without the table
            ctx.emit_temporaries(CollisionCandidate, counts=counts, values=values,
                                 count_overflow=not fused, width=k_eff)

        n_broad = builder.add_node(broadphase, deps=[n_pre], name="broadphase")

        def narrowphase(ctx: Context):
            # reference collisions.cpp:148-173: contact per candidate,
            # normal(a->b) = normalize(pos_b - pos_a)
            grid, counts, handles = cube_pairs(ctx)
            pos = ctx.column(CubeObject, Translation)

            def values():
                diff = pos[:, None, :, :] - pos[:, :, None, :]  # [W, a, b, 3]
                inv = torch.rsqrt((diff * diff).sum(-1, keepdim=True).clamp(min=1e-30))
                normals = (diff * inv).reshape(W, cap * cap, 3)
                norm_c, a_ent, b_ent = _compact(grid(), k_eff, [normals, *handles()])
                return {ContactData: {"normal": norm_c, "a": a_ent, "b": b_ent}}

            ctx.emit_temporaries(Contact, counts=counts, values=values,
                                 count_overflow=not fused, width=k_eff)

        n_narrow = builder.add_node(narrowphase, deps=[n_broad], name="narrowphase")
        n_clear_cand = builder.clear_tmp_node(CollisionCandidate, deps=[n_narrow])

        def solver(ctx: Context):
            # reference collisions.cpp:179-200: every unordered overlapping
            # pair {i, j} appears as (i, j) and (j, i), and all normals are
            # computed before any push, so the net delta is the dense
            #     delta_i = -2 * sum_j ok_ij * normalize(pos_j - pos_i)
            pos_col = ctx.column(CubeObject, Translation)
            if fused:
                ctx.set_column(CubeObject, Translation, pos_col + ctx.data["push_delta"])
                return
            aabb = ctx.column(CubeObject, PhysicsAABB)
            mask = ctx.row_mask(CubeObject)
            if use_kernel:
                delta = collision_pushes(pos_col, aabb["lo"], aabb["hi"], mask)
            else:
                # Gram form: the only [W, n, n] tensor is M = ok * rsqrt(d2)
                #   delta_i = -2 (M x - x * rowsum(M))
                # on positions centred per world (d2 is translation-
                # invariant; |x|^2 terms at large coordinates would cancel)
                ok = pair_ok(mask, aabb["lo"], aabb["hi"])
                pc = pos_col - pos_col.mean(dim=1, keepdim=True)
                with _strict_fp32():
                    gram = torch.bmm(pc, pc.transpose(1, 2))
                sq = (pc * pc).sum(-1)
                d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
                mmat = torch.where(ok, torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
                with _strict_fp32():
                    mx = torch.bmm(mmat, pc)
                delta = -2.0 * (mx - pc * mmat.sum(dim=2)[..., None])
            ctx.set_column(CubeObject, Translation, pos_col + delta)

        n_solve = builder.add_node(solver, deps=[n_clear_cand], name="solver")
        builder.clear_tmp_node(Contact, deps=[n_solve])


def make_executor(cfg: CollisionsConfig = CollisionsConfig(), device: str = "cuda"):
    """The collisions executor on ``device`` (the card unless the caller
    asks for the CPU; raises if there is no card)."""
    return TaskGraphExecutor(
        CollisionsWorld.with_config(cfg),
        ExecutorConfig(
            num_worlds=cfg.num_worlds,
            max_entities_per_world=cfg.num_objects + 8,
            seed=cfg.seed,
            device=device,
        ),
    )
