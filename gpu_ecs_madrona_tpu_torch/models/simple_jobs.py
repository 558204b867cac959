"""simple_jobs example (PyTorch) — reference examples/simple_jobs/.

Counterpart of ``gpu_ecs_madrona_tpu/models/simple_jobs.py``: the same
config, the same ``ctx.data`` keys, shapes and dtypes, and the same node
names.  The reference keeps this example's state outside the ECS, in raw
per-world buffers with atomic counters (simple.hpp:63-88); here they are
per-world user data, and nothing is registered with the ECS.

Per tick (reference simple.cpp):
  1. preprocess (simple.cpp:148-190): clamp each translation to the world
     bounds, then the AABB of the rotated unit cube (8 transformed corners).
  2. broadphase (simple.cpp:193-218): the ordered overlapping pairs
     (a != b) as (a, b) index pairs, compacted in ascending pair order.
  3. narrowphase (simple.cpp:222-250): contact normal = normalize(b - a).
  4. solver (simple.cpp:159-181): a -= normal, b += normal per contact,
     which sums to a dense centred push over every overlapping pair;
     counters reset.

``fused=True`` runs the whole tick as one kernel
(ops/simple_jobs_kernel.fused_simple_jobs_step) in a single node,
``fused_step``, which on the card is that one launch (the reset counters
come from it too); its AABBs take the extents from |R| instead of 8 corners,
so a borderline overlap can differ from the 4-node path.

Unlike the collisions example, the candidate and contact buffers are
observable user state, so every step builds them in full.

Init (simple_jobs/init.cpp): uniform random positions in the bounds,
rotations about +Y with angle in [0, pi), from the port's own per-world
generator.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import batched_gather, uniform
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.models.collisions import _strict_fp32
from gpu_ecs_madrona_tpu_torch.ops.simple_jobs_kernel import (
    clamp_to_bounds, fused_fits, fused_simple_jobs_step, overlap_grid)
from gpu_ecs_madrona_tpu_torch.utils import debug
from gpu_ecs_madrona_tpu_torch.utils import math as m
from gpu_ecs_madrona_tpu_torch.utils.compaction import first_partners, rank_slots

BOUNDS_LO = (-10.0, -10.0, 0.0)
BOUNDS_HI = (10.0, 10.0, 10.0)
BOUNDS = (BOUNDS_LO, BOUNDS_HI)
COMPACT_MODES = ("topk", "sortkey", "twostage", "rank", "rank_sort")
_BIG = 2 ** 30

f32, i32 = torch.float32, torch.int32


@dataclasses.dataclass
class SimpleJobsConfig:
    num_worlds: int = 1024
    num_objects: int = 100
    max_pairs: int = 1600  # candidate/contact buffer capacity K
    # per-body partner cap D of the capped compaction modes (twostage,
    # rank, rank_sort and the fused kernel); pairs past it are counted in
    # ``dropped`` (checked under GEM_TPU_DEBUG), never silently reordered
    degree_cap: int = 32
    seed: int = 0
    # The whole tick as one kernel.  None = on for a CUDA device (at any
    # body count), off on the CPU.
    fused: Optional[bool] = None


def _sort_compact(flat, k: int):
    """The first k set positions of each row of flat [W, L] in ascending
    order (0 past the count), by sorting iota keys."""
    iota = torch.arange(flat.shape[1], dtype=i32, device=flat.device)
    keys = torch.sort(torch.where(flat, iota, _BIG), dim=1).values[:, :k]
    return torch.where(keys < _BIG, keys, 0)


class SimpleJobsWorld:
    config: SimpleJobsConfig = SimpleJobsConfig()

    @classmethod
    def with_config(cls, cfg: SimpleJobsConfig):
        return type("SimpleJobsWorld", (cls,), {"config": cfg})

    @classmethod
    def register_types(cls, registry: ECSRegistry):
        # the state lives in user data (simple.hpp:63-88): nothing to register
        pass

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        cfg = cls.config
        W, n, K, dev = ctx.num_worlds, cfg.num_objects, cfg.max_pairs, ctx.device
        lo = torch.tensor(BOUNDS_LO, device=dev)
        hi = torch.tensor(BOUNDS_HI, device=dev)
        kpos, kang = ctx.rng_one(), ctx.rng_one()
        pos = uniform(kpos, (n, 3), lo, hi)
        ang = uniform(kang, (n,), 0.0, math.pi)
        rot = m.quat_from_angle_axis(ang, [0.0, 1.0, 0.0])

        def zeros(shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        ctx.data = {
            "translation": pos,                 # [W, n, 3]
            "rotation": rot,                    # [W, n, 4]
            "aabb_lo": zeros((W, n, 3)),
            "aabb_hi": zeros((W, n, 3)),
            "candidates": zeros((W, K, 2), i32),
            "num_candidates": zeros((W,), i32),
            "contacts_normal": zeros((W, K, 3)),
            "contacts_ab": zeros((W, K, 2), i32),
            "num_contacts": zeros((W,), i32),
        }

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        cfg = cls.config
        K, n0 = cfg.max_pairs, cfg.num_objects
        fused = cfg.fused
        if fused is None:
            fused = builder.mgr.device.type == "cuda"
        if fused and not fused_fits(n0):
            raise ValueError(f"fused=True: num_objects={n0}, at least 1 needed")
        if fused:
            def fused_step(ctx: Context):
                d = dict(ctx.data)
                # the reset counters come from the same launch: one device op
                npos, lo, hi, ab, nrm, counts, dropped, zero = fused_simple_jobs_step(
                    d["translation"], d["rotation"], n0=n0, K=K,
                    degree_cap=min(cfg.degree_cap, n0), bounds=BOUNDS, zeros=True)
                if debug.DEBUG:  # the predicate alone would be a second device op
                    debug.check(dropped == 0, "simple_jobs degree cap exceeded: "
                                "dropped pairs={} per world — raise degree_cap", dropped)
                d.update(translation=npos, aabb_lo=lo, aabb_hi=hi,
                         candidates=ab, num_candidates=zero,
                         contacts_normal=nrm, contacts_ab=ab, num_contacts=zero)
                ctx.data = d

            builder.add_node(fused_step, name="fused_step")
            return

        mode = os.environ.get("GEM_SJ_COMPACT", "rank")
        if mode not in COMPACT_MODES:
            raise ValueError(f"GEM_SJ_COMPACT={mode!r}: not one of {COMPACT_MODES}")
        device = builder.mgr.device
        corners = m.UNIT_CUBE_CORNERS.to(device)
        bounds = (torch.tensor(BOUNDS_LO, device=device), torch.tensor(BOUNDS_HI, device=device))
        memo = {}

        def pair_grid(d):
            """The step's overlap grid; broadphase and solver read the same
            AABB tensors, so it is built once while they are the same."""
            lo, hi = d["aabb_lo"], d["aabb_hi"]
            if memo.get("lo") is not lo or memo.get("hi") is not hi:
                memo.update(lo=lo, hi=hi, ok=overlap_grid(lo, hi))
            return memo["ok"]

        def preprocess(ctx: Context):
            d = dict(ctx.data)
            pos = clamp_to_bounds(d["translation"], bounds)
            alo, ahi = m.aabb_from_points(m.transform_points(pos, d["rotation"], corners))
            d.update(translation=pos, aabb_lo=alo, aabb_hi=ahi)
            ctx.data = d

        n_pre = builder.add_node(preprocess, name="preprocess")

        def broadphase(ctx: Context):
            # reference simple.cpp:193-218: the reference appends with an
            # atomic counter in scheduler order; here the pairs come in
            # ascending pair-index order, (a, b) -> a * n + b
            d = dict(ctx.data)
            ok = pair_grid(d)
            W, n = ok.shape[:2]
            k_eff = min(K, n * n)
            if mode in ("topk", "sortkey"):
                flat = ok.reshape(W, n * n)
                counts = flat.sum(dim=1, dtype=i32)
                if mode == "topk":
                    # lax.top_k's order: descending, ties by ascending index
                    # (the tail holds the first non-overlapping pairs)
                    pair_idx = torch.sort(flat.to(torch.int8), dim=1, descending=True,
                                          stable=True).indices[:, :k_eff].to(i32)
                else:
                    pair_idx = _sort_compact(flat, k_eff)
            elif mode == "twostage":
                # per-row sort packs the first D partners, one sort over
                # the [n * D] survivors
                D = min(cfg.degree_cap, n)
                iota_n = torch.arange(n, dtype=i32, device=ok.device)
                part = torch.sort(torch.where(ok, iota_n, _BIG), dim=2).values[:, :, :D]
                valid = part < _BIG
                deg = ok.sum(dim=2, dtype=i32)
                dropped = (deg - D).clamp(min=0).sum(dim=1, dtype=i32)
                debug.check(dropped == 0, f"simple_jobs degree cap {D} exceeded: "
                            "dropped pairs={} per world — raise degree_cap", dropped)
                counts = deg.sum(dim=1, dtype=i32) - dropped
                a_iota = iota_n[None, :, None] * n
                fkey = torch.where(valid, a_iota + part, _BIG).reshape(W, n * D)
                k_take = min(k_eff, n * D)
                keys = torch.sort(fkey, dim=1).values[:, :k_take]
                pair_idx = torch.where(keys < _BIG, keys, 0)
                if k_take < k_eff:
                    pair_idx = torch.nn.functional.pad(pair_idx, (0, k_eff - k_take))
            else:
                # rank / rank_sort: slot(a, b) = base[a] + rank(b in row a),
                # ascending in (a, b) by construction; the two modes differ
                # only in how row a's first D partners are found
                D = min(cfg.degree_cap, n)
                if mode == "rank_sort":
                    partners = _sort_compact(ok.reshape(W * n, n), D).reshape(W, n, D)
                    deg = ok.sum(dim=2, dtype=i32)
                else:
                    partners, deg = first_partners(ok, D)
                ab, counts, dropped = rank_slots(partners, deg, D, k_eff)
                debug.check(dropped == 0, f"simple_jobs degree cap {D} exceeded: "
                            "dropped pairs={} per world — raise degree_cap", dropped)
                pair_idx = ab[..., 0] * n + ab[..., 1]
            ab = torch.stack([pair_idx // n, pair_idx % n], dim=-1).to(i32)
            cands = torch.zeros((W, K, 2), dtype=i32, device=ok.device)
            cands[:, :k_eff] = ab
            d.update(candidates=cands, num_candidates=counts.clamp(max=k_eff))
            ctx.data = d

        n_broad = builder.add_node(broadphase, deps=[n_pre], name="broadphase")

        def narrowphase(ctx: Context):
            # reference simple.cpp:222-250, and the candidate counter reset
            # at :154-157
            d = dict(ctx.data)
            pos, cands = d["translation"], d["candidates"]
            diff = batched_gather(pos, cands[..., 1]) - batched_gather(pos, cands[..., 0])
            inv = torch.rsqrt((diff * diff).sum(-1, keepdim=True).clamp(min=1e-30))
            d.update(contacts_normal=diff * inv, contacts_ab=cands,
                     num_contacts=d["num_candidates"],
                     num_candidates=torch.zeros_like(d["num_candidates"]))
            ctx.data = d

        n_narrow = builder.add_node(narrowphase, deps=[n_broad], name="narrowphase")

        def solver(ctx: Context):
            # reference simple.cpp:159-181: the net push over every
            # overlapping pair in the Gram form (models/collisions.py
            # solver), on positions centred per world
            d = dict(ctx.data)
            ok = pair_grid(d)
            pos = d["translation"]
            pc = pos - pos.mean(dim=1, keepdim=True)
            with _strict_fp32():
                gram = torch.bmm(pc, pc.transpose(1, 2))
            sq = (pc * pc).sum(-1)
            d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
            # coincident pairs (clamped into the same bounds corner) have no
            # push direction (the reference's normalize(0) is NaN): excluded
            mmat = torch.where(ok & (d2 > 1e-12), torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
            with _strict_fp32():
                mx = torch.bmm(mmat, pc)
            delta = -2.0 * (mx - pc * mmat.sum(dim=2)[..., None])
            d.update(translation=pos + delta,
                     num_contacts=torch.zeros_like(d["num_contacts"]))
            ctx.data = d

        builder.add_node(solver, deps=[n_narrow], name="solver")


def make_executor(cfg: SimpleJobsConfig = SimpleJobsConfig(), device: str = "cuda"):
    """The simple_jobs executor on ``device`` (the card unless the caller
    asks for the CPU; raises if there is no card)."""
    return TaskGraphExecutor(
        SimpleJobsWorld.with_config(cfg),
        ExecutorConfig(num_worlds=cfg.num_worlds, max_entities_per_world=8,
                       seed=cfg.seed, device=device),
    )
