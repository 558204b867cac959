"""fantasy_vs example (PyTorch) — reference examples/fantasy_vs/.

Counterpart of ``gpu_ecs_madrona_tpu/models/fantasy_vs.py``: the same
components, archetypes, constants, config, node names and node order.
The reference runs it on the legacy job system (fvs.cpp): per tick an
action-select parallelFor, then the caster and archer systems, then a
cleanup job that destroys dead entities through a CleanupTracker
archetype (fvs.cpp:203-227).  The caster's nested AoE parallelFor
(fvs.cpp:171-183) becomes a dense [worlds, casters, targets] reduction.

Per tick (reference fvs.cpp):
  - action_select (fvs.cpp:108-146): busy agents count remainingTime down
    by deltaT; an idle agent moves with probability 0.5 to pos + U[-1,1]^3
    clamped to the bounds, remainingTime = |moved| / moveSpeed.  The
    reference clamps z against the new x (fvs.cpp:139); that is replicated
    only with ``replicate_clamp_bug`` (and in scripted mode).
  - caster (fvs.cpp:148-186), dragons: mana += regen * dt; an idle dragon
    with mana >= CAST_COST pays it, picks a uniform target point and
    damages every entity of either archetype within CAST_RADIUS by
    CAST_DAMAGE; remainingTime = castTime.
  - archer (fvs.cpp:188-210), knights: an idle knight with arrows shoots a
    uniformly random *live* dragon (picked by rank among the live rows)
    for ARROW_DAMAGE; arrows -= 1; remainingTime = shootTime.
  - cleanup (fvs.cpp:212-227, gameLoop mode): entities with hp <= 0 are
    listed in CleanupTracker, destroyed, and the tracker is cleared.
    ``cleanup=False`` is the reference's benchmarkTick (fvs.cpp:262-271).

The module-level constants are read when a node runs, so a caller may
change them before stepping (the reference-golden test does).

The random draws come from the port's own per-world generator and differ
from the JAX package's; parity with it and with the reference binary runs
through ``scripted=True``, which replays every decision from tables.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.core.component import Archetype, component
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import randint, uniform
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.models.collisions import _strict_fp32

f32, i32 = torch.float32, torch.int32

# Components (reference fvs.hpp:17-43)
Position = component("FvsPosition", ((3,), f32))
Health = component("Health", hp=((), f32))
Mana = component("Mana", mp=((), f32))
Quiver = component("Quiver", arrows=((), i32))
Action = component("Action", remaining=((), f32))
CleanupEntity = component("CleanupEntity", ((), i32))

# Archetypes (reference fvs.hpp:45-48)
Dragon = Archetype("Dragon", [Position, Health, Action, Mana])
Knight = Archetype("Knight", [Position, Health, Action, Quiver])
CleanupTracker = Archetype("CleanupTracker", [CleanupEntity])

DELTA_T = 1.0 / 60.0
MOVE_SPEED = 0.1
MANA_REGEN = 1.0
CAST_TIME = 2.0
SHOOT_TIME = 0.5
CAST_COST = 20.0
CAST_RADIUS = 2.0
CAST_DAMAGE = 20.0
ARROW_DAMAGE = 15.0
BOUNDS_LO = (-10.0, -10.0, 0.0)
BOUNDS_HI = (10.0, 10.0, 10.0)


@dataclasses.dataclass
class FantasyVsConfig:
    num_worlds: int = 1024
    num_dragons: int = 50   # reference main.cpp:85-88 benchmark config
    num_knights: int = 200
    seed: int = 0
    cleanup: bool = True    # gameLoop mode; False = reference benchmarkTick
    # replicate the reference's z-clamped-by-x bug (fvs.cpp:139)
    replicate_clamp_bug: bool = False
    # Scripted replay (the parity harness): every random decision comes
    # from tables passed as init_data.  Keys: d_pos [nd, 3], d_mana [nd],
    # k_pos [nk, 3], k_arrows [nk], d_act / k_act [T, n, 4] (move draw,
    # dx, dy, dz), cast_target [T, nd, 3], archer_target [T, nk] int32
    # dragon row (-1 = no shot).  Ticks past T reuse the last row (the
    # index is clamped, not checked).  Scripted mode always uses the
    # subtract-form AoE distance and the reference clamp bug.
    scripted: bool = False


def _bounds(device):
    return (torch.tensor(BOUNDS_LO, device=device), torch.tensor(BOUNDS_HI, device=device))


def _clamp_bugged(new_pos, lo, hi):
    """The reference's clamp (fvs.cpp:139): z is clamped from the new x."""
    return torch.stack([torch.clamp(new_pos[..., 0], lo[0], hi[0]),
                        torch.clamp(new_pos[..., 1], lo[1], hi[1]),
                        torch.clamp(new_pos[..., 0], lo[2], hi[2])], dim=-1)


def _script_row(ctx: Context, key: str):
    """This tick's row of a script table [W, T, ...] -> [W, ...]; the tick
    is clamped to T - 1, as in the JAX package (so a run past the table
    replays its last row instead of failing)."""
    tab = ctx.data["fvs_script"][key]
    t = ctx.tick.clamp(max=tab.shape[1] - 1).long()
    return tab[torch.arange(tab.shape[0], device=tab.device), t]


class FantasyVsWorld:
    config: FantasyVsConfig = FantasyVsConfig()

    @classmethod
    def with_config(cls, cfg: FantasyVsConfig):
        return type("FantasyVsWorld", (cls,), {"config": cfg})

    @classmethod
    def register_types(cls, registry: ECSRegistry):
        cfg = cls.config
        registry.register_archetype(Dragon, capacity=cfg.num_dragons)
        registry.register_archetype(Knight, capacity=cfg.num_knights)
        registry.register_archetype(CleanupTracker,
                                    capacity=cfg.num_dragons + cfg.num_knights,
                                    temporary=True)
        registry.export_column(Dragon, Position, 0)
        registry.export_column(Dragon, Health, 1)
        registry.export_column(Knight, Position, 2)
        registry.export_column(Knight, Health, 3)

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        cfg = cls.config
        W, dev = ctx.num_worlds, ctx.device
        nd, nk = cfg.num_dragons, cfg.num_knights
        lo, hi = _bounds(dev)
        ctx.data = {"_": torch.zeros((W, 1), device=dev)}
        if cfg.scripted:
            def bc(x, dtype=f32):
                t = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                return t[None].expand((W,) + tuple(t.shape))

            d_pos, d_mana = bc(init_data["d_pos"]), bc(init_data["d_mana"])
            k_pos, k_arrows = bc(init_data["k_pos"]), bc(init_data["k_arrows"], i32)
            ctx.data = {"_": ctx.data["_"], "fvs_script": {
                "d_act": bc(init_data["d_act"]),
                "k_act": bc(init_data["k_act"]),
                "cast_target": bc(init_data["cast_target"]),
                "archer_target": bc(init_data["archer_target"], i32),
            }}
        else:
            kd_pos, kd_mana = ctx.rng_one(), ctx.rng_one()
            kk_pos, kk_arrows = ctx.rng_one(), ctx.rng_one()
            d_pos = uniform(kd_pos, (nd, 3), lo, hi)
            d_mana = uniform(kd_mana, (nd,), 0.0, 50.0)
            k_pos = uniform(kk_pos, (nk, 3), lo, hi)
            k_arrows = randint(kk_arrows, (nk,), 20, 41)
        ctx.make_entities(Dragon, counts=nd, max_new=nd, values={
            Position: d_pos,
            Health: {"hp": torch.full((W, nd), 1000.0, device=dev)},
            Action: {"remaining": torch.zeros((W, nd), device=dev)},
            Mana: {"mp": d_mana},
        })
        ctx.make_entities(Knight, counts=nk, max_new=nk, values={
            Position: k_pos,
            Health: {"hp": torch.full((W, nk), 100.0, device=dev)},
            Action: {"remaining": torch.zeros((W, nk), device=dev)},
            Quiver: {"arrows": k_arrows},
        })

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        cfg = cls.config
        lo, hi = _bounds(builder.mgr.device)
        gram = not cfg.scripted and os.environ.get("GEM_TPU_FVS_GRAM") == "1"
        move_lo = torch.tensor([0.0, -1.0, -1.0, -1.0], device=builder.mgr.device)
        move_hi = torch.tensor([1.0, 1.0, 1.0, 1.0], device=builder.mgr.device)

        def move(pos, rem, draw, live):
            """One action-select update from draws [..., 4] (move draw,
            dx, dy, dz): (new pos, new remainingTime)."""
            busy = rem > 0.0
            do_move = live & ~busy & (draw[..., 0] <= 0.5)
            new_pos = pos + draw[..., 1:4]
            if cfg.scripted or cfg.replicate_clamp_bug:
                clamped = _clamp_bugged(new_pos, lo, hi)
            else:
                clamped = torch.clamp(new_pos, lo, hi)
            moved = clamped - pos
            move_time = torch.sqrt((moved * moved).sum(dim=-1)) / MOVE_SPEED
            out_pos = torch.where(do_move[..., None], clamped, pos)
            out_rem = torch.where(busy, rem - DELTA_T, torch.where(do_move, move_time, rem))
            return out_pos, out_rem

        if cfg.scripted:
            def action_select_scripted(ctx: Context):
                for arch, key in ((Dragon, "d_act"), (Knight, "k_act")):
                    act = ctx.column(arch, Action)["remaining"]
                    mask = ctx.row_mask(arch)
                    pos, rem = move(ctx.column(arch, Position), act,
                                    _script_row(ctx, key), mask)
                    ctx.set_column(arch, Position, pos)
                    ctx.set_column(arch, Action, {"remaining": torch.where(mask, rem, act)})

            n_action = builder.add_node(action_select_scripted, name="action_select")
        else:
            def action_select(rowctx, pos, action):
                # reference fvs.cpp:108-146
                draw = uniform(rowctx.key, (4,), move_lo, move_hi)
                out_pos, out_rem = move(pos, action["remaining"], draw, rowctx.live)
                return out_pos, {"remaining": out_rem}

            n_action = builder.parallel_for_node(
                action_select, [Position, Action], name="action_select", needs_rng=True)

        def caster(ctx: Context):
            # reference fvs.cpp:148-186: dragons blast random target points
            d_mask = ctx.row_mask(Dragon)
            d_act = ctx.column(Dragon, Action)["remaining"]
            d_mana = ctx.column(Dragon, Mana)["mp"]
            nd = d_mask.shape[1]
            mana = torch.where(d_mask, d_mana + MANA_REGEN * DELTA_T, d_mana)
            can_cast = d_mask & (d_act <= 0.0) & (mana >= CAST_COST)
            if cfg.scripted:
                targets = _script_row(ctx, "cast_target")          # [W, nd, 3]
            else:
                targets = uniform(ctx.rng_one(), (nd, 3), lo, hi)
            # AoE damage to every Position+Health entity of both archetypes
            for arch in (Dragon, Knight):
                pos = ctx.column(arch, Position)                     # [W, ne, 3]
                hp = ctx.column(arch, Health)["hp"]
                if gram:
                    # centred Gram form |t-c|^2 + |p-c|^2 - 2 (t-c).(p-c),
                    # in full fp32 (TF32 would move hits across the radius)
                    cen = 0.5 * (lo + hi)
                    tc, pc = targets - cen, pos - cen
                    with _strict_fp32():
                        tp = torch.bmm(tc, pc.transpose(1, 2))       # [W, nd, ne]
                    d2 = ((tc * tc).sum(-1)[:, :, None] + (pc * pc).sum(-1)[:, None, :]
                          - 2.0 * tp)
                else:
                    d2 = None
                    for c in range(3):
                        dc = targets[:, :, None, c] - pos[:, None, :, c]
                        d2 = dc * dc if d2 is None else d2 + dc * dc
                hit = (can_cast[:, :, None] & ctx.row_mask(arch)[:, None, :]
                       & (d2 <= CAST_RADIUS * CAST_RADIUS))
                dmg = CAST_DAMAGE * hit.sum(dim=1).to(f32)
                ctx.set_column(arch, Health, {"hp": hp - dmg})
            ctx.set_column(Dragon, Mana, {"mp": torch.where(can_cast, mana - CAST_COST, mana)})
            ctx.set_column(Dragon, Action,
                           {"remaining": torch.where(can_cast, CAST_TIME, d_act)})

        n_cast = builder.add_node(caster, deps=[n_action], name="caster")

        def archer(ctx: Context):
            # reference fvs.cpp:188-210: knights shoot a random live dragon
            k_mask = ctx.row_mask(Knight)
            k_act = ctx.column(Knight, Action)["remaining"]
            arrows = ctx.column(Knight, Quiver)["arrows"]
            d_mask = ctx.row_mask(Dragon)
            nk, nd = k_mask.shape[1], d_mask.shape[1]
            n_dragons = d_mask.sum(dim=1, dtype=i32)
            shoot = k_mask & (k_act <= 0.0) & (arrows > 0) & (n_dragons[:, None] > 0)
            if cfg.scripted:
                # the dragon ROW the binary shot (it picks by row in its
                # swap-removed table, which the rank pick does not reproduce)
                row = _script_row(ctx, "archer_target").long()      # [W, nk]
                in_range = (row >= 0) & (row < nd)
                row = row.clamp(0, nd - 1)
                hits = shoot & in_range & torch.gather(d_mask, 1, row)
            else:
                # the sel-th live dragon (by rank) is the first row whose
                # inclusive live count reaches sel + 1
                sel = randint(ctx.rng_one(), (nk,), 0, 1 << 24) % n_dragons.clamp(min=1)[:, None]
                live_count = torch.cumsum(d_mask, dim=1, dtype=i32)
                row = torch.searchsorted(live_count, (sel + 1).to(i32)).clamp(max=nd - 1)
                hits = shoot
            # each hit adds ARROW_DAMAGE; the sums are small integers times
            # it, exact in any order
            dmg = torch.zeros(d_mask.shape, dtype=f32, device=d_mask.device)
            dmg.scatter_add_(1, row, torch.where(hits, ARROW_DAMAGE, 0.0))
            ctx.set_column(Dragon, Health, {"hp": ctx.column(Dragon, Health)["hp"] - dmg})
            ctx.set_column(Knight, Quiver, {"arrows": torch.where(shoot, arrows - 1, arrows)})
            ctx.set_column(Knight, Action, {"remaining": torch.where(shoot, SHOOT_TIME, k_act)})

        n_arch = builder.add_node(archer, deps=[n_action], name="archer")

        if cfg.cleanup:
            def cleanup(ctx: Context):
                # reference fvs.cpp:212-227: track the dead, destroy, clear
                dead = {arch: ctx.row_mask(arch) & (ctx.column(arch, Health)["hp"] <= 0.0)
                        for arch in (Dragon, Knight)}
                ents = {arch: ctx.entity_column(arch) for arch in dead}

                def counts():
                    return sum(d.sum(dim=1, dtype=i32) for d in dead.values())

                def values():
                    return {CleanupEntity: torch.cat(
                        [torch.where(dead[a], ents[a], -1) for a in dead], dim=1)}

                # the tracker is read by nothing before its clear, so its
                # rows are emitted lazily; its width is its capacity, so no
                # count can overflow and the counter is left as it is
                ctx.emit_temporaries(CleanupTracker, counts=counts, values=values,
                                     count_overflow=False)
                ctx.destroy_rows(Dragon, dead[Dragon])
                ctx.destroy_rows(Knight, dead[Knight])
                ctx.clear_archetype(CleanupTracker)

            builder.add_node(cleanup, deps=[n_cast, n_arch], name="cleanup")


class FantasyVsRLWorld(FantasyVsWorld):
    """RL variant: knight movement comes from an injected action buffer
    (``user["knight_move"]`` [W, nk, 3]) before the usual tick — the
    BASELINE config-5 workload (a learner drives the knights)."""

    @classmethod
    def init(cls, ctx: Context, init_data=None):
        super().init(ctx, init_data)
        user = dict(ctx.data)
        user["knight_move"] = torch.zeros((ctx.num_worlds, cls.config.num_knights, 3),
                                          device=ctx.device)
        ctx.data = user

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        lo, hi = _bounds(builder.mgr.device)

        def apply_knight_actions(ctx: Context):
            pos = ctx.column(Knight, Position)
            new_pos = torch.clamp(pos + torch.tanh(ctx.data["knight_move"]), lo, hi)
            ctx.set_column(Knight, Position,
                           torch.where(ctx.row_mask(Knight)[..., None], new_pos, pos))

        builder.add_node(apply_knight_actions, name="apply_knight_actions")
        super().setup_tasks(builder)


def _executor(world, cfg: FantasyVsConfig, init_data, device):
    return TaskGraphExecutor(
        world.with_config(cfg),
        ExecutorConfig(num_worlds=cfg.num_worlds,
                       max_entities_per_world=cfg.num_dragons + cfg.num_knights + 8,
                       seed=cfg.seed, device=device),
        init_data=init_data)


def make_rl_env(cfg: FantasyVsConfig = FantasyVsConfig(), device: str = "cuda"):
    """(executor, obs_fn, inject_fn, reward_fn, obs_dim, act_dim) for a
    learner: obs [W, 5 nd + 5 nk], actions [W, 3 nk], reward = the damage
    dealt to dragons this step / 100."""
    sim = _executor(FantasyVsRLWorld, cfg, None, device)
    mgr = sim.mgr
    nd, nk = cfg.num_dragons, cfg.num_knights

    def obs_fn(state):
        parts = []
        for arch, hp_scale in ((Dragon, 1000.0), (Knight, 100.0)):
            pos = mgr.column(state, arch, Position)
            hp = mgr.column(state, arch, Health)["hp"][..., None] / hp_scale
            live = mgr.row_mask(state, arch)[..., None].to(f32)
            feats = torch.cat([pos / 10.0, hp, live], dim=-1) * live
            parts.append(feats.reshape(feats.shape[0], -1))
        return torch.cat(parts, dim=-1)

    def inject_fn(state, actions):
        user = dict(state["user"])
        user["knight_move"] = actions.reshape(actions.shape[0], nk, 3)
        new_state = dict(state)
        new_state["user"] = user
        return new_state

    def reward_fn(prev_state, state):
        """Damage dealt to dragons this step (dead dragons' hp leaves the
        total too)."""
        def total(s):
            hp = mgr.column(s, Dragon, Health)["hp"]
            return torch.where(mgr.row_mask(s, Dragon), hp, 0.0).sum(dim=1)
        return (total(prev_state) - total(state)) / 100.0

    return sim, obs_fn, inject_fn, reward_fn, nd * 5 + nk * 5, nk * 3


def make_executor(cfg: FantasyVsConfig = FantasyVsConfig(), init_data=None,
                  device: str = "cuda"):
    """The fantasy_vs executor on ``device`` (the card unless the caller
    asks for the CPU; raises if there is no card).  ``init_data`` holds the
    script tables when ``cfg.scripted``."""
    return _executor(FantasyVsWorld, cfg, init_data, device)
