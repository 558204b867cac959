"""Cases of the RL training path shared by the CPU tests, the card tests
and chip_smoke.py: numpy and the PyTorch port only (no JAX), so that they
also run on a machine with the card and no JAX.

- ``random_script``: fantasy_vs decision tables drawn with numpy (scripted
  replay takes every random decision from them, so both packages, or the
  card and the CPU, replay the same run); ``GOLDEN_CONSTANTS``: the
  damage constants of the reference binary's golden run, high enough for
  deaths and rewards within a few ticks.
- The learner case: a small scripted fantasy_vs RL world, a PPO config
  with every option on (2 epochs, 4 minibatches, observation
  normalisation, done every third tick), parameters and draws made with
  numpy, so that one train step can run from the same inputs anywhere.
- ``table_world``: a reset world whose init is deterministic (each world's
  start height from a table), built from either package.
- ``random_reset_world``: tests/test_reset.py's ResetWorld on the port
  (start heights from each world's generator stream).
"""

import contextlib

import numpy as np
import torch

import gpu_ecs_madrona_tpu_torch as P
from gpu_ecs_madrona_tpu_torch.core import base as pbase
from gpu_ecs_madrona_tpu_torch.core.state import uniform
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl

# the constants fvs_job_5d9k120t.bin was generated with (argv 5..8)
GOLDEN_CONSTANTS = {"ARROW_DAMAGE": 350.0, "CAST_DAMAGE": 60.0, "CAST_RADIUS": 8.0,
                    "CAST_COST": 5.0}


def random_script(seed, nd, nk, T):
    """Decision tables drawn with numpy: the same inputs for both sides."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(fvs.BOUNDS_LO, np.float32), np.array(fvs.BOUNDS_HI, np.float32)

    def pts(*shape):
        return (lo + (hi - lo) * rng.random(shape + (3,))).astype(np.float32)

    def act(n):
        tab = rng.random((T, n, 4)).astype(np.float32)
        tab[..., 1:] = 2.0 * tab[..., 1:] - 1.0
        return tab

    return {"d_pos": pts(nd), "d_mana": (50.0 * rng.random(nd)).astype(np.float32),
            "k_pos": pts(nk), "k_arrows": rng.integers(20, 41, nk).astype(np.int32),
            "d_act": act(nd), "k_act": act(nk), "cast_target": pts(T, nd),
            "archer_target": rng.integers(-1, nd, (T, nk)).astype(np.int32)}


@contextlib.contextmanager
def golden_constants(*modules):
    """GOLDEN_CONSTANTS set on ``modules`` (fantasy_vs modules read them
    when a node runs), restored on exit."""
    old = [(m, {k: getattr(m, k) for k in GOLDEN_CONSTANTS}) for m in modules]
    try:
        for m in modules:
            for k, v in GOLDEN_CONSTANTS.items():
                setattr(m, k, v)
        yield
    finally:
        for m, values in old:
            for k, v in values.items():
                setattr(m, k, v)


# ---------------------------------------------------------------------------
# the learner case
# ---------------------------------------------------------------------------

RL_WORLDS, RL_DRAGONS, RL_KNIGHTS, RL_SCRIPT_TICKS = 8, 3, 6, 16
RL_PPO = dict(hidden=32, rollout_len=4, epochs=2, num_minibatches=4, normalize_obs=True)


def rl_config(**kw):
    """The scripted RL world's fantasy_vs config (tests/test_learner.py's
    sizes, seed and cleanup)."""
    return dict(num_worlds=RL_WORLDS, num_dragons=RL_DRAGONS, num_knights=RL_KNIGHTS,
                seed=4, cleanup=False, scripted=True, replicate_clamp_bug=True, **kw)


def rl_script():
    return random_script(5, RL_DRAGONS, RL_KNIGHTS, RL_SCRIPT_TICKS)


def done_fn(state):
    return (state["tick"] % 3) == 0    # tests/test_learner.py:69-71


def rl_learner(device):
    """(executor, learner) of the scripted RL world on ``device``, the
    learner's parameters from ``rl_params``."""
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(
        fvs.FantasyVsConfig(**rl_config()), device=device, init_data=rl_script())
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **RL_PPO),
                            sim.graph.step, obs_fn, inject_fn, reward_fn, done_fn=done_fn,
                            device=device)
    learner.params = pl.params_from_numpy(rl_params(learner.cfg), device)
    return sim, learner


def rl_params(cfg, seed=21):
    """Parameters at the JAX package's scales, drawn with numpy (biases
    and log_std away from their initial constants)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    s1, s2 = 1.0 / np.sqrt(cfg.obs_dim), 1.0 / np.sqrt(cfg.hidden)
    return {"w1": normal(cfg.obs_dim, cfg.hidden, scale=s1), "b1": normal(cfg.hidden, scale=0.1),
            "w2": normal(cfg.hidden, cfg.hidden, scale=s2), "b2": normal(cfg.hidden, scale=0.1),
            "w_mu": normal(cfg.hidden, cfg.act_dim, scale=0.01 * s2),
            "b_mu": normal(cfg.act_dim, scale=0.1),
            "log_std": (-0.5 + normal(cfg.act_dim, scale=0.1)).astype(np.float32),
            "w_v": normal(cfg.hidden, 1, scale=s2), "b_v": normal(1, scale=0.1)}


def rl_draws(cfg, num_worlds, seed=22):
    """(eps [T, W, act_dim], perms [epochs, N] int64) drawn with numpy."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(cfg.rollout_len, num_worlds, cfg.act_dim)).astype(np.float32)
    n = cfg.rollout_len * num_worlds
    perms = np.stack([rng.permutation(n) for _ in range(cfg.epochs)])
    return torch.from_numpy(eps), torch.from_numpy(perms)


def learner_state(learner):
    """The learner's parameters, Adam state and observation statistics as
    numpy arrays (copies)."""
    def np_(d):
        return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}
    return {"params": np_(learner.params), "opt_m": np_(learner.opt_m),
            "opt_v": np_(learner.opt_v), "opt_t": int(learner.opt_t),
            "norm": np_(learner.norm)}


def learner_differences(a, b, start):
    """Largest differences between two ``learner_state``s (``b`` the
    reference) after a train step from parameters ``start``: parameters
    elementwise and the update as a whole (|a - b| / |b - start| over all
    leaves, L2), Adam moments relative to each leaf's largest entry, the
    step count and the observation statistics (absolute)."""
    def rel(x, y):
        return max(float(np.abs(x[k] - y[k]).max() / max(np.abs(y[k]).max(), 1e-30))
                   for k in y)

    pa, pb = a["params"], b["params"]
    num = sum(float(((pa[k] - pb[k]).astype(np.float64) ** 2).sum()) for k in pb)
    den = sum(float(((pb[k] - start[k]).astype(np.float64) ** 2).sum()) for k in pb)
    return {"params": max(float(np.abs(pa[k] - pb[k]).max()) for k in pb),
            "update_rel": (num / den) ** 0.5,
            "opt_m_rel": rel(a["opt_m"], b["opt_m"]), "opt_v_rel": rel(a["opt_v"], b["opt_v"]),
            "opt_t": abs(a["opt_t"] - b["opt_t"]),
            "norm_mean": float(np.abs(a["norm"]["mean"] - b["norm"]["mean"]).max()),
            "norm_var": float(np.abs(a["norm"]["var"] - b["norm"]["var"]).max()),
            "norm_count": float(abs(a["norm"]["count"] - b["norm"]["count"]))}


# A train step's tolerances, against JAX and between devices.  The float32
# sums of the trunk differ in order (XLA, the CPU's BLAS, cuBLAS; the card's
# tanh is another ulp off in ~1 element of 5), and 8-sample minibatches
# turn that into differences that Adam amplifies: its update is
# lr * m / (sqrt(v) + eps), so absolute noise on a gradient element that
# nearly cancels moves that element's update by a few percent of lr, and a
# clip or bf16 tie landing on the other side in one sample moves a
# minibatch's loss by ~4e-5 and its moments by ~5e-3 of their largest
# entry (measured under one-ulp tanh noise on the CPU, and on the card).
# So: parameters elementwise within lr / 4 (a step that flipped or dropped
# an element's update misses by 2 lr or lr) and the update as a whole
# within 5e-3 (a 1% error in its scale misses); moments within 2e-2 of the
# leaf's largest entry; the loss rtol 2e-4; the mean reward 1e-6 (its
# sum's order); the step count and the observation count exact, their
# mean and variance 1e-5.
LEARNER_TOL = {"loss_rel": 2e-4, "mean_reward": 1e-6, "params": 3e-4 / 4,
               "update_rel": 5e-3, "opt_m_rel": 2e-2, "opt_v_rel": 2e-2, "opt_t": 0,
               "norm_mean": 1e-5, "norm_var": 1e-5, "norm_count": 0.0}


def within(diff, tol):
    """The entries of ``diff`` over their tolerance."""
    return {k: (diff[k], tol[k]) for k in tol if k in diff and diff[k] > tol[k]}


def rl_train_step(device):
    """One train step of the learner case on ``device`` from the numpy
    parameters and draws: (loss, mean_reward, learner_state, the starting
    parameters)."""
    with golden_constants(fvs):
        sim, learner = rl_learner(device)
        start = rl_params(learner.cfg)
        eps, perms = rl_draws(learner.cfg, RL_WORLDS)
        _, loss, rew = learner.update(sim.state, eps.to(device), perms.to(device))
        return float(loss), float(rew), learner_state(learner), start


def rl_card_vs_cpu(card, cpu):
    """The differences between ``rl_train_step``'s results on two devices,
    with the loss's and the reward's."""
    diff = learner_differences(card[2], cpu[2], cpu[3])
    diff["loss_rel"] = abs(card[0] - cpu[0]) / abs(cpu[0])
    diff["mean_reward"] = abs(card[1] - cpu[1])
    return diff


# ---------------------------------------------------------------------------
# reset worlds
# ---------------------------------------------------------------------------

RESET_WORLDS = 8
Z0 = np.random.default_rng(11).uniform(5.0, 10.0, 1024).astype(np.float32)


def table_world(pkg, base, xp, name, z0=Z0, reset=True):
    """A faller a world, starting at z0[w] and falling 1.0 a step; with
    ``reset``, a world whose faller reaches the ground starts over.  Built
    from either package (``pkg``, its ``base`` and ``xp`` its array
    module)."""
    Faller = pkg.Archetype(name, [base.Position])

    class TableWorld:
        @staticmethod
        def register_types(registry):
            base.register_types(registry)
            registry.register_archetype(Faller, capacity=4)
            registry.export_column(Faller, base.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            n = ctx.num_worlds
            z = xp.asarray(z0[:n])
            if xp is torch:
                z = z.to(ctx.device)
            zeros = z * 0.0
            pos = xp.stack([zeros, zeros, z], axis=-1)
            ctx.make_entities(Faller, counts=1, max_new=1, values={base.Position: pos[:, None, :]})

        @staticmethod
        def setup_tasks(builder):
            step = ([0.0, 0.0, 1.0] if xp is not torch
                    else torch.tensor([0.0, 0.0, 1.0], device=builder.mgr.device))

            def fall(rowctx, pos):
                return pos - xp.asarray(step)

            n = builder.parallel_for_node(fall, [base.Position], archetypes=[Faller], name="fall")

            def hit_ground(ctx):
                return (ctx.column(Faller, base.Position)[:, 0, 2] <= 0.0) & \
                    ctx.row_mask(Faller)[:, 0]

            if reset:
                builder.reset_node(hit_ground, TableWorld.init, [n])

    return TableWorld


def random_reset_world(name):
    """tests/test_reset.py's ResetWorld on the port: z0 uniform in [5, 10)
    from each world's generator stream."""
    Faller = P.Archetype(name, [pbase.Position])

    class ResetWorld:
        @staticmethod
        def register_types(registry):
            pbase.register_types(registry)
            registry.register_archetype(Faller, capacity=4)
            registry.export_column(Faller, pbase.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            z0 = uniform(ctx.rng_one(), (), 5.0, 10.0)
            zeros = torch.zeros_like(z0)
            pos = torch.stack([zeros, zeros, z0], dim=-1)
            ctx.make_entities(Faller, counts=1, max_new=1, values={pbase.Position: pos[:, None, :]})

        @staticmethod
        def setup_tasks(builder):
            step = torch.tensor([0.0, 0.0, 1.0], device=builder.mgr.device)

            def fall(rowctx, pos):
                return pos - step

            n = builder.parallel_for_node(fall, [pbase.Position], archetypes=[Faller],
                                          name="fall")

            def hit_ground(ctx):
                return (ctx.column(Faller, pbase.Position)[:, 0, 2] <= 0.0) & \
                    ctx.row_mask(Faller)[:, 0]

            builder.reset_node(hit_ground, ResetWorld.init, [n])

    return ResetWorld


PORT_TABLE = table_world(P, pbase, torch, "ResetTableP")
PORT_RANDOM = random_reset_world("ResetRandomP")


def reset_run(world, device, steps, num_worlds=RESET_WORLDS, seed=7):
    """``steps`` steps of a reset world on ``device``: the positions [steps,
    W, 3], masks [steps, W] and ticks [steps, W] after each step, on the
    CPU."""
    sim = P.TaskGraphExecutor(world, P.ExecutorConfig(num_worlds=num_worlds, seed=seed,
                                                      device=device))
    pos, mask, tick = [], [], []
    for _ in range(steps):
        sim.step()
        v, m = sim.get_exported(0)
        pos.append(v[:, 0])
        mask.append(m[:, 0])
        tick.append(sim.state["tick"])
    return tuple(torch.stack(x).cpu() for x in (pos, mask, tick))
