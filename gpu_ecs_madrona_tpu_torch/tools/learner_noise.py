#!/usr/bin/env python3
"""Where the PPO learner's results part between devices, and where a train
step spends the card's time.

    python3 gpu_ecs_madrona_tpu_torch/tools/learner_noise.py [MODE ...]

Run from the root of a checkout.  Modes (all by default where a card is
present, else "emulate"), each printing one JSON line:

  card      the learner case of tests/test_torch_rl_cases.py (chip_smoke's
            parity_learner) on the card and on the CPU from the same
            parameters and draws: the rollouts' largest differences by
            field; the first minibatch's loss and gradients on both
            devices from the CPU's trajectory (largest difference, the
            leaf's largest entry, entries that differ); the share of
            2^20 normal inputs (times 2) whose torch.tanh and torch.exp
            differ between the devices
  emulate   on the CPU: the case's train step with every torch.tanh
            output moved one ulp up or down at random in 22% of its
            elements (6 seeds), against the step without: the
            differences of tests/test_torch_rl_cases.learner_differences,
            the loss's relative one
  profile   chip_smoke's main_ppo_fantasy_vs (16384 worlds x (50 + 200),
            2 epochs x 2 minibatches, normalised observations), after 2
            untimed train steps: torch.profiler over the rollout and over
            the update of one more, each part's wall ms, device busy ms
            and top 15 kernels (name, us, launches)
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_rl_cases as cases  # noqa: E402
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs  # noqa: E402
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def diff(a, b):
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def card_mode():
    with cases.golden_constants(fvs):
        runs = {}
        for dev in ("cpu", "cuda"):
            sim, learner = cases.rl_learner(dev)
            eps, perms = cases.rl_draws(learner.cfg, cases.RL_WORLDS)
            _, traj, last = learner.rollout(sim.state, learner.params, learner.norm,
                                            eps.to(dev))
            runs[dev] = (learner, traj, last, perms)
    names = ("obs", "obs_n", "act", "logp", "value", "reward", "done")
    rollout = {n: diff(runs["cpu"][1][i], runs["cuda"][1][i]) for i, n in enumerate(names)}
    learner, traj, last, perms = runs["cpu"]
    cfg = learner.cfg
    adv, ret = pl.gae(traj[5], traj[4], traj[6], last, cfg.gamma, cfg.gae_lambda)
    n = traj[0].shape[0] * traj[0].shape[1]
    batch = (traj[1], traj[2], traj[3], adv, ret)
    xs = tuple(x.reshape((n,) + tuple(x.shape[2:]))[perms[0]][:n // cfg.num_minibatches]
               for x in batch)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaf = {k: p.detach().clone().requires_grad_() for k, p in runs[dev][0].params.items()}
        loss = pl.ppo_loss(leaf, cfg, *(x.to(dev) for x in xs))
        grads[dev] = (float(loss.detach()),
                      dict(zip(leaf, torch.autograd.grad(loss, list(leaf.values())))))
    g = {k: {"max_abs_diff": diff(grads["cpu"][1][k], grads["cuda"][1][k]),
             "largest": float(grads["cpu"][1][k].abs().max()),
             "differing": int((grads["cpu"][1][k] != grads["cuda"][1][k].cpu()).sum()),
             "entries": grads["cpu"][1][k].numel()} for k in pl.PARAM_NAMES}
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0)) * 2
    ops = {f.__name__: float((f(x) != f(x.cuda()).cpu()).double().mean())
           for f in (torch.tanh, torch.exp)}
    emit({"mode": "card", "rollout_max_abs_diff": rollout,
          "minibatch0_loss": {"cpu": grads["cpu"][0], "card": grads["cuda"][0]},
          "minibatch0_grads": g, "share_differing": ops, "card": card_line()})


def emulate_mode(seeds=6, share=0.22):
    base = cases.rl_train_step("cpu")
    tanh = torch.tanh
    rows = []
    for seed in range(seeds):
        gen = torch.Generator().manual_seed(seed)

        def noisy(x, *args, **kwargs):
            y = tanh(x, *args, **kwargs)
            r = torch.rand(y.shape, generator=gen)
            up = torch.nextafter(y, torch.full_like(y, 2.0))
            down = torch.nextafter(y, torch.full_like(y, -2.0))
            return torch.where(r < share / 2, up, torch.where(r < share, down, y))

        torch.tanh = noisy
        try:
            other = cases.rl_train_step("cpu")
        finally:
            torch.tanh = tanh
        rows.append(cases.rl_card_vs_cpu(other, base))
    emit({"mode": "emulate", "tanh_ulp_share": share, "by_seed": rows,
          "largest": {k: max(r[k] for r in rows) for k in rows[0]},
          "tolerance": cases.LEARNER_TOL})


def profile_mode():
    from torch.profiler import ProfilerActivity, profile
    W = 16384
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(
        fvs.FantasyVsConfig(num_worlds=W, num_dragons=50, num_knights=200, cleanup=True),
        device="cuda")
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, epochs=2,
                                         num_minibatches=2, normalize_obs=True),
                            sim.graph.step, obs_fn, inject_fn, reward_fn, device="cuda")
    state = sim.state
    for _ in range(2):
        state, _, _ = learner.train_step(state)
    torch.cuda.synchronize()
    eps, perms = learner.draws(W)
    parts = {}

    def run(name, fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0]
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
        parts[name] = {"wall_ms": wall,
                       "device_busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
                       "top": [{"name": e.key[:90], "us": e.self_device_time_total,
                                "launches": e.count} for e in top]}
        return out

    state, traj, last = run("rollout", lambda: learner.rollout(state, learner.params,
                                                                 learner.norm, eps))
    run("update", lambda: learner.learn(traj, last, perms))
    emit({"mode": "profile", "worlds": W, **parts, "card": card_line()})


def main(argv):
    modes = argv or (["card", "emulate", "profile"] if torch.cuda.is_available()
                     else ["emulate"])
    for mode in modes:
        {"card": card_mode, "emulate": emulate_mode, "profile": profile_mode}[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
