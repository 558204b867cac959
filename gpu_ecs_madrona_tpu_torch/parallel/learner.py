"""PPO learner colocated with the simulator (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/parallel/learner.py``.  The reference
has no learner: it exports ECS columns to PyTorch and leaves training to
the user (SURVEY.md §2.8).  Here the act -> step -> observe -> learn loop
runs on the simulator's device: rollouts never leave it, and a train step
makes no host sync.

Env adapter protocol (duck-typed, as in the JAX package):
  obs_fn(state)                -> obs [W, obs_dim]
  inject_fn(state, actions)    -> state with actions written (pure)
  reward_fn(prev_state, state) -> reward [W]
  step_fn(state)               -> state (the taskgraph step)
  done_fn(state)               -> done [W] bool (optional; pairs with
                                  TaskGraphBuilder.reset_node)

Training: GAE with episode-boundary masking, running observation
normalisation (a parallel-Welford merge after each rollout, the stats
frozen during it), minibatched multi-epoch clipped updates with a fresh
permutation each epoch, Adam.  The policy is an ``nn.Module`` with the JAX
package's parameter names; the functions below take its parameters as a
dict of tensors and gradients come from autograd.

Numerics follow the JAX package: the trunk's two products multiply the
bfloat16-rounded operands exactly and accumulate in float32 (JAX's
``dot_general`` with ``preferred_element_type=float32``), computed here as
a float32 product of bf16-rounded values, so the gradients of ``w1``,
``w2`` and of the first layer's output are rounded to bf16 where JAX's
are; the heads are float32 products (TF32 must stay off, PyTorch's
default); statistics use ddof 0; Adam's bias correction is a float32 power.

The random draws (the actions' noise and the minibatch permutations) come
from the learner's own ``torch.Generator`` on its device; ``update`` takes
them as tensors, so a caller can pass any draws (the tests pass JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from gpu_ecs_madrona_tpu_torch.core.executor import resolve_device

Params = Dict[str, torch.Tensor]

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w_mu", "b_mu", "log_std", "w_v", "b_v")

# the JAX package's float32 constants: 0.5 * log(2 pi) and 0.5 * log(2 pi e)
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2 * math.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2 * math.pi * math.e)))
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class PPOConfig:
    obs_dim: int = 0
    act_dim: int = 0
    hidden: int = 128
    rollout_len: int = 16
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    epochs: int = 1
    num_minibatches: int = 1
    normalize_obs: bool = False
    obs_clip: float = 10.0


def init_params(cfg: PPOConfig, generator: torch.Generator) -> Params:
    """The JAX package's initial scales, drawn from ``generator`` (on its
    device): normal weights over sqrt(fan-in), the policy head 0.01 of
    that, zero biases, log_std -0.5."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    s1 = 1.0 / math.sqrt(cfg.obs_dim)
    s2 = 1.0 / math.sqrt(cfg.hidden)
    return {
        "w1": normal(cfg.obs_dim, cfg.hidden) * s1,
        "b1": torch.zeros(cfg.hidden, device=dev),
        "w2": normal(cfg.hidden, cfg.hidden) * s2,
        "b2": torch.zeros(cfg.hidden, device=dev),
        "w_mu": normal(cfg.hidden, cfg.act_dim) * s2 * 0.01,
        "b_mu": torch.zeros(cfg.act_dim, device=dev),
        "log_std": torch.zeros(cfg.act_dim, device=dev) - 0.5,
        "w_v": normal(cfg.hidden, 1) * s2,
        "b_v": torch.zeros(1, device=dev),
    }


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, order="C")).to(device)


def params_from_numpy(jax_params: Dict[str, np.ndarray], device) -> Params:
    """The JAX package's parameters (as numpy arrays) on ``device``."""
    return _from_numpy({k: jax_params[k] for k in PARAM_NAMES}, device)


def opt_state_from_numpy(opt_m: Dict[str, np.ndarray], opt_v: Dict[str, np.ndarray],
                         opt_t, device):
    """The JAX package's Adam state -> (opt_m, opt_v, opt_t int32 0-d)."""
    return (params_from_numpy(opt_m, device), params_from_numpy(opt_v, device),
            torch.tensor(np.asarray(opt_t), dtype=torch.int32, device=device))


def norm_from_numpy(norm: Dict[str, np.ndarray], device) -> Params:
    """The JAX package's observation statistics (mean, var, count)."""
    return _from_numpy({k: np.asarray(norm[k], np.float32) for k in ("mean", "var", "count")},
                       device)


class Policy(nn.Module):
    """The MLP policy: obs -> tanh(w1) -> tanh(w2) -> (mu, log_std, value)."""

    def __init__(self, params: Params):
        super().__init__()
        for k in PARAM_NAMES:
            setattr(self, k, nn.Parameter(params[k].clone()))

    def params(self) -> Params:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def forward(self, obs):
        return policy_apply(self.params(), obs)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def policy_apply(params: Params, obs: torch.Tensor):
    """MLP trunk -> (mu, log_std, value): the trunk's products on
    bf16-rounded operands with float32 accumulation, the heads float32."""
    h = torch.tanh(_bf16(obs) @ _bf16(params["w1"]) + params["b1"])
    h = torch.tanh(_bf16(h) @ _bf16(params["w2"]) + params["b2"])
    mu = h @ params["w_mu"] + params["b_mu"]
    value = (h @ params["w_v"] + params["b_v"])[..., 0]
    return mu, params["log_std"], value


def log_prob(act, mu, log_std):
    std = torch.exp(log_std)
    return torch.sum(-0.5 * ((act - mu) / std) ** 2 - log_std - _HALF_LOG_2PI, dim=-1)


def sample_action(params: Params, obs: torch.Tensor, eps: torch.Tensor):
    """(act, logp, value) with act = mu + std * eps (eps: [W, act_dim])."""
    mu, log_std, value = policy_apply(params, obs)
    act = mu + torch.exp(log_std) * eps
    return act, log_prob(act, mu, log_std), value


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """rewards/values/dones [T, W] -> (advantages, returns) [T, W]; a done
    step does not bootstrap from the next one (auto-reset worlds)."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv_next = delta + gamma * lam * adv_next * nonterm
        v_next = values[t]
        advs[t] = adv_next
    advs = torch.stack(advs)
    return advs, advs + values


def normalize_obs(obs, norm: Params, clip: float):
    return torch.clamp((obs - norm["mean"]) / torch.sqrt(norm["var"] + 1e-8), -clip, clip)


def update_norm(norm: Params, batch_obs: torch.Tensor) -> Params:
    """Parallel-Welford merge of a [N, obs_dim] batch into running stats."""
    n_b = float(batch_obs.shape[0])
    mean_b = batch_obs.mean(dim=0)
    var_b = batch_obs.var(dim=0, correction=0)
    delta = mean_b - norm["mean"]
    tot = norm["count"] + n_b
    new_mean = norm["mean"] + delta * n_b / tot
    m2 = norm["var"] * norm["count"] + var_b * n_b + delta ** 2 * norm["count"] * n_b / tot
    return {"mean": new_mean, "var": m2 / tot, "count": tot}


def ppo_loss(params: Params, cfg: PPOConfig, obs, act, old_logp, adv, ret):
    """The clipped PPO objective (advantages normalised over the
    minibatch), the value loss and the entropy bonus."""
    mu, log_std, value = policy_apply(params, obs)
    ratio = torch.exp(log_prob(act, mu, log_std) - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n,
    ).mean()
    v_loss = torch.mean((value - ret) ** 2)
    entropy = torch.sum(log_std + _HALF_LOG_2PIE)
    return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy


def adam_step(params: Params, opt_m: Params, opt_v: Params, opt_t: torch.Tensor,
              grads: Params, lr: float):
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8; the bias correction a
    float32 power of the int32 step count) -> (params, opt_m, opt_v, opt_t)."""
    opt_t = opt_t + 1
    m = {k: _B1 * opt_m[k] + (1 - _B1) * g for k, g in grads.items()}
    v = {k: _B2 * opt_v[k] + (1 - _B2) * g * g for k, g in grads.items()}
    tf = opt_t.to(torch.float32)
    c1 = 1 - _B1 ** tf
    c2 = 1 - _B2 ** tf
    new = {k: p - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + _ADAM_EPS)
           for k, p in params.items()}
    return new, m, v, opt_t


class PPOLearner:
    """Collects rollouts on the device and applies PPO updates.

    ``train_step(state) -> (state, loss, mean_reward)``, the last two 0-d
    tensors on the device; nothing in it waits for the device.
    """

    def __init__(self, cfg: PPOConfig, step_fn: Callable, obs_fn: Callable,
                 inject_fn: Callable, reward_fn: Callable,
                 done_fn: Optional[Callable] = None, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.step_fn, self.obs_fn = step_fn, obs_fn
        self.inject_fn, self.reward_fn, self.done_fn = inject_fn, reward_fn, done_fn
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.policy = Policy(init_params(cfg, self.generator))
        self.opt_m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.opt_v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.opt_t = torch.zeros((), dtype=torch.int32, device=self.device)
        self.norm = {
            "mean": torch.zeros(cfg.obs_dim, device=self.device),
            "var": torch.ones(cfg.obs_dim, device=self.device),
            "count": torch.tensor(1e-4, dtype=torch.float32, device=self.device),
        }

    @property
    def params(self) -> Params:
        """The policy's parameters, detached (the module's own storage)."""
        return {k: p.detach() for k, p in self.policy.params().items()}

    @params.setter
    def params(self, values: Params):
        with torch.no_grad():
            for k, p in self.policy.params().items():
                p.copy_(values[k])

    # -- the random draws ---------------------------------------------------

    def draws(self, num_worlds: int):
        """(eps [T, W, act_dim], perms [epochs, N] int64 or None) from the
        learner's generator; N = T * W.  Permutations are drawn only with
        more than one minibatch, as in the JAX package."""
        cfg = self.cfg
        g, dev = self.generator, self.device
        eps = torch.randn((cfg.rollout_len, num_worlds, cfg.act_dim), generator=g, device=dev)
        if max(1, cfg.num_minibatches) == 1:
            return eps, None
        n = cfg.rollout_len * num_worlds
        # a stable argsort of float64 draws: a permutation with no host sync
        keys = torch.rand((max(1, cfg.epochs), n), generator=g, device=dev,
                          dtype=torch.float64)
        return eps, torch.sort(keys, dim=1, stable=True).indices

    # -- one train step -----------------------------------------------------

    def rollout(self, state, params: Params, norm: Params, eps: torch.Tensor):
        """``rollout_len`` steps under the policy -> (state, trajectory of
        [T, W, ...] tensors (obs, obs_n, act, logp, value, reward, done),
        the value of the final observation).  Without normalisation obs_n
        is obs (one tensor)."""
        cfg = self.cfg
        T = cfg.rollout_len
        traj = None
        with torch.no_grad():
            for t in range(T):
                obs = self.obs_fn(state)
                obs_n = normalize_obs(obs, norm, cfg.obs_clip) if cfg.normalize_obs else obs
                act, logp, value = sample_action(params, obs_n, eps[t])
                nxt = self.step_fn(self.inject_fn(state, act))
                rew = self.reward_fn(state, nxt)
                done = (self.done_fn(nxt).to(torch.float32) if self.done_fn is not None
                        else torch.zeros_like(rew))
                row = (obs, obs_n, act, logp, value, rew, done)
                if traj is None:   # [T, W, ...] buffers, filled step by step
                    traj = [torch.empty((T,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                            for x in row]
                    if not cfg.normalize_obs:
                        traj[1] = traj[0]
                for i, x in enumerate(row):
                    if i != 1 or cfg.normalize_obs:
                        traj[i][t] = x
                state = nxt
            final = self.obs_fn(state)
            if cfg.normalize_obs:
                final = normalize_obs(final, norm, cfg.obs_clip)
            last_value = policy_apply(params, final)[2]
        return state, tuple(traj), last_value

    def update(self, state, eps: torch.Tensor, perms: Optional[torch.Tensor]):
        """One rollout and PPO update from the given draws; updates the
        policy, the Adam state and the observation statistics.  Returns
        (state, loss, mean_reward)."""
        state, traj, last_value = self.rollout(state, self.params, self.norm, eps)
        loss, mean_rew = self.learn(traj, last_value, perms)
        return state, loss, mean_rew

    def learn(self, traj, last_value: torch.Tensor, perms: Optional[torch.Tensor]):
        """The PPO update from a rollout's trajectory: GAE, ``epochs``
        passes over ``num_minibatches`` minibatches (each an Adam step),
        then the observation statistics.  Returns (loss, mean_reward)."""
        cfg = self.cfg
        params = self.params
        obs_raw, obs_n, act, logp, value, rew, done = traj
        adv, ret = gae(rew, value, done, last_value, cfg.gamma, cfg.gae_lambda)
        T, W = rew.shape
        N = T * W

        def flat(x):
            return x.reshape((N,) + tuple(x.shape[2:]))

        batch = (flat(obs_n), flat(act), flat(logp), flat(adv), flat(ret))
        n_mb = max(1, cfg.num_minibatches)
        mb = N // n_mb
        epochs = max(1, cfg.epochs)
        opt_m, opt_v, opt_t = self.opt_m, self.opt_v, self.opt_t
        loss_total = torch.zeros((), device=rew.device)
        for e in range(epochs):
            shuf = tuple(x[perms[e]] for x in batch) if n_mb > 1 else batch
            losses = []
            for i in range(n_mb):
                xs = tuple(x[i * mb:(i + 1) * mb] for x in shuf)
                leaf = {k: p.detach().requires_grad_() for k, p in params.items()}
                loss = ppo_loss(leaf, cfg, *xs)
                grads = dict(zip(leaf, torch.autograd.grad(loss, list(leaf.values()))))
                params, opt_m, opt_v, opt_t = adam_step(params, opt_m, opt_v, opt_t,
                                                        grads, cfg.lr)
                losses.append(loss.detach())
            loss_total = loss_total + torch.stack(losses).mean()
        if cfg.normalize_obs:
            self.norm = update_norm(self.norm, flat(obs_raw))
        self.params = params
        self.opt_m, self.opt_v, self.opt_t = opt_m, opt_v, opt_t
        return loss_total / epochs, rew.mean()

    def train_step(self, state):
        """One rollout + PPO update with draws from the learner's generator.
        Returns (state, loss, mean_reward)."""
        eps, perms = self.draws(int(state["tick"].shape[0]))
        return self.update(state, eps, perms)
