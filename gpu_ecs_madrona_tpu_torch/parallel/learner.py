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
are (``w1``'s and ``w2``'s once a minibatch's gradient is whole, see
below); the heads are float32 products (TF32 must stay off, PyTorch's
default); statistics use ddof 0; Adam's bias correction is a float32 power.

The random draws (the actions' noise and the minibatch permutations) come
from the learner's own ``torch.Generator`` on its device; ``update`` takes
them as tensors, so a caller can pass any draws (the tests pass JAX's).

The learner runs over a ``mesh`` (``parallel/mesh.py``; one rank and no
collectives by default), the JAX package's one program under a mesh: each
rank steps its own block of worlds and the update equals one process on
all the worlds.  Every rank draws the global noise and permutations from
the same seed and keeps its worlds' noise; a minibatch is the same global
rows as in one process, and each rank computes the terms of the rows it
owns (no row travels between ranks); the advantages' mean and standard
deviation, the losses, the observation statistics and the mean reward
are global sums over ranks divided by global counts; the gradients are
summed over ranks before each Adam step, so every rank takes the same
step.  The trunk's weights are rounded to bf16 on the way forward with an
unrounded gradient, which is rounded to bf16 after the sum (as one
process rounds its whole sum).  ``ppo_loss`` and ``update_norm`` are the
one-process forms of the loss and the statistics (the JAX package's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from gpu_ecs_madrona_tpu_torch.core.executor import resolve_device
from gpu_ecs_madrona_tpu_torch.parallel.mesh import WorldMesh, world_sharding

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


def _bf16_forward(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (exactly: the difference is exact in float32),
    with its gradient passed on unrounded."""
    d = x.detach()
    return x + (_bf16(d) - d)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; for ``x`` [B, N, k] one batched product of B [N, k]
    blocks (``bmm``), never folded into one [B N, k] product."""
    return x @ w if x.ndim == 2 else torch.bmm(x, w.expand(x.shape[0], -1, -1))


def policy_apply(params: Params, obs: torch.Tensor):
    """MLP trunk -> (mu, log_std, value) of ``obs`` [N, obs_dim] (or [B, N,
    obs_dim], B blocks in one batched product): the trunk's products on
    bf16-rounded operands with float32 accumulation, the heads float32.
    The trunk's weights are rounded straight through (``_bf16_forward``:
    their gradients unrounded, rounded by the caller once whole)."""
    h = torch.tanh(_mm(_bf16(obs), _bf16_forward(params["w1"])) + params["b1"])
    h = torch.tanh(_mm(_bf16(h), _bf16_forward(params["w2"])) + params["b2"])
    mu = _mm(h, params["w_mu"]) + params["b_mu"]
    value = (_mm(h, params["w_v"]) + params["b_v"])[..., 0]
    return mu, params["log_std"], value


def log_prob(act, mu, log_std):
    std = torch.exp(log_std)
    return torch.sum(-0.5 * ((act - mu) / std) ** 2 - log_std - _HALF_LOG_2PI, dim=-1)


# The rollout's policy runs on blocks of ROLLOUT_BLOCK rows, the last one
# padded with zeros, all blocks in one batched product of two blocks or
# more: the card's BLAS picks its kernel by a product's shape, and kernels
# add in different orders, so a world's actions and values would otherwise
# depend on how many worlds share the call, that is on how the worlds are
# split over ranks (on an H100 80GB HBM3 at 700 W, two calls of 2048 rows
# and one of 4096 part by up to 7e-4 in the value: tools/learner_ab.py;
# Adam then takes the difference up).  There a batched product of one
# block parts as much from one of more blocks, which agree bit for bit
# with each other and take the time of one product of all the rows
# (tools/learner_ab.py's "rows" case).
ROLLOUT_BLOCK = 4096


def policy_rows(params: Params, obs: torch.Tensor):
    """``policy_apply`` on ``obs`` [N, obs_dim] as [B, ROLLOUT_BLOCK,
    obs_dim] blocks, B >= 2 (padded with zero rows): each row's result is
    the same for any N."""
    n = obs.shape[0]
    pad = max(-n % ROLLOUT_BLOCK, 2 * ROLLOUT_BLOCK - n)
    if pad:
        obs = torch.cat([obs, obs.new_zeros((pad,) + tuple(obs.shape[1:]))])
    mu, log_std, value = policy_apply(params,
                                      obs.reshape((-1, ROLLOUT_BLOCK) + tuple(obs.shape[1:])))
    return mu.reshape((-1,) + tuple(mu.shape[2:]))[:n], log_std, value.reshape(-1)[:n]


def sample_action(params: Params, obs: torch.Tensor, eps: torch.Tensor):
    """(act, logp, value) with act = mu + std * eps (eps: [W, act_dim]), the
    policy in row blocks (``policy_rows``)."""
    mu, log_std, value = policy_rows(params, obs)
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
    return _merge_norm(norm, batch_obs.mean(dim=0), batch_obs.var(dim=0, correction=0),
                       float(batch_obs.shape[0]))


def _merge_norm(norm: Params, mean_b, var_b, n_b: float) -> Params:
    """The running stats merged with a batch's mean, ddof-0 variance and
    count."""
    delta = mean_b - norm["mean"]
    tot = norm["count"] + n_b
    new_mean = norm["mean"] + delta * n_b / tot
    m2 = norm["var"] * norm["count"] + var_b * n_b + delta ** 2 * norm["count"] * n_b / tot
    return {"mean": new_mean, "var": m2 / tot, "count": tot}


def ppo_loss(params: Params, cfg: PPOConfig, obs, act, old_logp, adv, ret):
    """The clipped PPO objective (advantages normalised over the
    minibatch), the value loss and the entropy bonus, in one process: the
    JAX package's loss, its trunk weights' gradients rounded to bf16."""
    mu, log_std, value = policy_apply(
        dict(params, w1=_bf16(params["w1"]), w2=_bf16(params["w2"])), obs)
    ratio = torch.exp(log_prob(act, mu, log_std) - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n,
    ).mean()
    v_loss = torch.mean((value - ret) ** 2)
    entropy = torch.sum(log_std + _HALF_LOG_2PIE)
    return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy


def ppo_loss_share(params: Params, cfg: PPOConfig, obs, act, old_logp, adv, ret,
                   weight: Optional[torch.Tensor], count: int, mesh):
    """This rank's share of ``ppo_loss`` over a minibatch of ``count`` rows
    in all (``weight`` [rows] 1.0 on the rows this rank owns, 0.0 on
    placeholders; None: all owned): the advantages normalised by their
    global mean and ddof-0 deviation (two sums over ranks), the clipped
    objective and the value loss as this rank's sums over ``count``, the
    entropy bonus on rank 0 only.  Summed over ranks it is ``ppo_loss``
    of the whole minibatch; so are its gradients, but that the trunk's
    weight gradients are left unrounded (``policy_apply``)."""
    def total(x):
        return (x if weight is None else x * weight).sum()

    mean = mesh.all_reduce(total(adv).reshape(1)) / count
    var = mesh.all_reduce(total((adv - mean) ** 2).reshape(1)) / count
    adv_n = (adv - mean) / (torch.sqrt(var) + 1e-8)
    mu, log_std, value = policy_apply(params, obs)
    ratio = torch.exp(log_prob(act, mu, log_std) - old_logp)
    pg = -total(torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n)) / count
    share = pg + cfg.value_coef * (total((value - ret) ** 2) / count)
    if mesh.rank == 0:
        share = share - cfg.entropy_coef * torch.sum(log_std + _HALF_LOG_2PIE)
    return share


def update_norm_ranked(norm: Params, var_r: torch.Tensor, mean_r: torch.Tensor, n_r: int,
                       obs_sum: torch.Tensor, count: int, mesh) -> Params:
    """``update_norm`` of the batch of all ranks (``count`` rows in all;
    ``obs_sum`` its column sums, already summed over ranks) from this
    rank's ddof-0 variance and mean of its ``n_r`` rows (one pass over
    them, ``torch.var_mean``): the batch's mean, then its ddof-0 variance
    from each rank's squared deviations about it, n_r (var_r + (mean_r -
    mean)^2), summed over ranks."""
    mean_b = obs_sum / count
    var_b = mesh.all_reduce(n_r * (var_r + (mean_r - mean_b) ** 2)) / count
    return _merge_norm(norm, mean_b, var_b, float(count))


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

    With a ``mesh`` (``parallel.mesh.make_world_mesh``) the learner runs on
    the mesh's device, ``state`` holds this rank's worlds
    (``shard_state``), every rank passes the same ``seed`` and calls
    ``train_step`` together; the loss and the mean reward are the global
    ones, and the parameters (rank 0's at construction) stay equal on
    every rank.  Without one it is a mesh of one rank on ``device``, whose
    collectives do nothing.

    Only the rollout shrinks with the ranks: each rank gathers every
    minibatch at its full global width, the other ranks' rows as weight-0
    placeholders (so that no row count waits on the host), so each does
    the update's forward and backward work, and holds its memory, of one
    process on all the worlds.
    """

    def __init__(self, cfg: PPOConfig, step_fn: Callable, obs_fn: Callable,
                 inject_fn: Callable, reward_fn: Callable,
                 done_fn: Optional[Callable] = None, seed: int = 0, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.step_fn, self.obs_fn = step_fn, obs_fn
        self.inject_fn, self.reward_fn, self.done_fn = inject_fn, reward_fn, done_fn
        self.mesh = WorldMesh(0, 1, resolve_device(device)) if mesh is None else mesh
        self.device = self.mesh.device
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
        with torch.no_grad():
            for p in self.policy.parameters():
                self.mesh.broadcast(p.data)

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
            last_value = policy_rows(params, final)[2]
        return state, tuple(traj), last_value

    def update(self, state, eps: torch.Tensor, perms: Optional[torch.Tensor]):
        """One rollout and PPO update from the given draws; updates the
        policy, the Adam state and the observation statistics.  Returns
        (state, loss, mean_reward).  The draws are the global ones (``eps``
        [T, all ranks' worlds, act_dim]); this rank rolls out its worlds'
        noise."""
        eps = eps[:, self._worlds(state)]
        state, traj, last_value = self.rollout(state, self.params, self.norm, eps)
        loss, mean_rew = self.learn(traj, last_value, perms)
        return state, loss, mean_rew

    def _worlds(self, state) -> slice:
        """This rank's block of the global worlds axis."""
        local = int(state["tick"].shape[0])
        return world_sharding(self.mesh, local * self.mesh.world_size)

    def learn(self, traj, last_value: torch.Tensor, perms: Optional[torch.Tensor]):
        """The PPO update from a rollout's trajectory: GAE, ``epochs``
        passes over ``num_minibatches`` minibatches (each an Adam step),
        then the observation statistics.  Returns (loss, mean_reward).

        Over this rank's worlds, equal to one process's over all of them.
        Minibatch i of epoch e is ``perms[e][i mb:(i + 1) mb]`` over the
        global flat rows t W + w; this rank gathers the rows of its worlds w
        in [start, start + W_r) at t W_r + w - start, each minibatch at its
        full width with the other ranks' rows as weight-0 placeholders (row
        0), so that nothing waits for a count on the host.  With one rank
        every row is its own and no weight is needed."""
        cfg, mesh = self.cfg, self.mesh
        params = self.params
        obs_raw, obs_n, act, logp, value, rew, done = traj
        adv, ret = gae(rew, value, done, last_value, cfg.gamma, cfg.gae_lambda)
        T, Wr = rew.shape
        Wg = Wr * mesh.world_size
        start = mesh.rank * Wr
        N, Nr = T * Wg, T * Wr

        def flat(x):
            return x.reshape((Nr,) + tuple(x.shape[2:]))

        batch = (flat(obs_n), flat(act), flat(logp), flat(adv), flat(ret))
        n_mb = max(1, cfg.num_minibatches)
        mb = N // n_mb
        epochs = max(1, cfg.epochs)
        opt_m, opt_v, opt_t = self.opt_m, self.opt_v, self.opt_t
        names = list(params)
        sizes = [params[k].numel() for k in names]
        loss_total = torch.zeros((), device=rew.device)
        for e in range(epochs):
            if n_mb == 1:
                rows, weight = None, None         # the whole batch, every row owned
            elif mesh.world_size == 1:
                rows, weight = perms[e][:n_mb * mb], None
            else:
                g = perms[e][:n_mb * mb]
                t = torch.div(g, Wg, rounding_mode="floor")
                w = g - t * Wg - start
                own = (w >= 0) & (w < Wr)
                rows = torch.where(own, t * Wr + w, 0)
                weight = own.to(torch.float32)
            losses = []
            for i in range(n_mb):
                part = slice(i * mb, (i + 1) * mb)
                xs = batch if rows is None else tuple(x[rows[part]] for x in batch)
                wi = None if weight is None else weight[part]
                leaf = {k: p.detach().requires_grad_() for k, p in params.items()}
                share = ppo_loss_share(leaf, cfg, *xs, wi, mb, mesh)
                grads = torch.autograd.grad(share, [leaf[k] for k in names])
                summed = mesh.all_reduce(torch.cat([x.reshape(-1) for x in grads]
                                                   + [share.detach().reshape(1)]))
                grads = dict(zip(names, (x.reshape(params[k].shape) for k, x in
                                         zip(names, torch.split(summed[:-1], sizes)))))
                for k in ("w1", "w2"):   # one process's bf16 gradient of the whole sum
                    grads[k] = _bf16(grads[k])
                params, opt_m, opt_v, opt_t = adam_step(params, opt_m, opt_v, opt_t,
                                                        grads, cfg.lr)
                losses.append(summed[-1])
            loss_total = loss_total + torch.stack(losses).mean()
        sums = [rew.sum().reshape(1)]
        if cfg.normalize_obs:
            var_r, mean_r = torch.var_mean(flat(obs_raw), dim=0, correction=0)
            sums.append(mean_r * Nr)
        sums = mesh.all_reduce(torch.cat(sums))
        if cfg.normalize_obs:
            self.norm = update_norm_ranked(self.norm, var_r, mean_r, Nr, sums[1:], N, mesh)
        self.params = params
        self.opt_m, self.opt_v, self.opt_t = opt_m, opt_v, opt_t
        return loss_total / epochs, sums[0] / N

    def train_step(self, state):
        """One rollout + PPO update with draws from the learner's generator.
        Returns (state, loss, mean_reward)."""
        eps, perms = self.draws(int(state["tick"].shape[0]) * self.mesh.world_size)
        return self.update(state, eps, perms)
