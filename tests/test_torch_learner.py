"""The PPO learner (parallel/learner.py) of the PyTorch port against the JAX
package's, and tests/test_learner.py's unsharded property tests on the port.

The functions are held against JAX's on the same inputs (made with numpy
from a seed; JAX's loss and Adam step are closures inside its
``PPOLearner``, restated below from ``learner.py:176-209``).  A whole
train step runs both learners from the same parameters on a scripted
fantasy_vs RL world (the same decision tables on both sides), with JAX's
own draws rebuilt from its key chain and passed to the port's ``update``.

Tolerances, and why:
- The trunk's products multiply bf16-rounded operands exactly and
  accumulate in float32 on both sides; only the order of the float32 sums
  differs (XLA against the CPU's BLAS): forward outputs atol 1e-5.  A
  first-layer output within 2e-6 of a bf16 rounding tie may round to the
  other neighbour on one side, which moves its row's value by up to ~1e-3:
  such rows (found from a float64 recomputation) are held at 2e-3.
- Gradients of ``w1`` and ``w2`` are bf16 values on both sides; a sum
  within rounding of a bf16 tie rounds to the neighbour, so they are held
  elementwise within one bf16 step (2^-8 relative) plus 1e-4 of the leaf's
  largest entry; the other gradients within 1e-4 of their largest entry.
- One Adam step from equal inputs: atol 1e-9 (the float32 power of the
  bias correction may differ by an ulp between XLA and PyTorch).
- A train step (8 Adam steps): tests/test_torch_rl_cases.py's
  ``LEARNER_TOL``, whose comment says why (parameters elementwise within
  lr / 4 and the update as a whole within 5e-3, so no tolerance reaches
  lr; moments 2e-2 of each leaf's largest entry; the loss rtol 2e-4).  It
  holds the first step; JAX's second step run again on a port learner
  that takes JAX's state after the first (``params_from_numpy``,
  ``opt_state_from_numpy``, ``norm_from_numpy`` and the world's state);
  and the port's own second step, which starts from parameters that
  already differ and rolls out again (its loss rtol 2e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.core.executor import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu.core.executor import TaskGraphExecutor as JExecutor
from gpu_ecs_madrona_tpu.models import fantasy_vs as jfvs
from gpu_ecs_madrona_tpu.parallel import learner as jl
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl

import test_torch_rl_cases as cases

OBS, ACT, HID = 45, 18, 32
BF16_STEP = 2.0 ** -8


def jax_params(seed=0, obs=OBS, act=ACT, hidden=HID):
    cfg = jl.PPOConfig(obs_dim=obs, act_dim=act, hidden=hidden)
    p = jl.init_params(cfg, jax.random.PRNGKey(seed))
    # nonzero biases and log_std, so that every term is exercised
    rng = np.random.default_rng(seed + 100)
    p = {k: np.asarray(v) for k, v in p.items()}
    for k in ("b1", "b2", "b_mu", "b_v"):
        p[k] = (0.1 * rng.normal(size=p[k].shape)).astype(np.float32)
    p["log_std"] = (-0.5 + 0.1 * rng.normal(size=act)).astype(np.float32)
    return p


def as_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def as_port(p):
    return pl.params_from_numpy(p, "cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def bf16_tie_rows(p, obs, within=2e-6):
    """Rows whose first-layer output lies within ``within`` of a bf16
    rounding tie (float64 recomputation from the bf16-rounded operands)."""
    def bf(a):
        return t(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()

    h = np.tanh(bf(obs) @ bf(p["w1"]) + p["b1"])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(h), 1e-30))) - 7)
    frac = np.abs(h) / ulp
    return (np.abs(frac - np.floor(frac) - 0.5) * ulp < within).any(axis=1)


def assert_rows_close(got, want, ties, atol=1e-5, tie_atol=2e-3):
    assert ties.mean() < 0.25
    np.testing.assert_allclose(got[~ties], want[~ties], atol=atol, rtol=0)
    np.testing.assert_allclose(got[ties], want[ties], atol=tie_atol, rtol=0)


def jax_loss_fn(cfg):
    """JAX learner.py:176-191, the closure ``loss_fn``."""
    def loss_fn(params, obs, act, old_logp, adv, ret):
        mu, log_std, value = jl.policy_apply(params, obs)
        std = jnp.exp(log_std)
        logp = jnp.sum(
            -0.5 * ((act - mu) / std) ** 2 - log_std
            - 0.5 * jnp.log(2 * jnp.pi), axis=-1)
        ratio = jnp.exp(logp - old_logp)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = -jnp.minimum(
            ratio * adv_n,
            jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n,
        ).mean()
        v_loss = jnp.mean((value - ret) ** 2)
        entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
        return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    return loss_fn


def jax_adam(cfg):
    """JAX learner.py:193-209, the closure ``adam``."""
    def adam(params, opt_m, opt_v, opt_t, grads):
        opt_t = opt_t + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        opt_m = jax.tree_util.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt_m, grads)
        opt_v = jax.tree_util.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt_v, grads)
        tf = opt_t.astype(jnp.float32)
        params = jax.tree_util.tree_map(
            lambda p, m_, v_: p - cfg.lr * (m_ / (1 - b1 ** tf))
            / (jnp.sqrt(v_ / (1 - b2 ** tf)) + eps),
            params, opt_m, opt_v)
        return params, opt_m, opt_v, opt_t
    return adam


def batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, OBS)).astype(np.float32),
            rng.normal(size=(n, ACT)).astype(np.float32),
            (rng.normal(size=n) - 20.0).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


def test_policy_apply_matches_jax():
    p = jax_params()
    obs = batch(1)[0]
    jmu, jls, jv = jl.policy_apply(as_jax(p), obs)
    pmu, pls, pv = pl.policy_apply(as_port(p), t(obs))
    ties = bf16_tie_rows(p, obs)
    assert_rows_close(pmu.numpy(), np.asarray(jmu), ties)
    assert_rows_close(pv.numpy(), np.asarray(jv), ties)
    np.testing.assert_array_equal(pls.numpy(), np.asarray(jls))
    policy = pl.Policy(as_port(p))
    assert [k for k, _ in policy.named_parameters()] == list(pl.PARAM_NAMES)
    np.testing.assert_array_equal(policy(t(obs))[0].detach().numpy(), pmu.numpy())


def test_sample_action_matches_jax():
    """The same noise: JAX's normal draw from its key, passed to the port."""
    p = jax_params()
    obs = batch(2)[0]
    key = jax.random.PRNGKey(9)
    jact, jlogp, jv = jl.sample_action(as_jax(p), obs, key)
    eps = np.asarray(jax.random.normal(key, (obs.shape[0], ACT)))
    pact, plogp, pv = pl.sample_action(as_port(p), t(obs), t(eps))
    ties = bf16_tie_rows(p, obs)
    assert_rows_close(pact.numpy(), np.asarray(jact), ties)
    # logp sums act_dim squared terms: atol 1e-4
    assert_rows_close(plogp.numpy(), np.asarray(jlogp), ties, atol=1e-4)
    assert_rows_close(pv.numpy(), np.asarray(jv), ties)


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    T, W = 7, 11
    rew = rng.normal(size=(T, W)).astype(np.float32)
    val = rng.normal(size=(T, W)).astype(np.float32)
    done = (rng.random((T, W)) < 0.3).astype(np.float32)
    last = rng.normal(size=W).astype(np.float32)
    jadv, jret = jl.gae(rew, val, done, last, 0.99, 0.95)
    padv, pret = pl.gae(t(rew), t(val), t(done), t(last), 0.99, 0.95)
    np.testing.assert_allclose(padv.numpy(), np.asarray(jadv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pret.numpy(), np.asarray(jret), atol=1e-6, rtol=0)


def test_update_norm_and_normalize_match_jax():
    rng = np.random.default_rng(4)
    x = (3.0 + 2.0 * rng.normal(size=(96, OBS))).astype(np.float32)
    norm = {"mean": rng.normal(size=OBS).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, OBS).astype(np.float32),
            "count": np.float32(37.0)}
    jn = jl.update_norm({k: jnp.asarray(v) for k, v in norm.items()}, x)
    pn = pl.update_norm(pl.norm_from_numpy(norm, "cpu"), t(x))
    for k in ("mean", "var"):
        np.testing.assert_allclose(pn[k].numpy(), np.asarray(jn[k]), atol=1e-5, rtol=1e-6)
    assert float(pn["count"]) == float(jn["count"]) == 133.0
    jo = jl.normalize_obs(x, jn, 1.5)
    po = pl.normalize_obs(t(x), pn, 1.5)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert float(po.abs().max()) == 1.5      # the clip is reached


@pytest.fixture(scope="module")
def grads():
    """The loss and its gradients on both sides, from equal inputs."""
    cfg = jl.PPOConfig(obs_dim=OBS, act_dim=ACT, hidden=HID)
    p = jax_params(seed=1)
    xs = batch(5)
    # old log-probabilities near the current ones, so that some ratios clip
    mu, ls, _ = jl.policy_apply(as_jax(p), xs[0])
    logp = np.asarray(pl.log_prob(t(xs[1]), t(np.asarray(mu)), t(np.asarray(ls))))
    xs = xs[:2] + ((logp + np.random.default_rng(6).normal(0, 0.3, logp.shape)
                    ).astype(np.float32),) + xs[3:]
    jloss, jg = jax.value_and_grad(jax_loss_fn(cfg))(as_jax(p), *xs)
    leaf = {k: v.requires_grad_() for k, v in as_port(p).items()}
    ploss = pl.ppo_loss(leaf, pl.PPOConfig(obs_dim=OBS, act_dim=ACT, hidden=HID),
                        *(t(x) for x in xs))
    pg = dict(zip(leaf, torch.autograd.grad(ploss, list(leaf.values()))))
    ratio = np.exp(logp - xs[2])
    assert ((ratio < 0.8) | (ratio > 1.2)).any() and ((ratio > 0.8) & (ratio < 1.2)).any()
    return (float(jloss), {k: np.asarray(v) for k, v in jg.items()},
            float(ploss.detach()), {k: v.numpy() for k, v in pg.items()})


def test_loss_matches_jax(grads):
    jloss, _, ploss, _ = grads
    assert math.isclose(ploss, jloss, rel_tol=1e-5, abs_tol=1e-6)


def is_bf16(a):
    return np.array_equal(t(a).to(torch.bfloat16).float().numpy(), a)


@pytest.mark.parametrize("name", pl.PARAM_NAMES)
def test_gradients_match_jax(grads, name):
    _, jg, _, pg = grads
    want, got = jg[name], pg[name]
    assert got.shape == want.shape
    if name in ("w1", "w2"):
        # both sides' trunk weight gradients are bf16 values
        assert is_bf16(want) and is_bf16(got)
        np.testing.assert_array_less(np.abs(got - want),
                                     BF16_STEP * np.abs(want) + 1e-4 * np.abs(want).max())
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)
    if name in ("b1", "w_mu", "b2"):
        assert not is_bf16(want) and not is_bf16(got)   # not rounded


def test_adam_step_matches_jax():
    cfg = jl.PPOConfig(obs_dim=OBS, act_dim=ACT, hidden=HID)
    p = jax_params(seed=2)
    rng = np.random.default_rng(7)

    def like(scale):
        return {k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in p.items()}

    g, m = like(0.1), like(0.01)
    v = {k: np.abs(x) for k, x in like(1e-3).items()}
    out = jax_adam(cfg)(as_jax(p), as_jax(m), as_jax(v), jnp.int32(3), as_jax(g))
    mine = pl.adam_step(as_port(p), as_port(m), as_port(v),
                        torch.tensor(3, dtype=torch.int32), as_port(g), cfg.lr)
    for i, what in enumerate(("params", "opt_m", "opt_v")):
        for k in pl.PARAM_NAMES:
            np.testing.assert_allclose(mine[i][k].numpy(), np.asarray(out[i][k]),
                                       atol=1e-9, rtol=0, err_msg=f"{what} {k}")
    assert int(mine[3]) == int(out[3]) == 4 and mine[3].dtype == torch.int32


# ---------------------------------------------------------------------------
# a whole train step against JAX's PPOLearner.train_step
# ---------------------------------------------------------------------------

W, ND, NK = cases.RL_WORLDS, cases.RL_DRAGONS, cases.RL_KNIGHTS


def jax_draws(key, cfg, num_worlds):
    """JAX learner.py's draws for one train step, from its key: a split
    and a normal per rollout step (:94, :166), then a split and a
    permutation per epoch (:228-229)."""
    eps = []
    for _ in range(cfg.rollout_len):
        key, sub = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(sub, (num_worlds, cfg.act_dim))))
    perms = []
    for _ in range(cfg.epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, cfg.rollout_len * num_worlds)))
    return key, torch.from_numpy(np.stack(eps)), torch.from_numpy(np.stack(perms)).long()


def jax_learner_state(jlr, loss, rew):
    def np_(d):
        return {k: np.array(v) for k, v in d.items()}
    return {"loss": float(loss), "mean_reward": float(rew), "params": np_(jlr.params),
            "opt_m": np_(jlr.opt_m), "opt_v": np_(jlr.opt_v), "opt_t": int(jlr.opt_t),
            "norm": np_(jlr.norm)}


def port_learner_state(plr, loss, rew):
    return dict(cases.learner_state(plr), loss=float(loss), mean_reward=float(rew))


@pytest.fixture(scope="module")
def train_steps():
    """Two train steps of both learners on the scripted RL world (damage
    constants high enough for rewards), from JAX's initial parameters; and
    JAX's second step again on a port learner that takes JAX's state after
    the first (parameters, Adam state, observation statistics and the
    world's state carried across), so that both start it equal.  Keys:
    "first", "second", "carried"; each {"jax": ..., "port": ...}."""
    script = cases.rl_script()
    kw = cases.rl_config()
    out = {}
    with cases.golden_constants(jfvs, fvs):
        jcfg = jfvs.FantasyVsConfig(**kw)
        jsim = JExecutor(jfvs.FantasyVsRLWorld.with_config(jcfg),
                         JExecutorConfig(num_worlds=W, max_entities_per_world=ND + NK + 8,
                                         seed=4, donate=False), init_data=script)
        # JAX's adapters (they read the registry's layout, not the world)
        _, jobs, jinj, jrew, obs_dim, act_dim = jfvs.make_rl_env(
            jfvs.FantasyVsConfig(**dict(kw, scripted=False)), donate=False)

        def port_learner():
            psim, pobs, pinj, prew, pobs_dim, pact_dim = fvs.make_rl_env(
                fvs.FantasyVsConfig(**kw), device="cpu", init_data=script)
            assert (pobs_dim, pact_dim) == (obs_dim, act_dim)
            return psim, pl.PPOLearner(pl.PPOConfig(**cfg), psim.graph.step, pobs, pinj,
                                       prew, done_fn=cases.done_fn, device="cpu")

        cfg = dict(cases.RL_PPO, obs_dim=obs_dim, act_dim=act_dim)
        jlr = jl.PPOLearner(jl.PPOConfig(**cfg), jsim.graph.step, jobs, jinj, jrew,
                            done_fn=cases.done_fn)
        psim, plr = port_learner()
        plr.params = pl.params_from_numpy({k: np.asarray(v) for k, v in jlr.params.items()},
                                          "cpu")
        out["start"] = {"jax": jax_learner_state(jlr, 0.0, 0.0)}
        jstate, pstate = jsim.state, psim.state
        for name in ("first", "second"):
            key, eps, perms = jax_draws(jlr.key, plr.cfg, W)
            if name == "second":   # JAX's state before it (the step donates jstate)
                carried = (jax_learner_state(jlr, 0.0, 0.0),
                           jax.tree_util.tree_map(np.array, jstate), eps, perms)
            jstate, jloss, jrew_ = jlr.train_step(jstate)
            assert np.array_equal(np.asarray(jlr.key), np.asarray(key))
            pstate, ploss, prew_ = plr.update(pstate, eps, perms)
            assert ploss.shape == prew_.shape == torch.Size([])
            out[name] = {"jax": jax_learner_state(jlr, jloss, jrew_),
                         "port": port_learner_state(plr, ploss, prew_)}
        js, jworld, eps, perms = carried
        csim, clr = port_learner()
        clr.params = pl.params_from_numpy(js["params"], "cpu")
        clr.opt_m, clr.opt_v, clr.opt_t = pl.opt_state_from_numpy(
            js["opt_m"], js["opt_v"], js["opt_t"], "cpu")
        clr.norm = pl.norm_from_numpy(js["norm"], "cpu")
        _, closs, crew = clr.update(state_from_numpy(jworld, "cpu"), eps, perms)
        out["carried"] = {"jax": out["second"]["jax"],
                          "port": port_learner_state(clr, closs, crew)}
    return out


STEPS = ["first", "second", "carried"]
# the port's own second step starts from parameters that already differ
# and rolls out again: its loss within 2e-3
TOL = {"first": cases.LEARNER_TOL, "carried": cases.LEARNER_TOL,
       "second": dict(cases.LEARNER_TOL, loss_rel=2e-3)}


def step_differences(train_steps, step):
    j, p = train_steps[step]["jax"], train_steps[step]["port"]
    start = train_steps["start" if step == "first" else "first"]["jax"]["params"]
    diff = cases.learner_differences(p, j, start)
    diff["loss_rel"] = abs(p["loss"] - j["loss"]) / abs(j["loss"])
    diff["mean_reward"] = abs(p["mean_reward"] - j["mean_reward"])
    return diff


@pytest.mark.parametrize("step", STEPS)
def test_train_step_loss_and_reward_match_jax(train_steps, step):
    diff = step_differences(train_steps, step)
    assert not cases.within({k: diff[k] for k in ("loss_rel", "mean_reward")}, TOL[step])
    assert any(train_steps[s]["jax"]["mean_reward"] > 0 for s in STEPS)   # rewards dealt


@pytest.mark.parametrize("step", STEPS)
def test_train_step_params_match_jax(train_steps, step):
    diff = step_differences(train_steps, step)
    assert TOL[step]["params"] < pl.PPOConfig().lr
    assert not cases.within({k: diff[k] for k in ("params", "update_rel")}, TOL[step]), diff
    # the step moved the parameters well past the tolerance
    j = train_steps[step]["jax"]["params"]
    start = train_steps["start" if step == "first" else "first"]["jax"]["params"]
    assert max(np.abs(j[k] - start[k]).max() for k in j) > 4 * TOL[step]["params"]


@pytest.mark.parametrize("step", STEPS)
def test_train_step_adam_state_matches_jax(train_steps, step):
    j, p = train_steps[step]["jax"], train_steps[step]["port"]
    # 2 epochs x 4 minibatches a step
    assert p["opt_t"] == j["opt_t"] == (8 if step == "first" else 16)
    diff = step_differences(train_steps, step)
    assert not cases.within({k: diff[k] for k in ("opt_m_rel", "opt_v_rel")}, TOL[step]), diff


@pytest.mark.parametrize("step", STEPS)
def test_train_step_obs_stats_match_jax(train_steps, step):
    diff = step_differences(train_steps, step)
    keys = ("norm_mean", "norm_var", "norm_count")
    assert not cases.within({k: diff[k] for k in keys}, TOL[step]), diff


# ---------------------------------------------------------------------------
# tests/test_learner.py's unsharded property tests, on the port
# ---------------------------------------------------------------------------


def make_env(num_worlds=8):
    cfg = fvs.FantasyVsConfig(num_worlds=num_worlds, num_dragons=3, num_knights=6, seed=4,
                              cleanup=False)
    return fvs.make_rl_env(cfg, device="cpu")


def test_train_step_runs_and_learns_shape():
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = make_env()
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, hidden=32,
                                         rollout_len=4),
                            sim.graph.step, obs_fn, inject_fn, reward_fn, device="cpu")
    before = {k: v.clone() for k, v in learner.params.items()}
    state, loss, rew = learner.train_step(sim.state)
    assert loss.shape == () and rew.shape == ()
    assert torch.isfinite(loss) and torch.isfinite(rew)
    assert any(not torch.equal(before[k], v) for k, v in learner.params.items())
    state, loss2, rew2 = learner.train_step(state)
    assert torch.isfinite(loss2)
    assert int(state["tick"][0]) == 8


def test_reward_reflects_damage():
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = make_env()
    s0 = sim.state
    sim.step()
    r = reward_fn(s0, sim.state)
    assert (r >= 0).all()
    assert r.max() > 0


def test_minibatch_multiepoch_normalized():
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = make_env()
    learner = pl.PPOLearner(
        pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, hidden=32, rollout_len=4,
                     epochs=2, num_minibatches=4, normalize_obs=True),
        sim.graph.step, obs_fn, inject_fn, reward_fn, done_fn=cases.done_fn, device="cpu")
    state, loss, rew = learner.train_step(sim.state)
    assert torch.isfinite(loss)
    assert float(learner.norm["count"]) > 1.0
    assert torch.isfinite(learner.norm["mean"]).all()
    state, loss2, _ = learner.train_step(state)
    assert torch.isfinite(loss2)
    assert float(learner.norm["count"]) == pytest.approx(1e-4 + 2 * 4 * 8, rel=1e-6)


def test_init_params_scales_and_seed():
    """The port's own initial parameters: JAX's shapes and scales, drawn
    from the learner's generator (the same seed gives the same values)."""
    cfg = pl.PPOConfig(obs_dim=400, act_dim=50, hidden=128)
    a = pl.init_params(cfg, torch.Generator().manual_seed(3))
    b = pl.init_params(cfg, torch.Generator().manual_seed(3))
    ref = jl.init_params(jl.PPOConfig(obs_dim=400, act_dim=50, hidden=128),
                         jax.random.PRNGKey(3))
    for k in pl.PARAM_NAMES:
        assert tuple(a[k].shape) == ref[k].shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    for k, s in (("w1", 1 / 20), ("w2", 1 / math.sqrt(128)), ("w_mu", 0.01 / math.sqrt(128))):
        assert float(a[k].std()) == pytest.approx(s, rel=0.05)
    assert (a["log_std"] == -0.5).all() and not a["b1"].any() and not a["b_v"].any()


def test_train_step_is_update_with_its_draws():
    """train_step = update(draws()): the same generator state gives the same
    step; the permutations are permutations; one minibatch draws none."""
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = make_env()
    cfg = pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, hidden=16, rollout_len=3,
                       epochs=2, num_minibatches=3)
    a, b = (pl.PPOLearner(cfg, sim.graph.step, obs_fn, inject_fn, reward_fn, seed=5,
                          device="cpu") for _ in range(2))
    sa, la, ra = a.train_step(sim.state)
    eps, perms = b.draws(8)
    assert eps.shape == (3, 8, act_dim) and perms.shape == (2, 24)
    assert all(torch.equal(p.sort().values, torch.arange(24)) for p in perms)
    sb, lb, rb = b.update(sim.state, eps, perms)
    assert torch.equal(la, lb) and torch.equal(ra, rb)
    for k in pl.PARAM_NAMES:
        assert torch.equal(a.params[k], b.params[k])
    one = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, hidden=16),
                        sim.graph.step, obs_fn, inject_fn, reward_fn, device="cpu")
    assert one.draws(8)[1] is None


def test_learner_case_repeats():
    """The card tests' and chip_smoke.py's learner case (numpy parameters
    and draws) on the CPU: a train step that changes the parameters, deals
    rewards and repeats bit for bit."""
    a, b = cases.rl_train_step("cpu"), cases.rl_train_step("cpu")
    assert a[0] == b[0] and a[1] == b[1] > 0
    d = cases.rl_card_vs_cpu(a, b)
    assert all(v == 0 for v in d.values()), d
    start = a[3]
    assert all(not np.array_equal(a[2]["params"][k], start[k]) for k in pl.PARAM_NAMES)
    assert a[2]["opt_t"] == 8
