"""The PPO learner across ranks (parallel/learner.py with a mesh) on the CPU:
2 and 4 gloo processes against one process, and 2 processes against the
JAX package's learner on a 2-device CPU mesh.

The learner case is tests/test_torch_rl_cases.py's scripted RL world (8
worlds x (3 + 6), 2 epochs, 4 minibatches, observation normalisation,
done every third tick), one train step from ``rl_params``.  Each worker
(tests/test_torch_rank_cases.py ``learner_worker``) takes its worlds of
the world state with ``shard_state`` and runs ``PPOLearner.update`` with
the global draws of three cases:

- "numpy": ``rl_draws`` (noise and permutations made with numpy);
- "empty": the same noise, and permutations in which some rank holds no
  row of a minibatch (``empty_minibatch_perms``);
- "jax": the noise and permutations of JAX's key chain (as
  tests/test_torch_learner.py rebuilds them), from which JAX's learner
  takes its step on the 2-device mesh.

Each rank's loss, mean reward, parameters, Adam moments and step count and
observation statistics agree with one process's within ``LEARNER_TOL``
(whose comment says why; the global sums are added in another order), and
the ranks hold bit-identical parameters and Adam state.  The workers get
120 s a run; on a timeout or a failure every worker is killed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.core.executor import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu.core.executor import TaskGraphExecutor as JExecutor
from gpu_ecs_madrona_tpu.models import fantasy_vs as jfvs
from gpu_ecs_madrona_tpu.parallel import learner as jl
from gpu_ecs_madrona_tpu.parallel import make_world_mesh as jmake_world_mesh
from gpu_ecs_madrona_tpu.parallel import shard_state as jshard_state
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl

import test_torch_rank_cases as rc
import test_torch_rl_cases as rl
from test_torch_learner import jax_draws, jax_learner_state

W = rl.RL_WORLDS
CASES = ["numpy", "empty", "jax"]
RANKS = [2, 4]


def jax_mesh_step(params):
    """JAX's learner (seed 0) on the scripted RL world sharded over a
    2-device mesh, from ``params``: (its result, the noise and permutations
    its key chain draws)."""
    kw = rl.rl_config()
    with rl.golden_constants(jfvs, fvs):
        jsim = JExecutor(jfvs.FantasyVsRLWorld.with_config(jfvs.FantasyVsConfig(**kw)),
                         JExecutorConfig(num_worlds=W, max_entities_per_world=rl.RL_DRAGONS
                                         + rl.RL_KNIGHTS + 8, seed=4, donate=False),
                         init_data=rl.rl_script())
        _, jobs, jinj, jrew, obs_dim, act_dim = jfvs.make_rl_env(
            jfvs.FantasyVsConfig(**dict(kw, scripted=False)), donate=False)
        cfg = pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl.RL_PPO)
        jlr = jl.PPOLearner(jl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl.RL_PPO),
                            jsim.graph.step, jobs, jinj, jrew, done_fn=rl.done_fn)
        jlr.params = {k: jnp.asarray(v) for k, v in params.items()}
        _, eps, perms = jax_draws(jlr.key, cfg, W)
        state = jshard_state(jsim.state, jmake_world_mesh(jax.devices()[:2]))
        state, loss, rew = jlr.train_step(state)
        assert len(state["tick"].sharding.device_set) == 2
        return jax_learner_state(jlr, loss, rew), eps.numpy(), perms.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"cases", "one": one process's results, "jax": JAX's on the mesh,
    2 and 4: each rank's results}."""
    d = tmp_path_factory.mktemp("learner_ranks")
    _, _, _, _, obs_dim, act_dim = rc.rl_env("cpu", 1)
    params = rl.rl_params(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl.RL_PPO))
    eps, perms = rl.rl_draws(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl.RL_PPO), W)
    jax_result, jeps, jperms = jax_mesh_step(params)
    cases = {"numpy": (params, eps.numpy(), perms.numpy()),
             "empty": (params, eps.numpy(), rc.empty_minibatch_perms()),
             "jax": (params, jeps, jperms)}
    out = {"cases": cases, "jax": jax_result,
           "one": {name: rc.rl_update(rc.rl_env("cpu"), "cpu", *c) for name, c in cases.items()}}
    inp = os.path.join(d, "cases.npz")
    rc.save_learner_cases(inp, cases)
    for n in RANKS:
        rc.run_ranks(d, "learner_worker", n, inp, os.path.join(d, f"ranks{n}"))
        out[n] = rc.load_rank_results(os.path.join(d, f"ranks{n}"), n)
    return out


def differences(got, want, start):
    diff = rl.learner_differences(got, want, start)
    diff["loss_rel"] = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    diff["mean_reward"] = abs(got["mean_reward"] - want["mean_reward"])
    return diff


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("nprocs", RANKS)
def test_ranks_match_one_process(runs, nprocs, case):
    start = runs["cases"][case][0]
    diff = differences(runs[nprocs][0][case], runs["one"][case], start)
    assert not rl.within(diff, rl.LEARNER_TOL), diff
    assert runs[nprocs][0][case]["opt_t"] == 8            # 2 epochs x 4 minibatches
    assert runs["one"]["numpy"]["mean_reward"] > 0         # rewards dealt


@pytest.mark.parametrize("nprocs", RANKS)
def test_ranks_hold_equal_parameters(runs, nprocs):
    for case in CASES:
        first = runs[nprocs][0][case]
        for other in runs[nprocs][1:]:
            for part in ("params", "opt_m", "opt_v", "norm"):
                for k, v in first[part].items():
                    np.testing.assert_array_equal(other[case][part][k], v,
                                                  err_msg=f"{case} {part} {k}")
            assert (other[case]["loss"], other[case]["mean_reward"]) == \
                (first["loss"], first["mean_reward"])


@pytest.mark.parametrize("nprocs", RANKS)
def test_empty_case_leaves_a_rank_without_rows(nprocs):
    counts = rc.rows_by_rank(rc.empty_minibatch_perms(), nprocs)
    assert (counts == 0).any()
    assert (counts.sum(axis=2) == 8).all()     # every minibatch holds 8 rows in all


def test_two_ranks_match_jax_on_a_two_device_mesh(runs):
    diff = differences(runs[2][0]["jax"], runs["jax"], runs["cases"]["jax"][0])
    assert not rl.within(diff, rl.LEARNER_TOL), diff
    assert runs[2][0]["jax"]["opt_t"] == runs["jax"]["opt_t"] == 8


def test_rollout_policy_rows_do_not_depend_on_the_row_count():
    """policy_rows: the rollout's policy in blocks of ROLLOUT_BLOCK rows (the
    last padded), so that a world's actions and values are the same however
    many worlds share the call (on the card the BLAS kernel, and so the
    order of a product's sums, depends on its shape)."""
    rng = np.random.default_rng(3)
    cfg = pl.PPOConfig(obs_dim=45, act_dim=18, hidden=32)
    params = pl.params_from_numpy(rl.rl_params(cfg), "cpu")
    obs = torch.from_numpy(rng.normal(size=(2 * pl.ROLLOUT_BLOCK + 5, 45)).astype(np.float32))
    whole = pl.policy_rows(params, obs)
    for lo, hi in ((0, 7), (3, pl.ROLLOUT_BLOCK + 9), (pl.ROLLOUT_BLOCK, obs.shape[0])):
        part = pl.policy_rows(params, obs[lo:hi])
        assert torch.equal(part[0], whole[0][lo:hi]) and torch.equal(part[2], whole[2][lo:hi])
    block = pl.policy_apply(params, obs[:pl.ROLLOUT_BLOCK])
    assert torch.equal(block[0], whole[0][:pl.ROLLOUT_BLOCK])
    assert whole[0].shape == (obs.shape[0], 18) and whole[2].shape == (obs.shape[0],)
