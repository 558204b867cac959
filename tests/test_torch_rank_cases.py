"""Multi-process cases of the port across ranks, shared by the CPU tests,
the card tests and chip_smoke.py: numpy, torch and the port only (no JAX),
so that they also run on a machine with the card and no JAX.

``run_ranks`` starts one worker process a rank (``subprocess.Popen``; the
worker script is written to a given directory, the group meets on a free
local port) and kills them all when one fails or the time runs out.  The
workers:

- ``learner_worker``: the scripted RL world of test_torch_rl_cases.py
  (8 worlds x (3 + 6), 2 epochs, 4 minibatches, observation
  normalisation, done every third tick) split over the ranks: one train
  step (``PPOLearner.update``) a case, each from given parameters and
  global draws, from the same world state;
- ``collisions_worker``: collisions worlds from a checkpoint split over the
  ranks, stepped, with a cross-rank checksum (``all_reduce`` of |pos|
  sums).

Each worker saves its results to ``<out>.<rank>.npz``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.parallel import learner as pl
from gpu_ecs_madrona_tpu_torch.parallel import mesh as pm

import test_torch_rl_cases as rl

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANK_TIMEOUT_S = 120

_SCRIPT = textwrap.dedent("""
    import sys
    sys.path[:0] = [{tests!r}, {repo!r}]
    import test_torch_rank_cases as cases
    cases.{worker}(*sys.argv[1:])
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(workdir, worker, nprocs, *args, timeout=RANK_TIMEOUT_S, env=None):
    """Run ``worker(coordinator, rank, nprocs, *args)`` in ``nprocs``
    processes; returns each rank's stdout.  A worker that fails, or a run
    past ``timeout`` seconds, kills every worker and raises."""
    script = os.path.join(str(workdir), f"{worker}.py")
    with open(script, "w") as f:
        f.write(_SCRIPT.format(tests=TESTS, repo=REPO, worker=worker))
    coordinator = f"127.0.0.1:{free_port()}"
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = REPO + os.pathsep + full_env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, script, coordinator, str(r), str(nprocs),
                               *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=full_env, cwd=REPO)
             for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"{worker} rank {len(outs) - 1} failed "
                                   f"(rc={p.returncode}):\n{out}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _join(coordinator, rank, nprocs, device, backend):
    pm.initialize_distributed(coordinator, int(nprocs), int(rank), device=device,
                              backend=backend)
    return pm.make_world_mesh(device)


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(z, prefix):
    """The entries of ``z`` (an npz file or a dict of arrays) under
    ``prefix``, as a nested dict."""
    tree = {}
    for key in getattr(z, "files", None) or list(z):
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


# ---------------------------------------------------------------------------
# the learner across ranks
# ---------------------------------------------------------------------------

def save_learner_cases(path, cases):
    """``cases``: {name: (params, eps [T, W, act_dim], perms [epochs, N])}."""
    out = {}
    for name, (params, eps, perms) in cases.items():
        _flat(f"{name}/params/", params, out)
        out[f"{name}/eps"] = np.asarray(eps, np.float32)
        out[f"{name}/perms"] = np.asarray(perms, np.int64)
    np.savez(path, **out)


def learner_result(loss, rew, learner):
    """A train step's loss, mean reward and ``rl.learner_state``."""
    return dict(rl.learner_state(learner), loss=float(loss), mean_reward=float(rew))


def rl_env(device, num_worlds=rl.RL_WORLDS):
    """``fvs.make_rl_env`` of the scripted RL world at ``num_worlds`` worlds."""
    return fvs.make_rl_env(fvs.FantasyVsConfig(**dict(rl.rl_config(), num_worlds=num_worlds)),
                           device=device, init_data=rl.rl_script())


def rl_update(env, device, params, eps, perms, mesh=None, state=None):
    """One train step of the scripted RL world ``env`` from ``params`` and
    the global draws, by a fresh learner: ``learner_result``.  With a mesh,
    ``state`` is this rank's (default: the executor's)."""
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = env
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **rl.RL_PPO),
                            sim.graph.step, obs_fn, inject_fn, reward_fn, done_fn=rl.done_fn,
                            device=device, mesh=mesh)
    learner.params = pl.params_from_numpy(params, device)
    with rl.golden_constants(fvs):
        _, loss, rew = learner.update(sim.state if state is None else state,
                                      torch.as_tensor(eps).to(device),
                                      torch.as_tensor(perms).to(device))
    return learner_result(loss, rew, learner)


def learner_worker(coordinator, rank, nprocs, inp, out, device="cpu", backend="gloo"):
    """Each case of ``inp`` on this rank's worlds; saves its results."""
    mesh = _join(coordinator, rank, nprocs, device, backend)
    state = pm.shard_state(rl_env(device)[0].state, mesh)
    env = rl_env(device, rl.RL_WORLDS // mesh.world_size)
    z = np.load(inp)
    res = {}
    for name in sorted({k.split("/")[0] for k in z.files}):
        r = rl_update(env, device, _nest(z, f"{name}/params/"), z[f"{name}/eps"],
                      z[f"{name}/perms"], mesh=mesh, state=state)
        _flat(f"{name}/", r, res)
    np.savez(f"{out}.{mesh.rank}.npz", **res)
    torch.distributed.destroy_process_group()


def load_rank_results(out, nprocs):
    """Each rank's {case: learner_result} (or other saved tree)."""
    res = []
    for r in range(nprocs):
        with np.load(f"{out}.{r}.npz") as z:
            cases = sorted({k.split("/")[0] for k in z.files})
            res.append({c: result_tree(z, f"{c}/") for c in cases})
    return res


def result_tree(z, prefix):
    """A ``learner_result`` saved flat under ``prefix`` (an npz file or a
    dict of arrays), with its scalars as Python numbers."""
    tree = _nest(z, prefix)
    for k in ("loss", "mean_reward", "opt_t"):
        if k in tree:
            tree[k] = tree[k].item()
    return tree


def empty_minibatch_perms(cfg_epochs=2, T=4, W=rl.RL_WORLDS, mb_count=4, seed=23):
    """Permutations of the learner case's T W rows in which minibatch 0 of
    epoch 0 holds only rows of worlds 0 .. W/2 - 1 and minibatch 1 of epoch
    1 only rows of worlds W/2 .. W - 1: under 2 or 4 ranks, some rank holds
    no row of them."""
    rng = np.random.default_rng(seed)
    N = T * W
    mb = N // mb_count
    perms = []
    for e in range(cfg_epochs):
        half = np.array([g for g in range(N) if (g % W < W // 2) == (e == 0)])
        picked = rng.permutation(half)[:mb]
        rest = rng.permutation(np.setdiff1d(np.arange(N), picked))
        perms.append(np.concatenate([rest[:e * mb], picked, rest[e * mb:]]))
    return np.stack(perms)


def rows_by_rank(perms, nprocs, W=rl.RL_WORLDS, mb_count=4):
    """[epochs, minibatches, ranks] counts of the rows each rank owns."""
    epochs, N = perms.shape
    mb = N // mb_count
    owner = (perms % W) // (W // nprocs)
    return np.stack([[np.bincount(owner[e, i * mb:(i + 1) * mb], minlength=nprocs)
                      for i in range(mb_count)] for e in range(epochs)])


# ---------------------------------------------------------------------------
# collisions across ranks
# ---------------------------------------------------------------------------

# tests/test_distributed.py's configuration, and the main path's (8192 x 100)
COLLISIONS = {"distributed": dict(num_objects=10, max_pairs=128, seed=5), "main": dict()}


def collisions_config(name, num_worlds, fused=None):
    return col.CollisionsConfig(num_worlds=num_worlds, fused=fused, **COLLISIONS[name])


def collisions_positions(sim):
    return sim.mgr.column(sim.state, col.CubeObject, col.Translation)


def _fused(arg):
    return None if arg == "None" else arg == "True"


def collisions_job(mesh, device, name, num_worlds, fused, steps, ckpt="initial"):
    """This rank's worlds of collisions ``name`` at ``num_worlds`` worlds
    (from the checkpoint ``ckpt``, else the executor's own initial state),
    stepped ``steps`` times: its state's leaves ("state/..."), the
    cross-rank checksum (the all_reduce of the ranks' |pos| sums), kernel
    1's launches and its worlds' [start, stop)."""
    from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    gsim = col.make_executor(collisions_config(name, num_worlds, fused), device=device)
    if ckpt != "initial":
        gsim.restore_checkpoint(ckpt)
    sim = col.make_executor(collisions_config(name, num_worlds // mesh.world_size, fused),
                            device=device)
    sim.state = pm.shard_state(gsim.state, mesh)
    del gsim
    ck.fused_collisions_step.launches = 0
    sim.run(steps)
    checksum = mesh.all_reduce(collisions_positions(sim).abs().sum().reshape(1))
    rows = pm.world_sharding(mesh, num_worlds)
    return _flat("state/", state_to_numpy(sim.state), {
        "checksum": checksum.cpu().numpy(), "worlds": np.array([rows.start, rows.stop]),
        "launches": np.int64(ck.fused_collisions_step.launches)})


def collisions_worker(coordinator, rank, nprocs, ckpt, out, steps, num_worlds, fused,
                      device="cpu", backend="gloo"):
    """``collisions_job`` of tests/test_distributed.py's configuration from
    the checkpoint ``ckpt``; saves its results."""
    mesh = _join(coordinator, rank, nprocs, device, backend)
    res = collisions_job(mesh, device, "distributed", int(num_worlds), _fused(fused),
                         int(steps), ckpt)
    np.savez(f"{out}.{mesh.rank}.npz", **res)
    torch.distributed.destroy_process_group()


def rank_state_rows(res, full):
    """The leaves of a rank's saved state that differ from the matching
    rows of ``full`` (the one-process state as numpy), by path."""
    start, stop = res["worlds"]
    want = dict(_flat("", full, {}))
    got = {k[len("state/"):]: v for k, v in res.items() if k.startswith("state/")}
    assert got.keys() == want.keys()
    return [k for k in want if not np.array_equal(got[k], want[k][start:stop])]


# ---------------------------------------------------------------------------
# two ranks sharing one card
# ---------------------------------------------------------------------------

# main_ppo_fantasy_vs's world and learner (chip_smoke.py)
FVS_MAIN = dict(num_dragons=50, num_knights=200, cleanup=True)
PPO_MAIN = dict(epochs=2, num_minibatches=2, normalize_obs=True)


def fvs_train_step(device, num_worlds, mesh=None):
    """The first train step from seed 0 of main_ppo_fantasy_vs's learner on
    fantasy_vs at ``num_worlds`` worlds in all (with a mesh: this rank's
    share of them, its state from ``shard_state``): ``learner_result`` with
    the parameters it started from ("start")."""
    genv = fvs.make_rl_env(fvs.FantasyVsConfig(num_worlds=num_worlds, **FVS_MAIN),
                           device=device)
    state = genv[0].state
    env = genv
    if mesh is not None:
        env = fvs.make_rl_env(fvs.FantasyVsConfig(num_worlds=num_worlds // mesh.world_size,
                                                  **FVS_MAIN), device=device)
        state = pm.shard_state(state, mesh)
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = env
    learner = pl.PPOLearner(pl.PPOConfig(obs_dim=obs_dim, act_dim=act_dim, **PPO_MAIN),
                            sim.graph.step, obs_fn, inject_fn, reward_fn, seed=0,
                            device=device, mesh=mesh)
    start = {k: v.cpu().numpy().copy() for k, v in learner.params.items()}
    _, loss, rew = learner.train_step(state)
    return dict(learner_result(loss, rew, learner), start=start)


def shared_card_worker(coordinator, rank, nprocs, out, fvs_worlds, col_worlds, steps,
                       device="cuda:0", backend="gloo"):
    """Ranks that share one card (gloo: NCCL takes one card a rank): the
    first PPO train step of ``fvs_train_step`` at ``fvs_worlds`` worlds in
    all ("learner/..."), then the main path's collisions at ``col_worlds``
    worlds with kernel 1 for ``steps`` steps (``collisions_job``)."""
    mesh = _join(coordinator, rank, nprocs, device, backend)
    res = _flat("learner/", fvs_train_step(device, int(fvs_worlds), mesh), {})
    torch.cuda.empty_cache()
    res.update(collisions_job(mesh, device, "main", int(col_worlds), True, int(steps)))
    np.savez(f"{out}.{mesh.rank}.npz", **res)
    print(json.dumps({"rank": mesh.rank, "checksum": float(res["checksum"][0]),
                      "launches": int(res["launches"])}), flush=True)
    torch.distributed.destroy_process_group()
