"""The fantasy_vs slice of the PyTorch port: against the JAX package, the
reference binary's golden, and invariants of its random path.

The port's random draws come from its own generator, so parity runs
through scripted replay: both sides take the same decision tables and are
compared leaf by leaf every tick.  Tolerances are the golden's
(tests/test_reference_golden.py:557-596): masks, handles, id tables and
arrows exact; hp and mana atol 1e-3; remaining action time atol 1e-4;
positions atol 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.models import fantasy_vs as jfvs
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# the constants fvs_job_5d9k120t.bin was generated with (argv 5..8)
GOLDEN_CONSTANTS = {"ARROW_DAMAGE": 350.0, "CAST_DAMAGE": 60.0, "CAST_RADIUS": 8.0,
                    "CAST_COST": 5.0}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def tolerance(path):
    if "Health" in path or "Mana" in path:
        return 1e-3
    if "Action" in path:
        return 1e-4
    if "FvsPosition" in path:
        return 1e-5
    return 0.0


def assert_states_match(jstate, pstate, where):
    jl = dict(leaves(jax.tree_util.tree_map(np.asarray, jstate)))
    pl = dict(leaves(state_to_numpy(pstate)))
    jl.pop(("rng",))
    pl.pop(("rng",))
    assert jl.keys() == pl.keys(), where
    for path, want in jl.items():
        got = pl[path]
        assert got.dtype == want.dtype and got.shape == want.shape, (where, path)
        tol = tolerance(path)
        if tol:
            np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=f"{where} {path}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {path}")


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


def patch_constants(monkeypatch, *modules):
    for mod in modules:
        for name, value in GOLDEN_CONSTANTS.items():
            monkeypatch.setattr(mod, name, value)


def test_scripted_replay_matches_jax(monkeypatch):
    """Both sides replay one script for 30 ticks, 6 past the table's end
    (the clamped tick index), with damage high enough for churn; every
    leaf but rng compared every tick."""
    patch_constants(monkeypatch, jfvs, fvs)
    nd, nk, T = 5, 9, 24
    script = random_script(3, nd, nk, T)
    kw = dict(num_worlds=2, num_dragons=nd, num_knights=nk, seed=0, scripted=True,
              replicate_clamp_bug=True)
    jsim = jfvs.make_executor(jfvs.FantasyVsConfig(**kw), init_data=script, donate=False)
    psim = fvs.make_executor(fvs.FantasyVsConfig(**kw), init_data=script, device="cpu")
    assert_states_match(jsim.state, psim.state, "init")
    for t in range(T + 6):
        jsim.step()
        psim.step()
        assert_states_match(jsim.state, psim.state, f"tick {t + 1}")
    alive = psim.mgr.num_rows(psim.state, fvs.Knight)
    assert (alive < nk).all()  # the run churned


def test_scripted_tick_index_is_clamped_not_failing():
    """Pinned reference-port behaviour (ROADMAP Queue 3): a scripted run
    past the end of its tables replays their last row instead of failing
    (fantasy_vs.py:208, :253, :337 of the JAX package)."""
    nd, nk, T, extra = 4, 6, 3, 4
    short = random_script(11, nd, nk, T)
    long = {k: (np.concatenate([v] + [v[-1:]] * extra) if k in
                ("d_act", "k_act", "cast_target", "archer_target") else v)
            for k, v in short.items()}
    kw = dict(num_worlds=1, num_dragons=nd, num_knights=nk, scripted=True)
    a = fvs.make_executor(fvs.FantasyVsConfig(**kw), init_data=short, device="cpu")
    b = fvs.make_executor(fvs.FantasyVsConfig(**kw), init_data=long, device="cpu")
    for _ in range(T + extra):
        a.step()
        b.step()
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for (path, x), (_, y) in zip(leaves(sa["arch"]), leaves(sb["arch"])):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


# -- the reference binary's golden, through the port alone ------------------

_M64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _key(domain, tick, idx, ch):
    return _splitmix64(((domain << 56) | (tick << 32) | (idx << 8) | ch) & _M64)


def _u01(domain, tick, idx, ch):
    return np.float32(_key(domain, tick, idx, ch) >> 40) / np.float32(16777216.0)


def load_fvs_golden(name="fvs_job_5d9k120t"):
    """tests/goldens/fvs_job_5d9k120t.bin: the reference JobManager running
    fvs.cpp (per tick: masks, hp, mana, action, positions, arrows, the
    knights' target rows)."""
    with open(os.path.join(GOLDEN_DIR, name + ".bin"), "rb") as f:
        d = f.read()
    assert d[:4] == b"FVSG"
    tp1, nd, nk, _ = np.frombuffer(d[4:20], np.int32)
    fields = (("d_alive", nd, np.int32), ("d_hp", nd, np.float32), ("d_mp", nd, np.float32),
              ("d_act", nd, np.float32), ("d_pos", nd * 3, np.float32),
              ("k_alive", nk, np.int32), ("k_hp", nk, np.float32),
              ("k_arrows", nk, np.int32), ("k_act", nk, np.float32),
              ("k_pos", nk * 3, np.float32), ("k_target", nk, np.int32))
    off, out = 20, []
    for _ in range(tp1):
        rec = {}
        for key, n, dt in fields:
            rec[key] = np.frombuffer(d[off:off + 4 * n], dt).copy()
            off += 4 * n
        rec["d_pos"] = rec["d_pos"].reshape(nd, 3)
        rec["k_pos"] = rec["k_pos"].reshape(nk, 3)
        out.append(rec)
    assert off == len(d)
    return out, int(nd), int(nk)


def golden_script(dump, nd, nk):
    """The binary's splitmix64 draws (domains in fvs_main.cpp) as tables."""
    T = len(dump) - 1
    lo, hi = np.array(fvs.BOUNDS_LO, np.float32), np.array(fvs.BOUNDS_HI, np.float32)
    span = hi - lo

    def posdraw(domain, tick, idx):
        return np.array([lo[c] + span[c] * _u01(domain, tick, idx, c) for c in range(3)],
                        np.float32)

    def act_tab(domain, n):
        tab = np.zeros((T, n, 4), np.float32)
        for t in range(T):
            for i in range(n):
                tab[t, i, 0] = _u01(domain, t, i, 0)
                for c in range(3):
                    tab[t, i, 1 + c] = np.float32(2.0) * _u01(domain, t, i, 1 + c) - np.float32(1.0)
        return tab

    return {
        "d_pos": np.stack([posdraw(0, 0, i) for i in range(nd)]),
        "d_mana": np.array([np.float32(50.0) * _u01(0, 0, i, 3) for i in range(nd)], np.float32),
        "k_pos": np.stack([posdraw(1, 0, i) for i in range(nk)]),
        "k_arrows": np.array([20 + _key(1, 0, i, 3) % 21 for i in range(nk)], np.int32),
        "d_act": act_tab(2, nd), "k_act": act_tab(3, nk),
        "cast_target": np.stack([np.stack([posdraw(4, t, i) for i in range(nd)])
                                 for t in range(T)]),
        "archer_target": np.stack([dump[t + 1]["k_target"] for t in range(T)]),
    }


def test_golden_fvs_job_system(monkeypatch):
    """The port's scripted replay against the reference JobManager's run:
    masks and arrows exact, hp/mana/action/positions within the golden's
    tolerances, every tick; at least one death."""
    patch_constants(monkeypatch, fvs)
    dump, nd, nk = load_fvs_golden()
    cfg = fvs.FantasyVsConfig(num_worlds=2, num_dragons=nd, num_knights=nk, seed=0,
                              scripted=True, replicate_clamp_bug=True)
    sim = fvs.make_executor(cfg, init_data=golden_script(dump, nd, nk), device="cpu")
    mgr = sim.mgr

    def grab(arch, comp, field=None):
        v = mgr.column(sim.state, arch, comp)
        return (v if field is None else v[field]).numpy()

    np.testing.assert_allclose(grab(fvs.Dragon, fvs.Position)[0], dump[0]["d_pos"], atol=1e-6)
    np.testing.assert_array_equal(grab(fvs.Knight, fvs.Quiver, "arrows")[0], dump[0]["k_arrows"])
    churned = False
    for t in range(len(dump) - 1):
        sim.step()
        ref = dump[t + 1]
        live_d, live_k = ref["d_alive"] > 0, ref["k_alive"] > 0
        churned |= not (live_d.all() and live_k.all())
        checks = (
            (mgr.row_mask(sim.state, fvs.Dragon).numpy(), live_d, None, 0),
            (mgr.row_mask(sim.state, fvs.Knight).numpy(), live_k, None, 0),
            (grab(fvs.Knight, fvs.Quiver, "arrows"), ref["k_arrows"], live_k, 0),
            (grab(fvs.Dragon, fvs.Health, "hp"), ref["d_hp"], live_d, 1e-3),
            (grab(fvs.Knight, fvs.Health, "hp"), ref["k_hp"], live_k, 1e-3),
            (grab(fvs.Dragon, fvs.Mana, "mp"), ref["d_mp"], live_d, 1e-3),
            (grab(fvs.Dragon, fvs.Action, "remaining"), ref["d_act"], live_d, 1e-4),
            (grab(fvs.Knight, fvs.Action, "remaining"), ref["k_act"], live_k, 1e-4),
            (grab(fvs.Dragon, fvs.Position), ref["d_pos"], live_d, 1e-5),
            (grab(fvs.Knight, fvs.Position), ref["k_pos"], live_k, 1e-5),
        )
        for i, (got, want, live, atol) in enumerate(checks):
            for w in range(2):  # the same tables: identical worlds
                g = got[w] if live is None else got[w][live]
                e = want if live is None else want[live]
                np.testing.assert_allclose(g, e, atol=atol, rtol=0, err_msg=f"t={t} check {i}")
    assert churned, "no entity died"


# -- the random path: invariants --------------------------------------------


def small_cfg(**kw):
    d = dict(num_worlds=4, num_dragons=5, num_knights=12, seed=7)
    d.update(kw)
    return fvs.FantasyVsConfig(**d)


def test_init_counts_and_values():
    sim = fvs.make_executor(small_cfg(), device="cpu")
    mgr = sim.mgr
    assert (mgr.num_rows(sim.state, fvs.Dragon) == 5).all()
    assert (mgr.num_rows(sim.state, fvs.Knight) == 12).all()
    assert (mgr.column(sim.state, fvs.Dragon, fvs.Health)["hp"] == 1000).all()
    arrows = mgr.column(sim.state, fvs.Knight, fvs.Quiver)["arrows"]
    assert arrows.dtype == torch.int32 and (arrows >= 20).all() and (arrows <= 40).all()
    pos = mgr.column(sim.state, fvs.Knight, fvs.Position)
    assert (pos >= torch.tensor(fvs.BOUNDS_LO)).all() and (pos < torch.tensor(fvs.BOUNDS_HI)).all()


def test_determinism_per_seed_and_worlds_differ():
    a = fvs.make_executor(small_cfg(), device="cpu")
    b = fvs.make_executor(small_cfg(), device="cpu")
    c = fvs.make_executor(small_cfg(seed=8), device="cpu")
    for s in (a, b, c):
        s.run(25)
    sa, sb, sc = (state_to_numpy(s.state) for s in (a, b, c))
    for (path, x), (_, y) in zip(leaves(sa), leaves(sb)):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    pa, pc = a.get_exported(0)[0], c.get_exported(0)[0]
    assert not torch.equal(pa, pc)
    assert not torch.equal(pa[0], pa[1])


def test_hp_never_rises_and_arrows_fall_by_the_shots(monkeypatch):
    """No casting (CAST_COST out of reach), no cleanup: every arrow spent
    takes exactly ARROW_DAMAGE from a live dragon, and no hp rises."""
    monkeypatch.setattr(fvs, "CAST_COST", 1e9)
    sim = fvs.make_executor(small_cfg(cleanup=False), device="cpu")
    mgr = sim.mgr
    shots = 0
    for _ in range(40):
        hp0 = mgr.column(sim.state, fvs.Dragon, fvs.Health)["hp"]
        k_hp0 = mgr.column(sim.state, fvs.Knight, fvs.Health)["hp"]
        arrows0 = mgr.column(sim.state, fvs.Knight, fvs.Quiver)["arrows"]
        sim.step()
        hp1 = mgr.column(sim.state, fvs.Dragon, fvs.Health)["hp"]
        spent = arrows0 - mgr.column(sim.state, fvs.Knight, fvs.Quiver)["arrows"]
        assert ((spent == 0) | (spent == 1)).all()
        assert (hp1 <= hp0).all()
        assert (mgr.column(sim.state, fvs.Knight, fvs.Health)["hp"] <= k_hp0).all()
        torch.testing.assert_close((hp0 - hp1).sum(dim=1),
                                   fvs.ARROW_DAMAGE * spent.sum(dim=1).float())
        shots += int(spent.sum())
    assert shots > 0


def test_cleanup_live_counts_never_rise(monkeypatch):
    patch_constants(monkeypatch, fvs)
    sim = fvs.make_executor(small_cfg(), device="cpu")
    mgr = sim.mgr
    prev = [mgr.num_rows(sim.state, a) for a in (fvs.Dragon, fvs.Knight)]
    for _ in range(60):
        sim.step()
        now = [mgr.num_rows(sim.state, a) for a in (fvs.Dragon, fvs.Knight)]
        assert all((n <= p).all() for n, p in zip(now, prev))
        for arch in (fvs.Dragon, fvs.Knight):
            hp = mgr.column(sim.state, arch, fvs.Health)["hp"]
            assert (hp[mgr.row_mask(sim.state, arch)] > 0).all()
        assert (mgr.num_rows(sim.state, fvs.CleanupTracker) == 0).all()
        prev = now
    assert (prev[1] < 12).any()  # someone died
    assert all((v == 0).all() for v in sim.overflow_counters().values())


def test_cleanup_destroys_and_invalidates_handles():
    sim = fvs.make_executor(small_cfg(num_dragons=8, num_knights=30), device="cpu")
    mgr = sim.mgr
    hp = mgr.column(sim.state, fvs.Dragon, fvs.Health)["hp"].clone()
    hp[:, :3] = 0.0
    sim.state = mgr.set_column(sim.state, fvs.Dragon, fvs.Health, {"hp": hp})
    dead = mgr.entity_column(sim.state, fvs.Dragon)[:, :3]
    sim.step()
    assert (mgr.num_rows(sim.state, fvs.Dragon) == 5).all()
    assert not mgr.lookup(sim.state, dead)[2].any()


def test_no_deaths_without_cleanup(monkeypatch):
    patch_constants(monkeypatch, fvs)
    sim = fvs.make_executor(small_cfg(cleanup=False), device="cpu")
    sim.run(60)
    assert (sim.mgr.num_rows(sim.state, fvs.Knight) == 12).all()
    assert (sim.mgr.num_rows(sim.state, fvs.Dragon) == 5).all()
    k_hp = sim.mgr.column(sim.state, fvs.Knight, fvs.Health)["hp"]
    assert (k_hp <= 0).any()  # dead by hp, yet not destroyed
    assert sim.graph.node_names == ["action_select", "caster", "archer"]


def test_gram_caster_matches_subtract(monkeypatch):
    """GEM_TPU_FVS_GRAM=1 (read when the graph is built) takes the AoE
    distances from the centred Gram form; from one seed it makes the same
    hits as the default subtract form."""
    patch_constants(monkeypatch, fvs)
    runs = {}
    for gram in ("0", "1"):
        monkeypatch.setenv("GEM_TPU_FVS_GRAM", gram)
        sim = fvs.make_executor(small_cfg(), device="cpu")
        sim.run(30)
        runs[gram] = state_to_numpy(sim.state)
    for (path, x), (_, y) in zip(leaves(runs["0"]), leaves(runs["1"])):
        np.testing.assert_allclose(x, y, atol=tolerance(path), rtol=0, err_msg=str(path))


def test_rl_env():
    cfg = small_cfg(num_worlds=3)
    sim, obs_fn, inject_fn, reward_fn, obs_dim, act_dim = fvs.make_rl_env(cfg, device="cpu")
    assert (obs_dim, act_dim) == (5 * 5 + 12 * 5, 12 * 3)
    assert sim.graph.node_names[0] == "apply_knight_actions"
    obs = obs_fn(sim.state)
    assert obs.shape == (3, obs_dim) and torch.isfinite(obs).all()
    total = torch.zeros(3)
    for _ in range(20):
        prev = sim.state
        sim.state = inject_fn(sim.state, torch.ones(3, act_dim))
        sim.step()
        r = reward_fn(prev, sim.state)
        assert r.shape == (3,) and (r >= 0).all()  # damage dealt, never negative
        total += r
    assert (total > 0).all()
    k_pos = sim.mgr.column(sim.state, fvs.Knight, fvs.Position)
    assert (k_pos <= torch.tensor(fvs.BOUNDS_HI)).all()
