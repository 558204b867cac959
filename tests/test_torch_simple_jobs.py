"""The simple_jobs slice of the PyTorch port against the JAX package.

The JAX executor's state is converted leaf by leaf into the port's
(interop.state_from_numpy), both step, and every leaf but ``rng`` is
compared.  Tolerances: integer buffers and counters exact; translation
atol 1e-4 on the 4-node path (tests/test_ops.py:94-111) and 1e-3 on the
fused path (tests/test_simple_jobs.py:136-153, the Pallas kernel sums its
push in another order); AABBs carry the positions' drift (1e-4) plus
their own arithmetic (1e-5); contact normals atol 1e-5.  The port runs on
the CPU, so its fused path runs the kernel's plain version; the JAX
package's fused path runs its Pallas kernel in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.models import simple_jobs as jsj
from gpu_ecs_madrona_tpu.ops import simple_jobs_kernel as jk
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk

import test_torch_simple_jobs_cases as cases

W, N, K, SEED = 4, 24, 128, 5


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_states_match(jstate, pstate, pos_atol, where=""):
    jl = dict(leaves(jax.tree_util.tree_map(np.asarray, jstate)))
    pl = dict(leaves(state_to_numpy(pstate)))
    jl.pop(("rng",))
    pl.pop(("rng",))
    assert jl.keys() == pl.keys(), where
    tol = {("user", "translation"): pos_atol,
           ("user", "aabb_lo"): pos_atol + 1e-5, ("user", "aabb_hi"): pos_atol + 1e-5,
           ("user", "contacts_normal"): 1e-5}
    for path, want in jl.items():
        got = pl[path]
        assert got.dtype == want.dtype and got.shape == want.shape, (where, path)
        if path in tol:
            np.testing.assert_allclose(got, want, atol=tol[path], rtol=0,
                                       err_msg=f"{where} {path}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{where} {path}")


def converted(jsim):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")


def cfgs(**kw):
    d = dict(num_worlds=W, num_objects=N, max_pairs=K, seed=SEED)
    d.update(kw)
    return jsj.SimpleJobsConfig(**d), sj.SimpleJobsConfig(**d)


@pytest.mark.parametrize("mode", sj.COMPACT_MODES)
def test_xla_path_matches_jax(monkeypatch, mode):
    """fused=False, each GEM_SJ_COMPACT mode: five steps from the same
    state, every leaf compared (candidates, their tails included, exact)."""
    monkeypatch.setenv("GEM_SJ_COMPACT", mode)
    jcfg, pcfg = cfgs(fused=False)
    jsim = jsj.make_executor(jcfg, donate=False)
    psim = sj.make_executor(pcfg, device="cpu")
    psim.state = converted(jsim)
    seen = 0
    for t in range(5):
        jsim.step()
        psim.step()
        assert_states_match(jsim.state, psim.state, 1e-4, f"{mode} step {t + 1}")
        seen += int((np.asarray(jsim.state["user"]["contacts_ab"]) != 0).any(-1).sum())
    assert seen > 0  # the buffers held pairs


def test_fused_matches_jax_interpret():
    """fused=True: the plain kernel version against the Pallas kernel in
    interpret mode, with a degree cap that binds (D=8)."""
    jcfg, pcfg = cfgs(degree_cap=8, fused=True)
    jsim = jsj.make_executor(jcfg, donate=False)
    psim = sj.make_executor(pcfg, device="cpu")
    psim.state = converted(jsim)
    assert psim.graph.node_names == ["fused_step"]
    for t in range(4):
        jsim.step()
        psim.step()
        assert_states_match(jsim.state, psim.state, 1e-3, f"fused step {t + 1}")
    got = psim.state["user"]
    assert torch.equal(got["candidates"], got["contacts_ab"])
    assert sk.fused_simple_jobs_step.launches == 0  # plain on the CPU


BOUNDS = (sj.BOUNDS_LO, sj.BOUNDS_HI)
KERNEL_CASES = {
    # name: (inputs, K, D); cubes around (0, 0, 5)
    "degree_cap": (lambda: cases.bodies(0, 3, 37, 6.0), 128, 4),    # dropped > 0, n0 % 32 != 0
    "k_truncation": (lambda: cases.bodies(2, 2, 40, 3.0), 64, 8),   # total > K: slots cut
    "no_cap": (lambda: cases.bodies(1, 2, 24, 10.0), 128, 24),
    # AABBs meeting on closed slabs: every lattice neighbour pair on the tie
    "touching_grid": (lambda: cases.touching_grid(4, 4, 4, 2), 512, 26),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_plain_matches_jax_interpret(case):
    make, k, D = KERNEL_CASES[case]
    pos, rot = make()
    n0 = pos.shape[1]
    want = [np.asarray(x) for x in jk.fused_simple_jobs_step(
        pos, rot, n0=n0, K=k, degree_cap=D, bounds=BOUNDS, interpret=True)]
    got = [x.numpy() for x in sk.fused_simple_jobs_step(
        torch.from_numpy(pos), torch.from_numpy(rot), n0=n0, K=k, degree_cap=D,
        bounds=BOUNDS)]
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "lo": 1e-5, "hi": 1e-5, "normals": 1e-5}
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in atol:
            np.testing.assert_allclose(g, w, atol=atol[name], rtol=0, err_msg=name)
            assert np.isfinite(g).all(), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    counts, dropped = want[5], want[6]
    if case == "degree_cap":
        assert (dropped > 0).all()
    if case == "k_truncation":
        assert (counts > k).all()
        assert (got[3].any(-1)).all()  # every slot of every world filled
    if case == "touching_grid":
        # world 0's lattice is exact in half precision: every tie is kept
        d = np.abs(pos[0, :, None] - pos[0, None]).max(-1)
        assert counts[0] == ((d <= 2.0) & (d > 0)).sum()


def test_kernel_wrapper_rejects_bad_shapes():
    """A pos that does not hold n0 bodies and n0 = 0 are refused; past the
    one-block layout's MAX_BODIES the wrapper takes the shape (on the CPU
    its plain version) as the JAX kernel does."""
    pos, rot = cases.bodies(0, 1, 8, 3.0)
    pos, rot = torch.from_numpy(pos), torch.from_numpy(rot)
    with pytest.raises(ValueError, match="n0"):
        sk.fused_simple_jobs_step(pos, rot, n0=9, K=16, degree_cap=4, bounds=BOUNDS)
    with pytest.raises(ValueError, match="at least 1"):
        sk.fused_simple_jobs_step(pos[:, :0], rot[:, :0], n0=0, K=16, degree_cap=4,
                                  bounds=BOUNDS)
    n0 = sk.MAX_BODIES + 1
    big, brot = (torch.from_numpy(a) for a in cases.bodies(3, 1, n0, 10.0))
    out = sk.fused_simple_jobs_step(big, brot, n0=n0, K=16, degree_cap=4, bounds=BOUNDS)
    assert [tuple(t.shape) for t in out] == [(1, n0, 3)] * 3 + [(1, 16, 2), (1, 16, 3), (1,),
                                                                  (1,)]
    assert int(out[5][0]) > 16 and int(out[6][0]) > 0   # slots cut, pairs dropped


# -- behaviour (tests/test_simple_jobs.py, on the port) ----------------------


FUSED = pytest.mark.parametrize("fused", [False, True], ids=["xla", "fused"])


def small_cfg(fused, **kw):
    d = dict(num_worlds=4, num_objects=12, max_pairs=256, seed=5, fused=fused)
    d.update(kw)
    return sj.SimpleJobsConfig(**d)


def set_bodies(sim, pos, rot=None):
    d = dict(sim.state["user"])
    d["translation"] = torch.tensor(pos, dtype=torch.float32)
    n = d["translation"].shape[1]
    d["rotation"] = (torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(1, n, 4).clone()
                     if rot is None else rot)
    state = dict(sim.state)
    state["user"] = d
    sim.state = state


@FUSED
def test_clamp_and_aabb(fused):
    sim = sj.make_executor(small_cfg(fused), device="cpu")
    sim.step()
    d = sim.state["user"]
    assert (d["translation"] >= torch.tensor(sj.BOUNDS_LO) - 2.1).all()
    half = (d["aabb_hi"] - d["aabb_lo"]) / 2
    # a rotated unit cube's AABB half-extent lies in [1, sqrt(3)] per axis
    assert (half >= 1.0 - 1e-5).all() and (half <= 3 ** 0.5 + 1e-5).all()


@FUSED
def test_counters_reset_each_tick(fused):
    sim = sj.make_executor(small_cfg(fused), device="cpu")
    sim.run(3)
    d = sim.state["user"]
    assert (d["num_candidates"] == 0).all() and (d["num_contacts"] == 0).all()


@FUSED
def test_overlap_pushes_apart(fused):
    sim = sj.make_executor(small_cfg(fused, num_worlds=1, num_objects=2), device="cpu")
    set_bodies(sim, [[[0.0, 0.0, 5.0], [1.0, 0.0, 5.0]]])
    sim.step()
    pos = sim.state["user"]["translation"].numpy()
    np.testing.assert_allclose(pos[0, 0], [-2.0, 0.0, 5.0], atol=1e-5)
    np.testing.assert_allclose(pos[0, 1], [3.0, 0.0, 5.0], atol=1e-5)
    ab = sim.state["user"]["contacts_ab"][0].tolist()
    assert ab[:2] == [[0, 1], [1, 0]] and not any(map(any, ab[2:]))


@FUSED
def test_determinism_and_divergence(fused):
    a = sj.make_executor(small_cfg(fused), device="cpu")
    b = sj.make_executor(small_cfg(fused), device="cpu")
    a.run(10)
    b.run(10)
    pa, pb = a.state["user"]["translation"], b.state["user"]["translation"]
    assert torch.equal(pa, pb)
    assert not torch.allclose(pa[0], pa[1])
    assert (a.state["tick"] == 10).all()


def test_parity_with_collisions_example():
    """simple_jobs and collisions push the same physics through different
    state layouts (user buffers vs archetypes): from the same in-bounds
    init, one step agrees."""
    cfg_c = col.CollisionsConfig(num_worlds=2, num_objects=8, max_pairs=256, seed=5,
                                 fused=False)
    col_sim = col.make_executor(cfg_c, device="cpu")
    sj_sim = sj.make_executor(small_cfg(False, num_worlds=2, num_objects=8), device="cpu")
    pos = col_sim.mgr.column(col_sim.state, col.CubeObject, col.Translation)[:, :8]
    rot = col_sim.mgr.column(col_sim.state, col.CubeObject, col.Rotation)[:, :8]
    set_bodies(sj_sim, pos.tolist(), rot.clone())
    sj_sim.run(1)
    col_sim.run(1)
    p_c = col_sim.mgr.column(col_sim.state, col.CubeObject, col.Translation)[:, :8]
    np.testing.assert_allclose(sj_sim.state["user"]["translation"].numpy(), p_c.numpy(),
                               atol=1e-5)


@FUSED
def test_coincident_objects_no_blowup(fused):
    """Two objects clamped into the same bounds corner coincide exactly:
    no push direction (the reference's normalize(0) is NaN), so the pair
    is left out of the push in both paths; its normal is 0."""
    sim = sj.make_executor(small_cfg(fused, num_worlds=1, num_objects=3), device="cpu")
    set_bodies(sim, [[[-99.0, -99.0, -5.0], [-88.0, -77.0, -9.0], [-9.5, -9.5, 0.5]]])
    sim.run(3)
    pos = sim.state["user"]["translation"]
    assert torch.isfinite(pos).all() and pos.abs().max() < 50
    assert torch.isfinite(sim.state["user"]["contacts_normal"]).all()


@FUSED
def test_degree_cap_check_under_debug(fused, monkeypatch, capsys):
    """With GEM_TPU_DEBUG's flag on, a step that drops pairs at the degree
    cap prints the check's failure; with it off the fused node evaluates no
    predicate (its launch is its only device op)."""
    from gpu_ecs_madrona_tpu_torch.utils import debug
    cfg = small_cfg(fused, num_worlds=1, num_objects=6, degree_cap=2)
    sim = sj.make_executor(cfg, device="cpu")
    set_bodies(sim, [[[0.1 * i, 0.0, 5.0] for i in range(6)]])
    sim.step()
    assert "CHECK FAILED" not in capsys.readouterr().out
    monkeypatch.setattr(debug, "DEBUG", True)
    set_bodies(sim, [[[0.1 * i, 0.0, 5.0] for i in range(6)]])
    sim.step()
    assert "degree cap" in capsys.readouterr().out


def test_fused_default_follows_device():
    """fused=None is the 4-node path on the CPU (the kernel on the card, at
    every body count); fused=True builds the kernel's node past the
    one-block layout's MAX_BODIES too, and refuses no body count >= 1."""
    sim = sj.make_executor(small_cfg(None), device="cpu")
    assert sim.graph.node_names == ["preprocess", "broadphase", "narrowphase", "solver"]
    sim = sj.make_executor(small_cfg(None, num_objects=sk.MAX_BODIES + 1, num_worlds=1),
                           device="cpu")
    assert sim.graph.node_names == ["preprocess", "broadphase", "narrowphase", "solver"]
    sim = sj.make_executor(small_cfg(True, num_objects=sk.MAX_BODIES + 1, num_worlds=1),
                           device="cpu")
    assert sim.graph.node_names == ["fused_step"]
    with pytest.raises(ValueError, match="at least 1"):
        sj.make_executor(small_cfg(True, num_objects=0, num_worlds=1), device="cpu")
