"""The fused substep kernel's options in the port against the JAX package
(CPU): the in-kernel broadphase (TPU kernel 8), the manifold cache and its
refresh, world sleep and persistent manifolds (TPU kernel 9).

  - ``inkernel_broadphase_plain`` against JAX's ``_inkernel_broadphase``
    (pure jnp, run outside Pallas) on a seeded pile of 2 worlds x 21 rows
    with a dead row in the middle, degree caps 12 and 2 (2 drops pairs),
    inflation 0 and 0.025: rows, kvalid, count and dropped exact, AABBs
    atol 1e-5;
  - ``pairs.cache_contacts`` / ``refresh_contacts`` against JAX's on a
    pile's contacts, atol 1e-5, and the cache's pack / parse round trip
    exact;
  - ``FusedSubstepKernel`` (its plain version here) against JAX's in
    interpret mode with ``wt=1`` (the port's one CTA a world): the
    broadphase with refresh; refresh with given rows at K = 256 (the
    chunked TPU route); persistence with the broadphase, refresh and sleep
    on 4 worlds over both calls of a cache's life (built, then reused),
    the second call covering stable x active in {0, 1}^2.  Pose and
    stashes atol 1e-4, velocities atol 1e-3, integers exact, the cache
    and AABBs atol 1e-4;
  - the JAX kernel's world-block dependence (an asleep world in a block
    with an awake one is rebuilt when it is not stable), which the port,
    one world a block, does not have.
Each JAX kernel call compiles for 20-50 s here, so the calls sit in
module fixtures, one compile each, at 1-2 substeps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu.ops import substep_kernel as jsk
from gpu_ecs_madrona_tpu.physics import pairs as jpk

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk

BODY_ARGS = ("pos", "rot", "v", "w", "im", "ii", "mu_s", "mu_d", "obj", "ext_f", "ext_t", "dyn",
             "h", "gravity", "restitution_threshold")
ROW_ARGS = ("rows_i", "rows_j", "kvalid")
POSE_KEYS = ("pos", "rot", "prev_pos", "prev_rot", "ps_pos", "ps_rot")
INT_KEYS = ("rows_i", "rows_j", "kvalid", "bp_count", "bp_dropped")


def pile(num_worlds=2, K=128, steps=5, seed=0):
    """The fused kernel's inputs (numpy) on a settling rigid_bench pile of
    boxes and spheres (the port's plain version, ``steps`` steps in), its
    dense broadphase's candidate rows at capacity K included."""
    sim = rb.make_executor(rb.RigidBenchConfig(
        num_worlds=num_worlds, num_bodies=20, spawn_xy=3.0, spawn_h=4.0, seed=seed,
        contact_mode="pallas", max_candidates=K), device="cpu")
    sim.run(steps)
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body,
                                                             rb.RigidBenchWorld.objmgr)
    return {k: v.numpy() for k, v in kw.items()}


def run_jax(kern, args):
    out = kern(**{k: jnp.asarray(v) for k, v in args.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(kern, args):
    sk.FusedSubstepKernel.launches = 0
    out = kern(**{k: torch.from_numpy(np.array(v)) for k, v in args.items()})
    assert sk.FusedSubstepKernel.launches == 0          # CPU: the plain version
    return {k: v.numpy() for k, v in out.items()}


def assert_outputs_match(got, want, worlds=slice(None)):
    """Integers exact, poses, stashes, AABBs and the cache atol 1e-4,
    velocities 1e-3.  The cache's ok flag is a compare of a depth with 0:
    where a slot's deepest cached depth is within 1e-5 of 0 in either
    package (a rounding tie), either flag is accepted."""
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k][worlds], w[worlds]
        assert g.shape == w.shape, k
        if k in INT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert np.isfinite(g).all(), k
        if k == "mcache":
            tie = np.minimum(np.abs(g[:, sk.MC_DEPTH0]), np.abs(w[:, sk.MC_DEPTH0])) < 1e-5
            g = g.copy()
            g[:, sk.MC_OK] = np.where(tie, w[:, sk.MC_OK], g[:, sk.MC_OK])
        atol = 1e-4 if k in POSE_KEYS or k in ("aabb_lo", "aabb_hi", "mcache") else 1e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def pile2():
    return pile(steps=15)


# -- (a) the in-kernel broadphase ----------------------------------------------


@pytest.mark.parametrize("D", [12, 2])
@pytest.mark.parametrize("inflate", [0.0, 0.025])
def test_inkernel_broadphase_matches_jax(pile2, D, inflate):
    W, n = pile2["im"].shape
    K = 128
    rng = np.random.default_rng(1)
    scale = rng.uniform(0.8, 1.2, (W, n, 3)).astype(np.float32)
    live = np.ones((W, n), bool)
    live[:, n // 2] = False                          # a dead row in the middle
    dtv = np.asarray([1 / 60, 1 / 30], np.float32)
    packed = np.zeros((W, sk.FC_IN, n), np.float32)
    packed[:, sk.F_POS:sk.F_POS + 3] = pile2["pos"].transpose(0, 2, 1)
    packed[:, sk.F_ROT:sk.F_ROT + 4] = pile2["rot"].transpose(0, 2, 1)
    packed[:, sk.F_V:sk.F_V + 3] = pile2["v"].transpose(0, 2, 1)
    packed[:, sk.F_OBJ] = pile2["obj"]
    packed[:, sk.F_SCALE:sk.F_SCALE + 3] = scale.transpose(0, 2, 1)
    packed[:, sk.F_LIVE] = live
    om = rb.default_object_manager()
    ri, rj, kv, lo3, hi3, st = (np.asarray(x) for x in jsk._inkernel_broadphase(
        jpk.ObjTables(om), W, n, K, D, jnp.asarray(packed), jnp.asarray(dtv[:, None]),
        inflate=inflate))
    t = {k: torch.from_numpy(pile2[k]) for k in ("pos", "rot", "v", "obj")}
    got = sk.inkernel_broadphase_plain(
        t["pos"], t["rot"], t["v"], torch.from_numpy(scale), torch.from_numpy(live), t["obj"],
        torch.from_numpy(dtv), tables=pk.ObjTables(om), K=K, D=D, inflate=inflate)
    np.testing.assert_array_equal(got["rows_i"].numpy(), ri[:, 0].astype(np.int32))
    np.testing.assert_array_equal(got["rows_j"].numpy(), rj[:, 0].astype(np.int32))
    np.testing.assert_array_equal(got["kvalid"].numpy(), kv[:, 0] > 0.5)
    np.testing.assert_array_equal(got["bp_count"].numpy(), st[:, 0, 0].astype(np.int32))
    np.testing.assert_array_equal(got["bp_dropped"].numpy(), st[:, 0, 1].astype(np.int32))
    np.testing.assert_allclose(got["aabb_lo"].numpy(), lo3.transpose(0, 2, 1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["aabb_hi"].numpy(), hi3.transpose(0, 2, 1), rtol=0, atol=1e-5)
    # the pile overlaps, the dead row takes no part, and the tight cap drops
    assert (got["bp_count"] + got["bp_dropped"] > 10).all()
    rows = torch.cat([got["rows_i"][got["kvalid"]], got["rows_j"][got["kvalid"]]])
    assert not (rows == n // 2).any()
    assert (int(got["bp_dropped"].sum()) > 0) == (D == 2)


# -- (b) the manifold cache ----------------------------------------------------


def pair_sides(kw, lib, shift=0.0, turn=0.0):
    """Pair sides (pos, rot) of the pile's candidate slots, the bodies moved
    by ``shift`` and turned by ``turn`` radians about a fixed axis."""
    W, n = kw["im"].shape
    axis = np.asarray([0.3, -0.5, 0.8], np.float32)
    axis /= np.linalg.norm(axis)
    dq = np.concatenate([[np.cos(turn / 2)], np.sin(turn / 2) * axis]).astype(np.float32)
    rot = kw["rot"].copy()
    w0, v0 = rot[..., :1], rot[..., 1:]
    rot = np.concatenate([dq[0] * w0 - v0 @ dq[1:, None],
                          dq[0] * v0 + w0 * dq[1:] + np.cross(dq[1:], v0)], -1)
    pos = kw["pos"] + np.float32(shift) * np.asarray([1.0, -0.5, 0.25], np.float32)

    def side(rows):
        p = np.take_along_axis(pos, rows[..., None].astype(np.int64), 1)
        r = np.take_along_axis(rot, rows[..., None].astype(np.int64), 1)
        return {"pos": tuple(lib(p[..., c].copy()) for c in range(3)),
                "rot": tuple(lib(r[..., c].copy()) for c in range(4))}

    return side(kw["rows_i"]), side(kw["rows_j"])


def test_cache_and_refresh_match_jax(pile2):
    kw = pile2
    tables = pk.ObjTables(rb.default_object_manager())
    PA, PB = pair_sides(kw, torch.from_numpy)
    obj = torch.from_numpy(kw["obj"]).long()
    oA = torch.gather(obj, 1, torch.from_numpy(kw["rows_i"]).long())
    oB = torch.gather(obj, 1, torch.from_numpy(kw["rows_j"]).long())
    # a speculative margin keeps the resting pairs' near contacts
    contacts = pk.pair_contacts(pk.body_fields(PA["pos"], PA["rot"], oA, tables),
                                pk.body_fields(PB["pos"], PB["rot"], oB, tables),
                                torch.from_numpy(kw["kvalid"]), speculative=0.05)
    assert int((contacts["ok"] & torch.from_numpy(kw["kvalid"])).sum()) >= 4
    cache = pk.cache_contacts(contacts, PA, PB)
    jc = {k: (tuple(jnp.asarray(c.numpy()) for c in v) if isinstance(v, tuple)
              else jnp.asarray(v.numpy())) for k, v in contacts.items()}
    JA, JB = pair_sides(kw, jnp.asarray)
    jcache = jpk.cache_contacts(jc, JA, JB)

    def flat(d):
        return {k: np.stack([np.asarray(c) for c in v]) if isinstance(v, tuple)
                else np.asarray(v) for k, v in d.items()}

    for k, want in flat(jcache).items():
        np.testing.assert_allclose(flat(cache)[k], want, rtol=0, atol=1e-5, err_msg=k)
    # the cache moved with the bodies
    PA2, PB2 = pair_sides(kw, torch.from_numpy, shift=0.01, turn=0.02)
    JA2, JB2 = pair_sides(kw, jnp.asarray, shift=0.01, turn=0.02)
    got = flat(pk.refresh_contacts(cache, PA2, PB2))
    for k, want in flat(jpk.refresh_contacts(jcache, JA2, JB2)).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5, err_msg=k)
    # packed into the persistent cache's channels and back, exactly
    packed = sk._pack_cache(cache)
    assert tuple(packed.shape) == (2, sk.MC_CACHE, kw["rows_i"].shape[1])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jsk._pack_cache(jcache)))
    again = flat(sk._parse_cache(packed))
    for k, want in flat(cache).items():
        np.testing.assert_array_equal(again[k], want, err_msg=k)


# -- (c) FusedSubstepKernel against the interpreted Pallas kernel ---------------


def kernels(om, S, **opts):
    return (jsk.FusedSubstepKernel(om, S, relaxation=0.7, interpret=True, wt=1, **opts),
            sk.FusedSubstepKernel(om, S, relaxation=0.7, **opts))


def bp_args(kw, dtv=1 / 60):
    W, n = kw["im"].shape
    args = {k: kw[k] for k in BODY_ARGS}
    args.update(scale=np.ones((W, n, 3), np.float32), live=np.ones((W, n), bool),
                dtv=np.full((W,), dtv, np.float32))
    return args


def test_bp_refresh_matches_jax(pile2):
    """The broadphase inside the kernel, with contact refresh, 2 substeps."""
    jk, tk = kernels(rb.default_object_manager(), 2, contact_refresh=True, bp_degree=12,
                     bp_capacity=100)
    args = bp_args(pile2)
    want = run_jax(jk, args)
    got = run_port(tk, args)
    assert got["rows_i"].shape == (2, 128)            # 100 slots round up to one tile
    assert_outputs_match(got, want)
    assert (got["bp_count"] >= 10).all()


@pytest.fixture(scope="module")
def pile_k256():
    return pile(K=256, steps=4, seed=3)


def test_refresh_with_rows_k256_matches_jax(pile_k256):
    """Refresh over given rows at K = 256 (JAX's chunked route), 2 substeps."""
    jk, tk = kernels(rb.default_object_manager(), 2, contact_refresh=True)
    args = {k: pile_k256[k] for k in BODY_ARGS + ROW_ARGS}
    assert args["rows_i"].shape[1] == 256
    assert_outputs_match(run_port(tk, args), run_jax(jk, args))


@pytest.fixture(scope="module")
def persist_calls():
    """Persistence + broadphase + refresh + sleep on 4 worlds, 1 substep:
    call 1 builds every world's cache from nothing (all unstable, all
    awake); call 2 starts from call 1's state and cache with (stable,
    active) = (1, 1), (1, 0), (0, 1), (0, 0).  Both packages get the same
    inputs (JAX's outputs of call 1 feed both second calls)."""
    om = rb.default_object_manager()
    opts = dict(contact_refresh=True, bp_degree=12, bp_capacity=128, persist_margin=0.05)
    jk, tk = kernels(om, 1, **opts)
    kw = pile(num_worlds=4, steps=6, seed=5)
    W, n = kw["im"].shape
    K = sk.bp_slots(128)
    first = bp_args(kw)
    first.update(mcache=np.zeros((W, sk.MC_CHANNELS, K), np.float32),
                 stable=np.zeros(W, bool), active=np.ones(W, bool),
                 aabb_lo=np.zeros((W, n, 3), np.float32), aabb_hi=np.zeros((W, n, 3), np.float32))
    want1 = run_jax(jk, first)
    got1 = run_port(tk, first)
    second = dict(first)
    for k in ("pos", "rot", "v", "w"):
        second[k] = want1[k]
    second.update(mcache=want1["mcache"], aabb_lo=want1["aabb_lo"], aabb_hi=want1["aabb_hi"],
                  stable=np.asarray([True, True, False, False]),
                  active=np.asarray([True, False, True, False]))
    want2 = run_jax(jk, second)
    got2 = run_port(tk, second)
    return {"om": om, "opts": opts, "first": (first, got1, want1),
            "second": (second, got2, want2)}


def test_persist_sleep_matches_jax(persist_calls):
    first, got1, want1 = persist_calls["first"]
    assert_outputs_match(got1, want1)
    assert (got1["bp_count"] > 0).all() and (got1["mcache"][:, 2].sum(-1) > 0).all()
    second, got2, want2 = persist_calls["second"]
    assert_outputs_match(got2, want2)
    # stable or asleep: the cache and its surface pass through
    for wld in (0, 1, 3):
        np.testing.assert_array_equal(got2["mcache"][wld], second["mcache"][wld])
        np.testing.assert_array_equal(got2["aabb_lo"][wld], second["aabb_lo"][wld])
    # asleep: the state passes through, bit for bit
    for wld in (1, 3):
        for k in ("pos", "rot", "v", "w", "prev_pos", "ps_pos", "ps_v"):
            src = {"prev_pos": "pos", "ps_pos": "pos", "ps_v": "v"}.get(k, k)
            np.testing.assert_array_equal(got2[k][wld], second[src][wld], err_msg=k)
    # the unstable awake world rebuilt its cache from the new poses
    assert not np.array_equal(got2["mcache"][2], second["mcache"][2])


# -- (d) a JAX reference oddity: the result depends on the world blocks --------


def test_jax_world_block_oddity_asleep_unstable_world(persist_calls):
    """In the TPU kernel, an asleep world that shares a world block with an
    awake world takes its rows, AABBs, counts and cache from the block's
    solve — rebuilt when it is not stable — where a block of sleepers
    passes them through.  With wt = 4 the four worlds of the second call
    share a block, and world 3 (unstable, asleep) is rebuilt; with wt = 1
    (the port's one CTA a world) it passes through.  The port keeps the
    wt = 1 result; its pose and velocities are the frozen passthrough
    either way."""
    second, got2, want2 = persist_calls["second"]
    jk4 = jsk.FusedSubstepKernel(persist_calls["om"], 1, relaxation=0.7, interpret=True, wt=4,
                                 **persist_calls["opts"])
    block = run_jax(jk4, second)
    np.testing.assert_array_equal(want2["mcache"][3], second["mcache"][3])
    np.testing.assert_array_equal(got2["mcache"][3], second["mcache"][3])
    assert not np.array_equal(block["mcache"][3], second["mcache"][3])
    # elsewhere wt does not matter, and world 3's state is frozen in both
    assert_outputs_match(got2, block, worlds=slice(0, 3))
    for k in ("pos", "rot", "v", "w"):
        np.testing.assert_array_equal(block[k][3], second[k][3])
        np.testing.assert_array_equal(got2[k][3], second[k][3])
