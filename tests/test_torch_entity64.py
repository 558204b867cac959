"""64-bit entity handles in the port (GEM_TPU_ENTITY_64=1) against the JAX
package's (tests/test_entity64.py), and the port's counterpart of
tests/test_entity_soak.py at both handle widths.

With the flag, handles are int64 with a 32-bit id and a 31-bit generation
(the reference's Entity{gen, id} headroom); the entity store's columns stay
int32, and so do the component fields that hold handles (a handle kept in
one keeps its low 32 bits: the id, read back as a handle of generation 0).
The flag is read when the packages are imported, so every check runs in a
subprocess of its own, on the CPU: the checks are scripts in CHECKS, all
started when the module's first test asks for them (the ``checks``
fixture, a few at a time), each test waiting on its own.
"""

import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from gpu_ecs_madrona_tpu_torch.core.component import ENTITY_64, ENTITY_GEN_BITS, Entity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import numpy as np
    import torch
""")

JAX_PRELUDE = PRELUDE + textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import gpu_ecs_madrona_tpu as J
    import gpu_ecs_madrona_tpu_torch as P
    from gpu_ecs_madrona_tpu.core import component as jcm
    from gpu_ecs_madrona_tpu_torch.core import component as pcm
    from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
    assert jax.config.jax_enable_x64 == (os.environ.get("GEM_TPU_ENTITY_64") == "1")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, np.asarray(tree)

    # The JAX leaves that x64 widens where the port's stay 32-bit, compared
    # by value: the per-archetype overflow counters of an archetype made
    # into (make_entities' dropped count comes out int64), and fantasy_vs's
    # placeholder user data (jnp.zeros without a dtype: float64, all zero)
    X64_WIDENED = {"overflow": (np.int32, np.int64), ("user", "_"): (np.float32, np.float64)}

    def compare(jstate, pstate, where, tolerance=lambda path: 0.0):
        # every leaf but rng; a float leaf within tolerance(path), the rest
        # exact; X64_WIDENED's by value
        jl = dict(leaves(jax.tree_util.tree_map(np.asarray, jstate)))
        pl = dict(leaves(state_to_numpy(pstate)))
        jl.pop(("rng",)), pl.pop(("rng",))
        assert jl.keys() == pl.keys(), where
        for path, want in jl.items():
            got = pl[path]
            assert got.shape == want.shape, (where, path)
            widened = X64_WIDENED.get(path[0], X64_WIDENED.get(path))
            if widened and jax.config.jax_enable_x64:
                assert got.dtype == widened[0] and want.dtype in widened, (path, want.dtype)
            else:
                assert got.dtype == want.dtype, (where, path, got.dtype, want.dtype)
            tol = tolerance(path)
            if tol:
                np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                           err_msg=f"{where} {path}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{where} {path}")
        return pl
""")


# name: (script, handle settings, time limit s); each test's script sits
# above it
CHECKS = {}
CHECK_PROCESSES = 4   # checks run at once


def run(script, env, timeout=240):
    """Runs ``script`` in a fresh interpreter at the repository's root, on
    the CPU, with the handle settings of ``env`` only: the finished
    process."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("GEM_TPU_ENTITY_64", "GEM_TPU_ENTITY_ID_BITS")}
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, timeout=timeout,
                          env={**base, "JAX_PLATFORMS": "cpu", **env})


@pytest.fixture(scope="module")
def checks():
    """Every script of CHECKS started, CHECK_PROCESSES at a time: {name: the
    future of its finished process}."""
    pool = ThreadPoolExecutor(CHECK_PROCESSES)
    futures = {name: pool.submit(run, *spec) for name, spec in CHECKS.items()}
    yield futures
    pool.shutdown(wait=True)


def passed(checks, name):
    """Asserts that the check ``name`` exited 0 and ended with "OK"."""
    r = checks[name].result()
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK"), r.stdout[-2000:]


def test_default_handles_stay_int32():
    """Without the flag nothing changes: int32 handles with the
    GEM_TPU_ENTITY_ID_BITS split (20/11 by default)."""
    assert not ENTITY_64
    assert Entity.dtype == torch.int32 and ENTITY_GEN_BITS == 11
    h = Entity.pack(torch.tensor([5]), torch.tensor([3]))
    assert h.dtype == torch.int32 and int(h) == 5 | (3 << 20)
    assert Entity.id(h).dtype == Entity.gen(h).dtype == torch.int32


HANDLES_DECODE = JAX_PRELUDE + textwrap.dedent("""
    assert pcm.Entity.dtype == torch.int64 and jcm.Entity.dtype == jnp.int64
    assert pcm.ENTITY_ID_BITS == jcm.ENTITY_ID_BITS == 32
    assert pcm.ENTITY_GEN_BITS == jcm.ENTITY_GEN_BITS == 31
    eids = np.array([0, 1, 123456, (1 << 20) + 7, (1 << 31) - 1, 1 << 31], np.int64)
    gens = np.array([0, 5000, 1 << 11, 1 << 20, (1 << 30) + 3, 1 << 30], np.int64)
    jh = np.asarray(jcm.Entity.pack(eids, gens))
    ph = pcm.Entity.pack(torch.from_numpy(eids), torch.from_numpy(gens))
    assert ph.dtype == torch.int64 and jh.dtype == np.int64
    assert np.array_equal(ph.numpy(), jh)
    for f in ("id", "gen"):
        j, p = np.asarray(getattr(jcm.Entity, f)(jh)), getattr(pcm.Entity, f)(ph)
        assert p.dtype == torch.int32 and j.dtype == np.int32, f
        assert np.array_equal(p.numpy(), j), f
    assert np.array_equal(pcm.Entity.gen(ph).numpy(), gens.astype(np.int32))
    assert not bool(pcm.Entity.is_null(ph).any())
    nulls = np.array([-1, -5], np.int64)
    assert np.array_equal(pcm.Entity.is_null(torch.from_numpy(nulls)).numpy(),
                          np.asarray(jcm.Entity.is_null(nulls)))
    assert bool(pcm.Entity.is_null(pcm.Entity.null()))
    assert int(pcm.Entity.null()) == int(jcm.Entity.null()) == -1
    print("OK")
""")
CHECKS["handles_decode"] = (HANDLES_DECODE, {"GEM_TPU_ENTITY_64": "1"})


def test_handles_decode_as_jax(checks):
    """pack, id, gen, is_null and null at ids up to 2^31 and generations up
    to 2^30, in both packages: the same values, int64 handles, int32 ids and
    generations."""
    passed(checks, "handles_decode")


STALE_HANDLE = PRELUDE + textwrap.dedent("""
    from gpu_ecs_madrona_tpu_torch import (Archetype, ExecutorConfig, TaskGraphExecutor,
                                           component)
    from gpu_ecs_madrona_tpu_torch.core.component import Entity
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    assert Entity.dtype == torch.int64
    Tag = component("E64Tag", ((), torch.int32))
    A = Archetype("E64Arch", [Tag])

    class W:
        @staticmethod
        def register_types(r):
            r.register_archetype(A, capacity=2)
            r.export_column(A, Tag, 0)

        @staticmethod
        def init(ctx, init_data=None):
            pass

        @staticmethod
        def setup_tasks(builder):
            def churn(ctx):
                ents = ctx.make_entities(A, counts=1, max_new=1,
                                         values={Tag: torch.zeros((2, 1), dtype=torch.int32)})
                ctx.destroy_entities(ents)
            builder.add_node(churn, name="churn")

    sim = TaskGraphExecutor(W, ExecutorConfig(num_worlds=2, max_entities_per_world=4,
                                              seed=0, device="cpu"))
    ctx = Context(sim.mgr, sim.state)
    stale = ctx.make_entities(A, counts=1, max_new=1,
                              values={Tag: torch.zeros((2, 1), dtype=torch.int32)})
    ctx.destroy_entities(stale)
    sim.state = ctx.state
    assert stale.dtype == torch.int64
    sim.run(2100)
    _, _, live = sim.mgr.lookup(sim.state, stale)
    assert not bool(live.any()), "stale 64-bit handle aliased after churn"
    assert (sim.state["eid"]["gen"][:, 0] == 2101).all()
    assert sim.state["eid"]["gen"].dtype == torch.int32
    # a checkpoint carries the int64 handle columns: a live handle of
    # generation 2,101 made, saved, churned past and restored
    import tempfile
    ctx = Context(sim.mgr, sim.state)
    held = ctx.make_entities(A, counts=1, max_new=1,
                             values={Tag: torch.zeros((2, 1), dtype=torch.int32)})
    sim.state = ctx.state
    assert (Entity.gen(held) == 2101).all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        sim.save_checkpoint(path)
        kept = sim.state["arch"]["E64Arch"]["entity"].clone()
        ctx = Context(sim.mgr, sim.state)
        ctx.destroy_entities(held)
        sim.state = ctx.state
        assert not bool(sim.mgr.lookup(sim.state, held)[2].any())
        sim.restore_checkpoint(path)
    ent = sim.state["arch"]["E64Arch"]["entity"]
    assert ent.dtype == torch.int64 and torch.equal(ent, kept)
    assert bool(sim.mgr.lookup(sim.state, held)[2].all())
    assert not bool(sim.mgr.lookup(sim.state, stale)[2].any())
    print("OK")
""")
CHECKS["stale_handle"] = (STALE_HANDLE, {"GEM_TPU_ENTITY_64": "1"})


def test_stale_handle_stays_dead_past_2_11_recycles(checks):
    """tests/test_entity64.py's churn in the port: a handle from a slot's
    first cycle stays dead after 2,100 recycles of it through the
    executor (at int32's default split it aliases at 2,048); a checkpoint
    of that state restores its int64 handle columns."""
    passed(checks, "stale_handle")


# The churn world of test_churn_world_matches_jax_after_40_ticks: bodies made
# and destroyed by handle, units destroyed by row mask, a temporary table whose
# int32 field holds handles, positions moved by velocities, all from one numpy
# seed's per-tick tables; the same tick in both packages.
CHURN_WORLD = textwrap.dedent("""
    W, CAP, TMP, T = 4, 8, 6, 40
    rng = np.random.default_rng(7)
    TAB = {
        "kill": rng.random((T, W, CAP)) < 0.3,
        "made": rng.integers(0, 4, (T, W)).astype(np.int32),
        "units": rng.integers(0, 3, (T, W)).astype(np.int32),
        "dead": rng.random((T, W, CAP)) < 0.25,
        "pos": rng.uniform(-5, 5, (T, W, 3, 3)).astype(np.float32),
        "vel": rng.uniform(-1, 1, (T, W, 3, 3)).astype(np.float32),
        "tmp": rng.integers(0, 7, (T, W)).astype(np.int32),
    }

    class Fw:
        def __init__(self, pkg, f32, i32, xp):
            self.pkg, self.xp = pkg, xp
            self.Pos = pkg.component("Pos", ((3,), f32))
            self.Vel = pkg.component("Vel", ((3,), f32))
            self.Ref = pkg.component("Ref", a=((), i32), b=((), i32))
            self.Body = pkg.Archetype("Body", [self.Pos, self.Vel])
            self.Unit = pkg.Archetype("Unit", [self.Pos])
            self.Tmp = pkg.Archetype("Tmp", [self.Ref])
            reg = pkg.ECSRegistry()
            reg.register_archetype(self.Body, capacity=CAP)
            reg.register_archetype(self.Unit, capacity=CAP)
            reg.register_archetype(self.Tmp, capacity=TMP, temporary=True)
            self.mgr = pkg.StateManager(reg, W, 20)

    def tick(fw, s, tab):
        xp, m = fw.xp, fw.mgr
        ent = s["arch"]["Body"]["entity"]
        s = m.destroy_entities(s, xp.where(tab["kill"], ent, -1))
        s, made = m.make_entities(s, fw.Body, tab["made"], 3,
                                  {fw.Pos: tab["pos"], fw.Vel: tab["vel"]})
        s, _ = m.make_entities(s, fw.Unit, tab["units"], 2, {fw.Pos: tab["pos"][:, :2]})
        s = m.destroy_rows(s, fw.Unit, tab["dead"])
        pos = m.column(s, fw.Body, fw.Pos)
        s = m.set_column(s, fw.Body, fw.Pos, pos + m.column(s, fw.Body, fw.Vel) * (1.0 / 60.0))
        # handles kept in the temporary's int32 fields
        ent = s["arch"]["Body"]["entity"]
        s = m.clear_archetype(s, fw.Tmp)
        s = m.emit_temporaries(s, fw.Tmp, tab["tmp"], {fw.Ref: {"a": ent[:, :TMP],
                                                                "b": ent[:, 2:2 + TMP]}})
        return s, made
""")


CHURN_TICKS = JAX_PRELUDE + CHURN_WORLD + textwrap.dedent("""
    jfw = Fw(J, jnp.float32, jnp.int32, jnp)
    pfw = Fw(P, torch.float32, torch.int32, torch)
    js = jfw.mgr.make_initial_state(seed=0)
    ps = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jtick = jax.jit(lambda s, tab: tick(jfw, s, tab))
    made_all = []
    for t in range(T):
        js, jmade = jtick(js, {k: jnp.asarray(v[t]) for k, v in TAB.items()})
        ps, pmade = tick(pfw, ps, {k: torch.from_numpy(v[t].copy()) for k, v in TAB.items()})
        assert pmade.dtype == torch.int64 and np.asarray(jmade).dtype == np.int64
        assert np.array_equal(pmade.numpy(), np.asarray(jmade)), t
        made_all.append(np.asarray(jmade))
    pl = compare(js, ps, "tick 40", lambda path: 1e-6 if path[-1] == "value" and
                 path[-2] in ("Pos", "Vel") else 0.0)
    assert pl[("arch", "Body", "entity")].dtype == np.int64
    assert pl[("eid", "gen")].dtype == np.int32
    assert pl[("arch", "Tmp", "comps", "Ref", "a")].dtype == np.int32
    handles = np.concatenate(made_all, axis=1)
    j = [np.asarray(x) for x in jfw.mgr.lookup(js, jnp.asarray(handles))]
    p = [x.numpy() for x in pfw.mgr.lookup(ps, torch.from_numpy(handles))]
    for a, b in zip(j, p):
        assert np.array_equal(a, b)
    assert p[2].sum() > 0 and (~p[2] & (handles >= 0)).sum() > 0
    # generations past 0 were made, and stored in the int32 fields
    assert (pcm.Entity.gen(torch.from_numpy(handles)) > 0).any()
    print("OK")
""")
CHECKS["churn_ticks"] = (CHURN_TICKS, {"GEM_TPU_ENTITY_64": "1"})


def test_churn_world_matches_jax_after_40_ticks(checks):
    """The churn world (make, destroy by handle and by row mask, a
    temporary's int32 fields holding handles, positions moved by
    velocities) for 40 ticks in both packages with 64-bit handles, from one
    numpy seed's tables: each tick's made handles exact; after the 40 ticks
    every leaf but rng, handles and integer leaves exact (the handle
    columns int64), the float leaves within 1e-6 (the same float32
    products and sums in both); the lookups of every handle made exact.
    The JAX package's overflow counters of Body and Unit come out int64
    under x64, the port's int32: compared by value (``compare``)."""
    passed(checks, "churn_ticks")


FANTASY_VS = JAX_PRELUDE + textwrap.dedent("""
    from gpu_ecs_madrona_tpu.core.context import Context as JContext
    from gpu_ecs_madrona_tpu.models import fantasy_vs as jfvs
    from gpu_ecs_madrona_tpu_torch.core.context import Context as PContext
    from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
    from test_torch_fantasy_vs import tolerance
    from test_torch_rl_cases import GOLDEN_CONSTANTS, random_script
    for mod in (jfvs, fvs):
        for name, value in GOLDEN_CONSTANTS.items():
            setattr(mod, name, value)
    seen = {"jax": [], "port": []}

    def spy(cls, key, as_np):
        clear = cls.clear_archetype

        def clear_and_record(self, arch):
            if arch.name == "CleanupTracker":
                col = self.column(arch, jfvs.CleanupEntity if key == "jax"
                                  else fvs.CleanupEntity)
                mask = self.row_mask(arch)
                seen[key].append((as_np(col), as_np(mask)))
            return clear(self, arch)
        cls.clear_archetype = clear_and_record

    spy(JContext, "jax", np.asarray)
    spy(PContext, "port", lambda t: t.numpy().copy())
    nd, nk, T = 5, 9, 8
    script = random_script(3, nd, nk, 24)
    kw = dict(num_worlds=2, num_dragons=nd, num_knights=nk, seed=0, scripted=True,
              replicate_clamp_bug=True)
    jsim = jfvs.make_executor(jfvs.FantasyVsConfig(**kw), init_data=script, donate=False)
    psim = fvs.make_executor(fvs.FantasyVsConfig(**kw), init_data=script, device="cpu")
    js = jsim.state
    for t in range(T):
        js = jsim.graph.step(js)
        psim.step()
        pl = compare(js, psim.state, f"tick {t}", tolerance)
        for arch in ("Dragon", "Knight"):
            assert pl[("arch", arch, "entity")].dtype == np.int64
    assert len(seen["jax"]) == len(seen["port"]) == T
    dead = 0
    for (jc, jm), (pc, pm) in zip(seen["jax"], seen["port"]):
        assert pc.dtype == jc.dtype == np.int32
        assert np.array_equal(pm, jm) and np.array_equal(pc, jc)
        dead += int(pm.sum())
    assert dead > 0, "no deaths: the cleanup never tracked a handle"
    print("OK")
""")
CHECKS["fantasy_vs"] = (FANTASY_VS, {"GEM_TPU_ENTITY_64": "1"}, 400)


def test_fantasy_vs_matches_jax_with_64_bit_handles(checks):
    """fantasy_vs at 2 worlds, scripted (both packages replay one decision
    table, damage high enough for deaths), 8 ticks with 64-bit handles:
    every tick the entity columns exact (int64), and the rows the cleanup
    node's tracker holds before its clear (CleanupEntity, an int32 field of
    handles) exact; the other leaves at the fantasy_vs tests' tolerances.
    With x64 on, every JAX leaf keeps the port's dtype (no float64 or int64
    leaf but the handles)."""
    passed(checks, "fantasy_vs")


INT32_FIELD = textwrap.dedent("""
    W = 2
    wide = pcm.ENTITY_64

    class Fw:
        def __init__(self, pkg, f32, i32):
            self.Val = pkg.component("Val", ((), f32))
            self.Ref = pkg.component("Ref", ((), i32))
            self.Thing = pkg.Archetype("Thing", [self.Val])
            self.Refs = pkg.Archetype("Refs", [self.Ref])
            reg = pkg.ECSRegistry()
            reg.register_archetype(self.Thing, capacity=2)
            reg.register_archetype(self.Refs, capacity=2)
            self.mgr = pkg.StateManager(reg, W, 4)

    def kept(fw, s, xp):
        # a slot recycled three times (generation 3), its handle stored in an
        # int32 field, and the field read back as a handle
        for _ in range(3):
            s, e = fw.mgr.make_entities(s, fw.Thing, 1, 1)
            s = fw.mgr.destroy_entities(s, e)
        s, e = fw.mgr.make_entities(s, fw.Thing, 1, 1)
        s, _ = fw.mgr.make_entities(s, fw.Refs, 1, 1, {fw.Ref: e})
        field = s["arch"]["Refs"]["comps"]["Ref"]["value"][:, :1]
        return e, field, fw.mgr.lookup(s, field)[2], fw.mgr.lookup(s, e)[2]

    jfw, pfw = Fw(J, jnp.float32, jnp.int32), Fw(P, torch.float32, torch.int32)
    je, jf, jlive, jlive_e = [np.asarray(x) for x in jax.jit(
        lambda s: kept(jfw, s, jnp))(jfw.mgr.make_initial_state())]
    pe, pf, plive, plive_e = [x.numpy() for x in
                              kept(pfw, pfw.mgr.make_initial_state(), torch)]
    for a, b in ((je, pe), (jf, pf), (jlive, plive), (jlive_e, plive_e)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pf.dtype == np.int32 and bool(plive_e.all())
    gen = pcm.Entity.gen(torch.from_numpy(pe))
    assert (gen == 3).all() and (pcm.Entity.id(torch.from_numpy(pe)) == 0).all()
    if wide:
        # the field keeps the low 32 bits, the id: a handle of generation 0,
        # dead while the slot's generation is 3
        assert pe.dtype == np.int64 and np.array_equal(pf, (pe & 0xFFFFFFFF).astype(np.int32))
        assert (pf == 0).all() and not plive.any()
    else:
        # an int32 handle fits its field whole and stays live
        assert pe.dtype == np.int32 and np.array_equal(pf, pe) and plive.all()
""")


for _width in ("int32", "int64"):
    CHECKS[f"int32_field_{_width}"] = (JAX_PRELUDE + INT32_FIELD + "print('OK')\n",
                                       {"GEM_TPU_ENTITY_64": "1"} if _width == "int64" else {})


@pytest.mark.parametrize("width", ["int32", "int64"])
def test_int32_fields_pin_a_handle_past_generation_0(width, checks):
    """A handle of generation 3 stored in an int32 component field (as
    CandidatePair, ContactData, CleanupEntity and the physics' handle
    fields are declared in both packages), in both packages at both
    widths: int32 handles are kept whole and stay live; a 64-bit handle
    keeps its low 32 bits, its id, and reads back as a generation-0 handle,
    dead once its slot has been recycled."""
    passed(checks, f"int32_field_{width}")


SOAK = textwrap.dedent("""
    from gpu_ecs_madrona_tpu_torch.core.component import (ENTITY_GEN_BITS, Archetype,
                                                          Entity, component)
    from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
    from gpu_ecs_madrona_tpu_torch.core.state import StateManager
    Val = component("SoakVal", ((), torch.float32))
    Thing = Archetype("SoakThing", [Val])
    registry = ECSRegistry()
    registry.register_archetype(Thing, capacity=2)
    mgr = StateManager(registry, num_worlds=1, max_entities_per_world=4)
    state, first = mgr.make_entities(mgr.make_initial_state(seed=0), Thing, 1, 1)
    h0 = first[:, 0:1]

    def churn(s):
        ent = s["arch"]["SoakThing"]["entity"][:, 0:1]
        s = mgr.destroy_entities(s, ent)
        s, _ = mgr.make_entities(s, Thing, 1, 1)
        return s

    def live(s):
        return bool(mgr.lookup(s, h0)[2][0, 0])

    # a handful of recycles: the stale handle is dead every time
    for i in range(5):
        state = churn(state)
        assert not live(state), i
    # then 2^11 recycles (the int32 default's generations) in all
    for _ in range((1 << 11) - 6):
        state = churn(state)
    assert not live(state)
    state = churn(state)
    wrap = 1 << ENTITY_GEN_BITS
    assert live(state) == (wrap == 1 << 11), (ENTITY_GEN_BITS, live(state))
    if wrap > 1 << 11:
        # the contract where the generation does wrap: the slot's generation
        # fast-forwarded to just before it (the table is state)
        gen = state["eid"]["gen"].clone()
        gen[:, 0] = wrap - 3
        ent = state["arch"]["SoakThing"]["entity"].clone()
        ent[:, 0] = Entity.pack(0, wrap - 3)
        state = {**state, "eid": {**state["eid"], "gen": gen},
                 "arch": {**state["arch"], "SoakThing": {**state["arch"]["SoakThing"],
                                                         "entity": ent}}}
        for _ in range(2):
            state = churn(state)
            assert not live(state)
        state = churn(state)
        assert live(state), "no alias at the 2^gen_bits recycle"
""")


SOAK_SPLITS = {"int32_20_11": {}, "int32_8_23": {"GEM_TPU_ENTITY_ID_BITS": "8"},
               "int64_32_31": {"GEM_TPU_ENTITY_64": "1"}}
for _split, _env in SOAK_SPLITS.items():
    CHECKS[f"soak_{_split}"] = (PRELUDE + SOAK + "print('OK')\n", _env)


@pytest.mark.parametrize("split", list(SOAK_SPLITS))
def test_entity_soak_at_both_widths(split, checks):
    """tests/test_entity_soak.py in the port, with real churn: at the int32
    default split (11 generation bits) a stale handle dies at every recycle
    and aliases at exactly 2^11; with 8 id bits (23 generation bits) and
    with 64-bit handles (31) it is still dead after 2^11 recycles, and
    aliases where its own generations wrap (the slot's generation
    fast-forwarded there)."""
    passed(checks, f"soak_{split}")
