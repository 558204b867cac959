"""The port's ECS store (core/state.py, core/executor.py) against the JAX
package's: the same op sequence on a JAX state and on the port's state,
inputs as numpy arrays, every leaf but ``rng`` compared after every op.
No arithmetic happens, so everything is held exact.  Cases follow
tests/test_state.py and tests/test_entity_soak.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ecs_madrona_tpu as J
import gpu_ecs_madrona_tpu_torch as P
from gpu_ecs_madrona_tpu.models import collisions as jcol
from gpu_ecs_madrona_tpu_torch.core.component import ENTITY_GEN_BITS, Entity
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col

W, CAP, TMP_CAP = 4, 8, 6


class Framework:
    """One framework's schema (same names in both) and array maker."""

    def __init__(self, pkg, f32, i32, arr, max_entities):
        self.C = {
            "Position": pkg.component("Position", ((3,), f32)),
            "Velocity": pkg.component("Velocity", ((3,), f32)),
            "Health": pkg.component("Health", hp=((), i32)),
            "Pair": pkg.component("Pair", a=((), i32), w=((2,), f32)),
        }
        self.A = {
            "Body": pkg.Archetype("Body", [self.C["Position"], self.C["Velocity"]]),
            "Unit": pkg.Archetype("Unit", [self.C["Position"], self.C["Health"]]),
            "Tmp": pkg.Archetype("Tmp", [self.C["Pair"]]),
        }
        reg = pkg.ECSRegistry()
        reg.register_archetype(self.A["Body"], capacity=CAP)
        reg.register_archetype(self.A["Unit"], capacity=CAP)
        reg.register_archetype(self.A["Tmp"], capacity=TMP_CAP, temporary=True)
        self.mgr = pkg.StateManager(reg, W, max_entities)
        self.arr = arr


def frameworks(max_entities=24):
    return (Framework(J, jnp.float32, jnp.int32, jnp.asarray, max_entities),
            Framework(P, torch.float32, torch.int32,
                      lambda a: torch.from_numpy(np.array(a)), max_entities))


def np_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from np_leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_same(jstate, pstate, where):
    jl = dict(np_leaves(jax.tree_util.tree_map(np.asarray, jstate)))
    pl = dict(np_leaves(state_to_numpy(pstate)))
    jl.pop(("rng",))
    pl.pop(("rng",))
    assert jl.keys() == pl.keys(), where
    for path, want in jl.items():
        assert pl[path].dtype == want.dtype, (where, path)
        np.testing.assert_array_equal(pl[path], want, err_msg=f"{where} {path}")


RNG = np.random.default_rng(0)
POS = RNG.uniform(-5, 5, (W, 10, 3)).astype(np.float32)
PAIR_A = RNG.integers(0, 100, (W, TMP_CAP)).astype(np.int32)
PAIR_W = RNG.uniform(size=(W, TMP_CAP, 2)).astype(np.float32)

# An op is fn(fw, state, outs) -> (state, out): the same call on both
# frameworks; ``outs`` holds the earlier ops' outputs (as numpy, from the
# JAX side, so both frameworks get identical handles).


def make(arch, counts, max_new, pos=None):
    def op(fw, s, outs):
        values = None
        if pos is not None:
            values = {fw.C["Position"]: fw.arr(pos[:, :max_new])}
        return fw.mgr.make_entities(s, fw.A[arch], fw.arr(np.asarray(counts, np.int32)),
                                    max_new, values)
    return op


def destroy(src, cols, extra_null=False):
    def op(fw, s, outs):
        h = outs[src][:, cols]
        if extra_null:
            h = np.concatenate([h, np.full((W, 1), -1, np.int32)], axis=1)
        return fw.mgr.destroy_entities(s, fw.arr(np.ascontiguousarray(h))), None
    return op


def lookup(src):
    def op(fw, s, outs):
        return s, fw.mgr.lookup(s, fw.arr(outs[src]))
    return op


def emit(counts, k, count_overflow=True):
    def op(fw, s, outs):
        vals = {fw.C["Pair"]: {"a": fw.arr(PAIR_A[:, :k].copy()),
                               "w": fw.arr(PAIR_W[:, :k].copy())}}
        return fw.mgr.emit_temporaries(s, fw.A["Tmp"], fw.arr(np.asarray(counts, np.int32)),
                                       vals, count_overflow=count_overflow), None
    return op


def clear(arch):
    return lambda fw, s, outs: (fw.mgr.clear_archetype(s, fw.A[arch]), None)


def destroy_rows(arch, dead):
    return lambda fw, s, outs: (fw.mgr.destroy_rows(s, fw.A[arch], fw.arr(dead)), None)


def set_health(src, hp):
    def op(fw, s, outs):
        vals = {"hp": fw.arr(np.full(outs[src].shape, hp, np.int32))}
        return fw.mgr.set_component(s, fw.C["Health"], fw.arr(outs[src]), vals), None
    return op


def get_position(*srcs):
    def op(fw, s, outs):
        h = np.concatenate([outs[k] for k in srcs], axis=1)
        return s, fw.mgr.get_component(s, fw.C["Position"], fw.arr(h))
    return op


def num_rows(arch):
    return lambda fw, s, outs: (s, fw.mgr.num_rows(s, fw.A[arch]))


DEAD = np.zeros((W, CAP), bool)
DEAD[:, 1] = DEAD[1:, 3] = DEAD[3, :] = True

SEQUENCES = {
    # per-world counts, capacity overflow (world 3 asks for 10 of 8 rows)
    "make_per_world_overflow": (24, [
        make("Body", [0, 3, 8, 10], 10, POS), make("Unit", [4, 4, 4, 4], 4, POS),
        make("Body", [1, 1, 1, 1], 1), num_rows("Body")]),
    # id space smaller than the tables: the id allocator overflows
    "id_space_overflow": (10, [
        make("Body", 8, 8, POS), make("Unit", [2, 3, 4, 5], 5), num_rows("Unit")]),
    # stale and null handles are ignored; ids recycle lowest-index-first
    # with a generation bump
    "destroy_stale_recreate": (24, [
        make("Body", 6, 6, POS), destroy(0, [0, 2, 4]),
        destroy(0, [0, 2, 4, 5], extra_null=True), make("Body", 3, 3, POS),
        lookup(0), lookup(3), make("Unit", 2, 2)]),
    # prefix rows, clip to K with and without the overflow counter
    "emit_temporaries_clip": (24, [
        emit([0, 2, 6, 9], TMP_CAP), clear("Tmp"), emit([1, 5, 7, 3], 4),
        num_rows("Tmp"), clear("Tmp"), emit([9, 9, 0, 2], TMP_CAP, count_overflow=False)]),
    # destroy by row mask, clear (stores zeroed, ids freed), re-create
    "destroy_rows_clear": (24, [
        make("Body", 5, 5, POS), make("Unit", 3, 3, POS), destroy_rows("Body", DEAD),
        lookup(0), clear("Body"), lookup(0), make("Body", 5, 5), lookup(6)]),
    # component access by handle across archetypes
    "components_by_handle": (24, [
        make("Body", 2, 2, POS), make("Unit", 3, 3, POS), set_health(1, 7),
        get_position(0, 1), destroy(1, [1]), get_position(0, 1)]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_op_sequence_parity(name):
    max_entities, ops = SEQUENCES[name]
    jfw, pfw = frameworks(max_entities)
    js = jfw.mgr.make_initial_state(seed=0)
    ps = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert_same(js, ps, "initial")
    outs = []
    for i, op in enumerate(ops):
        # one jit program per op: far quicker than eager JAX dispatch
        js, jout = jax.jit(lambda s: op(jfw, s, outs))(js)
        ps, pout = op(pfw, ps, outs)
        assert_same(js, ps, f"op {i}")
        jo = [np.asarray(x) for x in jax.tree_util.tree_leaves(jout)]
        po = [np.asarray(x) for x in jax.tree_util.tree_leaves(pout)]
        assert len(jo) == len(po)
        for a, b in zip(jo, po):
            np.testing.assert_array_equal(b, a, err_msg=f"op {i} output")
        outs.append(jo[0] if len(jo) == 1 else jo)


def test_lazy_emission_builds_only_when_read():
    """A lazily emitted table equals the eager one when read, and a clear
    drops it unbuilt."""
    _, pfw = frameworks()
    s = pfw.mgr.make_initial_state()
    built = []

    def values():
        built.append(1)
        return {pfw.C["Pair"]: {"a": torch.from_numpy(PAIR_A.copy()),
                                "w": torch.from_numpy(PAIR_W.copy())}}

    counts = torch.tensor([0, 2, 6, 9], dtype=torch.int32)
    eager = pfw.mgr.emit_temporaries(s, pfw.A["Tmp"], counts, values())
    built.clear()
    lazy = pfw.mgr.emit_temporaries(s, pfw.A["Tmp"], lambda: counts, values,
                                    count_overflow=False)
    assert isinstance(lazy["arch"]["Tmp"], LazyRows) and not built
    cleared = pfw.mgr.clear_archetype(lazy, pfw.A["Tmp"])
    assert (pfw.mgr.num_rows(cleared, pfw.A["Tmp"]) == 0).all() and not built
    assert torch.equal(pfw.mgr.row_mask(lazy, pfw.A["Tmp"]),
                       pfw.mgr.row_mask(eager, pfw.A["Tmp"]))
    assert built == [1]
    for f in ("a", "w"):
        assert torch.equal(pfw.mgr.column(lazy, pfw.A["Tmp"], pfw.C["Pair"])[f],
                           pfw.mgr.column(eager, pfw.A["Tmp"], pfw.C["Pair"])[f])


def _churn(fw, s):
    ent = s["arch"]["Body"]["entity"][:, 0:1]
    s = fw.mgr.destroy_entities(s, ent)
    s, _ = fw.mgr.make_entities(s, fw.A["Body"], 1, 1)
    return s


def test_gen_wrap_aliases_at_2_pow_gen_bits():
    """Stale handles die at every recycle before the wrap and alias exactly
    at 2^ENTITY_GEN_BITS recycles (tests/test_entity_soak.py); the first
    recycles match the JAX package.  The slot's generation is then
    fast-forwarded to just before the wrap (the table is state)."""
    jfw, pfw = frameworks()
    js, jfirst = jfw.mgr.make_entities(jfw.mgr.make_initial_state(), jfw.A["Body"], 1, 1)
    ps, pfirst = pfw.mgr.make_entities(pfw.mgr.make_initial_state(), pfw.A["Body"], 1, 1)
    assert np.array_equal(pfirst.numpy(), np.asarray(jfirst))
    jchurn = jax.jit(lambda s: _churn(jfw, s))
    for i in range(3):
        js, ps = jchurn(js), _churn(pfw, ps)
        assert_same(js, ps, f"churn {i}")
        assert not pfw.mgr.lookup(ps, pfirst)[2].any()
    wrap = 1 << ENTITY_GEN_BITS
    gen = ps["eid"]["gen"].clone()
    assert (gen[:, 0] == 3).all()
    gen[:, 0] = wrap - 5
    body = ps["arch"]["Body"]
    ent = body["entity"].clone()
    ent[:, 0] = Entity.pack(0, wrap - 5)  # the live handle of slot 0
    ps = {**ps, "eid": {**ps["eid"], "gen": gen},
          "arch": {**ps["arch"], "Body": {**body, "entity": ent}}}
    for i in range(4):  # recycles wrap - 4 .. wrap - 1
        ps = _churn(pfw, ps)
        assert not pfw.mgr.lookup(ps, pfirst)[2].any(), i
    ps = _churn(pfw, ps)  # recycle number ``wrap``
    assert pfw.mgr.lookup(ps, pfirst)[2].all()


# -- executor surfaces: packed exports and checkpoints ------------------------


def _executors():
    kw = dict(num_worlds=3, num_objects=6, max_pairs=64, seed=2, fused=False)
    jsim = jcol.make_executor(jcol.CollisionsConfig(**kw), donate=False)
    psim = col.make_executor(col.CollisionsConfig(**kw), device="cpu")
    psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    return jsim, psim


def test_get_exported_packed_parity():
    """Per-world live counts differ after a destroy: the packed layout
    (rows compacted in (world, row) order, counts, offsets) is exact."""
    jsim, psim = _executors()
    ents = np.asarray(jsim.state["arch"]["CubeObject"]["entity"])
    kill = np.full((3, 3), -1, np.int32)
    kill[0, :1] = ents[0, :1]
    kill[2, :3] = ents[2, 2:5]
    jsim.state = jsim.mgr.destroy_entities(jsim.state, jnp.asarray(kill))
    psim.state = psim.mgr.destroy_entities(psim.state, torch.from_numpy(kill))
    for slot in (0, 1):
        jv, jc, jo = jsim.get_exported(slot, packed=True)
        pv, pc, po = psim.get_exported(slot, packed=True)
        for a, b in ((jv, pv), (jc, pc), (jo, po)):
            assert b.numpy().dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert pc.tolist() == [5, 6, 3]


def test_checkpoint_from_jax_restores_into_port(tmp_path):
    """A checkpoint written by the JAX package restores into the port
    (every leaf but rng exact; rng mapped into the port's layout), and the
    port's own checkpoint round-trips bit for bit."""
    jsim, psim = _executors()
    jsim.run(2)
    jsim.save_checkpoint(str(tmp_path / "jax_ckpt"))
    psim.restore_checkpoint(str(tmp_path / "jax_ckpt.npz"))
    assert_same(jsim.state, psim.state, "restored")
    rng = psim.state["rng"]
    assert rng.dtype == torch.int64 and rng.shape == (3, 2) and (rng[:, 1] == 0).all()
    psim.step()
    psim.save_checkpoint(str(tmp_path / "port_ckpt"))
    before = state_to_numpy(psim.state)
    psim.step()
    psim.restore_checkpoint(str(tmp_path / "port_ckpt"))
    after = state_to_numpy(psim.state)
    for (pa, a), (pb, b) in zip(np_leaves(before), np_leaves(after)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
