"""The port's taskgraph and executor surfaces (core/taskgraph.py,
core/executor.py) against the JAX package's: the sorted node order,
batched parallel-for write-back, per-row generator keys, singletons and
export write-back."""

import jax.numpy as jnp
import numpy as np
import torch

import gpu_ecs_madrona_tpu as J
import gpu_ecs_madrona_tpu_torch as P
from gpu_ecs_madrona_tpu_torch.models import collisions as col


def _graph(pkg):
    """A diamond with a tail, added out of order: a, d(b, c), b(a), c(a),
    e(d), f()."""
    reg = pkg.ECSRegistry()
    b = pkg.TaskGraphBuilder(pkg.StateManager(reg, 1, 1))
    na = b.add_node(lambda ctx: None, name="a")
    nb = b.add_node(lambda ctx: None, deps=[na], name="b")
    nc = b.add_node(lambda ctx: None, deps=[na], name="c")
    nd = b.add_node(lambda ctx: None, deps=[nb, nc], name="d")
    b.add_node(lambda ctx: None, deps=[nd], name="e")
    b.add_node(lambda ctx: None, name="f")
    b.clear_tmp_node(pkg.Archetype("T", []), deps=[na])
    return b.build().node_names


def test_kahn_order_matches_jax():
    assert _graph(P) == _graph(J)


Val = P.component("Val", ((), torch.float32))
Tag = P.component("Tag", ((2,), torch.int32))
Clock = P.singleton_component("Clock", t=((), torch.float32))
Thing = P.Archetype("Thing", [Val, Tag])


class World:
    @staticmethod
    def register_types(reg):
        reg.register_archetype(Thing, capacity=6)
        reg.register_singleton(Clock)
        reg.export_column(Thing, Val, 0)

    @staticmethod
    def init(ctx, init_data=None):
        ctx.data = {"scale": torch.full((ctx.num_worlds,), 2.0)}
        ctx.make_entities(Thing, counts=torch.tensor([4, 2, 0], dtype=torch.int32),
                          max_new=4, values={Val: torch.ones((3, 4))})
        ctx.set_singleton(Clock, {"t": torch.tensor([1.0, 2.0, 3.0])})

    @staticmethod
    def setup_tasks(builder):
        def grow(rowctx, val, tag):
            t = rowctx.singleton(Clock)["t"][:, None]
            bits = (rowctx.key & 0xFF).to(torch.int32)
            new_tag = torch.stack([rowctx.row, bits], dim=-1)
            return val * rowctx.data["scale"][:, None] + t, new_tag

        builder.parallel_for_node(grow, [Val, Tag], needs_rng=True, name="grow")


def _sim(seed=0):
    return P.TaskGraphExecutor(World, P.ExecutorConfig(num_worlds=3, seed=seed,
                                                       device="cpu"))


def test_parallel_for_writes_live_rows_only():
    sim = _sim()
    sim.step()
    vals, mask = sim.get_exported(0)
    want = torch.where(mask, torch.tensor([3.0, 4.0, 5.0])[:, None], 0.0)
    assert torch.equal(vals, want)
    tag = sim.mgr.column(sim.state, Thing, Tag)
    assert torch.equal(tag[..., 0], torch.where(mask, torch.arange(6, dtype=torch.int32), 0))
    assert (sim.state["tick"] == 1).all()


def test_row_keys_deterministic_and_distinct():
    a, b, c = _sim(0), _sim(0), _sim(1)
    for s in (a, b, c):
        s.run(2)
    ka = a.mgr.column(a.state, Thing, Tag)[..., 1]
    kb = b.mgr.column(b.state, Thing, Tag)[..., 1]
    kc = c.mgr.column(c.state, Thing, Tag)[..., 1]
    assert torch.equal(ka, kb)
    assert not torch.equal(ka, kc)
    assert len(set(ka[0, :4].tolist())) > 1  # rows of one world differ


def test_set_exported_then_step_matches_jax():
    """Write an export back, step both packages' collisions worlds from the
    same state: the written positions are what the step starts from."""
    from gpu_ecs_madrona_tpu.models import collisions as jcol
    from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy
    import jax

    kw = dict(num_worlds=2, num_objects=5, max_pairs=64, seed=1, fused=False)
    jsim = jcol.make_executor(jcol.CollisionsConfig(**kw), donate=False)
    psim = col.make_executor(col.CollisionsConfig(**kw), device="cpu")
    psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    pos = np.zeros((2, 13, 3), np.float32)
    pos[:, :5, 0] = np.arange(5) * 1.5  # a row of overlapping cubes
    jsim.set_exported(0, jnp.asarray(pos))
    psim.set_exported(0, torch.from_numpy(pos.copy()))
    jsim.step()
    psim.step()
    np.testing.assert_allclose(psim.get_exported(0)[0].numpy(),
                               np.asarray(jsim.get_exported(0)[0]), atol=1e-4, rtol=0)
