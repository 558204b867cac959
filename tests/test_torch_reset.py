"""The episode auto-reset node (TaskGraphBuilder.reset_node) of the PyTorch
port against the JAX package's.

A world whose init is deterministic (each world's start height from a
numpy table) resets exactly as JAX's over 50 steps: positions, masks and
ticks equal bit for bit, since both subtract 1.0 from the same float32
values.  The random reset world of tests/test_reset.py draws from the
port's own generator, so its assertions (cycling, determinism by seed,
divergence across seeds) are held instead of values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ecs_madrona_tpu as J
import gpu_ecs_madrona_tpu_torch as P
from gpu_ecs_madrona_tpu.core import base as jbase
from gpu_ecs_madrona_tpu_torch.core import base as pbase
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy

import test_torch_rl_cases as cases

W = cases.RESET_WORLDS
JTABLE = cases.table_world(J, jbase, jnp, "ResetTableJ")
PTABLE, PRANDOM = cases.PORT_TABLE, cases.PORT_RANDOM


def port_sim(world, seed=7, num_worlds=W):
    return P.TaskGraphExecutor(world, P.ExecutorConfig(num_worlds=num_worlds, seed=seed,
                                                       device="cpu"))


def test_table_reset_matches_jax():
    """50 steps: every world resets several times; the exported positions,
    masks and ticks equal JAX's after every step."""
    jsim = J.TaskGraphExecutor(JTABLE, J.ExecutorConfig(num_worlds=W, seed=7, donate=False))
    psim = port_sim(PTABLE)
    resets = 0
    for t in range(50):
        jsim.step()
        psim.step()
        jv, jm = (np.asarray(x) for x in jsim.get_exported(0))
        pv, pm = (x.numpy() for x in psim.get_exported(0))
        np.testing.assert_array_equal(pm, jm, err_msg=f"mask, step {t + 1}")
        np.testing.assert_array_equal(pv, jv, err_msg=f"position, step {t + 1}")
        jt = np.asarray(jsim.state["tick"])
        np.testing.assert_array_equal(psim.state["tick"].numpy(), jt, err_msg=f"tick {t + 1}")
        if t:   # a world reset in this step restarts at tick 0, then ticks
            resets += int((jt == 1).sum())
    assert resets >= 4 * W


def test_auto_reset_reinitializes_done_worlds():
    sim = port_sim(PRANDOM)
    sim.run(50)
    pos, mask = sim.get_exported(0)
    z = pos[:, 0, 2].numpy()
    assert mask[:, 0].all()
    assert (z > 0.0).all() and (z <= 10.0).all()
    assert (sim.state["tick"] < 50).any()


def test_auto_reset_deterministic():
    a, b, c = port_sim(PRANDOM), port_sim(PRANDOM), port_sim(PRANDOM, seed=8)
    for s in (a, b, c):
        s.run(37)
    pa, pb, pc = (s.get_exported(0)[0] for s in (a, b, c))
    assert torch.equal(pa, pb)
    assert not torch.equal(pa, pc)


def test_reset_draws_a_fresh_episode():
    """A world's next episode starts from a new height, and the worlds'
    heights after a reset differ from each other."""
    sim = port_sim(PRANDOM, num_worlds=16)
    starts = [sim.get_exported(0)[0][:, 0, 2].clone()]
    for _ in range(40):
        sim.step()
        fresh = sim.state["tick"] == 1     # reset in this step, then ticked
        z = sim.get_exported(0)[0][:, 0, 2]
        starts.append(torch.where(fresh, z, torch.nan))
    heights = torch.stack(starts)          # [steps, W]: NaN where no reset
    for w in range(16):
        h = heights[:, w][~torch.isnan(heights[:, w])]
        assert len(h) >= 3 and len(set(h.tolist())) == len(h), (w, h)
    firsts = heights[1:][~torch.isnan(heights[1:])]
    assert len(set(firsts.tolist())) > len(firsts) // 2


def test_non_done_worlds_untouched():
    """Until a world's first reset, its every state leaf but the generator
    equals that of the same world without a reset node, bit for bit."""
    plain_cls = cases.table_world(P, pbase, torch, "ResetTableP", reset=False)
    a, b = port_sim(PTABLE), port_sim(plain_cls)
    first = np.ceil(cases.Z0[:W]).astype(int)       # the step of each world's first reset
    for t in range(1, 12):
        a.step()
        b.step()
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        keep = first > t
        for key in ("arch", "eid", "singleton", "overflow", "tick"):
            la, lb = _leaves(sa[key]), _leaves(sb[key])
            assert la.keys() == lb.keys()
            for path in la:
                np.testing.assert_array_equal(la[path][keep], lb[path][keep],
                                              err_msg=f"{key}{path} step {t}")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], path + (k,)))
        return out
    return {path: np.asarray(tree)}


def lazy_world(observe):
    """The table world with a temporary archetype emitted lazily before the
    reset node and cleared after it; with ``observe``, a node between the
    reset and the clear reads the rows."""
    Faller = P.Archetype("ResetLazyFaller", [pbase.Position])
    Tmp = P.Archetype("ResetLazyTmp", [pbase.Position])
    built, seen = [], []

    class LazyWorld:
        @staticmethod
        def register_types(registry):
            pbase.register_types(registry)
            registry.register_archetype(Faller, capacity=4)
            registry.register_archetype(Tmp, capacity=2, temporary=True)

        init = staticmethod(cases.table_world(P, pbase, torch, "ResetLazyFaller").init)

        @staticmethod
        def setup_tasks(builder):
            def fall(ctx):
                pos = ctx.column(Faller, pbase.Position)
                ctx.set_column(Faller, pbase.Position, pos - torch.tensor([0.0, 0.0, 1.0]))
                # user data the fresh state lacks: the merge keeps it
                ctx.data = dict(ctx.data, last_z=pos[:, 0, 2])

                def values():
                    built.append(1)
                    return {pbase.Position: pos[:, :2]}

                ctx.emit_temporaries(Tmp, counts=lambda: torch.full((W,), 2, dtype=torch.int32),
                                     values=values)

            n = builder.add_node(fall)

            def hit_ground(ctx):
                return ctx.column(Faller, pbase.Position)[:, 0, 2] <= 0.0

            r = builder.reset_node(hit_ground, LazyWorld.init, [n])
            deps = [r]
            if observe:
                def read(ctx):
                    seen.append((ctx.row_mask(Tmp).clone(), ctx.tick.clone()))
                deps = [builder.add_node(read, [r])]
            builder.clear_tmp_node(Tmp, deps)

    return LazyWorld, built, seen


def test_reset_keeps_unread_temporaries_unbuilt():
    world, built, _ = lazy_world(observe=False)
    sim = port_sim(world)
    sim.run(12)
    assert built == []


def test_reset_merges_read_temporaries():
    """Read after the reset node, a done world's temporary rows are the
    fresh state's (none), the other worlds' the emitted two."""
    world, built, seen = lazy_world(observe=True)
    sim = port_sim(world)
    sim.run(12)
    assert len(built) == 12
    assert sim.state["user"]["last_z"].shape == (W,)
    resets = 0
    for mask, tick in seen[1:]:            # (every world starts at tick 0)
        done = tick == 0                   # the reset node restarted the tick
        resets += int(done.sum())
        assert not mask[done].any()
        assert mask[~done].sum(dim=1).eq(2).all()
        assert isinstance(sim.state["arch"]["ResetLazyTmp"], dict)
    assert resets >= W


@pytest.mark.parametrize("which", ["table", "random"])
def test_reset_state_layout(which):
    """After resets the state keeps the initial state's leaves, shapes and
    dtypes, and no leaf is a lazy store."""
    sim = port_sim(PTABLE if which == "table" else PRANDOM)
    init = _leaves(state_to_numpy(sim.state))
    sim.run(15)
    assert not any(isinstance(a, LazyRows) for a in sim.state["arch"].values())
    now = _leaves(state_to_numpy(sim.state))
    assert now.keys() == init.keys()
    for path in init:
        assert now[path].shape == init[path].shape and now[path].dtype == init[path].dtype
