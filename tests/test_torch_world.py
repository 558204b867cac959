"""The decorator-based world (core/world.py) of the PyTorch port against the
JAX package's: the same declarations through each package's ``World`` and
``system`` give equal exports (exactly: the systems add and stamp small
integers), inheritance and the unknown dependency likewise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_ecs_madrona_tpu as J
import gpu_ecs_madrona_tpu_torch as P
from gpu_ecs_madrona_tpu.core import base as jbase
from gpu_ecs_madrona_tpu_torch.core import base as pbase


def deco_worlds(pkg, base, xp, name):
    """DecoWorld and DecoChild of tests/test_world_decorators.py, built from
    ``pkg`` (either package) with ``xp`` for its arrays."""
    Mover = pkg.Archetype(name, [base.Position])

    def set_axis(pos, axis, value):
        if xp is jnp:
            return pos.at[..., axis].set(value)
        pos = pos.clone()
        pos[..., axis] = value
        return pos

    class DecoWorld(pkg.World):
        @staticmethod
        def register_types(registry):
            base.register_types(registry)
            registry.register_archetype(Mover, capacity=4)
            registry.export_column(Mover, base.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            W = ctx.num_worlds
            ctx.data = {"log": xp.zeros((W, 3))}
            ctx.make_entities(Mover, counts=2, max_new=2, values={
                base.Position: xp.zeros((W, 2, 3))})

        @pkg.system(components=[base.Position], archetypes=[Mover])
        def step_x(rowctx, pos):
            return pos + xp.asarray([1.0, 0.0, 0.0])

        @pkg.system()   # chains after step_x by declaration order
        def double_y(ctx):
            pos = ctx.column(Mover, base.Position)
            ctx.set_column(Mover, base.Position, set_axis(pos, 1, pos[..., 0] * 2))

        @pkg.system(after=["step_x"])
        def stamp_z(ctx):
            pos = ctx.column(Mover, base.Position)
            ctx.set_column(Mover, base.Position, set_axis(pos, 2, 7.0))

    class DecoChild(DecoWorld):
        @pkg.system(after=["stamp_z", DecoWorld.double_y])   # a name and a function
        def shift_all(ctx):
            pos = ctx.column(Mover, base.Position)
            ctx.set_column(Mover, base.Position, pos + 10.0)

    return DecoWorld, DecoChild


JWORLD, JCHILD = deco_worlds(J, jbase, jnp, "DecoMoverJ")
PWORLD, PCHILD = deco_worlds(P, pbase, torch, "DecoMoverP")


def exports(sim):
    vals, mask = sim.get_exported(0)
    return np.asarray(vals), np.asarray(mask)


@pytest.mark.parametrize("which", ["world", "child"])
def test_decorated_world_matches_jax(which):
    """3 steps of each package's world: graphs in the same order, exports
    equal exactly."""
    jcls, pcls = (JWORLD, PWORLD) if which == "world" else (JCHILD, PCHILD)
    jsim = J.TaskGraphExecutor(jcls, J.ExecutorConfig(num_worlds=2, seed=0))
    psim = P.TaskGraphExecutor(pcls, P.ExecutorConfig(num_worlds=2, seed=0, device="cpu"))
    assert psim.graph.node_names == [n.name for n in jsim.graph.nodes]
    jsim.run(3)
    psim.run(3)
    jv, jm = exports(jsim)
    pv, pm = exports(psim)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pv, jv)


def test_decorated_world_runs_in_order():
    sim = P.TaskGraphExecutor(PWORLD, P.ExecutorConfig(num_worlds=2, seed=0, device="cpu"))
    sim.run(3)
    p, mask = exports(sim)
    assert mask[:, :2].all() and not mask[:, 2:].any()
    np.testing.assert_array_equal(p[:, :2, 0], 3.0)
    np.testing.assert_array_equal(p[:, :2, 1], 6.0)
    np.testing.assert_array_equal(p[:, :2, 2], 7.0)


def test_decorated_world_inheritance():
    sim = P.TaskGraphExecutor(PCHILD, P.ExecutorConfig(num_worlds=2, seed=0, device="cpu"))
    assert sim.graph.node_names == ["step_x", "double_y", "stamp_z", "shift_all"]
    sim.run(1)
    p = exports(sim)[0]
    np.testing.assert_array_equal(p[:, :2, 0], 11.0)   # 1 + 10
    np.testing.assert_array_equal(p[:, :2, 2], 17.0)   # 7 + 10


def test_root_system_and_rng_flag():
    """``after=[]`` makes a root node (it runs first, before systems
    declared ahead of it); ``needs_rng`` hands the rows distinct keys."""
    Mover = P.Archetype("DecoRngMover", [pbase.Position])
    seen = {}

    class RootWorld(P.World):
        @staticmethod
        def register_types(registry):
            pbase.register_types(registry)
            registry.register_archetype(Mover, capacity=3)

        @staticmethod
        def init(ctx, init_data=None):
            ctx.make_entities(Mover, counts=3, max_new=3)

        @P.system(components=[pbase.Position], archetypes=[Mover], needs_rng=True)
        def keyed(rowctx, pos):
            seen["key"] = rowctx.key
            return pos

        @P.system(after=[])
        def root(ctx):
            seen.setdefault("order", []).append("root")

    sim = P.TaskGraphExecutor(RootWorld, P.ExecutorConfig(num_worlds=2, seed=3, device="cpu"))
    assert sim.graph.node_names == ["keyed", "root"]   # both ready: declaration order
    sim.step()
    keys = seen["key"]
    assert keys.shape == (2, 3) and len(set(keys.flatten().tolist())) == 6


@pytest.mark.parametrize("pkg,base", [(J, jbase), (P, pbase)], ids=["jax", "port"])
def test_unknown_dependency_raises(pkg, base):
    Mover = pkg.Archetype("DecoBadMover", [base.Position])

    class Bad(pkg.World):
        @staticmethod
        def register_types(registry):
            base.register_types(registry)
            registry.register_archetype(Mover, capacity=4)

        @staticmethod
        def init(ctx, init_data=None):
            ctx.data = {}

        @pkg.system(after=["nope"])
        def s(ctx):
            pass

    kw = {} if pkg is J else {"device": "cpu"}
    with pytest.raises(ValueError, match="nope"):
        pkg.TaskGraphExecutor(Bad, pkg.ExecutorConfig(num_worlds=1, seed=0, **kw))
