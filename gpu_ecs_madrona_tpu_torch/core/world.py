"""Decorator-based world definition — sugar over the builder protocol.

Counterpart of ``gpu_ecs_madrona_tpu/core/world.py``.  The raw protocol
(executor.py) mirrors the reference's registerTypes / setupTasks free
functions (mw_cpu.inl:5-44); this module declares systems as decorated
methods and wires the taskgraph from them.

    class MyWorld(World):
        @staticmethod
        def register_types(registry): ...
        @staticmethod
        def init(ctx, init_data=None): ...

        @system(components=[Position, Velocity])
        def integrate(rowctx, pos, vel):            # batched rows
            return pos + vel, vel

        @system()                                   # batch node
        def spawn(ctx): ...

        @system(after=["integrate"])                # explicit dependency
        def cleanup(ctx): ...

Ordering: systems chain in declaration order by default (each depends on
the previous one); pass ``after=[...]`` (names or function refs) for
explicit DAG edges, or ``after=[]`` for a root node.  Subclasses inherit
base-class systems (declared first).  A system with ``components`` is a
``parallel_for_node``: its function gets the whole [W, cap, ...] columns
in one call (core/taskgraph.py).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraphBuilder

_order_counter = itertools.count()


def system(fn: Optional[Callable] = None, *, components=None, archetypes=None,
           after: Optional[Sequence] = None, name: Optional[str] = None,
           needs_rng: bool = False):
    """Mark a world method as a taskgraph system.

    components given -> parallel_for_node (fn(rowctx, *columns));
    omitted -> batch node (fn(ctx)).  See the module doc for ordering.
    """

    def wrap(f):
        f._gem_system = {
            "order": next(_order_counter),
            "components": components,
            "archetypes": archetypes,
            "after": after,
            "name": name or f.__name__,
            "needs_rng": needs_rng,
        }
        return staticmethod(f)

    if fn is not None:
        return wrap(fn)
    return wrap


def _dep_name(a) -> str:
    if isinstance(a, str):
        return a
    return getattr(a, "__name__", None) or getattr(a, "__func__").__name__


class World:
    """Base class wiring @system-decorated methods into setup_tasks."""

    @classmethod
    def _systems(cls):
        seen = {}
        for klass in reversed(cls.__mro__):
            for attr in vars(klass).values():
                f = getattr(attr, "__func__", attr)
                meta = getattr(f, "_gem_system", None)
                if meta is not None:
                    seen[meta["name"]] = (meta["order"], f, meta)
        return sorted(seen.values(), key=lambda t: t[0])

    @classmethod
    def setup_tasks(cls, builder: TaskGraphBuilder):
        ids = {}
        prev = []
        for _, f, meta in cls._systems():
            if meta["after"] is None:
                deps = prev
            else:
                deps = []
                for a in meta["after"]:
                    key = _dep_name(a)
                    if key not in ids:
                        raise ValueError(
                            f"system {meta['name']!r}: dependency {key!r} "
                            "not declared earlier")
                    deps.append(ids[key])
            if meta["components"] is not None:
                nid = builder.parallel_for_node(
                    f, meta["components"], deps=deps,
                    archetypes=meta["archetypes"], name=meta["name"],
                    needs_rng=meta["needs_rng"])
            else:
                nid = builder.add_node(f, deps=deps, name=meta["name"])
            ids[meta["name"]] = nid
            prev = [nid]

    # default hooks (subclasses override)
    @staticmethod
    def register_types(registry):
        raise NotImplementedError

    @staticmethod
    def init(ctx, init_data=None):
        raise NotImplementedError
