"""TaskGraph: dependency-ordered system nodes run in order each step.

Counterpart of ``gpu_ecs_madrona_tpu/core/taskgraph.py`` (reference
Builder + topological sort, include/madrona/taskgraph.hpp:41-83,
src/core/taskgraph.cpp:46-109).  PyTorch runs eagerly: ``step`` calls
every node in sorted order, and every node operates on all worlds at once.

``parallel_for_node`` calls its row function ONCE on the batched
``[W, cap, ...]`` columns (the JAX package vmaps it over worlds and rows);
the live-row mask gates the write-back.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gpu_ecs_madrona_tpu_torch.core.component import Archetype, Component
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows, SimState, StateManager, mix64


@dataclasses.dataclass(frozen=True)
class NodeID:
    """Handle returned by builder methods, used to express dependencies
    (reference TaskGraph::NodeID, taskgraph.hpp:33-39)."""

    idx: int


@dataclasses.dataclass
class RowCtx:
    """Batched row view handed to ParallelFor system functions.

    Every field covers all rows of all worlds at once: ``data`` and
    ``singletons`` keep their leading [W] axis; ``key``, ``world``,
    ``row``, ``tick`` and ``live`` are [W, cap] tensors (``key`` is an
    int64 per-row generator key when the node asked for one, else 0).
    """

    data: Any
    singletons: Dict[str, Any]
    key: torch.Tensor
    world: torch.Tensor
    row: torch.Tensor
    tick: torch.Tensor
    live: torch.Tensor

    def singleton(self, comp: Component):
        return self.singletons[comp.name]


@dataclasses.dataclass
class _Node:
    name: str
    run: Callable[[Context], None]
    deps: Tuple[int, ...]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


class TaskGraphBuilder:
    """Stage nodes + dependencies, then build a sorted TaskGraph.

      addNodeFn           -> add_node
      parallelForNode     -> parallel_for_node
      ClearTmpNode        -> clear_tmp_node
      ResetTmpAllocNode   -> reset_tmp_alloc_node (a no-op node: temporaries
                             are fixed-capacity archetypes)
      (no reference node) -> reset_node (per-world episode auto-reset)
    """

    def __init__(self, mgr: StateManager):
        self.mgr = mgr
        self._nodes: List[_Node] = []

    # -- generic nodes -----------------------------------------------------

    def add_node(
        self,
        fn: Callable[[Context], None],
        deps: Sequence[NodeID] = (),
        name: Optional[str] = None,
    ) -> NodeID:
        name = name or getattr(fn, "__name__", f"node{len(self._nodes)}")
        self._nodes.append(_Node(name=name, run=fn, deps=tuple(d.idx for d in deps)))
        return NodeID(len(self._nodes) - 1)

    # -- parallel-for over archetype rows ---------------------------------

    def parallel_for_node(
        self,
        fn: Callable,
        components: Sequence[Component],
        deps: Sequence[NodeID] = (),
        archetypes: Optional[Sequence[Archetype]] = None,
        name: Optional[str] = None,
        needs_rng: bool = False,
    ) -> NodeID:
        """Run ``fn(rowctx, *component_columns) -> updated columns`` over
        every row of every archetype containing ``components``.

        ``fn`` gets the whole [W, cap, ...] columns in one call; returned
        values write back only where the row mask is set, so fn must
        tolerate garbage values on dead rows.  Matches reference
        ParallelForNode semantics (taskgraph.hpp:99-113).
        """
        components = tuple(components)
        mgr = self.mgr
        name = name or getattr(fn, "__name__", "parallel_for")

        def run(ctx: Context):
            matches = (
                [mgr.registry.archetypes[a.name] for a in archetypes]
                if archetypes is not None
                else mgr.registry.archetypes_with(*components)
            )
            W = mgr.num_worlds
            for path, leaf in _leaves(ctx.data):
                if leaf.ndim == 0 or leaf.shape[0] != W:
                    raise ValueError(
                        f"ctx.data leaf {path} has shape {tuple(leaf.shape)}; "
                        f"every user-data leaf needs a leading num_worlds={W} "
                        "axis (expand constants or close over them in the "
                        "system fn)")
            singles = {sname: mgr.get_singleton(ctx.state, comp)
                       for sname, comp in mgr.registry.singletons.items()}
            for info in matches:
                arch = info.archetype
                cap = info.capacity
                mask = ctx.row_mask(arch)
                cols = [ctx.column(arch, c) for c in components]
                rows = torch.arange(cap, dtype=torch.int32, device=ctx.device)
                rows = rows.expand(W, cap)
                worlds = torch.arange(W, dtype=torch.int32, device=ctx.device)
                worlds = worlds[:, None].expand(W, cap)
                if needs_rng:
                    key = mix64(ctx.rng_one()[:, None] ^ rows.long())
                else:
                    key = torch.zeros((W, cap), dtype=torch.int64, device=ctx.device)
                rowctx = RowCtx(data=ctx.data, singletons=singles, key=key,
                                world=worlds, row=rows,
                                tick=ctx.tick[:, None].expand(W, cap), live=mask)
                out = fn(rowctx, *cols)
                if len(components) == 1 and not isinstance(out, tuple):
                    out = (out,)
                for comp, old, new in zip(components, cols, out):
                    if comp.scalar:
                        merged = _masked(mask, new, old)
                    else:
                        merged = {f: _masked(mask, new[f], old[f]) for f in old}
                    ctx.set_column(arch, comp, merged)

        return self.add_node(run, deps, name=name)

    # -- temporaries -------------------------------------------------------

    def clear_tmp_node(self, arch: Archetype, deps: Sequence[NodeID] = ()) -> NodeID:
        """reference ClearTmpNode (taskgraph.hpp:125-134)."""

        def clear(ctx: Context):
            ctx.clear_archetype(arch)

        return self.add_node(clear, deps, name=f"clear_{arch.name}")

    # -- episode reset -------------------------------------------------------

    def reset_node(
        self,
        condition_fn: Callable[[Context], torch.Tensor],
        init_fn: Callable[[Context], None],
        deps: Sequence[NodeID] = (),
        name: str = "episode_reset",
    ) -> NodeID:
        """Per-world episode auto-reset (the RL pattern the reference leaves
        to user code): worlds where ``condition_fn(ctx) -> [W] bool`` is
        True are rebuilt by running ``init_fn`` (normally the world class's
        ``init``) on a pristine state.

        Each reset world's fresh generator stream derives from a key drawn
        from its running stream, so episodes differ across resets and
        worlds while the whole run stays deterministic by seed (the draws
        are the port's, not the JAX package's).  Other worlds are
        untouched (a per-leaf ``torch.where`` on the worlds axis, no host
        sync: ``init_fn`` runs every step).  Reset worlds restart at tick 0.
        Lazily emitted rows stay lazy: their merge is built when read.
        """
        mgr = self.mgr
        pristine = []   # the initial state, made once (no op writes it)

        def run(ctx: Context):
            done = condition_fn(ctx)
            keys = ctx.rng_one()
            if not pristine:
                pristine.append(mgr.make_initial_state(seed=0))
            fresh = dict(pristine[0])
            fresh["rng"] = torch.stack([mix64(keys), torch.zeros_like(keys)], dim=1)
            fctx = Context(mgr, fresh)
            init_fn(fctx)
            ctx.set_state(_merge_worlds(done, ctx.state, fctx.state))

        return self.add_node(run, deps, name=name)

    def reset_tmp_alloc_node(self, deps: Sequence[NodeID] = ()) -> NodeID:
        """reference ResetTmpAllocNode (taskgraph.hpp:115-123) — no bump
        allocator to reset; kept as an explicit no-op for graph parity."""

        def noop(ctx: Context):
            pass

        return self.add_node(noop, deps, name="reset_tmp_alloc")

    # -- build -------------------------------------------------------------

    def build(self) -> "TaskGraph":
        """Topological sort preserving insertion order among ready nodes —
        same discipline as reference taskgraph.cpp:46-109."""
        n = len(self._nodes)
        indeg = [0] * n
        dependents: List[List[int]] = [[] for _ in range(n)]
        for i, node in enumerate(self._nodes):
            indeg[i] = len(node.deps)
            for d in node.deps:
                dependents[d].append(i)
        order: List[int] = []
        ready = [i for i in range(n) if indeg[i] == 0]
        while ready:
            i = ready.pop(0)
            order.append(i)
            for j in dependents[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != n:
            raise ValueError("taskgraph has a dependency cycle")
        return TaskGraph(self.mgr, [self._nodes[i] for i in order])


def _masked(mask, new, old):
    new = torch.as_tensor(new, dtype=old.dtype, device=old.device)
    return torch.where(mask.reshape(mask.shape + (1,) * (old.ndim - 2)), new, old)


def _merge_worlds(done: torch.Tensor, cur, ini):
    """``ini``'s worlds where ``done`` [W] is set and ``cur``'s elsewhere,
    leaf by leaf (every state leaf has a leading worlds axis).  A key that
    only ``cur`` holds (user data a node added) keeps its value; a leaf
    both sides share is kept as it is; rows that either side has not built
    yet are merged when they are read."""
    if isinstance(cur, torch.Tensor):
        if cur is ini:
            return cur
        return torch.where(done.reshape(done.shape + (1,) * (cur.ndim - 1)), ini, cur)
    if not isinstance(cur, Mapping):
        return cur
    if any(isinstance(s, LazyRows) and not s.built for s in (cur, ini)):
        return LazyRows(lambda: _merge_worlds(done, dict(cur), dict(ini)))
    return {k: (_merge_worlds(done, v, ini[k]) if k in ini else v) for k, v in cur.items()}


class TaskGraph:
    """A sorted node list; ``step`` runs every node in order."""

    def __init__(self, mgr: StateManager, nodes: List[_Node]):
        self.mgr = mgr
        self.nodes = nodes

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]

    def step(self, state: SimState) -> SimState:
        """One simulation step across all worlds (reference megakernel node
        loop, megakernel_impl.inl:27-40), ending with the tick advance."""
        ctx = Context(self.mgr, state)
        for node in self.nodes:
            node.run(ctx)
        ctx.advance_tick()
        return ctx.state
