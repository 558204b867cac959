"""SimState + StateManager: the batched ECS store and its ops (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/core/state.py``.  The state is a
nested dict of tensors with the same keys, shapes and dtypes as the JAX
package's ``make_initial_state``, so a JAX state converts leaf by leaf
(``interop.state_from_numpy``).  The one exception is ``rng``: the port
keeps its own counter-based generator (layout below).

  - per-archetype SoA tensors with a leading ``[num_worlds, capacity]``
    axis and a boolean ``mask`` of live rows; capacities are static and
    rows are freed by clearing mask bits;
  - per-world id tables (``loc_arch``/``loc_row``/``gen``) with
    deterministic lowest-index-first slot allocation (cumsum ranking).

All ops are functional: they take a state dict and return a new one, and
never write a state tensor in place.  Unchanged tensors are shared between
the old and the new state (and a cleared archetype shares one cached
all-empty store), so callers must copy a tensor before editing it.

Temporary rows may be emitted lazily (``emit_temporaries`` with callables):
eager PyTorch has no dead-code elimination, so rows that nothing reads
before the archetype is cleared are then never built.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from gpu_ecs_madrona_tpu_torch.core.component import (
    ENTITY_GEN_MASK,
    Archetype,
    Component,
    Entity,
)
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.utils import debug

SimState = Dict[str, Any]


# ---------------------------------------------------------------------------
# Per-world counter-based generator
# ---------------------------------------------------------------------------
#
# state["rng"] is int64 [W, 2]: column 0 is the world's stream key, column
# 1 counts the keys drawn from it.  Key i of a stream is
# mix64(stream + (count + i) * GOLDEN); a draw of N values from key k is
# mix64(k + (j + 1) * GOLDEN2) for j < N, with the top 24 bits as a float
# in [0, 1).  mix64 is the splitmix64 finaliser on wrapping int64
# arithmetic.  The same seed gives the same bits on the CPU and the card;
# the numbers differ from the JAX package's threefry keys.

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_GOLDEN2 = 0xD1B54A32D192ED03 - (1 << 64)
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_C2 = 0x94D049BB133111EB - (1 << 64)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 finaliser on int64 tensors (logical shifts by masking)."""
    z = (z ^ ((z >> 30) & ((1 << 34) - 1))) * _C1
    z = (z ^ ((z >> 27) & ((1 << 37) - 1))) * _C2
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def rng_streams(seed: int, num_worlds: int, device="cpu") -> torch.Tensor:
    """Initial generator state [W, 2] int64: one stream per world."""
    base = mix64(torch.tensor(int(seed) & ((1 << 63) - 1), dtype=torch.int64))
    w = torch.arange(num_worlds, dtype=torch.int64)
    streams = mix64(base + (w + 1) * _GOLDEN)
    return torch.stack([streams, torch.zeros_like(streams)], dim=1).to(device)


def rng_keys(rng: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` keys per world: (new rng [W, 2], keys [W, n] int64)."""
    i = torch.arange(n, dtype=torch.int64, device=rng.device)
    keys = mix64(rng[:, :1] + (rng[:, 1:] + i) * _GOLDEN)
    new = torch.stack([rng[:, 0], rng[:, 1] + n], dim=1)
    return new, keys


def _bits24(keys: torch.Tensor, shape) -> torch.Tensor:
    """24 random bits per draw, int64: keys [...] -> [..., *shape]."""
    shape = tuple(shape)
    count = 1
    for s in shape:
        count *= s
    j = torch.arange(1, count + 1, dtype=torch.int64, device=keys.device)
    bits = mix64(keys[..., None] + j * _GOLDEN2)
    return ((bits >> 40) & 0xFFFFFF).reshape(keys.shape + shape)


def randint(keys: torch.Tensor, shape, low: int, high: int) -> torch.Tensor:
    """Integer int32 draws in [low, high) (high - low <= 2^24):
    keys [...] -> [..., *shape]."""
    return (low + _bits24(keys, shape) % (high - low)).to(torch.int32)


def uniform(keys: torch.Tensor, shape, low=0.0, high=1.0) -> torch.Tensor:
    """Uniform float32 draws in [low, high): keys [...] -> [..., *shape].
    ``low``/``high`` broadcast against the trailing ``shape``."""
    u = _bits24(keys, shape).to(torch.float32) * (1.0 / (1 << 24))
    low = torch.as_tensor(low, dtype=torch.float32, device=keys.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=keys.device)
    return low + (high - low) * u


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32 draws (Box-Muller on two 24-bit uniforms):
    keys [...] -> [..., *shape]."""
    bits = _bits24(keys, tuple(shape) + (2,)).to(torch.float32) * (1.0 / (1 << 24))
    u1 = 1.0 - bits[..., 0]                  # (0, 1]: log stays finite
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * bits[..., 1])


# ---------------------------------------------------------------------------
# Batched gather/scatter helpers (rows may be -1 = invalid)
# ---------------------------------------------------------------------------


def _expand_rows(idx: torch.Tensor, trailing) -> torch.Tensor:
    return idx.reshape(idx.shape + (1,) * len(trailing)).expand(idx.shape + tuple(trailing))


def batched_gather(arr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """arr: [W, cap, ...]; rows: [W, K] (entries may be invalid; clipped).

    Returns [W, K, ...].  Callers mask out invalid rows themselves.
    """
    cap = arr.shape[1]
    safe = rows.clamp(0, cap - 1).long()
    return torch.gather(arr, 1, _expand_rows(safe, arr.shape[2:]))


def batched_scatter(arr: torch.Tensor, rows: torch.Tensor, values,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter values [W, K, ...] into a copy of arr [W, cap, ...] at rows
    [W, K].

    Invalid rows (negative, or ``valid`` False) are dropped: they are
    routed to an extra row ``cap`` that is sliced off afterwards (the
    counterpart of JAX's ``mode="drop"``).
    """
    W, cap = arr.shape[0], arr.shape[1]
    trailing = arr.shape[2:]
    ok = rows >= 0
    if valid is not None:
        ok = ok & valid
    idx = torch.where(ok, rows, cap).long()
    buf = torch.cat([arr, arr.new_zeros((W, 1) + tuple(trailing))], dim=1)
    values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    full = idx.shape + tuple(trailing)
    buf.scatter_(1, _expand_rows(idx, trailing), values.expand(full))
    return buf[:, :cap].contiguous()


def lookup_entities(eid_state, ents: torch.Tensor):
    """Entity handles [W, K] (of any integer type: a handle kept in an int32
    field reads as one of generation 0 under 64-bit handles, as in the JAX
    package) -> (arch_index, row, live bool), each [W, K], read from the
    entity store ``eid_state`` (loc_arch, loc_row, gen [W, E] int32); the
    stored generation is masked to the handles' generation bits, as JAX's
    ``lookup`` does."""
    eids = Entity.id(ents)
    gens = Entity.gen(ents)
    cur_gen = batched_gather(eid_state["gen"], eids)
    loc_arch = batched_gather(eid_state["loc_arch"], eids)
    loc_row = batched_gather(eid_state["loc_row"], eids)
    live = (~Entity.is_null(ents)) & (loc_arch >= 0) & (
        (cur_gen & ENTITY_GEN_MASK) == gens)
    return loc_arch, loc_row, live


def entity_rows(eid_state, ents: torch.Tensor, arch_index: int) -> torch.Tensor:
    """The rows of entity handles [W, K] in archetype ``arch_index``: -1
    unless the handle is live and its entity in that archetype."""
    loc_arch, loc_row, live = lookup_entities(eid_state, ents)
    return torch.where(live & (loc_arch == arch_index), loc_row, -1)


def _alloc_slots(free: torch.Tensor, count: torch.Tensor, k: int) -> torch.Tensor:
    """Pick the first ``count[w]`` free slot indices of each world
    (lowest-index-first).

    free: bool [W, cap]; count: int32 [W]; returns int32 [W, k], -1 past
    count or when free slots run out.
    """
    W, cap = free.shape
    ranks = torch.cumsum(free.to(torch.int32), dim=1) - 1  # rank among free
    take = free & (ranks < k)
    dest = torch.where(take, ranks, k).long()  # k = dropped
    rows = torch.full((W, k + 1), -1, dtype=torch.int32, device=free.device)
    slots = torch.arange(cap, dtype=torch.int32, device=free.device).expand(W, cap)
    rows.scatter_(1, dest, slots)
    rows = rows[:, :k]
    valid = torch.arange(k, device=free.device)[None, :] < count[:, None]
    return torch.where(valid & (rows >= 0), rows, -1)


# ---------------------------------------------------------------------------
# Lazily built temporary rows
# ---------------------------------------------------------------------------


class LazyRows(Mapping):
    """An archetype's ``{"mask", "entity", "comps"}`` whose tensors are
    built on first read.  Reading any key (directly, or through
    ``column``, ``row_mask``, ``num_rows``, ``entity_column``, an export
    or a checkpoint) runs the builder once; ``clear_archetype`` replaces
    the entry without reading it, so an unobserved emission costs nothing.
    """

    _KEYS = ("mask", "entity", "comps")

    def __init__(self, build: Callable[[], Dict[str, Any]]):
        self._build = build
        self._rows = None

    @property
    def built(self) -> bool:
        return self._rows is not None

    def _get(self):
        if self._rows is None:
            self._rows = self._build()
            self._build = None
        return self._rows

    def __getitem__(self, key):
        return self._get()[key]

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)


# ---------------------------------------------------------------------------
# StateManager
# ---------------------------------------------------------------------------


class StateManager:
    """Static schema + construction/ops for the batched ECS state.

    The analog of reference StateManager (src/core/state.cpp) minus all
    runtime allocation: every capacity is fixed at construction.  All
    tensors it creates live on ``device``.
    """

    def __init__(
        self,
        registry: ECSRegistry,
        num_worlds: int,
        max_entities_per_world: Optional[int] = None,
        device="cpu",
    ):
        registry.freeze()
        self.registry = registry
        self.num_worlds = int(num_worlds)
        self.device = torch.device(device)
        total_cap = sum(info.capacity for info in registry.archetypes.values())
        self.max_entities = int(max_entities_per_world or max(total_cap, 1))
        self.arch_index = {name: info.index for name, info in registry.archetypes.items()}
        self._empty_rows: Dict[str, Dict[str, Any]] = {}

    # -- construction -----------------------------------------------------

    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _empty(self, name: str) -> Dict[str, Any]:
        """The all-empty store of an archetype (mask False, entity -1,
        components zero).  Built once and shared by every state that holds
        the archetype empty, since state tensors are never written in
        place."""
        rows = self._empty_rows.get(name)
        if rows is None:
            info = self.registry.archetypes[name]
            W, cap = self.num_worlds, info.capacity
            rows = {
                "mask": self._zeros((W, cap), torch.bool),
                "entity": torch.full((W, cap), -1, dtype=Entity.dtype, device=self.device),
                "comps": {
                    comp.name: {
                        fname: self._zeros((W, cap) + tuple(shape), dtype)
                        for fname, (shape, dtype) in comp.fields
                    }
                    for comp in info.archetype.components
                },
            }
            self._empty_rows[name] = rows
        return {"mask": rows["mask"], "entity": rows["entity"],
                "comps": {c: dict(f) for c, f in rows["comps"].items()}}

    def make_initial_state(self, seed: int = 0) -> SimState:
        W = self.num_worlds
        singles = {
            name: {fname: self._zeros((W,) + tuple(shape), dtype)
                   for fname, (shape, dtype) in comp.fields}
            for name, comp in self.registry.singletons.items()
        }
        return {
            "arch": {name: self._empty(name) for name in self.registry.archetypes},
            "eid": {
                "loc_arch": torch.full((W, self.max_entities), -1,
                                       dtype=torch.int32, device=self.device),
                "loc_row": torch.full((W, self.max_entities), -1,
                                      dtype=torch.int32, device=self.device),
                "gen": self._zeros((W, self.max_entities), torch.int32),
            },
            "singleton": singles,
            "user": {},
            "rng": rng_streams(seed, W, self.device),
            "tick": self._zeros((W,), torch.int32),
            # per-world, per-archetype dropped-create counters (the masked
            # analog of the reference's capacity asserts)
            "overflow": {name: self._zeros((W,), torch.int32)
                         for name in self.registry.archetypes},
        }

    def _counts(self, counts) -> torch.Tensor:
        counts = torch.as_tensor(counts, dtype=torch.int32, device=self.device)
        return counts.expand(self.num_worlds)

    # -- entity lifecycle -------------------------------------------------

    def make_entities(
        self,
        state: SimState,
        arch: Archetype,
        counts,  # int32 [W] (or python int broadcast)
        max_new: int,
        values: Optional[Dict[Component, Any]] = None,
    ) -> Tuple[SimState, torch.Tensor]:
        """Create up to ``counts[w]`` entities per world (max_new static cap).

        Returns (new_state, entities [W, max_new] of Entity.dtype; -1 where
        not created).  Overflow (table or id space full) drops the excess
        creates and increments the per-world overflow counter.
        """
        W = self.num_worlds
        info = self.registry.archetypes[arch.name]
        astate = state["arch"][arch.name]
        counts = self._counts(counts)

        rows = _alloc_slots(~astate["mask"], counts, max_new)  # [W, K]
        id_free = state["eid"]["loc_arch"] < 0
        eids = _alloc_slots(id_free, counts, max_new)  # [W, K]
        valid = (rows >= 0) & (eids >= 0)

        made = valid.sum(dim=1, dtype=torch.int32)
        dropped = counts.clamp(min=0) - made
        debug.check(dropped == 0,
                    "make_entities overflow on archetype "
                    f"{arch.name}: dropped={{}} per world", dropped)
        rows = torch.where(valid, rows, -1)
        eids = torch.where(valid, eids, -1)

        gens = batched_gather(state["eid"]["gen"], eids)
        ents = torch.where(valid, Entity.pack(eids, gens), -1)

        new_mask = batched_scatter(astate["mask"], rows, True)
        new_ent_col = batched_scatter(astate["entity"], rows, ents)
        new_comps = dict(astate["comps"])
        prepared = {}
        if values:
            for comp, val in values.items():
                prepared[comp.name] = comp.validate_value(val, (W, max_new), self.device)
        for comp in info.archetype.components:
            vals = prepared.get(comp.name)
            store = dict(new_comps[comp.name])
            for fname in store:
                v = vals[fname] if vals is not None else 0
                store[fname] = batched_scatter(store[fname], rows, v)
            new_comps[comp.name] = store

        new_arch = dict(state["arch"])
        new_arch[arch.name] = {"mask": new_mask, "entity": new_ent_col, "comps": new_comps}

        eid_state = state["eid"]
        new_loc_arch = batched_scatter(eid_state["loc_arch"], eids, info.index)
        new_loc_row = batched_scatter(eid_state["loc_row"], eids, rows)

        new_state = dict(state)
        new_state["arch"] = new_arch
        new_state["eid"] = {
            "loc_arch": new_loc_arch,
            "loc_row": new_loc_row,
            "gen": eid_state["gen"],
        }
        new_state["overflow"] = {
            **state["overflow"],
            arch.name: state["overflow"][arch.name] + dropped,
        }
        return new_state, ents

    def destroy_entities(
        self,
        state: SimState,
        ents: torch.Tensor,  # Entity.dtype [W, K]
        valid: Optional[torch.Tensor] = None,
    ) -> SimState:
        """Destroy entities (null/-1 and stale-generation handles ignored)."""
        eid_state = state["eid"]
        eids = Entity.id(ents)
        gens = Entity.gen(ents)
        ok = ~Entity.is_null(ents)
        if valid is not None:
            ok = ok & valid
        cur_gen = batched_gather(eid_state["gen"], eids)
        loc_arch = batched_gather(eid_state["loc_arch"], eids)
        loc_row = batched_gather(eid_state["loc_row"], eids)
        ok = ok & ((cur_gen & ENTITY_GEN_MASK) == gens) & (loc_arch >= 0)

        new_arch = dict(state["arch"])
        for name, info in self.registry.archetypes.items():
            sel = ok & (loc_arch == info.index)
            astate = new_arch[name]
            rows = torch.where(sel, loc_row, -1)
            mask = batched_scatter(astate["mask"], rows, False)
            entc = batched_scatter(astate["entity"], rows, -1)
            new_arch[name] = {"mask": mask, "entity": entc, "comps": astate["comps"]}

        rel = torch.where(ok, eids, -1)
        new_loc_arch = batched_scatter(eid_state["loc_arch"], rel, -1)
        new_loc_row = batched_scatter(eid_state["loc_row"], rel, -1)
        cur = batched_gather(eid_state["gen"], rel)
        new_gen = batched_scatter(eid_state["gen"], rel, cur + 1)

        new_state = dict(state)
        new_state["arch"] = new_arch
        new_state["eid"] = {"loc_arch": new_loc_arch, "loc_row": new_loc_row, "gen": new_gen}
        return new_state

    def emit_temporaries(
        self,
        state: SimState,
        arch: Archetype,
        counts,
        values,
        count_overflow: bool = True,
        width: Optional[int] = None,
    ) -> SimState:
        """Fast-path creation into an EMPTY temporary archetype (reference
        ``makeTemporary`` rows): the new rows are the prefix 0..counts-1,
        so creation is a dense column write plus a prefix mask.

        ``values`` maps components to [W, K, ...] tensors with K <=
        capacity; counts is clipped to K (the clip increments the
        archetype's per-world overflow counter when ``count_overflow``).
        Rows have no entity handles (entity column = -1).  Only archetypes
        registered with ``temporary=True`` are accepted.

        Lazy emission: ``counts`` and ``values`` may each be a callable
        returning what it would otherwise be.  The rows are then built on
        first read (``LazyRows``) and never if the archetype is cleared
        first.  With ``count_overflow`` a callable ``counts`` is called at
        once, since the counter is state.  ``width`` gives K for callable
        ``values`` (default: the capacity).
        """
        info = self.registry.archetypes[arch.name]
        if not info.temporary:
            raise ValueError(
                f"emit_temporaries({arch.name}): archetype must be "
                "registered with temporary=True — emitting into a normal "
                "archetype would wholesale-replace its mask/entity columns "
                "and leak any live entity handles")
        cap = info.capacity
        W = self.num_worlds
        if callable(values):
            k = cap if width is None else width
        else:
            k = None
            for comp, val in values.items():
                first = val if comp.scalar else next(iter(val.values()))
                k = first.shape[1] if k is None else k
            if k is None:
                k = cap
        k = min(k, cap)

        new_state = dict(state)
        if count_overflow:
            if callable(counts):
                counts = counts()
            counts = self._counts(counts)
            dropped = counts.clamp(min=0) - counts.clamp(0, k)
            if debug.DEBUG:
                debug.check(dropped == 0,
                            "emit_temporaries overflow on archetype "
                            f"{arch.name} (capacity {cap}, K {k}): "
                            "dropped={} per world", dropped)
            new_state["overflow"] = {
                **state["overflow"],
                arch.name: state["overflow"][arch.name] + dropped,
            }

        empty = self._empty(arch.name)

        def build():
            c = self._counts(counts() if callable(counts) else counts)
            vals = values() if callable(values) else values
            comps = empty["comps"]
            for comp, val in vals.items():
                prepared = comp.validate_value(val, (W, k), self.device)
                store = dict(comps[comp.name])
                for fname, (shape, dtype) in comp.fields:
                    v = prepared[fname]
                    if k == cap:
                        store[fname] = v.contiguous()
                    else:
                        store[fname] = torch.cat(
                            [v, store[fname][:, k:]], dim=1)
                comps[comp.name] = store
            mask = (torch.arange(cap, device=self.device)[None, :]
                    < c.clamp(max=k)[:, None])
            return {"mask": mask, "entity": empty["entity"], "comps": comps}

        new_arch = dict(state["arch"])
        lazy = callable(counts) or callable(values)
        new_arch[arch.name] = LazyRows(build) if lazy else build()
        new_state["arch"] = new_arch
        return new_state

    def destroy_rows(self, state: SimState, arch: Archetype,
                     dead: torch.Tensor) -> SimState:
        """Destroy all rows of ``arch`` where ``dead`` [W, cap] is set
        (the scatter-free cleanup-query path: elementwise masking on the
        archetype, a gather through ``loc_row`` on the id table)."""
        info = self.registry.archetypes[arch.name]
        astate = state["arch"][arch.name]
        dead = dead & astate["mask"]

        new_arch = dict(state["arch"])
        new_arch[arch.name] = {
            "mask": astate["mask"] & ~dead,
            "entity": torch.where(dead, -1, astate["entity"]),
            "comps": astate["comps"],
        }

        eid_state = state["eid"]
        owned = eid_state["loc_arch"] == info.index
        dead_at_loc = batched_gather(dead, eid_state["loc_row"])
        sel = owned & dead_at_loc & (eid_state["loc_row"] >= 0)
        new_state = dict(state)
        new_state["arch"] = new_arch
        new_state["eid"] = {
            "loc_arch": torch.where(sel, -1, eid_state["loc_arch"]),
            "loc_row": torch.where(sel, -1, eid_state["loc_row"]),
            "gen": torch.where(sel, eid_state["gen"] + 1, eid_state["gen"]),
        }
        return new_state

    def clear_archetype(self, state: SimState, arch: Archetype) -> SimState:
        """Free every row of an archetype in every world (reference
        clearArchetype / ClearTmpNode, taskgraph.hpp:125-134).

        Component stores are zeroed (the shared empty store), and the old
        rows are not read: lazily emitted rows that nothing observed are
        dropped unbuilt."""
        info = self.registry.archetypes[arch.name]
        eid_state = state["eid"]
        owned = eid_state["loc_arch"] == info.index
        new_state = dict(state)
        new_state["eid"] = {
            "loc_arch": torch.where(owned, -1, eid_state["loc_arch"]),
            "loc_row": torch.where(owned, -1, eid_state["loc_row"]),
            "gen": torch.where(owned, eid_state["gen"] + 1, eid_state["gen"]),
        }
        new_arch = dict(state["arch"])
        new_arch[arch.name] = self._empty(arch.name)
        new_state["arch"] = new_arch
        return new_state

    # -- component access by entity handle --------------------------------

    def lookup(self, state: SimState, ents: torch.Tensor):
        """Entity handles -> (arch_index [..], row [..], live bool [..])."""
        return lookup_entities(state["eid"], ents)

    def get_component(self, state: SimState, comp: Component, ents: torch.Tensor):
        """Gather component values for entity handles [W, K] across every
        archetype holding the component.  Returns (value, live_mask)."""
        loc_arch, loc_row, live = self.lookup(state, ents)
        W, K = ents.shape[0], ents.shape[1]
        out = {fname: self._zeros((W, K) + tuple(shape), dtype)
               for fname, (shape, dtype) in comp.fields}
        found = self._zeros((W, K), torch.bool)
        for info in self.registry.archetypes_with(comp):
            sel = live & (loc_arch == info.index)
            store = state["arch"][info.archetype.name]["comps"][comp.name]
            for fname in out:
                v = batched_gather(store[fname], torch.where(sel, loc_row, 0))
                selb = sel.reshape(sel.shape + (1,) * (v.ndim - 2))
                out[fname] = torch.where(selb, v, out[fname])
            found = found | sel
        if comp.scalar:
            return out["value"], found
        return out, found

    def set_component(self, state: SimState, comp: Component, ents: torch.Tensor,
                      value: Any, valid: Optional[torch.Tensor] = None) -> SimState:
        """Scatter component values to entity handles [W, K]."""
        loc_arch, loc_row, live = self.lookup(state, ents)
        if valid is not None:
            live = live & valid
        W, K = ents.shape[0], ents.shape[1]
        prepared = comp.validate_value(value, (W, K), self.device)
        new_arch = dict(state["arch"])
        for info in self.registry.archetypes_with(comp):
            sel = live & (loc_arch == info.index)
            astate = new_arch[info.archetype.name]
            store = dict(astate["comps"][comp.name])
            rows = torch.where(sel, loc_row, -1)
            for fname in prepared:
                store[fname] = batched_scatter(store[fname], rows, prepared[fname])
            comps = dict(astate["comps"])
            comps[comp.name] = store
            new_arch[info.archetype.name] = {
                "mask": astate["mask"], "entity": astate["entity"], "comps": comps}
        new_state = dict(state)
        new_state["arch"] = new_arch
        return new_state

    # -- direct column access ---------------------------------------------

    def column(self, state: SimState, arch: Archetype, comp: Component):
        """The raw SoA column [W, cap, ...] (scalar comps unwrap)."""
        store = state["arch"][arch.name]["comps"][comp.name]
        if comp.scalar:
            return store["value"]
        return dict(store)

    def set_column(self, state: SimState, arch: Archetype, comp: Component,
                   value) -> SimState:
        astate = state["arch"][arch.name]
        old = astate["comps"][comp.name]
        if comp.scalar:
            value = {"value": value}
        new_store = {}
        for fname, oldarr in old.items():
            v = torch.as_tensor(value[fname], dtype=oldarr.dtype, device=oldarr.device)
            if v.shape != oldarr.shape:
                raise ValueError(
                    f"set_column {arch.name}.{comp.name}.{fname}: shape "
                    f"{tuple(v.shape)} != {tuple(oldarr.shape)}")
            new_store[fname] = v
        comps = dict(astate["comps"])
        comps[comp.name] = new_store
        new_arch = dict(state["arch"])
        new_arch[arch.name] = {"mask": astate["mask"], "entity": astate["entity"],
                               "comps": comps}
        new_state = dict(state)
        new_state["arch"] = new_arch
        return new_state

    def row_mask(self, state: SimState, arch: Archetype) -> torch.Tensor:
        return state["arch"][arch.name]["mask"]

    def entity_column(self, state: SimState, arch: Archetype) -> torch.Tensor:
        return state["arch"][arch.name]["entity"]

    def num_rows(self, state: SimState, arch: Archetype) -> torch.Tensor:
        """Live row count per world [W] (reference archetypeCount)."""
        return state["arch"][arch.name]["mask"].sum(dim=1, dtype=torch.int32)

    # -- queries (reference query.hpp / makeQuery) --------------------------

    def query(self, *comps):
        """A component-set query: the tuple of matching archetypes
        (reference StateManager::makeQuery).  Static — build once."""
        return tuple(self.registry.archetypes_with(*comps))

    def query_columns(self, state: SimState, query, comps):
        """Iterate a query: yields (archetype, [columns...], mask) per
        matching archetype (reference iterateArchetypes)."""
        for info in query:
            cols = [self.column(state, info.archetype, c) for c in comps]
            yield info.archetype, cols, self.row_mask(state, info.archetype)

    # -- singletons --------------------------------------------------------

    def get_singleton(self, state: SimState, comp: Component):
        store = state["singleton"][comp.name]
        if comp.scalar:
            return store["value"]
        return dict(store)

    def set_singleton(self, state: SimState, comp: Component, value) -> SimState:
        old = state["singleton"][comp.name]
        if comp.scalar:
            value = {"value": value}
        new_store = {f: torch.as_tensor(value[f], dtype=old[f].dtype,
                                        device=old[f].device).reshape(old[f].shape)
                     for f in old}
        singles = dict(state["singleton"])
        singles[comp.name] = new_store
        new_state = dict(state)
        new_state["singleton"] = singles
        return new_state
