"""Context — the imperative façade system code sees during a step (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/core/context.py`` (reference Context,
include/madrona/context.hpp:17-159).  Every "mutation" rebinds the
underlying state dict to new tensors.  All accessors operate on the full
worlds batch: components come back with a leading [num_worlds, ...] axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from gpu_ecs_madrona_tpu_torch.core.component import Archetype, Component
from gpu_ecs_madrona_tpu_torch.core.state import SimState, StateManager, rng_keys


class Context:
    """Mutable view over a SimState during one step."""

    def __init__(self, mgr: StateManager, state: SimState):
        self._mgr = mgr
        self._state = dict(state)

    # -- raw state ---------------------------------------------------------

    @property
    def state(self) -> SimState:
        return self._state

    def set_state(self, state: SimState):
        """Replace the underlying state wholesale."""
        self._state = dict(state)

    @property
    def mgr(self) -> StateManager:
        return self._mgr

    @property
    def num_worlds(self) -> int:
        return self._mgr.num_worlds

    @property
    def device(self) -> torch.device:
        return self._mgr.device

    # -- per-world user data (reference ctx.data() / WorldBase) ------------

    @property
    def data(self) -> Dict[str, Any]:
        return self._state["user"]

    @data.setter
    def data(self, value):
        self._state["user"] = value

    # -- entity lifecycle ---------------------------------------------------

    def make_entities(self, arch: Archetype, counts, max_new: int,
                      values: Optional[Dict[Component, Any]] = None) -> torch.Tensor:
        """Batched makeEntityNow (reference context.hpp:33-35)."""
        self._state, ents = self._mgr.make_entities(
            self._state, arch, counts, max_new, values)
        return ents

    def destroy_entities(self, ents, valid=None):
        """Batched destroyEntityNow (reference context.hpp:50-52)."""
        self._state = self._mgr.destroy_entities(self._state, ents, valid)

    def clear_archetype(self, arch: Archetype):
        self._state = self._mgr.clear_archetype(self._state, arch)

    def destroy_rows(self, arch: Archetype, dead):
        """Scatter-free destroy-by-row-mask (see StateManager.destroy_rows)."""
        self._state = self._mgr.destroy_rows(self._state, arch, dead)

    def emit_temporaries(self, arch: Archetype, counts, values,
                         count_overflow: bool = True, width: Optional[int] = None):
        """Fast creation into an empty temporary archetype, eager or lazy
        (see StateManager.emit_temporaries)."""
        self._state = self._mgr.emit_temporaries(
            self._state, arch, counts, values,
            count_overflow=count_overflow, width=width)

    def add_overflow(self, arch: Archetype, counts):
        """Account capacity-shaped losses into ``arch``'s per-world
        overflow counter (read by TaskGraphExecutor.overflow_counters())."""
        ov = dict(self._state["overflow"])
        ov[arch.name] = ov[arch.name] + torch.as_tensor(
            counts, dtype=torch.int32, device=self.device)
        self._state["overflow"] = ov

    # -- component access ---------------------------------------------------

    def get(self, comp: Component, ents) -> Tuple[Any, torch.Tensor]:
        """Gather by entity handle; returns (values, live_mask)."""
        return self._mgr.get_component(self._state, comp, ents)

    def set(self, comp: Component, ents, value, valid=None):
        self._state = self._mgr.set_component(self._state, comp, ents, value, valid)

    def column(self, arch: Archetype, comp: Component):
        """Direct SoA column [W, cap, ...] (reference ArchetypeRef::component)."""
        return self._mgr.column(self._state, arch, comp)

    def set_column(self, arch: Archetype, comp: Component, value):
        self._state = self._mgr.set_column(self._state, arch, comp, value)

    def row_mask(self, arch: Archetype) -> torch.Tensor:
        return self._mgr.row_mask(self._state, arch)

    def entity_column(self, arch: Archetype) -> torch.Tensor:
        return self._mgr.entity_column(self._state, arch)

    def num_rows(self, arch: Archetype) -> torch.Tensor:
        return self._mgr.num_rows(self._state, arch)

    # -- queries -------------------------------------------------------------

    def query(self, *comps):
        """reference ctx.query<Components...>() (context.hpp:107-110)."""
        return self._mgr.query(*comps)

    def for_each(self, query, comps, fn):
        """reference ctx.forEach(query, fn): calls fn(archetype, columns,
        mask) per matching archetype — batch-level."""
        for arch, cols, mask in self._mgr.query_columns(self._state, query, comps):
            fn(arch, cols, mask)

    # -- singletons ----------------------------------------------------------

    def singleton(self, comp: Component):
        """reference ctx.getSingleton<T>() (context.hpp:96-98)."""
        return self._mgr.get_singleton(self._state, comp)

    def set_singleton(self, comp: Component, value):
        self._state = self._mgr.set_singleton(self._state, comp, value)

    # -- tick / RNG ----------------------------------------------------------

    @property
    def tick(self) -> torch.Tensor:
        return self._state["tick"]

    def advance_tick(self):
        self._state["tick"] = self._state["tick"] + 1

    def rng(self, n: int = 1) -> torch.Tensor:
        """Draw ``n`` fresh keys per world from the port's counter-based
        per-world stream: int64 [W, n] (see core/state.py for the layout;
        ``state.uniform`` turns a key into draws).  Same seed, same keys;
        different worlds, different keys."""
        self._state["rng"], keys = rng_keys(self._state["rng"], n)
        return keys

    def rng_one(self) -> torch.Tensor:
        """One fresh key per world, int64 [W]."""
        return self.rng(1)[:, 0]
