"""ECSRegistry — registration of components, archetypes, singletons, exports.

Counterpart of ``gpu_ecs_madrona_tpu/core/registry.py`` (reference
ECSRegistry, include/madrona/state.hpp:109-134).  Registration happens in
Python before the state is built and freezes into a static schema.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

from gpu_ecs_madrona_tpu_torch.core.component import Archetype, Component

DEFAULT_CAPACITY = 1024


@dataclasses.dataclass
class ArchetypeInfo:
    archetype: Archetype
    capacity: int
    index: int
    # True for "temporary" archetypes cleared wholesale each step
    # (reference CandidateTemporary / ClearTmpNode, taskgraph.hpp:115-134).
    temporary: bool = False


@dataclasses.dataclass
class ExportInfo:
    slot: int
    archetype: Archetype
    comp: Component


class ECSRegistry:
    """Collects the world's ECS schema prior to state construction.

      registry.registerComponent<T>()        -> register_component(comp)
      registry.registerArchetype<A>()        -> register_archetype(arch, capacity=...)
      registry.registerSingleton<S>()        -> register_singleton(comp)
      registry.exportColumn<A, T>(slot)      -> export_column(arch, comp, slot)
    """

    def __init__(self):
        self.components: Dict[str, Component] = {}
        self.archetypes: Dict[str, ArchetypeInfo] = {}
        self.singletons: Dict[str, Component] = {}
        self.in_place_singletons: Set[str] = set()
        self.exports: Dict[int, ExportInfo] = {}
        self._frozen = False

    # -- registration -----------------------------------------------------

    def register_component(self, comp: Component) -> Component:
        self._check_mutable()
        existing = self.components.get(comp.name)
        if existing is not None and existing is not comp and existing != comp:
            raise ValueError(f"component {comp.name} registered twice with different specs")
        self.components[comp.name] = comp
        return comp

    def register_archetype(
        self,
        arch: Archetype,
        capacity: int = DEFAULT_CAPACITY,
        temporary: bool = False,
    ) -> Archetype:
        self._check_mutable()
        if arch.name in self.archetypes:
            raise ValueError(f"archetype {arch.name} registered twice")
        for comp in arch.components:
            self.register_component(comp)
        self.archetypes[arch.name] = ArchetypeInfo(
            archetype=arch,
            capacity=int(capacity),
            index=len(self.archetypes),
            temporary=temporary,
        )
        return arch

    def register_singleton(self, comp: Component, in_place: bool = False) -> Component:
        """Register a singleton component.  ``in_place``: a step may write
        its tensors in place (TaskGraphExecutor copies them when it takes
        a state in and when it saves one)."""
        self._check_mutable()
        self.singletons[comp.name] = comp
        if in_place:
            self.in_place_singletons.add(comp.name)
        return comp

    def export_column(self, arch: Archetype, comp: Component, slot: int):
        """Mark a component column for export (reference state.hpp:117-129).
        The exported tensor is the component column itself."""
        self._check_mutable()
        if arch.name not in self.archetypes:
            raise ValueError(f"archetype {arch.name} not registered")
        if not arch.has(comp):
            raise ValueError(f"archetype {arch.name} has no component {comp.name}")
        if slot in self.exports:
            raise ValueError(f"export slot {slot} already bound")
        self.exports[slot] = ExportInfo(slot=slot, archetype=arch, comp=comp)

    # -- queries over the schema ------------------------------------------

    def archetypes_with(self, *comps: Component) -> List[ArchetypeInfo]:
        """All archetypes containing every listed component, in registration
        order (reference query semantics, src/core/state.cpp makeQuery)."""
        return [info for info in self.archetypes.values()
                if all(info.archetype.has(c) for c in comps)]

    def freeze(self):
        self._frozen = True

    def _check_mutable(self):
        if self._frozen:
            raise RuntimeError("ECSRegistry is frozen; register before state construction")
