"""Component, Archetype and Entity definitions (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/core/component.py``:
  - a ``Component`` is a named, ordered set of fields, each field a
    (shape, torch dtype) leaf; storage is one tensor per field with a
    leading ``[num_worlds, capacity]`` axis;
  - an ``Archetype`` is a named, ordered set of component types;
  - an entity handle is one ``torch.int32`` (``torch.int64`` with
    ``GEM_TPU_ENTITY_64=1``) with the per-world entity id in the low bits
    and the generation in the high bits, with the same bit split and bit
    operations as the JAX package, so a converted state's handles decode
    the same.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Sequence, Tuple, Union

import torch

# Entity id bit layout (within one world's id space):
#   bits [0, ENTITY_ID_BITS)   : slot index into the world's entity store
#   bits [ENTITY_ID_BITS, ...) : generation counter (wraps)
# -1 is the null entity.  Both settings are read at import, as in the JAX
# package: by default handles are int32 with the split of
# GEM_TPU_ENTITY_ID_BITS (20/11); GEM_TPU_ENTITY_64=1 widens them to int64
# with a 32-bit id and a 31-bit generation (the reference's Entity{gen, id}
# headroom), so a slot's generation practically never wraps.  Component
# data stays float32 either way; the entity store's gen, loc_arch and
# loc_row columns stay int32.
ENTITY_64 = os.environ.get("GEM_TPU_ENTITY_64") == "1"
if ENTITY_64:
    ENTITY_ID_BITS = 32
    ENTITY_GEN_BITS = 31
else:
    ENTITY_ID_BITS = int(os.environ.get("GEM_TPU_ENTITY_ID_BITS", 20))
    assert 4 <= ENTITY_ID_BITS <= 27, ENTITY_ID_BITS
    ENTITY_GEN_BITS = 31 - ENTITY_ID_BITS
ENTITY_ID_MASK = (1 << ENTITY_ID_BITS) - 1
ENTITY_GEN_MASK = (1 << ENTITY_GEN_BITS) - 1

NULL_ENTITY = -1


class Entity:
    """Namespace for entity-handle helpers (handles are int32 tensors, int64
    with GEM_TPU_ENTITY_64=1; ``id`` and ``gen`` are int32 either way)."""

    dtype = torch.int64 if ENTITY_64 else torch.int32

    @staticmethod
    def pack(eid, gen):
        eid = torch.as_tensor(eid, dtype=Entity.dtype)
        gen = torch.as_tensor(gen, dtype=Entity.dtype)
        return (eid & ENTITY_ID_MASK) | ((gen & ENTITY_GEN_MASK) << ENTITY_ID_BITS)

    @staticmethod
    def id(e):
        # an id of up to 32 bits kept as int32, as the JAX package does
        # (entity stores stay far below 2^31 rows)
        return (torch.as_tensor(e, dtype=Entity.dtype) & ENTITY_ID_MASK).to(torch.int32)

    @staticmethod
    def gen(e):
        return ((torch.as_tensor(e, dtype=Entity.dtype) >> ENTITY_ID_BITS)
                & ENTITY_GEN_MASK).to(torch.int32)

    @staticmethod
    def is_null(e):
        return torch.as_tensor(e, dtype=Entity.dtype) < 0

    @staticmethod
    def null():
        return NULL_ENTITY


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

FieldSpec = Tuple[Tuple[int, ...], Any]  # (shape, torch dtype)


@dataclasses.dataclass(frozen=True)
class Component:
    """A named component type: an ordered mapping field -> (shape, dtype).

    ``scalar`` components have exactly one field named "value"; their values
    are passed to/returned from systems as the bare tensor, not a dict.
    """

    name: str
    fields: Tuple[Tuple[str, FieldSpec], ...]
    scalar: bool = False

    def __repr__(self):
        return f"Component({self.name})"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Component) and other.name == self.name

    @property
    def field_dict(self) -> Dict[str, FieldSpec]:
        return dict(self.fields)

    def zero_value(self, leading: Tuple[int, ...], device="cpu"):
        """A zero-initialised value with the given leading dims."""
        vals = {
            fname: torch.zeros(leading + tuple(shape), dtype=dtype, device=device)
            for fname, (shape, dtype) in self.fields
        }
        if self.scalar:
            return vals["value"]
        return vals

    def validate_value(self, value, leading: Tuple[int, ...], device="cpu"):
        """Broadcast/convert a user-provided value to storage layout."""
        if self.scalar:
            value = {"value": value}
        out = {}
        for fname, (shape, dtype) in self.fields:
            v = torch.as_tensor(value[fname], dtype=dtype, device=device)
            out[fname] = v.expand(leading + tuple(shape))
        return out


def component(
    name: str,
    spec: Union[FieldSpec, Dict[str, FieldSpec], None] = None,
    **field_kwargs: FieldSpec,
) -> Component:
    """Define a component type.

    ``component("Position", ((3,), torch.float32))`` — scalar (one tensor).
    ``component("Contact", normal=((3,), f32), a=((), i32))`` — struct.
    """
    if spec is not None and field_kwargs:
        raise ValueError("pass either a single spec or field kwargs, not both")
    if spec is None and not field_kwargs:
        raise ValueError(f"component {name} needs a field spec")
    if field_kwargs:
        fields = tuple((k, (tuple(v[0]), v[1])) for k, v in field_kwargs.items())
        return Component(name=name, fields=fields, scalar=False)
    if isinstance(spec, dict):
        fields = tuple((k, (tuple(v[0]), v[1])) for k, v in spec.items())
        return Component(name=name, fields=fields, scalar=False)
    shape, dtype = spec
    return Component(name=name, fields=(("value", (tuple(shape), dtype)),), scalar=True)


def singleton_component(name, spec=None, **field_kwargs) -> Component:
    """A singleton component (one instance per world, reference
    state.hpp registerSingleton / context.hpp getSingleton)."""
    return component(name, spec, **field_kwargs)


# ---------------------------------------------------------------------------
# Archetypes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Archetype:
    """An archetype: a named, ordered set of component types, with a static
    per-archetype capacity set at registration (reference
    ``Archetype<Components...>``, include/madrona/ecs.hpp)."""

    name: str
    components: Tuple[Component, ...]

    def __init__(self, name: str, components: Sequence[Component]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "components", tuple(components))
        seen = set()
        for c in self.components:
            if c.name in seen:
                raise ValueError(f"duplicate component {c.name} in archetype {name}")
            seen.add(c.name)

    def __repr__(self):
        return f"Archetype({self.name})"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Archetype) and other.name == self.name

    def has(self, comp: Component) -> bool:
        return any(c.name == comp.name for c in self.components)
