"""Base components shared by engine systems (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/core/base.py`` (reference
include/madrona/components.hpp:9-29: Position, Rotation, Scale, ObjectID).
The world id is implicit: the leading axis of every tensor is the world.
"""

import torch

from gpu_ecs_madrona_tpu_torch.core.component import component
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry

# Position: Vector3 (components.hpp:11)
Position = component("Position", ((3,), torch.float32))
# Rotation: Quat, stored (w, x, y, z) (components.hpp:15)
Rotation = component("Rotation", ((4,), torch.float32))
# Scale: Diag3x3 (components.hpp:19)
Scale = component("Scale", ((3,), torch.float32))
# ObjectID: index into physics/render asset tables (components.hpp:23-25)
ObjectID = component("ObjectID", ((), torch.int32))


def register_types(registry: ECSRegistry):
    """reference src/core/base.cpp:10-17 (base::registerTypes)."""
    registry.register_component(Position)
    registry.register_component(Rotation)
    registry.register_component(Scale)
    registry.register_component(ObjectID)
