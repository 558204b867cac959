"""gpu_ecs_madrona_tpu_torch — the batched-ECS simulation framework in
PyTorch, with its hot paths as hand-written CUDA kernels for NVIDIA Hopper.

The port of ``gpu_ecs_madrona_tpu`` (JAX), module for module: thousands of
independent worlds stepped in lockstep, an archetype-based entity-component
store held as SoA tensors with a leading worlds axis, masked slot
allocation for entity create/destroy, and a dependency-ordered taskgraph
run eagerly each step.  It imports neither JAX nor the JAX package; a JAX
state converts leaf by leaf (``interop``).  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

from gpu_ecs_madrona_tpu_torch.core.component import (
    Component,
    component,
    singleton_component,
    Entity,
    NULL_ENTITY,
    Archetype,
)
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import StateManager, SimState
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraph, TaskGraphBuilder, NodeID
from gpu_ecs_madrona_tpu_torch.core.executor import TaskGraphExecutor, ExecutorConfig
from gpu_ecs_madrona_tpu_torch.core.world import World, system

__version__ = "0.1.0"

__all__ = [
    "Component",
    "component",
    "singleton_component",
    "Entity",
    "NULL_ENTITY",
    "Archetype",
    "ECSRegistry",
    "StateManager",
    "SimState",
    "Context",
    "TaskGraph",
    "TaskGraphBuilder",
    "NodeID",
    "TaskGraphExecutor",
    "ExecutorConfig",
    "World",
    "system",
]
