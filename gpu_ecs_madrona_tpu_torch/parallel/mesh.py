"""Worlds sharded over ranks (PyTorch, ``torch.distributed``).

Counterpart of ``gpu_ecs_madrona_tpu/parallel/mesh.py``.  Every state leaf
carries a leading ``num_worlds`` axis and worlds are independent, so a
rank steps its own contiguous block of worlds with no collective inside a
step; only the learner reduces across ranks (``parallel/learner.py``).
The JAX package lets XLA partition one program over a device mesh; here
each rank is a process with its own device, and the mesh is the process
group seen from that rank.

Launch one process a rank, e.g. ``torchrun --nproc_per_node=N script.py``
with ``initialize_distributed("env://")`` in the script, or call
``initialize_distributed("host:port", num_processes, process_id)`` in
each process.  Then:

    mesh = make_world_mesh()                     # rank r on cuda:<local rank>
    sim = make_executor(cfg with num_worlds // mesh.world_size worlds)
    sim.state = shard_state(global_state, mesh)  # this rank's worlds

A rank's state must come from ``shard_state`` of the global state: an
executor built for its share of the worlds numbers them from 0, so its own
initial state would repeat rank 0's generator streams.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any, Optional

import torch
import torch.distributed as dist

from gpu_ecs_madrona_tpu_torch.core.executor import resolve_device
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows

WORLD_AXIS = "worlds"   # the JAX package's name for the worlds axis of its mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda", backend: Optional[str] = None):
    """Join the process group (``torch.distributed.init_process_group``).
    A no-op without ``coordinator_address``, as in the JAX package.

    ``coordinator_address`` is "host:port" (rank 0 listens there; any
    free port), a ``tcp://`` or ``file://`` URL, or "env://" under
    ``torchrun`` (rank and world size from its environment).  The backend
    is NCCL for a CUDA ``device`` and gloo for the CPU unless ``backend``
    names one.  NCCL takes one card a rank: ranks that share a card use
    gloo, whose collectives on CUDA tensors go through the host."""
    if coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


@dataclasses.dataclass(frozen=True)
class WorldMesh:
    """One rank's view of the worlds axis split over ``world_size`` ranks:
    its rank, its device and the process group (None: no collectives, one
    rank only).  ``all_reduce`` and ``broadcast`` are the learner's
    collectives; both act in place on a tensor of any device the group's
    backend takes, and return it."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    def _check(self):
        if self.group is None and self.world_size != 1:
            raise RuntimeError(f"a mesh of {self.world_size} ranks without a process group "
                               "has no collectives: build it with make_world_mesh after "
                               "initialize_distributed")

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        self._check()
        if self.group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``tensor`` of rank ``src`` on every rank, in place."""
        self._check()
        if self.group is not None:
            dist.broadcast(tensor, src=src, group=self.group)
        return tensor


def make_world_mesh(device=None) -> WorldMesh:
    """This process's mesh over the initialised process group (one rank and
    no collectives if there is none).  The device is ``device``, else
    ``cuda:<local rank>`` (``LOCAL_RANK`` under torchrun, else the rank
    modulo the cards); a CUDA device becomes the current one."""
    if dist.is_available() and dist.is_initialized():
        rank, size, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, size, group = 0, 1, None
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return WorldMesh(rank, size, dev, group)


def world_sharding(mesh: WorldMesh, num_worlds: int) -> slice:
    """This rank's ``[start, stop)`` of the worlds axis: equal contiguous
    blocks in rank order.  An uneven split raises (as the JAX package's
    NamedSharding refuses one)."""
    if num_worlds % mesh.world_size:
        raise ValueError(f"{num_worlds} worlds do not split evenly over "
                         f"{mesh.world_size} ranks")
    per = num_worlds // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_state(state, mesh: WorldMesh, num_worlds: Optional[int] = None):
    """This rank's worlds of a global state: every leaf's rows
    ``world_sharding(mesh, num_worlds)`` of its leading worlds axis (the
    generator streams in ``rng`` too), copied to the mesh's device.  Rows
    not built yet (``LazyRows``) stay lazy.  ``num_worlds`` defaults to
    the length of ``state["tick"]``."""
    if num_worlds is None:
        num_worlds = int(state["tick"].shape[0])
    rows = world_sharding(mesh, num_worlds)

    def take(node):
        if isinstance(node, LazyRows):
            if not node.built:
                return LazyRows(lambda: take(dict(node)))
            node = dict(node)
        if isinstance(node, Mapping):
            return {k: take(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(take(v) for v in node)
        if isinstance(node, torch.Tensor):
            if node.ndim == 0 or node.shape[0] != num_worlds:
                raise ValueError(f"a state leaf of shape {tuple(node.shape)} has no leading "
                                 f"axis of {num_worlds} worlds")
            return node[rows].to(mesh.device, copy=True)
        return node

    return take(state)
