"""Python bindings layer — Tensor hand-off to training code (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/bindings.py`` (reference
src/python/bindings.cpp + include/madrona/python.hpp):

  madrona::py::Tensor  -> Tensor (an exported column + its live-row mask)
  Tensor::to_torch     -> Tensor.to_torch(): the column itself, zero-copy
                          on any device (the state's tensors are torch's)
  CudaSync::wait       -> Tensor.sync(): torch.cuda.synchronize on the
                          values' device, nothing on the CPU

There is no ``to_jax``: the port never imports JAX.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional

import torch


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


@dataclasses.dataclass
class Tensor:
    """An exported ECS column view (reference py::Tensor).

    values: torch.Tensor [num_worlds, capacity, ...] (or a dict of them for
    struct components); mask: bool [num_worlds, capacity] of live rows.
    """

    values: Any
    mask: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return tuple(_first_leaf(self.values).shape)

    @property
    def dtype(self):
        return _first_leaf(self.values).dtype

    def to_numpy(self):
        """A host copy as numpy arrays."""
        return _tree_map(lambda x: x.detach().cpu().numpy().copy(), self.values)

    def to_torch(self):
        """The column's own tensors (same storage, same device)."""
        return self.values

    @staticmethod
    def from_torch(t):
        """Take torch tensors as they are (reference tensor import path)."""
        return t

    def sync(self):
        """reference CudaSync::wait: wait until the values are computed."""
        leaf = _first_leaf(self.values)
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        return self


def exported_tensor(executor, slot: int) -> Tensor:
    """Wrap TaskGraphExecutor.get_exported in a Tensor.  The values are the
    state's own tensors; the state never writes them in place, so they stay
    valid after stepping."""
    values, mask = executor.get_exported(slot)
    return Tensor(values=values, mask=mask)
