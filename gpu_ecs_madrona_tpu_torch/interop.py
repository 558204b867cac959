"""Carrying a simulation state between the JAX package and the port.

The JAX package's ``SimState`` is a nested dict of arrays; the port's has
the same keys, shapes and dtypes (core/state.py), apart from ``rng``.
``state_from_numpy`` builds the port's state from the JAX one given as
numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``), and
``state_to_numpy`` goes the other way.  Checkpoints share the leaf builder.

``rng``: a JAX state carries uint32 [W, 2] threefry keys, which the port's
counter-based generator cannot continue.  Each world's two key words are
packed into one 64-bit value and mixed into the port's stream key, with
the draw counter at 0: the mapping is deterministic, but the draws differ
from the JAX package's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.core.state import SimState, mix64


def rng_from_jax_keys(keys: np.ndarray, device) -> torch.Tensor:
    """uint32 [W, 2] threefry keys -> the port's generator state [W, 2]."""
    words = keys.astype(np.uint64)
    packed = ((words[:, 0] << np.uint64(32)) | words[:, 1]).view(np.int64)
    streams = mix64(torch.from_numpy(packed.copy()))
    return torch.stack([streams, torch.zeros_like(streams)], dim=1).to(device)


def _leaf_to_torch(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def state_from_numpy(tree, device="cuda") -> SimState:
    """A nested dict (or list/tuple) of numpy arrays -> the port's state
    on ``device``.  A uint32 top-level ``rng`` leaf is taken as JAX keys."""

    def build(node, top_key=None):
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        a = np.asarray(node)
        if top_key == "rng" and a.dtype == np.uint32:
            return rng_from_jax_keys(a, device)
        return _leaf_to_torch(a, device)

    return {k: build(v, top_key=k) for k, v in tree.items()}


def state_to_numpy(state):
    """The port's state -> the same nested structure of numpy arrays
    (lazily emitted rows are built on the way).  The arrays are copies,
    also of a state on the CPU: a later step, which may write some of the
    state's tensors in place, leaves them as they were."""
    if isinstance(state, Mapping):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(state_to_numpy(v) for v in state)
    t = state.detach()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
