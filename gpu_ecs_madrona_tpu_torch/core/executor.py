"""TaskGraphExecutor — the front door: build world, run steps (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/core/executor.py`` (reference
TaskGraphExecutor / MWCudaExecutor, include/madrona/mw_cpu.hpp,
mw_gpu.hpp).  The world class registers types, builds a taskgraph, and
each step runs the sorted graph eagerly on ``ExecutorConfig.device``.

World-class protocol (mirrors reference WorldT usage, mw_cpu.inl:5-44):

    class MyWorld:
        @staticmethod
        def register_types(registry: ECSRegistry): ...
        @staticmethod
        def setup_tasks(builder: TaskGraphBuilder): ...
        @staticmethod
        def init(ctx: Context, init_data): ...   # world ctor, batched

The step runs on the card unless the config asks for the CPU; with no
card and ``device="cuda"`` construction raises.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch import interop
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import SimState, StateManager
from gpu_ecs_madrona_tpu_torch.core.taskgraph import TaskGraph, TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.utils import tracing


@dataclasses.dataclass
class ExecutorConfig:
    """reference ThreadPoolExecutor::Config / StateConfig (mw_cpu.hpp:11-22,
    mw_gpu.hpp:20-36): world count + capacities + seed + the device."""

    num_worlds: int
    max_entities_per_world: Optional[int] = None
    seed: int = 0
    device: str = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


class TaskGraphExecutor:
    """Build + run a world across many lockstep worlds."""

    def __init__(self, world_cls, cfg: ExecutorConfig, init_data: Any = None):
        self.cfg = cfg
        self.world_cls = world_cls
        self.device = resolve_device(cfg.device)

        registry = ECSRegistry()
        world_cls.register_types(registry)
        self.registry = registry
        self.mgr = StateManager(registry, cfg.num_worlds,
                                cfg.max_entities_per_world, device=self.device)

        # World construction (reference: per-world WorldT ctor, batched here).
        ctx = Context(self.mgr, self.mgr.make_initial_state(seed=cfg.seed))
        world_cls.init(ctx, init_data)
        self._state = ctx.state

        builder = TaskGraphBuilder(self.mgr)
        world_cls.setup_tasks(builder)
        self.graph: TaskGraph = builder.build()

    # -- stepping ----------------------------------------------------------

    @property
    def state(self) -> SimState:
        return self._state

    @state.setter
    def state(self, value: SimState):
        self._state = value

    def step(self):
        """One step (reference MWCudaExecutor::run / ThreadPoolExecutor::run).
        Returns once the step's kernels are queued; see block_until_ready."""
        tracing.log(tracing.HostEvent.STEP_START)
        self._state = self.graph.step(self._state)
        tracing.log(tracing.HostEvent.STEP_END)

    def run(self, num_steps: int = 1, use_scan: bool = False):
        """Run ``num_steps`` steps.  ``use_scan`` is accepted for
        signature parity with the JAX package and runs the same loop."""
        del use_scan
        for _ in range(num_steps):
            self.step()

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- export (reference getExported / python bindings) -------------------

    def get_exported(self, slot: int, packed: bool = False):
        """The exported column: (values [W, cap, ...], live row mask
        [W, cap]).  The tensors are the state's own (no copy); the state
        never writes them in place, so they stay valid after stepping.

        packed=True returns the reference's cross-world packed layout
        (exportBlockSums + exportCopyOut, device/consts.cpp:137-273):
        (values [W*cap, ...] with every live row compacted to the front in
        (world, row) order, counts [W] int32, offsets [W] int32 exclusive
        prefix); rows past counts.sum() are zero."""
        info = self.registry.exports[slot]
        vals = self.mgr.column(self._state, info.archetype, info.comp)
        mask = self.mgr.row_mask(self._state, info.archetype)
        if not packed:
            return vals, mask
        W, cap = mask.shape
        flat_mask = mask.reshape(W * cap)
        # live rows first, (world, row) order preserved (stable)
        order = torch.sort((~flat_mask).to(torch.uint8), stable=True).indices
        live = flat_mask[order]

        def pack_leaf(x):
            kept = x.reshape((W * cap,) + x.shape[2:])[order]
            return torch.where(live.reshape((W * cap,) + (1,) * (kept.ndim - 1)),
                               kept, torch.zeros_like(kept))

        if isinstance(vals, dict):
            packed_vals = {k: pack_leaf(v) for k, v in vals.items()}
        else:
            packed_vals = pack_leaf(vals)
        counts = mask.sum(dim=1, dtype=torch.int32)
        offsets = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
        return packed_vals, counts, offsets

    def set_exported(self, slot: int, value):
        """External write-back (reference copyInExportedColumns,
        src/core/state.cpp:489-514) — e.g. action tensors from a learner."""
        info = self.registry.exports[slot]
        self._state = self.mgr.set_column(self._state, info.archetype, info.comp, value)

    def overflow_counters(self):
        """Per-world dropped-create counters, {archetype_name: [W] int32}.
        Any nonzero entry means creates/temporaries were clipped by a
        too-small capacity (e.g. max_pairs)."""
        return self._state["overflow"]

    # -- observation accessors (reference rgbObservations/depthObservations,
    # include/madrona/mw_render.hpp) ----------------------------------------

    def rgb_observations(self):
        """RGBA8 observations [W, views, H, Wpx, 4] uint8 (needs a
        render.renderer.BatchRenderer node in the graph)."""
        return self._state["user"]["render_out"]["rgb"]

    def depth_observations(self):
        """float32 depth observations [W, views, H, Wpx] (inf = miss)."""
        return self._state["user"]["render_out"]["depth"]

    # -- checkpoint ---------------------------------------------------------

    def save_state(self) -> SimState:
        """A snapshot of the state (tensors are shared: the state is never
        written in place)."""
        return dict(self._state)

    def restore_state(self, snapshot: SimState):
        self._state = snapshot

    def save_checkpoint(self, path: str):
        """Persist the full state: flat npz + a JSON structure spec, the
        JAX package's format (never pickle)."""
        arrays = {}

        def spec_of(node):
            if isinstance(node, Mapping):
                keys = sorted(node)
                return {"t": "dict", "k": keys, "c": [spec_of(node[k]) for k in keys]}
            if isinstance(node, (list, tuple)):
                return {"t": "list" if isinstance(node, list) else "tuple",
                        "c": [spec_of(x) for x in node]}
            i = len(arrays)
            arrays[f"leaf_{i}"] = node.detach().cpu().numpy()
            return {"t": "leaf", "i": i}

        spec = spec_of(self._state)
        np.savez(path, __spec__=np.frombuffer(json.dumps(spec).encode(), dtype=np.uint8),
                 **arrays)

    def restore_checkpoint(self, path: str):
        """Restore a checkpoint written by this executor or by the JAX
        package's (same format; a JAX ``rng`` leaf is mapped as in
        interop.state_from_numpy)."""
        with np.load(path if path.endswith(".npz") else path + ".npz",
                     allow_pickle=False) as z:
            if "__spec__" not in z.files:
                raise ValueError("not a framework checkpoint: missing '__spec__' entry")
            spec = json.loads(z["__spec__"].tobytes().decode())

            def build(s):
                if s["t"] == "dict":
                    return {k: build(c) for k, c in zip(s["k"], s["c"])}
                if s["t"] in ("list", "tuple"):
                    seq = [build(c) for c in s["c"]]
                    return seq if s["t"] == "list" else tuple(seq)
                return z[f"leaf_{s['i']}"]

            tree = build(spec)
        self._state = interop.state_from_numpy(tree, self.device)
