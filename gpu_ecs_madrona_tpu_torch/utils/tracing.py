"""Host event tracing.

Counterpart of ``gpu_ecs_madrona_tpu/utils/tracing.py`` (reference
include/madrona/tracing.hpp + src/common/tracing.cpp): thread-local
{event, timestamp} logs dumped to a binary file at exit, gated by
GEM_TPU_TRACING.  Timestamps are ``time.perf_counter_ns``.  The record
format is the JAX package's.  Decode with ``parse``; aggregate with
``analyze`` (the JAX package's pure-Python path; its native analyzer is
part of that package).
"""

from __future__ import annotations

import atexit
import os
import struct
import threading
import time
from enum import IntEnum
from typing import List, Tuple


class HostEvent(IntEnum):
    """reference HostEvent enum (tracing.hpp:11-20)."""

    STEP_START = 0
    STEP_END = 1
    RENDER_START = 2
    RENDER_END = 3
    EXPORT_COPY_IN = 4
    EXPORT_COPY_OUT = 5
    INIT_START = 6
    INIT_END = 7


_ENABLED = bool(os.environ.get("GEM_TPU_TRACING"))
_local = threading.local()
_all_logs: List[List[Tuple[int, int]]] = []
_lock = threading.Lock()


def enabled() -> bool:
    return _ENABLED


def log(event: HostEvent):
    """reference HostEventLogging (tracing.hpp:43-49) — no-op unless
    GEM_TPU_TRACING is set."""
    if not _ENABLED:
        return
    buf = getattr(_local, "events", None)
    if buf is None:
        buf = []
        _local.events = buf
        with _lock:
            _all_logs.append(buf)
    buf.append((int(event), time.perf_counter_ns()))


def dump(path: str = None):
    """reference FinalizeLogging (tracing.cpp:31-45): binary records of
    (event u32, timestamp u64)."""
    if path is None:
        name = os.environ.get("GEM_TPU_TRACE_NAME", str(os.getpid()))
        path = f"{name}_host_tracing.bin"
    with _lock:
        records = [r for buf in _all_logs for r in buf]
    records.sort(key=lambda r: r[1])
    with open(path, "wb") as f:
        for event, ts in records:
            f.write(struct.pack("<IQ", event, ts))
    return path


def parse(path: str) -> List[Tuple[int, int]]:
    """Decode a host trace file into (event, timestamp_ns) records."""
    with open(path, "rb") as f:
        data = f.read()
    return [struct.unpack_from("<IQ", data, i)
            for i in range(0, len(data) - len(data) % 12, 12)]


def analyze(path: str) -> dict:
    """Aggregate a trace file: per-event counts and span statistics
    (count, total, mean, min, max, p50, p95 in ns) of the START/END pairs
    (step, render, init), each END closing the oldest open START."""
    records = parse(path)
    counts: dict = {}
    for ev, _ in records:
        counts[ev] = counts.get(ev, 0) + 1
    spans = {}
    for start, end, name in ((HostEvent.STEP_START, HostEvent.STEP_END, "step"),
                             (HostEvent.RENDER_START, HostEvent.RENDER_END, "render"),
                             (HostEvent.INIT_START, HostEvent.INIT_END, "init")):
        open_ts, durs = [], []
        for ev, ts in records:
            if ev == start:
                open_ts.append(ts)
            elif ev == end and open_ts:
                durs.append(ts - open_ts.pop(0))
        if durs:
            durs.sort()
            n = len(durs)

            def pct(p):
                idx = p * (n - 1)
                lo = int(idx)
                hi = min(lo + 1, n - 1)
                return int((1 - (idx - lo)) * durs[lo] + (idx - lo) * durs[hi])

            spans[name] = {
                "count": n, "total_ns": sum(durs),
                "mean_ns": sum(durs) // n, "min_ns": durs[0],
                "max_ns": durs[-1], "p50_ns": pct(0.5), "p95_ns": pct(0.95),
            }
    return {"event_counts": counts, "spans": spans}


if _ENABLED:
    atexit.register(dump)
