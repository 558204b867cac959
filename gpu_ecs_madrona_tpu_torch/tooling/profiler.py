"""Per-node profiling and step timelines (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/tooling/profiler.py`` (reference
DeviceTracing + parse_device_tracing.py, scripts/profile.py):

  - ``profile_nodes``: each taskgraph node timed alone on the state the
    nodes before it make, then the whole step;
  - ``trace_step``: a per-node timeline of a few steps from CUDA events
    recorded at every node boundary (the host clock on the CPU), written
    as a Chrome trace in the layout ``node_timeline`` reads (the JAX
    package's, which reads it too).  No torch.profiler session: a later
    profiler session in the same process can miss events;
  - ``aggregate_trace``, ``node_timeline``, ``render_timeline_svg`` and
    ``sweep``: plain Python over that file, as in the JAX package.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional

import torch

from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows

_SLEEP_CYCLES = 200_000_000   # ~0.1 s of device sleep ahead of timed calls


def _fresh(executor, state):
    """``state`` for a run that must leave it as it is: its dicts copied
    (a node may assign into one, e.g. ``ctx.data``) and the singletons a
    step writes in place copied (``executor._own``); tensors and unbuilt
    lazy rows are shared."""
    def copy(node):
        if isinstance(node, LazyRows) or not isinstance(node, Mapping):
            return node
        return {k: copy(v) for k, v in node.items()}
    return executor._own(copy(state))


def _node_inputs(executor) -> List[Any]:
    """The state each node of a step starts from: the step's nodes run
    once, in order, on a copy (the executor's state is not touched), each
    input taken as ``_fresh`` copy."""
    ctx = Context(executor.mgr, _fresh(executor, executor.state))
    inputs = []
    for node in executor.graph.nodes:
        inputs.append(_fresh(executor, ctx.state))
        node.run(ctx)
    return inputs


def _mean_ms(executor, state, fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls, each on its own ``_fresh``
    copy of ``state`` (made outside the timed span).  On the
    card: CUDA events around each call, every call queued behind a device
    sleep so that the events time the device's work, not the host's
    enqueue; on the CPU: the host clock."""
    def own(s):
        return _fresh(executor, s)

    t0 = time.perf_counter()
    fn(own(state))                               # warm-up; builds lazy rows
    host_s = time.perf_counter() - t0
    if executor.device.type != "cuda":
        total = 0.0
        for _ in range(iters):
            s = own(state)
            t0 = time.perf_counter()
            fn(s)
            total += time.perf_counter() - t0
        return total / iters * 1e3
    torch.cuda.synchronize(executor.device)
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    # a sleep longer than the host takes to queue the calls (~2 GHz clock)
    torch.cuda._sleep(max(_SLEEP_CYCLES, int(min(3 * host_s * iters * 2e9, 2e10))))
    for a, b in marks:
        s = own(state)
        a.record()
        fn(s)
        b.record()
    torch.cuda.synchronize(executor.device)
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def profile_nodes(executor, iters: int = 20) -> List[Dict[str, Any]]:
    """Time each taskgraph node alone, then the full step.

    Mirrors the reference autotuner's per-node timing loop
    (scripts/profile.py).  Each node runs on the state the nodes before it
    make of the executor's; the executor's state is left bit for bit as it
    was (the singletons a node writes in place are copied for every run).
    ``mean_ms`` is device time on the card (``clock`` "cuda_events") and
    host time on the CPU ("host").  The numbers are advisory: lazily built
    temporaries are built in a node's first (untimed) run, and a node that
    writes a singleton in place sees its input's copy, so a node alone may
    do more or less work than inside the step, and the full step is not
    the sum of the nodes.
    """
    clock = "cuda_events" if executor.device.type == "cuda" else "host"
    mgr, graph = executor.mgr, executor.graph
    results = []
    for node, state in zip(graph.nodes, _node_inputs(executor)):
        def run(s, _node=node):
            _node.run(Context(mgr, s))

        results.append({"node": node.name, "mean_ms": _mean_ms(executor, state, run, iters),
                        "clock": clock})
    results.append({"node": "__full_step__",
                    "mean_ms": _mean_ms(executor, executor.state, graph.step, iters),
                    "clock": clock})
    return results


def trace_step(executor, out_dir: str, steps: int = 5) -> str:
    """A per-node timeline of ``steps`` steps, each from the executor's state
    (which is left as it was), written to
    ``out_dir/plugins/profile/<run>/steps.trace.json.gz``.

    Chrome-trace events: a ``process_name`` metadata event naming
    ``/device:GPU:<i>`` (``/device:CPU:0`` on the CPU), one span a step on
    tid 2 and one a node on tid 3 with ``args.tf_op`` "jit(step)/<node>:".
    The spans are the intervals between CUDA events recorded at each node
    boundary (host clock readings on the CPU): a node's span is its device
    work plus any wait for the host to queue it.  A node with no device
    work has a span of ~0, which ``node_timeline`` leaves out."""
    cuda = executor.device.type == "cuda"
    mgr, nodes = executor.mgr, executor.graph.nodes

    def mark():
        if not cuda:
            return time.perf_counter_ns()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    executor.graph.step(_fresh(executor, executor.state))   # warm-up
    if cuda:
        torch.cuda.synchronize(executor.device)
    marks = []
    for _ in range(steps):
        ctx = Context(mgr, _fresh(executor, executor.state))
        m = [mark()]
        for node in nodes:
            node.run(ctx)
            m.append(mark())
        ctx.advance_tick()
        m.append(mark())
        marks.append(m)
    if cuda:
        torch.cuda.synchronize(executor.device)
        origin = marks[0][0]

        def us(x):
            return origin.elapsed_time(x) * 1e3
    else:
        origin = marks[0][0]

        def us(x):
            return (x - origin) / 1e3

    device = (f"/device:GPU:{executor.device.index or 0}" if cuda else "/device:CPU:0")
    events = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": device}},
              {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name", "args": {"name": "Steps"}},
              {"ph": "M", "pid": 1, "tid": 3, "name": "thread_name", "args": {"name": "Nodes"}}]
    for k, m in enumerate(marks):
        t = [us(x) for x in m]
        events.append({"ph": "X", "pid": 1, "tid": 2, "ts": t[0], "dur": t[-1] - t[0],
                       "name": f"step {k}"})
        for i, node in enumerate(nodes):
            events.append({"ph": "X", "pid": 1, "tid": 3, "ts": t[i], "dur": t[i + 1] - t[i],
                           "name": node.name, "args": {"tf_op": f"jit(step)/{node.name}:"}})
    run = time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{time.time_ns() % 10 ** 9:09d}"
    path = os.path.join(out_dir, "plugins", "profile", run)
    os.makedirs(path, exist_ok=True)
    with gzip.open(os.path.join(path, "steps.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return out_dir


def _trace_paths(trace_dir: str) -> List[str]:
    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return paths


def aggregate_trace(trace_dir: str, top: int = 30) -> List[Dict[str, Any]]:
    """Total span time by event name in the newest trace (the analog of
    scripts/parse_device_tracing.py's per-node stats table)."""
    agg = collections.Counter()
    for e in _load_trace_events(trace_dir):
        if e.get("ph") == "X" and e.get("dur", 0) > 0:
            agg[e["name"]] += e["dur"]
    return [{"op": name, "total_us": dur} for name, dur in agg.most_common(top)]


def _load_trace_events(trace_dir: str) -> List[Dict[str, Any]]:
    with gzip.open(_trace_paths(trace_dir)[-1]) as f:
        return json.load(f).get("traceEvents", [])


def _scope_node(tf_op: str) -> str:
    """'jit(step)/bp_find_overlaps/top_k:' -> 'bp_find_overlaps': the first
    scope that is not a jit wrapper (the node's name)."""
    for p in tf_op.rstrip(":").split("/"):
        if not p or p.startswith("jit(") or p.startswith("pjit("):
            continue
        return p
    return tf_op or "<unattributed>"


def node_timeline(trace_dir: str,
                  events: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Per-taskgraph-node timeline from a ``trace_step`` capture (or the JAX
    package's): steps are the spans on the device's tid 2, ops those on
    tid 3, each op attributed to its node by its ``tf_op`` scope.

    Returns {"steps": [{"start_us", "dur_us", "segments": [
                {"node", "start_us", "dur_us"}, ...]}],
             "nodes": [{"node", "total_us", "mean_us_per_step", "pct",
                        "count"}]}: segments are per-node contiguous spans
    within each step, in device order.
    """
    evs = events if events is not None else _load_trace_events(trace_dir)
    dev_pids = {e["pid"] for e in evs
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:" in str(e.get("args", {}).get("name", ""))}
    mods = sorted((e for e in evs if e.get("ph") == "X"
                   and e.get("pid") in dev_pids and e.get("tid") == 2),
                  key=lambda e: e["ts"])
    ops = sorted((e for e in evs if e.get("ph") == "X"
                  and e.get("pid") in dev_pids and e.get("tid") == 3
                  and e.get("dur", 0) > 0),
                 key=lambda e: e["ts"])

    steps = []
    totals: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    op_pos = 0     # both lists are ts-sorted: advance once
    for mod in mods:
        t0, t1 = mod["ts"], mod["ts"] + mod["dur"]
        segments = []
        cur = None
        while op_pos < len(ops) and ops[op_pos]["ts"] < t0:
            op_pos += 1
        while op_pos < len(ops) and ops[op_pos]["ts"] < t1:
            op = ops[op_pos]
            op_pos += 1
            node = _scope_node(op.get("args", {}).get("tf_op", op["name"]))
            totals[node][0] += op["dur"]
            totals[node][1] += 1
            if cur is not None and cur["node"] == node:
                cur["dur_us"] = (op["ts"] + op["dur"] - t0) - cur["start_us"]
            else:
                cur = {"node": node, "start_us": op["ts"] - t0, "dur_us": op["dur"]}
                segments.append(cur)
        steps.append({"start_us": t0, "dur_us": mod["dur"], "segments": segments})

    n_steps = max(len(steps), 1)
    step_total = sum(s["dur_us"] for s in steps) or 1.0
    nodes = sorted(
        ({"node": k, "total_us": round(v[0], 1),
          "mean_us_per_step": round(v[0] / n_steps, 1),
          "pct": round(100.0 * v[0] / step_total, 1), "count": v[1]}
         for k, v in totals.items()),
        key=lambda r: -r["total_us"])
    return {"steps": steps, "nodes": nodes}


def render_timeline_svg(timeline: Dict[str, Any], path: str,
                        width: int = 1000, row_h: int = 22) -> str:
    """``node_timeline`` output as an SVG: one row a step, one coloured box
    a node segment, a legend of the top nodes."""
    steps = timeline["steps"]
    if not steps:
        raise ValueError("empty timeline")
    top_rows = timeline["nodes"][:12]
    nodes = [r["node"] for r in top_rows]
    palette = ["#4e79a7", "#f28e2b", "#e15759", "#76b7b2", "#59a14f",
               "#edc948", "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac"]
    color = {n: palette[i % len(palette)] for i, n in enumerate(nodes)}
    max_dur = max(s["dur_us"] for s in steps)
    scale = (width - 160) / max_dur
    legend_h = 16 * (min(len(nodes), 12) + 1)
    h = row_h * len(steps) + 30 + legend_h
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{h}" font-family="monospace" font-size="11">']
    for i, s in enumerate(steps):
        y = 10 + i * row_h
        out.append(f'<text x="2" y="{y + 14}">step {i} '
                   f'{s["dur_us"] / 1000:.2f}ms</text>')
        for seg in s["segments"]:
            x = 150 + seg["start_us"] * scale
            w = max(seg["dur_us"] * scale, 0.5)
            c = color.get(seg["node"], "#999")
            out.append(f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                       f'height="{row_h - 4}" fill="{c}">'
                       f'<title>{seg["node"]}: {seg["dur_us"]:.0f}us'
                       f'</title></rect>')
    y0 = 20 + row_h * len(steps)
    for i, r in enumerate(top_rows):
        y = y0 + 16 * i
        out.append(f'<rect x="150" y="{y}" width="12" height="12" '
                   f'fill="{color[r["node"]]}"/>')
        out.append(f'<text x="168" y="{y + 10}">{r["node"]} — '
                   f'{r["mean_us_per_step"] / 1000:.2f}ms/step '
                   f'({r["pct"]}%)</text>')
    out.append("</svg>")
    svg = "\n".join(out)
    with open(path, "w") as f:
        f.write(svg)
    return path


def sweep(make_fn: Callable[..., float], param_grid: Dict[str, List[Any]],
          out_json: Optional[str] = None) -> List[Dict[str, Any]]:
    """Generic config sweep (reference scripts/profile.py block-count
    sweep): ``make_fn(**params)`` returns a metric (higher is better); the
    rows come back ranked, and are written to ``out_json`` if given."""
    import itertools

    keys = list(param_grid)
    rows = []
    for combo in itertools.product(*(param_grid[k] for k in keys)):
        params = dict(zip(keys, combo))
        rows.append({**params, "metric": make_fn(**params)})
    rows.sort(key=lambda r: -r["metric"])
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows
