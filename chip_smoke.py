#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpu_ecs_madrona_tpu_torch).

Drives the port's main path — the collisions example at 8192 worlds x 100
cubes — on one CUDA card, through both of its kernels, and holds every
kernel against its plain PyTorch version.  Run from the root of a
checkout:

    python3 chip_smoke.py            # the smoke test
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}.  Any failed check, build or launch raises
and exits non-zero before that line.  There is no CPU fallback: without a
CUDA device, or run outside a checkout, it exits non-zero.

Phases:
  1. device   card name, count, nvidia-smi name and power limit
  2. build    nvcc of every csrc/*.cu (in parallel), ptxas register and
              shared-memory lines
  3. parity   each kernel vs its plain version at the main path's shapes
              (W=8192, n=108 rows, 100 live) and collision_pushes at
              n=1500, W=16 (many j tiles); fused_collisions_step: lo/hi
              atol 1e-5, delta atol 1e-4 against the plain push on the
              kernel's own lo/hi; collision_pushes: delta atol 1e-4
  4. golden   the reference binary's collisions trajectory
              (tests/goldens/job_collisions.bin, 1 world x 100 cubes, 120
              ticks) on the card, both modes: <= 1e-3 at t=3, <= 0.02 over
              the horizon
  5. main_fused     fused=True (kernel 1), 3 warm-up steps then 5 windows
              of 200 steps; launch count = steps, finite positions, empty
              temporary tables; env-steps/s
  6. main_unfused   fused=False, use_kernel=True (kernel 2), 50 steps
  7. timing   CUDA-event time of each kernel wrapper (200 calls) and of
              its plain version at the main path's shapes, beside the
              bound: max(bytes / 3.35 TB/s, fp32 ops / 67 TFLOP/s), the
              H100 SXM peaks; no single PyTorch call computes either
              function, so there is no library yardstick
"""

import json
import os
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_WORLDS = 8192
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b):
    return float((a - b).abs().max())


def cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pair_counts(torch, lo, hi, mask):
    """(live ordered pairs, overlapping live ordered pairs) of this data:
    the pairs the kernels test, and the pairs they push."""
    live = mask.sum(dim=1).double()
    live_pairs = float((live * (live - 1)).sum())
    not_eye = ~torch.eye(mask.shape[1], dtype=torch.bool, device=mask.device)
    overlaps = 0.0
    for w0 in range(0, mask.shape[0], 1024):  # bounded temporaries
        sl = slice(w0, w0 + 1024)
        ok = ((lo[sl, :, None] <= hi[sl, None]) & (lo[sl, None] <= hi[sl, :, None])).all(-1)
        overlaps += float((ok & mask[sl, :, None] & mask[sl, None, :] & not_eye).sum())
    return live_pairs, overlaps


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rates(steps, windows_s):
    r = sorted(steps * NUM_WORLDS / s for s in windows_s)
    return {"median": r[len(r) // 2], "min": r[0], "max": r[-1],
            "window_s": windows_s, "steps_per_window": steps}


def load_job_golden():
    path = os.path.join(HERE, "tests", "goldens", "job_collisions.bin")
    with open(path, "rb") as f:
        d = f.read()
    check(d[:4] == b"GLDJ", "golden magic")
    T1, n, _, _ = struct.unpack("<4i", d[4:20])
    off = 24 + n * 16
    import numpy as np
    rot0 = np.frombuffer(d[24:off], np.float32).reshape(n, 4).copy()
    rec = n * 12 + 4
    pos = np.stack([np.frombuffer(d[off + t * rec: off + t * rec + n * 12],
                                  np.float32).reshape(n, 3) for t in range(T1)])
    return pos, rot0


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import gpu_ecs_madrona_tpu_torch as port
    check(os.path.dirname(os.path.abspath(port.__file__)).startswith(HERE),
          f"the port must come from this checkout, got {port.__file__}")
    from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
    from gpu_ecs_madrona_tpu_torch.models import collisions as col
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    from gpu_ecs_madrona_tpu_torch.utils import math as m

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "dir": os.path.relpath(_build.BUILD_DIR, HERE),
          "ptxas": ptxas})

    # 3. kernel vs plain at the main path's shapes --------------------------
    sim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS), device="cuda")
    pos = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    rot = sim.mgr.column(sim.state, col.CubeObject, col.Rotation)
    mask = sim.mgr.row_mask(sim.state, col.CubeObject)
    check(tuple(pos.shape) == (NUM_WORLDS, 108, 3) and int(mask.sum(1).min()) == 100,
          "initial state shape")
    delta, klo, khi = ck.fused_collisions_step(pos, rot, mask)
    plo, phi = ck.aabb_plain(pos, rot)
    want = ck.pushes_plain(pos, klo, khi, mask, center=False)
    own = ck.fused_collisions_step_plain(pos, rot, mask)[0]
    torch.cuda.synchronize()
    err_fused = {"lo": max_err(klo, plo), "hi": max_err(khi, phi),
                 "delta": max_err(delta, want)}
    rows_own = int(((delta - own).abs().amax(-1) > 1e-4).sum())
    del want, own
    d108 = ck.collision_pushes(pos, plo, phi, mask)
    err_p108 = max_err(d108, ck.collision_pushes_plain(pos, plo, phi, mask))
    g = torch.Generator(device=dev).manual_seed(0)
    p1500 = torch.rand((16, 1500, 3), generator=g, device=dev) * 17.0 - 8.5
    m1500 = torch.rand((16, 1500), generator=g, device=dev) > 0.02
    d1500 = ck.collision_pushes(p1500, p1500 - 1.0, p1500 + 1.0, m1500)
    err_p1500 = max_err(d1500, ck.collision_pushes_plain(p1500, p1500 - 1.0, p1500 + 1.0,
                                                          m1500))
    emit({"phase": "parity", "fused_collisions_step": err_fused,
          "fused_rows_differing_with_plain_own_aabb": rows_own,
          "collision_pushes_n108": err_p108, "collision_pushes_n1500_w16": err_p1500,
          "atol": {"aabb": 1e-5, "delta": 1e-4}})
    check(err_fused["lo"] <= 1e-5 and err_fused["hi"] <= 1e-5, "fused lo/hi vs plain")
    check(err_fused["delta"] <= 1e-4, "fused delta vs plain")
    check(err_p108 <= 1e-4 and err_p1500 <= 1e-4, "collision_pushes vs plain")
    check(bool(torch.isfinite(delta).all()) and bool(torch.isfinite(d1500).all()),
          "finite kernel outputs")

    # 4. the reference binary's golden, on the card --------------------------
    g_pos, g_rot0 = load_job_golden()
    n_g = g_pos.shape[1]
    golden = {}
    for mode, kw in (("fused", dict(fused=True)),
                     ("pushes", dict(fused=False, use_kernel=True))):
        cfg = col.CollisionsConfig(num_worlds=1, num_objects=n_g, max_pairs=1600, **kw)

        class GoldenWorld(col.CollisionsWorld.with_config(cfg)):
            @classmethod
            def init(cls, ctx, init_data=None):
                ctx.data = {
                    "bounds_lo": torch.tensor([[-10.0, -10.0, 0.0]], device=dev),
                    "bounds_hi": torch.tensor([[10.0, 10.0, 10.0]], device=dev),
                    "push_delta": torch.zeros((1, n_g + 8, 3), device=dev),
                }
                inv_lo, inv_hi = m.aabb_invalid((1, n_g), device=dev)
                ctx.make_entities(col.CubeObject, counts=n_g, max_new=n_g, values={
                    col.Translation: torch.from_numpy(g_pos[0])[None].to(dev),
                    col.Rotation: torch.from_numpy(g_rot0)[None].to(dev),
                    col.PhysicsAABB: {"lo": inv_lo, "hi": inv_hi},
                })

        gsim = TaskGraphExecutor(GoldenWorld, ExecutorConfig(num_worlds=1, device="cuda"))
        errs = []
        for t in range(1, g_pos.shape[0]):
            gsim.step()
            mine = gsim.get_exported(0)[0][0, :n_g].cpu().numpy()
            errs.append(float(abs(mine - g_pos[t]).max()))
        golden[mode] = {"err_t3": max(errs[:3]), "max_err": max(errs), "ticks": len(errs)}
        check(golden[mode]["err_t3"] <= 1e-3 and golden[mode]["max_err"] <= 0.02,
              f"golden trajectory ({mode})")
    emit({"phase": "golden", **golden})

    # 5. main path, fused=True (kernel 1) ----------------------------------
    sim.run(3)
    sim.block_until_ready()
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        sim.run(200)
        sim.block_until_ready()
        windows.append(time.perf_counter() - t0)
    fused_launches = {"fused_collisions_step": ck.fused_collisions_step.launches,
                      "collision_pushes": ck.collision_pushes.launches}
    check(fused_launches == {"fused_collisions_step": 1000, "collision_pushes": 0},
          f"fused main path launches {fused_launches}")
    fpos, fmask = sim.get_exported(0)
    check(bool(torch.isfinite(fpos[fmask]).all()), "finite positions (fused)")
    for arch in (col.CollisionCandidate, col.Contact):
        check(int(sim.mgr.num_rows(sim.state, arch).sum()) == 0, f"{arch.name} empty")
    emit({"phase": "main_fused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": fused_launches, "env_steps_per_s": rates(200, windows),
          "card": smi})

    # 6. main path, fused=False with the collision_pushes kernel -------------
    usim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS, fused=False,
                                                  use_kernel=True), device="cuda")
    usim.run(3)
    usim.block_until_ready()
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    t0 = time.perf_counter()
    usim.run(50)
    usim.block_until_ready()
    uwindow = time.perf_counter() - t0
    unfused_launches = {"fused_collisions_step": ck.fused_collisions_step.launches,
                        "collision_pushes": ck.collision_pushes.launches}
    check(unfused_launches == {"fused_collisions_step": 0, "collision_pushes": 50},
          f"unfused main path launches {unfused_launches}")
    upos, umask = usim.get_exported(0)
    check(bool(torch.isfinite(upos[umask]).all()), "finite positions (unfused)")
    overflow = usim.overflow_counters()
    check(all(v.dtype == torch.int32 and int(v.min()) >= 0 for v in overflow.values()),
          "overflow counters int32 >= 0")
    emit({"phase": "main_unfused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": unfused_launches, "env_steps_per_s": rates(50, [uwindow]),
          "overflow_max": {k: int(v.max()) for k, v in overflow.items()}, "card": smi})

    # 7. kernel times at the main path's shapes -------------------------------
    fpos = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    frot = sim.mgr.column(sim.state, col.CubeObject, col.Rotation)
    W, n = fmask.shape
    f_ms = cuda_ms(torch, lambda: ck.fused_collisions_step(fpos, frot, fmask), 200)
    f_plain = cuda_ms(torch, lambda: ck.fused_collisions_step_plain(fpos, frot, fmask), 10)
    flo, fhi = ck.aabb_plain(fpos, frot)
    live, over = pair_counts(torch, flo, fhi, fmask)
    f_bound, f_by = bound(W * n * (12 + 16 + 1 + 36), W * n * 69 + live * 6 + over * 16)

    uaabb = usim.mgr.column(usim.state, col.CubeObject, col.PhysicsAABB)
    ulo, uhi = uaabb["lo"], uaabb["hi"]
    upos = usim.mgr.column(usim.state, col.CubeObject, col.Translation)
    p_ms = cuda_ms(torch, lambda: ck.collision_pushes(upos, ulo, uhi, umask), 200)
    p_plain = cuda_ms(torch, lambda: ck.collision_pushes_plain(upos, ulo, uhi, umask), 10)
    ulive, uover = pair_counts(torch, ulo, uhi, umask)
    p_bound, p_by = bound(W * n * (36 + 1 + 12), W * n * 9 + ulive * 6 + uover * 16)
    emit({"phase": "timing", "fused_collisions_step": {
              "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
              "live_pairs": live, "overlapping_pairs": over},
          "collision_pushes": {
              "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
              "live_pairs": ulive, "overlapping_pairs": uover},
          "library_ms": "none: no single PyTorch call computes either function",
          "card": smi})

    if "--profile" in argv:
        profile(torch, sim, usim)

    src = "gpu_ecs_madrona_tpu_torch/csrc/collision_kernels.cu"
    emit({"kernels": [
        {"name": "fused_collisions_step", "route": "cuda", "source": src,
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:330",
         "launches": fused_launches["fused_collisions_step"], "launches_per_step": 1,
         "max_abs_err": max(err_fused.values()), "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": None},
        {"name": "collision_pushes", "route": "cuda", "source": src,
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:212 (tiled :195)",
         "launches": unfused_launches["collision_pushes"], "launches_per_step": 1,
         "max_abs_err": max(err_p108, err_p1500), "ms": p_ms, "plain_ms": p_plain,
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile(torch, sim, usim):
    """torch.profiler over 20 steps of each main path: device time by
    kernel, and the device's busy share of the profiled wall time (which
    includes the profiler's own host overhead)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for name, s in (("fused", sim), ("unfused_pushes", usim)):
        s.run(3)
        s.block_until_ready()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()  # after the profiler has started
            s.run(20)
            s.block_until_ready()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        emit({"phase": f"profile_{name}", "steps": 20, "wall_us": wall_us,
              "device_busy_us": busy,
              "device_busy_share": busy / wall_us if busy else "not measured",
              "top": [{"name": e.key[:80], "us": e.self_device_time_total,
                       "calls": e.count} for e in top]})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
