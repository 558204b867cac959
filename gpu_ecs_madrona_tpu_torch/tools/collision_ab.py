#!/usr/bin/env python3
"""Times the collision kernels of one or more checkouts on one card, in
turns: an A/B of a change against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/collision_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository; each runs in a
process of its own (so that two versions of the package never meet), in
the order given: "parent change change parent" is the usual A/B.  Each
prints one JSON line:

  ptxas      registers, stack frame, spills and static shared memory of
             each kernel in ROOT's csrc/collision_kernels.cu (its build log)
  shape      threads a CTA, CTAs, dynamic shared bytes and CTAs an SM of
             each launch at the shapes below: from the occupancy API where
             ROOT exports it (``collision_kernel.occupancy``), and for every
             ROOT from the H100's limits (2048 threads, 64K registers, 228
             KB of shared memory and 32 CTAs an SM) with the ptxas
             registers ("ctas_per_sm_from_limits")
  rates      env-steps/s of the collisions example at 8192 worlds x 100
             cubes: main_fused (fused=True, kernel 1; 3 untimed steps,
             then 5 windows of 200 steps, median) and main_unfused
             (fused=False, use_kernel=True, kernel 2; 3 untimed steps, 3
             windows of 50, median)
  ms         CUDA-event device ms a call (200 calls, queued behind a device
             sleep) at the states chip_smoke.py times them at: row 1
             (fused_collisions_step) at main_fused's state after its
             windows, row 2 (collision_pushes) at main_unfused's, row 3
             (collision_pushes, tiled) on chip_smoke.py's W = 16, n = 1500
             data with 128- and 1024-wide j tiles; rows 1 and 2 also at the
             example's initial state ("_initial": ~2% of the live pairs
             overlap there, none at the later states)
  main_fused_profile   torch.profiler over 20 steps of main_fused after
             its windows: device us a step, device ops a step, the busy
             share of the wall time (with the profiler's own overhead)
  pushes_device_ops   the device ops one collision_pushes call queues at
             main_unfused's state (the nodes of a CUDA graph capturing it)

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import json
import os
import subprocess
import sys
import time

WORLDS = 8192


def cuda_ms(torch, fn, iters=200, warmup=3):
    """Device ms a call of fn: the calls are queued behind a device sleep,
    so the events time the device's work, not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rate(sim, steps, count):
    """Median env-steps/s over ``count`` windows of ``steps`` steps."""
    r = []
    for _ in range(count):
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        r.append(steps * sim.cfg.num_worlds / (time.perf_counter() - t0))
    return sorted(r)[len(r) // 2]


def device_events(prof):
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type) and e.self_device_time_total > 0]


def graph_nodes(torch, fn):
    """The device operations one call of fn queues: the nodes of a CUDA
    graph that captures the call (cuGraphGetNodes)."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with {rc}")
    return count.value


def step_profile(torch, sim, steps=20):
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events)
    return {"steps": steps, "device_us_per_step": busy / steps,
            "device_ops_per_step": sum(e.count for e in events) / steps,
            "device_busy_share": busy / wall_us}


def ptxas_lines(log):
    """{kernel: "registers ..., smem ..., stack ..., spills ..."} from an
    nvcc -Xptxas -v log."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
            for name in ("fused_collisions_step_kernel", "collision_pushes_kernelILb1E",
                         "collision_pushes_kernelILb0E", "collision_pushes_kernel"):
                if name in entry:
                    entry = {"collision_pushes_kernelILb1E": "collision_pushes_kernel<true>",
                             "collision_pushes_kernelILb0E": "collision_pushes_kernel<false>"
                             }.get(name, name)
                    break
        elif entry and any(k in ln for k in ("registers", "stack frame")):
            out[entry] = (out.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def registers(line):
    words = line.replace(",", " ").split()
    return int(words[words.index("registers") - 1]) if "registers" in words else None


def ctas_from_limits(threads, regs, smem):
    """CTAs an SM of an H100 by its limits (2048 threads, 65536 registers
    allocated 256 a warp at a time, 228 KB of shared memory with 1 KB
    reserved a CTA, 32 CTAs)."""
    warps = threads // 32
    reg_warp = -(-(regs * 32) // 256) * 256
    by_regs = 65536 // (reg_warp * warps) if regs else 32
    by_smem = (228 * 1024) // (smem + 1024)
    return min(2048 // threads, by_regs, by_smem, 32)


def one(root):
    import torch
    sys.path.insert(0, root)
    import gpu_ecs_madrona_tpu_torch as port
    from gpu_ecs_madrona_tpu_torch.models import collisions as col
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{port.__file__} is not under {root}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    ptxas = ptxas_lines(_build.build(["collision_kernels"])["collision_kernels"])
    res = {"root": root, "card": torch.cuda.get_device_name(0), "ptxas": ptxas}

    fsim = col.make_executor(col.CollisionsConfig(num_worlds=WORLDS), device="cuda")
    fsim.run(3)
    fsim.block_until_ready()
    rates = {"main_fused": rate(fsim, 200, 5)}
    usim = col.make_executor(col.CollisionsConfig(num_worlds=WORLDS, fused=False,
                                                  use_kernel=True), device="cuda")
    usim.run(3)
    usim.block_until_ready()
    rates["main_unfused"] = rate(usim, 50, 3)

    fpos = fsim.mgr.column(fsim.state, col.CubeObject, col.Translation)
    frot = fsim.mgr.column(fsim.state, col.CubeObject, col.Rotation)
    fmask = fsim.mgr.row_mask(fsim.state, col.CubeObject)
    uaabb = usim.mgr.column(usim.state, col.CubeObject, col.PhysicsAABB)
    upos = usim.mgr.column(usim.state, col.CubeObject, col.Translation)
    umask = usim.mgr.row_mask(usim.state, col.CubeObject)
    g = torch.Generator(device=dev).manual_seed(0)           # chip_smoke.py's row-3 data
    p1500 = torch.rand((16, 1500, 3), generator=g, device=dev) * 17.0 - 8.5
    m1500 = torch.rand((16, 1500), generator=g, device=dev) > 0.02
    t_lo, t_hi = p1500 - 1.0, p1500 + 1.0
    ms = {"row1_fused": cuda_ms(torch, lambda: ck.fused_collisions_step(fpos, frot, fmask)),
          "row2_pushes": cuda_ms(torch, lambda: ck.collision_pushes(
              upos, uaabb["lo"], uaabb["hi"], umask))}
    for tile in (0, 1024):
        ms[f"row3_tiled_{tile or 128}"] = cuda_ms(torch, lambda: ck.collision_pushes(
            p1500, t_lo, t_hi, m1500, force_tile=tile))
    ms["row1_fused_again"] = cuda_ms(torch, lambda: ck.fused_collisions_step(fpos, frot, fmask))
    # rows 1 and 2 at the example's initial state (~2% of live pairs overlap,
    # where the later states hold none)
    isim = col.make_executor(col.CollisionsConfig(num_worlds=WORLDS), device="cuda")
    ipos = isim.mgr.column(isim.state, col.CubeObject, col.Translation)
    irot = isim.mgr.column(isim.state, col.CubeObject, col.Rotation)
    imask = isim.mgr.row_mask(isim.state, col.CubeObject)
    ilo, ihi = ck.aabb_plain(ipos, irot)
    ms["row1_fused_initial"] = cuda_ms(torch, lambda: ck.fused_collisions_step(ipos, irot, imask))
    ms["row2_pushes_initial"] = cuda_ms(torch, lambda: ck.collision_pushes(ipos, ilo, ihi, imask))
    res["pushes_device_ops"] = graph_nodes(torch, lambda: ck.collision_pushes(
        upos, uaabb["lo"], uaabb["hi"], umask))
    res["main_fused_profile"] = step_profile(torch, fsim)

    W, n = fmask.shape
    shapes = {}
    for key, (w_, n_, kernel, tile) in {"fused_8192x108": (W, n, "fused", 0),
                                        "pushes_8192x108": (W, n, "pushes", 0),
                                        "pushes_16x1500": (16, 1500, "pushes", 0),
                                        "pushes_16x1500_tile1024": (16, 1500, "pushes", 1024)
                                        }.items():
        if hasattr(ck, "occupancy"):
            shape = ck.occupancy(w_, n_, kernel, tile)
            name = ("fused_collisions_step_kernel" if kernel == "fused" else
                    f"collision_pushes_kernel<{str(shape['path'] == 'tiled').lower()}>")
        else:   # the parent: one launch shape, 128 threads, j tiles of 128 (or the forced)
            tj = tile or 128
            shape = {"path": "parent", "threads": 128,
                     "ctas": w_ * (1 if kernel == "fused" else -(-n_ // 128)),
                     "smem": (n_ if kernel == "fused" else tj) * 37}
            name = ("fused_collisions_step_kernel" if kernel == "fused"
                    else "collision_pushes_kernel")
        shape["ctas_per_sm_from_limits"] = ctas_from_limits(
            shape["threads"], registers(ptxas.get(name, "")), shape["smem"])
        shapes[key] = shape
    res.update(shape=shapes, rates=rates, ms=ms)
    print(json.dumps(res), flush=True)


def main(argv):
    if "--one" in argv:
        one(argv[argv.index("--one") + 1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("collision_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [a for a in argv if not a.startswith("--")]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip().splitlines()[0], "order": roots}), flush=True)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
