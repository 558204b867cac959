#!/usr/bin/env python3
"""Where a step of rigid_bench's dense contact mode and of its sap path
spends the card's time.

    python3 gpu_ecs_madrona_tpu_torch/tools/dense_sap_profile.py [CASE ...]

Run from the root of a checkout, on a machine with a CUDA card.  The
cases (all by default) are chip_smoke.py's main_rigid_dense ("dense":
8192 worlds x 32 bodies + the plane, contact_mode and broadphase "auto":
the dense contact mode and the dense broadphase), main_rigid_sap ("sap":
8192 x 200 + the plane, contact_mode="pallas", broadphase "auto": sap,
kernel 7 at K = 800), and "kernel_at_33_rows": the dense case's worlds
with contact_mode="pallas" (the fused kernel), its yardstick.  Each case,
after 3 untimed steps, prints one JSON line:

  nodes    each node of the step run in order on a Context over the
           executor's state, its device ms (CUDA events around it, the
           device synchronised before and after)
  step     the device ms of a whole step (events around sim.step())
  profile  torch.profiler over one step: the device time summed over the
           step's kernels, their launches, and the 25 kernels with the
           most device time (name, us, launches)
  peak     the peak of allocated device memory over that step, GiB
  card     nvidia-smi's name and power limit
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

CASES = {"dense": dict(num_bodies=32, contact_mode="auto"),
         "sap": dict(num_bodies=200, contact_mode="pallas"),
         "kernel_at_33_rows": dict(num_bodies=32, contact_mode="pallas")}


def events_ms(torch, fn):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("dense_sap_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    for name in argv or list(CASES):
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=8192, **CASES[name]),
                               device="cuda")
        sim.run(3)
        torch.cuda.synchronize()
        ctx = Context(sim.mgr, sim.state)
        nodes = {}
        for nd in sim.graph.nodes:
            nodes[nd.name] = events_ms(torch, lambda nd=nd: nd.run(ctx))
        step = events_ms(torch, sim.step)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels = [e for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", "")) and e.self_device_time_total > 0]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]
        print(json.dumps({
            "case": name, "config": dict(num_worlds=8192, **CASES[name]),
            "nodes_ms": nodes, "step_ms": step,
            "profile": {"wall_ms": wall_ms,
                        "device_us": sum(e.self_device_time_total for e in kernels),
                        "launches": sum(e.count for e in kernels),
                        "top": [{"name": e.key[:90], "us": e.self_device_time_total,
                                 "launches": e.count} for e in top]},
            "peak_gib": peak, "card": card}), flush=True)
        del sim, ctx, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
