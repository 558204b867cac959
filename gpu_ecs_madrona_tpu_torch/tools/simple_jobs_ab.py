#!/usr/bin/env python3
"""Times the simple_jobs kernel (kernel 4) and its node of one or more
checkouts on one card, in turns: an A/B of a change against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/simple_jobs_ab.py [--phases] ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository; each runs in a
process of its own (so that two versions of the package never meet), in
the order given: "parent change change parent" is the usual A/B.  Each
prints one JSON line, from simple_jobs at 1024 worlds x 100 bodies, K =
1600, D = 32 (chip_smoke.py's main_simple_jobs):

  ptxas      registers, stack frame, spills and static shared memory of
             each kernel instantiation in ROOT's csrc/simple_jobs_kernels.cu
             (its build log)
  shape      threads a CTA, dynamic shared bytes and CTAs an SM: from the
             occupancy API where ROOT exports it
             (``simple_jobs_kernel.occupancy``), and for every ROOT from the
             H100's limits with the ptxas registers ("ctas_per_sm_from_limits")
  rates      env-steps/s: main_simple_jobs (fused=True; 3 untimed steps,
             then 5 windows of 200 steps: median, min, max) and
             main_simple_jobs_unfused (fused=False, rank compaction; 3
             untimed steps, 3 windows of 50)
  ms         CUDA-event device ms a call of fused_simple_jobs_step (200
             calls queued behind a device sleep): "main", at the state
             main_simple_jobs' windows leave (chip_smoke.py's timing state;
             "main_again" repeats it); "initial", at the example's initial
             state (~200 overlapping pairs a world, where the later states
             hold a few); "worlds_8192", at an 8192-world executor's
             initial state, for information (several waves of CTAs, where
             1024 worlds are one); "fill_written_bytes", a yardstick of the
             card's write rate: one zero_() over as many bytes as a "main"
             call writes
  pairs      the overlapping ordered pairs a world at those states (mean)
  digests    a SHA-256 of the outputs of the "main" and "initial" calls
             (every output tensor's bytes, in order), and of the rounds
             layout's call at main_simple_jobs_large's shape ("large":
             1024 worlds x 2048 objects, K = 32768, D = 32, the model's
             initial state; "large_after_33_steps": its state after 33
             steps, where rows sum 110-190 pushes; their ms under "ms"
             too), or "refused" where ROOT's
             kernel does not take that shape: two checkouts whose kernels
             give the same outputs bit for bit print the same digests
  node       the fused_step node on main_simple_jobs' state: device ms (20
             runs), host ms a run (20 runs, no sync between) and device
             operations (the nodes of a CUDA graph capturing one run)
  phases     (--phases) the kernel's cycles a CTA by phase (also of the
             rounds layout at the large shape, at its initial state and
             after 33 steps, as main_simple_jobs_large times it), from a copy of
             ROOT's .cu built with clock64() markers (a barrier of the
             threads that compute and thread 0's clock at each phase's
             end, summed over the CTAs with an atomicAdd; the markers'
             barriers are the copy's own),
             at the "main" and "initial" states, with the instrumented
             copy's ms and the SM clock nvidia-smi reads after it; and,
             for one launch behind a device sleep, the global timer (us)
             at each of the first 1024 CTAs' start and last marker, from
             the first start: start p50 and max, end min, p10, p50, p90
             and max, life p50 and max.  The markers of a kernel that has
             none (the PR 2 design) are put in at its phase comments.

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

WORLDS, OBJECTS, K, D = 1024, 100, 1600, 32
LARGE_OBJECTS, LARGE_K = 2048, 32768

# the PR 2 kernel's phases, each ended at the comment that opens the next
PARENT_MARKS = [("  // The world's mean position:", "clamp_aabb"),
                ("  // (3) row a of the overlap mask", "mean"),
                ("  // (4) base = exclusive prefix", "pairs_push"),
                ("  // (4, 5) row a's first degc partners", "scan"),
                ("  // The zero tail", "slots_translation"),
                ("\n}\n\n}  // namespace", "zero_tail")]
NEW_PHASES = ["loads_zeros_queued", "clamp_aabb", "mean_halfbox", "bit_grid", "retest_push",
              "scan", "outputs"]

PRELUDE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long sj_phase_cycles_d[8];
__device__ unsigned long long sj_cta_ns_d[CTA_SLOTS][2];
__device__ inline unsigned long long sj_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SJ_PHASE_START long long sj_t0 = clock64(); \
  if (threadIdx.x == 0 && blockIdx.x < CTA_SLOTS) sj_cta_ns_d[blockIdx.x][0] = sj_ns();
#define SJ_PHASE(k) do { SJ_SYNC(); if (threadIdx.x == 0) { \
    const long long sj_t = clock64(); \
    atomicAdd(&sj_phase_cycles_d[k], (unsigned long long)(sj_t - sj_t0)); sj_t0 = sj_t; \
    if (blockIdx.x < CTA_SLOTS) sj_cta_ns_d[blockIdx.x][1] = sj_ns(); } } while (0)
"""
READER = r"""
extern "C" int sj_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sj_phase_cycles_d, sizeof(unsigned long long) * 8);
  if (e == cudaSuccess && reset) {
    unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(sj_phase_cycles_d, z, sizeof z);
  }
  return (int)e;
}
extern "C" int sj_cta_ns(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, sj_cta_ns_d, sizeof(unsigned long long) * 2 * n);
}
"""
CTA_SLOTS = 1024


def digest(outs):
    """A SHA-256 (16 hex digits) of a call's output tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    r = []
    for _ in range(count):
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        r.append(steps * sim.cfg.num_worlds / (time.perf_counter() - t0))
    r.sort()
    return {"median": r[len(r) // 2], "min": r[0], "max": r[-1]}


def graph_nodes(torch, fn):
    """The device operations one call of fn queues: the nodes of a CUDA
    graph that captures the call (cuGraphGetNodes)."""
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


def ptxas_lines(log):
    """{kernel: "registers ..., smem ..., stack ..., spills ..."} from an
    nvcc -Xptxas -v log, an instantiation by its launch bounds (e.g.
    "fused_simple_jobs_step_kernel<160,8>")."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            name = ln.split("'")[1]
            entry = None
            if "fused_simple_jobs_step_kernel" in name:
                args = re.findall(r"Li(\d+)E", name.split("fused_simple_jobs_step_kernel", 1)[1])
                entry = "fused_simple_jobs_step_kernel" + (f"<{','.join(args)}>" if args else "")
        elif entry and any(k in ln for k in ("registers", "stack frame")):
            out[entry] = (out.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def registers(line):
    words = line.replace(",", " ").split()
    return int(words[words.index("registers") - 1]) if "registers" in words else None


def static_smem(line):
    words = line.replace(",", " ").split()
    return int(words[words.index("smem") - 2]) if "smem" in words else 0


def ctas_from_limits(threads, regs, smem):
    """CTAs an SM of an H100 by its limits (2048 threads, 65536 registers
    allocated 256 a warp at a time, 228 KB of shared memory with 1 KB
    reserved a CTA, 32 CTAs)."""
    warps = threads // 32
    reg_warp = -(-(regs * 32) // 256) * 256
    by_regs = 65536 // (reg_warp * warps) if regs else 32
    by_smem = (228 * 1024) // (smem + 1024)
    return min(2048 // threads, by_regs, by_smem, 32)


def instrumented(root, _build):
    """A copy of ROOT's .cu with phase markers, built into ROOT's build
    directory; returns (library, phase names, whether it takes zeros)."""
    src = open(os.path.join(root, "gpu_ecs_madrona_tpu_torch", "csrc",
                            "simple_jobs_kernels.cu")).read()
    if "SJ_PHASE(" in src:
        names = NEW_PHASES
    else:
        anchor = "  const size_t body = static_cast<size_t>(w) * n0 + a;\n"
        src = "#define SJ_SYNC() __syncthreads()\n" + src.replace(
            anchor, anchor + "  SJ_PHASE_START\n", 1)
        for k, (mark, _) in enumerate(PARENT_MARKS):
            if mark not in src:
                raise RuntimeError(f"phase mark {mark!r} not in {root}'s kernel")
            marker = (f"\n  SJ_PHASE({k});" if mark.startswith("\n")
                      else f"  SJ_PHASE({k});\n")
            src = src.replace(mark, marker + mark, 1)
        names = [n for _, n in PARENT_MARKS]
    out_dir = os.path.join(root, "build", "sj_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "simple_jobs_phases.cu")
    with open(cu, "w") as f:
        f.write((PRELUDE + src + READER).replace("CTA_SLOTS", str(CTA_SLOTS)))
    so = os.path.join(out_dir, "simple_jobs_phases.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    takes_zeros = "void* zeros" in src
    takes_scratch = "void* scratch" in src
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_simple_jobs_step_launch.argtypes = (
        [P, P, I, I, I, I] + [F] * 6 + [P] * (8 + takes_zeros + takes_scratch))
    lib.fused_simple_jobs_step_launch.restype = I
    lib.sj_phase_cycles.argtypes = [P, I]
    lib.sj_phase_cycles.restype = I
    lib.sj_cta_ns.argtypes = [P, I]
    lib.sj_cta_ns.restype = I
    lib.takes_scratch = takes_scratch
    return lib, names, takes_zeros


def phases(torch, lib, names, takes_zeros, pos, rot, bounds, launches=20, k=K, scratch=None):
    W, n0 = pos.shape[:2]
    outs = [torch.empty_like(pos) for _ in range(3)]
    ab = torch.empty((W, k, 2), dtype=torch.int32, device=pos.device)
    nrm = torch.empty((W, k, 3), dtype=torch.float32, device=pos.device)
    ints = [torch.empty((W,), dtype=torch.int32, device=pos.device) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        args = [pos.data_ptr(), rot.data_ptr(), W, n0, k, D,
                *map(float, bounds[0]), *map(float, bounds[1]),
                *(t.data_ptr() for t in outs), ab.data_ptr(), nrm.data_ptr(),
                ints[0].data_ptr(), ints[1].data_ptr()]
        if takes_zeros:
            args.append(ints[2].data_ptr())
        if lib.takes_scratch:
            args.append(None if scratch is None else scratch.data_ptr())
        rc = lib.fused_simple_jobs_step_launch(*args, stream)
        if rc != 0:
            raise RuntimeError(f"instrumented launch failed with cudaError {rc}")

    buf = (ctypes.c_ulonglong * 8)()
    launch()
    torch.cuda.synchronize()
    lib.sj_phase_cycles(buf, 1)
    for _ in range(launches):
        launch()
    torch.cuda.synchronize()
    if lib.sj_phase_cycles(buf, 1) != 0:
        raise RuntimeError("sj_phase_cycles failed")
    cycles = {n: buf[k] / (launches * W) for k, n in enumerate(names)}
    res = {"cycles_per_cta": cycles, "total_cycles_per_cta": sum(cycles.values()),
           "instrumented_ms": cuda_ms(torch, launch)}
    # one launch's CTAs on the global timer (ns): when each started its
    # work and ended its last phase, from the first start
    torch.cuda._sleep(200_000_000)
    launch()
    torch.cuda.synchronize()
    n = min(W, CTA_SLOTS)
    ns = (ctypes.c_ulonglong * (2 * n))()
    if lib.sj_cta_ns(ns, n) != 0:
        raise RuntimeError("sj_cta_ns failed")
    t0 = min(ns[2 * i] for i in range(n))
    starts = sorted(ns[2 * i] - t0 for i in range(n))
    ends = sorted(ns[2 * i + 1] - t0 for i in range(n))
    lives = sorted(ns[2 * i + 1] - ns[2 * i] for i in range(n))
    pct = lambda v, q: v[min(len(v) - 1, int(q * len(v)))] / 1e3  # noqa: E731
    res["cta_us"] = {"start": {"p50": pct(starts, 0.5), "max": starts[-1] / 1e3},
                     "end": {"min": ends[0] / 1e3, "p10": pct(ends, 0.1),
                             "p50": pct(ends, 0.5), "p90": pct(ends, 0.9),
                             "max": ends[-1] / 1e3},
                     "life": {"p50": pct(lives, 0.5), "max": lives[-1] / 1e3}}
    return res


def one(root, with_phases):
    import torch
    sys.path.insert(0, root)
    import gpu_ecs_madrona_tpu_torch as port
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk
    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{port.__file__} is not under {root}")
    torch.cuda.set_device(torch.device("cuda:0"))
    ptxas = ptxas_lines(_build.build(["simple_jobs_kernels"])["simple_jobs_kernels"])
    res = {"root": root, "card": torch.cuda.get_device_name(0), "ptxas": ptxas}

    cfg = dict(num_worlds=WORLDS, num_objects=OBJECTS, max_pairs=K, degree_cap=D)
    sim = sj.make_executor(sj.SimpleJobsConfig(fused=True, **cfg), device="cuda")
    sim.run(3)
    sim.block_until_ready()
    rates = {"main_simple_jobs": rate(sim, 200, 5)}
    os.environ["GEM_SJ_COMPACT"] = "rank"
    usim = sj.make_executor(sj.SimpleJobsConfig(fused=False, **cfg), device="cuda")
    usim.run(3)
    usim.block_until_ready()
    rates["main_simple_jobs_unfused"] = rate(usim, 50, 3)

    bounds = (sj.BOUNDS_LO, sj.BOUNDS_HI)
    kw = dict(n0=OBJECTS, K=K, degree_cap=D, bounds=bounds)
    states = {"main": sim.state["user"],
              "initial": sj.make_executor(sj.SimpleJobsConfig(fused=True, **cfg),
                                          device="cuda").state["user"],
              "worlds_8192": sj.make_executor(sj.SimpleJobsConfig(
                  fused=True, **dict(cfg, num_worlds=8192)), device="cuda").state["user"]}
    ms, pairs = {}, {}
    for name, user in states.items():
        p, r = user["translation"], user["rotation"]
        ms[name] = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(p, r, **kw))
        lo, hi = ck.aabb_plain(sk.clamp_to_bounds(p, bounds), r)
        pairs[name] = float(sk.overlap_grid(lo, hi).sum()) / p.shape[0]
    p, r = states["main"]["translation"], states["main"]["rotation"]
    ms["main_again"] = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(p, r, **kw))
    digests = {name: digest(sk.fused_simple_jobs_step(
        states[name]["translation"], states[name]["rotation"], **kw))
        for name in ("main", "initial")}
    if sk.fused_fits(LARGE_OBJECTS):
        bsim = sj.make_executor(sj.SimpleJobsConfig(
            fused=True, **dict(cfg, num_objects=LARGE_OBJECTS, max_pairs=LARGE_K)),
            device="cuda")
        bkw = dict(kw, n0=LARGE_OBJECTS, K=LARGE_K)
        for name, steps in (("large", 0), ("large_after_33_steps", 33)):
            bsim.run(steps)
            bp, br = bsim.state["user"]["translation"], bsim.state["user"]["rotation"]
            ms[name] = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(bp, br, **bkw), 20)
            digests[name] = digest(sk.fused_simple_jobs_step(bp, br, **bkw))
        del bsim, bp, br
    else:
        ms["large"] = digests["large"] = "refused"
    res["digests"] = digests
    # the card's rate for the bytes a main call writes, as one fill
    fill = torch.empty(WORLDS * (OBJECTS * 36 + K * 20 + 12), dtype=torch.uint8, device=p.device)
    ms["fill_written_bytes"] = cuda_ms(torch, fill.zero_)
    del fill

    node, state = sim.graph.nodes[0], sim.state

    def run():
        node.run(Context(sim.mgr, state))

    node_ms = cuda_ms(torch, run, 20)
    t0 = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    res["node"] = {"name": node.name, "device_ms": node_ms, "host_ms": host_ms,
                   "device_ops": graph_nodes(torch, run)}

    if hasattr(sk, "occupancy"):
        shape = sk.occupancy(WORLDS, OBJECTS, K)
    else:   # the PR 2 launch: a thread a body rounded to 32, 9 floats and the bit words a body
        threads = -(-OBJECTS // 32) * 32
        shape = {"ctas": WORLDS, "threads": threads,
                 "smem": OBJECTS * 9 * 4 + OBJECTS * (threads // 32) * 4}
    # the instantiation the main shape launches: the one whose launch bounds
    # take its threads, the tightest (the PR 2 kernel has one)
    fits = sorted((int(k.split("<")[1].split(",")[0]), k) for k in ptxas if "<" in k)
    line = next((ptxas[k] for t, k in fits if t >= shape["threads"]), None) or \
        next(iter(ptxas.values()), "")
    shape["ctas_per_sm_from_limits"] = ctas_from_limits(
        shape["threads"], registers(line), shape["smem"] + static_smem(line))
    res.update(shape=shape, rates=rates, ms=ms, pairs_per_world=pairs)

    if with_phases:
        lib, names, takes_zeros = instrumented(root, _build)
        res["phases"] = {}
        for name in ("main", "initial"):
            user = states[name]
            res["phases"][name] = phases(torch, lib, names, takes_zeros, user["translation"],
                                         user["rotation"], bounds)
        if sk.fused_fits(LARGE_OBJECTS):
            # the rounds layout (its first phase, the producer's, is empty)
            big = sj.make_executor(sj.SimpleJobsConfig(
                fused=True, **dict(cfg, num_objects=LARGE_OBJECTS, max_pairs=LARGE_K)),
                device="cuda")
            for name, steps in (("large_initial", 0), ("large_after_33_steps", 33)):
                big.run(steps)
                user = big.state["user"]
                res["phases"][name] = phases(
                    torch, lib, names, takes_zeros, user["translation"], user["rotation"],
                    bounds, launches=3, k=LARGE_K,
                    scratch=sk.scratch(WORLDS, LARGE_OBJECTS, user["translation"].device))
            del big
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True)
        res["phases"]["sm_clock_after"] = smi.stdout.strip()
    print(json.dumps(res), flush=True)


def main(argv):
    if "--one" in argv:
        one(argv[argv.index("--one") + 1], "--phases" in argv)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("simple_jobs_ab: no CUDA device", file=sys.stderr)
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
                        os.path.abspath(root)] + (["--phases"] if "--phases" in argv else []),
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
