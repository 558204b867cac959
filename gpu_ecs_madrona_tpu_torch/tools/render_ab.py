#!/usr/bin/env python3
"""Times the render kernel and simple_taskgraph's render node of one or more
checkouts on one card, in turns: an A/B of a change against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/render_ab.py [--phases] [--large-only] ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository; each runs in a
process of its own (so that two versions of the package never meet), in
the order given: "parent change change parent" is the usual A/B.  Each
prints one JSON line, from simple_taskgraph at 1024 worlds x 100 spheres,
64 x 64 RGB and depth:

  rate       main_simple_taskgraph's env-steps/s: 3 untimed steps, then 5
             windows of 50 steps, median, min and max; what follows is
             timed at the state they leave (chip_smoke.py's timing state)
  ptxas      registers, stack frame and spills of each kernel in ROOT's
             csrc/render_kernels.cu (its build log)
  ms         CUDA-event device ms a call (200 calls, queued behind a device
             sleep): "rays_equal_work", the kernel on the rays and
             instances the node's rays-mode route gives it
             (``render(rays, inst, img_w=64)``, row 10 at equal work); and,
             where ROOT has it, "views_launch", the node's one launch
             (``RenderKernel.render_views``)
  render_node   the batch_render node on the state the step's nodes before
             it leave: device ms (20 runs), host ms a run (20 runs, no sync
             between), device operations (the nodes of a CUDA graph
             capturing one run)
  render_group_ms   device ms of the step's render nodes together
             (render_pack, batch_render; 20 runs)
  digests    a SHA-256 of each timed call's outputs (two checkouts whose
             kernel gives the same outputs bit for bit print the same)
  large      tests/test_torch_render_scenes.py's large instances (4,096
             rows a world, past one block's shared memory) at
             chip_smoke.py's main_render_large shape (256 worlds, one 64 x
             64 view): the views launch's ms ("views_4096"), the rays
             mode's on the same rays ("rays_4096") and on a 360-degree
             sweep of 64 x 64 rays from each world's eye (``sweep_rays``,
             +-30 degrees of elevation; "sweep_4096"), with their digests
             and the rays mode's launch shape (CTAs an SM, CTAs an image,
             stages or blocks a CTA at most); "refused" where the kernel
             refuses them, or a note where the checkout has no such scene.
             A checkout without ``sweep_rays`` takes this checkout's
  phases     (--phases) the large launches' cycles a warp by phase, from a
             copy of ROOT's csrc/render_kernels.cu built with its RK_PHASE
             markers defined (each warp adds clock64() differences by phase
             in registers, no barrier, and its lane 0 adds them to a
             __device__ array at the end, read back through
             cudaMemcpyFromSymbol), with the instrumented copy's ms and the
             SM clock nvidia-smi reads after it.  The phase names are the
             source's "RK_PHASES:" lines; a checkout without markers (the kernel
             before them) gets PARENT_MARKS put in at their anchors.

--large-only skips everything but the large case (and its phases).

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import json
import os
import subprocess
import sys
import time

WORLDS, OBJECTS, RES = 1024, 100, 64

# the phases of the kernel before the markers: (anchor, marker, marker after
# the anchor)
PARENT_NAMES = ("setup stage_loads cone_cull stage_compact tile_setup carried_load tile_cull "
                "trace carried_store shade block_sync").split()
PARENT_MARKS = [
    ("  __shared__ int s_count[kWarps];\n", "  RK_PHASE_START\n", True),
    ("    sin_v = sqrtf(fmaxf(1.0f - cos_v * cos_v, 0.0f));\n  }\n", "  RK_PHASE(0);\n", True),
    ("      const float rbs = __ldg(tb + kRBound) * fmaxf(fmaxf(s.x, s.y), s.z);\n",
     "      RK_PHASE(1);\n", True),
    ("      const unsigned ballot = __ballot_sync(0xffffffffu, keep);\n",
     "      RK_PHASE(2);\n", False),
    ("      M += chunk;\n      __syncthreads();\n", "      RK_PHASE(3);\n", True),
    ("      int best_gid = -1;\n", "      RK_PHASE(4);\n", True),
    ("                         : __float_as_int(a.out[o_px + 3 * static_cast<size_t>(a.P)]);\n"
     "      }\n", "      RK_PHASE(5);\n", True),
    ("        if (pad) continue;\n", "        RK_PHASE(6);\n", False),
    ("            best_sphere = false;\n          }\n        }\n", "        RK_PHASE(7);\n", True),
    ("        continue;\n      }\n      if (best_k >= 0) {\n", "        RK_PHASE(8);\n", False),
    ("          o[4 * a.P] = hit ? best_t : kBig;\n        }\n      }\n", "      RK_PHASE(9);\n",
     True),
    ("      __syncthreads();   // the next block's staging overwrites this one's\n",
     "      RK_PHASE(10);\n", True),
    ("  } else {\n    pass(0, N);\n  }\n", "  RK_PHASE_END\n", True)]
PHASE_SLOTS = 16
PRELUDE = r"""
#include <cuda_runtime.h>
__device__ unsigned long long rk_phase_cycles_d[PHASE_SLOTS + 1];
#define RK_PHASE_START long long rk_t0 = clock64(); \
  unsigned long long rk_acc[PHASE_SLOTS] = {};
#define RK_PHASE(k) do { const long long rk_t = clock64(); \
    rk_acc[k] += (unsigned long long)(rk_t - rk_t0); rk_t0 = rk_t; } while (0)
#define RK_PHASE_END if ((threadIdx.x & 31) == 0) { \
    for (int rk_k = 0; rk_k < PHASE_SLOTS; ++rk_k) \
      if (rk_acc[rk_k]) atomicAdd(&rk_phase_cycles_d[rk_k], rk_acc[rk_k]); \
    atomicAdd(&rk_phase_cycles_d[PHASE_SLOTS], 1ull); }
"""
READER = r"""
extern "C" int rk_phase_cycles(unsigned long long* out, int reset) {
  const size_t n = sizeof(unsigned long long) * (PHASE_SLOTS + 1);
  cudaError_t e = cudaMemcpyFromSymbol(out, rk_phase_cycles_d, n);
  if (e == cudaSuccess && reset) {
    unsigned long long z[PHASE_SLOTS + 1] = {};
    e = cudaMemcpyToSymbol(rk_phase_cycles_d, z, n);
  }
  return (int)e;
}
"""


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


def ptxas_lines(log):
    """{kernel: "registers ..., stack ..., spills ..."} from an nvcc -Xptxas
    -v log, each kernel by its name; render_kernel's modes (and, before it
    lost them, its blocked specialisations) by their template arguments."""
    import re
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
            m = re.search(r"\d+(render\w*?kernel)((?:I(?:Lb\d+E)+E)?)", entry)
            bits = re.findall(r"Lb(\d)E", m.group(2)) if m else []
            entry = m.group(1) if m else entry
            if entry == "render_kernel" and bits:
                entry += "<" + ("views" if bits[0] == "1" else "rays") + (
                    ",blocked" if bits[1:2] == ["1"] else "") + ">"
        elif entry and any(k in ln for k in ("registers", "stack frame")):
            out[entry] = (out.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def digest(x):
    """SHA-256 of the tensors in x (a tensor or a tuple of them), their bytes
    as they are on the card."""
    import hashlib
    h = hashlib.sha256()
    for t in (x if isinstance(x, tuple) else (x,)):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def marked_source(root):
    """ROOT's render .cu with phase markers (its own, or PARENT_MARKS put
    in) and the phase names."""
    src = open(os.path.join(root, "gpu_ecs_madrona_tpu_torch", "csrc",
                            "render_kernels.cu")).read()
    if "RK_PHASE(" in src:
        names = " ".join(ln.split("RK_PHASES:", 1)[1] for ln in src.splitlines()
                         if "// RK_PHASES:" in ln).split()
        return src, names
    for anchor, marker, after in PARENT_MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor {anchor!r} is not in {root}'s kernel once")
        src = src.replace(anchor, anchor + marker if after else marker + anchor)
    return src, PARENT_NAMES


def instrumented(root, _build):
    """ROOT's render .cu built with its phase markers defined, into ROOT's
    build directory: (the library, the phase names)."""
    import ctypes
    src, names = marked_source(root)
    out_dir = os.path.join(root, "build", "rk_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "render_phases.cu")
    with open(cu, "w") as f:
        f.write((PRELUDE + src + READER).replace("PHASE_SLOTS", str(PHASE_SLOTS)))
    so = os.path.join(out_dir, "render_phases.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.rk_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rk_phase_cycles.restype = ctypes.c_int
    return lib, names


def phase_cycles(torch, lib, names, fn, launches=5):
    """fn's cycles a warp by phase (mean over launches and warps), run on
    the instrumented library lib."""
    import ctypes
    buf = (ctypes.c_ulonglong * (PHASE_SLOTS + 1))()
    fn()
    torch.cuda.synchronize()
    lib.rk_phase_cycles(buf, 1)
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    if lib.rk_phase_cycles(buf, 1) != 0:
        raise RuntimeError("rk_phase_cycles failed")
    warps = buf[PHASE_SLOTS] / launches
    cycles = {n: buf[k] / launches / max(warps, 1) for k, n in enumerate(names)}
    return {"cycles_per_warp": cycles, "total_cycles_per_warp": sum(cycles.values()),
            "warps_a_launch": warps, "instrumented_ms": cuda_ms(torch, fn, 5)}


def own_scenes():
    """This checkout's tests/test_torch_render_scenes.py, loaded under a name
    of its own (for a checkout whose scenes lack the sweep)."""
    import importlib.util
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "render_ab_scenes", os.path.join(here, "tests", "test_torch_render_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def large_case(torch, root, rk, res, with_phases=False, _build=None):
    """The large case (see the module doc)."""
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_render_scenes as scenes
    if not hasattr(scenes, "large_view_case"):
        res["large"] = "no large scene in this checkout"
        return
    k, views, inst, V, H, Wpx = scenes.large_view_case(W=256, H=RES, Wpx=RES, device="cuda")
    if rk.kernel_fits(inst[0].shape[1], views=True):
        res["large"] = "refused"
        return
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
    ro, d = rk.camera_rays(views, V, H, Wpx)
    rays, packed = k.pack(ro.reshape(256, -1, 3), d.reshape(256, -1, 3), *inst)

    sweep = getattr(scenes, "sweep_rays", None) or own_scenes().sweep_rays
    sro, srd = (torch.from_numpy(a).to("cuda")
                for a in sweep(views["eye"][:, 0].cpu().numpy(), H, Wpx))
    srays, _ = k.pack(sro, srd, *inst)
    fns = {"views_4096": lambda: rk.render_views(views, *inst, **kw, height=H, width=Wpx,
                                                 max_views=V),
           "rays_4096": lambda: rk.render(rays, packed, img_w=Wpx, **kw),
           "sweep_4096": lambda: rk.render(srays, packed, img_w=Wpx, **kw)}
    N, tiles = packed.shape[2], rk.tile_shape(rays.shape[2], Wpx)[3]
    # the rays twin's bands (a checkout before it: the blocked kernel's
    # launch_splits)
    splits = rk.rays_splits(tiles) if hasattr(rk, "rays_splits") else rk.launch_splits(256, tiles)
    shape = {"ctas_per_sm": rk.occupancy(N, False, H, Wpx), "splits": splits,
             "stages_at_most": rk.stage_blocks(N, False, H, Wpx)}
    res["large"] = {"ms": {name: cuda_ms(torch, fn, 20) for name, fn in fns.items()},
                    "digests": {name: digest(fn()) for name, fn in fns.items()},
                    "rays_launch": shape}
    if with_phases:
        lib, names = instrumented(root, _build)
        built = _build._loaded.get("render_kernels")
        _build._loaded["render_kernels"] = lib      # rk._lib() types and takes it
        try:
            got = {name: phase_cycles(torch, lib, names, fn) for name, fn in fns.items()}
            got["digests"] = {name: digest(fn()) for name, fn in fns.items()}
        finally:
            _build._loaded["render_kernels"] = built
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True)
        got["sm_clock_after"] = smi.stdout.strip()
        res["phases"] = got


def one(root, with_phases=False, large_only=False):
    import torch
    sys.path.insert(0, root)
    import gpu_ecs_madrona_tpu_torch as port
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{port.__file__} is not under {root}")
    torch.cuda.set_device(torch.device("cuda:0"))
    _build.build(["render_kernels"] if large_only else None)
    res = {"root": root, "card": torch.cuda.get_device_name(0),
           "ptxas": ptxas_lines(_build.build(["render_kernels"])["render_kernels"])}
    if large_only:
        large_case(torch, root, rk, res, with_phases, _build)
        print(json.dumps(res), flush=True)
        return

    sim = stg.make_executor(stg.SimpleTaskgraphConfig(
        num_worlds=WORLDS, num_objects=OBJECTS, render=True, render_width=RES,
        render_height=RES), device="cuda")
    sim.run(3)
    sim.block_until_ready()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        sim.run(50)
        sim.block_until_ready()
        rates.append(50 * WORLDS / (time.perf_counter() - t0))
    rates.sort()
    res["rate"] = {"median": rates[2], "min": rates[0], "max": rates[-1]}
    rend = sim.world_cls.renderer()
    k = rend._kernel
    render_in = sim.state["user"]["render"]
    rays, inst = rend.kernel_inputs(render_in, [stg.Sphere])
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient)
    ms = {"rays_equal_work": cuda_ms(torch, lambda: rk.render(rays, inst, img_w=RES, **kw))}
    res["digests"] = {"rays_equal_work": digest(rk.render(rays, inst, img_w=RES, **kw))}
    if hasattr(k, "render_views"):
        views, insts = render_in["__views__"], rend.instances(render_in, [stg.Sphere])
        ms["views_launch"] = cuda_ms(torch, lambda: k.render_views(
            views, *insts, height=RES, width=RES, max_views=1))
        res["digests"]["views_launch"] = digest(k.render_views(
            views, *insts, height=RES, width=RES, max_views=1))

    ctx = Context(sim.mgr, sim.state)
    for node in sim.graph.nodes:           # the step's nodes before the render node
        if node.name == "batch_render":
            break
        node.run(ctx)
    state = ctx.state

    def run():
        node.run(Context(sim.mgr, state))

    node_ms = cuda_ms(torch, run, 20)
    t0 = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    res["render_node"] = {"device_ms": node_ms, "host_ms": host_ms,
                          "device_ops": graph_nodes(torch, run)}
    group = [nd for nd in sim.graph.nodes if nd.name in ("render_pack", "batch_render")]

    def run_group():
        gctx = Context(sim.mgr, sim.state)
        for nd in group:
            nd.run(gctx)

    res["render_group_ms"] = cuda_ms(torch, run_group, 20)

    res["ms"] = ms
    large_case(torch, root, rk, res, with_phases, _build)
    print(json.dumps(res), flush=True)


def main(argv):
    flags = [a for a in argv if a in ("--phases", "--large-only")]
    if "--one" in argv:
        one(argv[argv.index("--one") + 1], "--phases" in flags, "--large-only" in flags)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("render_ab: no CUDA device", file=sys.stderr)
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
                        os.path.abspath(root)] + flags, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
