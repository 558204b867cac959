#!/usr/bin/env python3
"""Times the render kernel and simple_taskgraph's render node of one or more
checkouts on one card, in turns: an A/B of a change against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/render_ab.py ROOT [ROOT ...]

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
             64 view): the views launch's ms ("views_4096") and the rays
             mode's on the same rays ("rays_4096"), with their digests;
             "refused" where the kernel refuses them, or a note where the
             checkout has no such scene

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import json
import os
import subprocess
import sys
import time

WORLDS, OBJECTS, RES = 1024, 100, 64


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
    -v log; the rays and views modes, and the blocked specialisations, by
    their template arguments."""
    import re
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
            bits = re.findall(r"Lb(\d)E", entry.split("render_kernelI")[-1])
            entry = "render_kernel"
            if bits:
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


def large_case(torch, root, rk, res):
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

    def views_fn():
        return rk.render_views(views, *inst, **kw, height=H, width=Wpx, max_views=V)

    def rays_fn():
        return rk.render(rays, packed, img_w=Wpx, **kw)

    res["large"] = {"ms": {"views_4096": cuda_ms(torch, views_fn, 20),
                           "rays_4096": cuda_ms(torch, rays_fn, 20)},
                    "digests": {"views_4096": digest(views_fn()), "rays_4096": digest(rays_fn())}}


def one(root):
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
    _build.build()
    res = {"root": root, "card": torch.cuda.get_device_name(0),
           "ptxas": ptxas_lines(_build.build(["render_kernels"])["render_kernels"])}

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
    large_case(torch, root, rk, res)
    print(json.dumps(res), flush=True)


def main(argv):
    if "--one" in argv:
        one(argv[argv.index("--one") + 1])
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
                        os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
