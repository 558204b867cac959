#!/usr/bin/env python3
"""Times the physics substep kernels of one or more checkouts on one card,
in turns: an A/B of a change against its parent.

    python3 gpu_ecs_madrona_tpu_torch/tools/substep_ab.py ROOT [ROOT ...]
    python3 gpu_ecs_madrona_tpu_torch/tools/substep_ab.py --phases ROOT
    python3 gpu_ecs_madrona_tpu_torch/tools/substep_ab.py --stg ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository; each runs in a
process of its own (so that two versions of the package never meet), in
the order given: "parent change change parent" is the usual A/B.  Each
prints one JSON line:

  ptxas      registers, stack frame and spills of each substep kernel
             (the build log of ROOT's csrc/substep_kernels.cu)
  occupancy  threads a CTA and CTAs an SM of each specialisation at
             8192 x 65 (K = 256 and 128) and of the single-substep kernel
             at 1024 x 104, K = 1000 (and of its node launch with the 64
             joint rows, where ROOT has one)
  stg        simple_taskgraph at 1024 worlds x 100 spheres, 64 x 64 RGB
             and depth (with --stg, the only case): env-steps/s
             (main_simple_taskgraph, in rates) over 5 windows of 50 steps
             after 3; at that state row 5 at equal work (ms "row5_substep":
             the single-substep kernel from the post-integrate columns)
             and, where ROOT has it, kernel 5's node launch (ms
             "row5_node": with the integrate, the joints and the
             writeback); and the first substep node: its device ms a run,
             the device ops it queues (torch.profiler, by name) and the
             host ms a run takes to queue them (20 runs, no sync between)
  rates      env-steps/s of rigid_bench at 8192 x 64 (main_rigid: K = 256,
             the dense broadphase; main_rigid_fused_bp: the broadphase in
             the kernel): 3 untimed steps, 5 windows of 50 steps; and of
             the settled pile with persistence and sleep
             (main_rigid_settled) and without (main_rigid_settled_nopersist)
             after 400 + 3 untimed steps
  ms         CUDA-event device ms a call (20 calls, queued behind a device
             sleep) of the kernels of PERF.md's rows 5-9 at the states the
             chip smoke test times them at: rows 7 and 6 at main_rigid's
             state after 253 steps (K = 256, 128), row 8 at
             main_rigid_fused_bp's, row 9 at the settled pile after 400 +
             253 steps (as it is, and with its flags flipped so that every
             branch runs), row 8 with refresh at the settled pile without
             persistence, row 5 as the stg case says.  Row 9 is the
             launch the fused node makes: where ROOT has world_flags, the
             world flags kernel and
             fused_substep with the cache and anchors in place (on scratch
             copies), else fused_substep alone (its flags were PyTorch
             glue); so also fused_node_settled, the device ms of the whole
             fused node at the settled pile, which is the same work in both
  digests    a SHA-256 of the outputs of each row's call in ms (every output
             tensor's bytes, keys in order): two checkouts whose kernels give
             the same outputs bit for bit print the same digests
  settled    at the settled pile after those steps: the host ms a run of
             the fused node takes to queue its work (20 runs, no sync
             between), the device ops it queues (torch.profiler, by
             name), and over 20 steps
             the device busy share of the wall time and the device ops a
             step
  hulls      where ROOT has the general-hull paths (tests/
             test_torch_hull_scenes.py): the hull pile (rigid_bench at 8192 x
             64 with the imported prism for its box, K = 256): env-steps/s
             (main_rigid_hulls) after 3 untimed steps, the "hull" launch's ms
             at its state after 253 steps (hull_K256) and at K = 128
             (hull_K128), the settled hull pile's launch
             (hull_persist_settled, main_rigid_hulls_settled's rate) after
             400 + 253 steps and with its flags flipped
             (hull_persist_flipped), kernel 5's general-hull twin on the
             pile's first substep (hull_substep) and its node launch on the
             joint world of prisms (hull_node_joints), each with its output
             digest; and where the scenes have the 24-sided prism, its pile
             at the same width after 3 steps (hull_large_K256, or
             "refused" where the kernel refuses its tables)
  window     rigid_bench at 8192 x 255 bodies + the plane (K = 1020, the
             sap broadphase), chip_smoke.py's main_rigid_sap_large: its
             env-steps/s after 3 untimed steps and the fused launch's ms at
             its state after 103 steps (window_n256_K1020), with the
             digest; and the imported-prism pile at 255 bodies after 3 steps
             (window_hull_n256_K1020); "refused" where the kernel refuses
             these shapes (one block's shared memory); the occupancy of the
             windowed specialisations at that shape ("occupancy" "n256_K1020")
  shapes     the shapes past one block's resources: rigid_bench at 8192 x
             1,023 bodies + the plane (K = 4,092, sap), chip_smoke.py's
             main_rigid_sap_xlarge, its fused launch ("win+bodies") at its
             state after 3 steps (bodies_n1024_K4092); row 7 at main_rigid's
             state with the box table padded to 9 and 32 verts a hull
             (wide_box_vm9_K256, wide_box_vm32_K256); and kernel 5's node
             launch on the chains' world of tests/test_torch_joint_scenes.py
             at 1024 worlds, 4,096 joint rows (joint_rows_node_J4096); each
             with its digest, or "refused" where ROOT's kernel (or its
             tests' scenes) do not take the shape
  phases     (--phases) row 7's time at main_rigid's state with 0, 1 and 4
             substeps, with every slot cleared (the integrate and the body
             phases), with only the slots of one contact kind valid; row
             8's with 0 substeps (its broadphase and the loads and stores)

The script needs a CUDA card; without one it exits 1 and prints nothing.
"""

import json
import os
import subprocess
import sys
import time

RB_WORLDS, STG_WORLDS = 8192, 1024


def cuda_ms(torch, fn, iters=20, warmup=3):
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


def digest(x):
    """SHA-256 of the tensors in x (a tensor, or dicts and tuples of them,
    dict keys in sorted order), their bytes as they are on the card."""
    import hashlib

    import torch
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                h.update(k.encode())
                walk(v[k])
        elif isinstance(v, (tuple, list)):
            for item in v:
                walk(item)
        elif isinstance(v, torch.Tensor):
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    walk(x)
    return h.hexdigest()[:16]


def rate(sim, steps=50, count=5):
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


def node_profile(torch, sim, name):
    """(device ms of one run of sim's node ``name`` on the state the step's
    nodes before it make of sim's, as cuda_ms times it; {its device ops by
    name (torch.profiler), their count, the host ms a run takes to queue
    them})."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from gpu_ecs_madrona_tpu_torch.core.context import Context
    ctx = Context(sim.mgr, sim.state)
    for node in sim.graph.nodes:           # the step's nodes before it, once
        if node.name == name:
            break
        node.run(ctx)
    state = ctx.state

    def run():
        node.run(Context(sim.mgr, state))

    ms = cuda_ms(torch, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20     # the host's enqueue, not synced
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = {}
    for e in device_events(prof):
        ops[e.key[:60]] = ops.get(e.key[:60], 0) + e.count
    return ms, {"host_ms": host_ms, "device_ops": sum(ops.values()), "ops": ops}


def settled_profile(torch, sim):
    """(device ms of one run of sim's fused node on its state, as cuda_ms
    times it; {the device ops one run queues (torch.profiler), the device
    busy share of the wall time of 20 steps and the device ops a step})."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from gpu_ecs_madrona_tpu_torch import physics as phys
    ms, node = node_profile(torch, sim, phys.FUSED_NODE)
    sim.run(3)
    sim.block_until_ready()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(20)
        sim.block_until_ready()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events)
    return ms, {"fused_node_host_ms": node["host_ms"],
                "fused_node_device_ops": node["device_ops"], "fused_node_ops": node["ops"],
                "steps": 20, "wall_us": wall_us, "device_busy_us": busy,
                "device_busy_share": busy / wall_us,
                "device_ops_per_step": sum(e.count for e in events) / 20}


def kind_masks(torch, kw, prim_type):
    """Valid candidate slots [W, K] by contact kind."""
    prim = torch.as_tensor(prim_type, device=kw["obj"].device)
    pa = prim[torch.gather(kw["obj"], 1, kw["rows_i"].long()).long()]
    pb = prim[torch.gather(kw["obj"], 1, kw["rows_j"].long()).long()]
    lo, hi = torch.minimum(pa, pb), torch.maximum(pa, pb)   # 0 sphere, 1 hull, 2 plane
    kinds = {"sphere-sphere": (lo == 0) & (hi == 0), "sphere-box": (lo == 0) & (hi == 1),
             "sphere-plane": (lo == 0) & (hi == 2), "box-box": (lo == 1) & (hi == 1),
             "box-plane": (lo == 1) & (hi == 2)}
    return {k: v & kw["kvalid"] for k, v in kinds.items()}


def occupancy(ctypes, lib, n, K, hull_floats=None):
    """{specialisation: [threads, CTAs an SM]} where the library exports it;
    hull_floats: the staged floats a row the general-hull twins take (the
    imported prism's), where the library stages hull rows."""
    if not hasattr(lib, "fused_substep_occupancy"):
        return "not exported"
    out = {}
    t, b = ctypes.c_int(), ctypes.c_int()
    for code, name in ((0, "none"), (1, "refresh"), (2, "sleep"), (3, "refresh+sleep"),
                       (4, "bp"), (5, "refresh+bp"), (13, "refresh+bp+persist"),
                       (15, "refresh+sleep+bp+persist")):
        for bit, suffix in ((0, ""), (16, "+hull")):
            if hull_floats is None:
                rc = lib.fused_substep_occupancy(code | bit, n, K, ctypes.byref(t),
                                                 ctypes.byref(b))
            else:
                rc = lib.fused_substep_occupancy(code | bit, n, K, hull_floats if bit else 0,
                                                 ctypes.byref(t), ctypes.byref(b))
            if rc == 0:
                out[name + suffix] = [t.value, b.value]
            elif not bit:
                out[name] = f"cudaError {rc}"
    return out


def stg_case(torch, ms, rates, res):
    """The stg case (see the module doc) of the imported checkout."""
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
    RS = phys.RigidBodyPhysicsSystem
    ssim = stg.make_executor(stg.SimpleTaskgraphConfig(
        num_worlds=STG_WORLDS, num_objects=100, render=True, render_width=64,
        render_height=64), device="cuda")
    ssim.run(3)
    ssim.block_until_ready()
    rates["main_simple_taskgraph"] = rate(ssim)
    kw1 = RS.substep_kernel_inputs(RS.next_step_kernel_inputs(ssim, stg.Sphere, stg.OBJMGR))
    kern1 = sk.SubstepKernel(stg.OBJMGR, relaxation=0.7)
    ms["row5_substep"] = cuda_ms(torch, lambda: kern1(**kw1), 200)
    res.setdefault("digests", {})["row5_substep"] = digest(kern1(**kw1))
    if hasattr(sk.SubstepKernel, "step"):
        kern = RS.substep_kernel(ssim)
        kwn = RS.next_step_kernel_inputs(ssim, stg.Sphere, stg.OBJMGR, node=True)
        ms["row5_node"] = cuda_ms(torch, lambda: kern.step(**kwn), 200)
        res["digests"]["row5_node"] = digest(kern.step(**kwn))
    ms["stg_substep_node"], node = node_profile(torch, ssim, "physics_substep_0")
    res["stg"] = dict(node, pairs_per_world_max=int(kw1["kvalid"].sum(1).max()))


def hull_case(torch, root, ms, rates, res, timed):
    """The hulls case (see the module doc), where ROOT has the hull scenes;
    timed(name, fn) times fn and keeps its outputs' digest."""
    if not os.path.exists(os.path.join(root, "tests", "test_torch_hull_scenes.py")):
        res["hulls"] = "no general-hull paths in this checkout"
        return
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_hull_scenes as hs
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    RS = phys.RigidBodyPhysicsSystem

    def hull_sim(**cfg):
        return hs.hull_pile(rb.RigidBenchConfig(**dict(hs.HULL_PILE, **cfg)), device="cuda")

    def inputs(sim):
        return RS.next_step_kernel_inputs(sim, rb.Body, sim.world_cls.objmgr)

    for K in (256, 128):
        sim = hull_sim(max_candidates=K)
        sim.run(3)
        sim.block_until_ready()
        if K == 256:
            rates["main_rigid_hulls"] = rate(sim)
        else:
            sim.run(250)
        kern, kw = RS.fused_kernel(sim), inputs(sim)
        timed(f"hull_K{K}", lambda: kern(**kw))
        if K == 256:
            res["hulls"] = {"live_slots": {k: int(v.sum()) for k, v in kind_masks(
                torch, kw, sim.world_cls.objmgr["prim_type"]).items()}}
            single = phys.subk.SubstepKernel(sim.world_cls.objmgr, relaxation=0.7)
            kw1 = RS.substep_kernel_inputs(kw)
            timed("hull_substep", lambda: single(**kw1))
        del sim, kw
    settled = hull_sim(**{k: v for k, v in hs.HULL_SETTLED.items() if k not in hs.HULL_PILE})
    settled.run(rb.SETTLE_STEPS + 3)
    rates["main_rigid_hulls_settled"] = rate(settled)
    pkern, kwp = RS.fused_kernel(settled), inputs(settled)
    fkw = RS.next_step_kernel_inputs(settled, rb.Body, None, flags=True)
    opts = dict(mcache_out=kwp["mcache"].clone(), keep_velocity=True,
                anchors=tuple(fkw[k].clone() for k in ("apos", "arot", "valid")))
    kwl = {k: x for k, x in kwp.items() if k not in ("im", "ii", "mu_s", "mu_d")}
    timed("hull_persist_settled", lambda: (phys.subk.world_flags(**fkw), pkern(**kwl, **opts)))
    worlds = torch.arange(RB_WORLDS, device=kwp["pos"].device)
    flipped = dict(kwl, stable=kwp["stable"] ^ (worlds % 2 == 1),
                   active=kwp["active"] ^ (worlds % 4 >= 2))
    timed("hull_persist_flipped", lambda: pkern(**flipped, **opts))
    res["hulls"]["settled_branches"] = {
        "asleep": int((~kwp["active"]).sum()),
        "awake_stable": int((kwp["active"] & kwp["stable"]).sum())}
    del settled
    import test_torch_joint_scenes as joint_scenes
    jsim = joint_scenes.joint_world("pallas", num_worlds=256, device="cuda",
                                    body=hs.prism_object())
    jsim.run(5)
    jkern = RS.substep_kernel(jsim)
    jkw = RS.next_step_kernel_inputs(jsim, None, None, node=True)
    timed("hull_node_joints", lambda: jkern.step(**jkw))
    del jsim
    if hasattr(hs, "large_hull_object_manager"):
        large = hs.hull_pile(rb.RigidBenchConfig(**hs.HULL_PILE), device="cuda", large=True)
        large.run(3)
        lkern, lkw = RS.fused_kernel(large), inputs(large)
        timed("hull_large_K256", lambda: lkern(**lkw))
        res["hulls"]["large_live_slots"] = {k: int(v.sum()) for k, v in kind_masks(
            torch, lkw, large.world_cls.objmgr["prim_type"]).items()}


def window_case(torch, root, ms, rates, res, timed):
    """The window case (see the module doc); timed(name, fn) times fn and
    keeps its outputs' digest."""
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
    RS = phys.RigidBodyPhysicsSystem
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_hull_scenes as hs
    from gpu_ecs_madrona_tpu_torch.physics import assets
    from gpu_ecs_madrona_tpu_torch.utils import importer
    cfg = rb.RigidBenchConfig(num_worlds=RB_WORLDS, num_bodies=255, contact_mode="pallas")
    for name, make, om in (("window_n256_K1020", rb.make_executor, rb.RigidBenchWorld.objmgr),
                           ("window_hull_n256_K1020", hs.hull_pile,
                            hs.hull_object_manager(assets, importer))):
        if sk.kernel_fits(sk.pk.ObjTables(om), 256, 1020):
            ms[name] = "refused"
            continue
        sim = make(cfg, device="cuda")
        sim.run(3)
        sim.block_until_ready()
        if name == "window_n256_K1020":
            rates["main_rigid_sap_large"] = rate(sim, 20, 5)
        kern = RS.fused_kernel(sim)
        kw = RS.next_step_kernel_inputs(sim, rb.Body, sim.world_cls.objmgr)
        timed(name, lambda: kern(**kw))
        del sim, kw
    if hasattr(sk, "OPT_WIN"):
        res["occupancy"]["n256_K1020"] = sk.occupancy(256, 1020, codes=(
            sk.OPT_WIN, sk.OPT_WIN | sk.OPT_REFRESH))


def shapes_case(torch, root, ms, res, timed, kw256):
    """The shapes case (see the module doc); timed(name, fn) times fn and
    keeps its outputs' digest."""
    import numpy as np

    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
    RS = phys.RigidBodyPhysicsSystem
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, num_bodies=1023,
                                               contact_mode="auto", broadphase_mode="auto"),
                           device="cuda")
    sim.run(3)
    kern, kw = RS.fused_kernel(sim), RS.next_step_kernel_inputs(sim, rb.Body,
                                                                 rb.RigidBenchWorld.objmgr)
    timed("bodies_n1024_K4092", lambda: kern(**kw))
    del sim, kw
    om = rb.RigidBenchWorld.objmgr
    for vm in (9, 32):
        wide = dict(om, verts=np.pad(om["verts"], ((0, 0), (0, vm - om["verts"].shape[1]),
                                                   (0, 0))))
        name = f"wide_box_vm{vm}_K256"
        if sk.kernel_fits(sk.pk.ObjTables(wide), 65, 256):
            ms[name] = res["digests"][name] = "refused"
            continue
        wkern = sk.FusedSubstepKernel(wide, 4, relaxation=0.7)
        timed(name, lambda: wkern(**kw256))
    sys.path.insert(0, os.path.join(root, "tests"))
    import test_torch_joint_scenes as js
    name = "joint_rows_node_J4096"
    if not hasattr(js, "chain_world"):
        ms[name] = res["digests"][name] = "refused"
        return
    csim = js.chain_world("pallas", num_worlds=STG_WORLDS, device="cuda")
    csim.run(2)
    ckern = RS.substep_kernel(csim)
    ckw = RS.next_step_kernel_inputs(csim, csim.world_cls.Body, None, node=True)
    timed(name, lambda: ckern.step(**ckw))


def one(root, phases, stg_only):
    import ctypes

    import torch
    sys.path.insert(0, root)
    import gpu_ecs_madrona_tpu_torch as port
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
    if not os.path.abspath(port.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{port.__file__} is not under {root}")
    torch.cuda.set_device(0)
    # the substep sources (where ROOT has it, the wide-box build too) at once
    log = _build.build([name for name in _build.sources()
                        if name.startswith("substep")])["substep_kernels"]
    ptxas, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
            if "fused_substep_kernelILi" in entry:
                entry = "fused<" + entry.split("fused_substep_kernelILi")[1].split("E")[0] + ">"
            elif "world_flags_kernelILb" in entry:
                bits = entry.split("world_flags_kernelILb")[1]      # "1ELb0E..."
                entry = f"world_flags<{bits[0]},{bits[4]}>"
            elif "substep_kernelILb" in entry:
                bits = entry.split("substep_kernelILb")[1]         # "1ELb0E..." or "1EE..."
                entry = "substep<" + ",".join(
                    [bits[0]] + ([bits[4]] if bits[2:4] == "Lb" else [])) + ">"
            else:
                entry = next(k for k in ("asleep_surface_kernel", "substep_kernel")
                             if k in entry)
        elif entry and ("registers" in ln or "stack frame" in ln):
            ptxas[entry] = (ptxas.get(entry, "") + " " + ln.split(":")[-1].strip()).strip()
    lib = sk._lib()
    floats = None
    if hasattr(sk, "hull_stage_floats"):
        sys.path.insert(0, os.path.join(root, "tests"))
        import test_torch_hull_scenes as hs
        from gpu_ecs_madrona_tpu_torch.physics import assets
        from gpu_ecs_madrona_tpu_torch.utils import importer
        floats = sk.hull_stage_floats(sk.pk.ObjTables(hs.hull_object_manager(assets, importer)))
    res = {"root": root, "card": torch.cuda.get_device_name(0), "ptxas": ptxas,
           "occupancy": {"K256": occupancy(ctypes, lib, 65, 256, floats),
                         "K128": occupancy(ctypes, lib, 65, 128, floats)}}
    res["occupancy"]["substep_1024x104_K1000"] = sk.occupancy(104, 1000, single=True)
    if hasattr(sk.SubstepKernel, "step"):
        res["occupancy"]["substep_node_1024x104_K1000_J64"] = sk.occupancy(
            104, 1000, single=True, joints=64)
    ms, rates = {}, {}
    stg_case(torch, ms, rates, res)
    if stg_only:
        res.update(ms=ms, rates=rates)
        print(json.dumps(res), flush=True)
        return
    om = rb.RigidBenchWorld.objmgr

    def inputs(sim):
        return phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body, om)

    def executor(**cfg):
        return rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, **cfg), device="cuda")

    sims = {}
    for name, cfg in (("main_rigid", dict(contact_mode="pallas", max_candidates=256)),
                      ("main_rigid_k128", dict(contact_mode="pallas", max_candidates=128)),
                      ("main_rigid_fused_bp", dict(contact_mode="pallas", max_candidates=256,
                                                   broadphase_mode="fused"))):
        sim = executor(**cfg)
        sim.run(3)
        sim.block_until_ready()
        r = rate(sim)
        if name != "main_rigid_k128":
            rates[name] = r
        sims[name] = sim
    kern = sk.FusedSubstepKernel(om, 4, relaxation=0.7)
    kw256, kw128 = inputs(sims["main_rigid"]), inputs(sims["main_rigid_k128"])
    digests = res.setdefault("digests", {})

    def timed(name, fn):
        ms[name] = cuda_ms(torch, fn)
        digests[name] = digest(fn())

    timed("row7_K256", lambda: kern(**kw256))
    timed("row6_K128", lambda: kern(**kw128))
    bkern = phys.RigidBodyPhysicsSystem.fused_kernel(sims["main_rigid_fused_bp"])
    kwb = inputs(sims["main_rigid_fused_bp"])
    timed("row8_bp", lambda: bkern(**kwb))

    settled = executor(**dict(rb.SETTLED_PILE, max_candidates=256))
    settled.run(rb.SETTLE_STEPS + 3)
    rates["main_rigid_settled"] = rate(settled)
    pkern, kwp = phys.RigidBodyPhysicsSystem.fused_kernel(settled), inputs(settled)
    worlds = torch.arange(RB_WORLDS, device=kwp["pos"].device)
    flipped = dict(kwp, stable=kwp["stable"] ^ (worlds % 2 == 1),
                   active=kwp["active"] ^ (worlds % 4 >= 2))
    if hasattr(sk, "world_flags"):
        fkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(settled, rb.Body, om,
                                                                   flags=True)
        opts = dict(mcache_out=kwp["mcache"].clone(), keep_velocity=True,
                    anchors=tuple(fkw[k].clone() for k in ("apos", "arot", "valid")))

        def launch(kw):
            kw = {k: x for k, x in kw.items() if k not in ("im", "ii", "mu_s", "mu_d")}
            return lambda: (sk.world_flags(**fkw), pkern(**kw, **opts))
    else:
        def launch(kw):
            return lambda: pkern(**kw)
    timed("row9_persist_settled", launch(kwp))
    timed("row9_persist_flipped", launch(flipped))
    ms["fused_node_settled"], res["settled"] = settled_profile(torch, settled)
    del settled
    nsim = executor(**dict(rb.SETTLED_PILE, max_candidates=256, manifold_persist=False,
                           sleep_threshold=0.0))
    nsim.run(rb.SETTLE_STEPS + 3)
    rates["main_rigid_settled_nopersist"] = rate(nsim)
    nkern, kwn = phys.RigidBodyPhysicsSystem.fused_kernel(nsim), inputs(nsim)
    timed("row8_refresh_settled_nopersist", lambda: nkern(**kwn))
    del nsim

    res.update(ms=ms, rates=rates, live_slots={
        "main_rigid": {k: int(v.sum()) for k, v in kind_masks(
            torch, kw256, om["prim_type"]).items()}})
    hull_case(torch, root, ms, rates, res, timed)
    window_case(torch, root, ms, rates, res, timed)
    shapes_case(torch, root, ms, res, timed, kw256)

    if phases:
        ph = {}
        for S in (0, 1, 4):
            k = sk.FusedSubstepKernel(om, S, relaxation=0.7)
            ph[f"substeps_{S}"] = cuda_ms(torch, lambda: k(**kw256))
        ph["no_slots"] = cuda_ms(torch, lambda: kern(**dict(
            kw256, kvalid=torch.zeros_like(kw256["kvalid"]))))
        for name, mask in kind_masks(torch, kw256, om["prim_type"]).items():
            kwk = dict(kw256, kvalid=mask.contiguous())
            ph[f"only_{name}"] = cuda_ms(torch, lambda: kern(**kwk))
        b0 = sk.FusedSubstepKernel(om, 0, relaxation=0.7, bp_degree=bkern.bp_degree,
                                   bp_capacity=bkern.bp_capacity)
        ph["bp_substeps_0"] = cuda_ms(torch, lambda: b0(**kwb))
        ph["row7_K256_again"] = cuda_ms(torch, lambda: kern(**kw256))
        res["phases"] = ph
    print(json.dumps(res), flush=True)


def main(argv):
    phases, stg_only = "--phases" in argv, "--stg" in argv
    if "--one" in argv:
        one(argv[argv.index("--one") + 1], phases, stg_only)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("substep_ab: no CUDA device", file=sys.stderr)
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
                        os.path.abspath(root)] + (["--phases"] if phases else [])
                       + (["--stg"] if stg_only else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
