#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpu_ecs_madrona_tpu_torch).

Drives the port's main paths on one CUDA card — the collisions example at
8192 worlds x 100 cubes, simple_jobs at 1024 worlds x 100 objects,
fantasy_vs at 16384 worlds x 50 dragons + 200 knights and rigid_bench
(rigid-body physics) at 8192 worlds x 64 bodies — through every kernel
they run, and holds every kernel against its plain PyTorch version.
Run from the root of a checkout:

    python3 chip_smoke.py            # the smoke test
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown

Each phase prints one JSON line; the last line is
{"ok": true, "device": {...}}.  Any failed check, build or launch raises
and exits non-zero before that line.  There is no CPU fallback: without a
CUDA device, or run outside a checkout, it exits non-zero.

Phases:
  device   card name, count, nvidia-smi name and power limit
  build    nvcc of every csrc/*.cu (in parallel), ptxas register and
           shared-memory lines
  parity   collision kernels vs their plain versions at the main path's
           shapes (W=8192, n=108 rows, 100 live) and collision_pushes at
           n=1500, W=16 (many j tiles); fused_collisions_step: lo/hi atol
           1e-5, delta atol 1e-4 against the plain push on the kernel's
           own lo/hi; collision_pushes: delta atol 1e-4
  parity_simple_jobs   fused_simple_jobs_step vs its plain version: the
           main shapes (1024 x 100, K=1600, D=32, the executor's initial
           state), a dense cluster with D=4 (dropped > 0), K=128 with more
           pairs (slots cut), coincident bodies in one corner, n0=37; ab,
           counts and dropped exact, lo/hi and normals atol 1e-5,
           translation atol 1e-4, all finite
  golden   the reference binary's collisions trajectory
           (tests/goldens/job_collisions.bin, 1 world x 100 cubes, 120
           ticks) on the card, both modes: <= 1e-3 at t=3, <= 0.02 over
           the horizon
  golden_fvs   the reference binary's fantasy_vs run
           (tests/goldens/fvs_job_5d9k120t.bin, 2 worlds, 120 ticks)
           replayed in scripted mode on the card: masks and arrows exact,
           hp and mana atol 1e-3, action atol 1e-4, positions atol 1e-5,
           at least one death
  parity_substep   the fused substep kernel vs its plain version: the
           main path's shapes (8192 x 65 rows) after 3 steps at K=256 (the
           chunked TPU route) and K=128 (the unchunked one), the initial
           uniform spawn, tables without restitution, a golden scene;
           poses and stashes atol 1e-4, velocities atol 1e-3, all finite, a
           repeated launch and a repeated plain run bit-identical
  golden_physics   the reference binary's 1-substep physics goldens
           (cubes_fall, cube_pair, cube_stack, cube_bounce) and the
           free-fall check on the card, kernel and pairs modes, with
           tests/test_reference_golden.py's gates
  main_fused     collisions fused=True (kernel 1), 3 warm-up steps then
           windows of 200 steps; launches = steps, finite positions, empty
           temporary tables; env-steps/s
  main_unfused   collisions fused=False, use_kernel=True (kernel 2), 50
           steps
  main_simple_jobs   simple_jobs fused=True (kernel 4), 1024 x 100, 3
           warm-up steps then 5 windows of 200; launches = steps, finite
           positions, counters 0
  main_simple_jobs_unfused   fused=False, rank compaction, 50 steps; no
           kernel launch
  main_fantasy_vs   16384 worlds x 50 dragons + 200 knights, cleanup on, 3
           warm-up steps then 5 windows of 50; live counts never rise,
           overflow counters 0, finite positions
  main_rigid     rigid_bench defaults, 8192 x 64, K=256, the fused
           substep kernel: 3 warm-up steps then 5 windows of 50; launches =
           steps, finite positions, empty temporaries after each window;
           overflow counters, env-steps/s
  main_rigid_k128    the same at max_candidates=128
  main_rigid_pairs   contact_mode="pairs", one window of 10 steps; no
           kernel launch
  timing   CUDA-event time of each kernel wrapper (200 calls) and of its
           plain version at the main paths' shapes (kernel 3: the tiled
           case, n=1500, W=16, 128- and 1024-wide j tiles; the substep
           kernel: 20 calls at both K from the main_rigid states, with
           what its operation count is counted from: the pairs by kind,
           and the live contact points the plain version finds in each
           substep of the same call), beside the
           bound: max(bytes / 3.35 TB/s, fp32 ops / 67 TFLOP/s), the H100
           SXM peaks; no single PyTorch call computes any of these
           functions, so there is no library yardstick
"""

import json
import os
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NUM_WORLDS = 8192        # collisions
SJ_WORLDS, SJ_OBJECTS, SJ_K, SJ_D = 1024, 100, 1600, 32   # simple_jobs
FVS_WORLDS = 16384       # fantasy_vs
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
    """Device ms per call of fn.  The calls are queued behind a ~0.1 s
    device sleep, so the host has enqueued them before the first runs:
    the events time the device's work back to back, not the host's
    enqueue (which is the longer of the two for a call whose wrapper
    costs more than its kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # cycles
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
    step = max(1, (1 << 24) // (mask.shape[1] ** 2))  # bounded temporaries
    for w0 in range(0, mask.shape[0], step):
        sl = slice(w0, w0 + step)
        ok = ((lo[sl, :, None] <= hi[sl, None]) & (lo[sl, None] <= hi[sl, :, None])).all(-1)
        overlaps += float((ok & mask[sl, :, None] & mask[sl, None, :] & not_eye).sum())
    return live_pairs, overlaps


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rates(steps, windows_s, worlds=NUM_WORLDS):
    r = sorted(steps * worlds / s for s in windows_s)
    return {"median": r[len(r) // 2], "min": r[0], "max": r[-1],
            "window_s": windows_s, "steps_per_window": steps}


def windows(sim, steps, count):
    """Wall seconds of ``count`` windows of ``steps`` steps, each ended by
    a device synchronise."""
    out = []
    for _ in range(count):
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        out.append(time.perf_counter() - t0)
    return out


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


# -- the fantasy_vs golden: the binary's dump and its splitmix64 draws ------

_M64 = (1 << 64) - 1
# the constants fvs_job_5d9k120t.bin was generated with
FVS_GOLDEN_CONSTANTS = {"ARROW_DAMAGE": 350.0, "CAST_DAMAGE": 60.0, "CAST_RADIUS": 8.0,
                        "CAST_COST": 5.0}


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _fvs_key(domain, tick, idx, ch):
    return _splitmix64(((domain << 56) | (tick << 32) | (idx << 8) | ch) & _M64)


def _fvs_u01(np, domain, tick, idx, ch):
    return np.float32(_fvs_key(domain, tick, idx, ch) >> 40) / np.float32(16777216.0)


def load_fvs_golden(np):
    """(per-tick records, dragons, knights) of tests/goldens/fvs_job_5d9k120t.bin."""
    with open(os.path.join(HERE, "tests", "goldens", "fvs_job_5d9k120t.bin"), "rb") as f:
        d = f.read()
    check(d[:4] == b"FVSG", "fvs golden magic")
    tp1, nd, nk, _ = (int(v) for v in np.frombuffer(d[4:20], np.int32))
    fields = (("d_alive", nd, np.int32), ("d_hp", nd, np.float32), ("d_mp", nd, np.float32),
              ("d_act", nd, np.float32), ("d_pos", nd * 3, np.float32),
              ("k_alive", nk, np.int32), ("k_hp", nk, np.float32),
              ("k_arrows", nk, np.int32), ("k_act", nk, np.float32),
              ("k_pos", nk * 3, np.float32), ("k_target", nk, np.int32))
    off, out = 20, []
    for _ in range(tp1):
        rec = {}
        for key, n, dt in fields:
            rec[key] = np.frombuffer(d[off:off + 4 * n], dt).copy()
            off += 4 * n
        rec["d_pos"] = rec["d_pos"].reshape(nd, 3)
        rec["k_pos"] = rec["k_pos"].reshape(nk, 3)
        out.append(rec)
    check(off == len(d), "fvs golden length")
    return out, nd, nk


def fvs_golden_script(np, dump, nd, nk, lo, hi):
    """The binary's decisions (domains of fvs_main.cpp) as script tables."""
    T = len(dump) - 1
    lo, hi = np.array(lo, np.float32), np.array(hi, np.float32)
    span = hi - lo

    def posdraw(domain, tick, idx):
        return np.array([lo[c] + span[c] * _fvs_u01(np, domain, tick, idx, c)
                         for c in range(3)], np.float32)

    def act_tab(domain, n):
        tab = np.zeros((T, n, 4), np.float32)
        for t in range(T):
            for i in range(n):
                tab[t, i, 0] = _fvs_u01(np, domain, t, i, 0)
                for c in range(3):
                    tab[t, i, 1 + c] = (np.float32(2.0) * _fvs_u01(np, domain, t, i, 1 + c)
                                        - np.float32(1.0))
        return tab

    return {
        "d_pos": np.stack([posdraw(0, 0, i) for i in range(nd)]),
        "d_mana": np.array([np.float32(50.0) * _fvs_u01(np, 0, 0, i, 3) for i in range(nd)],
                           np.float32),
        "k_pos": np.stack([posdraw(1, 0, i) for i in range(nk)]),
        "k_arrows": np.array([20 + _fvs_key(1, 0, i, 3) % 21 for i in range(nk)], np.int32),
        "d_act": act_tab(2, nd), "k_act": act_tab(3, nk),
        "cast_target": np.stack([np.stack([posdraw(4, t, i) for i in range(nd)])
                                 for t in range(T)]),
        "archer_target": np.stack([dump[t + 1]["k_target"] for t in range(T)]),
    }


def golden_fvs(torch, fvs):
    """Replay fvs_job_5d9k120t.bin on the card; returns the phase's line."""
    import numpy as np
    dump, nd, nk = load_fvs_golden(np)
    saved = {k: getattr(fvs, k) for k in FVS_GOLDEN_CONSTANTS}
    for k, v in FVS_GOLDEN_CONSTANTS.items():
        setattr(fvs, k, v)
    try:
        cfg = fvs.FantasyVsConfig(num_worlds=2, num_dragons=nd, num_knights=nk, seed=0,
                                  scripted=True, replicate_clamp_bug=True)
        sim = fvs.make_executor(cfg, init_data=fvs_golden_script(
            np, dump, nd, nk, fvs.BOUNDS_LO, fvs.BOUNDS_HI), device="cuda")
        mgr = sim.mgr
        errs = {"hp": 0.0, "mp": 0.0, "act": 0.0, "pos": 0.0}
        deaths = 0
        for t in range(len(dump) - 1):
            sim.step()
            ref = dump[t + 1]
            live = {fvs.Dragon: ref["d_alive"] > 0, fvs.Knight: ref["k_alive"] > 0}
            deaths = int((~live[fvs.Dragon]).sum() + (~live[fvs.Knight]).sum())
            for arch, p in ((fvs.Dragon, "d"), (fvs.Knight, "k")):
                m = live[arch]
                got_mask = mgr.row_mask(sim.state, arch).cpu().numpy()
                check((got_mask == m[None]).all(), f"t={t} {arch.name} alive mask")

                def col(comp, field=None):
                    v = mgr.column(sim.state, arch, comp)
                    return (v if field is None else v[field]).cpu().numpy()[:, m]

                if arch is fvs.Knight:
                    check((col(fvs.Quiver, "arrows") == ref["k_arrows"][m][None]).all(),
                          f"t={t} arrows")
                else:
                    errs["mp"] = max(errs["mp"], float(np.abs(
                        col(fvs.Mana, "mp") - ref["d_mp"][m][None]).max(initial=0.0)))
                errs["hp"] = max(errs["hp"], float(np.abs(
                    col(fvs.Health, "hp") - ref[f"{p}_hp"][m][None]).max(initial=0.0)))
                errs["act"] = max(errs["act"], float(np.abs(
                    col(fvs.Action, "remaining") - ref[f"{p}_act"][m][None]).max(initial=0.0)))
                errs["pos"] = max(errs["pos"], float(np.abs(
                    col(fvs.Position) - ref[f"{p}_pos"][m][None]).max(initial=0.0)))
    finally:
        for k, v in saved.items():
            setattr(fvs, k, v)
    check(errs["hp"] <= 1e-3 and errs["mp"] <= 1e-3, f"fvs golden hp/mana {errs}")
    check(errs["act"] <= 1e-4 and errs["pos"] <= 1e-5, f"fvs golden action/pos {errs}")
    check(deaths > 0, "fvs golden: no entity died")
    return {"phase": "golden_fvs", "ticks": len(dump) - 1, "worlds": 2, "max_err": errs,
            "dead_at_end": deaths,
            "atol": {"hp": 1e-3, "mp": 1e-3, "act": 1e-4, "pos": 1e-5}}


# -- kernel 4 against its plain version --------------------------------------


def parity_simple_jobs(torch, sj, sk, dev):
    """fused_simple_jobs_step vs its plain version on the five cases; returns
    (the phase's line, the largest float error)."""
    bounds = (sj.BOUNDS_LO, sj.BOUNDS_HI)
    g = torch.Generator(device=dev).manual_seed(1)

    def bodies(W, n0, half):
        pos = (torch.rand((W, n0, 3), generator=g, device=dev) * 2.0 - 1.0) * half
        pos[..., 2] += 5.0
        q = torch.randn((W, n0, 4), generator=g, device=dev)
        return pos, q / q.norm(dim=-1, keepdim=True)

    init = sj.make_executor(sj.SimpleJobsConfig(num_worlds=SJ_WORLDS, num_objects=SJ_OBJECTS,
                                                max_pairs=SJ_K, degree_cap=SJ_D, fused=True),
                            device="cuda").state["user"]
    corner = torch.tensor([[[-99.0, -99.0, -5.0], [-88.0, -77.0, -9.0], [-9.5, -9.5, 0.5]]],
                          device=dev).expand(4, 3, 3).contiguous()
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(4, 3, 4).contiguous()
    cases = {
        "main": (init["translation"], init["rotation"], SJ_K, SJ_D),
        "degree_cap": (*bodies(64, 100, 2.5), 1600, 4),
        "k_truncation": (*bodies(64, 100, 4.0), 128, 32),
        "coincident_corner": (corner, ident, 64, 8),
        "n0_37": (*bodies(64, 37, 4.0), 256, 8),
    }
    out, worst = {}, 0.0
    names = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
    atol = {"translation": 1e-4, "lo": 1e-5, "hi": 1e-5, "normals": 1e-5}
    for case, (pos, rot, K, D) in cases.items():
        kw = dict(n0=pos.shape[1], K=K, degree_cap=D, bounds=bounds)
        got = sk.fused_simple_jobs_step(pos, rot, **kw)
        want = sk.fused_simple_jobs_step_plain(pos, rot, **kw)
        torch.cuda.synchronize()
        res = {"W": pos.shape[0], "n0": pos.shape[1], "K": K, "D": D,
               "pairs_kept": int(torch.clamp(want[5], max=K).sum()),
               "counts_over_K": int((want[5] > K).sum()), "dropped": int(want[6].sum())}
        for name, a, b in zip(names, got, want):
            if name in atol:
                e = max_err(a, b)
                res[name] = e
                worst = max(worst, e)
                check(e <= atol[name], f"simple_jobs {case} {name} err {e}")
                check(bool(torch.isfinite(a).all()), f"simple_jobs {case} {name} finite")
            else:
                check(bool(torch.equal(a, b)), f"simple_jobs {case} {name} not exact")
        out[case] = res
    check(out["degree_cap"]["dropped"] > 0, "degree-cap case dropped no pair")
    check(out["k_truncation"]["counts_over_K"] > 0, "K-truncation case cut no slot")
    check(out["coincident_corner"]["pairs_kept"] > 0, "coincident case kept no pair")
    return {"phase": "parity_simple_jobs", "cases": out, "ints": "exact", "atol": atol}, worst


# -- rigid-body physics: the fused substep kernel ------------------------------

RB_WORLDS, RB_BODIES = 8192, 64      # rigid_bench defaults
# fp32 operations of the fused substep kernel (each add, sub, mul, div,
# sqrt, min, max and abs; compares and selects not counted), counted from
# csrc/substep_kernels.cu.  The data decides how many of each the call
# needs, so substep_work counts them from the plain version's contacts in
# every substep of the timed call:
#   - each valid candidate slot, its contact test by kind (the box-box SAT
#     over 15 axes; a box against the plane tests its 8 corners);
#   - each touching box pair, the incident-face clip when it keeps two or
#     more live points, else the cheaper edge-edge point;
#   - each pair with a live point (ok and depth > 0), the passes' per-pair
#     work (two world inertia tensors a pass, the drift and friction
#     direction, the velocity deltas), and 15 sums a dynamic side; a pair
#     without a live point needs no pass work;
#   - each live point, both passes' work at it (36 more for the
#     restitution channels when some material bounces);
#   - each pair (i <= j) of a pair's live points, one entry of the velocity
#     pass's system and its share of the closed-form solve;
#   - each dynamic body, the integrate, pose update and velocity recovery.
OPS_TEST = {"box-box": 420, "box-plane": 360, "sphere-box": 100, "sphere-plane": 50,
            "sphere-sphere": 25, "other": 0}
OPS_CLIP_FACE, OPS_CLIP_EDGE = 760, 220
OPS_PAIR, OPS_SIDE_SUM = 385, 15
OPS_POINT, OPS_POINT_BOUNCE = 450, 36
OPS_POINT_PAIR = 24
OPS_BODY = 300
# bytes a call moves: per body row 105 in (pose, velocity, mass, inertia,
# friction, object id, external force and torque, dyn flag) and 132 out
# (pose, velocity and the six stashes); per candidate slot 9 (rows, flag);
# per world 20 (h, gravity, restitution threshold)
BYTES_BODY, BYTES_SLOT, BYTES_WORLD = 237, 9, 20
SUBSTEP_POSE_KEYS = ("pos", "rot", "prev_pos", "prev_rot", "ps_pos", "ps_rot")


def fused_inputs(sim, rb, phys):
    """The fused substep kernel's inputs for a rigid_bench executor's next step."""
    return phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body,
                                                               rb.RigidBenchWorld.objmgr)


def kind_masks(torch, kw, tables):
    """Valid candidate slots [W, K] by contact kind (the kernel's branch)."""
    prim = torch.as_tensor(tables.om["prim_type"], device=kw["obj"].device)
    ri, rj, valid = kw["rows_i"].long(), kw["rows_j"].long(), kw["kvalid"]
    pa = prim[torch.gather(kw["obj"], 1, ri).long()]
    pb = prim[torch.gather(kw["obj"], 1, rj).long()]
    lo, hi = torch.minimum(pa, pb), torch.maximum(pa, pb)   # 0 sphere, 1 hull, 2 plane
    kinds = {"sphere-sphere": (lo == 0) & (hi == 0), "sphere-box": (lo == 0) & (hi == 1),
             "sphere-plane": (lo == 0) & (hi == 2), "box-box": (lo == 1) & (hi == 1),
             "box-plane": (lo == 1) & (hi == 2)}
    kinds = {k: v & valid for k, v in kinds.items()}
    kinds["other"] = valid & ~torch.stack(list(kinds.values())).any(0)
    return kinds


def pair_kinds(torch, kw, tables):
    """Valid candidate pairs by contact kind."""
    return {k: int(v.sum()) for k, v in kind_masks(torch, kw, tables).items()}


def substep_work(torch, sk, kern, kw):
    """The fp32 operations this call's data needs of the kernel, and what
    they were counted from: the candidates by kind, and summed over the
    substeps of a plain-version run on the same inputs, the pairs with a
    live point, their dynamic sides and live points, the pairs of live
    points within a pair, and the touching box pairs by clip path."""
    kinds = kind_masks(torch, kw, kern.tables)
    ri, rj = kw["rows_i"].long(), kw["rows_j"].long()
    dyn_sides = torch.gather(kw["dyn"], 1, ri).int() + torch.gather(kw["dyn"], 1, rj).int()
    n = dict.fromkeys(("pairs", "dyn_sides", "points", "point_pairs", "face_clips",
                       "edge_points"), 0)

    def observe(c):
        live = c["ok"][:, None, :] & (c["depth"] > 0) & kw["kvalid"][:, None, :]
        pts = live.sum(1)                                           # [W, K]
        touching = pts > 0
        boxes = kinds["box-box"] & c["ok"]
        n["pairs"] += int(touching.sum())
        n["dyn_sides"] += int(dyn_sides[touching].sum())
        n["points"] += int(pts.sum())
        n["point_pairs"] += int((pts * (pts + 1) // 2).sum())
        n["face_clips"] += int((boxes & (pts >= 2)).sum())
        n["edge_points"] += int((boxes & (pts < 2)).sum())

    sk.fused_substep_plain(**kw, tables=kern.tables, num_substeps=kern.num_substeps,
                           relaxation=kern.relaxation, speculative=kern.speculative,
                           observe=observe)
    counts = {k: int(v.sum()) for k, v in kinds.items()}
    S = kern.num_substeps
    per_point = OPS_POINT + (OPS_POINT_BOUNCE if kern.tables.any_restitution else 0)
    ops = (S * sum(c * OPS_TEST[k] for k, c in counts.items())
           + n["face_clips"] * OPS_CLIP_FACE + n["edge_points"] * OPS_CLIP_EDGE
           + n["pairs"] * OPS_PAIR + n["dyn_sides"] * OPS_SIDE_SUM
           + n["points"] * per_point + n["point_pairs"] * OPS_POINT_PAIR
           + S * int(kw["dyn"].sum()) * OPS_BODY)
    return ops, counts, n


def substep_bound(kw, ops):
    W, n = kw["im"].shape
    K = kw["rows_i"].shape[1]
    return bound(W * (n * BYTES_BODY + K * BYTES_SLOT + BYTES_WORLD), ops)


def substep_case(torch, sk, kern, kw):
    """Kernel (twice) vs plain (twice) on one input: max errors, or raises."""
    got, again = kern(**kw), kern(**kw)
    want, want2 = (sk.fused_substep_plain(**kw, tables=kern.tables,
                                          num_substeps=kern.num_substeps,
                                          relaxation=kern.relaxation,
                                          speculative=kern.speculative) for _ in range(2))
    torch.cuda.synchronize()
    errs = {}
    for k in sk.OUT_KEYS:
        check(bool(torch.isfinite(got[k]).all()), f"substep {k} finite")
        check(torch.equal(got[k], again[k]), f"substep {k}: a repeated launch differs")
        check(torch.equal(want[k], want2[k]), f"substep {k}: the plain version does not repeat")
        errs[k] = max_err(got[k], want[k])
        check(errs[k] <= (1e-4 if k in SUBSTEP_POSE_KEYS else 1e-3), f"substep {k} err {errs[k]}")
    return errs


def parity_substep(torch, rb, phys, sk):
    """fused_substep vs its plain version: the main path's shapes after 3
    steps at K = 256 and 128, the initial uniform spawn, tables without
    restitution, a golden scene.  Returns (the phase's line, worst error)."""
    import numpy as np
    cases, worst = {}, 0.0
    for K in (256, 128):
        sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, contact_mode="pallas",
                                                   max_candidates=K), device="cuda")
        if K == 256:
            spawn = fused_inputs(sim, rb, phys)
        sim.run(3)
        kw = fused_inputs(sim, rb, phys)
        kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
        errs = substep_case(torch, sk, kern, kw)
        cases[f"main_K{K}"] = {"W": RB_WORLDS, "n": RB_BODIES + 1, "K": K,
                               "pairs": pair_kinds(torch, kw, kern.tables), "max_err": errs}
        del sim
    kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
    cases["initial_spawn"] = {"pairs": pair_kinds(torch, spawn, kern.tables),
                              "max_err": substep_case(torch, sk, kern, spawn)}
    om = dict(rb.RigidBenchWorld.objmgr)
    om["restitution"] = np.zeros_like(om["restitution"])
    quiet = sk.FusedSubstepKernel(om, 4, relaxation=0.7)
    check(not quiet.tables.any_restitution, "zero-restitution tables")
    cases["no_restitution"] = {"max_err": substep_case(torch, sk, quiet, kw)}
    gold = golden_sim(torch, phys, "cube_stack_ss1", "pallas")[0]
    gkw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(gold, gold.world_cls.Body,
                                                              gold.world_cls.objmgr)
    gkern = sk.FusedSubstepKernel(gold.world_cls.objmgr, 1)
    cases["golden_cube_stack_ss1"] = {"pairs": int(gkw["kvalid"].sum()),
                                      "max_err": substep_case(torch, sk, gkern, gkw)}
    for c in cases.values():
        worst = max(worst, max(c["max_err"].values()))
    return {"phase": "parity_substep", "cases": cases, "repeat": "bit-identical (kernel and plain)",
            "atol": {"pose_and_stashes": 1e-4, "velocities": 1e-3}}, worst


def load_physics_golden(np, name):
    with open(os.path.join(HERE, "tests", "goldens", name + ".bin"), "rb") as f:
        d = f.read()
    check(d[:4] == b"GLD1", "physics golden magic")
    T1, W, K, ss = struct.unpack("<4i", d[4:20])
    dt = struct.unpack("<f", d[20:24])[0]
    return np.frombuffer(d[24:], np.float32).reshape(T1, W, K, 13).copy(), W, K, ss, dt


def golden_sim(torch, phys, name, mode):
    """The golden's scene (plane row 0, its cubes after) on the card, from
    its tick 0; returns (executor, golden, K)."""
    import numpy as np
    from gpu_ecs_madrona_tpu_torch.core import base
    from gpu_ecs_madrona_tpu_torch.core.component import Archetype
    from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
    from gpu_ecs_madrona_tpu_torch.physics import components as pc
    golden, W, K, ss, dt = load_physics_golden(np, name)
    loader = phys.assets.PhysicsLoader()
    loader.load_objects([phys.assets.make_plane(mu_s=0.5, mu_d=0.5),
                         phys.assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.5,
                                              mu_d=0.5)])
    mgr = loader.get_object_manager()
    init0 = golden[0]

    class World:
        Body = Archetype("GoldenBody", phys.BODY_COMPONENTS)
        objmgr = mgr

        @classmethod
        def register_types(cls, r):
            phys.RigidBodyPhysicsSystem.register_types(r, max_candidates=64, max_contacts=64,
                                                       max_joints=0)
            r.register_archetype(cls.Body, capacity=K + 1)
            r.export_column(cls.Body, base.Position, 0)
            r.export_column(cls.Body, base.Rotation, 1)
            r.export_column(cls.Body, pc.Velocity, 2)

        @classmethod
        def init(cls, ctx, init_data=None):
            dev = ctx.device
            phys.RigidBodyPhysicsSystem.init(ctx, delta_t=dt, num_substeps=ss)
            pos = np.zeros((W, K + 1, 3), np.float32)
            rot = np.zeros((W, K + 1, 4), np.float32)
            rot[..., 0] = 1.0
            vel = np.zeros((W, K + 1, 3), np.float32)
            omega = np.zeros((W, K + 1, 3), np.float32)
            pos[:, 1:], rot[:, 1:] = init0[..., 0:3], init0[..., 3:7]
            vel[:, 1:], omega[:, 1:] = init0[..., 7:10], init0[..., 10:13]
            oid = np.ones((W, K + 1), np.int32)
            oid[:, 0] = 0
            resp = np.full((W, K + 1), pc.RESPONSE_DYNAMIC, np.int32)
            resp[:, 0] = pc.RESPONSE_STATIC

            def t(a):
                return torch.from_numpy(a).to(dev)
            ctx.make_entities(cls.Body, counts=K + 1, max_new=K + 1, values={
                base.Position: t(pos), base.Rotation: t(rot),
                base.Scale: torch.ones((W, K + 1, 3), device=dev), base.ObjectID: t(oid),
                pc.Velocity: {"linear": t(vel), "angular": t(omega)},
                pc.ResponseType: t(resp)})

        @classmethod
        def setup_tasks(cls, builder):
            bp = phys.RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], cls.Body, mgr)
            sub = phys.RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], ss, cls.Body,
                                                                  mgr, contact_mode=mode)
            phys.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [sub])

    sim = TaskGraphExecutor(World, ExecutorConfig(num_worlds=W, max_entities_per_world=K + 8,
                                                  seed=0, device="cuda"))
    return sim, golden, K


def golden_physics(torch, phys, sk):
    """The four 1-substep physics goldens and the free-fall check on the
    card, both contact modes, with tests/test_reference_golden.py's gates."""
    import numpy as np
    out = {}
    for mode in ("pallas", "pairs"):
        for name in ("cubes_fall_ss1", "cube_pair_ss1", "cube_stack_ss1", "cube_bounce_ss1"):
            sk.FusedSubstepKernel.launches = 0
            sim, golden, K = golden_sim(torch, phys, name, mode)
            T = golden.shape[0] - 1
            mine = np.zeros_like(golden)
            mine[0] = golden[0]
            for t in range(1, T + 1):
                sim.step()
                vel = sim.get_exported(2)[0]
                mine[t] = np.concatenate([sim.get_exported(0)[0][:, 1:].cpu().numpy(),
                                          sim.get_exported(1)[0][:, 1:].cpu().numpy(),
                                          vel["linear"][:, 1:].cpu().numpy(),
                                          vel["angular"][:, 1:].cpu().numpy()], axis=-1)
            check(sk.FusedSubstepKernel.launches == (T if mode == "pallas" else 0),
                  f"golden {name} {mode} launches {sk.FusedSubstepKernel.launches}")
            perr = np.abs(mine[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
            zmin = golden[..., 2].min(axis=(1, 2))
            fc = int(np.argmax(zmin < 0.52)) if (zmin < 0.52).any() else T + 1
            res = {"ticks": T, "free_flight": float(perr[:fc].max()) if fc > 1 else None,
                   "early_contact": float(perr[:min(fc + 10, T)].max()),
                   "horizon": float(perr.max())}
            check(fc <= 1 or res["free_flight"] <= 1e-5, f"golden {name} {mode} free flight")
            check(res["early_contact"] <= 0.06, f"golden {name} {mode} early contact")
            check(res["horizon"] <= (2.5 if name.startswith("cube_stack") else 1.2),
                  f"golden {name} {mode} horizon")
            check(bool(np.isfinite(mine).all()), f"golden {name} {mode} finite")
            if name.startswith("cube_bounce"):
                res["bounce_peak"] = float(np.abs(golden[fc:, ..., 2].max(axis=0)
                                                  - mine[fc:, ..., 2].max(axis=0)).max())
                check(res["bounce_peak"] <= 0.08, f"golden {name} {mode} bounce peak")
            if name.startswith("cubes_fall"):
                m_final, g_final = mine[-1, ..., 2], golden[-1, ..., 2]
                check(bool((m_final > 0.3).all() and (m_final < 4.0).all()),
                      f"golden {name} {mode} rest")
                res["rest"] = float(np.abs(np.sort(m_final, axis=None)
                                           - np.sort(g_final, axis=None)).max())
                check(res["rest"] <= 0.6, f"golden {name} {mode} rest state")
                res["free_fall_all_channels"] = float(np.abs(mine[:fc - 1]
                                                             - golden[:fc - 1]).max())
                check(fc >= 15 and res["free_fall_all_channels"] <= 1e-5,
                      f"golden free fall {mode}")
            out[f"{name}_{mode}"] = res
    return {"phase": "golden_physics", "cases": out,
            "gates": {"free_flight": 1e-5, "early_contact": 0.06, "horizon": "1.2 (stack 2.5)",
                      "bounce_peak": 0.08, "rest": 0.6}}


def main_rigid(torch, rb, phys, mode, K, steps, count, card, reset_counts, read_counts):
    """rigid_bench defaults at 8192 x 64 through ``mode`` at capacity K:
    3 warm-up steps, then ``count`` windows of ``steps`` steps; launches =
    steps (kernel mode) or 0, no other kernel launched, finite positions,
    empty temporaries."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=RB_WORLDS, contact_mode=mode,
                                               max_candidates=K), device="cuda")
    sim.run(3)
    sim.block_until_ready()
    reset_counts()
    wins = []
    for _ in range(count):
        wins += windows(sim, steps, 1)
        for arch in (phys.CandidateTemporary, phys.CandidateRowsTemporary,
                     phys.ContactTemporary, phys.CollisionEventTemporary):
            check(int(sim.mgr.num_rows(sim.state, arch).sum()) == 0,
                  f"{arch.name} not empty after a step")
    launches = read_counts()
    want = {name: 0 for name in launches}
    want["fused_substep"] = steps * count if mode == "pallas" else 0
    check(launches == want, f"rigid_bench {mode} K={K} launches {launches}")
    pos, mask = sim.get_exported(0)
    check(bool(torch.isfinite(pos[mask]).all()), f"finite positions (rigid_bench {mode})")
    overflow = {k: int(v.sum()) for k, v in sim.overflow_counters().items()}
    return sim, {"worlds": RB_WORLDS, "bodies": RB_BODIES, "contact_mode": mode,
                 "max_candidates": K, "launches": launches,
                 "overflow_sum": overflow,
                 "env_steps_per_s": rates(steps, wins, RB_WORLDS), "card": card}


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
    from gpu_ecs_madrona_tpu_torch import physics as phys
    from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
    from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
    from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
    from gpu_ecs_madrona_tpu_torch.ops import _build
    from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck
    from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk
    from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
    from gpu_ecs_madrona_tpu_torch.utils import math as m

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    wrappers = {"fused_collisions_step": ck.fused_collisions_step,
                "collision_pushes": ck.collision_pushes,
                "fused_simple_jobs_step": sk.fused_simple_jobs_step,
                "fused_substep": subk.FusedSubstepKernel}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    # device ----------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # build -----------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if any(k in ln for k in ("Compiling entry", "registers", "spill"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "dir": os.path.relpath(_build.BUILD_DIR, HERE),
          "ptxas": ptxas})

    # collision kernels vs plain at the main path's shapes --------------------
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

    # kernel 4 vs plain ---------------------------------------------------------
    line, err_sj = parity_simple_jobs(torch, sj, sk, dev)
    emit(line)

    # the reference binary's goldens, on the card ------------------------------
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
    emit(golden_fvs(torch, fvs))

    # the fused substep kernel vs plain, and the physics goldens on the card
    line, err_substep = parity_substep(torch, rb, phys, subk)
    emit(line)
    emit(golden_physics(torch, phys, subk))

    # collisions, fused=True (kernel 1) ----------------------------------------
    sim.run(3)
    sim.block_until_ready()
    reset_counts()
    fused_windows = windows(sim, 200, 5)
    fused_launches = read_counts()
    check(fused_launches == {"fused_collisions_step": 1000, "collision_pushes": 0,
                             "fused_simple_jobs_step": 0, "fused_substep": 0},
          f"fused main path launches {fused_launches}")
    fpos, fmask = sim.get_exported(0)
    check(bool(torch.isfinite(fpos[fmask]).all()), "finite positions (fused)")
    for arch in (col.CollisionCandidate, col.Contact):
        check(int(sim.mgr.num_rows(sim.state, arch).sum()) == 0, f"{arch.name} empty")
    emit({"phase": "main_fused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": fused_launches, "env_steps_per_s": rates(200, fused_windows),
          "card": smi})

    # collisions, fused=False with the collision_pushes kernel (kernel 2) -------
    usim = col.make_executor(col.CollisionsConfig(num_worlds=NUM_WORLDS, fused=False,
                                                  use_kernel=True), device="cuda")
    usim.run(3)
    usim.block_until_ready()
    reset_counts()
    uwindows = windows(usim, 50, 1)
    unfused_launches = read_counts()
    check(unfused_launches == {"fused_collisions_step": 0, "collision_pushes": 50,
                               "fused_simple_jobs_step": 0, "fused_substep": 0},
          f"unfused main path launches {unfused_launches}")
    upos, umask = usim.get_exported(0)
    check(bool(torch.isfinite(upos[umask]).all()), "finite positions (unfused)")
    overflow = usim.overflow_counters()
    check(all(v.dtype == torch.int32 and int(v.min()) >= 0 for v in overflow.values()),
          "overflow counters int32 >= 0")
    emit({"phase": "main_unfused", "worlds": NUM_WORLDS, "objects": 100,
          "launches": unfused_launches, "env_steps_per_s": rates(50, uwindows),
          "overflow_max": {k: int(v.max()) for k, v in overflow.items()}, "card": smi})

    # simple_jobs, fused=True (kernel 4) ----------------------------------------
    sj_cfg = dict(num_worlds=SJ_WORLDS, num_objects=SJ_OBJECTS, max_pairs=SJ_K,
                  degree_cap=SJ_D)
    sjsim = sj.make_executor(sj.SimpleJobsConfig(fused=True, **sj_cfg), device="cuda")
    check(sjsim.graph.node_names == ["fused_step"], "simple_jobs fused graph")
    sjsim.run(3)
    sjsim.block_until_ready()
    reset_counts()
    sj_windows = windows(sjsim, 200, 5)
    sj_launches = read_counts()
    check(sj_launches == {"fused_collisions_step": 0, "collision_pushes": 0,
                          "fused_simple_jobs_step": 1000, "fused_substep": 0},
          f"simple_jobs main path launches {sj_launches}")
    user = sjsim.state["user"]
    check(bool(torch.isfinite(user["translation"]).all()), "finite positions (simple_jobs)")
    check(int(user["num_candidates"].abs().sum()) == 0
          and int(user["num_contacts"].abs().sum()) == 0, "simple_jobs counters reset")
    emit({"phase": "main_simple_jobs", "worlds": SJ_WORLDS, "objects": SJ_OBJECTS,
          "max_pairs": SJ_K, "degree_cap": SJ_D, "launches": sj_launches,
          "pairs_in_buffers": int((user["contacts_ab"] != 0).any(-1).sum()),
          "env_steps_per_s": rates(200, sj_windows, SJ_WORLDS), "card": smi})

    # simple_jobs, fused=False, rank compaction ---------------------------------
    os.environ["GEM_SJ_COMPACT"] = "rank"
    sjusim = sj.make_executor(sj.SimpleJobsConfig(fused=False, **sj_cfg), device="cuda")
    sjusim.run(3)
    sjusim.block_until_ready()
    reset_counts()
    sju_windows = windows(sjusim, 50, 1)
    sju_launches = read_counts()
    check(all(v == 0 for v in sju_launches.values()),
          f"simple_jobs unfused launches {sju_launches}")
    check(bool(torch.isfinite(sjusim.state["user"]["translation"]).all()),
          "finite positions (simple_jobs unfused)")
    emit({"phase": "main_simple_jobs_unfused", "worlds": SJ_WORLDS, "objects": SJ_OBJECTS,
          "compaction": "rank", "launches": sju_launches,
          "env_steps_per_s": rates(50, sju_windows, SJ_WORLDS), "card": smi})

    # fantasy_vs, 16384 worlds, cleanup on --------------------------------------
    fcfg = fvs.FantasyVsConfig(num_worlds=FVS_WORLDS, num_dragons=50, num_knights=200,
                               cleanup=True)
    fsim = fvs.make_executor(fcfg, device="cuda")
    fsim.run(3)
    fsim.block_until_ready()

    def live_counts():
        return [fsim.mgr.num_rows(fsim.state, a).clone() for a in (fvs.Dragon, fvs.Knight)]

    before = live_counts()
    first = before
    reset_counts()
    fvs_windows = []
    for _ in range(5):
        fvs_windows += windows(fsim, 50, 1)
        now = live_counts()
        check(all(bool((n <= p).all()) for n, p in zip(now, before)),
              "fantasy_vs live counts rose")
        before = now
    fvs_launches = read_counts()
    check(all(v == 0 for v in fvs_launches.values()), f"fantasy_vs launches {fvs_launches}")
    check(all(int(v.abs().sum()) == 0 for v in fsim.overflow_counters().values()),
          "fantasy_vs overflow counters")
    for arch in (fvs.Dragon, fvs.Knight):
        p = fsim.mgr.column(fsim.state, arch, fvs.Position)
        check(bool(torch.isfinite(p[fsim.mgr.row_mask(fsim.state, arch)]).all()),
              f"finite {arch.name} positions")
    emit({"phase": "main_fantasy_vs", "worlds": FVS_WORLDS, "dragons": 50, "knights": 200,
          "cleanup": True, "launches": fvs_launches,
          "destroyed_in_windows": {"Dragon": int((first[0] - before[0]).sum()),
                                   "Knight": int((first[1] - before[1]).sum())},
          "env_steps_per_s": rates(50, fvs_windows, FVS_WORLDS), "card": smi})

    # rigid_bench, 8192 x 64: the fused substep kernel at K = 256 and 128, and
    # the pairs path -------------------------------------------------------------
    counts = (reset_counts, read_counts)
    rsim, line = main_rigid(torch, rb, phys, "pallas", 256, 50, 5, smi, *counts)
    rig_launches = line["launches"]["fused_substep"]
    emit({"phase": "main_rigid", **line})
    r128, line = main_rigid(torch, rb, phys, "pallas", 128, 50, 5, smi, *counts)
    emit({"phase": "main_rigid_k128", **line})
    rpairs, line = main_rigid(torch, rb, phys, "pairs", 256, 10, 1, smi, *counts)
    emit({"phase": "main_rigid_pairs", **line})

    # kernel times at the main paths' shapes ------------------------------------
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

    # kernel 3: the tiled case, the parity phase's n=1500 data
    t_lo, t_hi = p1500 - 1.0, p1500 + 1.0
    tiled = {}
    for tile in (0, 1024):
        tiled[tile or 128] = cuda_ms(
            torch, lambda: ck.collision_pushes(p1500, t_lo, t_hi, m1500, force_tile=tile), 200)
    t_plain = cuda_ms(torch, lambda: ck.collision_pushes_plain(p1500, t_lo, t_hi, m1500), 10)
    tlive, tover = pair_counts(torch, t_lo, t_hi, m1500)
    tW, tn = m1500.shape
    t_bound, t_by = bound(tW * tn * (36 + 1 + 12), tW * tn * 9 + tlive * 6 + tover * 16)

    # kernel 4 at the simple_jobs main path's shapes and state
    spos, srot = user["translation"], user["rotation"]
    skw = dict(n0=SJ_OBJECTS, K=SJ_K, degree_cap=SJ_D, bounds=(sj.BOUNDS_LO, sj.BOUNDS_HI))
    s_ms = cuda_ms(torch, lambda: sk.fused_simple_jobs_step(spos, srot, **skw), 200)
    s_plain = cuda_ms(torch, lambda: sk.fused_simple_jobs_step_plain(spos, srot, **skw), 10)
    _, slo, shi, _, _, _, _ = sk.fused_simple_jobs_step(spos, srot, **skw)
    smask = torch.ones(spos.shape[:2], dtype=torch.bool, device=dev)
    slive, sover = pair_counts(torch, slo, shi, smask)
    sW, sn = smask.shape
    s_bound, s_by = bound(sW * (sn * 28 + sn * 36 + SJ_K * 20 + 8),
                          sW * sn * 40 + slive * 6 + sover * 20)

    # the fused substep kernel at both capacities, from the main_rigid states
    sub_t = {}
    for K, s_ in ((256, rsim), (128, r128)):
        kw = fused_inputs(s_, rb, phys)
        kern = subk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 4, relaxation=0.7)
        ops, kinds, work = substep_work(torch, subk, kern, kw)
        b_ms, b_by = substep_bound(kw, ops)
        rows = kw["kvalid"].sum(1)
        bodies = kw["dyn"].sum(1).double() + 1.0       # the pile and its plane
        sub_t[K] = {"ms": cuda_ms(torch, lambda: kern(**kw), 20),
                    "plain_ms": cuda_ms(torch, lambda: subk.fused_substep_plain(
                        **kw, tables=kern.tables, num_substeps=4, relaxation=0.7), 3, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
                    "live_pairs": float((bodies * (bodies - 1) / 2).sum()),
                    "overlapping_pairs": sum(kinds.values()), "pairs_by_kind": kinds,
                    "work_over_substeps": work,
                    "pairs_per_world_max": int(rows.max())}

    emit({"phase": "timing", "fused_collisions_step": {
              "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
              "live_pairs": live, "overlapping_pairs": over},
          "collision_pushes": {
              "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
              "live_pairs": ulive, "overlapping_pairs": uover},
          "collision_pushes_tiled_n1500_w16": {
              "ms_by_tile_j": tiled, "plain_ms": t_plain, "bound_ms": t_bound,
              "bound_by": t_by, "live_pairs": tlive, "overlapping_pairs": tover},
          "fused_simple_jobs_step": {
              "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
              "live_pairs": slive, "overlapping_pairs": sover},
          "fused_substep_K256": sub_t[256], "fused_substep_K128": sub_t[128],
          "library_ms": "none: no single PyTorch call computes any of these functions",
          "card": smi})

    if "--profile" in argv:
        profile(torch, {"fused": sim, "unfused_pushes": usim, "simple_jobs_fused": sjsim,
                        "rigid_fused_k256": rsim, "rigid_fused_k128": r128,
                        "rigid_pairs": rpairs,
                        "simple_jobs_rank": sjusim, "fantasy_vs": fsim})

    csrc = "gpu_ecs_madrona_tpu_torch/csrc/"
    emit({"kernels": [
        {"name": "fused_collisions_step", "route": "cuda",
         "source": csrc + "collision_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:330",
         "launches": fused_launches["fused_collisions_step"], "launches_per_step": 1,
         "max_abs_err": max(err_fused.values()), "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": None},
        {"name": "collision_pushes", "route": "cuda", "source": csrc + "collision_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/collision_kernel.py:212 (tiled :195)",
         "launches": unfused_launches["collision_pushes"], "launches_per_step": 1,
         "max_abs_err": max(err_p108, err_p1500), "ms": p_ms, "plain_ms": p_plain,
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": None},
        {"name": "fused_simple_jobs_step", "route": "cuda",
         "source": csrc + "simple_jobs_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/simple_jobs_kernel.py:276",
         "launches": sj_launches["fused_simple_jobs_step"], "launches_per_step": 1,
         "max_abs_err": err_sj, "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": s_by, "library_ms": None},
        {"name": "fused_substep", "route": "cuda", "source": csrc + "substep_kernels.cu",
         "replaces": "gpu_ecs_madrona_tpu/ops/substep_kernel.py:1257 (chunked :1241)",
         "launches": rig_launches, "launches_per_step": 1, "max_abs_err": err_substep,
         "ms": sub_t[256]["ms"], "plain_ms": sub_t[256]["plain_ms"],
         "bound_ms": sub_t[256]["bound_ms"], "bound_by": sub_t[256]["bound_by"],
         "library_ms": None,
         "K128": {k: sub_t[128][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile(torch, sims):
    """torch.profiler over 20 steps of each main path: device time by
    kernel, and the device's busy share of the profiled wall time (which
    includes the profiler's own host overhead)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for name, s in sims.items():
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
