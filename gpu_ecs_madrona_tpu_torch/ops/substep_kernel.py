"""The physics substep kernels: wrappers, plain versions, launch counters,
and the ``FusedSubstepKernel`` and ``SubstepKernel`` drivers.

Counterpart of ``gpu_ecs_madrona_tpu/ops/substep_kernel.py``'s
``FusedSubstepKernel`` (``_run_fused`` without in-kernel broadphase,
contact refresh, sleep or persistent manifolds).  ``fused_substep`` runs,
per world and for each of ``num_substeps`` substeps (the JAX kernel loop,
``_make_fused_kernel``):

  1. semi-implicit Euler integrate with the gyroscopic term (``_integrate``);
  2. a per-pair gather of pose and prev_pos at the candidate rows;
  3. ``pairs.pair_contacts``;
  4. ``pairs.positional_pass``;
  5. a segment sum to bodies;
  6. ``_apply_positional_recover`` (pose update, velocity recovery with the
     sign-selected angular term);
  7. a re-gather at the post-solve poses;
  8. ``pairs.velocity_pass`` (restitution channels only when some material
     bounces);
  9. a segment sum; non-dynamic rows keep their pose and get zero v/w.

The static pair data (inverse mass and inertia, friction, object id) is
gathered once per step; the outputs carry the last substep's stashes.

``substep`` is the counterpart of ``SubstepKernel`` (``_run``, one
substep per call), which worlds with joints take: steps 2-9 once, from
the post-integrate pose and velocities its caller passes (the caller
integrates before the call and solves the joints after it).  Both
versions share steps 2-9 with the fused ones (``_solve_substep`` here,
``solve_substep`` in the .cu).

On CUDA tensors ``fused_substep`` and ``substep`` launch the hand-written
kernels in ``csrc/substep_kernels.cu`` (one CTA per world; its notes say
what bounds them and how they are laid out) or raise; on CPU tensors they
run ``fused_substep_plain`` and ``substep_plain``, the same loop in
batched PyTorch over [W, K] pair tensors.  Launches are counted in
``FusedSubstepKernel.launches`` and ``SubstepKernel.launches``.  The
segment sums add each body's A-side contributions in ascending slot order,
then its B-side ones, in both versions (a stable sort and
``segment_reduce`` in the plain version, a loop over the slots in the
kernel), so both repeat bit for bit from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_ecs_madrona_tpu_torch.ops import _build
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk

# The kernel's bounds: one CTA per world, whose bodies, per-slot stash and
# slot lists sit in shared memory (see csrc/substep_kernels.cu), at most
# 227 KB a block on an H100.
MAX_SMEM_BYTES = 227 * 1024
MAX_TABLE_VERTS = 8


def smem_bytes(n: int, K: int) -> int:
    """The kernel's shared memory for n bodies and K slots: its dynamic
    part (smem_bytes in the .cu: 54 floats a body, 24 + 18 a slot, 5 ints
    a slot and n + 1 offsets) and its one static int."""
    return 4 * (54 * n + 42 * K) + 4 * (5 * K + n + 1) + 4

OUT_KEYS = ("pos", "rot", "v", "w", "prev_pos", "prev_rot",
            "ps_pos", "ps_rot", "ps_v", "ps_w")
_WIDTH = {"pos": 3, "rot": 4, "v": 3, "w": 3, "prev_pos": 3, "prev_rot": 4,
          "ps_pos": 3, "ps_rot": 4, "ps_v": 3, "ps_w": 3}
SUBSTEP_KEYS = ("pos", "rot", "v", "w")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _comps(x):
    return tuple(x[..., c] for c in range(x.shape[-1]))


def _integrate(pos, rot, v, w, im, ii, extf, extt, dyn, h1, g):
    """Semi-implicit Euler substep in tuple form (the JAX kernel's
    ``_integrate``; inertia 1/max(ii, 1e-12))."""
    live = dyn & (im > 0)
    vn = tuple(torch.where(live, vc + h1 * (gc + fc * im), vc)
               for vc, gc, fc in zip(v, g, extf))
    posn = tuple(torch.where(live, pc + h1 * vc, pc) for pc, vc in zip(pos, vn))
    inertia = tuple(torch.where(iic > 0, 1.0 / torch.clamp(iic, min=1e-12), 0.0)
                    for iic in ii)
    om_b = pk.qrot_inv(rot, w)
    gyro = pk.cross3(om_b, tuple(a * b for a, b in zip(inertia, om_b)))
    tau_b = pk.qrot_inv(rot, extt)
    om_b = tuple(o + h1 * iic * (tc - gc) for o, iic, tc, gc in zip(om_b, ii, tau_b, gyro))
    wn = pk.qrot(rot, om_b)
    wn = tuple(torch.where(live, wc, w0) for wc, w0 in zip(wn, w))
    zero = torch.zeros_like(pos[0])
    dq = pk.qmul((zero,) + wn, rot)
    rotn = pk.qnormalize(tuple(q + 0.5 * h1 * d for q, d in zip(rot, dq)))
    rotn = tuple(torch.where(live, rc, r0) for rc, r0 in zip(rotn, rot))
    return posn, rotn, vn, wn


def _apply_positional_recover(pos_i, rot_i, prev_pos, prev_rot, acc, h1):
    """Apply the positional segment sum acc (9 [W, n] channels: dx, dw,
    bias dx) to the post-integrate pose and recover the substep's
    velocities, bias excluded (set_velocities)."""
    p2 = pk.v3add(pos_i, acc[0:3])
    zero = torch.zeros_like(acc[3])
    dq = pk.qmul((zero,) + tuple(acc[3:6]), rot_i)
    r2 = pk.qnormalize(tuple(q + 0.5 * d for q, d in zip(rot_i, dq)))
    v2 = tuple((p - pp - b) / h1 for p, pp, b in zip(p2, prev_pos, acc[6:9]))
    dqv = pk.qmul(r2, (prev_rot[0], -prev_rot[1], -prev_rot[2], -prev_rot[3]))
    w2 = tuple(torch.where(dqv[0] >= 0, 2.0 * c / h1, -2.0 * c / h1) for c in dqv[1:4])
    return p2, r2, v2, w2


def _gather(comp, idx):
    """Per-body channel [W, n] at pair rows idx [W, K] (int64, clamped)."""
    return torch.gather(comp, 1, idx)


def _pair_setup(im, ii, mu_s, mu_d, obj, rows_i, rows_j):
    """The pair rows (int64, clamped), their flat body indices and the
    static pair sides (gathered once a call)."""
    W, n = im.shape
    ri = rows_i.long().clamp(0, n - 1)
    rj = rows_j.long().clamp(0, n - 1)
    base = torch.arange(W, device=im.device)[:, None] * n
    flat_i, flat_j = (ri + base).reshape(-1), (rj + base).reshape(-1)

    def side_static(idx):
        return {"im": _gather(im, idx), "ii": tuple(_gather(c, idx) for c in _comps(ii)),
                "mu_s": _gather(mu_s, idx), "mu_d": _gather(mu_d, idx),
                "obj": _gather(obj, idx)}

    return ri, rj, flat_i, flat_j, side_static(ri), side_static(rj)


def _solve_substep(pos_i, rot_i, v_i, w_i, prev_pos, prev_rot, pairs, kvalid, h1, rest1, *,
                   tables, relaxation, speculative, observe=None):
    """Steps 2-9 of a substep (the JAX kernels' ``_substep_core``) from the
    post-integrate pose and velocities and the substep start, all tuples
    of [W, n]: returns the post-solve pose and the post-velocity-pass
    velocities (p2, r2, v3, w3), before the dynamic-row selection."""
    ri, rj, flat_i, flat_j, SA, SB = pairs
    W, n = pos_i[0].shape
    bounce = tables.any_restitution

    def rot_at(r, idx):
        # dead slots get an identity-w quat, as in the JAX kernel
        return (torch.where(kvalid, _gather(r[0], idx), 1.0),) + tuple(
            _gather(c, idx) for c in r[1:])

    def side1(idx, S):
        return {"pos": tuple(_gather(c, idx) for c in pos_i), "rot": rot_at(rot_i, idx),
                "prev_pos": tuple(_gather(c, idx) for c in prev_pos),
                "im": S["im"], "ii": S["ii"], "mu": S["mu_s"]}

    PA, PB = side1(ri, SA), side1(rj, SB)
    FA = pk.body_fields(PA["pos"], PA["rot"], SA["obj"], tables)
    FB = pk.body_fields(PB["pos"], PB["rot"], SB["obj"], tables)
    contacts = pk.pair_contacts(FA, FB, kvalid, speculative=speculative)
    if observe is not None:
        observe(contacts)
    packA, packB, lam = pk.positional_pass(PA, PB, contacts, relaxation=relaxation)
    acc = pk.segment_sum(packA, packB, flat_i, flat_j, kvalid, W, n)
    p2, r2, v2, w2 = _apply_positional_recover(pos_i, rot_i, prev_pos, prev_rot, acc, h1)

    def side2(idx, S):
        side = {"pos": tuple(_gather(c, idx) for c in p2), "rot": rot_at(r2, idx),
                "im": S["im"], "ii": S["ii"], "mu": S["mu_d"],
                "v": tuple(_gather(c, idx) for c in v2),
                "w": tuple(_gather(c, idx) for c in w2)}
        if bounce:
            side["pv"] = tuple(_gather(c, idx) for c in v_i)
            side["pw"] = tuple(_gather(c, idx) for c in w_i)
            side["rest"] = tables.scalar(S["obj"], "restitution")
        return side

    vpA, vpB = pk.velocity_pass(side2(ri, SA), side2(rj, SB), contacts, lam, h1, rest1,
                                speculative=speculative)
    accv = pk.segment_sum(vpA, vpB, flat_i, flat_j, kvalid, W, n)
    return p2, r2, pk.v3add(v2, accv[0:3]), pk.v3add(w2, accv[3:6])


def fused_substep_plain(pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
                        h, gravity, restitution_threshold, rows_i, rows_j, kvalid, *,
                        tables: pk.ObjTables, num_substeps: int, relaxation: float = 1.0,
                        speculative: float = 0.0, observe=None):
    """The plain PyTorch version of the fused substep kernel (see the module
    doc).  Body args [W, n(, 3/4)]; pair args [W, K]; h and
    restitution_threshold [W]; gravity [W, 3].  Returns the dict of
    OUT_KEYS, each [W, n, 3/4].  ``observe``, if given, is called with
    each substep's ``pair_contacts`` output (to count the work the data
    needs)."""
    h1 = h[:, None]
    rest1 = restitution_threshold[:, None]
    g = tuple(gravity[:, c:c + 1] for c in range(3))
    pairs = _pair_setup(im, ii, mu_s, mu_d, obj, rows_i, rows_j)
    ii_b, extf, extt = _comps(ii), _comps(ext_f), _comps(ext_t)
    posc, rotc, vc, wc = _comps(pos), _comps(rot), _comps(v), _comps(w)
    prev_pos, prev_rot = posc, rotc
    ps = (posc, rotc, vc, wc)
    for _ in range(num_substeps):
        prev_pos, prev_rot = posc, rotc
        pos_i, rot_i, v_i, w_i = _integrate(posc, rotc, vc, wc, im, ii_b, extf, extt, dyn,
                                            h1, g)
        ps = (pos_i, rot_i, v_i, w_i)
        p2, r2, v3, w3 = _solve_substep(pos_i, rot_i, v_i, w_i, prev_pos, prev_rot, pairs,
                                        kvalid, h1, rest1, tables=tables,
                                        relaxation=relaxation, speculative=speculative,
                                        observe=observe)
        posc = tuple(torch.where(dyn, a, b) for a, b in zip(p2, posc))
        rotc = tuple(torch.where(dyn, a, b) for a, b in zip(r2, rotc))
        vc = tuple(torch.where(dyn, a, 0.0) for a in v3)
        wc = tuple(torch.where(dyn, a, 0.0) for a in w3)

    vals = (posc, rotc, vc, wc, prev_pos, prev_rot) + ps
    return {k: torch.stack(x, -1) for k, x in zip(OUT_KEYS, vals)}


def substep_plain(pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn, h,
                  restitution_threshold, rows_i, rows_j, kvalid, *, tables: pk.ObjTables,
                  relaxation: float = 1.0, speculative: float = 0.0, observe=None):
    """The plain PyTorch version of the single-substep kernel: steps 2-9 of
    the fused loop once, from the post-integrate pose and velocities
    (pos, rot, v, w) and the substep start (prev_pos, prev_rot).  Body args
    [W, n(, 3/4)]; pair args [W, K]; h and restitution_threshold [W].
    Returns the dict of SUBSTEP_KEYS: dynamic rows the solve, the others
    their pose and zero velocity.  ``observe`` as in fused_substep_plain."""
    pairs = _pair_setup(im, ii, mu_s, mu_d, obj, rows_i, rows_j)
    pos_i, rot_i, v_i, w_i = _comps(pos), _comps(rot), _comps(v), _comps(w)
    p2, r2, v3, w3 = _solve_substep(pos_i, rot_i, v_i, w_i, _comps(prev_pos), _comps(prev_rot),
                                    pairs, kvalid, h[:, None], restitution_threshold[:, None],
                                    tables=tables, relaxation=relaxation,
                                    speculative=speculative, observe=observe)
    vals = (tuple(torch.where(dyn, a, b) for a, b in zip(p2, pos_i)),
            tuple(torch.where(dyn, a, b) for a, b in zip(r2, rot_i)),
            tuple(torch.where(dyn, a, 0.0) for a in v3),
            tuple(torch.where(dyn, a, 0.0) for a in w3))
    return {k: torch.stack(x, -1) for k, x in zip(SUBSTEP_KEYS, vals)}


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("substep_kernels")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_substep_launch.argtypes = (
            [P] * 19 + [I] * 6 + [F, F, I] + [P] * 10 + [P])
        lib.fused_substep_launch.restype = I
        lib.substep_launch.argtypes = [P] * 18 + [I] * 5 + [F, F, I] + [P] * 4 + [P]
        lib.substep_launch.restype = I
        lib._typed = True
    return lib


def kernel_fits(tables: pk.ObjTables, n: int, K: int) -> str:
    """'' when the kernel takes these tables and shapes, else why not."""
    if not tables.all_box:
        return ("a non-box hull in the object tables: the kernel's general-hull "
                "SAT waits (ROADMAP)")
    if tables.Vm > MAX_TABLE_VERTS:
        return f"tables with {tables.Vm} verts per hull > {MAX_TABLE_VERTS}"
    if n < 1 or K < 1:
        return f"n={n} bodies and K={K} candidate slots must both be >= 1"
    if smem_bytes(n, K) > MAX_SMEM_BYTES:
        return (f"n={n} bodies and K={K} candidate slots need {smem_bytes(n, K)} B of "
                f"shared memory, over the {MAX_SMEM_BYTES} B a block may have")
    return ""


# dtype and width of each argument (0: [W, n], c: [W, n, c]; the world
# and slot arguments by their own shapes)
_SPECS = {"pos": (torch.float32, 3), "rot": (torch.float32, 4), "v": (torch.float32, 3),
          "w": (torch.float32, 3), "prev_pos": (torch.float32, 3),
          "prev_rot": (torch.float32, 4), "im": (torch.float32, 0), "ii": (torch.float32, 3),
          "mu_s": (torch.float32, 0), "mu_d": (torch.float32, 0), "obj": (torch.int32, 0),
          "ext_f": (torch.float32, 3), "ext_t": (torch.float32, 3), "dyn": (torch.bool, 0)}


def _check_inputs(name, device, bodies, W, n, K, **others):
    """Raise ValueError unless every body argument has its _SPECS dtype and
    shape, every other its own, all on ``device`` and contiguous."""
    checks = [(key, t) + (_SPECS[key][0], (W, n) + ((_SPECS[key][1],) if _SPECS[key][1] else ()))
              for key, t in bodies.items()]
    world = {"h": (torch.float32, (W,)), "gravity": (torch.float32, (W, 3)),
             "restitution_threshold": (torch.float32, (W,)),
             "rows_i": (torch.int32, (W, K)), "rows_j": (torch.int32, (W, K)),
             "kvalid": (torch.bool, (W, K))}
    checks += [(key, t) + world[key] for key, t in others.items()]
    for key, t, dt, shape in checks:
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, pos on {device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {dt} {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def fused_substep(pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
                  h, gravity, restitution_threshold, rows_i, rows_j, kvalid, *,
                  tables: pk.ObjTables, num_substeps: int, relaxation: float = 1.0,
                  speculative: float = 0.0):
    """All substeps of one physics step.  Body args [W, n(, 3/4)] (dyn
    bool, obj int32); pair args rows_i/rows_j [W, K] int32, kvalid [W, K]
    bool; h, restitution_threshold [W]; gravity [W, 3].  Returns the dict
    of OUT_KEYS.  CPU tensors: the plain version.  CUDA tensors: the
    kernel, or a raise (bad input, tables or shapes the kernel does not
    take, a failed launch) — never the plain version."""
    args = (pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
            h, gravity, restitution_threshold, rows_i, rows_j, kvalid)
    kw = dict(tables=tables, num_substeps=num_substeps, relaxation=relaxation,
              speculative=speculative)
    if pos.device.type == "cpu":
        return fused_substep_plain(*args, **kw)
    W, n = im.shape
    K = rows_i.shape[1]
    why = kernel_fits(tables, n, K)
    if why:
        raise NotImplementedError(f"fused_substep: {why}")
    named = dict(zip(("pos", "rot", "v", "w", "im", "ii", "mu_s", "mu_d", "obj",
                      "ext_f", "ext_t", "dyn"), args[:12]))
    _check_inputs("fused_substep", pos.device, named, W, n, K, h=h, gravity=gravity,
                  restitution_threshold=restitution_threshold, rows_i=rows_i, rows_j=rows_j,
                  kvalid=kvalid)
    table = tables.kernel_table(pos.device)
    outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=pos.device)
            for k in OUT_KEYS}
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = _lib().fused_substep_launch(
        *(t.data_ptr() for t in args), table.data_ptr(),
        tables.O, tables.Vm, W, n, K, int(num_substeps), float(relaxation),
        float(speculative), int(tables.any_restitution),
        *(outs[k].data_ptr() for k in OUT_KEYS), stream)
    if rc != 0:
        raise RuntimeError(f"fused_substep: kernel launch failed with cudaError {rc}")
    FusedSubstepKernel.launches += 1
    return outs


def substep(pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn, h,
            restitution_threshold, rows_i, rows_j, kvalid, *, tables: pk.ObjTables,
            relaxation: float = 1.0, speculative: float = 0.0):
    """One substep after the integrate (the single-substep kernel).  Body
    args [W, n(, 3/4)] (dyn bool, obj int32); pair args rows_i/rows_j
    [W, K] int32, kvalid [W, K] bool; h, restitution_threshold [W].
    Returns the dict of SUBSTEP_KEYS.  CPU tensors: the plain version.
    CUDA tensors: the kernel, or a raise (bad input, tables or shapes the
    kernel does not take, a failed launch) — never the plain version."""
    args = (pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn, h,
            restitution_threshold, rows_i, rows_j, kvalid)
    kw = dict(tables=tables, relaxation=relaxation, speculative=speculative)
    if pos.device.type == "cpu":
        return substep_plain(*args, **kw)
    W, n = im.shape
    K = rows_i.shape[1]
    why = kernel_fits(tables, n, K)
    if why:
        raise NotImplementedError(f"substep: {why}")
    named = dict(zip(("pos", "rot", "v", "w", "prev_pos", "prev_rot", "im", "ii", "mu_s",
                      "mu_d", "obj", "dyn"), args[:12]))
    _check_inputs("substep", pos.device, named, W, n, K, h=h,
                  restitution_threshold=restitution_threshold, rows_i=rows_i, rows_j=rows_j,
                  kvalid=kvalid)
    table = tables.kernel_table(pos.device)
    outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=pos.device)
            for k in SUBSTEP_KEYS}
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = _lib().substep_launch(
        *(t.data_ptr() for t in args), table.data_ptr(), tables.O, tables.Vm, W, n, K,
        float(relaxation), float(speculative), int(tables.any_restitution),
        *(outs[k].data_ptr() for k in SUBSTEP_KEYS), stream)
    if rc != 0:
        raise RuntimeError(f"substep: kernel launch failed with cudaError {rc}")
    SubstepKernel.launches += 1
    return outs


class SubstepKernel:
    """Single-substep driver (JAX ``SubstepKernel``): one ``substep`` call
    (one kernel launch on the card) per substep, for worlds with joints,
    whose solve runs between the calls.  Call with the post-integrate body
    columns; returns (pos, rot, v, w).

    ``launches`` counts the kernel launches (class-wide)."""

    launches = 0

    def __init__(self, object_manager, relaxation: float = 1.0, speculative: float = 0.0):
        self.tables = pk.ObjTables(object_manager)
        self.relaxation = float(relaxation)
        self.speculative = float(speculative)

    def __call__(self, *, pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn,
                 rows_i, rows_j, kvalid, h, restitution_threshold):
        out = substep(
            pos.contiguous(), rot.contiguous(), v.contiguous(), w.contiguous(),
            prev_pos.contiguous(), prev_rot.contiguous(), im.contiguous(), ii.contiguous(),
            mu_s.contiguous(), mu_d.contiguous(), obj.to(torch.int32).contiguous(),
            dyn.to(torch.bool).contiguous(), h.contiguous(),
            restitution_threshold.contiguous(), rows_i.to(torch.int32).contiguous(),
            rows_j.to(torch.int32).contiguous(), kvalid.to(torch.bool).contiguous(),
            tables=self.tables, relaxation=self.relaxation, speculative=self.speculative)
        return out["pos"], out["rot"], out["v"], out["w"]


class FusedSubstepKernel:
    """All-substeps driver: one ``fused_substep`` call (one kernel launch on
    the card) per STEP, whatever the substep count.  The JAX driver's
    signature and output dict; of its options only the defaults are
    ported — contact_refresh, bp_degree (the in-kernel broadphase),
    persist_margin and sleep (``active``) raise NotImplementedError
    (ROADMAP).  ``interpret`` and ``wt`` are the TPU kernel's interpret
    mode and world-block size; only their defaults are accepted.

    ``launches`` counts the kernel launches (class-wide)."""

    launches = 0

    def __init__(self, object_manager, num_substeps: int, relaxation: float = 1.0,
                 interpret: bool = False, wt=None, speculative: float = 0.0,
                 contact_refresh: bool = False, bp_degree: int = 0, bp_capacity: int = 0,
                 persist_margin: float = 0.0):
        for name, val in (("contact_refresh", contact_refresh), ("bp_degree", bp_degree),
                          ("bp_capacity", bp_capacity), ("persist_margin", persist_margin)):
            if val:
                raise NotImplementedError(
                    f"FusedSubstepKernel: {name} is not ported yet (ROADMAP, "
                    "'the fused kernel's options')")
        if interpret or wt is not None:
            raise ValueError("FusedSubstepKernel: interpret and wt are TPU kernel "
                             "settings with no meaning on the card")
        self.tables = pk.ObjTables(object_manager)
        self.num_substeps = int(num_substeps)
        self.relaxation = float(relaxation)
        self.speculative = float(speculative)

    def __call__(self, *, pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
                 h, gravity, restitution_threshold, rows_i=None, rows_j=None,
                 kvalid=None, active=None, scale=None, live=None, dtv=None, mcache=None,
                 stable=None, aabb_lo=None, aabb_hi=None):
        """Body args [W, n(, 3/4)]; pair args [W, K]; h and
        restitution_threshold [W]; gravity [W, 3].  Returns the dict of
        updated columns: pos, rot, v, w and the last substep's stashes
        prev_pos, prev_rot, ps_pos, ps_rot, ps_v, ps_w."""
        if rows_i is None or rows_j is None or kvalid is None:
            raise NotImplementedError("FusedSubstepKernel: the in-kernel broadphase is "
                                      "not ported yet (ROADMAP); pass rows_i/rows_j/kvalid")
        if any(x is not None for x in (active, scale, live, dtv, mcache, stable,
                                       aabb_lo, aabb_hi)):
            raise NotImplementedError("FusedSubstepKernel: sleep and persistent "
                                      "manifolds are not ported yet (ROADMAP)")
        return fused_substep(
            pos.contiguous(), rot.contiguous(), v.contiguous(), w.contiguous(),
            im.contiguous(), ii.contiguous(), mu_s.contiguous(), mu_d.contiguous(),
            obj.to(torch.int32).contiguous(), ext_f.contiguous(), ext_t.contiguous(),
            dyn.to(torch.bool).contiguous(), h.contiguous(), gravity.contiguous(),
            restitution_threshold.contiguous(), rows_i.to(torch.int32).contiguous(),
            rows_j.to(torch.int32).contiguous(), kvalid.to(torch.bool).contiguous(),
            tables=self.tables, num_substeps=self.num_substeps,
            relaxation=self.relaxation, speculative=self.speculative)
