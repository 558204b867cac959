"""Pair-major contact pipeline for compacted candidate pairs (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/physics/pairs.py``, with the same
layout: no component axis, every vec3/quat is a tuple of scalar-field
tensors shaped [W, K] (pair axis last), per-point and per-row lists
[W, R, K].  The math is written out term by term, in the JAX module's
order, so the CUDA kernel (``csrc/substep_kernels.cu``), which repeats
it one pair per thread, rounds the same way.  Where the JAX module uses
``rsqrt`` this one uses ``1 / sqrt`` (correctly rounded on the CPU and
the card alike).

Per-object constants come from ``ObjTables``: small tensors indexed by the
object id (the JAX module unrolls ``obj == o`` selects for the TPU; a
gather gives the same value).  Row gathers are index gathers, and the
sums over bodies are ordered segment sums (``segment_sum``).

Reference mapping: narrowphase src/physics/narrowphase.cpp (doSAT
:663-727, type dispatch :98-108), solver src/physics/physics.cpp
(solvePositions :166-461, solveVelocities :716-1009).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL, PRIM_PLANE, PRIM_SPHERE

NEG_BIG = -1e9
BIG = 1e9
# SAT winner tie margin: scores within SAT_TIE_EPS of the extreme tie and
# the first index wins, so face-on-face stacks (exact ties in real
# arithmetic) pick the same axis whatever the rounding
SAT_TIE_EPS = 1e-5
# manifold cap (reference clips hull contacts to 4 points)
MANIFOLD_MAX_POINTS = 4
CLIP_EPS = 1e-6      # on-plane tolerance: boundary points count inside
CLIP_T_EPS = 1e-4    # segment-endpoint crossings are covered by the vert set
CLIP_STRICT = 1e-5   # ref-vert set must be STRICTLY inside (dedup vs vert set)
FACE_BIAS = 1.001

# ---------------------------------------------------------------------------
# Component-tuple vec3/quat math (each component a [..., K] tensor)
# ---------------------------------------------------------------------------


def v3add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def norm3(a, eps=1e-30):
    return torch.sqrt(torch.clamp(dot3(a, a), min=eps))


def rsqrt(x):
    return 1.0 / torch.sqrt(x)


def v3where(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def qrot(q, v):
    """Rotate vec3 tuple by quat tuple (w,x,y,z)."""
    qw, qv = q[0], (q[1], q[2], q[3])
    t = v3scale(cross3(qv, v), 2.0)
    return v3add(v3add(v, v3scale(t, qw)), cross3(qv, t))


def qrot_inv(q, v):
    qw, qv = q[0], (-q[1], -q[2], -q[3])
    t = v3scale(cross3(qv, v), 2.0)
    return v3add(v3add(v, v3scale(t, qw)), cross3(qv, t))


def qmul(a, b):
    """Quat product of (w,x,y,z) component tuples."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def qnormalize(q, eps=1e-30):
    inv = rsqrt(torch.clamp(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3],
                            min=eps))
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def quat_axes(q):
    """Rotation-matrix columns of quat (w,x,y,z): the box's local x/y/z
    axes in world space, as vec3 tuples."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    u0 = (1.0 - 2.0 * (yy + zz), 2.0 * (xy + wz), 2.0 * (xz - wy))
    u1 = (2.0 * (xy - wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz + wx))
    u2 = (2.0 * (xz + wy), 2.0 * (yz - wx), 1.0 - 2.0 * (xx + yy))
    return u0, u1, u2


def expand(x, axis=1):
    """Insert a broadcast axis (per-pair scalar -> per-row scalar)."""
    return x.unsqueeze(axis)


def vexpand(v, axis=1):
    return tuple(c.unsqueeze(axis) for c in v)


def extreme(score, mode, tie_eps=0.0):
    """score [W,R,K] -> (extreme [W,K], index [W,K] int64 of the FIRST
    row at the extreme; with tie_eps, of the first row within tie_eps of
    it)."""
    ext = score.amax(dim=1) if mode == "max" else score.amin(dim=1)
    e = ext.unsqueeze(1)
    if tie_eps:
        at = (score >= e - tie_eps) if mode == "max" else (score <= e + tie_eps)
    else:
        at = score == e
    # argmax of a bool along R returns the first True
    return ext, at.to(torch.uint8).argmax(dim=1)


def pick_rows(idx, values):
    """values [W,R,K] (or a tuple of them) at rows idx [W,K] -> [W,K]."""
    if isinstance(values, tuple):
        return tuple(pick_rows(idx, c) for c in values)
    return torch.gather(values, 1, idx.unsqueeze(1)).squeeze(1)


def segment_sum(packA, packB, flat_i, flat_j, kvalid, W, n):
    """Sum per-slot channels (tuples of [W, K]) to bodies: [W, n] each.
    flat_i / flat_j [W K]: each slot's A and B body as world * n + row.
    Dead slots add zero; per body, A sides in ascending slot order, then B
    sides, one after the other from 0.  That order is fixed on every
    device (a stable sort by body, then ``segment_reduce``, which adds each
    segment in order), where ``index_add_`` on CUDA adds with atomics in no
    fixed order; so the sums repeat bit for bit, and the CUDA kernel keeps
    the same order."""
    def flat(pack):
        x = torch.stack(pack, -1)                                  # [W, K, C]
        x = torch.where(kvalid[..., None], x, 0.0)
        return x.reshape(-1, x.shape[-1])
    body = torch.cat([flat_i, flat_j])
    order = torch.sort(body, stable=True).indices
    lengths = torch.bincount(body, minlength=W * n)
    vals = torch.cat([flat(packA), flat(packB)])[order]
    out = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
    out = out.reshape(W, n, -1)
    return tuple(out[..., c] for c in range(out.shape[-1]))


def aabb_overlap(loA, hiA, loB, hiB):
    """vec3 tuples [W,K] -> [W,K] overlap (closed slabs)."""
    ok = torch.ones_like(loA[0], dtype=torch.bool)
    for c in range(3):
        ok = ok & (loA[c] <= hiB[c]) & (hiA[c] >= loB[c])
    return ok


# ---------------------------------------------------------------------------
# Per-object asset constants as small tensors
# ---------------------------------------------------------------------------


class ObjTables:
    """The padded object manager as small tensors, indexed by object id.

    ``all_box``: every hull is a box (``hull_is_box``), so hull-hull pairs
    take the analytic OBB path (Gottschalk's 15 axes, box faces clipped
    analytically); ``any_restitution``: some material bounces, so the
    velocity pass carries the restitution channels."""

    def __init__(self, objmgr):
        om = {k: np.asarray(v) for k, v in objmgr.items()}
        self.O = om["prim_type"].shape[0]
        # hand-built managers predating the restitution table get e=0
        om.setdefault("restitution", np.zeros(self.O, np.float32))
        if "local_aabb_lo" in om:
            # each object's bounding radius, the persistence predicate's
            # lever arm (the JAX package's _r_tab, the same numpy formula)
            om["bound_radius"] = np.linalg.norm(np.maximum(
                np.abs(om["local_aabb_lo"]), np.abs(om["local_aabb_hi"])),
                axis=-1).astype(np.float32)
        self.om = om
        self.Vm = om["verts"].shape[1]
        self.Fm = om["face_normals"].shape[1]
        self.Em = om["edge_dirs"].shape[1]
        self.FVm = om["face_verts"].shape[2]
        hulls = om["prim_type"] == PRIM_HULL
        self.all_box = "hull_is_box" in om and bool((om["hull_is_box"][hulls] == 1).all())
        self.any_restitution = bool(np.any(om["restitution"] != 0.0))
        if not self.all_box and "face_side_n" not in om:
            raise ValueError("ObjTables: general hulls need the face clipping "
                             "tables (physics/assets.py PhysicsLoader)")
        self._by_device = {}

    def tab(self, key, device):
        """Table ``key`` as a tensor on ``device`` (built once per device)."""
        tabs = self._by_device.setdefault(torch.device(device), {})
        t = tabs.get(key)
        if t is None:
            a = self.om[key]
            dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
            t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
            tabs[key] = t
        return t

    def masks(self, obj):
        """(is_sphere, is_hull, is_plane) [W,K] bool."""
        pt = self.tab("prim_type", obj.device)[obj.long()]
        return pt == PRIM_SPHERE, pt == PRIM_HULL, pt == PRIM_PLANE

    def scalar(self, obj, key):
        """Per-pair scalar const [W,K] (e.g. sphere_radius)."""
        return self.tab(key, obj.device)[obj.long()]

    def vec(self, obj, key):
        """Per-pair vec3 const tuple of [W,K] (e.g. box_half)."""
        v = self.tab(key, obj.device)[obj.long()]
        return tuple(v[..., c] for c in range(3))

    def rows_vec(self, obj, key, count_key):
        """Per-pair row list: vec3 comps [W,R,K] of an [O,R,3] table and its
        f32 0/1 row mask [W,R,K] (row < the object's count)."""
        t = self.tab(key, obj.device)[obj.long()]            # [W,K,R,3]
        comps = tuple(t[..., c].transpose(1, 2) for c in range(3))
        R = t.shape[2]
        cnt = self.tab(count_key, obj.device)[obj.long()]    # [W,K]
        rows = torch.arange(R, device=obj.device)[None, :, None]
        return comps, (rows < cnt[:, None, :]).to(torch.float32)

    def rows_scalar(self, obj, key):
        """Per-pair row list [W,R,K] of an [O,R] table (face_d)."""
        return self.tab(key, obj.device)[obj.long()].transpose(1, 2)

    def rows2_vec_sel(self, obj, key, idx):
        """Row idx [W,K] of an [O,R1,R2,3] table -> vec3 comps [W,R2,K]
        (one face's vertex/plane rows per pair)."""
        t = self.tab(key, obj.device)[obj.long(), idx]        # [W,K,R2,3]
        return tuple(t[..., c].transpose(1, 2) for c in range(3))

    def rows2_scalar_sel(self, obj, key, idx):
        """Row idx [W,K] of an [O,R1,R2] table -> [W,R2,K]."""
        return self.tab(key, obj.device)[obj.long(), idx].transpose(1, 2)

    def kernel_table(self, device):
        """The table the CUDA kernels read: [O, 20 + 3 Vm] float32, per
        object (prim_type, sphere_radius, box_half xyz, restitution,
        num_verts, verts, local_aabb_lo xyz, local_aabb_hi xyz, inv_mass,
        inv_inertia xyz, mu_s, mu_d, bound_radius; a manager without the
        mass and friction tables gets zeros there).  Built and copied once
        per device, so a step queues no host-to-device copy (which would
        wait for the stream)."""
        tabs = self._by_device.setdefault(torch.device(device), {})
        t = tabs.get("_kernel")
        if t is None:
            om = self.om

            def col(key, width=1):
                a = om.get(key)
                a = np.zeros((self.O, width), np.float32) if a is None else np.asarray(a)
                return a.reshape(self.O, width).astype(np.float32)

            rows = np.concatenate([
                om["prim_type"][:, None].astype(np.float32),
                om["sphere_radius"][:, None], om["box_half"],
                om["restitution"][:, None],
                om["num_verts"][:, None].astype(np.float32),
                om["verts"].reshape(self.O, -1),
                om["local_aabb_lo"], om["local_aabb_hi"],
                col("inv_mass"), col("inv_inertia", 3), col("mu_s"), col("mu_d"),
                col("bound_radius")], axis=1).astype(np.float32)
            t = torch.as_tensor(np.ascontiguousarray(rows), device=device)
            tabs["_kernel"] = t
        return t


def body_fields(pos, rot, obj, tables: ObjTables) -> Dict[str, Any]:
    """World-space per-pair-side fields.  pos: vec3 tuple [W,K]; rot: quat
    tuple [W,K]; obj [W,K] int.  The data a reference CollisionPrimitive
    carries (physics.hpp:245-264) pushed to world space per pair.  Only
    the fields the tables' path reads are built (eager PyTorch has no
    dead-code elimination): box frames for all-box tables, face / edge /
    SAT-axis rows otherwise."""
    is_s, is_h, is_p = tables.masks(obj)
    verts_l, vmask = tables.rows_vec(obj, "verts", "num_verts")
    rq = tuple(expand(c) for c in rot)            # [W,1,K]
    pe = tuple(expand(c) for c in pos)
    zero = torch.zeros_like(pos[0])
    plane_n = qrot(rot, (zero, zero, torch.ones_like(zero)))
    out = {
        "obj": obj, "_tables": tables,
        "pos": pos, "rot": rot,
        "is_sphere": is_s, "is_hull": is_h, "is_plane": is_p,
        "radius": tables.scalar(obj, "sphere_radius"),
        "verts_w": v3add(qrot(rq, verts_l), pe), "vmask": vmask,
        "plane_n": plane_n, "plane_d": dot3(plane_n, pos),
    }
    if tables.all_box:
        out["box_u"] = quat_axes(rot)
        out["box_h"] = tables.vec(obj, "box_half")
        return out
    fnorm_l, fmask = tables.rows_vec(obj, "face_normals", "num_faces")
    fnorm_w = qrot(rq, fnorm_l)
    sat_l, smask = tables.rows_vec(obj, "sat_axes", "num_sat_axes")
    edir_l, emask = tables.rows_vec(obj, "edge_dirs", "num_edges")
    ep0_l, efmask = tables.rows_vec(obj, "edge_p0", "num_full_edges")
    ep1_l, _ = tables.rows_vec(obj, "edge_p1", "num_full_edges")
    out.update({
        "fnorm_w": fnorm_w, "fmask": fmask,
        "face_dw": tables.rows_scalar(obj, "face_d") + dot3(fnorm_w, pe),
        "sat_w": qrot(rq, sat_l), "smask": smask,
        "edir_w": qrot(rq, edir_l), "emask": emask,
        "edge_p0_w": v3add(qrot(rq, ep0_l), pe), "efmask": efmask,
        "edge_p1_w": v3add(qrot(rq, ep1_l), pe),
    })
    return out


# ---------------------------------------------------------------------------
# Narrowphase
# ---------------------------------------------------------------------------


def _obb_sat(A, B):
    """Gottschalk's 15-axis OBB separating-axis tests for box-box pairs.
    Returns (minA, minB, minE [W,K] pens, fA, fB, fE winning-axis vec3
    tuples, sign-agnostic, and the winning edge axes' per-side row
    indices (iA, iB) [W,K])."""
    uA, uB = A["box_u"], B["box_u"]
    hA, hB = A["box_h"], B["box_h"]
    d = v3sub(B["pos"], A["pos"])
    t = [dot3(u, d) for u in uA]                       # d in A frame
    s = [dot3(u, d) for u in uB]                       # d in B frame
    M = [[dot3(uA[i], uB[j]) for j in range(3)] for i in range(3)]
    # Gottschalk eps: inflate |M| so near-parallel axes don't produce
    # false separations from cancellation
    aM = [[torch.abs(M[i][j]) + 1e-6 for j in range(3)] for i in range(3)]

    penA = [hA[i] + aM[i][0] * hB[0] + aM[i][1] * hB[1] + aM[i][2] * hB[2]
            - torch.abs(t[i]) for i in range(3)]
    penB = [hB[j] + aM[0][j] * hA[0] + aM[1][j] * hA[1] + aM[2][j] * hA[2]
            - torch.abs(s[j]) for j in range(3)]
    penE = []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            rA = hA[i1] * aM[i2][j] + hA[i2] * aM[i1][j]
            rB = hB[j1] * aM[i][j2] + hB[j2] * aM[i][j1]
            tL = torch.abs(t[i2] * M[i1][j] - t[i1] * M[i2][j])
            len2 = 1.0 - M[i][j] * M[i][j]
            pen = (rA + rB - tL) * rsqrt(torch.clamp(len2, min=1e-12))
            penE.append(torch.where(len2 > 1e-8, pen, BIG))

    minA, ia = extreme(torch.stack(penA, 1), "min", SAT_TIE_EPS)
    minB, ib = extreme(torch.stack(penB, 1), "min", SAT_TIE_EPS)
    minE, ie = extreme(torch.stack(penE, 1), "min", SAT_TIE_EPS)   # i-major

    def pick_axis(idx, axes):
        return pick_rows(idx, tuple(torch.stack([ax[c] for ax in axes], 1)
                                    for c in range(3)))

    fA = pick_axis(ia, uA)
    fB = pick_axis(ib, uB)
    eA, eB = ie // 3, ie % 3
    fE = cross3(pick_axis(eA, uA), pick_axis(eB, uB))
    fE = v3scale(fE, 1.0 / torch.clamp(norm3(fE), min=1e-12))
    return minA, minB, minE, fA, fB, fE, (eA, eB)


def _clip_face_manifold(polyI_w, polyIn_w, vvalI, sidesR, sidesI,
                        polyR_w, vvalR, n_reff, d_reff, n_incf, d_incf,
                        axis_inc):
    """Exact incident-face clip manifold — order-free Sutherland-Hodgman
    (see the JAX module): set 1 = incident edges interval-clipped against
    the reference face's side planes (start point per edge, end point when
    strictly clipped); set 2 = reference-face verts strictly inside the
    incident polygon, projected onto the incident face along the contact
    axis.  Returns (pts vec3 [W,3*FVe,K], dep [W,3*FVe,K]); dep -BIG on
    dead slots."""
    shapeP = polyI_w[0].shape                      # [W, FVe, K]
    dev = polyI_w[0].device
    t_lo = torch.zeros(shapeP, device=dev)
    t_hi = torch.ones(shapeP, device=dev)
    empty = torch.zeros(shapeP, dtype=torch.bool, device=dev)
    for sn, sd, pv in sidesR:
        d0 = dot3(polyI_w, vexpand(sn)) - expand(sd)
        d1 = dot3(polyIn_w, vexpand(sn)) - expand(sd)
        pvb = expand(pv > 0.5)
        denom = d0 - d1
        crossing = torch.abs(denom) > 1e-12
        tc = d0 / torch.where(crossing, denom, 1.0)
        t_lo = torch.where(pvb & crossing & (d0 > 0) & (d1 <= 0),
                           torch.maximum(t_lo, tc), t_lo)
        t_hi = torch.where(pvb & crossing & (d0 <= 0) & (d1 > 0),
                           torch.minimum(t_hi, tc), t_hi)
        empty = empty | (pvb & (d0 > CLIP_EPS) & (d1 > CLIP_EPS))
    edge_ok = (vvalI > 0.5) & ~empty & (t_lo <= t_hi + 1e-9)
    seg = v3sub(polyIn_w, polyI_w)
    pt_lo = v3add(polyI_w, v3scale(seg, t_lo))
    pt_hi = v3add(polyI_w, v3scale(seg, t_hi))
    dep_lo = expand(d_reff) - dot3(pt_lo, vexpand(n_reff))
    dep_hi = expand(d_reff) - dot3(pt_hi, vexpand(n_reff))
    dep_lo = torch.where(edge_ok, dep_lo, -BIG)
    dep_hi = torch.where(edge_ok & (t_hi < 1.0 - CLIP_T_EPS), dep_hi, -BIG)

    inside3 = vvalR > 0.5
    for sn, sd, pv in sidesI:
        dist = dot3(polyR_w, vexpand(sn)) - expand(sd)
        inside3 = inside3 & ((dist <= -CLIP_STRICT) | ~expand(pv > 0.5))
    den = dot3(n_incf, axis_inc)                   # ~-1 when faces oppose
    den_ok = torch.abs(den) > 0.1
    den_s = expand(torch.where(den_ok, den, 1.0))
    s = (expand(d_incf) - dot3(polyR_w, vexpand(n_incf))) / den_s
    q = v3add(polyR_w, v3scale(vexpand(axis_inc), s))
    dep3 = expand(d_reff) - dot3(q, vexpand(n_reff))
    dep3 = torch.where(inside3 & expand(den_ok), dep3, -BIG)

    pts = tuple(torch.cat([a, b, c], 1) for a, b, c in zip(pt_lo, pt_hi, q))
    return pts, torch.cat([dep_lo, dep_hi, dep3], 1)


def _box_face_inputs(pos, u, h, outward):
    """The face of a box most aligned with ``outward`` as clip inputs:
    (poly vec3 [W,4,K] loop-ordered, poly_next, vval [W,4,K], side planes
    [(n, d, valid)] x4, n_face, d_face)."""
    score = [dot3(u[k], outward) for k in range(3)]
    _, sel = extreme(torch.stack([torch.abs(sc) for sc in score], 1), "max")
    sgn = [torch.where(score[k] >= 0, 1.0, -1.0) for k in range(3)]

    def pick(vals, shift=0):
        # vals[(sel + shift) % 3] for per-axis values (tensors or vec3s)
        idx = (sel + shift) % 3
        if isinstance(vals[0], tuple):
            return tuple(pick_rows(idx, torch.stack([v[c] for v in vals], 1))
                         for c in range(3))
        return pick_rows(idx, torch.stack(list(vals), 1))

    n = pick([v3scale(u[k], sgn[k]) for k in range(3)])
    hn = pick(h)
    a, b = pick(u, 1), pick(u, 2)
    ha, hb = pick(h, 1), pick(h, 2)
    d = dot3(n, pos) + hn
    center = v3add(pos, v3scale(n, hn))
    corners = [v3add(center, v3add(v3scale(a, sa * ha), v3scale(b, sb * hb)))
               for sa, sb in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))]
    poly = tuple(torch.stack([c[i] for c in corners], 1) for i in range(3))
    nxt = corners[1:] + corners[:1]
    poly_n = tuple(torch.stack([c[i] for c in nxt], 1) for i in range(3))
    vval = torch.ones_like(poly[0])
    one = torch.ones_like(d)
    sides = [(a, dot3(a, pos) + ha, one),
             (v3scale(a, -1.0), -dot3(a, pos) + ha, one),
             (b, dot3(b, pos) + hb, one),
             (v3scale(b, -1.0), -dot3(b, pos) + hb, one)]
    return poly, poly_n, vval, sides, n, d


def _segment_closest(a0, a1, b0, b1):
    """Midpoint of the closest points between segments a0-a1 and b0-b1
    (standard clamped form)."""
    d1v = v3sub(a1, a0)
    d2v = v3sub(b1, b0)
    rv = v3sub(a0, b0)
    a_ = dot3(d1v, d1v)
    e_ = dot3(d2v, d2v)
    f_ = dot3(d2v, rv)
    c_ = dot3(d1v, rv)
    b_ = dot3(d1v, d2v)
    denom = a_ * e_ - b_ * b_
    big = torch.abs(denom) > 1e-12
    s_ = torch.clamp(torch.where(big, (b_ * f_ - c_ * e_) / torch.where(big, denom, 1.0),
                                 0.0), 0.0, 1.0)
    t_ = torch.clamp((b_ * s_ + f_) / torch.clamp(e_, min=1e-12), 0.0, 1.0)
    s_ = torch.clamp((b_ * t_ - c_) / torch.clamp(a_, min=1e-12), 0.0, 1.0)
    cA = v3add(a0, v3scale(d1v, s_))
    cB = v3add(b0, v3scale(d2v, t_))
    return v3scale(v3add(cA, cB), 0.5)


def pair_contacts(A: Dict[str, Any], B: Dict[str, Any], pair_live: torch.Tensor,
                  speculative: float = 0.0) -> Dict[str, Any]:
    """Contacts for compacted pairs; A/B from body_fields, pair_live [W,K].

    Same pair kinds and merge order as the JAX module: sphere-sphere,
    sphere-plane, hull-plane (all hull verts, depth-masked), sphere-hull
    (analytic sphere-box for all-box tables), hull-hull SAT (analytic OBB
    for all-box tables, the vertex-support SAT otherwise) with the exact
    incident-face clip manifold and an edge-edge point.  The candidates
    are compacted to the deepest MANIFOLD_MAX_POINTS.  speculative > 0
    keeps near-miss contacts (depth in (-speculative, 0]).

    Output: ok [W,K], normal vec3 tuple [W,K], points vec3 tuple [W,4,K],
    depth [W,4,K], num_points [W,K] int32."""
    W, K = pair_live.shape
    dev = pair_live.device
    tables: ObjTables = A["_tables"]
    all_box = tables.all_box
    Vm = A["vmask"].shape[1]
    P = max(Vm, 12 if all_box else 3 * tables.FVm)

    def padP(x, fill=0.0):
        if x.shape[1] == P:
            return x
        return torch.cat([x, x.new_full((W, P - x.shape[1], K), fill)], 1)

    zeroK = torch.zeros((W, K), device=dev)
    falseK = torch.zeros((W, K), dtype=torch.bool, device=dev)
    st = {"ok": falseK, "normal": (zeroK,) * 3,
          "np": torch.zeros((W, K), dtype=torch.int32, device=dev),
          "pt0": (zeroK,) * 3, "dep0": torch.full((W, K), -BIG, device=dev),
          "single": falseK,
          "mpts": (torch.zeros((W, P, K), device=dev),) * 3,
          "mdep": torch.full((W, P, K), -BIG, device=dev), "multi": falseK}

    def merge(sel, ok, normal, num_points, point=None, pen=None,
              points=None, depth=None):
        sel = sel & pair_live
        st["ok"] = (sel & ok) | (st["ok"] & ~sel)
        st["normal"] = v3where(sel, normal, st["normal"])
        st["np"] = torch.where(sel, num_points, st["np"])
        if points is None:
            st["pt0"] = v3where(sel, point, st["pt0"])
            st["dep0"] = torch.where(sel, pen, st["dep0"])
            st["single"] = st["single"] | sel
            st["multi"] = st["multi"] & ~sel
        else:
            selP = expand(sel)
            st["mpts"] = v3where(selP, points, st["mpts"])
            st["mdep"] = torch.where(selP, depth, st["mdep"])
            st["multi"] = st["multi"] | sel
            st["single"] = st["single"] & ~sel

    posA, posB = A["pos"], B["pos"]
    radA, radB = A["radius"], B["radius"]
    ones_np = torch.ones((W, K), dtype=torch.int32, device=dev)

    # ---- sphere-sphere ----------------------------------------------------
    d = v3sub(posB, posA)
    dist = norm3(d, 1e-18)
    nrm = v3scale(d, 1.0 / dist)
    pen = (radA + radB) - dist
    mid = v3add(posA, v3scale(nrm, radA - 0.5 * pen))
    merge(A["is_sphere"] & B["is_sphere"], pen > -speculative, nrm, ones_np, mid, pen)

    # ---- sphere-plane (either order) ---------------------------------------
    def sphere_plane(s_pos, s_rad, p_n, p_d, flip):
        c_dist = dot3(s_pos, p_n) - p_d
        pen = s_rad - c_dist
        contact = v3sub(s_pos, v3scale(p_n, c_dist))
        return pen > -speculative, p_n if flip else v3scale(p_n, -1.0), contact, pen

    o, n_, c, dp = sphere_plane(posA, radA, B["plane_n"], B["plane_d"], False)
    merge(A["is_sphere"] & B["is_plane"], o, n_, ones_np, c, dp)
    o, n_, c, dp = sphere_plane(posB, radB, A["plane_n"], A["plane_d"], True)
    merge(A["is_plane"] & B["is_sphere"], o, n_, ones_np, c, dp)

    # ---- hull-plane (either order): all verts, depth-masked ---------------
    def hull_plane(h_verts_w, h_vmask, p_n, p_d, flip):
        vd = dot3(h_verts_w, vexpand(p_n)) - expand(p_d)          # [W,Vm,K]
        pen_v = torch.where(h_vmask > 0.5, -vd, -BIG)
        num = (pen_v > -speculative).sum(1, dtype=torch.int32)
        return (num > 0, p_n if flip else v3scale(p_n, -1.0),
                tuple(padP(c) for c in h_verts_w), padP(pen_v, -BIG), num)

    o, n_, p_, dp, cnt = hull_plane(A["verts_w"], A["vmask"], B["plane_n"], B["plane_d"],
                                    False)
    merge(A["is_hull"] & B["is_plane"], o, n_, cnt, points=p_, depth=dp)
    o, n_, p_, dp, cnt = hull_plane(B["verts_w"], B["vmask"], A["plane_n"], A["plane_d"],
                                    True)
    merge(A["is_plane"] & B["is_hull"], o, n_, cnt, points=p_, depth=dp)

    # ---- sphere-hull (either order) ---------------------------------------
    if all_box:
        # analytic sphere-box: clamp the center into the box frame (exact on
        # faces, edges and corners)
        def sphere_hull(s_pos, s_rad, H, flip):
            b_pos, b_u, b_h = H["pos"], H["box_u"], H["box_h"]
            dd = v3sub(s_pos, b_pos)
            cl = tuple(dot3(b_u[k], dd) for k in range(3))
            q = tuple(torch.clamp(cl[k], -b_h[k], b_h[k]) for k in range(3))
            inside = ((torch.abs(cl[0]) < b_h[0]) & (torch.abs(cl[1]) < b_h[1])
                      & (torch.abs(cl[2]) < b_h[2]))
            q_w = tuple(q[0] * b_u[0][c] + q[1] * b_u[1][c] + q[2] * b_u[2][c]
                        for c in range(3))
            delta = v3sub(dd, q_w)
            dist = norm3(delta, 1e-18)
            n_out = v3scale(delta, 1.0 / dist)
            fdist = torch.stack([b_h[k] - torch.abs(cl[k]) for k in range(3)], 1)
            fmin, ax = extreme(fdist, "min")
            n_in = pick_rows(ax, tuple(
                torch.stack([torch.where(cl[k] >= 0, 1.0, -1.0) * b_u[k][c]
                             for k in range(3)], 1) for c in range(3)))
            nrm_hs = v3where(inside, n_in, n_out)                 # box -> sphere
            pen = torch.where(inside, s_rad + fmin, s_rad - dist)
            contact = tuple(b_pos[c] + q_w[c] for c in range(3))
            return (pen > -speculative, nrm_hs if flip else v3scale(nrm_hs, -1.0),
                    contact, pen)
    else:
        def sphere_hull(s_pos, s_rad, H, flip):
            cd = dot3(H["fnorm_w"], vexpand(s_pos)) - H["face_dw"]   # [W,Fm,K]
            cd = torch.where(H["fmask"] > 0.5, cd, NEG_BIG)
            fdist, f = extreme(cd, "max")
            fn = pick_rows(f, H["fnorm_w"])
            pen = s_rad - fdist
            contact = v3sub(s_pos, v3scale(fn, fdist))
            return pen > -speculative, fn if flip else v3scale(fn, -1.0), contact, pen

    o, n_, c, dp = sphere_hull(posA, radA, B, False)
    merge(A["is_sphere"] & B["is_hull"], o, n_, ones_np, c, dp)
    o, n_, c, dp = sphere_hull(posB, radB, A, True)
    merge(A["is_hull"] & B["is_sphere"], o, n_, ones_np, c, dp)

    # ---- hull-hull SAT -----------------------------------------------------
    both_hull = A["is_hull"] & B["is_hull"] & pair_live
    ab = v3sub(posB, posA)
    if all_box:
        minA, minB, minE, fA, fB, fE, edge_sel = _obb_sat(A, B)
    else:
        def axis_pen(axes_w, valid):
            projA = sum(axes_w[c][:, :, None] * A["verts_w"][c][:, None] for c in range(3))
            projB = sum(axes_w[c][:, :, None] * B["verts_w"][c][:, None] for c in range(3))
            vmA = (A["vmask"][:, None] > 0.5).expand(projA.shape)
            vmB = (B["vmask"][:, None] > 0.5).expand(projB.shape)
            maxA = torch.where(vmA, projA, NEG_BIG).amax(2)
            minA_ = torch.where(vmA, projA, BIG).amin(2)
            maxB = torch.where(vmB, projB, NEG_BIG).amax(2)
            minB_ = torch.where(vmB, projB, BIG).amin(2)
            return torch.where(valid, torch.minimum(maxA - minB_, maxB - minA_), BIG)

        Em = tables.Em
        cr_parts, cv_parts = [], []
        for i in range(Em):
            eAi = tuple(c[:, i] for c in A["edir_w"])
            for j in range(Em):
                cr_parts.append(cross3(eAi, tuple(c[:, j] for c in B["edir_w"])))
                cv_parts.append(A["emask"][:, i] * B["emask"][:, j])
        cr = tuple(torch.stack([p[c] for p in cr_parts], 1) for c in range(3))
        clen = norm3(cr)
        cvalid = (clen > 1e-6) & (torch.stack(cv_parts, 1) > 0.5)
        cr = v3scale(cr, 1.0 / torch.clamp(clen, min=1e-12))
        minA, ia = extreme(axis_pen(A["sat_w"], A["smask"] > 0.5), "min", SAT_TIE_EPS)
        minB, ib = extreme(axis_pen(B["sat_w"], B["smask"] > 0.5), "min", SAT_TIE_EPS)
        minE, ie = extreme(axis_pen(cr, cvalid), "min", SAT_TIE_EPS)
        fA = pick_rows(ia, A["sat_w"])
        fB = pick_rows(ib, B["sat_w"])
        fE = pick_rows(ie, cr)

    sat_pen = torch.minimum(torch.minimum(minA, minB), minE)
    hit = both_hull & (sat_pen > -speculative) & (sat_pen < BIG * 0.5)
    use_faceA = minA <= torch.minimum(minB, minE) * FACE_BIAS + SAT_TIE_EPS
    use_faceB = (~use_faceA) & (minB <= minE * FACE_BIAS + SAT_TIE_EPS)
    use_edge = ~(use_faceA | use_faceB)

    def orient(v):
        return v3scale(v, torch.where(dot3(v, ab) >= 0, 1.0, -1.0))

    sat_normal = v3where(use_faceA, orient(fA), v3where(use_faceB, orient(fB), orient(fE)))
    # axis pointing from the reference face INTO the incident hull
    nrm_inc = v3where(use_faceB, v3scale(sat_normal, -1.0), sat_normal)
    ref_pos = v3where(use_faceB, posB, posA)
    inc_pos = v3where(use_faceB, posA, posB)
    if all_box:
        ref_u = tuple(v3where(use_faceB, ub, ua) for ua, ub in zip(A["box_u"], B["box_u"]))
        inc_u = tuple(v3where(use_faceB, ua, ub) for ua, ub in zip(A["box_u"], B["box_u"]))
        ref_h = tuple(torch.where(use_faceB, hb, ha) for ha, hb in zip(A["box_h"], B["box_h"]))
        inc_h = tuple(torch.where(use_faceB, ha, hb) for ha, hb in zip(A["box_h"], B["box_h"]))
        polyI, polyIn, vvalI, sidesI, n_incf, d_incf = _box_face_inputs(
            inc_pos, inc_u, inc_h, v3scale(nrm_inc, -1.0))
        polyR, _, vvalR, sidesR, n_reff, d_reff = _box_face_inputs(
            ref_pos, ref_u, ref_h, nrm_inc)
    else:
        ref_rot = tuple(torch.where(use_faceB, b, a) for a, b in zip(A["rot"], B["rot"]))
        inc_rot = tuple(torch.where(use_faceB, a, b) for a, b in zip(A["rot"], B["rot"]))
        obj_ref = torch.where(use_faceB, B["obj"], A["obj"])
        obj_inc = torch.where(use_faceB, A["obj"], B["obj"])
        ufF = expand(use_faceB)
        fnormR_w = v3where(ufF, B["fnorm_w"], A["fnorm_w"])
        fnormI_w = v3where(ufF, A["fnorm_w"], B["fnorm_w"])
        fdR_w = torch.where(ufF, B["face_dw"], A["face_dw"])
        fdI_w = torch.where(ufF, A["face_dw"], B["face_dw"])
        fmR = torch.where(ufF, B["fmask"], A["fmask"])
        fmI = torch.where(ufF, A["fmask"], B["fmask"])
        # reference face: most aligned with the contact axis; incident
        # face: most anti-aligned
        _, fr = extreme(torch.where(fmR > 0.5, dot3(fnormR_w, vexpand(nrm_inc)), NEG_BIG),
                        "max")
        _, fi = extreme(torch.where(fmI > 0.5, dot3(fnormI_w, vexpand(nrm_inc)), BIG),
                        "min")
        n_reff, d_reff = pick_rows(fr, fnormR_w), pick_rows(fr, fdR_w)
        n_incf, d_incf = pick_rows(fi, fnormI_w), pick_rows(fi, fdI_w)
        rqR, peR = tuple(expand(c) for c in ref_rot), vexpand(ref_pos)
        rqI, peI = tuple(expand(c) for c in inc_rot), vexpand(inc_pos)
        polyI = v3add(qrot(rqI, tables.rows2_vec_sel(obj_inc, "face_verts", fi)), peI)
        polyIn = v3add(qrot(rqI, tables.rows2_vec_sel(obj_inc, "face_verts_next", fi)), peI)
        vvalI = tables.rows2_scalar_sel(obj_inc, "face_slot_valid", fi)
        polyR = v3add(qrot(rqR, tables.rows2_vec_sel(obj_ref, "face_verts", fr)), peR)
        vvalR = tables.rows2_scalar_sel(obj_ref, "face_slot_valid", fr)

        def mk_sides(rot_q, pos_v, n_l, d_l, val):
            out = []
            for p in range(n_l[0].shape[1]):
                sn_w = qrot(rot_q, tuple(c[:, p] for c in n_l))
                out.append((sn_w, d_l[:, p] + dot3(sn_w, pos_v), val[:, p]))
            return out

        sidesR = mk_sides(ref_rot, ref_pos, tables.rows2_vec_sel(obj_ref, "face_side_n", fr),
                          tables.rows2_scalar_sel(obj_ref, "face_side_d", fr), vvalR)
        sidesI = mk_sides(inc_rot, inc_pos, tables.rows2_vec_sel(obj_inc, "face_side_n", fi),
                          tables.rows2_scalar_sel(obj_inc, "face_side_d", fi), vvalI)

    pts_c, dep_c = _clip_face_manifold(polyI, polyIn, vvalI, sidesR, sidesI, polyR, vvalR,
                                       n_reff, d_reff, n_incf, d_incf, nrm_inc)
    dep_sat = padP(dep_c, -BIG)
    pts_sat = tuple(padP(c) for c in pts_c)

    # edge-edge: one contact at the closest point between the supporting
    # edges (the full edge whose least-projecting endpoint is maximal along
    # the support direction)
    if all_box:
        def box_edge(pos, u, h, e_idx, n_dir):
            sel_w = [(e_idx == k).to(torch.float32) for k in range(3)]
            u_sel = tuple(sel_w[0] * u[0][c] + sel_w[1] * u[1][c] + sel_w[2] * u[2][c]
                          for c in range(3))
            off = (torch.zeros_like(pos[0]),) * 3
            for k in range(3):
                sk = torch.where(dot3(n_dir, u[k]) >= 0, 1.0, -1.0)
                off = v3add(off, v3scale(u[k], (1.0 - sel_w[k]) * sk * h[k]))
            h_sel = sel_w[0] * h[0] + sel_w[1] * h[1] + sel_w[2] * h[2]
            mid_ = v3add(pos, off)
            arm = v3scale(u_sel, h_sel)
            return v3sub(mid_, arm), v3add(mid_, arm)

        a0, a1 = box_edge(posA, A["box_u"], A["box_h"], edge_sel[0], sat_normal)
        b0, b1 = box_edge(posB, B["box_u"], B["box_h"], edge_sel[1],
                          v3scale(sat_normal, -1.0))
    else:
        def support_edge(F, n_dir):
            p0, p1 = F["edge_p0_w"], F["edge_p1_w"]
            score = torch.where(F["efmask"] > 0.5,
                                torch.minimum(dot3(p0, vexpand(n_dir)),
                                              dot3(p1, vexpand(n_dir))), NEG_BIG)
            _, e = extreme(score, "max")
            return pick_rows(e, p0), pick_rows(e, p1)

        a0, a1 = support_edge(A, sat_normal)
        b0, b1 = support_edge(B, v3scale(sat_normal, -1.0))
    edge_pt = _segment_closest(a0, a1, b0, b1)

    ue = expand(use_edge)
    slot0 = (torch.arange(P, device=dev) == 0)[None, :, None]
    dep_sat = torch.where(ue, torch.where(slot0, expand(sat_pen), -BIG), dep_sat)
    pts_sat = tuple(torch.where(ue, torch.where(slot0, expand(ec), 0.0), pc)
                    for ec, pc in zip(edge_pt, pts_sat))
    merge(both_hull, hit, sat_normal, (dep_sat > 0).sum(1, dtype=torch.int32),
          points=pts_sat, depth=dep_sat)

    # ---- final assembly: the single-point channel in slot 0 ----------------
    sing = expand(st["single"])
    points = tuple(torch.where(sing, torch.where(slot0, expand(c0), 0.0), mc)
                   for c0, mc in zip(st["pt0"], st["mpts"]))
    depth = torch.where(sing, torch.where(slot0, expand(st["dep0"]), -BIG), st["mdep"])

    # ---- deepest-4 manifold compaction (first index wins ties) -------------
    rem = depth
    sel_d, sel_p = [], []
    rows = torch.arange(P, device=dev)[None, :, None]
    for _ in range(MANIFOLD_MAX_POINTS):
        dmax, i = extreme(rem, "max")
        sel_d.append(dmax)
        sel_p.append(pick_rows(i, points))
        rem = torch.where(rows == i.unsqueeze(1), -BIG, rem)
    return {
        "ok": st["ok"],
        "normal": st["normal"],
        "points": tuple(torch.stack([p[c] for p in sel_p], 1) for c in range(3)),
        "depth": torch.stack(sel_d, 1),
        "num_points": torch.clamp(st["np"], max=MANIFOLD_MAX_POINTS),
    }


# ---------------------------------------------------------------------------
# Solver passes (reference physics.cpp:166-461, 716-1009)
# ---------------------------------------------------------------------------


def _sym_from_quat_ii(rot, ii):
    """World-frame inverse-inertia matrix M = R diag(ii) R^T from a quat
    tuple and body-frame diagonal ii, as (m00, m01, m02, m11, m12, m22)."""
    qw, qx, qy, qz = rot
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    r00 = 1.0 - 2.0 * (yy + zz)
    r10 = 2.0 * (xy + wz)
    r20 = 2.0 * (xz - wy)
    r01 = 2.0 * (xy - wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r21 = 2.0 * (yz + wx)
    r02 = 2.0 * (xz + wy)
    r12 = 2.0 * (yz - wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    i0, i1, i2 = ii
    return (i0 * r00 * r00 + i1 * r01 * r01 + i2 * r02 * r02,
            i0 * r00 * r10 + i1 * r01 * r11 + i2 * r02 * r12,
            i0 * r00 * r20 + i1 * r01 * r21 + i2 * r02 * r22,
            i0 * r10 * r10 + i1 * r11 * r11 + i2 * r12 * r12,
            i0 * r10 * r20 + i1 * r11 * r21 + i2 * r12 * r22,
            i0 * r20 * r20 + i1 * r21 * r21 + i2 * r22 * r22)


def _sym_mv(M, v):
    m00, m01, m02, m11, m12, m22 = M
    return (m00 * v[0] + m01 * v[1] + m02 * v[2],
            m01 * v[0] + m11 * v[1] + m12 * v[2],
            m02 * v[0] + m12 * v[1] + m22 * v[2])


def _sum_points(x):
    """x [W,P,K] -> [W,K], summed over P in index order."""
    acc = x[:, 0]
    for p in range(1, x.shape[1]):
        acc = acc + x[:, p]
    return acc


def positional_pass(sideA, sideB, contacts, relaxation=1.0, max_visible_depth=0.05):
    """Per-pair positional corrections.  sides: dicts with vec3/quat tuples
    (pos/rot/prev_pos) + scalars (im/mu) + vec3 ii.  Returns (packA, packB,
    lam): packs are tuples of 9 [W,K] tensors (dx, dw, bias_dx) summed over
    the points, zero on dead points; lam [W,P,K]."""
    pts = contacts["points"]
    depth = contacts["depth"]
    pt_ok = expand(contacts["ok"]) & (depth > 0)

    posA, rotA = sideA["pos"], sideA["rot"]
    posB, rotB = sideB["pos"], sideB["rot"]
    rA = v3sub(pts, vexpand(posA))
    rB = v3sub(pts, vexpand(posB))
    n4 = vexpand(contacts["normal"])

    MA = tuple(expand(c) for c in _sym_from_quat_ii(rotA, sideA["ii"]))
    MB = tuple(expand(c) for c in _sym_from_quat_ii(rotB, sideB["ii"]))
    imA4, imB4 = expand(sideA["im"]), expand(sideB["im"])
    imsum = imA4 + imB4

    cA = cross3(rA, n4)
    cB = cross3(rB, n4)
    uA = _sym_mv(MA, cA)
    uB = _sym_mv(MB, cB)
    wsum = imsum + dot3(cA, uA) + dot3(cB, uB)
    depth_vis = torch.clamp(depth, max=max_visible_depth)
    ok_w = pt_ok & (wsum > 1e-12)
    inv_w = 1.0 / torch.clamp(wsum, min=1e-12)
    dlam = torch.where(ok_w, depth * inv_w, 0.0) * relaxation
    dlam_vis = torch.where(ok_w, depth_vis * inv_w, 0.0) * relaxation
    bias_frac = torch.where(dlam > 1e-12, (dlam - dlam_vis) / torch.clamp(dlam, min=1e-12),
                            0.0)
    dxA = v3scale(n4, -dlam * imA4)
    dwA = v3scale(uA, -dlam)
    dxB = v3scale(n4, dlam * imB4)
    dwB = v3scale(uB, dlam)

    # static friction (physics.cpp:369-441)
    drift = vexpand(v3sub(v3sub(posB, sideB["prev_pos"]), v3sub(posA, sideA["prev_pos"])))
    tang = v3sub(drift, v3scale(n4, dot3(drift, n4)))
    tlen = norm3(tang)
    that = v3scale(tang, 1.0 / torch.clamp(tlen, min=1e-12))
    tA = cross3(rA, that)
    tB = cross3(rB, that)
    uA_t = _sym_mv(MA, tA)
    uB_t = _sym_mv(MB, tB)
    wsum_t = imsum + dot3(tA, uA_t) + dot3(tB, uB_t)
    mu_pair = expand(0.5 * (sideA["mu"] + sideB["mu"]))
    dlam_t = torch.where(pt_ok & (wsum_t > 1e-12) & (tlen < mu_pair * dlam),
                         tlen / torch.clamp(wsum_t, min=1e-12), 0.0) * relaxation
    dxA = v3add(dxA, v3scale(that, dlam_t * imA4))
    dwA = v3add(dwA, v3scale(uA_t, dlam_t))
    dxB = v3add(dxB, v3scale(that, -dlam_t * imB4))
    dwB = v3add(dwB, v3scale(uB_t, -dlam_t))

    def pack(dx, dw):
        def s(c):
            return _sum_points(torch.where(pt_ok, c, 0.0))
        return (s(dx[0]), s(dx[1]), s(dx[2]), s(dw[0]), s(dw[1]), s(dw[2]),
                s(dx[0] * bias_frac), s(dx[1] * bias_frac), s(dx[2] * bias_frac))

    return pack(dxA, dwA), pack(dxB, dwB), torch.where(pt_ok, dlam, 0.0)


def cache_contacts(contacts, PA, PB):
    """A pair_contacts manifold in body frames, for refresh_contacts: each
    point's anchor on A and on B, and the normal, rotated into the body's
    frame at the pair poses PA / PB (the fused kernel's contact refresh
    and persistent manifolds; JAX pairs.cache_contacts)."""
    pts = contacts["points"]                             # vec3 [W,P,K]
    qAc = (PA["rot"][0],) + tuple(-c for c in PA["rot"][1:])
    qBc = (PB["rot"][0],) + tuple(-c for c in PB["rot"][1:])
    rA = qrot(tuple(expand(c) for c in qAc), v3sub(pts, vexpand(PA["pos"])))
    rB = qrot(tuple(expand(c) for c in qBc), v3sub(pts, vexpand(PB["pos"])))
    return {"ok": contacts["ok"], "num_points": contacts["num_points"],
            "depth0": contacts["depth"], "rA": rA, "rB": rB,
            "n_loc": qrot(qAc, contacts["normal"])}


def refresh_contacts(cache, PA, PB):
    """A cache_contacts manifold at the pair poses PA / PB: each point the
    midpoint of its two anchors in world space, the normal rotated with A,
    the depth moved by the anchors' divergence along the normal (they
    coincide at the poses the cache was made at)."""
    pA = v3add(vexpand(PA["pos"]), qrot(tuple(expand(c) for c in PA["rot"]), cache["rA"]))
    pB = v3add(vexpand(PB["pos"]), qrot(tuple(expand(c) for c in PB["rot"]), cache["rB"]))
    n = qrot(PA["rot"], cache["n_loc"])
    depth = cache["depth0"] - dot3(vexpand(n), v3sub(pB, pA))
    return {"ok": cache["ok"], "normal": n, "points": v3scale(v3add(pA, pB), 0.5),
            "depth": depth, "num_points": cache["num_points"]}


def velocity_pass(sideA, sideB, contacts, lambda_n, h, restitution_threshold,
                  speculative: float = 0.0):
    """Per-pair velocity corrections: two Gauss-Seidel restitution sweeps
    over the manifold's points in closed form, then one sequential
    dynamic-friction pass, then (speculative > 0) the near-miss clamp —
    the JAX module's velocity_pass, term for term (see its docstring for
    the formulation).  sides carry v/w (post-position-solve) and, for
    restitution, pv/pw (post-integrate) and rest.  h and
    restitution_threshold [W, 1].  Returns (packA, packB): tuples of 6
    [W,K] velocity deltas (dv, dw)."""
    pts = contacts["points"]
    dep = contacts["depth"]
    pt_ok = expand(contacts["ok"]) & (dep > 0)
    n2 = contacts["normal"]
    posA, rotA = sideA["pos"], sideA["rot"]
    posB, rotB = sideB["pos"], sideB["rot"]
    imA, imB = sideA["im"], sideB["im"]
    mu2 = 0.5 * (sideA["mu"] + sideB["mu"])
    imsum = imA + imB
    MA = _sym_from_quat_ii(rotA, sideA["ii"])
    MB = _sym_from_quat_ii(rotB, sideB["ii"])
    P = dep.shape[1]

    rAs, rBs, okfs, cAs, cBs, uAs, uBs = [], [], [], [], [], [], []
    for i in range(P):
        p_i = tuple(c[:, i] for c in pts)
        rA = v3sub(p_i, posA)
        rB = v3sub(p_i, posB)
        cA = cross3(rA, n2)
        cB = cross3(rB, n2)
        rAs.append(rA)
        rBs.append(rB)
        okfs.append(pt_ok[:, i].to(torch.float32))
        cAs.append(cA)
        cBs.append(cB)
        uAs.append(_sym_mv(MA, cA))
        uBs.append(_sym_mv(MB, cB))

    def pvel(v, w, r):
        return v3add(v, cross3(w, r))

    Km = [[None] * P for _ in range(P)]
    for i in range(P):
        for j in range(i, P):
            Km[i][j] = Km[j][i] = imsum + dot3(cAs[i], uAs[j]) + dot3(cBs[i], uBs[j])
    A = [okfs[i] / torch.clamp(Km[i][i], min=1e-12) for i in range(P)]

    vA0, wA0 = sideA["v"], sideA["w"]
    vB0, wB0 = sideB["v"], sideB["w"]
    vns = [dot3(v3sub(pvel(vB0, wB0, rBs[i]), pvel(vA0, wA0, rAs[i])), n2) for i in range(P)]
    if "pv" in sideA:
        e_pair = 0.5 * (sideA["rest"] + sideB["rest"])
        targets = []
        for i in range(P):
            vb = dot3(v3sub(pvel(sideB["pv"], sideB["pw"], rBs[i]),
                            pvel(sideA["pv"], sideA["pw"], rAs[i])), n2)
            e = torch.where(torch.abs(vb) <= restitution_threshold, 0.0, e_pair)
            targets.append(torch.clamp(-e * vb, min=0.0))
    else:
        targets = [torch.zeros_like(mu2)] * P

    # ---- restitution: 2 Gauss-Seidel sweeps in closed form -----------------
    assert P <= 4, "closed-form GS restitution assumes <= 4 points"
    b = [targets[i] - vns[i] for i in range(P)]
    G = {(i, j): A[i] * Km[i][j] for i in range(1, P) for j in range(i)}
    M = [[None] * P for _ in range(P)]
    for i in range(P):
        M[i][i] = A[i]
    if P > 1:
        M[1][0] = -G[(1, 0)] * A[0]
    if P > 2:
        M[2][0] = (-G[(2, 0)] + G[(2, 1)] * G[(1, 0)]) * A[0]
        M[2][1] = -G[(2, 1)] * A[1]
    if P > 3:
        M[3][0] = (-G[(3, 0)] + G[(3, 1)] * G[(1, 0)] + G[(3, 2)] * G[(2, 0)]
                   - G[(3, 2)] * G[(2, 1)] * G[(1, 0)]) * A[0]
        M[3][1] = (-G[(3, 1)] + G[(3, 2)] * G[(2, 1)]) * A[1]
        M[3][2] = -G[(3, 2)] * A[2]

    def mvec_lower(x):
        out = []
        for i in range(P):
            acc = M[i][0] * x[0]
            for j in range(1, i + 1):
                acc = acc + M[i][j] * x[j]
            out.append(acc)
        return out

    d1 = mvec_lower(b)
    r = []
    for i in range(P):
        acc = Km[i][0] * d1[0]
        for j in range(1, P):
            acc = acc + Km[i][j] * d1[j]
        r.append(b[i] - acc)
    d2 = mvec_lower(r)
    lams = [d1[i] + d2[i] for i in range(P)]

    lam_sum = lams[0]
    swA = v3scale(uAs[0], lams[0])
    swB = v3scale(uBs[0], lams[0])
    for i in range(1, P):
        lam_sum = lam_sum + lams[i]
        swA = v3add(swA, v3scale(uAs[i], lams[i]))
        swB = v3add(swB, v3scale(uBs[i], lams[i]))
    vA = v3sub(vA0, v3scale(n2, imA * lam_sum))
    wA = v3sub(wA0, swA)
    vB = v3add(vB0, v3scale(n2, imB * lam_sum))
    wB = v3add(wB0, swB)

    # ---- dynamic friction: one sequential pass -----------------------------
    mu_h = mu2 / h
    for i in range(P):
        vpt = v3sub(pvel(vB, wB, rBs[i]), pvel(vA, wA, rAs[i]))
        vn = dot3(vpt, n2)
        vt = v3sub(vpt, v3scale(n2, vn))
        vt2 = dot3(vt, vt)
        inv_len = rsqrt(torch.clamp(vt2, min=1e-24))
        vt_len = vt2 * inv_len
        dyn_mag = mu_h * torch.abs(lambda_n[:, i])
        tA = cross3(rAs[i], vt)
        tB = cross3(rBs[i], vt)
        uA = _sym_mv(MA, tA)
        uB = _sym_mv(MB, tB)
        wsum = torch.clamp(imsum + (dot3(tA, uA) + dot3(tB, uB)) * inv_len * inv_len,
                           min=1e-12)
        s = torch.minimum(dyn_mag, vt_len) / wsum * inv_len
        s = torch.where((vt_len > 1e-9) & (dyn_mag > 0), s, 0.0) * okfs[i]
        vA = v3add(vA, v3scale(vt, s * imA))
        wA = v3add(wA, v3scale(uA, s))
        vB = v3sub(vB, v3scale(vt, s * imB))
        wB = v3sub(wB, v3scale(uB, s))

    # ---- speculative near-miss clamp (depth <= 0): per-point Jacobi --------
    if speculative > 0:
        okexp = expand(contacts["ok"]).expand(dep.shape)
        simp, s_oks = [], []
        for i in range(P):
            vn4 = dot3(v3sub(pvel(vB0, wB0, rBs[i]), pvel(vA0, wA0, rAs[i])), n2)
            uA_s = _sym_mv(MA, cAs[i])
            uB_s = _sym_mv(MB, cBs[i])
            wsum_n = torch.clamp(imsum + dot3(cAs[i], uA_s) + dot3(cBs[i], uB_s), min=1e-12)
            dv_spec = dep[:, i] / h - vn4
            s_ok = okexp[:, i] & (dep[:, i] <= 0) & (dv_spec > 0)
            simp.append(torch.where(s_ok, dv_spec / wsum_n, 0.0))
            s_oks.append(s_ok)
        npts = s_oks[0].to(torch.float32)
        for i in range(1, P):
            npts = npts + s_oks[i].to(torch.float32)
        inv_npts = 1.0 / torch.clamp(npts, min=1.0)
        stot = torch.zeros_like(mu2)
        twA = (torch.zeros_like(mu2),) * 3
        twB = (torch.zeros_like(mu2),) * 3
        for i in range(P):
            si = simp[i] * inv_npts
            stot = stot + si
            twA = v3add(twA, v3scale(_sym_mv(MA, cAs[i]), si))
            twB = v3add(twB, v3scale(_sym_mv(MB, cBs[i]), si))
        vA = v3sub(vA, v3scale(n2, imA * stot))
        wA = v3sub(wA, twA)
        vB = v3add(vB, v3scale(n2, imB * stot))
        wB = v3add(wB, twB)

    return (v3sub(vA, vA0) + v3sub(wA, wA0), v3sub(vB, vB0) + v3sub(wB, wB0))
