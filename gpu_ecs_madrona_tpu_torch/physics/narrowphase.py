"""Dense-grid narrowphase (PyTorch): batched SAT over a generic pair axis.

Counterpart of ``gpu_ecs_madrona_tpu/physics/narrowphase.py`` (reference
src/physics/narrowphase.cpp: the type dispatch :98-108, doSAT :663-727).
Every pair evaluates every primitive-pair kind with masked selects; the
core (``pair_contacts``) is leading-shape generic, and
``narrowphase_dense`` runs it over the i < j pairs of the [W, n, n] grid
of body pairs (the JAX module runs the whole grid, A fields broadcast
along axis 2 and B fields along axis 1; the other half only carries a
dead pair's values), which is the dense contact mode of the substep node.

Unlike physics/pairs.py (the compacted-pairs layout, a tuple of [W, K]
tensors per vec3), this module keeps the JAX module's component axis
([..., 3]).  Its dot products are written out in component order
(solver.py's ``_dot``), so that they round the same way on the CPU and
the card and for any number of worlds; its selections are gathers, where
the JAX module builds one-hot sums for the TPU (a gather gives the same
value).  Any hull is taken: there is no box fast path here, as in the JAX
module.

Output: the contact dict with leading pair shape L (i = ref body A, j =
other body B): ok [L] bool, normal [L, 3] (ref -> other), points
[L, 4, 3], depth [L, 4], num_points [L] int32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL, PRIM_PLANE, PRIM_SPHERE
from gpu_ecs_madrona_tpu_torch.physics.pairs import CLIP_EPS, CLIP_STRICT, CLIP_T_EPS, ObjTables
from gpu_ecs_madrona_tpu_torch.physics.solver import _dot, _norm3, to_grid, upper_pairs
from gpu_ecs_madrona_tpu_torch.utils import math as m

NEG_BIG = -1e9
BIG = 1e9
# small bias toward face axes for manifold stability (the JAX module's)
FACE_BIAS = 1.001


def _sel_vec(table, idx):
    """table [..., R, D] at row ``idx`` [...] -> [..., D]."""
    return torch.take_along_dim(table, idx[..., None, None], dim=-2).squeeze(-2)


def _sel_scalar(table, idx):
    """table [..., R] at ``idx`` [...] -> [...]."""
    return torch.take_along_dim(table, idx[..., None], dim=-1).squeeze(-1)


def _top4(dep, pts):
    """The four deepest entries and their points: four rounds of a max and
    its first occurrence (lax.top_k's lower-index tie-break; the first is
    argmax's, not a scan's, which is slow along a short last axis on the
    card).  dep [..., K], pts [..., K, 3] -> ([..., 4, 3], [..., 4])."""
    outs_p, outs_d = [], []
    cur = dep
    slots = torch.arange(dep.shape[-1], device=dep.device)
    for _ in range(4):
        mx = cur.amax(dim=-1)
        oh = cur == mx[..., None]
        first = oh & (slots == oh.to(torch.uint8).argmax(dim=-1, keepdim=True))
        outs_p.append(torch.where(first[..., None], pts, 0.0).sum(dim=-2))
        outs_d.append(mx)
        cur = torch.where(first, -BIG, cur)
    return torch.stack(outs_p, dim=-2), torch.stack(outs_d, dim=-1)


def tables_of(object_manager) -> ObjTables:
    """The object manager as ObjTables (given one, itself).  The manifold
    needs the face clipping tables of physics/assets.py's PhysicsLoader
    (the JAX module's deepest-verts stand-in for managers without them is
    not ported)."""
    tables = object_manager if isinstance(object_manager, ObjTables) \
        else ObjTables(object_manager)
    if "face_side_n" not in tables.om:
        raise ValueError("the dense narrowphase needs the face clipping tables "
                         "(physics/assets.py PhysicsLoader)")
    return tables


def _clip_manifold(tables: ObjTables, A, B, use_faceB, nrm_inc, L, bc):
    """The exact incident-face clip manifold (JAX ``_clip_manifold_aos``):
    the order-free Sutherland-Hodgman candidates of pairs._clip_face_manifold
    (incident edges clipped to the reference side planes, reference verts
    strictly inside the incident side planes projected onto the incident
    face), the face polygons and side planes gathered by flat (object,
    face) index.  Returns (pts [*L, 4, 3], dep [*L, 4])."""
    dev = nrm_inc.device
    Fm = A["fnorm_w"].shape[-2]
    fv = tables.tab("face_verts", dev)
    O, FVe = fv.shape[0], fv.shape[2]
    sB1 = use_faceB[..., None]
    sB2 = use_faceB[..., None, None]

    pos_ref = torch.where(sB1, B["pos"], A["pos"])
    pos_inc = torch.where(sB1, A["pos"], B["pos"])
    rot_ref = torch.where(sB1, B["rot"], A["rot"])
    rot_inc = torch.where(sB1, A["rot"], B["rot"])
    obj_ref = torch.where(use_faceB, B["obj_id"], A["obj_id"])
    obj_inc = torch.where(use_faceB, A["obj_id"], B["obj_id"])
    fnR = torch.where(sB2, bc(B["fnorm_w"], 2), bc(A["fnorm_w"], 2))
    fnI = torch.where(sB2, bc(A["fnorm_w"], 2), bc(B["fnorm_w"], 2))
    fdR = torch.where(sB1, bc(B["face_dw"], 1), bc(A["face_dw"], 1))
    fdI = torch.where(sB1, bc(A["face_dw"], 1), bc(B["face_dw"], 1))
    fmR = torch.where(sB1, bc(B["fmask"], 1), bc(A["fmask"], 1))
    fmI = torch.where(sB1, bc(A["fmask"], 1), bc(B["fmask"], 1))

    # reference face: most aligned with the contact axis; incident face:
    # most anti-aligned
    nrm_e = nrm_inc[..., None, :]
    idxR = torch.where(fmR, _dot(fnR, nrm_e), NEG_BIG).argmax(dim=-1)
    idxI = torch.where(fmI, _dot(fnI, nrm_e), BIG).argmin(dim=-1)
    n_reff = _sel_vec(fnR, idxR)
    d_reff = _sel_scalar(fdR, idxR)
    n_incf = _sel_vec(fnI, idxI)
    d_incf = _sel_scalar(fdI, idxI)

    def rows(key, width=3):
        t = tables.tab(key, dev)
        return t.reshape((O * Fm, FVe) + ((width,) if width else ()))

    fvert, fnext, fsn = rows("face_verts"), rows("face_verts_next"), rows("face_side_n")
    fsd, fsv = rows("face_side_d", 0), rows("face_slot_valid", 0)
    gR = obj_ref * Fm + idxR
    gI = obj_inc * Fm + idxI

    rotI_e, rotR_e = rot_inc[..., None, :], rot_ref[..., None, :]
    posI_e, posR_e = pos_inc[..., None, :], pos_ref[..., None, :]
    polyI = m.quat_rotate(rotI_e, fvert[gI]) + posI_e
    polyIn = m.quat_rotate(rotI_e, fnext[gI]) + posI_e
    polyR = m.quat_rotate(rotR_e, fvert[gR]) + posR_e
    svalI = fsv[gI] > 0.5
    svalR = fsv[gR] > 0.5
    snR = m.quat_rotate(rotR_e, fsn[gR])
    sdR = fsd[gR] + _dot(snR, posR_e)
    snI = m.quat_rotate(rotI_e, fsn[gI])
    sdI = fsd[gI] + _dot(snI, posI_e)

    def plane_dist(pts, sn, sd):
        """[*L, v, 3] points against [*L, p] planes -> [*L, v, p]."""
        return _dot(pts[..., :, None, :], sn[..., None, :, :]) - sd[..., None, :]

    # set 1: incident edges interval-clipped against the reference side
    # planes; the clipped segment's START covers verts inside and entering
    # crossings, its END only where strictly clipped
    dI0 = plane_dist(polyI, snR, sdR)
    dI1 = plane_dist(polyIn, snR, sdR)
    pvalR = svalR[..., None, :]
    denom = dI0 - dI1
    crossing = denom.abs() > 1e-12
    tc = dI0 / torch.where(crossing, denom, 1.0)
    ent = pvalR & crossing & (dI0 > 0) & (dI1 <= 0)
    ext = pvalR & crossing & (dI0 <= 0) & (dI1 > 0)
    t_lo = torch.where(ent, tc, 0.0).amax(dim=-1)
    t_hi = torch.where(ext, tc, 1.0).amin(dim=-1)
    empty = (pvalR & (dI0 > CLIP_EPS) & (dI1 > CLIP_EPS)).any(dim=-1)
    edge_ok = svalI & ~empty & (t_lo <= t_hi + 1e-9)
    seg = polyIn - polyI
    pt_lo = polyI + t_lo[..., None] * seg
    pt_hi = polyI + t_hi[..., None] * seg
    n_reff_e = n_reff[..., None, :]
    dep_lo = d_reff[..., None] - _dot(pt_lo, n_reff_e)
    dep_hi = d_reff[..., None] - _dot(pt_hi, n_reff_e)
    dep_lo = torch.where(edge_ok, dep_lo, -BIG)
    dep_hi = torch.where(edge_ok & (t_hi < 1.0 - CLIP_T_EPS), dep_hi, -BIG)

    # set 2: reference verts strictly inside the incident side planes,
    # projected onto the incident face along the contact axis
    dRp = plane_dist(polyR, snI, sdI)
    inside3 = ((dRp <= -CLIP_STRICT) | ~svalI[..., None, :]).all(dim=-1) & svalR
    den = _dot(n_incf, nrm_inc)
    den_ok = den.abs() > 0.1
    s = (d_incf[..., None] - _dot(polyR, n_incf[..., None, :])) \
        / torch.where(den_ok, den, 1.0)[..., None]
    q = polyR + s[..., None] * nrm_e
    dep3 = d_reff[..., None] - _dot(q, n_reff_e)
    dep3 = torch.where(inside3 & den_ok[..., None], dep3, -BIG)

    pts = torch.cat([pt_lo, pt_hi, q], dim=-2)
    dep = torch.cat([dep_lo, dep_hi, dep3], dim=-1)
    return _top4(dep, pts)


def body_fields(pos, rot, obj_id, tables: ObjTables) -> Dict[str, Any]:
    """Per-body world-space collision fields (the data a reference
    CollisionPrimitive carries, physics.hpp:245-264).  pos [*L, 3], rot
    [*L, 4] (w, x, y, z), obj_id [*L] int; returns a dict of tensors with
    leading *L."""
    dev = pos.device
    o = obj_id.long()

    def tab(key):
        return tables.tab(key, dev)[o]

    verts_l, fnorm_l, edir_l = tab("verts"), tab("face_normals"), tab("edge_dirs")
    ep0_l, ep1_l = tab("edge_p0"), tab("edge_p1")

    def count_mask(rows, key):
        return torch.arange(rows.shape[-2], device=dev) < tab(key)[..., None]

    rot_e, pos_e = rot[..., None, :], pos[..., None, :]
    fnorm_w = m.quat_rotate(rot_e, fnorm_l)
    # plane primitives: world normal and offset of the z = 0 object plane
    zup = torch.zeros_like(pos)
    zup[..., 2] = 1.0
    plane_n = m.quat_rotate(rot, zup)
    return {
        "pos": pos, "rot": rot, "obj_id": o,
        "ptype": tab("prim_type"), "radius": tab("sphere_radius"),
        "verts_w": m.quat_rotate(rot_e, verts_l) + pos_e,
        "vmask": count_mask(verts_l, "num_verts"),
        # rotated and translated face planes: d_w = face_d + n_w . pos
        "fnorm_w": fnorm_w, "face_dw": tab("face_d") + _dot(fnorm_w, pos_e),
        "fmask": count_mask(fnorm_l, "num_faces"),
        "edir_w": m.quat_rotate(rot_e, edir_l), "emask": count_mask(edir_l, "num_edges"),
        "edge_p0_w": m.quat_rotate(rot_e, ep0_l) + pos_e,
        "edge_p1_w": m.quat_rotate(rot_e, ep1_l) + pos_e,
        "efmask": count_mask(ep0_l, "num_full_edges"),
        "plane_n": plane_n, "plane_d": _dot(plane_n, pos),
        "is_box": (tab("hull_is_box") > 0 if "hull_is_box" in tables.om
                   else torch.zeros_like(o, dtype=torch.bool)),
        "box_half": (tab("box_half") if "box_half" in tables.om else torch.zeros_like(pos)),
    }


def pair_contacts(A: Dict[str, Any], B: Dict[str, Any], pair_live: torch.Tensor,
                  tables: ObjTables, speculative: float = 0.0) -> Dict[str, Any]:
    """Contacts for body pairs (A = ref, B = other).  A/B: ``body_fields``
    dicts whose leading shapes broadcast to ``pair_live.shape`` (L).
    speculative: the near-miss margin of speculative contacts."""
    L = tuple(pair_live.shape)
    dev = pair_live.device

    def bc(x, trailing: int):
        return x.expand(L + tuple(x.shape[x.dim() - trailing:]))

    is_sphereA, is_sphereB = A["ptype"] == PRIM_SPHERE, B["ptype"] == PRIM_SPHERE
    is_hullA, is_hullB = A["ptype"] == PRIM_HULL, B["ptype"] == PRIM_HULL
    is_planeA, is_planeB = A["ptype"] == PRIM_PLANE, B["ptype"] == PRIM_PLANE

    out = {"normal": torch.zeros(L + (3,), device=dev),
           "points": torch.zeros(L + (4, 3), device=dev),
           "depth": torch.full(L + (4,), -BIG, device=dev),
           "num_points": torch.zeros(L, dtype=torch.int32, device=dev),
           "ok": torch.zeros(L, dtype=torch.bool, device=dev)}

    def merge(sel, ok, normal, points, depth, num_points):
        sel = sel & pair_live
        out["ok"] = torch.where(sel, sel & ok, out["ok"])
        out["normal"] = torch.where(sel[..., None], normal, out["normal"])
        out["points"] = torch.where(sel[..., None, None], points, out["points"])
        out["depth"] = torch.where(sel[..., None], depth, out["depth"])
        out["num_points"] = torch.where(sel, num_points, out["num_points"])

    posA, posB = A["pos"], B["pos"]
    radA, radB = A["radius"], B["radius"]
    slot0 = torch.arange(4, device=dev) == 0

    def one_point(pt, pen):
        pts = torch.where(slot0[:, None], bc(pt, 1)[..., None, :], 0.0)
        dep = torch.where(slot0, bc(pen, 0)[..., None], -BIG)
        return pts, dep

    ones_np = torch.ones(L, dtype=torch.int32, device=dev)

    # ---------------- sphere - sphere --------------------------------------
    d = posB - posA
    dist = torch.sqrt(torch.clamp(_dot(d, d), min=1e-18))
    nrm = d / dist[..., None]
    pen = (radA + radB) - dist
    mid = posA + nrm * (radA - 0.5 * pen)[..., None]
    pts, dep = one_point(mid, pen)
    merge(is_sphereA & is_sphereB, pen > -speculative, nrm, pts, dep, ones_np)

    # ---------------- sphere - plane (either order) -------------------------
    def sphere_plane(s_pos, s_rad, p_n, p_d, flip):
        c_dist = _dot(s_pos, p_n) - p_d
        pen = s_rad - c_dist
        contact = s_pos - p_n * c_dist[..., None]
        nrm_sp = bc(p_n if flip else -p_n, 1)            # ref -> other
        pts, dep = one_point(contact, pen)
        return pen > -speculative, nrm_sp, pts, dep

    ok_sp, n_sp, p_sp, d_sp = sphere_plane(posA, radA, B["plane_n"], B["plane_d"], False)
    merge(is_sphereA & is_planeB, ok_sp, n_sp, p_sp, d_sp, ones_np)
    ok_ps, n_ps, p_ps, d_ps = sphere_plane(posB, radB, A["plane_n"], A["plane_d"], True)
    merge(is_planeA & is_sphereB, ok_ps, n_ps, p_ps, d_ps, ones_np)

    # ---------------- hull - plane (either order) ---------------------------
    def hull_plane(h_verts_w, h_vmask, p_n, p_d, flip):
        vd = _dot(h_verts_w, p_n[..., None, :]) - p_d[..., None]
        vd = torch.where(h_vmask, vd, BIG)
        pts, top_pen = _top4(bc(-vd, 1), bc(h_verts_w, 2))
        num_pts = (top_pen > -speculative).to(torch.int32).sum(dim=-1, dtype=torch.int32)
        nrm_hp = bc(p_n if flip else -p_n, 1)            # ref(hull) -> other(plane)
        return num_pts > 0, nrm_hp, pts, top_pen, num_pts

    ok_hp, n_hp, p_hp, d_hp, np_hp = hull_plane(A["verts_w"], A["vmask"], B["plane_n"],
                                                B["plane_d"], False)
    merge(is_hullA & is_planeB, ok_hp, n_hp, p_hp, d_hp, np_hp)
    ok_ph, n_ph, p_ph, d_ph, np_ph = hull_plane(B["verts_w"], B["vmask"], A["plane_n"],
                                                A["plane_d"], True)
    merge(is_planeA & is_hullB, ok_ph, n_ph, p_ph, d_ph, np_ph)

    # ---------------- sphere - hull (either order) --------------------------
    def sphere_hull(s_pos, s_rad, h_fn_w, h_fd_w, h_fmask, flip):
        # the centre's largest face distance: its signed distance to the
        # hull (exact outside near a face, approximate at edges)
        cd = _dot(s_pos[..., None, :], h_fn_w) - h_fd_w
        cd = torch.where(h_fmask, cd, NEG_BIG)
        fdist, fidx = cd.amax(dim=-1), cd.argmax(dim=-1)
        fn = _sel_vec(bc(h_fn_w, 2), bc(fidx, 0))
        pen = s_rad - fdist
        contact = s_pos - fn * fdist[..., None]
        pts, dep = one_point(contact, pen)
        return pen > -speculative, fn if flip else -fn, pts, dep

    def sphere_box(s_pos, s_rad, b_pos, b_rot, b_half, flip):
        """Analytic sphere-box: the centre clamped into the box frame."""
        d_l = m.quat_inv_rotate(b_rot, s_pos - b_pos)
        q = torch.minimum(torch.maximum(d_l, -b_half), b_half)
        inside = (d_l.abs() < b_half).all(dim=-1)
        closest_w = m.quat_rotate(b_rot, q) + b_pos
        delta = s_pos - closest_w
        dist = torch.sqrt(_dot(delta, delta) + 1e-18)
        n_out = delta / dist[..., None]
        fdist = b_half - d_l.abs()
        oh = torch.nn.functional.one_hot(fdist.argmin(dim=-1), 3).to(fdist.dtype)
        n_in = m.quat_rotate(b_rot, oh * torch.where(d_l >= 0, 1.0, -1.0))
        pen_in = s_rad + fdist.amin(dim=-1)
        nrm_bs = torch.where(inside[..., None], n_in, n_out)       # box -> sphere
        pen = torch.where(inside, pen_in, s_rad - dist)
        pts, dep = one_point(closest_w, pen)
        return pen > -speculative, nrm_bs if flip else -nrm_bs, pts, dep

    def sphere_hull_or_box(s_pos, s_rad, H, flip):
        ok_f, n_f, p_f, d_f = sphere_hull(s_pos, s_rad, H["fnorm_w"], H["face_dw"],
                                          H["fmask"], flip)
        ok_b, n_b, p_b, d_b = sphere_box(s_pos, s_rad, H["pos"], H["rot"], H["box_half"], flip)
        isb = bc(H["is_box"], 0)
        return (torch.where(isb, ok_b, ok_f),
                torch.where(isb[..., None], bc(n_b, 1), bc(n_f, 1)),
                torch.where(isb[..., None, None], p_b, p_f),
                torch.where(isb[..., None], d_b, d_f))

    ok_sh, n_sh, p_sh, d_sh = sphere_hull_or_box(posA, radA, B, False)
    merge(is_sphereA & is_hullB, ok_sh, n_sh, p_sh, d_sh, ones_np)
    ok_hs, n_hs, p_hs, d_hs = sphere_hull_or_box(posB, radB, A, True)
    merge(is_hullA & is_sphereB, ok_hs, n_hs, p_hs, d_hs, ones_np)

    # ---------------- hull - hull: SAT (narrowphase.cpp doSAT) --------------
    both_hull = is_hullA & is_hullB & pair_live

    def axis_penetration(axes_w, axes_valid):
        """Penetration of the pair along world axes [*L, K, 3] -> [*L, K]
        (+BIG where invalid): max/min projections of the world verts."""
        def proj(verts_w):
            return _dot(axes_w[..., :, None, :], verts_w[..., None, :, :])
        projA, projB = proj(A["verts_w"]), proj(B["verts_w"])
        vmA, vmB = A["vmask"][..., None, :], B["vmask"][..., None, :]
        maxA = torch.where(vmA, projA, NEG_BIG).amax(dim=-1)
        minA = torch.where(vmA, projA, BIG).amin(dim=-1)
        maxB = torch.where(vmB, projB, NEG_BIG).amax(dim=-1)
        minB = torch.where(vmB, projB, BIG).amin(dim=-1)
        pen = torch.minimum(maxA - minB, maxB - minA)     # positive = penetrating
        return torch.where(axes_valid, pen, BIG)

    # candidate axes: A's faces, B's faces, edge A x edge B
    Em = A["edir_w"].shape[-2]
    cross = torch.linalg.cross(A["edir_w"][..., :, None, :], B["edir_w"][..., None, :, :],
                               dim=-1)
    cross = cross.reshape(L + (Em * Em, 3))
    clen = _norm3(cross)[..., None]
    cvalid = (clen[..., 0] > 1e-6) & (
        A["emask"][..., :, None] & B["emask"][..., None, :]).reshape(L + (Em * Em,))
    cross = cross / torch.clamp(clen, min=1e-12)

    axesA, axesB = A["fnorm_w"], B["fnorm_w"]
    penA = axis_penetration(axesA, A["fmask"])
    penB = axis_penetration(axesB, B["fmask"])
    penE = axis_penetration(cross, cvalid)
    minA_, idxA_ = bc(penA.amin(dim=-1), 0), bc(penA.argmin(dim=-1), 0)
    minB_, idxB_ = bc(penB.amin(dim=-1), 0), bc(penB.argmin(dim=-1), 0)
    minE_, idxE_ = penE.amin(dim=-1), penE.argmin(dim=-1)

    sat_pen = torch.minimum(torch.minimum(minA_, minB_), minE_)
    hit = both_hull & (sat_pen > -speculative) & (sat_pen < BIG * 0.5)
    use_faceA = minA_ <= torch.minimum(minB_, minE_) * FACE_BIAS + 1e-6
    use_faceB = ~use_faceA & (minB_ <= minE_ * FACE_BIAS + 1e-6)
    use_edge = ~(use_faceA | use_faceB)

    # the winning axis, oriented ref(A) -> other(B)
    fA = _sel_vec(bc(axesA, 2), idxA_)
    fB = _sel_vec(bc(axesB, 2), idxB_)
    fE = _sel_vec(bc(cross, 2), idxE_)
    ab = posB - posA

    def sgn(v):
        return torch.where(_dot(v, ab)[..., None] >= 0, 1.0, -1.0)

    sat_normal = torch.where(use_faceA[..., None], fA * sgn(fA),
                             torch.where(use_faceB[..., None], fB * sgn(fB), fE * sgn(fE)))

    # the manifold: the incident face clipped against the reference face's
    # side planes
    nrm_inc = torch.where(use_faceB[..., None], -sat_normal, sat_normal)
    pts_sat, depth_sat = _clip_manifold(tables, A, B, use_faceB, nrm_inc, L, bc)

    # edge-edge: one contact at the closest points of the supporting edges
    # (the full edge whose lower-projecting endpoint is highest along the
    # support direction)
    def support_edge(F, n_dir):
        p0, p1 = F["edge_p0_w"], F["edge_p1_w"]
        s0 = _dot(p0, n_dir[..., None, :])
        s1 = _dot(p1, n_dir[..., None, :])
        idx = torch.where(F["efmask"], torch.minimum(s0, s1), NEG_BIG).argmax(dim=-1)
        return _sel_vec(bc(p0, 2), idx), _sel_vec(bc(p1, 2), idx)

    a0, a1 = support_edge(A, sat_normal)
    b0, b1 = support_edge(B, -sat_normal)
    d1v, d2v, rv = a1 - a0, b1 - b0, a0 - b0
    a_, e_ = _dot(d1v, d1v), _dot(d2v, d2v)
    f_, c_, b_ = _dot(d2v, rv), _dot(d1v, rv), _dot(d1v, d2v)
    denom = a_ * e_ - b_ * b_
    big_denom = denom.abs() > 1e-12
    s_ = torch.clamp(torch.where(big_denom, (b_ * f_ - c_ * e_)
                                 / torch.where(big_denom, denom, 1.0), 0.0), 0.0, 1.0)
    t_ = torch.clamp((b_ * s_ + f_) / torch.clamp(e_, min=1e-12), 0.0, 1.0)
    s_ = torch.clamp((b_ * t_ - c_) / torch.clamp(a_, min=1e-12), 0.0, 1.0)
    edge_pt = 0.5 * ((a0 + d1v * s_[..., None]) + (b0 + d2v * t_[..., None]))

    ue = use_edge[..., None]
    depth_sat = torch.where(ue, torch.where(slot0, sat_pen[..., None], -BIG), depth_sat)
    pts_sat = torch.where(ue[..., None], torch.where(slot0[:, None], edge_pt[..., None, :], 0.0),
                          pts_sat)
    num_sat = (depth_sat > -speculative).to(torch.int32).sum(dim=-1, dtype=torch.int32)
    merge(both_hull, hit, sat_normal, pts_sat, depth_sat, num_sat)
    return out


def narrowphase_dense(pos, rot, obj_id, row_mask, object_manager,
                      speculative: float = 0.0) -> Dict[str, Any]:
    """The dense [W, n, n] all-pairs narrowphase (i = ref body, j = other;
    only i < j pairs of live rows are valid).  pos [W, n, 3], rot [W, n, 4],
    obj_id [W, n] int, row_mask [W, n] bool; ``object_manager``: the
    object manager dict or its ObjTables.  The pair math runs over the
    i < j pairs only (the fields of both sides gathered to them); the
    other pairs of the grid carry pair_contacts' values for a dead pair,
    as on the JAX package's full grid."""
    tables = tables_of(object_manager)
    n = obj_id.shape[1]
    iu, ju, flat = upper_pairs(n, pos.device)
    F = body_fields(pos, rot, obj_id, tables)
    A = {k: v[:, iu] for k, v in F.items()}
    B = {k: v[:, ju] for k, v in F.items()}
    c = pair_contacts(A, B, row_mask[:, iu] & row_mask[:, ju], tables, speculative=speculative)
    return {"ok": to_grid(c["ok"], flat, n, False), "normal": to_grid(c["normal"], flat, n),
            "points": to_grid(c["points"], flat, n), "depth": to_grid(c["depth"], flat, n, -BIG),
            "num_points": to_grid(c["num_points"], flat, n, 0)}
