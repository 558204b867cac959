"""XPBD rigid-body solver (PyTorch), batched and Jacobi-accumulated.

Counterpart of ``gpu_ecs_madrona_tpu/physics/solver.py``: ``integrate``
(reference substepRigidBodies, physics.cpp:79-164), ``_apply_rot_delta``,
``set_velocities`` (setVelocities, physics.cpp:673-714), the dense
contact grid's ``solve_positions`` (solvePositions, physics.cpp:166-461)
and ``solve_velocities`` (solveVelocities, physics.cpp:716-1009) over the
leading-shape generic ``_positional_contact_math`` and
``_velocity_contact_math``, and ``solve_joints`` (handleJointConstraint,
physics.cpp:478-650).  The compacted-pairs contact math is
physics/pairs.py.

Every sum here adds in one fixed order, the same on every device and for
every world count: 3-vectors in component order (``_sum3``), the dense
grid's per-body sums by ``grid_sums`` (a fixed halving tree of
elementwise adds), the joints by an ordered segment sum.  So a step
repeats bit for bit on the card, and a block of worlds gives what the
whole batch gives.
"""

from __future__ import annotations

import torch

from gpu_ecs_madrona_tpu_torch.core.state import batched_gather
from gpu_ecs_madrona_tpu_torch.utils import math as m


def integrate(pos, rot, vel_lin, vel_ang, inv_mass, inv_inertia, ext_f, ext_t,
              response_dynamic, h, gravity):
    """Semi-implicit Euler substep with the gyroscopic term.  Returns new
    (pos, rot, vel_lin, vel_ang) plus the prev stash (pos, rot).  All args
    lead with [W, n]; h [W], gravity [W, 3]."""
    prev_pos, prev_rot = pos, rot
    h = h.reshape(h.shape[0], 1, 1)
    dyn = (response_dynamic & (inv_mass > 0))[..., None]
    v = vel_lin + h * (gravity[:, None, :] + ext_f * inv_mass[..., None])
    v = torch.where(dyn, v, vel_lin)
    new_pos = torch.where(dyn, pos + h * v, pos)

    # omega += h * invI * (tau - omega x (I omega)), in the body frame
    inertia = torch.where(inv_inertia > 0, 1.0 / torch.clamp(inv_inertia, min=1e-12), 0.0)
    omega_b = m.quat_inv_rotate(rot, vel_ang)
    gyro_b = torch.linalg.cross(omega_b, inertia * omega_b, dim=-1)
    tau_b = m.quat_inv_rotate(rot, ext_t)
    omega_b = omega_b + h * inv_inertia * (tau_b - gyro_b)
    w = torch.where(dyn, m.quat_rotate(rot, omega_b), vel_ang)
    new_rot = torch.where(dyn, m.quat_integrate(rot, w, h), rot)
    return new_pos, new_rot, v, w, prev_pos, prev_rot


def _apply_rot_delta(rot, dw):
    """Accumulated rotation vector -> quaternion delta (physics.cpp:247-268)."""
    return m.quat_normalize(
        rot + 0.5 * m.quat_mul(torch.cat([torch.zeros_like(dw[..., :1]), dw], dim=-1), rot))


def set_velocities(pos, rot, prev_pos, prev_rot, h, bias_dpos=None):
    """Finite-difference velocity recovery.  bias_dpos (the deep-
    depenetration share of the positional correction) is excluded so it
    does not turn into velocity."""
    h = h.reshape(h.shape[0], 1, 1)
    if bias_dpos is None:
        bias_dpos = torch.zeros_like(pos)
    v = (pos - prev_pos - bias_dpos) / h
    dq = m.quat_mul(rot, torch.cat([prev_rot[..., 0:1], -prev_rot[..., 1:4]], dim=-1))
    omega = 2.0 * dq[..., 1:4] / h
    omega = torch.where(dq[..., 0:1] >= 0, omega, -omega)
    return v, omega


def _sum3(x):
    """The sum over the last axis of 3, in component order ((x0 + x1) + x2),
    as the kernels add it: a reduction's order on the card is not fixed."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _norm3(x):
    """|x| over the last axis of 3, its squares added in component order."""
    return torch.sqrt(_sum3(x * x))


def _dot(a, b):
    """a . b over the last axis of 3 (broadcast), its products added in
    component order (``_sum3(a * b)`` without the [..., 3] product)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ordered_sum(x, dim):
    """The sum of x over ``dim`` in a fixed order: halves added
    elementwise until one slice is left (an odd last slice carried
    along).  Elementwise adds round alike on every device and whatever
    the other dimensions, where a reduction's order is not fixed."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if x.shape[dim] % 2:
            head = torch.cat([head, x.narrow(dim, 2 * h, 1)], dim)
        x = head
    return x.squeeze(dim)


def grid_sums(valsA, valsB):
    """Per-body sums of a dense grid's per-pair values [W, n, n, (P,) C]:
    body k collects row k as the reference side (valsA) plus column k as
    the other side (valsB), each over its points first -> [W, n, C]."""
    if valsA.dim() == 5:
        valsA, valsB = ordered_sum(valsA, 3), ordered_sum(valsB, 3)
    return ordered_sum(valsA, 2) + ordered_sum(valsB, 1)


def _generalized_inv_mass(r, nrm, inv_mass, inv_inertia, rot):
    """w = 1/m + (r x n)^T I^-1 (r x n) (physics.cpp:215-231); the inertia
    diagonal is in the body frame."""
    rxn_b = m.quat_inv_rotate(rot, torch.linalg.cross(r, nrm, dim=-1))
    return inv_mass + _sum3(rxn_b * inv_inertia * rxn_b)


def _apply_impulse_terms(p, r, inv_mass, inv_inertia, rot):
    """Positional impulse p at offset r -> (dx, rotation update vector
    I^-1 (r x p)) (physics.cpp:247-268)."""
    rxp_b = m.quat_inv_rotate(rot, torch.linalg.cross(r, p, dim=-1))
    return p * inv_mass[..., None], m.quat_rotate(rot, inv_inertia * rxp_b)


def _positional_contact_math(posA, rotA, imA, iiA, muA, prevA, posB, rotB, imB, iiB, muB,
                             prevB, contacts, relaxation=1.0, max_visible_depth=0.05):
    """Per-contact positional impulses (reference solvePositions,
    physics.cpp:166-461), leading-shape generic: per-side args lead with
    the pair shape *L (pos [*L, 3], rot [*L, 4], im [*L], ii [*L, 3], mu
    [*L], prev pos [*L, 3]); contacts leads with *L (normal A -> B).

    Depths are solved with zero compliance; static friction corrects the
    contact points' tangential drift since the substep start, clamped by
    mu_s.  Corrections deeper than max_visible_depth are position bias:
    applied, but left out of the velocity recovery.  Returns (dxA, dwA,
    dxB, dwB [*L, 4, 3], zero on dead points; dlam [*L, 4]; bias_frac
    [*L, 4]; pt_ok [*L, 4])."""
    ok, nrm, pts, depth = contacts["ok"], contacts["normal"], contacts["points"], \
        contacts["depth"]
    pt_ok = ok[..., None] & (depth > 0) & (
        torch.arange(4, device=depth.device) < contacts["num_points"][..., None])
    imA4, imB4 = imA[..., None], imB[..., None]
    iiA4, iiB4 = iiA[..., None, :], iiB[..., None, :]
    rotA4, rotB4 = rotA[..., None, :], rotB[..., None, :]
    rA = pts - posA[..., None, :]
    rB = pts - posB[..., None, :]
    n4 = nrm[..., None, :].expand(rA.shape)

    wsum = (_generalized_inv_mass(rA, n4, imA4, iiA4, rotA4)
            + _generalized_inv_mass(rB, n4, imB4, iiB4, rotB4))
    # XPBD: dlambda = -C / (w1 + w2), C = -depth
    live = pt_ok & (wsum > 1e-12)
    wsum_c = torch.clamp(wsum, min=1e-12)
    dlam = torch.where(live, depth / wsum_c, 0.0) * relaxation
    dlam_vis = torch.where(live, torch.clamp(depth, max=max_visible_depth) / wsum_c,
                           0.0) * relaxation
    bias_frac = torch.where(dlam > 1e-12, (dlam - dlam_vis) / torch.clamp(dlam, min=1e-12),
                            0.0)
    p = dlam[..., None] * n4
    # the normal points A -> B: A pushed back, B forward
    dxA, dwA = _apply_impulse_terms(-p, rA, imA4, iiA4, rotA4)
    dxB, dwB = _apply_impulse_terms(p, rB, imB4, iiB4, rotB4)

    # static friction (physics.cpp:369-441): the relative drift of the two
    # frames at the contact over this substep, clamped by mu_s lambda_n
    drift = (posB - prevB)[..., None, :] - (posA - prevA)[..., None, :]
    tang = drift - _dot(drift, n4)[..., None] * n4
    tlen = _norm3(tang)
    that = (tang / torch.clamp(tlen[..., None], min=1e-12)).expand(rA.shape)
    wsum_t = (_generalized_inv_mass(rA, that, imA4, iiA4, rotA4)
              + _generalized_inv_mass(rB, that, imB4, iiB4, rotB4))
    mu_pair = (0.5 * (muA + muB))[..., None]
    dlam_t = torch.where(pt_ok & (wsum_t > 1e-12) & (tlen < mu_pair * dlam),
                         tlen / torch.clamp(wsum_t, min=1e-12), 0.0) * relaxation
    pt = dlam_t[..., None] * that
    fxA, fwA = _apply_impulse_terms(pt, rA, imA4, iiA4, rotA4)
    fxB, fwB = _apply_impulse_terms(-pt, rB, imB4, iiB4, rotB4)

    # dead points zeroed here: a sum must never see the NaNs a garbage
    # pair can make (0 * NaN = NaN)
    m4 = pt_ok[..., None]
    return (torch.where(m4, dxA + fxA, 0.0), torch.where(m4, dwA + fwA, 0.0),
            torch.where(m4, dxB + fxB, 0.0), torch.where(m4, dwB + fwB, 0.0),
            torch.where(pt_ok, dlam, 0.0), bias_frac, pt_ok)


def upper_pairs(n, device):
    """The dense grid's i < j pairs in row-major order: (i, j, i * n + j),
    each [n (n - 1) / 2] int64."""
    iu, ju = torch.triu_indices(n, n, 1, device=device)
    return iu, ju, iu * n + ju


def to_grid(x, flat, n, fill=0.0):
    """Values [W, P, ...] at the grid's i < j pairs (flat indices
    ``flat``) -> [W, n, n, ...], ``fill`` elsewhere."""
    W = x.shape[0]
    out = torch.full((W, n * n) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
    out[:, flat] = x
    return out.reshape((W, n, n) + tuple(x.shape[2:]))


def _upper_contacts(contacts, flat):
    """A dense contact grid's i < j pairs: every leaf [W, n, n, ...] ->
    [W, P, ...]."""
    return {k: v.reshape((v.shape[0], -1) + tuple(v.shape[3:]))[:, flat]
            for k, v in contacts.items()}


def solve_positions(pos, rot, contacts, inv_mass, inv_inertia, mu_s, prev_pos, prev_rot,
                    response_dynamic, relaxation=1.0, max_visible_depth=0.05):
    """One Jacobi XPBD positional pass over the dense contact grid
    (contacts from narrowphase.narrowphase_dense, leading [W, n, n], i =
    ref, j = other; only its i < j pairs are read, the others can hold no
    contact).  Returns (pos, rot, lambda_n [W, n, n, 4], bias_dpos
    [W, n, 3]); the lambdas feed the velocity pass.  The pair math runs
    over the i < j pairs; their corrections go back to the grid, zero
    elsewhere, for the per-body sums."""
    n = pos.shape[1]
    iu, ju, flat = upper_pairs(n, pos.device)
    dynm = response_dynamic & (inv_mass > 0)
    im = torch.where(dynm, inv_mass, 0.0)
    ii = torch.where(dynm[..., None], inv_inertia, 0.0)
    dxA, dwA, dxB, dwB, dlam, bias_frac, _ = _positional_contact_math(
        pos[:, iu], rot[:, iu], im[:, iu], ii[:, iu], mu_s[:, iu], prev_pos[:, iu],
        pos[:, ju], rot[:, ju], im[:, ju], ii[:, ju], mu_s[:, ju], prev_pos[:, ju],
        _upper_contacts(contacts, flat), relaxation, max_visible_depth)
    # body k: row k (as A) plus column k (as B); the deep-depenetration
    # share of the linear correction is the bias
    bias4 = bias_frac[..., None]
    acc = grid_sums(to_grid(torch.cat([dxA, dwA, dxA * bias4], -1), flat, n),
                    to_grid(torch.cat([dxB, dwB, dxB * bias4], -1), flat, n))
    return (pos + acc[..., 0:3], _apply_rot_delta(rot, acc[..., 3:6]), to_grid(dlam, flat, n),
            acc[..., 6:9])


def _velocity_contact_math(posA, rotA, imA, iiA, muA, vA_lin, vA_ang, pvA_lin, pvA_ang,
                           posB, rotB, imB, iiB, muB, vB_lin, vB_ang, pvB_lin, pvB_ang,
                           contacts, lambda_n, h4, restitution4, restA=None, restB=None,
                           speculative=0.0):
    """Per-contact velocity solve (reference solveVelocitiesForContact,
    physics.cpp:716-1009) within each manifold as the reference does it:
    two sequential restitution iterations over the (up to 4) points, then
    a sequential dynamic-friction pass, each point updating the pair's
    local velocity copies before the next reads them; across pairs
    Jacobi.  Leading-shape generic (per-side args broadcast over *L);
    h4 and restitution4 broadcast against [*L, 4]; restA/restB the sides'
    restitution coefficients (None: no bounce).  No relaxation: the
    reference's velocity pass is unrelaxed.  Returns the pair's velocity
    deltas (dvA, dwA, dvB, dwB), each [*L, 3], zero (never NaN) on dead
    pairs."""
    ok, nrm, pts = contacts["ok"], contacts["normal"], contacts["points"]
    P = pts.shape[-2]
    pt_ok = ok[..., None] & (contacts["depth"] > 0) & (
        torch.arange(P, device=pts.device) < contacts["num_points"][..., None])
    mu_pair = 0.5 * (muA + muB)
    h1, rest1 = h4[..., 0], restitution4[..., 0]
    rAs = [pts[..., i, :] - posA for i in range(P)]
    rBs = [pts[..., i, :] - posB for i in range(P)]
    oks = [pt_ok[..., i] for i in range(P)]

    def pvel(v, w, r):
        return v + torch.linalg.cross(w, r, dim=-1)

    # vn_bar and e per point from the pre-substep velocities (reference
    # vn_bars[], physics.cpp:900-950)
    bounce = restA is not None and restB is not None
    targets = []
    for i in range(P):
        if bounce:
            vb = _dot(pvel(pvB_lin, pvB_ang, rBs[i]) - pvel(pvA_lin, pvA_ang, rAs[i]), nrm)
            e = torch.where(vb.abs() <= rest1, 0.0, 0.5 * (restA + restB))
            targets.append(torch.clamp(-e * vb, min=0.0))
        else:
            targets.append(torch.zeros_like(mu_pair))

    vA0, wA0, vB0, wB0 = vA_lin, vA_ang, vB_lin, vB_ang
    vA, wA, vB, wB = vA0, wA0, vB0, wB0

    def turn(rot, ii, torque):
        """The world-frame angular change I^-1 torque of a side."""
        return m.quat_rotate(rot, ii * m.quat_inv_rotate(rot, torque))

    def apply_point(vA, wA, vB, wB, imp, i, mask):
        m1 = mask[..., None]
        dwA = turn(rotA, iiA, torch.linalg.cross(rAs[i], -imp, dim=-1))
        dwB = turn(rotB, iiB, torch.linalg.cross(rBs[i], imp, dim=-1))
        return (torch.where(m1, vA - imp * imA[..., None], vA), torch.where(m1, wA + dwA, wA),
                torch.where(m1, vB + imp * imB[..., None], vB), torch.where(m1, wB + dwB, wB))

    # restitution: two sequential iterations (physics.cpp:953-966); the
    # generalized masses and targets do not change between them
    wsum_ns = [torch.clamp(_generalized_inv_mass(rAs[i], nrm, imA, iiA, rotA)
                           + _generalized_inv_mass(rBs[i], nrm, imB, iiB, rotB), min=1e-12)
               for i in range(P)]
    for _ in range(2):
        for i in range(P):
            vn = _dot(pvel(vB, wB, rBs[i]) - pvel(vA, wA, rAs[i]), nrm)
            imp = ((targets[i] - vn) / wsum_ns[i])[..., None] * nrm
            vA, wA, vB, wB = apply_point(vA, wA, vB, wB, imp, i, oks[i])

    # dynamic friction: one sequential pass (physics.cpp:755-817)
    for i in range(P):
        vpt = pvel(vB, wB, rBs[i]) - pvel(vA, wA, rAs[i])
        vn = _dot(vpt, nrm)
        vt = vpt - vn[..., None] * nrm
        vt_len = _norm3(vt)
        that = vt / torch.clamp(vt_len[..., None], min=1e-12)
        dyn_mag = mu_pair * lambda_n[..., i].abs() / h1
        corrected = torch.minimum(dyn_mag, vt_len)
        wsum = torch.clamp(_generalized_inv_mass(rAs[i], that, imA, iiA, rotA)
                           + _generalized_inv_mass(rBs[i], that, imB, iiB, rotB), min=1e-12)
        imp = (-corrected / wsum)[..., None] * that
        mask = oks[i] & (vt_len > 1e-9) & (dyn_mag > 0)
        vA, wA, vB, wB = apply_point(vA, wA, vB, wB, imp, i, mask)

    # speculative near-miss clamp (depth <= 0): per point, Jacobi
    if speculative > 0:
        rA4 = pts - posA[..., None, :]
        rB4 = pts - posB[..., None, :]
        n4 = nrm[..., None, :].expand(rA4.shape)

        def point_vel4(v, w, r):
            return v[..., None, :] + torch.linalg.cross(w[..., None, :], r, dim=-1)

        vn4 = _dot(point_vel4(vB0, wB0, rB4) - point_vel4(vA0, wA0, rA4), n4)
        imA4, imB4 = imA[..., None], imB[..., None]
        iiA4, iiB4 = iiA[..., None, :], iiB[..., None, :]
        rotA4, rotB4 = rotA[..., None, :], rotB[..., None, :]
        wsum_n = torch.clamp(_generalized_inv_mass(rA4, n4, imA4, iiA4, rotA4)
                             + _generalized_inv_mass(rB4, n4, imB4, iiB4, rotB4), min=1e-12)
        depth4 = contacts["depth"]
        ok_np = ok[..., None] & (
            torch.arange(P, device=pts.device) < contacts["num_points"][..., None])
        dv_spec = depth4 / h4 - vn4
        s_ok = ok_np & (depth4 <= 0) & (dv_spec > 0)
        npts_s = torch.clamp(s_ok.to(torch.int32).sum(dim=-1, keepdim=True), min=1)
        simp = (torch.where(s_ok, dv_spec / wsum_n, 0.0)[..., None]
                / npts_s[..., None].to(dv_spec.dtype) * n4)
        # one-shot apply: the angular update is linear in the impulse, so
        # the torques are summed first
        simp_sum = ordered_sum(simp, -2)
        tqA = ordered_sum(torch.linalg.cross(rA4, -simp, dim=-1), -2)
        tqB = ordered_sum(torch.linalg.cross(rB4, simp, dim=-1), -2)
        any_s = s_ok.any(dim=-1)[..., None]
        vA = torch.where(any_s, vA - simp_sum * imA[..., None], vA)
        vB = torch.where(any_s, vB + simp_sum * imB[..., None], vB)
        wA = torch.where(any_s, wA + turn(rotA, iiA, tqA), wA)
        wB = torch.where(any_s, wB + turn(rotB, iiB, tqB), wB)

    zero = torch.zeros_like(pts[..., 0, :])
    return vA - vA0 + zero, wA - wA0 + zero, vB - vB0 + zero, wB - wB0 + zero


def solve_velocities(pos, rot, vel_lin, vel_ang, contacts, lambda_n, inv_mass, inv_inertia,
                     mu_d, pre_v, pre_omega, response_dynamic, h, restitution_threshold,
                     rest_coef=None, speculative=0.0):
    """The velocity pass over the dense contact grid (reference
    solveVelocities, physics.cpp:716-1009), its i < j pairs as
    solve_positions reads them.  rest_coef: per-body restitution [W, n]
    (None: no bounce); speculative: the near-miss margin.  Returns
    (vel_lin, vel_ang)."""
    n = pos.shape[1]
    iu, ju, flat = upper_pairs(n, pos.device)
    dynm = response_dynamic & (inv_mass > 0)
    im = torch.where(dynm, inv_mass, 0.0)
    ii = torch.where(dynm[..., None], inv_inertia, 0.0)
    h4 = h.reshape(h.shape[0], 1, 1)
    rest4 = restitution_threshold.reshape(-1, 1, 1)
    restA = None if rest_coef is None else rest_coef[:, iu]
    restB = None if rest_coef is None else rest_coef[:, ju]
    dvA, dwA, dvB, dwB = _velocity_contact_math(
        pos[:, iu], rot[:, iu], im[:, iu], ii[:, iu], mu_d[:, iu], vel_lin[:, iu],
        vel_ang[:, iu], pre_v[:, iu], pre_omega[:, iu],
        pos[:, ju], rot[:, ju], im[:, ju], ii[:, ju], mu_d[:, ju], vel_lin[:, ju],
        vel_ang[:, ju], pre_v[:, ju], pre_omega[:, ju],
        _upper_contacts(contacts, flat),
        lambda_n.reshape((lambda_n.shape[0], n * n, -1))[:, flat], h4, rest4, restA=restA,
        restB=restB, speculative=speculative)
    acc = grid_sums(to_grid(torch.cat([dvA, dwA], -1), flat, n),
                    to_grid(torch.cat([dvB, dwB], -1), flat, n))
    return vel_lin + acc[..., 0:3], vel_ang + acc[..., 3:6]


def _to_bodies(vals, rows, valid, n):
    """Per-joint values of both sides [2, W, J, c] summed onto their bodies
    [W, n, c]: each side's live joints at a row in [0, n), added from 0 in
    joint order, then side 1's sum plus side 2's (JAX's one-hot einsums).
    The order is fixed on every device (a stable sort by body and
    ``segment_reduce``, which adds each segment in order, as
    physics/pairs.py segment_sum does), so the single-substep kernel's
    joint sums repeat it bit for bit."""
    _, W, J, C = vals.shape
    ok = valid & (rows >= 0) & (rows < n)                                # [2, W, J]
    base = torch.arange(W, device=rows.device)[:, None] * n
    body = torch.where(ok, rows.long() + base, W * n)      # the others: one extra segment
    sides = []
    for s in range(2):
        flat = body[s].reshape(-1)
        order = torch.sort(flat, stable=True).indices
        lengths = torch.bincount(flat, minlength=W * n + 1)
        seg = torch.segment_reduce(vals[s].reshape(W * J, C)[order], "sum", lengths=lengths,
                                   axis=0, unsafe=True)
        sides.append(seg[:W * n].reshape(W, n, C))
    return sides[0] + sides[1]


def solve_joints(pos, rot, inv_mass, inv_inertia, joints, rows1, rows2, jmask,
                 relaxation=1.0):
    """XPBD joint solve (reference handleJointConstraint, physics.cpp:478-650),
    Jacobi-accumulated: Fixed joints (joint_type 0) hold the relative
    orientation (attach_rot1/2) and the separation along the attachment x
    axis; Hinge joints (1) align the local axes and pin the attachment
    points.  pos/rot/inv_mass/inv_inertia: body columns [W, n, ...];
    joints: the JointConstraint field dict [W, J, ...]; rows1/rows2 [W, J]
    body rows (-1 invalid); jmask [W, J] live joints.  Returns (pos, rot).

    The JAX package's formulas, with each per-side quantity computed once
    for both sides, stacked on a leading axis of 2: elementwise the same
    operations, in a fraction of the launches."""
    n, J = pos.shape[1], rows1.shape[1]
    valid = jmask & (rows1 >= 0) & (rows2 >= 0)
    rows = torch.stack([rows1, rows2])                                  # [2, W, J]

    def sides(x):
        g = batched_gather(x, torch.cat([rows1, rows2], 1))
        return torch.stack([g[:, :J], g[:, J:]])

    def both(f1, f2):
        return torch.stack([joints[f1], joints[f2]])

    x, q, im, ii = sides(pos), sides(rot), sides(inv_mass), sides(inv_inertia)
    is_fixed = (joints["joint_type"] == 0)[..., None]

    # angular: Fixed 2 vec((q1 aq1)(q2 aq2)^-1), Hinge a1w x a2w
    o = m.quat_normalize(m.quat_mul(q, both("attach_rot1", "attach_rot2")))
    diff = m.quat_mul(o[0], torch.cat([o[1][..., 0:1], -o[1][..., 1:4]], -1))
    aw = m.quat_rotate(q, both("a1_local", "a2_local"))
    dq = torch.where(is_fixed, 2.0 * diff[..., 1:4], torch.linalg.cross(aw[0], aw[1], dim=-1))
    mag = _norm3(dq)
    # dead rows' fields may be garbage: zero them before they reach a sum
    dq_dir = torch.where(valid[..., None], dq / torch.clamp(mag[..., None], min=1e-12), 0.0)
    mag = torch.where(valid, mag, 0.0)
    n_l = m.quat_inv_rotate(q, dq_dir)                                  # [2, W, J, 3]
    w_side = _sum3(n_l * ii * n_l)
    w_a = w_side[0] + w_side[1]
    ang_ok = valid & (mag > 1e-9) & (w_a > 1e-12)
    dlam_a = torch.where(ang_ok, mag / torch.clamp(w_a, min=1e-12), 0.0) * relaxation
    dw = m.quat_rotate(q, ii * n_l * dlam_a[..., None])    # body 1 turns by -dw[0]

    # positional: Fixed keeps the separation along the attach x axis and
    # zero along the others; Hinge pins the attachment points
    rw = m.quat_rotate(q, both("r1", "r2"))
    delta_r = (x[1] + rw[1]) - (x[0] + rw[0])
    # the attachment frame's x and y axes (o[0] is q1 attach_rot1,
    # normalized); the unit axes are made on the device (a copy from the
    # host would make it wait for the stream)
    e_xy = torch.zeros((2,) + delta_r.shape, dtype=pos.dtype, device=pos.device)
    e_xy[0, ..., 0] = 1.0
    e_xy[1, ..., 1] = 1.0
    a1, b1 = m.quat_rotate(o[0], e_xy)
    c1 = torch.linalg.cross(a1, b1, dim=-1)
    a_sep = _sum3(delta_r * a1) - joints["separation"]
    b_sep = _sum3(delta_r * b1)
    c_sep = _sum3(delta_r * c1)
    corr_fixed = a_sep[..., None] * a1 + b_sep[..., None] * b1 + c_sep[..., None] * c1
    corr = torch.where(is_fixed, corr_fixed, delta_r)
    c_mag = _norm3(corr)
    nrm = torch.where(valid[..., None], corr / torch.clamp(c_mag[..., None], min=1e-12), 0.0)
    c_mag = torch.where(valid, c_mag, 0.0)
    w_side = _generalized_inv_mass(rw, nrm.expand_as(rw), im, ii, q)
    w_p = w_side[0] + w_side[1]
    pos_ok = valid & (c_mag > 1e-9) & (w_p > 1e-12)
    dlam_p = torch.where(pos_ok, c_mag / torch.clamp(w_p, min=1e-12), 0.0) * relaxation
    p_imp = dlam_p[..., None] * nrm                   # pulls p1 toward p2
    dx, dwp = _apply_impulse_terms(torch.stack([p_imp, -p_imp]), rw, im, ii, q)

    acc = _to_bodies(torch.cat([dx, torch.stack([-dw[0], dw[1]]) + dwp], -1), rows, valid, n)
    return pos + acc[..., 0:3], _apply_rot_delta(rot, acc[..., 3:6])
