"""XPBD rigid-body solver pieces the compacted-pairs path uses (PyTorch).

Counterpart of part of ``gpu_ecs_madrona_tpu/physics/solver.py``:
``integrate`` (reference substepRigidBodies, physics.cpp:79-164),
``_apply_rot_delta``, ``set_velocities`` (setVelocities,
physics.cpp:673-714) and ``solve_joints`` (handleJointConstraint,
physics.cpp:478-650).  The dense-grid solves (``solve_positions``,
``solve_velocities``) wait (ROADMAP); the per-pair contact math is
physics/pairs.py.
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


def _generalized_inv_mass(r, nrm, inv_mass, inv_inertia, rot):
    """w = 1/m + (r x n)^T I^-1 (r x n) (physics.cpp:215-231); the inertia
    diagonal is in the body frame."""
    rxn_b = m.quat_inv_rotate(rot, torch.linalg.cross(r, nrm, dim=-1))
    return inv_mass + (rxn_b * inv_inertia * rxn_b).sum(-1)


def _apply_impulse_terms(p, r, inv_mass, inv_inertia, rot):
    """Positional impulse p at offset r -> (dx, rotation update vector
    I^-1 (r x p)) (physics.cpp:247-268)."""
    rxp_b = m.quat_inv_rotate(rot, torch.linalg.cross(r, p, dim=-1))
    return p * inv_mass[..., None], m.quat_rotate(rot, inv_inertia * rxp_b)


def _to_bodies(vals, rows, valid, n):
    """Per-joint values of both sides [2, W, J, c] summed onto their bodies
    [W, n, c]: a masked sum over the joints, side 1's sum then side 2's
    (JAX's one-hot einsums, with no matmul, so TF32 never touches them)."""
    oh = (rows[..., None] == torch.arange(n, device=rows.device)) & valid[..., None]
    per_side = torch.where(oh[..., None], vals[:, :, :, None, :], 0.0).sum(2)   # [2, W, n, c]
    return per_side[0] + per_side[1]


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
    mag = torch.linalg.vector_norm(dq, dim=-1)
    # dead rows' fields may be garbage: zero them before they reach a sum
    dq_dir = torch.where(valid[..., None], dq / torch.clamp(mag[..., None], min=1e-12), 0.0)
    mag = torch.where(valid, mag, 0.0)
    n_l = m.quat_inv_rotate(q, dq_dir)                                  # [2, W, J, 3]
    w_side = (n_l * ii * n_l).sum(-1)
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
    a_sep = (delta_r * a1).sum(-1) - joints["separation"]
    b_sep = (delta_r * b1).sum(-1)
    c_sep = (delta_r * c1).sum(-1)
    corr_fixed = a_sep[..., None] * a1 + b_sep[..., None] * b1 + c_sep[..., None] * c1
    corr = torch.where(is_fixed, corr_fixed, delta_r)
    c_mag = torch.linalg.vector_norm(corr, dim=-1)
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
