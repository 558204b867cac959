"""XPBD rigid-body solver pieces the compacted-pairs path uses (PyTorch).

Counterpart of part of ``gpu_ecs_madrona_tpu/physics/solver.py``:
``integrate`` (reference substepRigidBodies, physics.cpp:79-164),
``_apply_rot_delta`` and ``set_velocities`` (setVelocities,
physics.cpp:673-714).  The dense-grid solves (``solve_positions``,
``solve_velocities``) and the joint solve wait (ROADMAP); the per-pair
contact math is physics/pairs.py.
"""

from __future__ import annotations

import torch

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
