"""Batched math helpers: quaternions, rigid transforms, AABBs (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/utils/math.py``, the subset the
collisions example and rigid-body physics use.  Every function broadcasts
over leading dims, so the same code serves one row or ``[worlds, rows]``
blocks.  Quaternions are stored (w, x, y, z), matching the reference's
field order.

Strict fp32: nothing here is a matrix product (rotations are written out
as sums), so no result depends on TF32.  The JAX module's ``EXACT`` /
``DEFAULT_P`` matmul precisions have no counterpart, and its
``mask_cumsum_last`` (a triangular matmul for the TPU's matrix unit) is a
plain ``torch.cumsum`` here.
"""

from __future__ import annotations

import math

import torch

# -- quaternions -------------------------------------------------------------


def quat_from_angle_axis(angle, axis):
    """reference Quat::angleAxis (math.hpp)."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    axis = torch.as_tensor(axis, dtype=torch.float32, device=angle.device)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle * 0.5
    w = torch.cos(half)
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([w[..., None], xyz], dim=-1)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]
    (reference Quat::rotateVec)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_inv_rotate(q, v):
    qc = torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)
    return quat_rotate(qc, v)


def quat_to_mat(q):
    """Rotation matrix [..., 3, 3] from quaternions [..., 4] (wxyz)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def quat_normalize(q):
    """q / max(|q|, 1e-12): all-zero quats (dead masked rows) must not
    produce NaN, which would poison masked arithmetic downstream."""
    sq = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2] \
        + q[..., 3] * q[..., 3]
    return q / torch.sqrt(sq).clamp(min=1e-12)[..., None]


def quat_integrate(q, omega, dt):
    """Integrate angular velocity omega [..., 3] over dt (XPBD-style,
    reference physics.cpp substepRigidBodies)."""
    dq = 0.5 * quat_mul(torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1), q)
    return quat_normalize(q + dt * dq)


# -- transforms --------------------------------------------------------------


def transform_points(translation, rotation, points):
    """Apply the rigid transform to points [..., N, 3] (reference
    Mat3x4::fromTRS + txfmPoint, math.hpp)."""
    p = quat_rotate(rotation[..., None, :], points)
    return p + translation[..., None, :]


# -- AABBs -------------------------------------------------------------------


def aabb_invalid(shape=(), dtype=torch.float32, device="cpu"):
    """reference AABB::invalid() — inverted infinite box."""
    lo = torch.full(tuple(shape) + (3,), math.inf, dtype=dtype, device=device)
    hi = torch.full(tuple(shape) + (3,), -math.inf, dtype=dtype, device=device)
    return lo, hi


def aabb_from_points(points):
    """AABB of points [..., N, 3] -> (pmin [..., 3], pmax [..., 3])."""
    return points.amin(dim=-2), points.amax(dim=-2)


def aabb_overlaps(a_lo, a_hi, b_lo, b_hi):
    """reference AABB::overlaps (math.hpp): closed slab test, ``<=`` on
    both sides (touching boxes overlap)."""
    return ((a_lo <= b_hi) & (b_lo <= a_hi)).all(dim=-1)


def mask_cumsum_last(mask, dtype=torch.int32):
    """Inclusive cumsum of a 0/1 mask along the last axis (exact)."""
    return torch.cumsum(mask.to(torch.int32), dim=-1).to(dtype)


UNIT_CUBE_CORNERS = torch.tensor(
    [
        [-1.0, -1.0, -1.0],
        [1.0, -1.0, -1.0],
        [1.0, 1.0, -1.0],
        [-1.0, 1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [1.0, -1.0, 1.0],
        [1.0, 1.0, 1.0],
        [-1.0, 1.0, 1.0],
    ],
    dtype=torch.float32,
)
