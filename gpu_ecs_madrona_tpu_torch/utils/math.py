"""Batched math helpers: quaternions, rigid transforms, AABBs (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/utils/math.py``, the subset the
collisions example uses.  Every function broadcasts over leading dims, so
the same code serves one row or ``[worlds, rows]`` blocks.  Quaternions
are stored (w, x, y, z), matching the reference's field order.

The JAX module's ``mask_cumsum_last`` (a triangular matmul for the TPU's
matrix unit) has no counterpart: the port uses ``torch.cumsum``.
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


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]
    (reference Quat::rotateVec)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


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
