"""Collision kernels: wrappers, plain versions and launch counters.

Counterpart of ``gpu_ecs_madrona_tpu/ops/collision_kernel.py``.  The two
functions keep the JAX signatures ([W, n, 3] in, [W, n, 3] out) and run
hand-written CUDA kernels (csrc/collision_kernels.cu, whose notes say what
bounds each one and how it is laid out):

  - ``fused_collisions_step(pos, rot, mask) -> (delta, lo, hi)``: the
    whole collisions tick per world — the AABB of each rotated +-1 cube,
    the overlap grid and the push reduction, without centring.
  - ``collision_pushes(pos, lo, hi, mask) -> delta``: the push reduction
    alone with the AABBs given, on positions centred per world; n is
    unbounded (j is walked in shared-memory tiles).

The push of body i is  delta_i = -2 sum_j ok_ij (x_j - x_i) / |x_j - x_i|
over every live j != i whose AABB overlaps i's, with |.|^2 clamped at
1e-30 (the reference's both-orders pair push, collisions.cpp:179-200).

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches its kernel or raises — never falls back.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_ecs_madrona_tpu_torch.ops import _build

# The fused kernel's single-tile bound, kept from the JAX package
# (collision_kernel.py:307): n padded to 128, n_pad^2 * 12 B <= 6 MB.
FUSED_MAX_BYTES = 6 * 1024 * 1024


def fused_fits(n: int) -> bool:
    n_pad = ((n + 127) // 128) * 128
    return n_pad * n_pad * 12 <= FUSED_MAX_BYTES


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def aabb_plain(pos, rot):
    """AABB of the +-1 cube rotated by rot [W, n, 4] (w-first) about pos
    [W, n, 3]: (pos - e, pos + e), e_a = sum_b |R_ab|."""
    qw, qx, qy, qz = rot.unbind(-1)
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - qw * qz)
    r02 = 2.0 * (qx * qz + qw * qy)
    r10 = 2.0 * (qx * qy + qw * qz)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - qw * qx)
    r20 = 2.0 * (qx * qz - qw * qy)
    r21 = 2.0 * (qy * qz + qw * qx)
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
    e = torch.stack([r00.abs() + r01.abs() + r02.abs(),
                     r10.abs() + r11.abs() + r12.abs(),
                     r20.abs() + r21.abs() + r22.abs()], dim=-1)
    return pos - e, pos + e


def pushes_plain(pos, lo, hi, mask, center: bool = True):
    """The push reduction over the dense [W, n, n] pair grid.  ``center``
    subtracts each world's mean position first (collision_pushes does,
    fused_collisions_step does not)."""
    n = pos.shape[1]
    if center:
        pos = pos - pos.mean(dim=1, keepdim=True)
    ok = ((lo[:, :, None, :] <= hi[:, None, :, :])
          & (lo[:, None, :, :] <= hi[:, :, None, :])).all(dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    ok = ok & mask[:, :, None] & mask[:, None, :] & ~eye
    diff = pos[:, None, :, :] - pos[:, :, None, :]  # [W, i, j, 3] = x_j - x_i
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    m = torch.where(ok, torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
    return -2.0 * (m[..., None] * diff).sum(dim=2)


def fused_collisions_step_plain(pos, rot, mask):
    lo, hi = aabb_plain(pos, rot)
    return pushes_plain(pos, lo, hi, mask, center=False), lo, hi


def collision_pushes_plain(pos, lo, hi, mask):
    return pushes_plain(pos, lo, hi, mask, center=True)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("collision_kernels")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_collisions_step_launch.argtypes = [P, P, P, I, I, P, P, P, P]
        lib.fused_collisions_step_launch.restype = I
        lib.collision_pushes_launch.argtypes = [P, P, P, P, I, I, I, P, P]
        lib.collision_pushes_launch.restype = I
        lib._typed = True
    return lib


def _check(name, mask, **tensors):
    """Device, dtype, shape and contiguity checks before a launch."""
    W, n = mask.shape
    for key, (t, width) in tensors.items():
        if t.device.type != "cuda" or t.device != mask.device:
            raise ValueError(f"{name}: {key} on {t.device}, mask on {mask.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (W, n, width):
            raise ValueError(f"{name}: {key} must be float32 [{W}, {n}, {width}], "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if mask.device.type != "cuda" or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous bool CUDA tensor")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def fused_collisions_step(pos, rot, mask):
    """pos [W, n, 3], rot [W, n, 4] (w-first quats), mask [W, n] bool ->
    (delta [W, n, 3], lo [W, n, 3], hi [W, n, 3]).

    The collisions example's whole per-tick chain (aabb_preprocess +
    solver) in one kernel; lo/hi are written for dead rows too, and dead
    rows get a zero push."""
    W, n = mask.shape
    if not fused_fits(n):
        raise ValueError(
            f"fused_collisions_step: n={n} exceeds the single-tile bound; "
            "use collision_pushes + the aabb_preprocess row node for large n")
    if pos.device.type == "cpu":
        return fused_collisions_step_plain(pos, rot, mask)
    _check("fused_collisions_step", mask, pos=(pos, 3), rot=(rot, 4))
    delta = torch.empty_like(pos)
    lo = torch.empty_like(pos)
    hi = torch.empty_like(pos)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = _lib().fused_collisions_step_launch(
        pos.data_ptr(), rot.data_ptr(), mask.data_ptr(), W, n,
        delta.data_ptr(), lo.data_ptr(), hi.data_ptr(), stream)
    _raise_on(rc, "fused_collisions_step")
    fused_collisions_step.launches += 1
    return delta, lo, hi


fused_collisions_step.launches = 0

_TILE_J = 128


def collision_pushes(pos, lo, hi, mask, force_tile: int = 0):
    """pos [W, n, 3], lo/hi [W, n, 3], mask [W, n] bool -> delta [W, n, 3].

    Positions are centred per world first (d2 and the push are
    translation-invariant; centring keeps large coordinates from
    cancelling).  ``force_tile`` sets the width of the j tiles the kernel
    stages through shared memory (default 128; at most 1024)."""
    if pos.device.type == "cpu":
        return collision_pushes_plain(pos, lo, hi, mask)
    _check("collision_pushes", mask, pos=(pos, 3), lo=(lo, 3), hi=(hi, 3))
    tile_j = force_tile or _TILE_J
    if not 1 <= tile_j <= 1024:
        raise ValueError(f"collision_pushes: force_tile={force_tile} outside [1, 1024]")
    W, n = mask.shape
    pc = (pos - pos.mean(dim=1, keepdim=True)).contiguous()
    delta = torch.empty_like(pos)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = _lib().collision_pushes_launch(
        pc.data_ptr(), lo.data_ptr(), hi.data_ptr(), mask.data_ptr(), W, n,
        tile_j, delta.data_ptr(), stream)
    _raise_on(rc, "collision_pushes")
    collision_pushes.launches += 1
    return delta


collision_pushes.launches = 0
