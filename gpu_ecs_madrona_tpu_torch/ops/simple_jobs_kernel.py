"""The simple_jobs tick in one kernel: wrapper, plain version, launch counter.

Counterpart of ``gpu_ecs_madrona_tpu/ops/simple_jobs_kernel.py``.
``fused_simple_jobs_step(pos, rot, *, n0, K, degree_cap, bounds)`` keeps
the JAX signature and outputs and runs the hand-written CUDA kernel in
``csrc/simple_jobs_kernels.cu`` (whose notes say what bounds it and how it
is laid out).  Per world of n0 bodies it clamps the positions to the
bounds, takes the AABB of each rotated +-1 cube (the |R| form of
``collision_kernel.aabb_plain``), finds the ordered overlapping pairs,
compacts them by capped rank, computes each kept pair's normal and pushes
every body apart over all overlapping pairs:

  - slot(a, b) = base[a] + rank(b in row a) for the first D = degree_cap
    partners of row a in ascending b, base the exclusive prefix of
    min(deg, D) over rows; slots at or past K are cut and not counted;
    ``dropped`` counts the pairs the cap cut, sum(deg) - total;
  - normal = normalize(p_b - p_a) at the clamped positions;
  - translation_a = p_a - 2 sum_b rsqrt(d2_ab) (pc_b - pc_a) over every
    overlapping b, pc the positions centred on the world's mean, pairs with
    d2 <= 1e-12 (bodies clamped into the same corner) excluded.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises — never falls back.  The launches
are counted in ``fused_simple_jobs_step.launches``.  ``zeros=True`` adds an
eighth output, a [W] int32 zero tensor written by the same launch: the
simple_jobs node's reset counters, so that the node queues one device op.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_ecs_madrona_tpu_torch.core.state import batched_gather
from gpu_ecs_madrona_tpu_torch.ops import _build
from gpu_ecs_madrona_tpu_torch.ops.collision_kernel import aabb_plain
from gpu_ecs_madrona_tpu_torch.utils.compaction import first_partners, rank_slots

# The kernel's launch shape (csrc/simple_jobs_kernels.cu; the layout test
# holds these equal to the .cu's constants and shared-memory formulas): one
# CTA a world.  Up to MAX_BODIES bodies, a compute thread a row slot (n0
# rounded up to CHUNK, at least MIN_THREADS) and one producer warp that
# queues the slot spans' zeros where it fits in MAX_THREADS.  Past it, the
# rounds layout: ROUND_THREADS threads, every warp computing, take the rows
# a block of at most BLOCK_ROWS at a time, a warp a row; the rows' state in
# shared memory while it fits beside a block of MIN_BLOCK_ROWS rows' overlap
# words (rounds_rows_shared).  A global scratch (scratch_bytes a world; the
# wrapper allocates it) holds the lower triangle's words, and the rows and a
# block's words where they do not fit.
MAX_BODIES = 1024
MAX_THREADS = 1024
MIN_THREADS = 128
ROUND_THREADS = 1024
BLOCK_ROWS = 256    # the rounds layout's rows a block at most
MIN_BLOCK_ROWS = 64  # ... at least, where its rows stay in shared memory
UNIT = 16           # rows of a candidate-word unit
CHUNK = 64          # rows a bit-grid word covers
STAGE = 512         # slots staged a chunk
ZERO_BYTES = 2048   # the bulk stores' zero source
MAX_SMEM = 232448   # a CTA's shared memory at most (227 KB)


def fused_fits(n0: int) -> bool:
    """Whether the kernel takes n0 bodies: any n0 >= 1."""
    return n0 >= 1


def rounds(n0: int) -> bool:
    """Whether a launch at n0 bodies takes the rounds layout."""
    return n0 > MAX_BODIES


def compute_threads(n0: int) -> int:
    if rounds(n0):
        return ROUND_THREADS
    return max(MIN_THREADS, CHUNK * -(-n0 // CHUNK))


def block_threads(n0: int) -> int:
    tc = compute_threads(n0)
    return tc + 32 if tc + 32 <= MAX_THREADS else tc


def smem_bytes(n0: int) -> int:
    """Shared bytes of a one-block CTA (smem_bytes in the .cu): lo, hi,
    position and the half box, 16 bytes a row slot each; the bulk stores'
    zeros; the 64-bit overlap words [np / 64][np]; the slot stage (ab and
    normals, STAGE slots); the warps' position sums and slot and drop
    sums."""
    np_ = CHUNK * -(-n0 // CHUNK)
    return (16 * 4 * np_ + ZERO_BYTES + 8 * (np_ // CHUNK * np_)
            + 4 * (5 * STAGE + 32 * 3 + 32 * 2))


def round_ncp(n0: int) -> int:
    """The rounds layout's words a row in a block: the chunks, made odd."""
    return -(-n0 // CHUNK) | 1


def rounds_fixed_bytes() -> int:
    """The rounds layout's shared bytes at any n0: each warp's slot stage
    (32 partners and 3 x 32 normals), a block's degrees and bases, the
    warps' sums."""
    return 4 * (ROUND_THREADS // 32 * 4 * 32 + 2 * BLOCK_ROWS + 32 * 3 + 32 * 2)


def rounds_rows_shared(n0: int) -> bool:
    """Whether the rounds layout keeps the rows' lo, hi and centred position
    (16 bytes a row slot each) in shared memory: where they fit beside a
    MIN_BLOCK_ROWS-row block's words (rounds_rows_shared in the .cu)."""
    np_ = CHUNK * -(-n0 // CHUNK)
    return (16 * 3 * np_ + 8 * MIN_BLOCK_ROWS * round_ncp(n0) + rounds_fixed_bytes()
            <= MAX_SMEM)


def _rows_bytes(n0: int) -> int:
    return 16 * 3 * CHUNK * -(-n0 // CHUNK) if rounds_rows_shared(n0) else 0


def rounds_words_shared(n0: int) -> bool:
    """Whether a block's words stay in shared memory (at least
    MIN_BLOCK_ROWS rows')."""
    return (_rows_bytes(n0) + 8 * MIN_BLOCK_ROWS * round_ncp(n0) + rounds_fixed_bytes()
            <= MAX_SMEM)


def rounds_block_rows(n0: int) -> int:
    """The rows a rounds-layout block takes (rounds_block_rows in the .cu):
    whole chunks, as many as the shared memory left holds the words of, at
    most BLOCK_ROWS; BLOCK_ROWS with the words in the scratch."""
    left = MAX_SMEM - rounds_fixed_bytes() - _rows_bytes(n0)
    fit = left // (8 * round_ncp(n0)) // CHUNK * CHUNK
    return BLOCK_ROWS if fit < MIN_BLOCK_ROWS else min(fit, BLOCK_ROWS)


def rounds_smem_bytes(n0: int) -> int:
    """Shared bytes of a rounds-layout CTA (rounds_smem_bytes in the .cu):
    the rows where they fit, a block's words where they fit, the rest."""
    words = rounds_block_rows(n0) * round_ncp(n0) if rounds_words_shared(n0) else 0
    return _rows_bytes(n0) + 8 * words + rounds_fixed_bytes()


def scratch_bytes(n0: int) -> int:
    """A world's bytes of the rounds layout's global scratch
    (rounds_scratch_bytes in the .cu; 0 in the one-block layout): the lower
    triangle's words u64 [np / 64][np], then the rows and a block's words
    where they are not in shared memory."""
    if not rounds(n0):
        return 0
    np_ = CHUNK * -(-n0 // CHUNK)
    rows = 0 if rounds_rows_shared(n0) else 3 * np_
    words = 0 if rounds_words_shared(n0) else rounds_block_rows(n0) * round_ncp(n0)
    return 8 * (np_ // CHUNK * np_) + 16 * rows + 8 * words


def launch_shape(W: int, n0: int) -> dict:
    """{ctas, threads, smem} of a launch at W worlds of n0 bodies, and the
    global scratch's bytes."""
    smem = rounds_smem_bytes(n0) if rounds(n0) else smem_bytes(n0)
    return {"ctas": W, "threads": block_threads(n0), "smem": smem,
            "scratch": W * scratch_bytes(n0)}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def clamp_to_bounds(pos, bounds):
    """min(max(pos, lo), hi) per axis (jnp.clip's order); bounds are
    (lo, hi) triples or tensors of 3."""
    return torch.clamp(pos, torch.as_tensor(bounds[0], dtype=pos.dtype, device=pos.device),
                       torch.as_tensor(bounds[1], dtype=pos.dtype, device=pos.device))


def overlap_grid(lo, hi):
    """Ordered-pair AABB overlap [W, n, n] (closed slabs), diagonal off."""
    n = lo.shape[1]
    ok = ((lo[:, :, None, :] <= hi[:, None, :, :])
          & (lo[:, None, :, :] <= hi[:, :, None, :])).all(dim=-1)
    return ok & ~torch.eye(n, dtype=torch.bool, device=lo.device)


def contact_normals(pos, ab):
    """normalize(p_b - p_a) for each slot's pair [W, k, 3] (a zero pair,
    as in an empty slot, gives 0)."""
    diff = batched_gather(pos, ab[..., 1]) - batched_gather(pos, ab[..., 0])
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    return diff * torch.rsqrt(d2.clamp(min=1e-30))[..., None]


def centred_pushes(pos, ok):
    """-2 sum_j M_ij (pc_j - pc_i), M_ij = ok_ij rsqrt(d2_ij) where d2_ij >
    1e-12, pc the positions centred on each world's mean; subtract-first d2
    over the dense [W, n, n] grid."""
    pc = pos - pos.mean(dim=1, keepdim=True)
    diff = pc[:, None, :, :] - pc[:, :, None, :]  # [W, i, j, 3] = x_j - x_i
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    m = torch.where(ok & (d2 > 1e-12), torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
    return -2.0 * (m[..., None] * diff).sum(dim=2)


def fused_simple_jobs_step_plain(pos, rot, *, n0: int, K: int, degree_cap: int, bounds):
    p = clamp_to_bounds(pos, bounds)
    lo, hi = aabb_plain(p, rot)
    ok = overlap_grid(lo, hi)
    partners, deg = first_partners(ok, degree_cap)
    ab, total, dropped = rank_slots(partners, deg, degree_cap, K)
    return (p + centred_pushes(p, ok), lo, hi, ab, contact_normals(p, ab),
            total, dropped)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("simple_jobs_kernels")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_simple_jobs_step_launch.argtypes = (
            [P, P, I, I, I, I] + [F] * 6 + [P] * 10)
        lib.fused_simple_jobs_step_launch.restype = I
        IP = ctypes.POINTER(ctypes.c_int)
        lib.simple_jobs_occupancy.argtypes = [I, IP, IP, IP]
        lib.simple_jobs_occupancy.restype = I
        lib._typed = True
    return lib


def _check(pos, rot, n0):
    W = pos.shape[0]
    for key, t, width in (("pos", pos, 3), ("rot", rot, 4)):
        if t.device.type != "cuda" or t.device != pos.device:
            raise ValueError(f"fused_simple_jobs_step: {key} on {t.device}, "
                             f"pos on {pos.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (W, n0, width):
            raise ValueError(f"fused_simple_jobs_step: {key} must be float32 "
                             f"[{W}, {n0}, {width}], got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_simple_jobs_step: {key} must be contiguous")
    if rot.data_ptr() % 16:
        raise ValueError("fused_simple_jobs_step: rot must be 16-byte aligned (a float4 a body)")


def scratch(W: int, n0: int, device):
    """The rounds layout's global scratch for W worlds of n0 bodies
    (scratch_bytes a world; the launch writes every word it reads, so it
    needs no clearing), or None in the one-block layout."""
    if scratch_bytes(n0) == 0:
        return None
    return torch.empty((W * scratch_bytes(n0) // 16, 4), dtype=torch.int32, device=device)


def occupancy(W: int, n0: int, K: int) -> dict:
    """launch_shape plus the CTAs an SM the card's occupancy API gives for
    it (needs the card; K does not change the shape)."""
    if not fused_fits(n0) or K < 1:
        raise ValueError(f"occupancy: n0={n0}, K={K}")
    t, b, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().simple_jobs_occupancy(n0, ctypes.byref(t), ctypes.byref(b), ctypes.byref(c))
    if rc != 0:
        raise RuntimeError(f"simple_jobs_occupancy failed with cudaError {rc}")
    return dict(launch_shape(W, n0), ctas_per_sm=c.value)


def fused_simple_jobs_step(pos, rot, *, n0: int, K: int, degree_cap: int, bounds,
                           zeros: bool = False):
    """pos [W, n0, 3], rot [W, n0, 4] (w-first quats) -> (translation
    [W, n0, 3], lo [W, n0, 3], hi [W, n0, 3], ab [W, K, 2] int32 (zero past
    counts), normals [W, K, 3] (zero past counts), counts [W] int32,
    dropped [W] int32), and with ``zeros`` a [W] int32 zero tensor from the
    same launch.

    K: the candidate capacity; degree_cap: the per-row partner cap D;
    bounds: ((lo x, y, z), (hi x, y, z)).  Past MAX_BODIES bodies the
    kernel takes its rounds layout, with a global scratch made here where
    its rows do not fit in shared memory."""
    if pos.ndim != 3 or pos.shape[1] != n0:
        raise ValueError(f"fused_simple_jobs_step: pos {tuple(pos.shape)} does not "
                         f"hold n0={n0} bodies")
    if not fused_fits(n0):
        raise ValueError(f"fused_simple_jobs_step: n0={n0} bodies, at least 1 needed")
    if K < 1 or degree_cap < 0:
        raise ValueError(f"fused_simple_jobs_step: K={K}, degree_cap={degree_cap}")
    if pos.device.type == "cpu":
        out = fused_simple_jobs_step_plain(pos, rot, n0=n0, K=K,
                                           degree_cap=degree_cap, bounds=bounds)
        return (*out, torch.zeros_like(out[5])) if zeros else out
    _check(pos, rot, n0)
    W = pos.shape[0]
    translation = torch.empty_like(pos)
    lo = torch.empty_like(pos)
    hi = torch.empty_like(pos)
    ab = torch.empty((W, K, 2), dtype=torch.int32, device=pos.device)
    nrm = torch.empty((W, K, 3), dtype=torch.float32, device=pos.device)
    counts = torch.empty((W,), dtype=torch.int32, device=pos.device)
    dropped = torch.empty((W,), dtype=torch.int32, device=pos.device)
    zero = torch.empty((W,), dtype=torch.int32, device=pos.device) if zeros else None
    work = scratch(W, n0, pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = _lib().fused_simple_jobs_step_launch(
        pos.data_ptr(), rot.data_ptr(), W, n0, K, degree_cap,
        *(float(v) for v in bounds[0]), *(float(v) for v in bounds[1]),
        translation.data_ptr(), lo.data_ptr(), hi.data_ptr(), ab.data_ptr(),
        nrm.data_ptr(), counts.data_ptr(), dropped.data_ptr(),
        None if zero is None else zero.data_ptr(),
        None if work is None else work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_simple_jobs_step: kernel launch failed with cudaError {rc}")
    fused_simple_jobs_step.launches += 1
    out = (translation, lo, hi, ab, nrm, counts, dropped)
    return (*out, zero) if zeros else out


fused_simple_jobs_step.launches = 0
