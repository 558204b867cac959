"""The physics substep kernels: wrappers, plain versions, launch counters,
and the ``FusedSubstepKernel`` and ``SubstepKernel`` drivers.

Counterpart of ``gpu_ecs_madrona_tpu/ops/substep_kernel.py``'s
``FusedSubstepKernel`` (``_run_fused`` with all its options) and
``SubstepKernel``.  ``fused_substep`` runs, per world and for each of
``num_substeps`` substeps (the JAX kernel loop, ``_make_fused_kernel``):

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

Its options, each a specialisation of the one CUDA kernel:

  - ``refresh`` (contact_refresh): substep 0 runs ``pair_contacts`` and
    keeps the manifold in body frames (``pairs.cache_contacts``); later
    substeps move it with the bodies (``pairs.refresh_contacts``).
  - ``active`` (sleep): an asleep world passes its state through, with
    stashes equal to it.
  - ``bp_degree`` (the in-kernel broadphase, TPU kernel 8): the candidate
    rows come from the world's velocity-expanded AABBs and the dense rank
    compaction with degree cap D (``inkernel_broadphase_plain``), over
    K slots; the outputs add the AABBs, rows, counts and drops.
  - ``persist_margin`` (persistent manifolds, TPU kernel 9; with bp and
    refresh): a ``stable`` world reuses the rows, AABBs and body-frame
    manifold of its cache ``mcache`` [W, MC_CHANNELS, K] and skips the
    broadphase and SAT; the others rebuild with AABBs inflated by
    margin / 2.  Both take substep 0's contacts through
    ``refresh_contacts`` of the resolved cache, and the cache goes out:
    a new tensor, or ``mcache_out`` (which may be ``mcache``) updated in
    place where a world rebuilt, with its ``anchors`` (apos, arot,
    valid).  An asleep world passes the cache surface through too.  On
    the card with sleep, ``asleep_surface`` (asleep_surface_kernel) writes
    the asleep worlds' outputs and lists the awake ones before the fused
    kernel, which then runs only those.

``world_flags`` computes the fused node's sleep classifier and stability
predicate (world_flags_kernel on the card, ``world_flags_plain`` on the
CPU), which give the kernel its ``active`` and ``stable`` flags.  The
per-object constants (inverse mass and inertia, friction) may be left to
the kernels, which read them from their object table (``object_columns``
is the plain version's gather).

``substep`` is the counterpart of ``SubstepKernel`` (``_run``, one
substep per call), which worlds with joints take: steps 2-9 once, from
the post-integrate pose and velocities its caller passes (the JAX
kernel's contract).  ``substep_node`` is the kernel-mode substep node of
such a world in one launch of the same kernel: the integrate
(``solver.integrate``) from the state's columns, steps 2-9, the joint
solve (``solver.solve_joints``, the joints' entity handles looked up in
the kernel) and the writeback (dynamic rows take the solve, the others
keep their pose and velocity), with the substep's three stashes.  Its
plain version ``substep_node_plain`` is that route composed.  Both share
steps 2-9 with the fused ones (``_solve_substep`` here, ``solve_substep``
in the .cu).

On CUDA tensors ``fused_substep``, ``substep`` and ``substep_node`` launch
the hand-written kernels in ``csrc/substep_kernels.cu`` (one CTA per
world; its notes say what bounds them and how they are laid out) or
raise.  All-box tables take the analytic box paths; tables with general
hulls (any convex hull, e.g. from utils/importer.py, of any size whose
world-space rows fit the shared memory: ``hull_stage_bytes``) take each
specialisation's general-hull twin (OPT_HULL, counted as "...+hull" and in
``SubstepKernel.hull_launches``), which reads ``pairs.ObjTables.hull_table``
beside the object table.  A fused shape without the in-kernel broadphase
whose slot layout leaves one CTA an SM (``windowed``: from 129 bodies of
rigid_bench, 80 with contact refresh, the 24-sided prism's pile at 64; past
one block's shared memory from 239 bodies) takes each specialisation's
windowed twin (OPT_WIN, counted as "...win"; ``fused_route``): a window of
work entries in shared memory (``fused_window``: every slot up to ~250
bodies), the rest in a global scratch (``fused_scratch``), bit for bit the
slot layout, in a block of its own (``WIN_THREADS``, one CTA an SM, no
register cap).  Where even that layout's
smallest window does not fit beside the bodies (from 871 bodies of
rigid_bench, 648 with contact refresh), and where kernel 5's window layout
passes one block's shared memory (from 816 body rows), the bodies' rows,
lists' offsets and cursors and staged hull rows move to a second global
scratch (``body_scratch``; OPT_BODY, counted as "...win+bodies" and in
``SubstepKernel.body_launches``), bit for bit the same, and the shared
memory the twin's budget leaves holds the offsets and cursors, kernel 5's
joint lists and the hottest body channels (``body_plan``); kernel 5's joint
rows follow the bodies where they do not fit beside its window either
(about 3,600 joint rows a world: ``substep_joints_in_scratch``, counted in
``SubstepKernel.joint_scratch_launches``), and that twin sums each body's
joints over its own per-body lists.  On CPU tensors
they run ``fused_substep_plain``, ``substep_plain``
and ``substep_node_plain``, the same loop in batched PyTorch over [W, K]
pair tensors.  The segment sums add each body's A-side contributions in
ascending slot order, then its B-side ones, in both versions (a stable
sort and ``segment_reduce`` in the plain version, a loop over the slots
in the kernel), and the joint sums each side's joints in joint order, so
both repeat bit for bit from run to run.  Launches are counted in
``FusedSubstepKernel.launches``, ``SubstepKernel.launches``,
``WorldFlags.launches`` and ``AsleepSurface.launches``.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from gpu_ecs_madrona_tpu_torch.core.component import ENTITY_GEN_BITS, ENTITY_ID_BITS
from gpu_ecs_madrona_tpu_torch.core.state import entity_rows
from gpu_ecs_madrona_tpu_torch.ops import _build
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk
from gpu_ecs_madrona_tpu_torch.physics import solver
from gpu_ecs_madrona_tpu_torch.physics.components import RESPONSE_DYNAMIC
from gpu_ecs_madrona_tpu_torch.utils.compaction import first_partners, rank_slots

# The JAX kernel's packed channels ([W, C, n], body lanes last), for
# reading its layout: fused inputs F_*, fused outputs FO_*.
F_POS, F_ROT, F_V, F_W, F_IM, F_II, F_MUS, F_MUD, F_OBJ = 0, 3, 7, 10, 13, 14, 17, 18, 19
F_EXTF, F_EXTT, F_DYN, F_SCALE, F_LIVE, FC_IN = 20, 23, 26, 27, 30, 31
F_ALO, F_AHI, FC_IN_P = 31, 34, 37
FO_POS, FO_ROT, FO_V, FO_W, FO_PREV_POS, FO_PREV_ROT = 0, 3, 7, 10, 13, 16
FO_PS_POS, FO_PS_ROT, FO_PS_V, FO_PS_W, FC_OUT = 20, 23, 27, 30, 33

# The persistent-manifold cache (the ManifoldPersist singleton's ``mc``,
# [W, MC_CHANNELS, K]), as the JAX package lays it out: per slot the
# cached broadphase (rows_i, rows_j, kvalid), then the body-frame manifold
# of pairs.cache_contacts (rA[c][p] at MC_RA + 4 c + p, rB likewise,
# n_loc, depth0[p], ok, num_points).
MC_ROWS = 3
MC_RA, MC_RB, MC_NLOC, MC_DEPTH0, MC_OK, MC_NPTS = 3, 15, 27, 30, 34, 35
MC_CHANNELS = 36
MC_CACHE = MC_CHANNELS - MC_ROWS

# The kernel's bounds: one CTA per world, whose bodies, per-slot stash and
# slot lists sit in shared memory (see csrc/substep_kernels.cu), at most
# 227 KB a block on an H100.  The in-kernel broadphase takes one thread a
# body row.
MAX_SMEM_BYTES = 227 * 1024
# The object tables the kernels take: all-box tables of any verts a hull
# (the analytic box paths; past BOX_VERTS, the wide_box tables, from the
# build of csrc/substep_wide_box_kernels.cu, whose hull-plane path reads
# every live vertex at the table's stride); tables with general hulls
# (pairs.ObjTables.hull_table) of any counts, the kernels staging each hull
# row's world-space data in shared memory (hull_stage_bytes), which with
# the rest must fit MAX_SMEM_BYTES (or, past it, goes to the body scratch).
BOX_VERTS = 8
MAX_BP_ROWS = 128
MAX_THREADS = 128


def block_threads(n: int, K: int) -> int:
    """The kernels' block size (block_threads in the .cu): one thread a
    slot and a body, in whole warps, at most MAX_THREADS."""
    return min(-(-max(n, K) // 32) * 32, MAX_THREADS)


def stash_slots(n: int, K: int) -> int:
    """The slots whose manifold waits in shared memory between the two
    passes (stash_slots in the .cu): a thread keeps its first entry's in
    registers, so only the rounds of T slots after the first."""
    T = block_threads(n, K)
    return (-(-K // T) - 1) * T


def hull_stage_floats(tables: pk.ObjTables) -> int:
    """The floats a row of the general-hull specialisations' staged hull
    rows (hull_stride in the .cu): a row's world vertices, edge directions
    and SAT axes (3 each) and faces (4: normal and offset), at the table's
    counts; 0 for all-box tables (or None)."""
    if tables is None or tables.all_box:
        return 0
    _, Fm, Sm, Em, _, _ = tables.hull_dims()
    return 3 * (tables.Vm + Em + Sm) + 4 * Fm


def hull_stage_bytes(tables: pk.ObjTables, n: int) -> int:
    """The shared memory the general-hull specialisations stage n rows of
    ``tables``' hulls in, beside smem_bytes / substep_smem_bytes (0 for
    all-box tables)."""
    return 4 * n * hull_stage_floats(tables)


# The fused kernel's windowed layout (OPT_WIN, see csrc/substep_kernels.cu
# kOptWin): a shape without the in-kernel broadphase whose slot layout
# (smem_bytes with the staged hull rows) passes TWO_CTA_BYTES keeps kernel
# 5's window of work entries in shared memory and the rest in a global
# scratch of SCRATCH_CH channels an entry (WIN_CACHE_CH with the manifold
# cache), its window the most entries one CTA's MAX_SMEM_BYTES holds
# (fused_window).
# The twins past one block (kWinThreads, kBodyThreads, kBodyWinEntries in
# the .cu), one CTA an SM: the windowed twins' threads a CTA (at every
# shape: a narrow one's hull phases spread over all 12 warps); kernel 5's
# bodies-in-scratch twin's threads at most; the fused bodies-in-scratch
# twin's window at most.
WIN_THREADS = 384
BODY_THREADS = 384
BODY_WIN_ENTRIES = 512


def smem_bytes(n: int, K: int, bp: bool = False, cache: bool = False) -> int:
    """The kernel's shared memory for n bodies and K slots: its dynamic
    part (smem_bytes in the .cu: 54 floats a body, 18 a slot and 24 a
    stash slot, 6 ints a slot (rows, flag, the per-body list, the work
    list), 3 n + 1 list offsets and cursors and 8 world ints; with the
    broadphase 6 floats and 6 ints a body (the AABB; degree, first slot and
    4 partner-mask words), with a manifold cache 33 floats a slot) and its
    one static int."""
    floats = (54 * n + 24 * stash_slots(n, K) + 18 * K + (6 * n if bp else 0)
              + (MC_CACHE * K if cache else 0))
    ints = 6 * K + 3 * n + 1 + 8 + (6 * n if bp else 0)
    return 4 * floats + 4 * ints + 4


# Kernel 5 (substep_kernel, see csrc/substep_kernels.cu): its block, its
# shared window of work entries, and the global scratch channels of an entry
# past the window; a joint's kJointCh floats of shared memory.
SUBSTEP_THREADS = 128
SUBSTEP_WINDOW = 320
SCRATCH_CH = 46
JOINT_CH = 12
WIN_CACHE_CH = SCRATCH_CH + MC_CACHE


def substep_window(K: int) -> int:
    """Kernel 5's work entries in shared memory for K slots."""
    return min(K, SUBSTEP_WINDOW)


def substep_threads(n: int, K: int) -> int:
    """Kernel 5's block size: one thread a window entry and a body, in whole
    warps, at most SUBSTEP_THREADS."""
    return min(-(-max(n, substep_window(K)) // 32) * 32, SUBSTEP_THREADS)


def substep_smem_bytes(n: int, K: int, J: int = 0) -> int:
    """Kernel 5's shared memory for n bodies, K slots and J joints
    (substep_smem_bytes in the .cu): 54 floats a body, 18 a window entry and
    24 more one past the block's threads, 12 a joint; 4 ints a window entry,
    3 n + 1 list offsets and cursors, 8 world ints and 2 a joint."""
    kw, T = substep_window(K), substep_threads(n, K)
    floats = 54 * n + 24 * max(kw - T, 0) + 18 * kw + JOINT_CH * J
    ints = 4 * kw + 3 * n + 1 + 8 + 2 * J
    return 4 * floats + 4 * ints


def fused_window_smem_bytes(n: int, kw: int, T: int, cache: bool = False) -> int:
    """The windowed layout's shared memory for n bodies, a window of kw
    work entries and T threads (fused_window_smem_bytes in the .cu): 54
    floats a body, 18 a window entry (with the cache 33 more) and 24 more
    one past the block's threads; 4 ints a window entry, 3 n + 1 list
    offsets and cursors and 8 world ints."""
    floats = 54 * n + 24 * max(kw - T, 0) + (18 + (MC_CACHE if cache else 0)) * kw
    ints = 4 * kw + 3 * n + 1 + 8
    return 4 * floats + 4 * ints


def fused_window(n: int, K: int, cache: bool = False, hull_bytes: int = 0) -> int:
    """The windowed layout's window for n bodies, K slots and hull_bytes of
    staged hull rows (fused_window in the .cu): the most work entries (at
    most K) whose layout fits one CTA's MAX_SMEM_BYTES; 0 when not even the
    smallest window (min(K, the block's threads)) fits beside the bodies and
    the hull rows."""
    T = WIN_THREADS
    least = min(K, T)
    if fused_window_smem_bytes(n, least, T, cache) + hull_bytes > MAX_SMEM_BYTES:
        return 0
    lo, hi = least, K
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        if fused_window_smem_bytes(n, mid, T, cache) + hull_bytes <= MAX_SMEM_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


# The most shared memory a CTA may take for two to share an SM: an H100 SM
# holds MAX_SMEM_BYTES and 1 KB, and each CTA on it reserves 1 KB.
TWO_CTA_BYTES = (MAX_SMEM_BYTES - 1024) // 2


def windowed(tables: pk.ObjTables, n: int, K: int, bp: bool = False,
             cache: bool = False) -> bool:
    """Whether the fused kernel runs these shapes in its windowed twin (the
    route's one rule; ``tables`` None for all-box tables): without the
    in-kernel broadphase (and so without persistence), where the slot layout
    with the staged hull rows leaves one CTA an SM (passes TWO_CTA_BYTES);
    there the twin's block of WIN_THREADS threads, its registers
    uncapped, runs the same work bit for bit (rigid_bench from 130 rows, 81
    with contact refresh; the 24-sided prism's pile at 65 rows, K = 256);
    past MAX_SMEM_BYTES the slot layout does not fit at all."""
    return (not bp and smem_bytes(n, K, bp, cache) + hull_stage_bytes(tables, n)
            > TWO_CTA_BYTES)


# Bodies in a global scratch (OPT_BODY, see csrc/substep_kernels.cu
# kOptBody): kernel 5 where its window layout (substep_smem_bytes with the
# staged hull rows) passes MAX_SMEM_BYTES, the fused kernel's windowed
# specialisations where fused_window is 0.  A world's body rows (BODY_CH
# floats a row, every channel's place), its lists' offsets and cursors
# (3 n + 1), kernel 5's joints' rows where they do not fit beside its window,
# its joint lists and the staged hull rows live in its slice of a second
# global scratch (body_scratch).  Shared memory, MAX_SMEM_BYTES at most (one
# CTA an SM), holds the fixed part (the window, kernel 5's joints, the
# world ints) and then, each where it still fits (body_plan), the lists'
# offsets and cursors, kernel 5's joint lists and the hottest body channels
# (the first ``hot`` of the .cu's body_rank order).
BODY_CH = 54


def body_bytes(n: int) -> int:
    """The shared memory the window layouts keep n bodies' rows, lists'
    offsets and cursors in (body_bytes in the .cu): what the
    bodies-in-scratch layout moves out."""
    return 4 * BODY_CH * n + 4 * (3 * n + 1)


def body_scratch_floats(n: int, tables: pk.ObjTables, joints: int = 0,
                        joints_in_scratch: bool = False) -> int:
    """A world's floats of the body scratch (body_scratch_floats in the .cu):
    its body rows, lists' offsets and cursors, the rows of ``joints`` joints
    where they are there too (JOINT_CH floats and 2 ints a joint;
    substep_joints_in_scratch), kernel 5's joint lists (2 n + 2 ``joints``
    ints where it has joints) and staged hull rows."""
    return (BODY_CH * n + 3 * n + 1 + ((JOINT_CH + 2) * joints if joints_in_scratch else 0)
            + (2 * n + 2 * joints if joints > 0 else 0) + n * hull_stage_floats(tables))


def substep_body_threads(n: int, K: int) -> int:
    """Kernel 5's bodies-in-scratch twin's block: one thread a window entry
    and a body, in whole warps, at most BODY_THREADS."""
    return min(-(-max(n, substep_window(K)) // 32) * 32, BODY_THREADS)


def substep_body_fixed_bytes(n: int, K: int, J: int = 0) -> int:
    """The fixed part of kernel 5's bodies-in-scratch twin's shared memory
    with J joints' rows there (substep_body_fixed_bytes in the .cu): its
    window layout without the bodies at its own block."""
    kw, T = substep_window(K), substep_body_threads(n, K)
    floats = 24 * max(kw - T, 0) + 18 * kw + JOINT_CH * J
    ints = 4 * kw + 8 + 2 * J
    return 4 * floats + 4 * ints


def body_plan(fixed: int, n: int, J: int, budget: int) -> dict:
    """What a bodies-in-scratch twin's shared memory holds past its fixed
    part (body_plan in the .cu): the lists' offsets and cursors ("offsets"),
    kernel 5's joint lists ("joint_lists"), each where it still fits, then
    the ``hot`` body channels that fit; "bytes" its shared memory."""
    used = fixed
    offs = used + 4 * (3 * n + 1) <= budget
    used += 4 * (3 * n + 1) if offs else 0
    lists = J > 0 and used + 4 * (2 * n + 2 * J) <= budget
    used += 4 * (2 * n + 2 * J) if lists else 0
    hot = min(BODY_CH, max(budget - used, 0) // (4 * n))
    return {"offsets": offs, "joint_lists": lists, "hot": hot, "bytes": used + 4 * n * hot}


def substep_body_plan(n: int, K: int, J: int = 0, jg: bool = False) -> dict:
    """Kernel 5's bodies-in-scratch twin's body_plan at n bodies, K slots and
    J joints, their rows in the scratch (jg) or not."""
    return body_plan(substep_body_fixed_bytes(n, K, 0 if jg else J), n, J, MAX_SMEM_BYTES)


def substep_body_smem_bytes(n: int, K: int, J: int = 0, jg: bool = False) -> int:
    """Kernel 5's shared memory with its bodies in the scratch
    (substep_body_smem_bytes in the .cu)."""
    return substep_body_plan(n, K, J, jg)["bytes"]


def body_window_smem_bytes(n: int, kw: int, T: int, cache: bool = False) -> int:
    """The fused kernel's windowed layout's shared memory without its
    bodies, at a window of kw entries: its bodies-in-scratch twin's fixed
    part."""
    return fused_window_smem_bytes(n, kw, T, cache) - body_bytes(n)


def body_window(n: int, K: int, cache: bool = False) -> int:
    """The fused kernel's window with its bodies in the scratch (body_window
    in the .cu): the most work entries (at most K and BODY_WIN_ENTRIES, at
    least a round of the block) whose fixed part fits MAX_SMEM_BYTES; 0 when
    not even the least does."""
    T = WIN_THREADS
    least = min(K, T)
    most = K if K < BODY_WIN_ENTRIES else max(BODY_WIN_ENTRIES, least)
    budget = MAX_SMEM_BYTES
    if body_window_smem_bytes(n, least, T, cache) > budget:
        return 0
    lo, hi = least, most
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        if body_window_smem_bytes(n, mid, T, cache) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def fused_body_plan(n: int, K: int, cache: bool = False) -> dict:
    """The fused bodies-in-scratch twin's body_plan at its window."""
    kw = body_window(n, K, cache)
    return body_plan(body_window_smem_bytes(n, kw, WIN_THREADS, cache), n, 0,
                     MAX_SMEM_BYTES)


def substep_bodies(tables: pk.ObjTables, n: int, K: int, J: int = 0) -> bool:
    """Whether kernel 5 keeps these shapes' bodies in the scratch: its window
    layout with the staged hull rows passes MAX_SMEM_BYTES."""
    return substep_smem_bytes(n, K, J) + hull_stage_bytes(tables, n) > MAX_SMEM_BYTES


def substep_joints_in_scratch(tables: pk.ObjTables, n: int, K: int, J: int) -> bool:
    """Whether kernel 5 keeps these shapes' joint rows in the body scratch
    too (Args1::jg in the .cu): its bodies are there and its window with the
    joint rows does not fit its twin's budget (~3,600 joint rows a world at
    K > 320)."""
    return (substep_bodies(tables, n, K, J)
            and substep_body_fixed_bytes(n, K, J) > MAX_SMEM_BYTES)


def substep_layout_smem_bytes(tables: pk.ObjTables, n: int, K: int, J: int = 0) -> int:
    """Kernel 5's shared memory in the layout these shapes take
    (substep_layout_smem in the .cu)."""
    if not substep_bodies(tables, n, K, J):
        return substep_smem_bytes(n, K, J) + hull_stage_bytes(tables, n)
    return substep_body_smem_bytes(n, K, J, substep_joints_in_scratch(tables, n, K, J))


def fused_route(code: int, tables: pk.ObjTables, n: int, K: int) -> int:
    """The fused kernel's option bits ``code`` (no OPT_HULL) as a launch at n
    bodies and K slots with ``tables`` (None: all-box) takes them: with
    OPT_WIN where windowed, and OPT_BODY where fused_bodies; bits that name
    a layout already are kept."""
    if code & OPT_WIN:
        return code
    bp, cache = bool(code & OPT_BP), bool(code & (OPT_REFRESH | OPT_PERSIST))
    if not windowed(tables, n, K, bp, cache):
        return code
    return code | OPT_WIN | (OPT_BODY if fused_bodies(tables, n, K, bp, cache) else 0)


def fused_bodies(tables: pk.ObjTables, n: int, K: int, bp: bool = False,
                 cache: bool = False) -> bool:
    """Whether the fused kernel keeps these shapes' bodies in the scratch: a
    windowed shape whose smallest window does not fit beside the bodies and
    the staged hull rows (fused_window 0)."""
    return (windowed(tables, n, K, bp, cache)
            and fused_window(n, K, cache, hull_stage_bytes(tables, n)) == 0)


def fused_layout_window(tables: pk.ObjTables, n: int, K: int, cache: bool = False) -> int:
    """The window of a windowed fused launch: fused_window, or body_window
    where the bodies go to the scratch."""
    if fused_bodies(tables, n, K, cache=cache):
        return body_window(n, K, cache)
    return fused_window(n, K, cache, hull_stage_bytes(tables, n))


def body_scratch(W: int, n: int, tables: pk.ObjTables, device, joints: int = 0,
                 joints_in_scratch: bool = False):
    """The body scratch for W worlds of n bodies with ``tables``' staged hull
    rows (and kernel 5's ``joints`` joints' lists, and their rows where
    ``joints_in_scratch``), [W, body_scratch_floats] float32."""
    return torch.empty((W, body_scratch_floats(n, tables, joints, joints_in_scratch)),
                       dtype=torch.float32, device=device)


def win_pitch(kg: int) -> int:
    """The windowed twins' scratch pitch for kg entries past the window
    (win_pitch in the .cu): rounded up to even, so that each world's slice
    is 8-byte aligned for the twins' paired pass channels."""
    return kg + (kg & 1)


def fused_scratch(W: int, K: int, kw: int, cache: bool, device):
    """The windowed layout's global scratch for W worlds, K slots and a
    window of kw (fused_window), [W, SCRATCH_CH (WIN_CACHE_CH with the
    cache), win_pitch(K - kw)] float32 (the work entries past the window),
    or None when K fits the window."""
    if kw >= K:
        return None
    return torch.empty((W, WIN_CACHE_CH if cache else SCRATCH_CH, win_pitch(K - kw)),
                       dtype=torch.float32, device=device)


def substep_scratch(W: int, K: int, device):
    """Kernel 5's global scratch for W worlds and K slots, [W, SCRATCH_CH,
    K - window] float32 (the work entries past the window), or None when K
    fits the window."""
    if K <= SUBSTEP_WINDOW:
        return None
    return torch.empty((W, SCRATCH_CH, K - SUBSTEP_WINDOW), dtype=torch.float32, device=device)


def bp_slots(capacity: int) -> int:
    """The in-kernel broadphase's slot count for a candidate capacity: the
    JAX kernel's whole 128-lane tiles, at least one."""
    return max(128, -(-capacity // 128) * 128)

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


def _sumsq(x):
    """Each row's sum of squares over the last axis, in component order
    ((x0 x0 + x1 x1) + x2 x2 ...), as the kernels add it."""
    c = _comps(x)
    acc = c[0] * c[0]
    for xc in c[1:]:
        acc = acc + xc * xc
    return acc


def object_columns(obj, dyn, tables: pk.ObjTables):
    """The static body columns from the object tables at obj [W, n]:
    inverse mass [W, n] and inertia [W, n, 3] (zero on rows not in dyn),
    static and dynamic friction [W, n] — what the kernels read from their
    table when these arguments are None."""
    o, dev = obj.long(), obj.device
    im = torch.where(dyn, tables.tab("inv_mass", dev)[o], 0.0)
    ii = torch.where(dyn[..., None], tables.tab("inv_inertia", dev)[o], 0.0)
    return im, ii, tables.tab("mu_s", dev)[o], tables.tab("mu_d", dev)[o]


def world_flags_plain(pos, rot, v, w, ext_f, ext_t, dyn, obj, scale, delta_t, *,
                      tables: pk.ObjTables, quiet_steps=None, sleep_threshold: float = 0.0,
                      sleep_frames: int = 10, apos=None, arot=None, valid=None,
                      persist_margin: float = 0.0):
    """The plain version of the world flags kernel: the fused node's sleep
    classifier and stability predicate (the JAX package's XLA glue,
    physics/__init__.py).  Body args [W, n(, 3/4)] (dyn bool, obj int32),
    delta_t [W].  A body is forced when it is dynamic and has an external
    force or torque.

    sleep_threshold > 0, with quiet_steps [W] int32: a world is quiet when
    no dynamic body has |v|^2 + |w|^2 > thr^2 and none is forced;
    quiet_steps counts quiet steps, saturating at sleep_frames; asleep =
    quiet_steps >= sleep_frames (int32); active = not asleep (bool).

    persist_margin > 0, with the cache's anchors apos [W, n, 3], arot [W,
    n, 4] and valid [W] int32: stable (bool) = valid > 0 and no dynamic
    body is forced or has |dpos| + pi |dq| r + (|v| + |w| r) delta_t >=
    margin / 2, r the object's bounding radius times its largest scale.

    Returns the dict of the options' flags.  Sums of squares add in
    component order (_sumsq), as the kernel does."""
    out = {}
    forced = dyn & ((ext_f != 0.0).any(-1) | (ext_t != 0.0).any(-1))
    if sleep_threshold > 0.0:
        sp2 = _sumsq(v) + _sumsq(w)
        fast = (dyn & (sp2 > sleep_threshold ** 2)).any(1)
        quiet = ~(fast | forced.any(1))
        qs = torch.clamp(torch.where(quiet, quiet_steps + 1, 0), max=sleep_frames)
        asleep = qs >= sleep_frames
        out.update(quiet_steps=qs, asleep=asleep.to(torch.int32), active=~asleep)
    if persist_margin > 0.0:
        rad = tables.scalar(obj, "bound_radius") * scale.amax(-1)
        carry = (torch.sqrt(_sumsq(v)) + torch.sqrt(_sumsq(w)) * rad) * delta_t[:, None]
        move = (torch.sqrt(_sumsq(pos - apos)) + math.pi * torch.sqrt(_sumsq(rot - arot)) * rad
                + carry)
        moving = dyn & (move >= 0.5 * persist_margin)
        out["stable"] = (valid > 0) & ~(moving | forced).any(1)
    return out


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


def _pack_cache(cache):
    """pairs.cache_contacts dict ([W, P, K] tuples) -> [W, MC_CACHE, K]."""
    chans = [cache["rA"][c][:, p] for c in range(3) for p in range(4)]
    chans += [cache["rB"][c][:, p] for c in range(3) for p in range(4)]
    chans += list(cache["n_loc"])
    chans += [cache["depth0"][:, p] for p in range(4)]
    chans += [cache["ok"].to(torch.float32), cache["num_points"].to(torch.float32)]
    return torch.stack(chans, dim=1)


def _parse_cache(mcc):
    """[W, MC_CACHE, K] -> pairs.cache_contacts dict."""
    def vec4(base):
        return tuple(mcc[:, base + 4 * c:base + 4 * c + 4] for c in range(3))
    return {"rA": vec4(MC_RA - MC_ROWS), "rB": vec4(MC_RB - MC_ROWS),
            "n_loc": tuple(mcc[:, MC_NLOC - MC_ROWS + c] for c in range(3)),
            "depth0": mcc[:, MC_DEPTH0 - MC_ROWS:MC_DEPTH0 - MC_ROWS + 4],
            "ok": mcc[:, MC_OK - MC_ROWS] > 0.5,
            "num_points": torch.round(mcc[:, MC_NPTS - MC_ROWS]).to(torch.int32)}


def _aabbs(pos, rot, v, scale, obj, dtv, tables, inflate):
    """Each body's velocity-expanded world AABB, inflated by ``inflate``
    on every side: lo, hi [W, n, 3].  The JAX kernel's arithmetic
    (``_inkernel_broadphase``): its own quaternion-to-matrix formula, the
    rotated centre and half extent summed in axis order, the expansion
    v * dtv from the step's starting velocity."""
    lo_l, hi_l = tables.vec(obj, "local_aabb_lo"), tables.vec(obj, "local_aabb_hi")
    scl = _comps(scale)
    c_l = tuple((lo + hi) * 0.5 * s for lo, hi, s in zip(lo_l, hi_l, scl))
    he = tuple((hi - lo) * 0.5 * s for lo, hi, s in zip(lo_l, hi_l, scl))
    qw, qx, qy, qz = _comps(rot)
    R = ((1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy)),
         (2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx)),
         (2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)))
    p, vel, d = _comps(pos), _comps(v), dtv[:, None]
    los, his = [], []
    for a in range(3):
        cw = p[a] + (R[a][0] * c_l[0] + R[a][1] * c_l[1] + R[a][2] * c_l[2])
        ext = R[a][0].abs() * he[0] + R[a][1].abs() * he[1] + R[a][2].abs() * he[2]
        vexp = vel[a] * d
        los.append(cw - ext + torch.clamp(vexp, max=0.0) - inflate)
        his.append(cw + ext + torch.clamp(vexp, min=0.0) + inflate)
    return torch.stack(los, -1), torch.stack(his, -1)


def inkernel_broadphase_plain(pos, rot, v, scale, live, obj, dtv, *, tables: pk.ObjTables,
                              K: int, D: int, inflate: float = 0.0):
    """The plain version of the fused kernel's broadphase (JAX
    ``_inkernel_broadphase``): each body's velocity-expanded AABB, the
    live pairs (``live`` for both rows) whose AABBs overlap, owned by the
    higher row, and the rank compaction — each owner's first min(deg, D)
    partners in ascending row, owners in ascending row, into K slots.
    Body args [W, n(, 3/4)], live bool, obj int32; dtv [W] (delta_t x
    velocity expansion).  Returns aabb_lo, aabb_hi [W, n, 3]; rows_i
    (partners), rows_j (owners) [W, K] int32; kvalid [W, K] bool (slot <
    count); bp_count = the sum of min(deg, D) and bp_dropped = the sum of
    deg less that, [W] int32 (a count above K keeps its value)."""
    lo, hi = _aabbs(pos, rot, v, scale, obj, dtv, tables, inflate)
    n = lo.shape[1]
    ok = ((lo[:, :, None] <= hi[:, None]) & (hi[:, :, None] >= lo[:, None])).all(-1)
    lower = torch.ones((n, n), dtype=torch.bool, device=lo.device).tril(-1)
    P = ok & live[:, :, None] & live[:, None, :] & lower        # [W, owner j, partner i]
    partners, deg = first_partners(P, D)
    ab, total, dropped = rank_slots(partners, deg, D, K)
    kvalid = torch.arange(K, device=lo.device)[None] < total[:, None]
    return {"aabb_lo": lo, "aabb_hi": hi, "rows_i": ab[..., 1].contiguous(),
            "rows_j": ab[..., 0].contiguous(), "kvalid": kvalid, "bp_count": total,
            "bp_dropped": dropped}


def _cached_surface(mcache, aabb_lo, aabb_hi):
    """The broadphase surface of a world that keeps its cache: the cached
    rows and kvalid, the current AABB columns, count = the cached kvalid's
    sum, nothing dropped."""
    return {"aabb_lo": aabb_lo, "aabb_hi": aabb_hi, "rows_i": mcache[:, 0].to(torch.int32),
            "rows_j": mcache[:, 1].to(torch.int32), "kvalid": mcache[:, 2] > 0.5,
            "bp_count": mcache[:, 2].sum(-1).to(torch.int32),
            "bp_dropped": torch.zeros(mcache.shape[0], dtype=torch.int32,
                                      device=mcache.device)}


def _select(cond, a, b):
    """Per world (cond [W] bool): a where cond, else b, for tensors of any
    rank with the world axis first."""
    return torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _solve_substep(pos_i, rot_i, v_i, w_i, prev_pos, prev_rot, pairs, kvalid, h1, rest1, *,
                   tables, relaxation, speculative, observe=None, contacts_at=None):
    """Steps 2-9 of a substep (the JAX kernels' ``_substep_core``) from the
    post-integrate pose and velocities and the substep start, all tuples
    of [W, n]: returns the post-solve pose and the post-velocity-pass
    velocities (p2, r2, v3, w3), before the dynamic-row selection.
    ``contacts_at(PA, PB, fresh)``, if given, makes the contacts from the
    pair sides (``fresh()`` is pair_contacts at them); by default they
    are pair_contacts."""
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

    def fresh():
        FA = pk.body_fields(PA["pos"], PA["rot"], SA["obj"], tables)
        FB = pk.body_fields(PB["pos"], PB["rot"], SB["obj"], tables)
        return pk.pair_contacts(FA, FB, kvalid, speculative=speculative)

    contacts = fresh() if contacts_at is None else contacts_at(PA, PB, fresh)
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
                        speculative: float = 0.0, observe=None, refresh: bool = False,
                        active=None, bp_degree: int = 0, K: int = 0, scale=None, live=None,
                        dtv=None, persist_margin: float = 0.0, mcache=None, stable=None,
                        aabb_lo=None, aabb_hi=None, mcache_out=None, anchors=None,
                        keep_velocity: bool = False):
    """The plain PyTorch version of the fused substep kernel (see the module
    doc).  Body args [W, n(, 3/4)]; pair args [W, K]; h and
    restitution_threshold [W]; gravity [W, 3]; im, ii, mu_s and mu_d may
    be None (object_columns).  Returns the dict of OUT_KEYS, each [W, n,
    3/4].  ``observe``, if given, is called with each substep's contacts
    (to count the work the data needs).  ``keep_velocity``: non-dynamic
    rows keep their v and w (else they come out zero).

    Options (the module doc): ``refresh``; ``active`` [W] bool (None: all
    awake); ``bp_degree`` D > 0 with ``K`` slots, ``scale`` [W, n, 3],
    ``live`` [W, n] bool and ``dtv`` [W], the rows then None, adding
    aabb_lo/hi, rows_i/j, kvalid, bp_count and bp_dropped to the dict;
    ``persist_margin`` > 0 (with bp and refresh) with ``mcache`` [W,
    MC_CHANNELS, K], ``stable`` [W] bool and the current ``aabb_lo/hi``
    columns, adding "mcache": a new tensor, or ``mcache_out`` (which may be
    mcache) with the worlds that rebuilt their cache written into it and
    the others left as they are.  ``anchors`` (apos [W, n, 3], arot [W,
    n, 4], valid [W] int32), if given, is updated in place where a world
    rebuilt: the step's starting pose, valid = nothing dropped."""
    if im is None:
        im, ii, mu_s, mu_d = object_columns(obj, dyn, tables)
    persist = persist_margin > 0.0
    # an asleep world takes the cached surface, so its cache passes through
    keep = None
    if persist:
        keep = stable if active is None else stable | ~active
    extra = {}
    if bp_degree:
        extra = inkernel_broadphase_plain(pos, rot, v, scale, live, obj, dtv, tables=tables,
                                          K=K, D=bp_degree, inflate=0.5 * persist_margin)
        if persist:
            cached = _cached_surface(mcache, aabb_lo, aabb_hi)
            extra = {k: _select(keep, cached[k], x) for k, x in extra.items()}
        rows_i, rows_j, kvalid = extra["rows_i"], extra["rows_j"], extra["kvalid"]
    h1 = h[:, None]
    rest1 = restitution_threshold[:, None]
    g = tuple(gravity[:, c:c + 1] for c in range(3))
    pairs = _pair_setup(im, ii, mu_s, mu_d, obj, rows_i, rows_j)
    ii_b, extf, extt = _comps(ii), _comps(ext_f), _comps(ext_t)
    posc, rotc, vc, wc = _comps(pos), _comps(rot), _comps(v), _comps(w)
    prev_pos, prev_rot = posc, rotc
    ps = (posc, rotc, vc, wc)
    memo = {}

    def build(PA, PB, fresh):
        # substep 0 with refresh: fresh contacts, kept in body frames
        contacts = fresh()
        memo["cache"] = pk.cache_contacts(contacts, PA, PB)
        return contacts

    def resolve(PA, PB, fresh):
        # substep 0 with persistence: the kept or the rebuilt cache, refreshed
        built = _pack_cache(pk.cache_contacts(fresh(), PA, PB))
        memo["mcc"] = _select(keep, mcache[:, MC_ROWS:], built)
        memo["cache"] = _parse_cache(memo["mcc"])
        return pk.refresh_contacts(memo["cache"], PA, PB)

    def refreshed(PA, PB, fresh):
        return pk.refresh_contacts(memo["cache"], PA, PB)

    for step in range(num_substeps):
        contacts_at = None
        if persist and step == 0:
            contacts_at = resolve
        elif refresh and step == 0 and num_substeps > 1:
            contacts_at = build
        elif refresh and step > 0:
            contacts_at = refreshed
        prev_pos, prev_rot = posc, rotc
        pos_i, rot_i, v_i, w_i = _integrate(posc, rotc, vc, wc, im, ii_b, extf, extt, dyn,
                                            h1, g)
        ps = (pos_i, rot_i, v_i, w_i)
        p2, r2, v3, w3 = _solve_substep(pos_i, rot_i, v_i, w_i, prev_pos, prev_rot, pairs,
                                        kvalid, h1, rest1, tables=tables,
                                        relaxation=relaxation, speculative=speculative,
                                        observe=observe, contacts_at=contacts_at)
        posc = tuple(torch.where(dyn, a, b) for a, b in zip(p2, posc))
        rotc = tuple(torch.where(dyn, a, b) for a, b in zip(r2, rotc))
        vc = tuple(torch.where(dyn, a, 0.0) for a in v3)
        wc = tuple(torch.where(dyn, a, 0.0) for a in w3)

    vals = (posc, rotc, vc, wc, prev_pos, prev_rot) + ps
    out = {k: torch.stack(x, -1) for k, x in zip(OUT_KEYS, vals)}
    if active is not None:
        frozen = (pos, rot, v, w, pos, rot, pos, rot, v, w)
        out = {k: _select(active, out[k], x) for k, x in zip(OUT_KEYS, frozen)}
    if keep_velocity:
        out["v"] = torch.where(dyn[..., None], out["v"], v)
        out["w"] = torch.where(dyn[..., None], out["w"], w)
    if persist:
        rows = torch.stack([rows_i.to(torch.float32), rows_j.to(torch.float32),
                            kvalid.to(torch.float32)], dim=1)
        rows = _select(keep, mcache[:, :MC_ROWS], rows)
        new = torch.cat([rows, memo["mcc"]], dim=1)
        if mcache_out is not None:
            mcache_out.copy_(_select(keep, mcache_out, new))
            new = mcache_out
        extra["mcache"] = new
        if anchors is not None:
            apos, arot, valid = anchors
            apos.copy_(_select(keep, apos, pos))
            arot.copy_(_select(keep, arot, rot))
            valid.copy_(torch.where(keep, valid, (extra["bp_dropped"] == 0).to(torch.int32)))
    return extra | out


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


NODE_KEYS = ("pos", "rot", "v", "w", "prev_pos", "prev_rot", "ps_pos", "ps_rot", "ps_v", "ps_w")
# the JointConstraint fields the joint solve reads, with their widths
JOINT_FIELDS = {"e1": 0, "e2": 0, "joint_type": 0, "attach_rot1": 4, "attach_rot2": 4,
                "separation": 0, "a1_local": 3, "a2_local": 3, "r1": 3, "r2": 3}


def substep_node_plain(pos, rot, v, w, obj, resp, mask, ext_f, ext_t, h, gravity,
                       restitution_threshold, rows_i, rows_j, kvalid, *, tables: pk.ObjTables,
                       relaxation: float = 1.0, speculative: float = 0.0, joints=None, jmask=None,
                       eid=None, arch_index: int = 0, observe=None):
    """The plain version of kernel 5's node launch: the kernel-mode substep
    node of a world with joints, composed of its route — the per-object
    constants at obj (inverse mass and inertia zero unless dynamic: resp ==
    RESPONSE_DYNAMIC and the row mask), ``solver.integrate``,
    ``substep_plain``, ``solver.solve_joints`` on its pose (the joints'
    rows by ``core.state.entity_rows``), and the writeback: dynamic rows take the
    solve, the others keep their pose and velocity.  Body args [W, n(,
    3/4)] (obj and resp int32, mask bool); pair args [W, K]; h,
    restitution_threshold [W]; gravity [W, 3]; ``joints`` the
    JointConstraint field dict [W, J, ...] with its row mask ``jmask`` and
    the entity store ``eid`` (None: no joint solve).  Returns the dict of
    NODE_KEYS: the new pose and velocity, the substep start (prev_pos,
    prev_rot) and the post-integrate stashes (ps_*)."""
    dyn = (resp == RESPONSE_DYNAMIC) & mask
    im, ii, mu_s, mu_d = object_columns(obj, dyn, tables)
    pos_i, rot_i, v_i, w_i, prev_pos, prev_rot = solver.integrate(
        pos, rot, v, w, im, ii, ext_f, ext_t, dyn, h, gravity)
    out = substep_plain(pos_i, rot_i, v_i, w_i, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn,
                        h, restitution_threshold, rows_i, rows_j, kvalid, tables=tables,
                        relaxation=relaxation, speculative=speculative, observe=observe)
    p2, r2 = out["pos"], out["rot"]
    if joints is not None:
        p2, r2 = solver.solve_joints(p2, r2, im, ii, joints,
                                     entity_rows(eid, joints["e1"], arch_index),
                                     entity_rows(eid, joints["e2"], arch_index), jmask,
                                     relaxation=relaxation)
    keep = dyn[..., None]
    vals = (torch.where(keep, p2, pos), torch.where(keep, r2, rot),
            torch.where(keep, out["v"], v), torch.where(keep, out["w"], w),
            prev_pos, prev_rot, pos_i, rot_i, v_i, w_i)
    return dict(zip(NODE_KEYS, vals))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def wide_box(tables: pk.ObjTables) -> bool:
    """Whether ``tables`` is an all-box table past a box's BOX_VERTS verts a
    hull, which the kernels of csrc/substep_wide_box_kernels.cu take."""
    return tables.all_box and tables.Vm > BOX_VERTS


# The phases the substep kernels' phase build counts cycles in
# (csrc/substep_kernels.cu's SS_PHASE markers, in their order).
PHASES = ("load", "slots", "integrate", "hull_rows", "positional", "positional_sum",
          "velocity", "velocity_sum", "joint_terms", "writeback")


def _lib(tables: pk.ObjTables = None, phases: bool = False):
    """The substep kernels' library: the wide-box build for wide_box
    ``tables``, else csrc/substep_kernels.cu's, its phase build with
    ``phases`` (phase_cycles)."""
    wide = tables is not None and wide_box(tables)
    if phases and wide:
        raise ValueError("phase_cycles: the wide-box tables have no phase build")
    lib = _build.load("substep_wide_box_kernels" if wide
                      else "substep_phases" if phases else "substep_kernels")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_substep_launch.argtypes = (
            [P] * 19 + [I] * 6 + [F, F, I] + [P] * 10 + [I, I, F] + [P] * 16 + [P] * 5 + [I]
            + [P, P] + [I, P] + [P] + [P])
        lib.fused_substep_launch.restype = I
        lib.world_flags_launch.argtypes = [P] * 15 + [I] * 5 + [F, I, F] + [P] * 4 + [P]
        lib.world_flags_launch.restype = I
        lib.asleep_surface_launch.argtypes = [P] * 8 + [I] * 3 + [P] * 19 + [P]
        lib.asleep_surface_launch.restype = I
        lib.substep_launch.argtypes = ([P] * 18 + [I] * 5 + [F, F, I] + [P] * 4 + [P] + [P, P]
                                       + [P] + [P])
        lib.substep_launch.restype = I
        lib.substep_node_launch.argtypes = (
            [P] * 16 + [I] * 5 + [F, F] + [I] * 3 + [P] * 11 + [I] + [P] * 3 + [I, I, I]
            + [P] * 10 + [P] + [P, P] + [P] + [P])
        lib.substep_node_launch.restype = I
        IP = ctypes.POINTER(ctypes.c_int)
        lib.fused_substep_occupancy.argtypes = [I, I, I, I, IP, IP]
        lib.fused_substep_occupancy.restype = I
        lib.substep_occupancy.argtypes = [I, I, I, I, I, IP, IP]
        lib.substep_occupancy.restype = I
        lib._typed = True
    return lib


def phase_cycles(fn, ctas: int, launches: int = 5) -> dict:
    """The substep launches of ``fn(phases=True)`` (fused_substep's or
    substep_node's ``phases``: the kernels' phase build, its SS_PHASE
    markers): {phase: clock cycles a CTA, averaged over ``launches`` calls of
    fn and ``ctas`` CTAs a call}, each phase ended by a barrier of the
    block.  The phase build's kernels run the same code with those barriers
    and clock reads between the phases; time the kernels as built, not
    these."""
    lib = _lib(phases=True)
    lib.substep_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.substep_phase_cycles.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    fn(phases=True)
    torch.cuda.synchronize()
    if lib.substep_phase_cycles(buf, 1) != 0:
        raise RuntimeError("substep_phase_cycles failed")
    for _ in range(launches):
        fn(phases=True)
    torch.cuda.synchronize()
    if lib.substep_phase_cycles(buf, 1) != 0:
        raise RuntimeError("substep_phase_cycles failed")
    return {name: buf[k] / (launches * ctas) for k, name in enumerate(PHASES)}


def kernel_fits(tables: pk.ObjTables, n: int, K: int, bp: bool = False,
                cache: bool = False, single: bool = False, joints: int = 0) -> str:
    """'' when the kernel takes these tables and shapes (the fused kernel
    with the in-kernel broadphase, with a manifold cache; with ``single``
    kernel 5 with ``joints`` joints), else why not: all-box tables of any
    verts a hull; general hulls of any counts.  The fused kernel with the
    in-kernel broadphase (at most MAX_BP_ROWS rows) refuses staged hull rows
    that do not fit the shared memory the rest of the kernel leaves of
    MAX_SMEM_BYTES ("... hull-row budget").  Without it, a shape past that
    takes the windowed layout (windowed), and past that the bodies in the
    scratch (fused_bodies); kernel 5 takes the bodies in the scratch past
    its window layout (substep_bodies), and its joint rows there too past
    that (substep_joints_in_scratch).  What it refuses the JAX kernels
    refuse too (the in-kernel broadphase past MAX_BP_ROWS rows or its
    shared memory)."""
    if n < 1 or K < 1:
        return f"n={n} bodies and K={K} candidate slots must both be >= 1"
    if bp and n > MAX_BP_ROWS:
        return f"the in-kernel broadphase takes at most {MAX_BP_ROWS} body rows, not {n}"
    if single and substep_bodies(tables, n, K, joints):
        # the bodies in the scratch, and the joints' rows where they do not
        # fit beside the window: the window layout's rest always fits
        return ""
    if not single and windowed(tables, n, K, bp, cache):
        # past one block: the windowed layout, and past that the bodies in
        # the scratch, whose smallest window always fits
        return ""
    need = substep_smem_bytes(n, K, joints) if single else smem_bytes(n, K, bp, cache)
    if need > MAX_SMEM_BYTES:
        return (f"n={n} bodies and K={K} candidate slots need {need} B of "
                f"shared memory, over the {MAX_SMEM_BYTES} B a block may have")
    stage = hull_stage_bytes(tables, n)
    if need + stage > MAX_SMEM_BYTES:
        return (f"general-hull tables staged at {hull_stage_floats(tables)} floats a row "
                f"({tables.Vm} verts, {tables.Em} edge directions, "
                f"{tables.hull_dims()[2]} SAT axes, {tables.Fm} faces) need {stage} B for "
                f"n={n} bodies, over the {MAX_SMEM_BYTES - need} B of the hull-row budget "
                f"(the {MAX_SMEM_BYTES} B a block may have less the kernel's {need} B)")
    return ""


# dtype and width of each argument (0: [W, n], c: [W, n, c]; the world
# and slot arguments by their own shapes)
_SPECS = {"pos": (torch.float32, 3), "rot": (torch.float32, 4), "v": (torch.float32, 3),
          "w": (torch.float32, 3), "prev_pos": (torch.float32, 3),
          "prev_rot": (torch.float32, 4), "im": (torch.float32, 0), "ii": (torch.float32, 3),
          "mu_s": (torch.float32, 0), "mu_d": (torch.float32, 0), "obj": (torch.int32, 0),
          "ext_f": (torch.float32, 3), "ext_t": (torch.float32, 3), "dyn": (torch.bool, 0),
          "scale": (torch.float32, 3), "live": (torch.bool, 0),
          "aabb_lo": (torch.float32, 3), "aabb_hi": (torch.float32, 3),
          "apos": (torch.float32, 3), "arot": (torch.float32, 4), "resp": (torch.int32, 0),
          "mask": (torch.bool, 0)}


def _check_inputs(name, device, bodies, W, n, K, **others):
    """Raise ValueError unless every body argument has its _SPECS dtype and
    shape, every other its own, all on ``device`` and contiguous."""
    checks = [(key, t) + (_SPECS[key][0], (W, n) + ((_SPECS[key][1],) if _SPECS[key][1] else ()))
              for key, t in bodies.items()]
    world = {"h": (torch.float32, (W,)), "gravity": (torch.float32, (W, 3)),
             "restitution_threshold": (torch.float32, (W,)),
             "rows_i": (torch.int32, (W, K)), "rows_j": (torch.int32, (W, K)),
             "kvalid": (torch.bool, (W, K)), "dtv": (torch.float32, (W,)),
             "active": (torch.bool, (W,)), "stable": (torch.bool, (W,)),
             "mcache": (torch.float32, (W, MC_CHANNELS, K)),
             "mcache_out": (torch.float32, (W, MC_CHANNELS, K)),
             "valid": (torch.int32, (W,)), "quiet_steps": (torch.int32, (W,)),
             "delta_t": (torch.float32, (W,))}
    checks += [(key, t) + world[key] for key, t in others.items()]
    for key, t, dt, shape in checks:
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, pos on {device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {dt} {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


# the kernel's option bits (fused_substep_launch's opts); OPT_HULL names
# the general-hull specialisations, which the launch takes for tables with
# general hulls (kOptHull); OPT_BODY the bodies in a global scratch (with
# OPT_WIN)
OPT_REFRESH, OPT_SLEEP, OPT_BP, OPT_PERSIST, OPT_HULL, OPT_WIN = 1, 2, 4, 8, 16, 32
OPT_BODY = 64
BP_KEYS = ("aabb_lo", "aabb_hi", "rows_i", "rows_j", "kvalid", "bp_count", "bp_dropped")


def _hull_args(tables: pk.ObjTables, device):
    """A launch's general-hull arguments: the hull table's pointer and a
    host array of its shape (``hull_dims``), or two nulls for all-box
    tables (the analytic box paths)."""
    t = tables.hull_table(device)
    if t is None:
        return (None, None)
    return (t.data_ptr(), ctypes.cast((ctypes.c_int * 6)(*tables.hull_dims()), ctypes.c_void_p))


def fused_substep(pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
                  h, gravity, restitution_threshold, rows_i, rows_j, kvalid, *,
                  tables: pk.ObjTables, num_substeps: int, relaxation: float = 1.0,
                  speculative: float = 0.0, refresh: bool = False, active=None,
                  bp_degree: int = 0, K: int = 0, scale=None, live=None, dtv=None,
                  persist_margin: float = 0.0, mcache=None, stable=None, aabb_lo=None,
                  aabb_hi=None, mcache_out=None, anchors=None, keep_velocity: bool = False,
                  phases: bool = False):
    """All substeps of one physics step.  Body args [W, n(, 3/4)] (dyn
    bool, obj int32; im, ii, mu_s and mu_d may be None: the kernel reads
    them from its object table); pair args rows_i/rows_j [W, K] int32,
    kvalid [W, K] bool; h, restitution_threshold [W]; gravity [W, 3]; the
    options, mcache_out, anchors and keep_velocity as in
    fused_substep_plain (active, live, stable bool; the rows None with
    bp_degree).  Returns the dict of OUT_KEYS, with bp_degree also BP_KEYS,
    with persist_margin also "mcache" (mcache_out when given).  CPU
    tensors: the plain version.  CUDA tensors: the kernel (with
    persistence and sleep, asleep_surface_kernel first), or a raise (bad
    input, tables or shapes the kernel does not take, a failed launch) —
    never the plain version.  ``phases``: launch the kernels' phase build
    (phase_cycles)."""
    bp, persist = bool(bp_degree), persist_margin > 0.0
    if persist and not (bp and refresh):
        raise ValueError("fused_substep: persist_margin needs bp_degree and refresh")
    if bp and active is not None and not persist:
        raise ValueError("fused_substep: sleep with the in-kernel broadphase needs "
                         "persist_margin")
    if persist and num_substeps < 1:
        raise ValueError("fused_substep: persist_margin needs num_substeps >= 1")
    args = (pos, rot, v, w, im, ii, mu_s, mu_d, obj, ext_f, ext_t, dyn,
            h, gravity, restitution_threshold, rows_i, rows_j, kvalid)
    opts = dict(refresh=refresh, active=active, bp_degree=bp_degree, K=K, scale=scale,
                live=live, dtv=dtv, persist_margin=persist_margin, mcache=mcache,
                stable=stable, aabb_lo=aabb_lo, aabb_hi=aabb_hi, mcache_out=mcache_out,
                anchors=anchors, keep_velocity=keep_velocity)
    kw = dict(tables=tables, num_substeps=num_substeps, relaxation=relaxation,
              speculative=speculative)
    if pos.device.type == "cpu":
        return fused_substep_plain(*args, **kw, **opts)
    W, n = pos.shape[:2]
    if not bp:
        K = rows_i.shape[1]
    why = kernel_fits(tables, n, K, bp, refresh or persist)
    if why:
        raise NotImplementedError(f"fused_substep: {why}")
    dev = pos.device
    named = {k: t for k, t in zip(("pos", "rot", "v", "w", "im", "ii", "mu_s", "mu_d", "obj",
                                   "ext_f", "ext_t", "dyn"), args[:12]) if t is not None}
    if len(named) not in (8, 12):
        raise ValueError("fused_substep: pass all of im, ii, mu_s and mu_d, or none")
    others = dict(h=h, gravity=gravity, restitution_threshold=restitution_threshold)
    if bp:
        named.update(scale=scale, live=live)
        others.update(dtv=dtv)
    else:
        others.update(rows_i=rows_i, rows_j=rows_j, kvalid=kvalid)
    if active is not None:
        others.update(active=active)
    if persist:
        if mcache_out is None:
            mcache_out = mcache.clone()
        named.update(aabb_lo=aabb_lo, aabb_hi=aabb_hi)
        others.update(mcache=mcache, stable=stable, mcache_out=mcache_out)
        if anchors is not None:
            named.update(apos=anchors[0], arot=anchors[1])
            others.update(valid=anchors[2])
    _check_inputs("fused_substep", dev, named, W, n, K, **others)
    table = tables.kernel_table(dev)
    outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=dev)
            for k in OUT_KEYS}
    extra = {}
    if bp:
        extra = {"aabb_lo": torch.empty((W, n, 3), dtype=torch.float32, device=dev),
                 "aabb_hi": torch.empty((W, n, 3), dtype=torch.float32, device=dev),
                 "rows_i": torch.empty((W, K), dtype=torch.int32, device=dev),
                 "rows_j": torch.empty((W, K), dtype=torch.int32, device=dev),
                 "kvalid": torch.empty((W, K), dtype=torch.bool, device=dev),
                 "bp_count": torch.empty((W,), dtype=torch.int32, device=dev),
                 "bp_dropped": torch.empty((W,), dtype=torch.int32, device=dev)}
    if persist:
        extra["mcache"] = mcache_out
    code = fused_route((OPT_REFRESH if refresh else 0) | (OPT_SLEEP if active is not None else 0)
                       | (OPT_BP if bp else 0) | (OPT_PERSIST if persist else 0), tables, n, K)
    window, scratch, bodies = 0, None, None
    if code & OPT_WIN:
        # where the slot layout leaves one CTA an SM: the twin's window (every
        # slot where it fits), the rest in a scratch; past that the bodies in
        # a scratch too
        if code & OPT_BODY:
            bodies = body_scratch(W, n, tables, dev)
        window = fused_layout_window(tables, n, K, refresh)
        scratch = fused_scratch(W, K, window, refresh, dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    work = (None, None)
    if persist and active is not None:
        # the asleep worlds' outputs, and the list of the awake ones
        _, *work = asleep_surface(pos, rot, v, w, active, mcache, aabb_lo, aabb_hi,
                                  outs=outs | extra)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hull = _hull_args(tables, dev)
    rc = _lib(tables, phases).fused_substep_launch(
        *(ptr(t) for t in args), table.data_ptr(),
        tables.O, tables.Vm, W, n, K, int(num_substeps), float(relaxation),
        float(speculative), int(tables.any_restitution),
        *(outs[k].data_ptr() for k in OUT_KEYS),
        code, int(bp_degree), float(0.5 * persist_margin),
        *(ptr(t) for t in (scale, live, dtv, active, stable, mcache, aabb_lo, aabb_hi)),
        *(ptr(extra.get(k)) for k in BP_KEYS + ("mcache",)),
        *(ptr(t) for t in (anchors or (None, None, None))), *(ptr(t) for t in work),
        int(keep_velocity), *hull, window, ptr(scratch), ptr(bodies), stream)
    if rc != 0:
        raise RuntimeError(f"fused_substep: kernel launch failed with cudaError {rc}")
    FusedSubstepKernel.launches += 1
    FusedSubstepKernel.launches_by_options[
        option_name(code | (OPT_HULL if hull[0] else 0))] += 1
    return extra | outs


def asleep_surface_plain(pos, rot, v, w, active, mcache, aabb_lo, aabb_hi):
    """The plain version of asleep_surface_kernel: the outputs of the
    persistent kernel with sleep for an asleep world (fused_substep_plain's
    asleep branch), here for every world — pose and velocity unchanged,
    every stash the current state, the cached rows and kvalid (mcache's
    first three channels), the given AABB columns, count = the cached
    kvalid's sum, nothing dropped — and the list of the awake worlds:
    (dict of OUT_KEYS and BP_KEYS, work_list [W] int32 (the awake worlds
    ascending, then -1), work_count [1] int32)."""
    W = pos.shape[0]
    outs = dict(zip(OUT_KEYS, (pos, rot, v, w, pos, rot, pos, rot, v, w)))
    surface = _cached_surface(mcache, aabb_lo, aabb_hi)
    awake = torch.nonzero(active).reshape(-1).to(torch.int32)
    work_list = torch.full((W,), -1, dtype=torch.int32, device=pos.device)
    work_list[:awake.shape[0]] = awake
    count = torch.full((1,), awake.shape[0], dtype=torch.int32, device=pos.device)
    return outs | surface, work_list, count


def asleep_surface(pos, rot, v, w, active, mcache, aabb_lo, aabb_hi, outs=None):
    """The asleep worlds of the persistent kernel with sleep (see
    asleep_surface_plain), which fused_substep launches before it: CPU
    tensors the plain version (every world's rows).  CUDA tensors:
    asleep_surface_kernel, which writes the rows of the asleep worlds only
    into ``outs`` (fused_substep's outputs; allocated when None, the awake
    worlds' rows then undefined) and lists the awake worlds; or a raise."""
    if pos.device.type == "cpu":
        return asleep_surface_plain(pos, rot, v, w, active, mcache, aabb_lo, aabb_hi)
    W, n = pos.shape[:2]
    K = mcache.shape[2]
    dev = pos.device
    _check_inputs("asleep_surface", dev, dict(pos=pos, rot=rot, v=v, w=w, aabb_lo=aabb_lo,
                                               aabb_hi=aabb_hi), W, n, K,
                  active=active, mcache=mcache)
    if outs is None:
        outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=dev)
                for k in OUT_KEYS}
        outs.update(aabb_lo=torch.empty((W, n, 3), dtype=torch.float32, device=dev),
                    aabb_hi=torch.empty((W, n, 3), dtype=torch.float32, device=dev),
                    rows_i=torch.empty((W, K), dtype=torch.int32, device=dev),
                    rows_j=torch.empty((W, K), dtype=torch.int32, device=dev),
                    kvalid=torch.empty((W, K), dtype=torch.bool, device=dev),
                    bp_count=torch.empty((W,), dtype=torch.int32, device=dev),
                    bp_dropped=torch.empty((W,), dtype=torch.int32, device=dev))
    work = (torch.empty((W,), dtype=torch.int32, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))
    rc = _lib().asleep_surface_launch(
        *(t.data_ptr() for t in (pos, rot, v, w, active, mcache, aabb_lo, aabb_hi)), W, n, K,
        *(outs[k].data_ptr() for k in OUT_KEYS + BP_KEYS), *(t.data_ptr() for t in work),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"asleep_surface: kernel launch failed with cudaError {rc}")
    AsleepSurface.launches += 1
    return (outs,) + work


def world_flags(pos, rot, v, w, ext_f, ext_t, dyn, obj, scale, delta_t, *,
                tables: pk.ObjTables, quiet_steps=None, sleep_threshold: float = 0.0,
                sleep_frames: int = 10, apos=None, arot=None, valid=None,
                persist_margin: float = 0.0):
    """The fused node's world flags (see world_flags_plain, same arguments
    and dict; at least one of the two options).  CPU tensors: the plain
    version.  CUDA tensors: world_flags_kernel (one warp a world, bit for
    bit the plain version), or a raise — never the plain version."""
    sleep, persist = sleep_threshold > 0.0, persist_margin > 0.0
    if not (sleep or persist):
        raise ValueError("world_flags: pass sleep_threshold or persist_margin")
    if pos.device.type == "cpu":
        return world_flags_plain(pos, rot, v, w, ext_f, ext_t, dyn, obj, scale, delta_t,
                                 tables=tables, quiet_steps=quiet_steps,
                                 sleep_threshold=sleep_threshold, sleep_frames=sleep_frames,
                                 apos=apos, arot=arot, valid=valid,
                                 persist_margin=persist_margin)
    W, n = pos.shape[:2]
    dev = pos.device
    named = dict(pos=pos, rot=rot, v=v, w=w, ext_f=ext_f, ext_t=ext_t, dyn=dyn, obj=obj)
    others = {}
    if sleep:
        others.update(quiet_steps=quiet_steps)
    if persist:
        named.update(scale=scale, apos=apos, arot=arot)
        others.update(delta_t=delta_t, valid=valid)
    _check_inputs("world_flags", dev, named, W, n, 0, **others)
    out = {}
    if sleep:
        out.update(quiet_steps=torch.empty((W,), dtype=torch.int32, device=dev),
                   asleep=torch.empty((W,), dtype=torch.int32, device=dev),
                   active=torch.empty((W,), dtype=torch.bool, device=dev))
    if persist:
        out["stable"] = torch.empty((W,), dtype=torch.bool, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    table = tables.kernel_table(dev)
    rc = _lib().world_flags_launch(
        *(ptr(t) for t in (pos, rot, v, w, ext_f, ext_t, dyn, obj,
                           scale if persist else None, delta_t if persist else None,
                           quiet_steps if sleep else None, apos if persist else None,
                           arot if persist else None, valid if persist else None)),
        table.data_ptr(), tables.O, tables.Vm, W, n, (1 if sleep else 0) | (2 if persist else 0),
        float(sleep_threshold ** 2), int(sleep_frames), float(0.5 * persist_margin),
        *(ptr(out.get(k)) for k in ("quiet_steps", "asleep", "active", "stable")),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"world_flags: kernel launch failed with cudaError {rc}")
    WorldFlags.launches += 1
    return out


class WorldFlags:
    """``launches`` counts world_flags_kernel's launches (class-wide)."""

    launches = 0


class AsleepSurface:
    """``launches`` counts asleep_surface_kernel's launches (class-wide),
    one before each launch of the persistent kernel with sleep."""

    launches = 0


SPECIALISATION_CODES = (0, OPT_REFRESH, OPT_SLEEP, OPT_REFRESH | OPT_SLEEP, OPT_BP,
                        OPT_BP | OPT_REFRESH, OPT_PERSIST | OPT_BP | OPT_REFRESH,
                        OPT_PERSIST | OPT_BP | OPT_REFRESH | OPT_SLEEP)


def occupancy(n: int, K: int, single: bool = False, joints=None,
              codes=SPECIALISATION_CODES, hull: pk.ObjTables = None):
    """The kernels' launch shape at n bodies and K slots, on the current
    card: {specialisation name: (threads a CTA, CTAs an SM)} for the fused
    kernel's specialisations ``codes`` (all eight by default; a shape that
    fits only some asks for those), each as a launch at these shapes takes
    it (fused_route: the windowed twin where the slot layout leaves one CTA
    an SM, named "...win"), or (threads, CTAs an SM) of kernel 5 with
    ``single``: without its integrate and joints, or with ``joints`` joints
    its node launch, in the layout the shape takes.  ``hull``: tables with general hulls, for
    the general-hull specialisations with those tables' staged rows.
    Builds the kernels if needed."""
    lib = _lib()
    threads, blocks = ctypes.c_int(), ctypes.c_int()

    def read(rc, what):
        if rc != 0:
            raise RuntimeError(f"occupancy of {what}: cudaError {rc}")
        return threads.value, blocks.value

    floats = 0 if hull is None else hull_stage_floats(hull)
    if hull is not None and not floats:
        raise ValueError("occupancy: hull= takes tables with general hulls")
    if single:
        return read(lib.substep_occupancy(n, K, int(joints or 0), int(joints is not None),
                                          floats, ctypes.byref(threads), ctypes.byref(blocks)),
                    "substep")
    codes = [fused_route(code, hull, n, K) | (OPT_HULL if floats else 0) for code in codes]
    return {option_name(code): read(lib.fused_substep_occupancy(
        code, n, K, floats, ctypes.byref(threads), ctypes.byref(blocks)),
        option_name(code)) for code in codes}


def option_name(code: int) -> str:
    """The kernel specialisation of option bits ``code``: "none", or its
    options joined by "+" (e.g. "refresh+sleep+bp+persist")."""
    names = [n for bit, n in ((OPT_REFRESH, "refresh"), (OPT_SLEEP, "sleep"), (OPT_BP, "bp"),
                              (OPT_PERSIST, "persist"), (OPT_WIN, "win"), (OPT_BODY, "bodies"),
                              (OPT_HULL, "hull"))
             if code & bit]
    return "+".join(names) or "none"


def _scratch_for(scratch, W, K, device):
    """The given kernel-5 scratch (checked), or a new one."""
    if scratch is None:
        return substep_scratch(W, K, device)
    want = (W, SCRATCH_CH, K - SUBSTEP_WINDOW)
    if (K <= SUBSTEP_WINDOW or tuple(scratch.shape) != want or scratch.dtype != torch.float32
            or scratch.device != device or not scratch.is_contiguous()):
        raise ValueError(f"substep: scratch must be float32 {list(want)} on {device}")
    return scratch


def substep(pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn, h,
            restitution_threshold, rows_i, rows_j, kvalid, *, tables: pk.ObjTables,
            relaxation: float = 1.0, speculative: float = 0.0, scratch=None):
    """One substep after the integrate (kernel 5 without its integrate and
    joints).  Body args [W, n(, 3/4)] (dyn bool, obj int32); pair args
    rows_i/rows_j [W, K] int32, kvalid [W, K] bool; h,
    restitution_threshold [W]; ``scratch`` the kernel's global scratch
    (substep_scratch; made when None).  Returns the dict of SUBSTEP_KEYS.
    CPU tensors: the plain version.  CUDA tensors: the kernel, or a raise
    (bad input, tables or shapes the kernel does not take, a failed
    launch) — never the plain version."""
    args = (pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn, h,
            restitution_threshold, rows_i, rows_j, kvalid)
    kw = dict(tables=tables, relaxation=relaxation, speculative=speculative)
    if pos.device.type == "cpu":
        return substep_plain(*args, **kw)
    W, n = im.shape
    K = rows_i.shape[1]
    why = kernel_fits(tables, n, K, single=True)
    if why:
        raise NotImplementedError(f"substep: {why}")
    named = dict(zip(("pos", "rot", "v", "w", "prev_pos", "prev_rot", "im", "ii", "mu_s",
                      "mu_d", "obj", "dyn"), args[:12]))
    _check_inputs("substep", pos.device, named, W, n, K, h=h,
                  restitution_threshold=restitution_threshold, rows_i=rows_i, rows_j=rows_j,
                  kvalid=kvalid)
    scratch = _scratch_for(scratch, W, K, pos.device)
    bodies = body_scratch(W, n, tables, pos.device) if substep_bodies(tables, n, K) else None
    table = tables.kernel_table(pos.device)
    outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=pos.device)
            for k in SUBSTEP_KEYS}
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    hull = _hull_args(tables, pos.device)
    rc = _lib(tables).substep_launch(
        *(t.data_ptr() for t in args), table.data_ptr(), tables.O, tables.Vm, W, n, K,
        float(relaxation), float(speculative), int(tables.any_restitution),
        *(outs[k].data_ptr() for k in SUBSTEP_KEYS),
        0 if scratch is None else scratch.data_ptr(), *hull,
        0 if bodies is None else bodies.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"substep: kernel launch failed with cudaError {rc}")
    SubstepKernel.launches += 1
    SubstepKernel.hull_launches += 1 if hull[0] else 0
    SubstepKernel.body_launches += 0 if bodies is None else 1
    return outs


def _check_joints(device, W, joints, jmask, eid):
    """Raise ValueError unless the joint fields are [W, J(, c)] (the handles
    and joint_type int32, the rest float32), jmask [W, J] bool and the
    entity store's three columns [W, E] int32, all on ``device`` and
    contiguous.  Returns (J, E)."""
    J, E = jmask.shape[1], eid["gen"].shape[1]
    checks = [("jmask", jmask, torch.bool, (W, J))]
    for f, c in JOINT_FIELDS.items():
        dt = torch.int32 if f in ("e1", "e2", "joint_type") else torch.float32
        checks.append((f, joints[f], dt, (W, J) + ((c,) if c else ())))
    checks += [(k, eid[k], torch.int32, (W, E)) for k in ("loc_arch", "loc_row", "gen")]
    for key, t, dt, shape in checks:
        if t.device != device:
            raise ValueError(f"substep_node: {key} on {t.device}, pos on {device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"substep_node: {key} must be {dt} {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"substep_node: {key} must be contiguous")
    return J, E


def substep_node(pos, rot, v, w, obj, resp, mask, ext_f, ext_t, h, gravity,
                 restitution_threshold, rows_i, rows_j, kvalid, *, tables: pk.ObjTables,
                 relaxation: float = 1.0, speculative: float = 0.0, joints, jmask, eid,
                 arch_index: int, scratch=None, phases: bool = False):
    """The kernel-mode substep node of a world with joints in one launch of
    kernel 5: the integrate, steps 2-9, the joint solve and the writeback
    (substep_node_plain, same arguments; ``joints`` the JointConstraint
    field dict, ``jmask`` its row mask, ``eid`` the entity store, all
    required).  Returns the dict of NODE_KEYS.  CPU tensors: the plain
    version.  CUDA tensors: the kernel, or a raise (bad input, tables or
    shapes the kernel does not take, a failed launch) — never the plain
    version.  ``phases``: launch the kernels' phase build (phase_cycles)."""
    args = (pos, rot, v, w, obj, resp, mask, ext_f, ext_t, h, gravity, restitution_threshold,
            rows_i, rows_j, kvalid)
    if pos.device.type == "cpu":
        return substep_node_plain(*args, tables=tables, relaxation=relaxation,
                                  speculative=speculative, joints=joints, jmask=jmask, eid=eid,
                                  arch_index=arch_index)
    W, n = obj.shape
    K = rows_i.shape[1]
    dev = pos.device
    J, E = _check_joints(dev, W, joints, jmask, eid)
    why = kernel_fits(tables, n, K, single=True, joints=J)
    if why:
        raise NotImplementedError(f"substep_node: {why}")
    _check_inputs("substep_node", dev, dict(pos=pos, rot=rot, v=v, w=w, obj=obj, resp=resp,
                                            mask=mask, ext_f=ext_f, ext_t=ext_t), W, n, K,
                  h=h, gravity=gravity, restitution_threshold=restitution_threshold,
                  rows_i=rows_i, rows_j=rows_j, kvalid=kvalid)
    scratch = _scratch_for(scratch, W, K, dev)
    jg = substep_joints_in_scratch(tables, n, K, J)
    bodies = (body_scratch(W, n, tables, dev, J, jg)
              if substep_bodies(tables, n, K, J) else None)
    table = tables.kernel_table(dev)
    outs = {k: torch.empty((W, n, _WIDTH[k]), dtype=torch.float32, device=dev)
            for k in NODE_KEYS}
    hull = _hull_args(tables, dev)
    rc = _lib(tables, phases).substep_node_launch(
        *(t.data_ptr() for t in args), table.data_ptr(), tables.O, tables.Vm, W, n, K,
        float(relaxation), float(speculative), int(tables.any_restitution), RESPONSE_DYNAMIC, J,
        *(joints[f].data_ptr() for f in JOINT_FIELDS), jmask.data_ptr(), E,
        *(eid[k].data_ptr() for k in ("loc_arch", "loc_row", "gen")), int(arch_index),
        ENTITY_ID_BITS, ENTITY_GEN_BITS, *(outs[k].data_ptr() for k in NODE_KEYS),
        0 if scratch is None else scratch.data_ptr(), *hull,
        0 if bodies is None else bodies.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"substep_node: kernel launch failed with cudaError {rc}")
    SubstepKernel.launches += 1
    SubstepKernel.hull_launches += 1 if hull[0] else 0
    SubstepKernel.body_launches += 0 if bodies is None else 1
    SubstepKernel.joint_scratch_launches += int(jg)
    return outs


class SubstepKernel:
    """The single-substep kernel's object (JAX ``SubstepKernel``), for
    worlds with joints: one kernel-5 launch on the card per substep.
    ``step`` is the kernel-mode substep node's launch (substep_node: the
    integrate, the solve, the joints and the writeback, from the state's
    columns), and ``step_plain`` its plain version on the same inputs; a
    call is the JAX kernel's contract, steps 2-9 from the post-integrate
    body columns, returning (pos, rot, v, w).  The kernel's global scratch
    (for worlds whose work overflows its shared window) is made once per
    shape.

    ``launches`` counts the kernel launches (class-wide), ``hull_launches``
    those of its general-hull specialisation (tables with general hulls),
    ``body_launches`` those with the bodies in a global scratch
    (substep_bodies), ``joint_scratch_launches`` those with the joints'
    rows there too (substep_joints_in_scratch)."""

    launches = 0
    hull_launches = 0
    body_launches = 0
    joint_scratch_launches = 0

    def __init__(self, object_manager, relaxation: float = 1.0, speculative: float = 0.0):
        self.tables = pk.ObjTables(object_manager)
        self.relaxation = float(relaxation)
        self.speculative = float(speculative)
        self._scratch = {}

    def scratch(self, W: int, K: int, device):
        """The kernel's global scratch for W worlds and K slots on device
        (substep_scratch), made at first use."""
        key = (torch.device(device), W, K)
        if key not in self._scratch:
            self._scratch[key] = substep_scratch(W, K, device)
        return self._scratch[key]

    def __call__(self, *, pos, rot, v, w, prev_pos, prev_rot, im, ii, mu_s, mu_d, obj, dyn,
                 rows_i, rows_j, kvalid, h, restitution_threshold):
        out = substep(
            pos.contiguous(), rot.contiguous(), v.contiguous(), w.contiguous(),
            prev_pos.contiguous(), prev_rot.contiguous(), im.contiguous(), ii.contiguous(),
            mu_s.contiguous(), mu_d.contiguous(), obj.to(torch.int32).contiguous(),
            dyn.to(torch.bool).contiguous(), h.contiguous(),
            restitution_threshold.contiguous(), rows_i.to(torch.int32).contiguous(),
            rows_j.to(torch.int32).contiguous(), kvalid.to(torch.bool).contiguous(),
            tables=self.tables, relaxation=self.relaxation, speculative=self.speculative,
            scratch=(self.scratch(*rows_i.shape, pos.device) if pos.is_cuda else None))
        return out["pos"], out["rot"], out["v"], out["w"]

    def _node_args(self, *, pos, rot, v, w, obj, resp, mask, ext_f, ext_t, h, gravity,
                   restitution_threshold, rows_i, rows_j, kvalid, joints, jmask, eid,
                   arch_index):
        args = (pos.contiguous(), rot.contiguous(), v.contiguous(), w.contiguous(),
                obj.to(torch.int32).contiguous(), resp.to(torch.int32).contiguous(),
                mask.to(torch.bool).contiguous(), ext_f.contiguous(), ext_t.contiguous(),
                h.contiguous(), gravity.contiguous(), restitution_threshold.contiguous(),
                rows_i.to(torch.int32).contiguous(), rows_j.to(torch.int32).contiguous(),
                kvalid.to(torch.bool).contiguous())
        opts = dict(tables=self.tables, relaxation=self.relaxation, speculative=self.speculative,
                    joints={f: joints[f].contiguous() for f in JOINT_FIELDS},
                    jmask=jmask.to(torch.bool).contiguous(),
                    eid={k: eid[k].contiguous() for k in ("loc_arch", "loc_row", "gen")},
                    arch_index=int(arch_index))
        return args, opts

    def step(self, phases=False, **kw):
        """One substep node's launch (substep_node) on keyword inputs: the
        body columns pos, rot, v, w, obj, resp, mask, ext_f, ext_t; h,
        gravity, restitution_threshold; the candidate rows rows_i, rows_j,
        kvalid; the joints (the JointConstraint field dict), jmask, the
        entity store eid and the body archetype's arch_index.  Returns the
        dict of NODE_KEYS.  ``phases`` as in substep_node."""
        args, opts = self._node_args(**kw)
        if args[0].is_cuda:
            opts.update(scratch=self.scratch(*args[12].shape, args[0].device), phases=phases)
        return substep_node(*args, **opts)

    def step_plain(self, observe=None, **kw):
        """The plain version of ``step`` on the same inputs, on their own
        device (how the kernel is held to it); ``observe`` as in
        fused_substep_plain."""
        args, opts = self._node_args(**kw)
        return substep_node_plain(*args, **opts, observe=observe)


class FusedSubstepKernel:
    """All-substeps driver: one ``fused_substep`` call (one kernel launch on
    the card) per STEP, whatever the substep count.  The JAX driver's
    signature and output dict, with all its options: contact_refresh,
    bp_degree (the in-kernel broadphase over bp_slots(bp_capacity)
    slots), persist_margin (persistent manifolds; needs bp_degree and
    contact_refresh) and sleep (``active``).  ``interpret`` and ``wt`` are
    the TPU kernel's interpret mode and world-block size; only their
    defaults are accepted (one CTA a world is the TPU kernel's wt = 1).

    ``launches`` counts the kernel launches (class-wide), and
    ``launches_by_options`` counts them by specialisation (option_name)."""

    launches = 0
    launches_by_options = collections.Counter()

    def __init__(self, object_manager, num_substeps: int, relaxation: float = 1.0,
                 interpret: bool = False, wt=None, speculative: float = 0.0,
                 contact_refresh: bool = False, bp_degree: int = 0, bp_capacity: int = 0,
                 persist_margin: float = 0.0):
        if interpret or wt is not None:
            raise ValueError("FusedSubstepKernel: interpret and wt are TPU kernel "
                             "settings with no meaning on the card")
        self.tables = pk.ObjTables(object_manager)
        self.num_substeps = int(num_substeps)
        self.relaxation = float(relaxation)
        self.speculative = float(speculative)
        self.contact_refresh = bool(contact_refresh)
        self.bp_degree = int(bp_degree)
        self.bp_capacity = int(bp_capacity)
        self.persist_margin = float(persist_margin)
        if self.persist_margin > 0.0 and not (self.bp_degree and self.contact_refresh):
            raise ValueError("persist_margin requires the in-kernel broadphase (bp_degree) "
                             "and contact_refresh")

    def __call__(self, mcache_out=None, anchors=None, keep_velocity=False, phases=False, **kw):
        """Body args [W, n(, 3/4)] (im, ii, mu_s and mu_d may be None or
        left out: the object tables' at obj); pair args [W, K]; h and
        restitution_threshold [W]; gravity [W, 3]; active [W] (true or 1 =
        awake; None = all awake).  With bp_degree, omit the rows and pass
        scale [W, n, 3] (default ones), live [W, n] (default all) and dtv
        [W] (delta_t x velocity expansion, default 0); with
        persist_margin, also mcache [W, MC_CHANNELS, K], stable [W] and
        the current aabb_lo/hi [W, n, 3], and optionally mcache_out and
        anchors (fused_substep_plain).  Returns the dict of updated
        columns: pos, rot, v, w and the last substep's stashes prev_pos,
        prev_rot, ps_pos, ps_rot, ps_v, ps_w; with bp_degree also
        aabb_lo/hi, rows_i/j [W, K] int32, kvalid [W, K] bool, bp_count
        and bp_dropped [W] int32; with persist_margin also "mcache".
        ``phases`` as in fused_substep."""
        args, opts = self._arguments(**kw)
        return fused_substep(*args, **opts, mcache_out=mcache_out, anchors=anchors,
                             keep_velocity=keep_velocity, phases=phases)

    def plain(self, observe=None, mcache_out=None, anchors=None, keep_velocity=False, **kw):
        """The plain version on the same inputs, on their own device (how
        the kernel is held to it); ``observe`` as in fused_substep_plain."""
        args, opts = self._arguments(**kw)
        return fused_substep_plain(*args, **opts, observe=observe, mcache_out=mcache_out,
                                   anchors=anchors, keep_velocity=keep_velocity)

    def _arguments(self, *, pos, rot, v, w, obj, ext_f, ext_t, dyn, h, gravity,
                   restitution_threshold, im=None, ii=None, mu_s=None, mu_d=None, rows_i=None,
                   rows_j=None, kvalid=None, active=None, scale=None, live=None, dtv=None,
                   mcache=None, stable=None, aabb_lo=None, aabb_hi=None):
        """fused_substep's positional and keyword arguments for a call."""
        W, n = pos.shape[:2]
        dev = pos.device

        def flag(x):
            if x is None or x.dtype == torch.bool:
                return None if x is None else x.contiguous()
            return (x.to(torch.float32) > 0.5).contiguous()

        def opt(x):
            return None if x is None else x.contiguous()

        opts = dict(tables=self.tables, num_substeps=self.num_substeps,
                    relaxation=self.relaxation, speculative=self.speculative,
                    refresh=self.contact_refresh, active=flag(active))
        if self.bp_degree:
            if rows_i is not None or rows_j is not None or kvalid is not None:
                raise ValueError("FusedSubstepKernel: with bp_degree the kernel makes "
                                 "the candidate rows; pass none")
            opts.update(
                bp_degree=self.bp_degree, K=bp_slots(self.bp_capacity),
                scale=(torch.ones((W, n, 3), device=dev) if scale is None
                       else scale.to(torch.float32).contiguous()),
                live=(torch.ones((W, n), dtype=torch.bool, device=dev) if live is None
                      else live.to(torch.bool).contiguous()),
                dtv=(torch.zeros((W,), device=dev) if dtv is None
                     else dtv.to(torch.float32).contiguous()))
        elif rows_i is None or rows_j is None or kvalid is None:
            raise ValueError("FusedSubstepKernel: pass rows_i/rows_j/kvalid (or build "
                             "them with bp_degree)")
        else:
            rows_i, rows_j = (r.to(torch.int32).contiguous() for r in (rows_i, rows_j))
            kvalid = kvalid.to(torch.bool).contiguous()
        if self.persist_margin > 0.0:
            if mcache is None or stable is None or aabb_lo is None or aabb_hi is None:
                raise ValueError("FusedSubstepKernel: persist_margin needs mcache, stable "
                                 "and aabb_lo/aabb_hi")
            opts.update(persist_margin=self.persist_margin, mcache=mcache.contiguous(),
                        stable=flag(stable), aabb_lo=aabb_lo.contiguous(),
                        aabb_hi=aabb_hi.contiguous())
        args = (pos.contiguous(), rot.contiguous(), v.contiguous(), w.contiguous(),
                opt(im), opt(ii), opt(mu_s), opt(mu_d), obj.to(torch.int32).contiguous(),
                ext_f.contiguous(), ext_t.contiguous(),
                dyn.to(torch.bool).contiguous(), h.contiguous(), gravity.contiguous(),
                restitution_threshold.contiguous(), rows_i, rows_j, kvalid)
        return args, opts
