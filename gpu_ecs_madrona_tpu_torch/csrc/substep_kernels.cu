// The physics step's substeps in one kernel for Hopper (sm_90a).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -Xptxas -v
// and called through the plain C function at the end of this file
// (ctypes).  The launch goes on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// fused_substep_kernel<OPTS>
//   Replaces gpu_ecs_madrona_tpu/ops/substep_kernel.py: _run_fused, the
//   unchunked pallas_call (K <= 128, :1257) and the K-slab chunked one
//   (K > 128, :1241) — one kernel for both capacities — and, as
//   compile-time options (OPTS, kOpt*), its contact refresh, world sleep,
//   in-kernel broadphase (:1278) and persistent manifolds (:1214).
//   Computes, per world and for each of num_substeps substeps (the JAX
//   kernel's loop, _make_fused_kernel):
//     1. semi-implicit Euler integrate with the gyroscopic term (_integrate);
//     2. per candidate slot, a gather of both bodies' pose and prev_pos;
//     3. pair_contacts (physics/pairs.py): sphere-sphere, sphere-plane,
//        hull-plane (all hull verts), sphere-box and box-box (Gottschalk's
//        15-axis SAT, the incident face clipped against the reference face,
//        an edge-edge point) for all-box tables; for general hulls the
//        deepest face plane for sphere-hull and the vertex-support SAT over
//        both hulls' SAT axes and their edge directions' cross axes, the
//        incident face (from the face tables) clipped against the reference
//        face's side planes, or an edge-edge point between the supporting
//        full edges; compacted to the deepest 4 points;
//     4. positional_pass; 5. a segment sum to bodies; 6. the pose update and
//        velocity recovery (_apply_positional_recover); 7. a re-gather at the
//        post-solve poses; 8. velocity_pass (restitution channels when any
//        material bounces); 9. a segment sum; non-dynamic rows keep their pose
//        and get zero v/w.
//   The outputs carry the last substep's stashes (prev pose, post-integrate
//   pose and velocities).  Tables with general hulls (a launch given the
//   general-hull rows, pairs.py ObjTables.hull_table) take the kOptHull
//   specialisation of each option set: GEN in solve_substep, the general
//   paths for every hull (boxes too, as in pairs.py) from hull rows staged
//   in shared memory, the hull pairs on lane groups; the all-box tables run
//   the box paths as compiled without it (the same registers, frames and
//   outputs).  No table count is capped: a launch needs only the shared
//   memory for its staged rows; a table whose rows do not fit beside the
//   rest (kMaxSmem) goes to a global scratch with the bodies (kOptBody,
//   below), and only the in-kernel broadphase, which keeps its rows in
//   shared memory, refuses it by name.
//
// world_flags_kernel and asleep_surface_kernel
//   With the persistent manifolds (:1214) they make kernel 9's launch
//   with the fused kernel's "refresh+sleep+bp+persist" specialisation.
//   world_flags_kernel computes the fused node's sleep classifier and
//   stability predicate, which the JAX package compiles into the step's
//   jit program beside its Pallas kernel (gpu_ecs_madrona_tpu/physics/
//   __init__.py:1103-1166).  asleep_surface_kernel writes the asleep
//   worlds' outputs and lists the awake ones; the fused kernel then runs
//   only the listed worlds (CTA b takes list[b]).  The bytes bound them
//   (an asleep world: ~300 B a body, 21 a slot); the design keeps many in
//   flight: a warp a world, its lanes on consecutive floats, 64 warps an
//   SM, no shared memory, where the asleep branch inside the fused kernel
//   held its 86.6 KB CTAs to 8 warps an SM.  The manifold cache stays in
//   place: a world writes it only when it rebuilt (with its anchors and
//   valid flag), and an asleep world reads only its three row channels.
//
// substep_kernel<FULL>
//   Replaces gpu_ecs_madrona_tpu/ops/substep_kernel.py: _run, the
//   single-substep pallas_call (:1165) that worlds with joints take: steps
//   2-9 above once.  FULL is the kernel-mode substep node of such a world
//   in one launch: the integrate from the state's columns (the route's
//   formulas, physics/solver.py integrate, the per-object constants read
//   from the table), steps 2-9, the joint solve (solver.solve_joints, the
//   joints' entity handles looked up here) and the writeback, with the
//   three stashes out; the JAX package runs the integrate and the joints
//   as XLA glue around its kernel (its physics/__init__.py:820-841).
//   Without FULL, steps 2-9 alone from the caller's post-integrate pose and
//   velocities (the JAX kernel's contract).  Both kernels share steps 2-9
//   (solve_substep), so they cannot drift apart.
//   What bounds it: at 1024 worlds x 104 rows, K = 1000 a launch moves
//   W (104 x 217 B + K x 9 B + 84 B) ~ 32 MB (~0.0097 ms); its operations,
//   a few hundred a live pair and ~350 a body, are fewer.  As with the
//   fused kernel, the time is the chain of a world's phases times the
//   worlds an SM cannot overlap.  Design: the shared memory is sized to a
//   window of kWindow work entries, not to K: each valid slot gets a work
//   entry e (build order as build_work), and its rows, pass contributions,
//   stash and body-list entries are indexed by e; an entry past the window
//   lives in the world's slice of a global scratch (touched only by a
//   world with more live pairs than the window; L2-resident).  Nothing
//   K-wide is staged: the slot lists and the work list are built from the
//   caller's rows.  The joints: one thread a joint (a dead one costs its
//   mask), both sides' terms into shared memory; then one thread a body
//   adds side 1's terms over the joints in joint order, then side 2's, and
//   applies them.  Measured (ptxas -v, cudaOccupancyMaxActiveBlocksPer-
//   Multiprocessor at 104 rows, K = 1000, 64 joint rows, H100): window 320,
//   168 registers (the cap of 3 CTAs), no frame, no spills, ~72 KB a world,
//   3 CTAs an SM.  In one A/B at simple_taskgraph's state (PERF.md's
//   findings) a window of 512 at 2 CTAs an SM (200-205 registers, ~107 KB)
//   ran 0.181 ms a node launch, 320 at 3 CTAs 0.157, 200 at 4 CTAs (128
//   registers, a 120-byte spill, most worlds past the window) 0.155, 256
//   threads at 2 CTAs 0.175; the window of 320 keeps most worlds' live
//   pairs in shared memory at no spill.  Past 815 rows (799 with 64 joint
//   rows) the bodies move to a global scratch (kOptBody, below), and where
//   the joints' rows (56 B a joint) do not fit beside the window either
//   (~3,300 joint rows a world), they move there too (Args1::jg).
//
// What bounds them on this card.  At 8192 worlds x 65 rows x K = 256 a
// call moves W (65 x 237 B + K x 9 B + 20 B) ~ 145 MB (~0.043 ms at 3.35
// TB/s); the operations depend on the contacts (a box-box candidate's SAT
// ~420 fp32 operations a substep, its face clip ~760 more when it
// touches, each live contact point ~450 in the two passes: a few GFLOP a
// call, chip_smoke.py counts them), about as long as the bytes at 67
// TFLOP/s.  The kernel is far from both: a world's substep is a chain of
// barrier-separated phases, and in its slot phases one thread carries a
// pair through contacts and a pass as long dependent chains (IEEE
// divisions and square roots, -fmad=false), so the time is the latency of
// the longest chain times the worlds an SM cannot overlap.  Per world
// (clock64 stamps in a build of this kernel, H100): the two slot phases
// take ~80% of the cycles, the body phases ~10%.
//
// Design: one CTA per world, block_threads(n, K) threads (one a slot and a
// body, in whole warps, at most kMaxThreads = 128).  The world's body
// state (current, previous, post-integrate and post-solve pose and
// velocity, the static columns) sits in shared memory, 54 floats a body.
// What the design does about the chain:
//   - no array is indexed at run time (every candidate, axis and side is
//     picked by selects over compile-time indices: pick3, sel_body,
//     deepest4), so nothing lives in local memory but what the register
//     cap spills;
//   - the valid slots are walked in a work list grouped by contact kind
//     (build_work), so a warp runs one or two branches of pair_contacts,
//     not all five;
//   - a thread keeps the manifold of its first work-list entry in
//     registers between the passes: the shared stash holds only the
//     entries past T, which with the per-body channels and the slot
//     arrays lets 4 worlds share an SM at K = 256 (min_blocks caps the
//     no-cache specialisations at 128 registers for that);
//   - in the cache specialisations (2 worlds an SM, registers free) the
//     box-box pairs are taken by groups of kGroup = 4 lanes
//     (warp_box_box, box_box_group): the edge axes, clipped edges and
//     reference vertices split across the group, the argmins and the
//     deepest-4 picks reduced by shuffles; at 128 registers the group's
//     state spills, so the other specialisations keep one lane a pair;
//   - each body's slot lists and the work list are built in parallel
//     (integer atomics for the counts, a warp scan, a stable counting
//     sort by __match_any_sync and ballots), and the in-kernel broadphase
//     tests its pairs in parallel into per-owner bit masks, sums the
//     degrees by popcount and scans them in one warp.
//   The slot loops stop at the world's last valid slot: the chunked TPU
//   kernel's dead-slab skip, by construction, at one-slot granularity.
//   The segment sums are deterministic (no float atomics): one thread per
//   body adds its A-side contributions in ascending slot order, then its
//   B-side ones — the plain version's order — walking its slot list; a
//   non-dynamic body (the plane, which meets every pile body) gets only
//   zero contributions and skips its sum.
//   Measured (ptxas -v, and cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   through fused_substep_occupancy at 65 rows, K = 256 and 128, H100):
//   "none" and "sleep" 128 registers, a 128-byte frame, 138 bytes of spill
//   stores; "bp" 128, 128, 158; all three 4 CTAs an SM.  The cache
//   specialisations 248-255 registers, no frame, no spills, 2 CTAs an SM
//   (shared memory).  The frame of the three capped specialisations
//   is the register cap's spill, kept on purpose: it holds the manifold a
//   thread keeps between the passes (24 floats, so that stash lives in L1
//   rather than registers) and ~10 loop values (nvdisasm of a -lineinfo
//   build); uncapped they take ~220 registers and 2 CTAs an SM, and in one
//   A/B the capped kernel with the spill ran 2.33 ms against 2.93 ms
//   (K = 256; PERF.md's findings).
// The general-hull paths (GEN: hull_hull, sphere_hull, hull_plane) loop
// over the live counts; padded rows score +-1e9 in pairs.py and never tie a
// live one, so the choices are the same.  What bounds them: a prism pair's
// SAT is ~5.8K operations (24 axes over 24 vertices) against a box pair's
// 420, the work list puts the hull pairs first (so, taken as they come, one
// warp of four carries them all, a lane a pair), and a pair's world
// vertices rebuilt per pair need per-thread arrays (local memory).
// The design:
//   - each substep stages every hull row's world vertices, edge
//     directions, SAT axes and face planes once in shared memory
//     (stage_hulls, Hulls: a thread an item), the values the per-pair code
//     computed, so no per-thread array is left and the table's counts are
//     bounded only by that shared memory;
//   - a round's work entries are dealt lane-major across the warps, so the
//     hull pairs at the head of the work list spread over every warp;
//   - each warp's hull pairs run on lane groups (warp_hull_hull: as wide as
//     the pending pairs allow, at least enough for the clip's corners in
//     one pass), the lanes splitting each SAT family's axes, the face
//     choices, the supporting edges and the clip's corners and side
//     planes; minima by fminf shuffles (exact in any order), first indices
//     by shuffle minima of indices, each lane's candidates in a running
//     deepest-4 (Top4, ordered as pairs.py's argmax rounds) merged across
//     the group in (depth, index) order.
// Sphere-hull and hull-plane stay one thread a pair, on the staged rows.
// Measured (H100, the imported prism pile at 8192 x 65, K = 256; PERF.md's
// findings): the "hull" launch 5.40 ms against the one-thread-a-pair
// code's 8.04, bit for bit its outputs; the hull rows ~24 KB of shared
// memory, so "hull", "sleep+hull" 3 CTAs an SM (kHullBlocks: 168
// registers, a 128-byte frame, 122 bytes of spill), "bp+hull" and the cache
// twins 2.  The launch is bound by its issue rate, not by occupancy (2
// CTAs an SM without spills ran as fast as 3 with them), and by the
// passes' chains: dealing only the hull pairs across the warps (the other
// kinds packed by kind) ran 6.05 ms, staging four items' table loads at
// once 6.64, two clip corners a lane 5.64.
// Past one block's shared memory (kOptWin).  The slot layout above keeps
// every slot's rows, pass contributions and stash in shared memory, which at
// rigid_bench's K = 4 x bodies passes the 227 KB a block may have from 239
// bodies (160 with the manifold cache), where JAX's K-slab chunked kernel
// keeps one 128-slot slab in VMEM.  The windowed specialisations of "none"
// and "refresh" (each also with kOptHull; sleep read from a.active at run
// time) take kernel 5's window layout instead: the bodies, the lists'
// offsets and cursors and the staged hull rows stay in shared memory; each
// valid slot's work entry (the same work list, grouped by contact kind)
// keeps its rows, pass contributions, stash, list entries and manifold cache
// in the window when its index is below kw, else in the world's slice of a
// global scratch (kScratchCh channels an entry, kWinCacheCh with the cache),
// which only worlds with more live pairs than the window touch.  The window
// (fused_window) is the most entries that let kWinBlocks CTAs share an SM
// (378 at 256 rows, K = 1020; 220 with the cache), else the most one CTA
// holds; where its bodies, its hull rows and the smallest window (a round
// of the block's threads) pass kMaxSmem, past 968 bodies of boxes (894
// with the cache) and 370 of the imported prism (341), the bodies take a
// global scratch too (kOptBody, below).
// The slot lists, work order, first-entry-in-registers stash and every
// sum's order are the slot layout's, so a windowed launch is bit for bit
// the slot layout's and the plain version's at any window (a serial CPU
// build of this file held windows of 1, 3, half the live pairs and K to the
// slot layout, bit for bit, on rigid_bench piles of 20-255 bodies); the
// shapes that fit one block keep the slot layout and its specialisations
// as compiled before.
// Past the body-row ceilings (kOptBody).  Both window layouts keep a world's
// bodies (kBodyCh = 54 floats a row) and its lists' offsets and cursors (3 n
// + 1 ints) in shared memory, 228 B a body: kernel 5 passes kMaxSmem from
// 816 rows (800 with simple_taskgraph's 64 joint rows), the windowed fused
// specialisations from 969 bodies of boxes (895 with the cache, 371 of the
// imported prism, whose staged hull rows add 368 B a body), where JAX's
// kernels keep them in VMEM.  There those arrays, and the staged hull rows,
// live in the world's slice of a second global scratch (body_scratch_floats
// a world), the rest of the layout in shared memory as before: kernel 5's
// window of kWindow entries and its joints (~50 KB at simple_taskgraph's
// 1,000 objects), the fused kernel's window sized by body_window (695
// entries for kWinBlocks CTAs an SM, 404 with the cache).  The code that
// reads them is the window layouts' (the Smem pointers are generic, so the
// loads and stores address global memory; no cp.async, cvta or
// shared-only intrinsic touches them; __syncthreads and __syncwarp order
// a block's global writes as its shared ones; the cursors' integer atomics
// work on global memory), compiled as twins (substep_kernel<FULL, GEN,
// true>, fused_substep_kernel<kOptWin | kOptBody (| kOptRefresh) (|
// kOptHull)>), so the shapes that fit one block keep their specialisations
// as compiled before, and every sum keeps its order: bit for bit the plain
// version.  What bounds them: a world's rows (~228 KB at 1,024 bodies) stay
// in L1 and L2 while its CTA runs; at the natural occupancy (3 CTAs an SM
// for kernel 5, by its registers; 2 for the fused twin, by its window) the
// worlds in flight hold ~90-130 MB of rows, past the 50 MB L2, and at 1 CTA
// an SM (shared memory padded to one CTA's) ~30 MB.  Measured (H100 80GB
// HBM3, 700 W): kernel 5's node launch at 1024 x 1,004 rows, K = 10,000
// 7.48 ms at 3 CTAs an SM against 12.28 at 1; the fused twin at 8192 x
// 1,024 rows, K = 4,092, 72.3 ms at 2 CTAs an SM against 86.2 at 1: the
// worlds in flight hide the latency of each world's chain better than L2
// hits do, so both keep their natural occupancy, and the padded layout was
// dropped.
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain version (ops/substep_kernel.py,
// physics/pairs.py); 1/sqrtf stands for the plain version's 1 / sqrt.  The
// SAT axis choice treats scores within 1e-5 as tied, first index winning,
// and the deepest-4 choice takes the first of equal depths, as there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;
constexpr float kNegBig = -1e9f;
constexpr float kSatTieEps = 1e-5f;
constexpr float kFaceBias = 1.001f;
constexpr int kMaxBoxVerts = 8;  // table verts per hull, all-box tables (a box has 8)
// All-box tables of any verts a hull (past kMaxBoxVerts: a hand-built or
// merged object manager): this source built again with SUBSTEP_WIDE_BOX
// (substep_wide_box_kernels.cu), whose box-plane path merges every live
// vertex of the row as it reads it, and which builds only the all-box
// specialisations.  This build keeps pairs.py's 12 candidates unrolled in
// registers and takes tables of at most kMaxBoxVerts.
#ifdef SUBSTEP_WIDE_BOX
constexpr bool kWideBox = true;
#else
constexpr bool kWideBox = false;
#endif
// Whether this build has the specialisations of general hulls (gen) or
// of all-box tables (!gen).
constexpr bool builds(bool gen) { return !(kWideBox && gen); }
constexpr int kCand = 12;        // manifold candidates (3 per box-face vertex)
constexpr int kPts = 4;          // manifold points kept
constexpr int kPrimSphere = 0;
constexpr int kPrimHull = 1;
constexpr int kPrimPlane = 2;
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 4;
constexpr int kHullBlocks = 3;   // CTAs an SM the general-hull twins of kMinBlocks' are built for
// A block's shared memory at most (the H100's 227 KB; MAX_SMEM_BYTES in
// ops/substep_kernel.py).
constexpr size_t kMaxSmem = 232448;
constexpr int kGroup = 4;        // lanes a box-box pair (box_box_group)

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scl(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float norm3(V3 a, float eps) { return sqrtf(fmaxf(dot(a, a), eps)); }
__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// qrot / qrot_inv of physics/pairs.py: t = 2 (qv x v); v + t qw + qv x t.
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  const V3 qv = mk(q.x, q.y, q.z);
  const V3 t = scl(cross(qv, v), 2.0f);
  return add(add(v, scl(t, q.w)), cross(qv, t));
}
__device__ __forceinline__ V3 qrot_inv(Q4 q, V3 v) {
  const V3 qv = mk(-q.x, -q.y, -q.z);
  const V3 t = scl(cross(qv, v), 2.0f);
  return add(add(v, scl(t, q.w)), cross(qv, t));
}
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  const float inv = rsq(fmaxf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z, 1e-30f));
  return Q4{q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}
// The route's quaternion arithmetic (physics/solver.py integrate and
// solve_joints, utils/math.py), as PyTorch computes it on the card:
// torch.linalg.cross rounds each component as one fused multiply-add,
// fma(a1, b2, -(a2 b1)) (its CPU kernel does too); quat_rotate is
// v + 2 (w (u x v) + u x (u x v)); quat_normalize is q / max(|q|, 1e-12).
__device__ __forceinline__ V3 cross_t(V3 a, V3 b) {
  return mk(__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}
__device__ __forceinline__ V3 qrot_t(Q4 q, V3 v) {
  const V3 u = mk(q.x, q.y, q.z);
  const V3 uv = cross_t(u, v), uuv = cross_t(u, uv);
  return mk(v.x + 2.0f * (q.w * uv.x + uuv.x), v.y + 2.0f * (q.w * uv.y + uuv.y),
            v.z + 2.0f * (q.w * uv.z + uuv.z));
}
__device__ __forceinline__ V3 qrot_inv_t(Q4 q, V3 v) {
  return qrot_t(Q4{q.w, -q.x, -q.y, -q.z}, v);
}
__device__ __forceinline__ Q4 qnormalize_t(Q4 q) {
  const float d = fmaxf(sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), 1e-12f);
  return Q4{q.w / d, q.x / d, q.y / d, q.z / d};
}
// A rotation vector's quaternion delta (solver._apply_rot_delta).
__device__ __forceinline__ Q4 rot_delta_t(Q4 r, V3 dw) {
  const Q4 d = qmul(Q4{0.0f, dw.x, dw.y, dw.z}, r);
  return qnormalize_t(Q4{r.w + 0.5f * d.w, r.x + 0.5f * d.x, r.y + 0.5f * d.y, r.z + 0.5f * d.z});
}

// Rotation-matrix columns (the box's local axes in world space).
__device__ __forceinline__ void quat_axes(Q4 q, V3 u[3]) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  u[0] = mk(1.0f - 2.0f * (yy + zz), 2.0f * (xy + wz), 2.0f * (xz - wy));
  u[1] = mk(2.0f * (xy - wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz + wx));
  u[2] = mk(2.0f * (xz + wy), 2.0f * (yz - wx), 1.0f - 2.0f * (xx + yy));
}

// World-frame inverse inertia R diag(ii) R^T as (m00 m01 m02 m11 m12 m22).
struct Sym {
  float m00, m01, m02, m11, m12, m22;
};
__device__ __forceinline__ Sym sym_from(Q4 q, V3 ii) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const float r00 = 1.0f - 2.0f * (yy + zz), r10 = 2.0f * (xy + wz), r20 = 2.0f * (xz - wy);
  const float r01 = 2.0f * (xy - wz), r11 = 1.0f - 2.0f * (xx + zz), r21 = 2.0f * (yz + wx);
  const float r02 = 2.0f * (xz + wy), r12 = 2.0f * (yz - wx), r22 = 1.0f - 2.0f * (xx + yy);
  const float i0 = ii.x, i1 = ii.y, i2 = ii.z;
  return Sym{i0 * r00 * r00 + i1 * r01 * r01 + i2 * r02 * r02,
             i0 * r00 * r10 + i1 * r01 * r11 + i2 * r02 * r12,
             i0 * r00 * r20 + i1 * r01 * r21 + i2 * r02 * r22,
             i0 * r10 * r10 + i1 * r11 * r11 + i2 * r12 * r12,
             i0 * r10 * r20 + i1 * r11 * r21 + i2 * r12 * r22,
             i0 * r20 * r20 + i1 * r21 * r21 + i2 * r22 * r22};
}
__device__ __forceinline__ V3 sym_mv(const Sym& M, V3 v) {
  return mk(M.m00 * v.x + M.m01 * v.y + M.m02 * v.z, M.m01 * v.x + M.m11 * v.y + M.m12 * v.z,
            M.m02 * v.x + M.m12 * v.y + M.m22 * v.z);
}

// The object table row (pairs.py ObjTables.kernel_table): prim_type,
// sphere_radius, box_half xyz, restitution, num_verts, verts (vm x 3),
// local_aabb_lo xyz, local_aabb_hi xyz, inv_mass, inv_inertia xyz, mu_s,
// mu_d, bound_radius: kTableFixed + 3 vm floats.
constexpr int kTableFixed = 20;
// The general-hull rows' layout (Table::h): the counts, a face's head
// (normal, offset) and a corner slot's floats.
constexpr int kHullHead = 4;
constexpr int kFaceHead = 4;
constexpr int kCornerFl = 11;
struct Table {
  const float* t;
  int stride;
  int vm;
  __device__ __forceinline__ float aabb_lo(int o, int k) const {
    return t[o * stride + 7 + 3 * vm + k];
  }
  __device__ __forceinline__ float aabb_hi(int o, int k) const {
    return t[o * stride + 10 + 3 * vm + k];
  }
  __device__ __forceinline__ float inv_mass(int o) const { return t[o * stride + 13 + 3 * vm]; }
  __device__ __forceinline__ float inv_inertia(int o, int k) const {
    return t[o * stride + 14 + 3 * vm + k];
  }
  __device__ __forceinline__ float mu_s(int o) const { return t[o * stride + 17 + 3 * vm]; }
  __device__ __forceinline__ float mu_d(int o) const { return t[o * stride + 18 + 3 * vm]; }
  __device__ __forceinline__ float bound_radius(int o) const {
    return t[o * stride + 19 + 3 * vm];
  }
  __device__ __forceinline__ int prim(int o) const { return static_cast<int>(t[o * stride]); }
  __device__ __forceinline__ float radius(int o) const { return t[o * stride + 1]; }
  __device__ __forceinline__ float half(int o, int k) const { return t[o * stride + 2 + k]; }
  __device__ __forceinline__ float rest(int o) const { return t[o * stride + 5]; }
  __device__ __forceinline__ int nverts(int o) const { return static_cast<int>(t[o * stride + 6]); }
  __device__ __forceinline__ V3 vert(int o, int v) const {
    const float* p = t + o * stride + 7 + 3 * v;
    return mk(p[0], p[1], p[2]);
  }
  // The general-hull rows (pairs.py ObjTables.hull_table; null for all-box
  // tables), hs floats an object: the counts of its faces, SAT axes, edge
  // directions and full edges; fm faces of kFaceHead + kCornerFl fvm floats
  // (the outward normal and offset, then each corner slot's vertex, next
  // vertex, side-plane normal and offset, and valid flag); sm SAT axes, em
  // edge directions, efm full edges (two endpoints): the object's frame.
  const float* h;
  int hs, fm, sm, em, fvm, efm;
  __device__ __forceinline__ int nfaces(int o) const { return static_cast<int>(__ldg(h + o * hs)); }
  __device__ __forceinline__ int nsat(int o) const { return static_cast<int>(__ldg(h + o * hs + 1)); }
  __device__ __forceinline__ int nedges(int o) const {
    return static_cast<int>(__ldg(h + o * hs + 2));
  }
  __device__ __forceinline__ int nfull(int o) const { return static_cast<int>(__ldg(h + o * hs + 3)); }
  __device__ __forceinline__ const float* face(int o, int f) const {
    return h + o * hs + kHullHead + f * (kFaceHead + kCornerFl * fvm);
  }
  __device__ __forceinline__ const float* sat(int o, int k) const {
    return h + o * hs + kHullHead + fm * (kFaceHead + kCornerFl * fvm) + 3 * k;
  }
  __device__ __forceinline__ const float* edge_dir(int o, int k) const {
    return sat(o, sm) + 3 * k;
  }
  __device__ __forceinline__ const float* full_edge(int o, int k) const {
    return sat(o, sm) + 3 * em + 6 * k;
  }
};

struct Body {
  V3 pos;
  Q4 rot;
  int obj;
};

struct Manifold {
  bool ok;
  V3 n;
  V3 p[kPts];
  float d[kPts];
};

// First index of the minimum of s[0..m), scores within eps of it tied.
template <int M>
__device__ __forceinline__ int argmin_tie(const float (&s)[M], float eps, float* ext) {
  float e = s[0];
#pragma unroll
  for (int i = 1; i < M; ++i) e = fminf(e, s[i]);
  int first = 0;
#pragma unroll
  for (int i = M - 1; i >= 0; --i)
    if (s[i] <= e + eps) first = i;
  *ext = e;
  return first;
}

// Element i (0..2, known only at run time) of a 3-array, by selects: an
// array indexed at run time would live in local memory.
template <typename T>
__device__ __forceinline__ T pick3(const T (&x)[3], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}
__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) {
  return mk(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z);
}
__device__ __forceinline__ V3 pick3(const V3 (&x)[3], int i) {
  return sel3(i == 0, x[0], sel3(i == 1, x[1], x[2]));
}

// The face of a box most aligned with `outward`, as clip inputs.
struct BoxFace {
  V3 poly[4];
  V3 side_n[4];
  float side_d[4];
  V3 n;
  float d;
};
__device__ __forceinline__ void box_face(V3 pos, const V3 (&u)[3], const float (&h)[3],
                                         V3 outward, BoxFace& f) {
  float score[3], mag[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    score[k] = dot(u[k], outward);
    mag[k] = fabsf(score[k]);
  }
  int sel = mag[1] > mag[0] ? 1 : 0;
  if (mag[2] > pick3(mag, sel)) sel = 2;
  const float sgn = pick3(score, sel) >= 0.0f ? 1.0f : -1.0f;
  const int s1 = (sel + 1) % 3, s2 = (sel + 2) % 3;
  const V3 n = scl(pick3(u, sel), sgn);
  const float hn = pick3(h, sel);
  const V3 a = pick3(u, s1), b = pick3(u, s2);
  const float ha = pick3(h, s1), hb = pick3(h, s2);
  f.n = n;
  f.d = dot(n, pos) + hn;
  const V3 center = add(pos, scl(n, hn));
  const float sa[4] = {1.0f, -1.0f, -1.0f, 1.0f};
  const float sb[4] = {1.0f, 1.0f, -1.0f, -1.0f};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    f.poly[c] = add(center, add(scl(a, sa[c] * ha), scl(b, sb[c] * hb)));
  const float da = dot(a, pos), db = dot(b, pos);
  f.side_n[0] = a;
  f.side_d[0] = da + ha;
  f.side_n[1] = scl(a, -1.0f);
  f.side_d[1] = -da + ha;
  f.side_n[2] = b;
  f.side_d[2] = db + hb;
  f.side_n[3] = scl(b, -1.0f);
  f.side_d[3] = -db + hb;
}

// Supporting edge of a box along the winning cross axis.
__device__ __forceinline__ void box_edge(V3 pos, const V3 (&u)[3], const float (&h)[3], int e,
                                         V3 n_dir, V3* e0, V3* e1) {
  float selw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) selw[k] = (e == k) ? 1.0f : 0.0f;
  const V3 u_sel = mk(selw[0] * u[0].x + selw[1] * u[1].x + selw[2] * u[2].x,
                      selw[0] * u[0].y + selw[1] * u[1].y + selw[2] * u[2].y,
                      selw[0] * u[0].z + selw[1] * u[1].z + selw[2] * u[2].z);
  V3 off = mk(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sk = dot(n_dir, u[k]) >= 0.0f ? 1.0f : -1.0f;
    off = add(off, scl(u[k], (1.0f - selw[k]) * sk * h[k]));
  }
  const float h_sel = selw[0] * h[0] + selw[1] * h[1] + selw[2] * h[2];
  const V3 mid = add(pos, off);
  const V3 arm = scl(u_sel, h_sel);
  *e0 = sub(mid, arm);
  *e1 = add(mid, arm);
}

__device__ V3 segment_closest(V3 a0, V3 a1, V3 b0, V3 b1) {
  const V3 d1v = sub(a1, a0), d2v = sub(b1, b0), rv = sub(a0, b0);
  const float a_ = dot(d1v, d1v), e_ = dot(d2v, d2v), f_ = dot(d2v, rv);
  const float c_ = dot(d1v, rv), b_ = dot(d1v, d2v);
  const float denom = a_ * e_ - b_ * b_;
  float s_ = clamp01(fabsf(denom) > 1e-12f ? (b_ * f_ - c_ * e_) / denom : 0.0f);
  const float t_ = clamp01((b_ * s_ + f_) / fmaxf(e_, 1e-12f));
  s_ = clamp01((b_ * t_ - c_) / fmaxf(a_, 1e-12f));
  const V3 cA = add(a0, scl(d1v, s_));
  const V3 cB = add(b0, scl(d2v, t_));
  return scl(add(cA, cB), 0.5f);
}

// Box-box contact: OBB SAT, then the incident-face clip or the edge point.
// Fills the kCand candidates; returns hit, sets the normal and point count.
__device__ __forceinline__ bool box_box(const Body& A, const Body& B, const Table& tab,
                                        float spec, V3 (&cp)[kCand], float (&cd)[kCand],
                                        V3* normal, int* num) {
  V3 uA[3], uB[3];
  quat_axes(A.rot, uA);
  quat_axes(B.rot, uB);
  const float hA[3] = {tab.half(A.obj, 0), tab.half(A.obj, 1), tab.half(A.obj, 2)};
  const float hB[3] = {tab.half(B.obj, 0), tab.half(B.obj, 1), tab.half(B.obj, 2)};
  const V3 d = sub(B.pos, A.pos);
  float t[3], s[3], M[3][3], aM[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = dot(uA[i], d);
    s[i] = dot(uB[i], d);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[i][j] = dot(uA[i], uB[j]);
      aM[i][j] = fabsf(M[i][j]) + 1e-6f;
    }
  float penA[3], penB[3], penE[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    penA[i] = hA[i] + aM[i][0] * hB[0] + aM[i][1] * hB[1] + aM[i][2] * hB[2] - fabsf(t[i]);
    penB[i] = hB[i] + aM[0][i] * hA[0] + aM[1][i] * hA[1] + aM[2][i] * hA[2] - fabsf(s[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
      const float rA = hA[i1] * aM[i2][j] + hA[i2] * aM[i1][j];
      const float rB = hB[j1] * aM[i][j2] + hB[j2] * aM[i][j1];
      const float tL = fabsf(t[i2] * M[i1][j] - t[i1] * M[i2][j]);
      const float len2 = 1.0f - M[i][j] * M[i][j];
      const float pen = (rA + rB - tL) * rsq(fmaxf(len2, 1e-12f));
      penE[3 * i + j] = len2 > 1e-8f ? pen : kBig;
    }
  }
  float minA, minB, minE;
  const int ia = argmin_tie(penA, kSatTieEps, &minA);
  const int ib = argmin_tie(penB, kSatTieEps, &minB);
  const int ie = argmin_tie(penE, kSatTieEps, &minE);
  const int eA = ie / 3, eB = ie % 3;
  V3 fE = cross(pick3(uA, eA), pick3(uB, eB));
  fE = scl(fE, 1.0f / fmaxf(norm3(fE, 1e-30f), 1e-12f));

  const float sat_pen = fminf(fminf(minA, minB), minE);
  const bool hit = (sat_pen > -spec) && (sat_pen < kBig * 0.5f);
  const bool faceA = minA <= fminf(minB, minE) * kFaceBias + kSatTieEps;
  const bool faceB = !faceA && (minB <= minE * kFaceBias + kSatTieEps);
  const V3 ab = sub(B.pos, A.pos);
  const V3 f = sel3(faceA, pick3(uA, ia), sel3(faceB, pick3(uB, ib), fE));
  const V3 nrm = scl(f, dot(f, ab) >= 0.0f ? 1.0f : -1.0f);
  *normal = nrm;
#pragma unroll
  for (int c = 0; c < kCand; ++c) {
    cp[c] = mk(0.0f, 0.0f, 0.0f);
    cd[c] = kNegBig;
  }
  if (!faceA && !faceB) {
    // edge-edge: one point, the midpoint of the supporting edges' closest
    // points, at the SAT depth
    V3 a0, a1, b0, b1;
    box_edge(A.pos, uA, hA, eA, nrm, &a0, &a1);
    box_edge(B.pos, uB, hB, eB, scl(nrm, -1.0f), &b0, &b1);
    cp[0] = segment_closest(a0, a1, b0, b1);
    cd[0] = sat_pen;
  } else {
    // incident face clipped against the reference face's side planes; the
    // reference (R) and incident (I) boxes by value selects, not by
    // pointers into the two, which would put them in local memory
    const V3 nrm_inc = faceB ? scl(nrm, -1.0f) : nrm;
    V3 uR[3], uI[3];
    float hR[3], hI[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uR[k] = sel3(faceB, uB[k], uA[k]);
      uI[k] = sel3(faceB, uA[k], uB[k]);
      hR[k] = faceB ? hB[k] : hA[k];
      hI[k] = faceB ? hA[k] : hB[k];
    }
    BoxFace fi, fr;
    box_face(sel3(faceB, A.pos, B.pos), uI, hI, scl(nrm_inc, -1.0f), fi);
    box_face(sel3(faceB, B.pos, A.pos), uR, hR, nrm_inc, fr);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const V3 p0 = fi.poly[c], p1 = fi.poly[(c + 1) % 4];
      float t_lo = 0.0f, t_hi = 1.0f;
      bool empty = false;
#pragma unroll
      for (int sd = 0; sd < 4; ++sd) {
        const float d0 = dot(p0, fr.side_n[sd]) - fr.side_d[sd];
        const float d1 = dot(p1, fr.side_n[sd]) - fr.side_d[sd];
        const float denom = d0 - d1;
        const bool crossing = fabsf(denom) > 1e-12f;
        const float tc = d0 / (crossing ? denom : 1.0f);
        if (crossing && d0 > 0.0f && d1 <= 0.0f) t_lo = fmaxf(t_lo, tc);
        if (crossing && d0 <= 0.0f && d1 > 0.0f) t_hi = fminf(t_hi, tc);
        empty = empty || (d0 > 1e-6f && d1 > 1e-6f);
      }
      const bool edge_ok = !empty && (t_lo <= t_hi + 1e-9f);
      const V3 seg = sub(p1, p0);
      const V3 pt_lo = add(p0, scl(seg, t_lo));
      const V3 pt_hi = add(p0, scl(seg, t_hi));
      cp[c] = pt_lo;
      cd[c] = edge_ok ? fr.d - dot(pt_lo, fr.n) : kNegBig;
      cp[4 + c] = pt_hi;
      cd[4 + c] = (edge_ok && t_hi < 0.9999f) ? fr.d - dot(pt_hi, fr.n) : kNegBig;
    }
    const float den = dot(fi.n, nrm_inc);
    const bool den_ok = fabsf(den) > 0.1f;
    const float den_s = den_ok ? den : 1.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const V3 pr = fr.poly[c];
      bool inside = true;
#pragma unroll
      for (int sd = 0; sd < 4; ++sd)
        inside = inside && (dot(pr, fi.side_n[sd]) - fi.side_d[sd] <= -1e-5f);
      const float sq = (fi.d - dot(pr, fi.n)) / den_s;
      const V3 q = add(pr, scl(nrm_inc, sq));
      cp[8 + c] = q;
      cd[8 + c] = (inside && den_ok) ? fr.d - dot(q, fr.n) : kNegBig;
    }
  }
  int cnt = 0;
#pragma unroll
  for (int c = 0; c < kCand; ++c) cnt += cd[c] > 0.0f ? 1 : 0;
  *num = cnt;
  return hit;
}

// Sphere against box: clamp the centre into the box frame.  Returns the
// contact decision; flip = the sphere is side B.
__device__ __forceinline__ bool sphere_box(V3 s_pos, float s_rad, const Body& Bx,
                                           const Table& tab, float spec, bool flip, V3* normal,
                                           V3* point, float* pen_out) {
  V3 u[3];
  quat_axes(Bx.rot, u);
  const float h[3] = {tab.half(Bx.obj, 0), tab.half(Bx.obj, 1), tab.half(Bx.obj, 2)};
  const V3 d = sub(s_pos, Bx.pos);
  float cl[3], q[3], fd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cl[k] = dot(u[k], d);
    q[k] = fminf(fmaxf(cl[k], -h[k]), h[k]);
    fd[k] = h[k] - fabsf(cl[k]);
  }
  const bool inside = (fabsf(cl[0]) < h[0]) && (fabsf(cl[1]) < h[1]) && (fabsf(cl[2]) < h[2]);
  const V3 q_w = mk(q[0] * u[0].x + q[1] * u[1].x + q[2] * u[2].x,
                    q[0] * u[0].y + q[1] * u[1].y + q[2] * u[2].y,
                    q[0] * u[0].z + q[1] * u[1].z + q[2] * u[2].z);
  const V3 delta = sub(d, q_w);
  const float dist = norm3(delta, 1e-18f);
  const V3 n_out = scl(delta, 1.0f / dist);
  int ax = fd[1] < fd[0] ? 1 : 0;
  if (fd[2] < pick3(fd, ax)) ax = 2;
  const V3 n_in = scl(pick3(u, ax), pick3(cl, ax) >= 0.0f ? 1.0f : -1.0f);
  const V3 nrm_hs = inside ? n_in : n_out;
  const float pen = inside ? s_rad + pick3(fd, ax) : s_rad - dist;
  *normal = flip ? nrm_hs : scl(nrm_hs, -1.0f);
  *point = add(Bx.pos, q_w);
  *pen_out = pen;
  return pen > -spec;
}

__device__ __forceinline__ V3 plane_normal(Q4 rot) {
  return qrot(rot, mk(0.0f, 0.0f, 1.0f));
}

// One of two bodies, by value selects (a reference chosen at run time
// would put both in local memory).
__device__ __forceinline__ Body sel_body(bool c, const Body& a, const Body& b) {
  Body r;
  r.pos = sel3(c, a.pos, b.pos);
  r.rot = Q4{c ? a.rot.w : b.rot.w, c ? a.rot.x : b.rot.x, c ? a.rot.y : b.rot.y,
             c ? a.rot.z : b.rot.z};
  r.obj = c ? a.obj : b.obj;
  return r;
}

// The deepest 4 of kCand candidates, as pairs.py's compaction: each pick
// the first index of the largest depth, which is then set to -1e9 (so that
// once the real candidates are taken, the first candidate at -1e9 is taken
// again).  Every index is known at compile time: no local memory.
__device__ __forceinline__ void deepest4(const V3 (&cp)[kCand], float (&cd)[kCand],
                                         Manifold& out) {
#pragma unroll
  for (int s = 0; s < kPts; ++s) {
    float bv = cd[0];
    V3 bp = cp[0];
    int best = 0;
#pragma unroll
    for (int c = 1; c < kCand; ++c) {
      const bool gt = cd[c] > bv;
      bv = gt ? cd[c] : bv;
      bp = sel3(gt, cp[c], bp);
      best = gt ? c : best;
    }
    out.d[s] = bv;
    out.p[s] = bp;
#pragma unroll
    for (int c = 0; c < kCand; ++c) cd[c] = best == c ? kNegBig : cd[c];
  }
}

// deepest4 of one candidate (p0, d0) and kCand - 1 empty ones (the origin
// at -1e9), in closed form: (p0, d0) then p0 at -1e9 three times, or, when
// d0 < -1e9, the origin at -1e9 four times.
__device__ __forceinline__ void single_point(V3 p0, float d0, Manifold& out) {
  const bool keep = !(d0 < kNegBig);
  const V3 p = sel3(keep, p0, mk(0.0f, 0.0f, 0.0f));
  out.d[0] = keep ? d0 : kNegBig;
  out.p[0] = p;
#pragma unroll
  for (int s = 1; s < kPts; ++s) {
    out.d[s] = kNegBig;
    out.p[s] = p;
  }
}

// Element (r, c) of a 3 x 3 array, both known only at run time, by selects.
__device__ __forceinline__ float pick33(const float (&m)[3][3], int r, int c) {
  const float row[3] = {pick3(m[0], c), pick3(m[1], c), pick3(m[2], c)};
  return pick3(row, r);
}
__device__ __forceinline__ V3 pick4(const V3 (&x)[4], int i) {
  return sel3(i == 0, x[0], sel3(i == 1, x[1], sel3(i == 2, x[2], x[3])));
}

// box_box by the kGroup lanes of a group (mask gmask, this lane the s-th):
// box_box's arithmetic term by term, the work split across the group.
// Each lane computes the face axes and the shared setup itself; lane s
// takes the edge axes s, s + kGroup, ... and the clip's edge and
// reference vertex s, s + kGroup, ... (candidates x, 4 + x and 8 + x of
// each); the argmins and the deepest-4 picks (largest depth, first index
// on ties) reduce across the group by shuffles.  Every lane of the group
// returns the manifold and the count of candidates past 0.  The minimum
// over the edge axes is taken in another order than box_box's fold: only
// the sign of a zero could differ, and no NaN is expected.
__device__ __forceinline__ void box_box_group(const Body& A, const Body& B, const Table& tab,
                                           float spec, int s, unsigned gmask, int gbase,
                                           Manifold& out, int* num) {
  constexpr int kEdgeAx = (9 + kGroup - 1) / kGroup;  // edge axes a lane
  constexpr int kQuads = 4 / kGroup;                  // clip edges a lane
  V3 uA[3], uB[3];
  quat_axes(A.rot, uA);
  quat_axes(B.rot, uB);
  const float hA[3] = {tab.half(A.obj, 0), tab.half(A.obj, 1), tab.half(A.obj, 2)};
  const float hB[3] = {tab.half(B.obj, 0), tab.half(B.obj, 1), tab.half(B.obj, 2)};
  const V3 d = sub(B.pos, A.pos);
  float t[3], sv[3], M[3][3], aM[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = dot(uA[i], d);
    sv[i] = dot(uB[i], d);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[i][j] = dot(uA[i], uB[j]);
      aM[i][j] = fabsf(M[i][j]) + 1e-6f;
    }
  float penA[3], penB[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    penA[i] = hA[i] + aM[i][0] * hB[0] + aM[i][1] * hB[1] + aM[i][2] * hB[2] - fabsf(t[i]);
    penB[i] = hB[i] + aM[0][i] * hA[0] + aM[1][i] * hA[1] + aM[2][i] * hA[2] - fabsf(sv[i]);
  }
  // this lane's edge axes e = s + kGroup r
  float pe[kEdgeAx];
  const float inf = __int_as_float(0x7f800000);
  float minE = inf;
#pragma unroll
  for (int r = 0; r < kEdgeAx; ++r) {
    const int e = s + kGroup * r;
    const int i = e / 3, j = e % 3;
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3, j1 = (j + 1) % 3, j2 = (j + 2) % 3;
    const float rA = pick3(hA, i1) * pick33(aM, i2, j) + pick3(hA, i2) * pick33(aM, i1, j);
    const float rB = pick3(hB, j1) * pick33(aM, i, j2) + pick3(hB, j2) * pick33(aM, i, j1);
    const float tL =
        fabsf(pick3(t, i2) * pick33(M, i1, j) - pick3(t, i1) * pick33(M, i2, j));
    const float mij = pick33(M, i, j);
    const float len2 = 1.0f - mij * mij;
    const float pen = (rA + rB - tL) * rsq(fmaxf(len2, 1e-12f));
    pe[r] = e < 9 ? (len2 > 1e-8f ? pen : kBig) : inf;
    minE = fminf(minE, pe[r]);
  }
  for (int m = 1; m < kGroup; m <<= 1) minE = fminf(minE, __shfl_xor_sync(gmask, minE, m));
  int ie = 99;
#pragma unroll
  for (int r = kEdgeAx - 1; r >= 0; --r)
    if (s + kGroup * r < 9 && pe[r] <= minE + kSatTieEps) ie = s + kGroup * r;
  for (int m = 1; m < kGroup; m <<= 1) ie = min(ie, __shfl_xor_sync(gmask, ie, m));
  ie = ie == 99 ? 0 : ie;
  float minA, minB;
  const int ia = argmin_tie(penA, kSatTieEps, &minA);
  const int ib = argmin_tie(penB, kSatTieEps, &minB);
  const int eA = ie / 3, eB = ie % 3;
  V3 fE = cross(pick3(uA, eA), pick3(uB, eB));
  fE = scl(fE, 1.0f / fmaxf(norm3(fE, 1e-30f), 1e-12f));

  const float sat_pen = fminf(fminf(minA, minB), minE);
  const bool hit = (sat_pen > -spec) && (sat_pen < kBig * 0.5f);
  const bool faceA = minA <= fminf(minB, minE) * kFaceBias + kSatTieEps;
  const bool faceB = !faceA && (minB <= minE * kFaceBias + kSatTieEps);
  const V3 ab = sub(B.pos, A.pos);
  const V3 f = sel3(faceA, pick3(uA, ia), sel3(faceB, pick3(uB, ib), fE));
  const V3 nrm = scl(f, dot(f, ab) >= 0.0f ? 1.0f : -1.0f);
  out.ok = hit;
  out.n = nrm;
  if (!faceA && !faceB) {
    // edge-edge: one point at the SAT depth (every lane alike)
    V3 a0, a1, b0, b1;
    box_edge(A.pos, uA, hA, eA, nrm, &a0, &a1);
    box_edge(B.pos, uB, hB, eB, scl(nrm, -1.0f), &b0, &b1);
    single_point(segment_closest(a0, a1, b0, b1), sat_pen, out);
    *num = sat_pen > 0.0f ? 1 : 0;
    return;
  }
  const V3 nrm_inc = faceB ? scl(nrm, -1.0f) : nrm;
  V3 uR[3], uI[3];
  float hR[3], hI[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uR[k] = sel3(faceB, uB[k], uA[k]);
    uI[k] = sel3(faceB, uA[k], uB[k]);
    hR[k] = faceB ? hB[k] : hA[k];
    hI[k] = faceB ? hA[k] : hB[k];
  }
  BoxFace fi, fr;
  box_face(sel3(faceB, A.pos, B.pos), uI, hI, scl(nrm_inc, -1.0f), fi);
  box_face(sel3(faceB, B.pos, A.pos), uR, hR, nrm_inc, fr);
  const float den = dot(fi.n, nrm_inc);
  const bool den_ok = fabsf(den) > 0.1f;
  const float den_s = den_ok ? den : 1.0f;
  // this lane's candidates, local entry k * kQuads + q: candidate x + 4 k
  // of x = s + kGroup q (k = 0: the clipped edge's low end, 1: its high
  // end, 2: the reference vertex)
  V3 cp[3 * kQuads];
  float cd[3 * kQuads];
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int x = s + kGroup * q;
    const V3 p0 = pick4(fi.poly, x), p1 = pick4(fi.poly, (x + 1) % 4);
    float t_lo = 0.0f, t_hi = 1.0f;
    bool empty = false;
#pragma unroll
    for (int sd = 0; sd < 4; ++sd) {
      const float d0 = dot(p0, fr.side_n[sd]) - fr.side_d[sd];
      const float d1 = dot(p1, fr.side_n[sd]) - fr.side_d[sd];
      const float denom = d0 - d1;
      const bool crossing = fabsf(denom) > 1e-12f;
      const float tc = d0 / (crossing ? denom : 1.0f);
      if (crossing && d0 > 0.0f && d1 <= 0.0f) t_lo = fmaxf(t_lo, tc);
      if (crossing && d0 <= 0.0f && d1 > 0.0f) t_hi = fminf(t_hi, tc);
      empty = empty || (d0 > 1e-6f && d1 > 1e-6f);
    }
    const bool edge_ok = !empty && (t_lo <= t_hi + 1e-9f);
    const V3 seg = sub(p1, p0);
    const V3 pt_lo = add(p0, scl(seg, t_lo));
    const V3 pt_hi = add(p0, scl(seg, t_hi));
    cp[q] = pt_lo;
    cd[q] = edge_ok ? fr.d - dot(pt_lo, fr.n) : kNegBig;
    cp[kQuads + q] = pt_hi;
    cd[kQuads + q] = (edge_ok && t_hi < 0.9999f) ? fr.d - dot(pt_hi, fr.n) : kNegBig;
    const V3 pr = pick4(fr.poly, x);
    bool inside = true;
#pragma unroll
    for (int sd = 0; sd < 4; ++sd)
      inside = inside && (dot(pr, fi.side_n[sd]) - fi.side_d[sd] <= -1e-5f);
    const float sq = (fi.d - dot(pr, fi.n)) / den_s;
    const V3 qv = add(pr, scl(nrm_inc, sq));
    cp[2 * kQuads + q] = qv;
    cd[2 * kQuads + q] = (inside && den_ok) ? fr.d - dot(qv, fr.n) : kNegBig;
  }
#pragma unroll
  for (int l = 0; l < 3 * kQuads; ++l) cnt += cd[l] > 0.0f ? 1 : 0;
  for (int m = 1; m < kGroup; m <<= 1) cnt += __shfl_xor_sync(gmask, cnt, m);
  *num = cnt;
  // the deepest 4: local entries in ascending candidate order (k outer,
  // q inner), then the group's best, its point from the lane holding it
#pragma unroll
  for (int pick = 0; pick < kPts; ++pick) {
    float bv = cd[0];
    int bi = s;
#pragma unroll
    for (int l = 1; l < 3 * kQuads; ++l) {
      const bool gt = cd[l] > bv;
      bv = gt ? cd[l] : bv;
      bi = gt ? s + kGroup * (l % kQuads) + 4 * (l / kQuads) : bi;
    }
    for (int m = 1; m < kGroup; m <<= 1) {
      const float ov = __shfl_xor_sync(gmask, bv, m);
      const int oi = __shfl_xor_sync(gmask, bi, m);
      const bool take = ov > bv || (ov == bv && oi < bi);
      bv = take ? ov : bv;
      bi = take ? oi : bi;
    }
    const int holder = (bi % 4) % kGroup;
    const int li = (bi / 4) * kQuads + (bi % 4) / kGroup;
    V3 mine = cp[0];
#pragma unroll
    for (int l = 1; l < 3 * kQuads; ++l) mine = sel3(l == li, cp[l], mine);
    out.d[pick] = bv;
    out.p[pick] = mk(__shfl_sync(gmask, mine.x, gbase + holder),
                     __shfl_sync(gmask, mine.y, gbase + holder),
                     __shfl_sync(gmask, mine.z, gbase + holder));
#pragma unroll
    for (int l = 0; l < 3 * kQuads; ++l)
      cd[l] = (s == holder && l == li) ? kNegBig : cd[l];
  }
}

// ---------------------------------------------------------------------------
// General hulls: pairs.py's paths for tables that are not all boxes
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 ld3g(const float* p) { return mk(__ldg(p), __ldg(p + 1), __ldg(p + 2)); }

constexpr int kNone = 0x7fffffff;  // no index (a lane without a candidate)

// The world-space hull data of a world's rows in shared memory, staged once
// a substep at the post-integrate poses (stage_hulls): each hull row's block
// of `stride` floats, its world vertices (3 vm), edge directions (3 em),
// SAT axes (3 sm) and faces (4 fm: the outward normal, then the offset
// face_d + n . pos) — every row of the table's sections, so a padded row
// holds what the per-pair code would compute from it.  A fixed stride a
// row: the launch reserves the worst case (every row a hull) whatever the
// world holds, so packing the rows tighter would save no shared memory.
struct Hulls {
  float* s;
  int stride, oe, os, of;
  __device__ __forceinline__ const float* verts(int b) const { return s + b * stride; }
  __device__ __forceinline__ V3 at(int b, int off) const {
    const float* p = s + b * stride + off;
    return mk(p[0], p[1], p[2]);
  }
  __device__ __forceinline__ V3 edge(int b, int k) const { return at(b, oe + 3 * k); }
  __device__ __forceinline__ V3 sat(int b, int k) const { return at(b, os + 3 * k); }
  __device__ __forceinline__ V3 face_n(int b, int f) const { return at(b, of + 4 * f); }
  __device__ __forceinline__ float face_d(int b, int f) const {
    return s[b * stride + of + 4 * f + 3];
  }
};

// The staged floats a row for a table's sections (hull_stage_floats in
// ops/substep_kernel.py).
__host__ __device__ __forceinline__ int hull_stride(int vm, int em, int sm, int fm) {
  return 3 * (vm + em + sm) + 4 * fm;
}
__device__ __forceinline__ Hulls hulls_at(float* s, const Table& tab) {
  Hulls h;
  h.s = s;
  h.oe = 3 * tab.vm;
  h.os = h.oe + 3 * tab.em;
  h.of = h.os + 3 * tab.sm;
  h.stride = hull_stride(tab.vm, tab.em, tab.sm, tab.fm);
  return h;
}

// The lanes a hull pair takes at least (warp_hull_hull): enough that the
// clip runs its corners in one pass of one a lane (glo >= fvm), at most a
// warp.
__device__ __forceinline__ int hull_group_min(const Table& tab) {
  int g = 1;
  while (g < tab.fvm && g < 32) g <<= 1;
  return g;
}

// The deepest 4 of a contact's candidates, kept as they come: a candidate
// (depth d, index i, point p) ranks ahead of a kept one when it is deeper,
// or as deep with a lower index — the order of pairs.py's four argmax
// rounds (first index on ties), in whatever order the candidates come.
// Only candidates above -1e9 are kept; a slot left empty takes candidate
// 0's point at -1e9, as the rounds do once the real candidates are taken
// (candidate 0 is then taken or dead, so it is the first at -1e9).
struct Top4 {
  float d[kPts];
  int i[kPts];
  V3 p[kPts];
};
__device__ __forceinline__ void top4_init(Top4& t) {
#pragma unroll
  for (int s = 0; s < kPts; ++s) {
    t.d[s] = kNegBig;
    t.i[s] = kNone;
    t.p[s] = mk(0.0f, 0.0f, 0.0f);
  }
}
__device__ __forceinline__ void top4_push(Top4& t, float d, int i, V3 p) {
  if (!(d > kNegBig)) return;
  bool ahead[kPts];
#pragma unroll
  for (int s = 0; s < kPts; ++s) ahead[s] = d > t.d[s] || (d == t.d[s] && i < t.i[s]);
  // ahead is false above the new entry's place and true from there on:
  // the kept entries from there move down one
#pragma unroll
  for (int s = kPts - 1; s > 0; --s) {
    const bool prev = ahead[s - 1];
    t.d[s] = ahead[s] ? (prev ? t.d[s - 1] : d) : t.d[s];
    t.i[s] = ahead[s] ? (prev ? t.i[s - 1] : i) : t.i[s];
    t.p[s] = ahead[s] ? sel3(prev, t.p[s - 1], p) : t.p[s];
  }
  t.d[0] = ahead[0] ? d : t.d[0];
  t.i[0] = ahead[0] ? i : t.i[0];
  t.p[0] = sel3(ahead[0], p, t.p[0]);
}
__device__ __forceinline__ void top4_out(const Top4& t, V3 p0, Manifold& out) {
#pragma unroll
  for (int s = 0; s < kPts; ++s) {
    out.d[s] = t.d[s];
    out.p[s] = sel3(t.d[s] > kNegBig, t.p[s], p0);
  }
}

// Sphere against a general hull (staged at row h): the deepest face plane
// (the first of the largest dot(n_f, p) - d_f over the live faces), the
// contact at p - n_f dist.  flip = the sphere is side B.
__device__ bool sphere_hull(V3 s_pos, float s_rad, const Body& H, int h, const Table& tab,
                            const Hulls& hs, float spec, bool flip, V3* normal, V3* point,
                            float* pen_out) {
  const int nf = tab.nfaces(H.obj);
  float best = kNegBig;
  V3 bn = mk(0.0f, 0.0f, 0.0f);
  for (int f = 0; f < nf; ++f) {
    const V3 fn = hs.face_n(h, f);
    const float cd = dot(fn, s_pos) - hs.face_d(h, f);
    if (f == 0 || cd > best) {
      best = cd;
      bn = fn;
    }
  }
  const float pen = s_rad - best;
  *point = sub(s_pos, scl(bn, best));
  *normal = flip ? bn : scl(bn, -1.0f);
  *pen_out = pen;
  return pen > -spec;
}

// A hull's nv live verts (vert(v), world space) against a plane: every
// vertex a candidate (its depth below the plane), the deepest 4 kept.
// Returns the candidates past the margin.
template <typename Vert>
__device__ __forceinline__ int verts_plane(int nv, Vert vert, V3 p_n, float p_d, float spec,
                                           Manifold& out) {
  Top4 t;
  top4_init(t);
  V3 p0 = mk(0.0f, 0.0f, 0.0f);
  int num = 0;
  for (int v = 0; v < nv; ++v) {
    const V3 vw = vert(v);
    const float vd = dot(vw, p_n) - p_d;
    const float pen_v = -vd;
    num += pen_v > -spec ? 1 : 0;
    top4_push(t, pen_v, v, vw);
    if (v == 0) p0 = vw;
  }
  top4_out(t, p0, out);
  return num;
}

// A hull staged at row h against a plane.
__device__ int hull_plane(const Body& H, int h, V3 p_n, float p_d, const Table& tab,
                          const Hulls& hs, float spec, Manifold& out) {
  return verts_plane(
      tab.nverts(H.obj), [&](int v) { return hs.at(h, 3 * v); }, p_n, p_d, spec, out);
}

// The penetration along axis ax of two staged vertex sets: min(maxA - minB,
// maxB - minA) of their projections (pairs.py axis_pen).
__device__ __forceinline__ float axis_pen(V3 ax, const float* vA, int nA, const float* vB,
                                          int nB) {
  float maxA = kNegBig, minA = kBig, maxB = kNegBig, minB = kBig;
  for (int v = 0; v < nA; ++v) {
    const float p = dot(ax, mk(vA[3 * v], vA[3 * v + 1], vA[3 * v + 2]));
    maxA = fmaxf(maxA, p);
    minA = fminf(minA, p);
  }
  for (int v = 0; v < nB; ++v) {
    const float p = dot(ax, mk(vB[3 * v], vB[3 * v + 1], vB[3 * v + 2]));
    maxB = fmaxf(maxB, p);
    minB = fminf(minB, p);
  }
  return fminf(maxA - minB, maxB - minA);
}

// The cross axis of edge directions eA x eB, normalised; false where the
// edges are (near) parallel.
__device__ __forceinline__ bool cross_axis(V3 eA, V3 eB, V3* ax) {
  const V3 c = cross(eA, eB);
  const float clen = norm3(c, 1e-30f);
  *ax = scl(c, 1.0f / fmaxf(clen, 1e-12f));
  return clen > 1e-6f;
}

// Reductions over a lane group: G consecutive lanes (G a power of two, the
// group's first lane a multiple of G), mask gmask.  fminf and min are exact
// in any order.
__device__ __forceinline__ float group_fmin(float v, int G, unsigned gmask) {
  for (int m = 1; m < G; m <<= 1) v = fminf(v, __shfl_xor_sync(gmask, v, m));
  return v;
}
__device__ __forceinline__ int group_imin(int v, int G, unsigned gmask) {
  for (int m = 1; m < G; m <<= 1) v = min(v, __shfl_xor_sync(gmask, v, m));
  return v;
}
__device__ __forceinline__ int group_isum(int v, int G, unsigned gmask) {
  for (int m = 1; m < G; m <<= 1) v += __shfl_xor_sync(gmask, v, m);
  return v;
}
// The group's (value, index) of the first extreme: each lane's pair the
// first extreme of its own items in ascending index (index kNone: none);
// MAX the largest value, else the smallest; equal values to the lower
// index.
template <bool MAX>
__device__ __forceinline__ void group_arg(float* v, int* i, int G, unsigned gmask) {
  for (int m = 1; m < G; m <<= 1) {
    const float ov = __shfl_xor_sync(gmask, *v, m);
    const int oi = __shfl_xor_sync(gmask, *i, m);
    const bool better = MAX ? ov > *v : ov < *v;
    const bool take = oi != kNone && (*i == kNone || better || (ov == *v && oi < *i));
    *v = take ? ov : *v;
    *i = take ? oi : *i;
  }
}

// One family of SAT axes (cnt of them; lane s of the group takes s, s + G,
// ...): the minimum of pen(k) from kBig, the per-pair loop's start, and the
// first axis within kSatTieEps of it, 0 when none (pairs.py's first index
// at the extreme).  The second pass computes pen(k) again in ascending
// order to the lane's first hit, past the lane's first two axes, which
// stay in registers.
template <typename Pen>
__device__ __forceinline__ int family_first(int cnt, int s, int G, unsigned gmask, Pen pen,
                                            float* mn) {
  float m = kBig, p0 = kBig, p1 = kBig;
  for (int k = s, r = 0; k < cnt; k += G, ++r) {
    const float p = pen(k);
    p0 = r == 0 ? p : p0;
    p1 = r == 1 ? p : p1;
    m = fminf(m, p);
  }
  m = group_fmin(m, G, gmask);
  const float lim = m + kSatTieEps;
  int first = kNone;
  if (s < cnt && p0 <= lim) {
    first = s;
  } else if (s + G < cnt && p1 <= lim) {
    first = s + G;
  } else {
    for (int k = s + 2 * G; k < cnt; k += G)
      if (pen(k) <= lim) {
        first = k;
        break;
      }
  }
  first = group_imin(first, G, gmask);
  *mn = m;
  return first == kNone ? 0 : first;
}

// The supporting full edge of hull H along n, by the group: the first of
// the edges whose lower endpoint projection is largest (zero endpoints
// when H has none).
__device__ void support_edge(const Table& tab, const Body& H, V3 n, int s, int G,
                             unsigned gmask, V3* e0, V3* e1) {
  const int ne = tab.nfull(H.obj);
  float best = kNegBig;
  int bi = kNone;
  for (int e = s; e < ne; e += G) {
    const float* E = tab.full_edge(H.obj, e);
    const V3 p0 = add(qrot(H.rot, ld3g(E)), H.pos);
    const V3 p1 = add(qrot(H.rot, ld3g(E + 3)), H.pos);
    const float sc = fminf(dot(p0, n), dot(p1, n));
    if (bi == kNone || sc > best) {
      best = sc;
      bi = e;
    }
  }
  group_arg<true>(&best, &bi, G, gmask);
  *e0 = *e1 = mk(0.0f, 0.0f, 0.0f);
  if (bi == kNone) return;
  const float* E = tab.full_edge(H.obj, bi);
  *e0 = add(qrot(H.rot, ld3g(E)), H.pos);
  *e1 = add(qrot(H.rot, ld3g(E + 3)), H.pos);
}

// Corner slot k's side plane of face F of a body at (rot, pos), in world
// space: its normal, offset and valid flag.
__device__ __forceinline__ void side_plane(const float* F, int k, Q4 rot, V3 pos, V3* sn,
                                           float* sd, bool* ok) {
  const float* C = F + kFaceHead + kCornerFl * k;
  *sn = qrot(rot, ld3g(C + 6));
  *sd = __ldg(C + 9) + dot(*sn, pos);
  *ok = __ldg(C + 10) > 0.5f;
}

// Two general hulls (pairs.py's vertex-support SAT) by a group of G lanes
// (lane s, mask gmask, first lane gbase), from their staged rows ra and rb:
// each side's SAT
// axes and the cross axes of their edge directions (i-major), each axis's
// penetration from both sides' staged vertices, the lanes splitting each
// family; per family the first axis within kSatTieEps of its minimum; then
// the face bias, the orientation and, on a face axis, the reference face
// (the most aligned with the axis into the other hull) and the incident
// face (the most anti-aligned; first index on ties), the incident face's
// edges clipped against the reference face's side planes plus the
// reference face's corners inside the incident face, the lanes splitting
// the corners (one a lane a pass, in passes of G) and each lane's side
// planes shared by shuffles; on an edge axis one point between the
// supporting edges.  Candidates (3 fvm: the clipped edges' low and high
// ends, the reference corners) go to each lane's deepest 4 as they come,
// merged across the group in (depth, index) order.  Every lane of the group
// returns the result.  Without NPTS (no manifold cache keeps the points) a
// pair that does not touch skips its manifold: the passes read none of it.
template <bool NPTS>
__device__ bool hull_hull(const Body& A, const Body& B, int ra, int rb, const Table& tab,
                          const Hulls& hs, float spec, int s, int G, unsigned gmask, int gbase,
                          Manifold& out, V3* normal, int* num) {
  const int nA = tab.nverts(A.obj), nB = tab.nverts(B.obj);
  const float *vA = hs.verts(ra), *vB = hs.verts(rb);
  float minA, minB, minE;
  const int ia = family_first(
      tab.nsat(A.obj), s, G, gmask, [&](int k) { return axis_pen(hs.sat(ra, k), vA, nA, vB, nB); },
      &minA);
  const int ib = family_first(
      tab.nsat(B.obj), s, G, gmask, [&](int k) { return axis_pen(hs.sat(rb, k), vA, nA, vB, nB); },
      &minB);
  // the edge cross axes (invalid ones +inf: they neither lower the minimum
  // nor hit); the axis of edges 0 and 0 when none is valid
  const int neA = tab.nedges(A.obj), neB = tab.nedges(B.obj);
  const int ie = family_first(
      neA * neB, s, G, gmask,
      [&](int k) {
        const int i = k / neB;
        V3 ax;
        return cross_axis(hs.edge(ra, i), hs.edge(rb, k - i * neB), &ax)
                   ? axis_pen(ax, vA, nA, vB, nB)
                   : __int_as_float(0x7f800000);
      },
      &minE);
  const int i0 = neB > 0 ? ie / neB : 0;
  const V3 fA = hs.sat(ra, ia);
  const V3 fB = hs.sat(rb, ib);
  V3 fE;
  cross_axis(hs.edge(ra, i0), hs.edge(rb, ie - i0 * neB), &fE);

  const float sat_pen = fminf(fminf(minA, minB), minE);
  const bool hit = (sat_pen > -spec) && (sat_pen < kBig * 0.5f);
  const bool faceA = minA <= fminf(minB, minE) * kFaceBias + kSatTieEps;
  const bool faceB = !faceA && (minB <= minE * kFaceBias + kSatTieEps);
  const V3 ab = sub(B.pos, A.pos);
  const V3 f = sel3(faceA, fA, sel3(faceB, fB, fE));
  const V3 nrm = scl(f, dot(f, ab) >= 0.0f ? 1.0f : -1.0f);
  *normal = nrm;
  if (!faceA && !faceB) {
    // edge-edge: one point, the midpoint of the supporting edges' closest
    // points, at the SAT depth
    V3 a0, a1, b0, b1;
    support_edge(tab, A, nrm, s, G, gmask, &a0, &a1);
    support_edge(tab, B, scl(nrm, -1.0f), s, G, gmask, &b0, &b1);
    single_point(segment_closest(a0, a1, b0, b1), sat_pen, out);
    *num = sat_pen > 0.0f ? 1 : 0;
    return hit;
  }
  if (!NPTS && !hit) {
    single_point(mk(0.0f, 0.0f, 0.0f), kNegBig, out);
    *num = 0;
    return false;
  }
  // the reference (R) and incident (I) hulls and faces
  const V3 nrm_inc = faceB ? scl(nrm, -1.0f) : nrm;
  const Body R = sel_body(faceB, B, A), I = sel_body(faceB, A, B);
  const int rr = faceB ? rb : ra, ri = faceB ? ra : rb;
  float sr = kNegBig, si = kBig;
  int fr = kNone, fi = kNone;
  const int nfR = tab.nfaces(R.obj), nfI = tab.nfaces(I.obj);
  for (int k = s; k < nfR; k += G) {
    const float sc = dot(hs.face_n(rr, k), nrm_inc);
    if (fr == kNone || sc > sr) {
      sr = sc;
      fr = k;
    }
  }
  for (int k = s; k < nfI; k += G) {
    const float sc = dot(hs.face_n(ri, k), nrm_inc);
    if (fi == kNone || sc < si) {
      si = sc;
      fi = k;
    }
  }
  group_arg<true>(&sr, &fr, G, gmask);
  group_arg<false>(&si, &fi, G, gmask);
  fr = fr == kNone ? 0 : fr;
  fi = fi == kNone ? 0 : fi;
  const float* FR = tab.face(R.obj, fr);
  const float* FI = tab.face(I.obj, fi);
  const V3 n_ref = hs.face_n(rr, fr);
  const float d_ref = hs.face_d(rr, fr);
  const V3 n_inc = hs.face_n(ri, fi);
  const float d_inc = hs.face_d(ri, fi);
  const int FV = tab.fvm;
  const float den = dot(n_inc, nrm_inc);
  const bool den_ok = fabsf(den) > 0.1f;
  const float den_s = den_ok ? den : 1.0f;
  Top4 t;
  top4_init(t);
  V3 p0 = mk(0.0f, 0.0f, 0.0f);
  int cnt = 0;
  // this lane's corner c0 + s of each pass of G: the incident face's edge e
  // clipped against the reference face's sides (candidates e, the low end,
  // and FV + e, the high end when clipped) and the reference face's corner e
  // tested against the incident face's sides (candidate 2 FV + e)
  for (int c0 = 0; c0 < FV; c0 += G) {
    const int ec = min(c0 + s, FV - 1);
    const float* CI = FI + kFaceHead + kCornerFl * ec;
    const V3 q0 = add(qrot(I.rot, ld3g(CI)), I.pos);
    const V3 q1 = add(qrot(I.rot, ld3g(CI + 3)), I.pos);
    float t_lo = 0.0f, t_hi = 1.0f;
    bool empty = false;
    const float* CR = FR + kFaceHead + kCornerFl * ec;
    const V3 pr = add(qrot(R.rot, ld3g(CR)), R.pos);
    bool inside = __ldg(CR + 10) > 0.5f;
    // the side planes in ascending order, in passes of G: lane s makes
    // plane p0 + s of both faces, and each goes to the group by shuffles
    // from its lane
    for (int b0 = 0; b0 < FV; b0 += G) {
      V3 snR, snI;
      float sdR, sdI;
      bool pvR, pvI;
      const int k = min(b0 + s, FV - 1);
      side_plane(FR, k, R.rot, R.pos, &snR, &sdR, &pvR);
      side_plane(FI, k, I.rot, I.pos, &snI, &sdI, &pvI);
      const int lim = min(G, FV - b0);
      for (int j = 0; j < lim; ++j) {
        const int src = gbase + j;
        const V3 nR = mk(__shfl_sync(gmask, snR.x, src), __shfl_sync(gmask, snR.y, src),
                         __shfl_sync(gmask, snR.z, src));
        const float dR = __shfl_sync(gmask, sdR, src);
        const bool vR = __shfl_sync(gmask, pvR ? 1 : 0, src) != 0;
        const V3 nI = mk(__shfl_sync(gmask, snI.x, src), __shfl_sync(gmask, snI.y, src),
                         __shfl_sync(gmask, snI.z, src));
        const float dI = __shfl_sync(gmask, sdI, src);
        const bool vI = __shfl_sync(gmask, pvI ? 1 : 0, src) != 0;
        if (vR) {
          const float d0 = dot(q0, nR) - dR;
          const float d1 = dot(q1, nR) - dR;
          const float denom = d0 - d1;
          const bool crossing = fabsf(denom) > 1e-12f;
          const float tc = d0 / (crossing ? denom : 1.0f);
          if (crossing && d0 > 0.0f && d1 <= 0.0f) t_lo = fmaxf(t_lo, tc);
          if (crossing && d0 <= 0.0f && d1 > 0.0f) t_hi = fminf(t_hi, tc);
          empty = empty || (d0 > 1e-6f && d1 > 1e-6f);
        }
        if (vI) inside = inside && (dot(pr, nI) - dI <= -1e-5f);
      }
    }
    const int e = c0 + s;
    if (e >= FV) continue;
    const bool edge_ok = __ldg(CI + 10) > 0.5f && !empty && (t_lo <= t_hi + 1e-9f);
    const V3 seg = sub(q1, q0);
    const V3 pt_lo = add(q0, scl(seg, t_lo));
    const V3 pt_hi = add(q0, scl(seg, t_hi));
    const float dlo = edge_ok ? d_ref - dot(pt_lo, n_ref) : kNegBig;
    const float dhi = (edge_ok && t_hi < 0.9999f) ? d_ref - dot(pt_hi, n_ref) : kNegBig;
    if (e == 0) p0 = pt_lo;
    cnt += (dlo > 0.0f ? 1 : 0) + (dhi > 0.0f ? 1 : 0);
    top4_push(t, dlo, e, pt_lo);
    top4_push(t, dhi, FV + e, pt_hi);
    // the reference corner strictly inside the incident face, projected
    // onto it along the axis
    const float sq = (d_inc - dot(pr, n_inc)) / den_s;
    const V3 q = add(pr, scl(nrm_inc, sq));
    const float dq = (inside && den_ok) ? d_ref - dot(q, n_ref) : kNegBig;
    cnt += dq > 0.0f ? 1 : 0;
    top4_push(t, dq, 2 * FV + e, q);
  }
  *num = group_isum(cnt, G, gmask);
  // candidate 0's point (edge 0's low end) from the group's first lane
  p0 = mk(__shfl_sync(gmask, p0.x, gbase), __shfl_sync(gmask, p0.y, gbase),
          __shfl_sync(gmask, p0.z, gbase));
  // the group's deepest 4: four rounds of the lanes' next kept entries
  int head = 0;
#pragma unroll
  for (int pick = 0; pick < kPts; ++pick) {
    float hd = kNegBig;
    int hx = kNone;
    V3 hp = mk(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const bool at = q == head && t.d[q] > kNegBig;
      hd = at ? t.d[q] : hd;
      hx = at ? t.i[q] : hx;
      hp = sel3(at, t.p[q], hp);
    }
    float bd = hd;
    int bx = hx;
    group_arg<true>(&bd, &bx, G, gmask);
    const bool mine = bx != kNone && hx == bx;
    const unsigned who = __ballot_sync(gmask, mine);
    const int holder = who ? __ffs(who) - 1 : gbase;
    const V3 bp = mk(__shfl_sync(gmask, hp.x, holder), __shfl_sync(gmask, hp.y, holder),
                     __shfl_sync(gmask, hp.z, holder));
    out.d[pick] = bx != kNone ? bd : kNegBig;
    out.p[pick] = sel3(bx != kNone, bp, p0);
    head += mine ? 1 : 0;
  }
  return hit;
}

// pair_contacts of physics/pairs.py for one live pair (rows ra and rb):
// GEN false, the all-box tables' analytic paths; GEN true, the general
// hulls' (every hull of such tables, boxes too, takes them, as in
// pairs.py) from the staged rows hs, but for the hull pairs, which
// warp_hull_hull takes.  NPTS: also its num_points (candidates past the
// speculative margin, at most kPts) in *npts, which only the manifold cache
// keeps.  Each kind's branch compacts its own candidates, so the sphere
// kinds (one candidate) carry no candidate arrays.
template <bool NPTS, bool GEN>
__device__ __forceinline__ void pair_contacts(const Body& A, const Body& B, int ra, int rb,
                                              const Table& tab, const Hulls& hs, float spec,
                                              Manifold& out, int* npts) {
  const int pa = tab.prim(A.obj), pb = tab.prim(B.obj);
  bool ok = false;
  V3 n = mk(0.0f, 0.0f, 0.0f);
  int num = 0;
  if (pa == kPrimSphere && pb == kPrimSphere) {
    const float radA = tab.radius(A.obj), radB = tab.radius(B.obj);
    const V3 d = sub(B.pos, A.pos);
    const float dist = norm3(d, 1e-18f);
    n = scl(d, 1.0f / dist);
    const float pen = (radA + radB) - dist;
    single_point(add(A.pos, scl(n, radA - 0.5f * pen)), pen, out);
    ok = pen > -spec;
    num = 1;
  } else if ((pa == kPrimSphere && pb == kPrimPlane) || (pa == kPrimPlane && pb == kPrimSphere)) {
    const bool flip = pa == kPrimPlane;
    const Body S = sel_body(flip, B, A);
    const Body Pl = sel_body(flip, A, B);
    const V3 p_n = plane_normal(Pl.rot);
    const float p_d = dot(p_n, Pl.pos);
    const float c_dist = dot(S.pos, p_n) - p_d;
    const float pen = tab.radius(S.obj) - c_dist;
    single_point(sub(S.pos, scl(p_n, c_dist)), pen, out);
    n = flip ? p_n : scl(p_n, -1.0f);
    ok = pen > -spec;
    num = 1;
  } else if ((pa == kPrimHull && pb == kPrimPlane) || (pa == kPrimPlane && pb == kPrimHull)) {
    const bool flip = pa == kPrimPlane;
    const Body H = sel_body(flip, B, A);
    const Body Pl = sel_body(flip, A, B);
    const V3 p_n = plane_normal(Pl.rot);
    const float p_d = dot(p_n, Pl.pos);
    if (GEN) {
      num = hull_plane(H, flip ? rb : ra, p_n, p_d, tab, hs, spec, out);
    } else if constexpr (kWideBox) {
      // every live vertex of the row, read at the table's stride: pairs.py's
      // max(vm, 12) candidates, whose dead ones (-1e9) give way to vertex 0
      // once the live ones are taken
      num = verts_plane(
          min(tab.nverts(H.obj), tab.vm),
          [&](int v) { return add(qrot(H.rot, tab.vert(H.obj, v)), H.pos); }, p_n, p_d, spec,
          out);
    } else {
      const int nv = tab.nverts(H.obj);
      V3 cp[kCand];
      float cd[kCand];
#pragma unroll
      for (int v = 0; v < kCand; ++v) {
        cp[v] = mk(0.0f, 0.0f, 0.0f);
        cd[v] = kNegBig;
        if (v < kMaxBoxVerts && v < tab.vm) {
          const V3 vw = add(qrot(H.rot, tab.vert(H.obj, v)), H.pos);
          const float vd = dot(vw, p_n) - p_d;
          const float pen_v = v < nv ? -vd : kNegBig;
          cp[v] = vw;
          cd[v] = pen_v;
          num += pen_v > -spec ? 1 : 0;
        }
      }
      deepest4(cp, cd, out);
    }
    n = flip ? p_n : scl(p_n, -1.0f);
    ok = num > 0;
  } else if ((pa == kPrimSphere && pb == kPrimHull) || (pa == kPrimHull && pb == kPrimSphere)) {
    const bool flip = pa == kPrimHull;
    const Body S = sel_body(flip, B, A);
    const Body Bx = sel_body(flip, A, B);
    float pen;
    V3 p0;
    if (GEN)
      ok = sphere_hull(S.pos, tab.radius(S.obj), Bx, flip ? ra : rb, tab, hs, spec, flip, &n, &p0,
                       &pen);
    else
      ok = sphere_box(S.pos, tab.radius(S.obj), Bx, tab, spec, flip, &n, &p0, &pen);
    single_point(p0, pen, out);
    num = 1;
  } else if (!GEN && pa == kPrimHull && pb == kPrimHull) {
    V3 cp[kCand];
    float cd[kCand];
    ok = box_box(A, B, tab, spec, cp, cd, &n, &num);
    deepest4(cp, cd, out);
  } else {
    single_point(mk(0.0f, 0.0f, 0.0f), kNegBig, out);  // no candidate
  }
  out.ok = ok;
  out.n = n;
  if (NPTS) *npts = num < kPts ? num : kPts;
}

// The box-box pairs among a warp's entries (lanes with bb set), kGroup
// lanes each: the warp takes them in batches of 32 / kGroup, lowest lanes
// first, each group runs box_box_group on its owner's pair, and each owner
// lane takes its manifold (and with NPTS its point count) back.  Called by
// every lane of the warp.
template <bool NPTS>
__device__ __forceinline__ void warp_box_box(const Body (&Bd)[2], const Table& tab, float spec,
                                             bool bb, int lane, Manifold& c, int* npts) {
  const unsigned full = 0xffffffffu;
  const int gs = lane % kGroup, gbase = lane - gs, g = lane / kGroup;
  const unsigned gmask = ((1u << kGroup) - 1u) << gbase;
  unsigned todo = __ballot_sync(full, bb);
  while (todo) {
    unsigned m = todo;
    for (int i = 0; i < g; ++i) m &= m - 1u;
    const int owner = m ? __ffs(m) - 1 : lane;
    Body P[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      P[q].pos = mk(__shfl_sync(full, Bd[q].pos.x, owner), __shfl_sync(full, Bd[q].pos.y, owner),
                    __shfl_sync(full, Bd[q].pos.z, owner));
      P[q].rot = Q4{__shfl_sync(full, Bd[q].rot.w, owner), __shfl_sync(full, Bd[q].rot.x, owner),
                    __shfl_sync(full, Bd[q].rot.y, owner), __shfl_sync(full, Bd[q].rot.z, owner)};
      P[q].obj = __shfl_sync(full, Bd[q].obj, owner);
    }
    Manifold r;
    int num = 0;
    if (m) box_box_group(P[0], P[1], tab, spec, gs, gmask, gbase, r, &num);
    __syncwarp();
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool mine = ((todo >> lane) & 1u) && rank < 32 / kGroup;
    const int src = mine ? rank * kGroup : lane;
    const float ok = __shfl_sync(full, r.ok ? 1.0f : 0.0f, src);
    const V3 n = mk(__shfl_sync(full, r.n.x, src), __shfl_sync(full, r.n.y, src),
                    __shfl_sync(full, r.n.z, src));
    Manifold got;
    got.ok = ok > 0.5f;
    got.n = n;
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      got.p[p] = mk(__shfl_sync(full, r.p[p].x, src), __shfl_sync(full, r.p[p].y, src),
                    __shfl_sync(full, r.p[p].z, src));
      got.d[p] = __shfl_sync(full, r.d[p], src);
    }
    const int got_num = __shfl_sync(full, num, src);
    if (mine) {
      c = got;
      if (NPTS) *npts = got_num < kPts ? got_num : kPts;
    }
    for (int i = 0; i < 32 / kGroup && todo; ++i) todo &= todo - 1u;
  }
}

// The hull pairs among a warp's entries (lanes with hh set; general-hull
// tables), a lane group each: the widest group (a power of two) that gives
// every pending pair one, but at least glo lanes (hull_group_min); the warp
// takes them in batches of 32 / G, lowest lanes first, each group runs
// hull_hull on its owner's pair (bodies Bd, rows), and each owner lane takes
// its manifold (and with NPTS its point count) back.  Called by every lane
// of the warp.
template <bool NPTS>
__device__ __forceinline__ void warp_hull_hull(const Body (&Bd)[2], const int (&rows)[2],
                                               const Table& tab, const Hulls& hs, float spec,
                                               bool hh, int lane, int glo, Manifold& c,
                                               int* npts) {
  const unsigned full = 0xffffffffu;
  unsigned todo = __ballot_sync(full, hh);
  while (todo) {
    const int pending = __popc(todo);
    int G = 32;
    while (G > glo && G * pending > 32) G >>= 1;
    const int gs = lane % G, gbase = lane - gs, g = lane / G;
    const unsigned gmask = G == 32 ? full : ((1u << G) - 1u) << gbase;
    unsigned m = todo;
    for (int i = 0; i < g; ++i) m &= m - 1u;
    const int owner = m ? __ffs(m) - 1 : lane;
    Body P[2];
    int R[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      P[q].pos = mk(__shfl_sync(full, Bd[q].pos.x, owner), __shfl_sync(full, Bd[q].pos.y, owner),
                    __shfl_sync(full, Bd[q].pos.z, owner));
      P[q].rot = Q4{__shfl_sync(full, Bd[q].rot.w, owner), __shfl_sync(full, Bd[q].rot.x, owner),
                    __shfl_sync(full, Bd[q].rot.y, owner), __shfl_sync(full, Bd[q].rot.z, owner)};
      P[q].obj = __shfl_sync(full, Bd[q].obj, owner);
      R[q] = __shfl_sync(full, rows[q], owner);
    }
    Manifold r;
    single_point(mk(0.0f, 0.0f, 0.0f), kNegBig, r);
    V3 n = mk(0.0f, 0.0f, 0.0f);
    int num = 0;
    bool ok = false;
    if (m) ok = hull_hull<NPTS>(P[0], P[1], R[0], R[1], tab, hs, spec, gs, G, gmask, gbase, r, &n,
                                &num);
    __syncwarp();
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool mine = ((todo >> lane) & 1u) && rank < 32 / G;
    const int src = mine ? rank * G : lane;
    Manifold got;
    got.ok = __shfl_sync(full, ok ? 1 : 0, src) != 0;
    got.n = mk(__shfl_sync(full, n.x, src), __shfl_sync(full, n.y, src),
               __shfl_sync(full, n.z, src));
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      got.p[p] = mk(__shfl_sync(full, r.p[p].x, src), __shfl_sync(full, r.p[p].y, src),
                    __shfl_sync(full, r.p[p].z, src));
      got.d[p] = __shfl_sync(full, r.d[p], src);
    }
    const int got_num = __shfl_sync(full, num, src);
    if (mine) {
      c = got;
      if (NPTS) *npts = got_num < kPts ? got_num : kPts;
    }
    for (int i = 0; i < 32 / G && todo; ++i) todo &= todo - 1u;
  }
}

// ---------------------------------------------------------------------------
// Solver passes (physics/pairs.py positional_pass / velocity_pass)
// ---------------------------------------------------------------------------

struct Side {
  V3 pos;
  Q4 rot;
  V3 prev_pos;  // positional pass
  V3 v, w;      // velocity pass: post-recovery velocities
  V3 pv, pw;    // velocity pass: post-integrate velocities (restitution)
  float im, mu, rest;
  V3 ii;
};

__device__ __forceinline__ V3 pvel(V3 v, V3 w, V3 r) { return add(v, cross(w, r)); }

// Writes packA/packB (9 each: dx, dw, bias dx summed over the points) and
// lam[4].
__device__ void positional_pass(const Side& A, const Side& B, const Manifold& c, float relax,
                                float packA[9], float packB[9], float lam[kPts]) {
  const Sym MA = sym_from(A.rot, A.ii), MB = sym_from(B.rot, B.ii);
  const float imsum = A.im + B.im;
  const V3 n = c.n;
  const V3 drift = sub(sub(B.pos, B.prev_pos), sub(A.pos, A.prev_pos));
  const float mu_pair = 0.5f * (A.mu + B.mu);
#pragma unroll
  for (int q = 0; q < 9; ++q) packA[q] = packB[q] = 0.0f;
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const float depth = c.d[p];
    const bool pt_ok = c.ok && depth > 0.0f;
    const V3 rA = sub(c.p[p], A.pos), rB = sub(c.p[p], B.pos);
    const V3 cA = cross(rA, n), cB = cross(rB, n);
    const V3 uA = sym_mv(MA, cA), uB = sym_mv(MB, cB);
    const float wsum = imsum + dot(cA, uA) + dot(cB, uB);
    const float depth_vis = fminf(depth, 0.05f);
    const bool ok_w = pt_ok && wsum > 1e-12f;
    const float inv_w = 1.0f / fmaxf(wsum, 1e-12f);
    const float dlam = (ok_w ? depth * inv_w : 0.0f) * relax;
    const float dlam_vis = (ok_w ? depth_vis * inv_w : 0.0f) * relax;
    const float bias = dlam > 1e-12f ? (dlam - dlam_vis) / fmaxf(dlam, 1e-12f) : 0.0f;
    V3 dxA = scl(n, -dlam * A.im), dwA = scl(uA, -dlam);
    V3 dxB = scl(n, dlam * B.im), dwB = scl(uB, dlam);
    // static friction (physics.cpp:369-441)
    const V3 tang = sub(drift, scl(n, dot(drift, n)));
    const float tlen = norm3(tang, 1e-30f);
    const V3 that = scl(tang, 1.0f / fmaxf(tlen, 1e-12f));
    const V3 tA = cross(rA, that), tB = cross(rB, that);
    const V3 uA_t = sym_mv(MA, tA), uB_t = sym_mv(MB, tB);
    const float wsum_t = imsum + dot(tA, uA_t) + dot(tB, uB_t);
    const float dlam_t =
        (pt_ok && wsum_t > 1e-12f && tlen < mu_pair * dlam ? tlen / fmaxf(wsum_t, 1e-12f) : 0.0f) *
        relax;
    dxA = add(dxA, scl(that, dlam_t * A.im));
    dwA = add(dwA, scl(uA_t, dlam_t));
    dxB = add(dxB, scl(that, -dlam_t * B.im));
    dwB = add(dwB, scl(uB_t, -dlam_t));
    const float vA[9] = {dxA.x, dxA.y, dxA.z, dwA.x, dwA.y, dwA.z,
                         dxA.x * bias, dxA.y * bias, dxA.z * bias};
    const float vB[9] = {dxB.x, dxB.y, dxB.z, dwB.x, dwB.y, dwB.z,
                         dxB.x * bias, dxB.y * bias, dxB.z * bias};
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float a = pt_ok ? vA[q] : 0.0f, b = pt_ok ? vB[q] : 0.0f;
      packA[q] = p == 0 ? a : packA[q] + a;
      packB[q] = p == 0 ? b : packB[q] + b;
    }
    lam[p] = pt_ok ? dlam : 0.0f;
  }
}

// Writes packA/packB (6 each: dv, dw).
__device__ void velocity_pass(const Side& A, const Side& B, const Manifold& c,
                              const float lam[kPts], float h, float rest_thr, bool bounce,
                              float spec, float packA[6], float packB[6]) {
  const V3 n = c.n;
  const float mu2 = 0.5f * (A.mu + B.mu);
  const float imsum = A.im + B.im;
  const Sym MA = sym_from(A.rot, A.ii), MB = sym_from(B.rot, B.ii);
  V3 rA[kPts], rB[kPts], cA[kPts], cB[kPts], uA[kPts], uB[kPts];
  float okf[kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    rA[i] = sub(c.p[i], A.pos);
    rB[i] = sub(c.p[i], B.pos);
    okf[i] = (c.ok && c.d[i] > 0.0f) ? 1.0f : 0.0f;
    cA[i] = cross(rA[i], n);
    cB[i] = cross(rB[i], n);
    uA[i] = sym_mv(MA, cA[i]);
    uB[i] = sym_mv(MB, cB[i]);
  }
  float Km[kPts][kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i)
#pragma unroll
    for (int j = i; j < kPts; ++j) {
      Km[i][j] = imsum + dot(cA[i], uA[j]) + dot(cB[i], uB[j]);
      Km[j][i] = Km[i][j];
    }
  float Ad[kPts], b[kPts];
  const float e_pair = 0.5f * (A.rest + B.rest);
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    Ad[i] = okf[i] / fmaxf(Km[i][i], 1e-12f);
    const float vn = dot(sub(pvel(B.v, B.w, rB[i]), pvel(A.v, A.w, rA[i])), n);
    float target = 0.0f;
    if (bounce) {
      const float vb = dot(sub(pvel(B.pv, B.pw, rB[i]), pvel(A.pv, A.pw, rA[i])), n);
      const float e = fabsf(vb) <= rest_thr ? 0.0f : e_pair;
      target = fmaxf(-e * vb, 0.0f);
    }
    b[i] = target - vn;
  }
  // restitution: 2 Gauss-Seidel sweeps in closed form, M = (I - G + G^2 - G^3) A
  float G[kPts][kPts];
#pragma unroll
  for (int i = 1; i < kPts; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) G[i][j] = Ad[i] * Km[i][j];
  float M[kPts][kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i) M[i][i] = Ad[i];
  M[1][0] = -G[1][0] * Ad[0];
  M[2][0] = (-G[2][0] + G[2][1] * G[1][0]) * Ad[0];
  M[2][1] = -G[2][1] * Ad[1];
  M[3][0] = (-G[3][0] + G[3][1] * G[1][0] + G[3][2] * G[2][0] - G[3][2] * G[2][1] * G[1][0]) *
            Ad[0];
  M[3][1] = (-G[3][1] + G[3][2] * G[2][1]) * Ad[1];
  M[3][2] = -G[3][2] * Ad[2];
  float d1[kPts], r[kPts], lams[kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    float acc = M[i][0] * b[0];
#pragma unroll
    for (int j = 1; j <= i; ++j) acc = acc + M[i][j] * b[j];
    d1[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    float acc = Km[i][0] * d1[0];
#pragma unroll
    for (int j = 1; j < kPts; ++j) acc = acc + Km[i][j] * d1[j];
    r[i] = b[i] - acc;
  }
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    float acc = M[i][0] * r[0];
#pragma unroll
    for (int j = 1; j <= i; ++j) acc = acc + M[i][j] * r[j];
    lams[i] = d1[i] + acc;
  }
  float lam_sum = lams[0];
  V3 swA = scl(uA[0], lams[0]), swB = scl(uB[0], lams[0]);
#pragma unroll
  for (int i = 1; i < kPts; ++i) {
    lam_sum = lam_sum + lams[i];
    swA = add(swA, scl(uA[i], lams[i]));
    swB = add(swB, scl(uB[i], lams[i]));
  }
  V3 vA = sub(A.v, scl(n, A.im * lam_sum)), wA = sub(A.w, swA);
  V3 vB = add(B.v, scl(n, B.im * lam_sum)), wB = add(B.w, swB);

  // dynamic friction: one sequential pass
  const float mu_h = mu2 / h;
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    const V3 vpt = sub(pvel(vB, wB, rB[i]), pvel(vA, wA, rA[i]));
    const float vn = dot(vpt, n);
    const V3 vt = sub(vpt, scl(n, vn));
    const float vt2 = dot(vt, vt);
    const float inv_len = rsq(fmaxf(vt2, 1e-24f));
    const float vt_len = vt2 * inv_len;
    const float dyn_mag = mu_h * fabsf(lam[i]);
    const V3 tA = cross(rA[i], vt), tB = cross(rB[i], vt);
    const V3 fuA = sym_mv(MA, tA), fuB = sym_mv(MB, tB);
    const float wsum =
        fmaxf(imsum + (dot(tA, fuA) + dot(tB, fuB)) * inv_len * inv_len, 1e-12f);
    float s = fminf(dyn_mag, vt_len) / wsum * inv_len;
    s = ((vt_len > 1e-9f && dyn_mag > 0.0f) ? s : 0.0f) * okf[i];
    vA = add(vA, scl(vt, s * A.im));
    wA = add(wA, scl(fuA, s));
    vB = sub(vB, scl(vt, s * B.im));
    wB = sub(wB, scl(fuB, s));
  }

  // speculative near-miss clamp (depth <= 0): per-point Jacobi
  if (spec > 0.0f) {
    float simp[kPts];
    float npts = 0.0f;
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const float vn4 = dot(sub(pvel(B.v, B.w, rB[i]), pvel(A.v, A.w, rA[i])), n);
      const float wsum_n = fmaxf(imsum + dot(cA[i], uA[i]) + dot(cB[i], uB[i]), 1e-12f);
      const float dv_spec = c.d[i] / h - vn4;
      const bool s_ok = c.ok && c.d[i] <= 0.0f && dv_spec > 0.0f;
      simp[i] = s_ok ? dv_spec / wsum_n : 0.0f;
      npts = i == 0 ? (s_ok ? 1.0f : 0.0f) : npts + (s_ok ? 1.0f : 0.0f);
    }
    const float inv_npts = 1.0f / fmaxf(npts, 1.0f);
    float stot = 0.0f;
    V3 twA = mk(0.0f, 0.0f, 0.0f), twB = mk(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const float si = simp[i] * inv_npts;
      stot = stot + si;
      twA = add(twA, scl(uA[i], si));
      twB = add(twB, scl(uB[i], si));
    }
    vA = sub(vA, scl(n, A.im * stot));
    wA = sub(wA, twA);
    vB = add(vB, scl(n, B.im * stot));
    wB = add(wB, twB);
  }
  const V3 dvA = sub(vA, A.v), dwA = sub(wA, A.w), dvB = sub(vB, B.v), dwB = sub(wB, B.w);
  packA[0] = dvA.x; packA[1] = dvA.y; packA[2] = dvA.z;
  packA[3] = dwA.x; packA[4] = dwA.y; packA[5] = dwA.z;
  packB[0] = dvB.x; packB[1] = dvB.y; packB[2] = dvB.z;
  packB[3] = dwB.x; packB[4] = dwB.y; packB[5] = dwB.z;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Body channels in shared memory, each n floats (SoA).
enum BodyCh {
  kPos = 0, kRot = 3, kV = 7, kW = 10,            // current state
  kPrevPos = 13, kPrevRot = 16,                    // substep start
  kIPos = 20, kIRot = 23, kIV = 27, kIW = 30,      // post-integrate
  kP2 = 33, kR2 = 36, kV2 = 40, kW2 = 43,          // post-positional-solve
  kIm = 46, kIi = 47, kMuS = 50, kMuD = 51, kDyn = 52, kObj = 53,
  kBodyCh = 54
};
// Per-slot stash channels, each K floats: ok, normal, points, depths, lambdas.
enum SlotCh { kSOk = 0, kSN = 1, kSP = 4, kSD = 16, kSLam = 20, kSlotCh = 24 };
constexpr int kPackCh = 18;
// The manifold cache, each K floats: the JAX layout of ManifoldPersist's mc
// (ops/substep_kernel.py MC_*) without its three row channels — rA[c][p] at
// kCRA + 4 c + p, rB likewise, the normal in A's frame, depth0[p], ok, the
// point count.  mc itself is [W, kMcCh, K]: rows_i, rows_j, kvalid, cache.
enum CacheCh { kCRA = 0, kCRB = 12, kCNLoc = 24, kCDepth0 = 27, kCOk = 31, kCNpts = 32,
               kCacheCh = 33 };
constexpr int kMcRows = 3;
constexpr int kMcCh = kMcRows + kCacheCh;
// The broadphase's AABB channels, each n floats: lo xyz, hi xyz.
constexpr int kAabbCh = 6;
// The kernel's option bits (OPT_* in ops/substep_kernel.py).
constexpr int kOptRefresh = 1, kOptSleep = 2, kOptBp = 4, kOptPersist = 8;
// A specialisation's general-hull bit (the launch sets it for tables with
// general-hull rows; OPT_HULL in ops/substep_kernel.py names it).
constexpr int kOptHull = 16;
// The world scalars in shared memory: the work list's length, the
// broadphase's dropped pairs, kernel 5's end of the valid slots and the
// broadphase's live rows (kBpWords bit words).
constexpr int kWorkCount = 0, kBpDropped = 1, kSlotsEnd = 2, kBpLive = 4, kWorldInts = 8;
// The in-kernel broadphase's rows (MAX_BP_ROWS in ops/substep_kernel.py)
// and the 32-bit words of a row's partner mask.
constexpr int kMaxBpRows = 128, kBpWords = kMaxBpRows / 32;
// Contact kinds, in the work list's order (the heaviest first), and the
// number of kinds (the last: no contact code, a plane against a plane).
enum Kind { kBoxBox = 0, kBoxPlane, kSphereBox, kSpherePlane, kSphereSphere, kOther, kKinds };
// substep_kernel (kernel 5): threads a CTA at most, the CTAs an SM it is
// compiled for, and its shared window: the work entries whose rows, pass
// contributions, stash and list entries stay in shared memory.  An entry
// past the window lives in the world's slice of a global scratch of
// kScratchCh channels an entry (the 18 pass channels, the 24 stash
// channels, the two rows and the two list entries).  A joint keeps its two
// sides' contributions (dx, dw each): kJointCh floats.
constexpr int kSubstepThreads = 128;
constexpr int kSubstepBlocks = 3;
constexpr int kWindow = 320;
constexpr int kScratchCh = 46;
constexpr int kJointCh = 12;
// The fused kernel's windowed specialisations (kOptWin; OPT_WIN in
// ops/substep_kernel.py), which the launch takes for a shape without the
// in-kernel broadphase whose whole layout (smem_bytes and the staged hull
// rows) passes kMaxSmem: kernel 5's window layout, its work entries past a
// window of fused_window(...) entries in the world's slice of a global
// scratch of kScratchCh channels an entry, kWinCacheCh with the manifold
// cache (its 33 channels after the others).  The window aims at kWinBlocks
// CTAs an SM of kSmSmem bytes, each reserving kCtaReserved.
constexpr int kOptWin = 32;
constexpr int kWinBlocks = 2;
constexpr int kWinCacheCh = 79;
constexpr size_t kSmSmem = 233472;
constexpr size_t kCtaReserved = 1024;
// Bodies in a global scratch (kOptBody; OPT_BODY in ops/substep_kernel.py),
// which kernel 5 takes where its window layout passes kMaxSmem and the
// fused kernel's windowed specialisations where not even their smallest
// window fits beside the bodies: a world's body rows (kBodyCh floats a
// row), its lists' offsets and cursors (3 n + 1 ints) and the staged hull
// rows (Hulls) live in its slice of a second global scratch instead of
// shared memory; the window of work entries, the joints and the world
// scalars stay in shared memory.  The code that reads them is the same
// (generic pointers: the body scratch is addressed as the shared rows were,
// __syncthreads orders a block's global writes as its shared ones, and the
// integer atomics on the cursors work on either).
constexpr int kOptBody = 64;

struct Args {
  const float *pos, *rot, *v, *w, *im, *ii, *mu_s, *mu_d;
  const int* obj;
  const float *ext_f, *ext_t;
  const uint8_t* dyn;
  const float *h, *gravity, *rest_thr;
  const int *rows_i, *rows_j;
  const uint8_t* kvalid;
  Table tab;
  int n, K, num_substeps, bounce;
  float relax, spec;
  float *o_pos, *o_rot, *o_v, *o_w, *o_prev_pos, *o_prev_rot, *o_ps_pos, *o_ps_rot, *o_ps_v,
      *o_ps_w;
  // the options: the broadphase's inputs (scale [W, n, 3], live [W, n],
  // dtv [W]), degree cap and AABB inflation; sleep's active [W]; the
  // persistent cache's stable [W], mc [W, kMcCh, K] and current AABB columns
  const float* scale;
  const uint8_t* live;
  const float* dtv;
  const uint8_t *active, *stable;
  const float *mc, *aabb_lo, *aabb_hi;
  int D;
  float inflate;
  float *o_aabb_lo, *o_aabb_hi;
  int *o_rows_i, *o_rows_j;
  uint8_t* o_kvalid;
  int *o_count, *o_dropped;
  float* o_mc;
  // with persistence: the rebuilt worlds' anchors (apos [W, n, 3], arot
  // [W, n, 4], valid [W]; null: not written); with sleep too, the list of
  // the worlds that run here and its length (asleep_surface_kernel's)
  float *o_apos, *o_arot;
  int* o_valid;
  const int *work_list, *work_count;
  // non-dynamic rows keep their velocities (else they come out zero)
  int keep_v;
  // the windowed specialisations: the window's work entries and the global
  // scratch [W, kScratchCh (kWinCacheCh with the cache), K - kw] (null when
  // kw = K)
  int kw;
  float* scratch;
  // kOptBody: the body scratch [W, bstride] (body_scratch_floats)
  float* bodies;
  size_t bstride;
};

__device__ __forceinline__ V3 ld3(const float* s, int ch, int b, int n) {
  return mk(s[ch * n + b], s[(ch + 1) * n + b], s[(ch + 2) * n + b]);
}
__device__ __forceinline__ Q4 ld4(const float* s, int ch, int b, int n) {
  return Q4{s[ch * n + b], s[(ch + 1) * n + b], s[(ch + 2) * n + b], s[(ch + 3) * n + b]};
}
__device__ __forceinline__ void st3(float* s, int ch, int b, int n, V3 v) {
  s[ch * n + b] = v.x;
  s[(ch + 1) * n + b] = v.y;
  s[(ch + 2) * n + b] = v.z;
}
__device__ __forceinline__ void st4(float* s, int ch, int b, int n, Q4 q) {
  s[ch * n + b] = q.w;
  s[(ch + 1) * n + b] = q.x;
  s[(ch + 2) * n + b] = q.y;
  s[(ch + 3) * n + b] = q.z;
}
__device__ __forceinline__ int obj_of(const float* s, int b, int n) {
  return __float_as_int(s[kObj * n + b]);
}

// The block size for n bodies and K slots: one thread a slot and a body,
// rounded up to whole warps, at most kMaxThreads (the threads loop over
// what is left).
__host__ __device__ __forceinline__ int block_threads(int n, int K) {
  const int widest = n > K ? n : K;
  const int t = ((widest + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// The slots whose manifold waits in shared memory between the two passes:
// a thread keeps the manifold of its first work-list entry in registers,
// so only entries at T and beyond (at most ceil(K / T) - 1 rounds of T)
// need the stash.
__host__ __device__ __forceinline__ int stash_slots(int n, int K) {
  const int t = block_threads(n, K);
  return ((K + t - 1) / t - 1) * t;
}

// The dynamic shared memory for n bodies and K slots, with the broadphase's
// AABBs, pair masks, degrees and bases (bp) and the manifold cache (cache):
//   floats: 54 a body; 18 (pass contributions) a slot; 24 (the manifold
//           stash) a stash slot (stash_slots); with the cache 33 a slot;
//           with bp 6 a body (AABB lo, hi)
//   ints:   6 a slot (rows i, j, valid, the per-body list's 2, the work
//           list); 3 n + 1 (the lists' offsets and two cursors a body); 8
//           world scalars; with bp 6 a body (degree, base, kBpWords mask
//           words)
size_t smem_bytes(int n, int K, bool bp, bool cache) {
  const size_t nn = static_cast<size_t>(n), kk = static_cast<size_t>(K);
  const size_t ks = static_cast<size_t>(stash_slots(n, K));
  const size_t floats = kBodyCh * nn + kSlotCh * ks + kPackCh * kk +
                        (cache ? kCacheCh * kk : 0) + (bp ? kAabbCh * nn : 0);
  const size_t ints = 6 * kk + 3 * nn + 1 + kWorldInts + (bp ? (2 + kBpWords) * nn : 0);
  return sizeof(float) * floats + sizeof(int) * ints;
}

// A world's shared memory, carved from the dynamic block (smem_bytes).
struct Smem {
  float *sb, *sst, *spk;
  int ks;         // stash slots (sst's channel stride)
  float* scache;  // kCacheCh K (cache only)
  float* saabb;   // kAabbCh n (bp only)
  int *sri, *srj, *skv;
  int* soff;    // n + 1: each body's first entry in slist
  int *scurA, *scurB;  // n each: the next A-side and B-side entry of a body
  int* slist;   // 2 K: (slot << 1 | side) per body, A sides first
  int* swork;   // K: the valid slots, grouped by contact kind (Kind)
  int* sworld;  // kWorldInts world scalars (kWorkCount, kBpDropped, kBpLive)
  int *sdeg, *sbase;  // n each (bp only): owner degree, first slot
  unsigned* smask;    // kBpWords n (bp only): each owner's lower partners
  // kernel 5's window (carve_window): kw entries in shared memory, the
  // rest in gsc (kScratchCh channels of kg floats); the window's rows
  // (2 kw: i at e, j at kw + e); the joints' contributions (kJointCh J)
  // and body rows (2 J: side 1 at j, side 2 at J + j; -1 if not summed)
  int kw, kg;
  float* gsc;
  int* swrow;
  float* sjv;
  int* sjr;
  // the general-hull specialisations' staged rows (Hulls), after the rest
  float* shull;
};

__device__ __forceinline__ Smem carve(float* smem, int n, int K, bool bp, bool cache, int T) {
  Smem s;
  s.ks = ((K + T - 1) / T - 1) * T;  // stash_slots(n, K) at the launch's T
  s.sb = smem;
  s.sst = s.sb + kBodyCh * n;
  s.spk = s.sst + kSlotCh * s.ks;
  float* f = s.spk + kPackCh * K;
  s.scache = cache ? f : nullptr;
  f += cache ? kCacheCh * K : 0;
  s.saabb = bp ? f : nullptr;
  f += bp ? kAabbCh * n : 0;
  s.sri = reinterpret_cast<int*>(f);
  s.srj = s.sri + K;
  s.skv = s.srj + K;
  s.soff = s.skv + K;
  s.scurA = s.soff + n + 1;
  s.scurB = s.scurA + n;
  s.slist = s.scurB + n;
  s.swork = s.slist + 2 * K;
  s.sworld = s.swork + K;
  s.sdeg = bp ? s.sworld + kWorldInts : nullptr;
  s.sbase = bp ? s.sdeg + n : nullptr;
  s.smask = bp ? reinterpret_cast<unsigned*>(s.sbase + n) : nullptr;
  s.shull = reinterpret_cast<float*>(bp ? s.sbase + n + kBpWords * n : s.sworld + kWorldInts);
  return s;
}

// Kernel 5's window for K slots, its block for n bodies (one thread a
// window entry and a body, in whole warps, at most kSubstepThreads), and the
// entries of the global scratch a world may need (those past the window).
__host__ __device__ __forceinline__ int substep_window(int K) { return K < kWindow ? K : kWindow; }
__host__ __device__ __forceinline__ int substep_threads(int n, int K) {
  const int kw = substep_window(K);
  const int widest = n > kw ? n : kw;
  const int t = ((widest + 31) / 32) * 32;
  return t < kSubstepThreads ? t : kSubstepThreads;
}
__host__ __device__ __forceinline__ int substep_scratch(int K) { return K - substep_window(K); }

// Kernel 5's dynamic shared memory for n bodies, K slots and J joints (the
// window's layout, carve_window):
//   floats: 54 a body; 18 (pass contributions) a window entry; 24 (the
//           manifold stash) a window entry past the block's threads;
//           kJointCh a joint
//   ints:   4 a window entry (its rows, its two list entries); 3 n + 1
//           (the lists' offsets and two cursors a body); 8 world scalars; 2
//           a joint (its body rows)
size_t substep_smem_bytes(int n, int K, int J) {
  const size_t nn = static_cast<size_t>(n), jj = static_cast<size_t>(J);
  const size_t ww = static_cast<size_t>(substep_window(K));
  const size_t tt = static_cast<size_t>(substep_threads(n, K));
  const size_t ks = ww > tt ? ww - tt : 0;
  const size_t floats = kBodyCh * nn + kSlotCh * ks + kPackCh * ww + kJointCh * jj;
  const size_t ints = 4 * ww + 3 * nn + 1 + kWorldInts + 2 * jj;
  return sizeof(float) * floats + sizeof(int) * ints;
}

// Kernel 5's shared memory, carved from the dynamic block; gsc is the
// world's slice of the global scratch (kScratchCh channels of kg floats).
// BODY: the bodies in a global scratch (kOptBody), gb the world's slice of
// it: its body rows, then the lists' offsets and cursors, then the staged
// hull rows (body_scratch_floats); the rest carved from the block as
// without it, in the same order.
// JG (with BODY): the joints' rows in the body scratch too, after the
// lists' offsets and cursors (the joints' kJointCh floats, then their 2
// ints a joint), the staged hull rows after them.
template <bool BODY>
__device__ __forceinline__ Smem carve_window(float* smem, int n, int K, int J, int T, float* gsc,
                                             float* gb, bool jg = false) {
  Smem s;
  s.kw = substep_window(K);
  s.kg = substep_scratch(K);
  s.gsc = gsc;
  s.ks = s.kw > T ? s.kw - T : 0;
  if constexpr (BODY) {
    const int js = jg ? 0 : J;  // the joints in shared memory
    s.sb = gb;
    s.sst = smem;
    s.spk = s.sst + kSlotCh * s.ks;
    s.sjv = s.spk + kPackCh * s.kw;
    s.swrow = reinterpret_cast<int*>(s.sjv + kJointCh * js);
    s.slist = s.swrow + 2 * s.kw;
    s.sworld = s.slist + 2 * s.kw;
    s.sjr = s.sworld + kWorldInts;
    s.soff = reinterpret_cast<int*>(gb + kBodyCh * n);
    s.scurA = s.soff + n + 1;
    s.scurB = s.scurA + n;
    s.shull = reinterpret_cast<float*>(s.scurB + n);
    if (jg) {
      s.sjv = s.shull;
      s.sjr = reinterpret_cast<int*>(s.sjv + kJointCh * J);
      s.shull = reinterpret_cast<float*>(s.sjr + 2 * J);
    }
  } else {
    s.sb = smem;
    s.sst = s.sb + kBodyCh * n;
    s.spk = s.sst + kSlotCh * s.ks;
    s.sjv = s.spk + kPackCh * s.kw;
    s.swrow = reinterpret_cast<int*>(s.sjv + kJointCh * J);
    s.slist = s.swrow + 2 * s.kw;
    s.soff = s.slist + 2 * s.kw;
    s.scurA = s.soff + n + 1;
    s.scurB = s.scurA + n;
    s.sworld = s.scurB + n;
    s.sjr = s.sworld + kWorldInts;
    s.shull = reinterpret_cast<float*>(s.sjr + 2 * J);
  }
  s.scache = s.saabb = nullptr;
  s.sri = s.srj = s.skv = s.swork = s.sdeg = s.sbase = nullptr;
  s.smask = nullptr;
  return s;
}

// The fused kernel's windowed layout (kOptWin, carve_fused_window): its
// dynamic shared memory for n bodies, a window of kw work entries and T
// threads, with the manifold cache (cache):
//   floats: 54 a body; 18 (pass contributions) a window entry, with the
//           cache 33 more; 24 (the manifold stash) a window entry past the
//           block's threads
//   ints:   4 a window entry (its rows, its two list entries); 3 n + 1 (the
//           lists' offsets and two cursors a body); 8 world scalars
__host__ __device__ __forceinline__ size_t fused_window_smem_bytes(int n, int kw, int T,
                                                                   bool cache) {
  const size_t nn = static_cast<size_t>(n), ww = static_cast<size_t>(kw);
  const size_t ks = kw > T ? static_cast<size_t>(kw - T) : 0;
  const size_t floats = kBodyCh * nn + kSlotCh * ks + (kPackCh + (cache ? kCacheCh : 0)) * ww;
  const size_t ints = 4 * ww + 3 * nn + 1 + kWorldInts;
  return sizeof(float) * floats + sizeof(int) * ints;
}

// The window of the fused kernel's windowed layout for n bodies, K slots and
// hull bytes of staged hull rows: the most work entries (at most K) whose
// layout lets kWinBlocks CTAs share an SM, when that holds the smallest
// window (a round of the block's threads, or K); else the most that one
// CTA's kMaxSmem holds; 0 when not even the smallest window fits beside the
// bodies and the hull rows.
int fused_window(int n, int K, bool cache, size_t hull) {
  const int T = block_threads(n, K);
  const int least = K < T ? K : T;
  const size_t budgets[2] = {kSmSmem / kWinBlocks - kCtaReserved, kMaxSmem};
  for (const size_t budget : budgets) {
    if (fused_window_smem_bytes(n, least, T, cache) + hull > budget) continue;
    int lo = least, hi = K;
    while (lo < hi) {
      const int mid = lo + (hi - lo + 1) / 2;
      if (fused_window_smem_bytes(n, mid, T, cache) + hull <= budget)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }
  return 0;
}

// The windowed layout's shared memory, carved from the dynamic block: kernel
// 5's window (carve_window) without joints and with the manifold cache of
// the window's entries (33 channels of kw); gsc is the world's slice of the
// global scratch (kScratchCh channels of kg = K - kw floats, then the
// cache's kCacheCh).  BODY: the bodies in a global scratch, as in
// carve_window.
template <bool BODY>
__device__ __forceinline__ Smem carve_fused_window(float* smem, int n, int K, int kw, bool cache,
                                                   int T, float* gsc, float* gb) {
  Smem s;
  s.kw = kw;
  s.kg = K - kw;
  s.gsc = gsc;
  s.ks = kw > T ? kw - T : 0;
  if constexpr (BODY) {
    s.sb = gb;
    s.sst = smem;
    s.spk = s.sst + kSlotCh * s.ks;
    float* f = s.spk + kPackCh * kw;
    s.scache = cache ? f : nullptr;
    f += cache ? kCacheCh * kw : 0;
    s.swrow = reinterpret_cast<int*>(f);
    s.slist = s.swrow + 2 * kw;
    s.sworld = s.slist + 2 * kw;
    s.soff = reinterpret_cast<int*>(gb + kBodyCh * n);
    s.scurA = s.soff + n + 1;
    s.scurB = s.scurA + n;
    s.shull = reinterpret_cast<float*>(s.scurB + n);
  } else {
    s.sb = smem;
    s.sst = s.sb + kBodyCh * n;
    s.spk = s.sst + kSlotCh * s.ks;
    float* f = s.spk + kPackCh * kw;
    s.scache = cache ? f : nullptr;
    f += cache ? kCacheCh * kw : 0;
    s.swrow = reinterpret_cast<int*>(f);
    s.slist = s.swrow + 2 * kw;
    s.soff = s.slist + 2 * kw;
    s.scurA = s.soff + n + 1;
    s.scurB = s.scurA + n;
    s.sworld = s.scurB + n;
    s.shull = reinterpret_cast<float*>(s.sworld + kWorldInts);
  }
  s.sjv = nullptr;
  s.sjr = nullptr;
  s.saabb = nullptr;
  s.sri = s.srj = s.skv = s.swork = s.sdeg = s.sbase = nullptr;
  s.smask = nullptr;
  return s;
}

// The bodies-in-scratch layout (kOptBody).  The bytes a world's bodies,
// lists' offsets and cursors take in the layouts above (what it moves out
// of shared memory); the floats of a world's body scratch with hull_stride
// staged floats a hull row (0 for all-box tables); kernel 5's shared memory
// in it (its window layout without the bodies); the fused kernel's (its
// windowed layout without the bodies) at a window of kw entries, and that
// window: the most entries (at most K) that let kWinBlocks CTAs share an SM.
__host__ __device__ __forceinline__ size_t body_bytes(int n) {
  const size_t nn = static_cast<size_t>(n);
  return sizeof(float) * kBodyCh * nn + sizeof(int) * (3 * nn + 1);
}
__host__ __device__ __forceinline__ size_t body_scratch_floats(int n, int hull_stride,
                                                               int jg = 0) {
  const size_t nn = static_cast<size_t>(n);
  return kBodyCh * nn + 3 * nn + 1 + (kJointCh + 2) * static_cast<size_t>(jg) +
         nn * static_cast<size_t>(hull_stride);
}
size_t substep_body_smem_bytes(int n, int K, int J) {
  return substep_smem_bytes(n, K, J) - body_bytes(n);
}
size_t body_window_smem_bytes(int n, int kw, int T, bool cache) {
  return fused_window_smem_bytes(n, kw, T, cache) - body_bytes(n);
}
int body_window(int n, int K, bool cache) {
  const int T = block_threads(n, K);
  const int least = K < T ? K : T;
  const size_t budget = kSmSmem / kWinBlocks - kCtaReserved;
  if (body_window_smem_bytes(n, least, T, cache) > budget) return 0;
  int lo = least, hi = K;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (body_window_smem_bytes(n, mid, T, cache) <= budget)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Where an entry's data lives.  The fused kernel's layout (WIN false)
// indexes the pass contributions by slot (idx = k), the stash by work
// entry past the threads (e - T); kernel 5's (WIN true) indexes both by
// work entry (idx = e), in the window below kw, else in the global scratch.
template <bool WIN>
__device__ __forceinline__ float* pack_at(const Smem& s, int K, int q, int idx) {
  if (!WIN) return s.spk + q * K + idx;
  return idx < s.kw ? s.spk + q * s.kw + idx : s.gsc + q * s.kg + (idx - s.kw);
}
template <bool WIN>
__device__ __forceinline__ float* stash_at(const Smem& s, int T, int e, int* stride) {
  if (!WIN || e < s.kw) {
    *stride = s.ks;
    return s.sst + (e - T);
  }
  *stride = s.kg;
  return s.gsc + kPackCh * s.kg + (e - s.kw);
}
// The windowed fused kernel's manifold cache of work entry e: in the window
// below kw, else in the global scratch after its kScratchCh channels.
__device__ __forceinline__ float* cache_at(const Smem& s, int e, int* stride) {
  if (e < s.kw) {
    *stride = s.kw;
    return s.scache + e;
  }
  *stride = s.kg;
  return s.gsc + kScratchCh * s.kg + (e - s.kw);
}
// Kernel 5's rows of work entry e, and its body lists' entry i.
__device__ __forceinline__ void entry_rows(const Smem& s, int e, int rows[2]) {
  if (e < s.kw) {
    rows[0] = s.swrow[e];
    rows[1] = s.swrow[s.kw + e];
  } else {
    const float* g = s.gsc + (kPackCh + kSlotCh) * s.kg + (e - s.kw);
    rows[0] = __float_as_int(g[0]);
    rows[1] = __float_as_int(g[s.kg]);
  }
}
__device__ __forceinline__ void entry_rows_store(const Smem& s, int e, int ri, int rj) {
  if (e < s.kw) {
    s.swrow[e] = ri;
    s.swrow[s.kw + e] = rj;
  } else {
    float* g = s.gsc + (kPackCh + kSlotCh) * s.kg + (e - s.kw);
    g[0] = __int_as_float(ri);
    g[s.kg] = __int_as_float(rj);
  }
}
__device__ __forceinline__ int list_at(const Smem& s, int i) {
  return i < 2 * s.kw ? s.slist[i]
                      : __float_as_int(s.gsc[(kPackCh + kSlotCh + 2) * s.kg + (i - 2 * s.kw)]);
}
__device__ __forceinline__ void list_store(const Smem& s, int i, int v) {
  if (i < 2 * s.kw)
    s.slist[i] = v;
  else
    s.gsc[(kPackCh + kSlotCh + 2) * s.kg + (i - 2 * s.kw)] = __int_as_float(v);
}

__device__ __forceinline__ int clamp_row(int r, int n) { return min(max(r, 0), n - 1); }

// Stages world wld's candidate slots from the caller's rows.
__device__ void stage_rows(const Smem& s, const int* rows_i, const int* rows_j,
                           const uint8_t* kvalid, int wld, int n, int K, int tid, int T) {
  for (int k = tid; k < K; k += T) {
    const size_t g = static_cast<size_t>(wld) * K + k;
    s.sri[k] = clamp_row(rows_i[g], n);
    s.srj[k] = clamp_row(rows_j[g], n);
    s.skv[k] = kvalid[g] ? 1 : 0;
  }
}

// The contact kind of a pair of primitives (pair_contacts' branch).
__device__ __forceinline__ int pair_kind(int pa, int pb) {
  const int lo = min(pa, pb), hi = max(pa, pb);
  if (lo == kPrimHull && hi == kPrimHull) return kBoxBox;
  if (lo == kPrimHull && hi == kPrimPlane) return kBoxPlane;
  if (lo == kPrimSphere && hi == kPrimHull) return kSphereBox;
  if (lo == kPrimSphere && hi == kPrimPlane) return kSpherePlane;
  if (lo == kPrimSphere && hi == kPrimSphere) return kSphereSphere;
  return kOther;
}

// The work list, by one warp of L lanes (L = 32 on the card): the valid
// slots below kc grouped by contact kind (Kind's order), ascending within a
// kind — a stable counting sort, two passes of a ballot per kind over
// chunks of L slots.  The per-slot loops walk it, so a warp runs one branch
// of pair_contacts (two or three at the boundaries between kinds).
__device__ void build_work(const Smem& s, const Table& tab, int n, int kc, int lane, int L) {
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  int cnt[kKinds];
#pragma unroll
  for (int c = 0; c < kKinds; ++c) cnt[c] = 0;
  for (int c0 = 0; c0 < kc; c0 += L) {
    const int k = c0 + lane;
    const int kind = (k < kc && s.skv[k])
                         ? pair_kind(tab.prim(obj_of(s.sb, s.sri[k], n)),
                                     tab.prim(obj_of(s.sb, s.srj[k], n)))
                         : kKinds;
#pragma unroll
    for (int c = 0; c < kKinds; ++c) cnt[c] += __popc(__ballot_sync(full, kind == c));
  }
  int base[kKinds], total = 0;
#pragma unroll
  for (int c = 0; c < kKinds; ++c) {
    base[c] = total;
    total += cnt[c];
  }
  for (int c0 = 0; c0 < kc; c0 += L) {
    const int k = c0 + lane;
    const int kind = (k < kc && s.skv[k])
                         ? pair_kind(tab.prim(obj_of(s.sb, s.sri[k], n)),
                                     tab.prim(obj_of(s.sb, s.srj[k], n)))
                         : kKinds;
#pragma unroll
    for (int c = 0; c < kKinds; ++c) {
      const unsigned b = __ballot_sync(full, kind == c);
      if (kind == c) s.swork[base[c] + __popc(b & below)] = k;
      base[c] += __popc(b);
    }
  }
  if (lane == 0) s.sworld[kWorkCount] = total;
}

// Inclusive prefix sum of v over the L lanes of a warp (L = 32 on the card).
__device__ __forceinline__ int warp_scan(int v, int lane, int L) {
  for (int d = 1; d < L; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Each body's list of its pair sides, A sides in ascending slot order then
// B sides (the segment sums walk these lists instead of every slot), by
// one warp of L lanes: a stable counting sort of the valid slots below kc
// by row, chunks of L slots in order, lanes of one row ranked by
// __match_any_sync, each row's leader lane advancing the row's cursor
// (scurA / scurB, set to the row's first A-side and B-side entry).
__device__ void build_lists(const Smem& s, int kc, int lane, int L) {
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  for (int c0 = 0; c0 < kc; c0 += L) {
    const int k = c0 + lane;
    const bool valid = k < kc && s.skv[k];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int row = side ? s.srj[valid ? k : 0] : s.sri[valid ? k : 0];
      const int key = valid ? row : -1 - lane;
      const unsigned same = __match_any_sync(full, key);
      const int leader = __ffs(same) - 1;
      int* cur = side ? s.scurB : s.scurA;
      const int first = __shfl_sync(full, lane == leader && valid ? cur[row] : 0, leader);
      if (valid) s.slist[first + __popc(same & below)] = (k << 1) | side;
      __syncwarp();
      if (valid && lane == leader) cur[row] = first + __popc(same);
      __syncwarp();
    }
  }
}

// Each body's first list entry (soff, n + 1) and its A-side and B-side
// cursors from the counts in scurA and scurB, by one warp's scan.
__device__ __forceinline__ void list_offsets(const Smem& s, int n, int lane, int L) {
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += L) {
    const int b = c0 + lane;
    const int na = b < n ? s.scurA[b] : 0, v = b < n ? na + s.scurB[b] : 0;
    const int incl = warp_scan(v, lane, L);
    if (b < n) {
      const int first = carry + incl - v;
      s.soff[b] = first;
      s.scurA[b] = first;
      s.scurB[b] = first + na;
    }
    carry += __shfl_sync(0xffffffffu, incl, L - 1);
  }
  if (lane == 0) s.soff[n] = carry;
}

// After the staging: kc = 1 + the last valid slot (the cache's dead-slot
// loop stops there; candidate slots are a validity prefix, so this skips
// the dead tail); each body's count of A and B sides (integer atomics: the
// counts do not depend on their order); the lists' offsets by a warp scan;
// then, at once, the lists (build_lists, warp 0) and the work list
// (build_work, warp 1, or warp 0 after the lists when the block has one
// warp).  Starts and ends with a barrier.
__device__ int finish_slots(const Smem& s, const Table& tab, int n, int K, int tid, int T) {
  const int *sri = s.sri, *srj = s.srj, *skv = s.skv;
  __shared__ int s_kc;
  if (tid == 0) s_kc = 0;
  for (int b = tid; b < n; b += T) s.scurA[b] = s.scurB[b] = 0;
  __syncthreads();
  for (int k = tid; k < K; k += T)
    if (skv[k]) {
      atomicMax(&s_kc, k + 1);
      atomicAdd(&s.scurA[sri[k]], 1);
      atomicAdd(&s.scurB[srj[k]], 1);
    }
  __syncthreads();
  const int kc = s_kc;
  const int L = T < 32 ? T : 32, lane = tid % 32;
  if (tid < 32) list_offsets(s, n, lane, L);
  __syncthreads();
  if (tid < 32) build_lists(s, kc, lane, L);
  if (T > 32 ? (tid >= 32 && tid < 64) : tid < 32) build_work(s, tab, n, kc, lane, L);
  __syncthreads();
  return kc;
}

// Kernel 5's slot lists and work list, in its window's layout: the rows are
// read from the caller's arrays (nothing K-wide is staged).  After the
// counts by body (as finish_slots), warp 0 scans the lists' offsets while
// warp 1 counts the valid slots below kc by contact kind; then warp 1 gives
// each valid slot its work entry e (grouped by kind, ascending within a
// kind, as build_work), stores its rows at e and lists its two sides by
// body as (e << 1 | side), in ascending slot order, A sides first (as
// build_lists, whose per-body order the segment sums keep).  Starts and ends
// with a barrier; returns kc.
__device__ int finish_slots_win(const Smem& s, const Table& tab, const int* rows_i,
                                const int* rows_j, const uint8_t* kvalid, int wld, int n, int K,
                                int tid, int T) {
  const size_t k0 = static_cast<size_t>(wld) * K;
  if (tid == 0) s.sworld[kSlotsEnd] = 0;
  for (int b = tid; b < n; b += T) s.scurA[b] = s.scurB[b] = 0;
  __syncthreads();
  for (int k = tid; k < K; k += T)
    if (kvalid[k0 + k]) {
      atomicMax(&s.sworld[kSlotsEnd], k + 1);
      atomicAdd(&s.scurA[clamp_row(rows_i[k0 + k], n)], 1);
      atomicAdd(&s.scurB[clamp_row(rows_j[k0 + k], n)], 1);
    }
  __syncthreads();
  const int kc = s.sworld[kSlotsEnd];
  const int L = T < 32 ? T : 32, lane = tid % 32;
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;
  const bool sorter = T > 32 ? (tid >= 32 && tid < 64) : tid < 32;
  int base[kKinds];
  if (tid < 32) list_offsets(s, n, lane, L);
  if (sorter) {
    int total = 0;
#pragma unroll
    for (int c = 0; c < kKinds; ++c) base[c] = 0;
    for (int c0 = 0; c0 < kc; c0 += L) {
      const int k = c0 + lane;
      const int kind = (k < kc && kvalid[k0 + k])
                           ? pair_kind(tab.prim(obj_of(s.sb, clamp_row(rows_i[k0 + k], n), n)),
                                       tab.prim(obj_of(s.sb, clamp_row(rows_j[k0 + k], n), n)))
                           : kKinds;
#pragma unroll
      for (int c = 0; c < kKinds; ++c) base[c] += __popc(__ballot_sync(full, kind == c));
    }
#pragma unroll
    for (int c = 0; c < kKinds; ++c) {
      const int cnt = base[c];
      base[c] = total;
      total += cnt;
    }
    if (lane == 0) s.sworld[kWorkCount] = total;
  }
  __syncthreads();
  if (sorter) {
    for (int c0 = 0; c0 < kc; c0 += L) {
      const int k = c0 + lane;
      const bool valid = k < kc && kvalid[k0 + k];
      const int ri = valid ? clamp_row(rows_i[k0 + k], n) : 0;
      const int rj = valid ? clamp_row(rows_j[k0 + k], n) : 0;
      const int kind =
          valid ? pair_kind(tab.prim(obj_of(s.sb, ri, n)), tab.prim(obj_of(s.sb, rj, n))) : kKinds;
      int e = 0;
#pragma unroll
      for (int c = 0; c < kKinds; ++c) {
        const unsigned b = __ballot_sync(full, kind == c);
        if (kind == c) e = base[c] + __popc(b & below);
        base[c] += __popc(b);
      }
      if (valid) entry_rows_store(s, e, ri, rj);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int row = side ? rj : ri;
        const int key = valid ? row : -1 - lane;
        const unsigned same = __match_any_sync(full, key);
        const int leader = __ffs(same) - 1;
        int* cur = side ? s.scurB : s.scurA;
        const int first = __shfl_sync(full, lane == leader && valid ? cur[row] : 0, leader);
        if (valid) list_store(s, first + __popc(same & below), (e << 1) | side);
        __syncwarp();
        if (valid && lane == leader) cur[row] = first + __popc(same);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  return kc;
}

// ---------------------------------------------------------------------------
// The in-kernel broadphase (JAX _inkernel_broadphase)
// ---------------------------------------------------------------------------

// Each body's velocity-expanded AABB from the step's starting pose and
// velocity (the JAX kernel's arithmetic, term by term), then the live pairs
// whose AABBs overlap, owned by the higher row, in parallel: each thread
// tests a (row, word) item's 32 lower rows into a bit word of the row's
// partner mask and adds its popcount to the row's degree; a warp scan of
// the degrees capped at D gives each owner its first slot; and each owner
// writes its first min(deg, D) partners in ascending row from its mask,
// without testing again.  Slots
// at K and beyond are not written.  Writes the AABB, row and count
// outputs; the slots go to shared memory for finish_slots.  n <= kMaxBpRows.
__device__ void inkernel_broadphase(const Smem& s, const Args& a, int wld, int n, int K,
                                    int tid, int T) {
  const float* sb = s.sb;
  float* sa = s.saabb;
  const size_t b0 = static_cast<size_t>(wld) * n;
  const uint8_t* live = a.live + b0;
  const float dtv = a.dtv[wld];
  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    const int o = obj_of(sb, b, n);
    const V3 p = ld3(sb, kPos, b, n), vel = ld3(sb, kV, b, n);
    const Q4 q = ld4(sb, kRot, b, n);
    float cl[3], he[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lo = a.tab.aabb_lo(o, c), hi = a.tab.aabb_hi(o, c), sc = a.scale[3 * g + c];
      cl[c] = (lo + hi) * 0.5f * sc;
      he[c] = (hi - lo) * 0.5f * sc;
    }
    const float R[3][3] = {
        {1.0f - 2.0f * (q.y * q.y + q.z * q.z), 2.0f * (q.x * q.y - q.w * q.z),
         2.0f * (q.x * q.z + q.w * q.y)},
        {2.0f * (q.x * q.y + q.w * q.z), 1.0f - 2.0f * (q.x * q.x + q.z * q.z),
         2.0f * (q.y * q.z - q.w * q.x)},
        {2.0f * (q.x * q.z - q.w * q.y), 2.0f * (q.y * q.z + q.w * q.x),
         1.0f - 2.0f * (q.x * q.x + q.y * q.y)}};
    const float pp[3] = {p.x, p.y, p.z}, vv[3] = {vel.x, vel.y, vel.z};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float cw = pp[ax] + (R[ax][0] * cl[0] + R[ax][1] * cl[1] + R[ax][2] * cl[2]);
      const float ext = fabsf(R[ax][0]) * he[0] + fabsf(R[ax][1]) * he[1] + fabsf(R[ax][2]) * he[2];
      const float vexp = vv[ax] * dtv;
      const float lo = ((cw - ext) + fminf(vexp, 0.0f)) - a.inflate;
      const float hi = ((cw + ext) + fmaxf(vexp, 0.0f)) + a.inflate;
      sa[ax * n + b] = lo;
      sa[(3 + ax) * n + b] = hi;
      a.o_aabb_lo[3 * g + ax] = lo;
      a.o_aabb_hi[3 * g + ax] = hi;
    }
  }
  const int nw = (n + 31) / 32;
  for (int k = tid; k < K; k += T) s.sri[k] = s.srj[k] = s.skv[k] = 0;
  for (int wd = tid; wd < kBpWords; wd += T) s.sworld[kBpLive + wd] = 0;
  for (int j = tid; j < n; j += T) s.sdeg[j] = 0;
  if (tid == 0) s.sworld[kBpDropped] = 0;
  __syncthreads();
  for (int b = tid; b < n; b += T)
    if (live[b]) atomicOr(reinterpret_cast<unsigned*>(&s.sworld[kBpLive + b / 32]), 1u << (b % 32));
  __syncthreads();
  // the pair tests: item (j, wd) holds rows i = 32 wd + bit < j; the
  // degrees are summed as the words are made (integer atomics)
  const unsigned* live_bits = reinterpret_cast<const unsigned*>(s.sworld + kBpLive);
  for (int it = tid; it < n * nw; it += T) {
    const int j = it / nw, wd = it % nw;
    unsigned m = 0;
    if (((live_bits[j / 32] >> (j % 32)) & 1u) && 32 * wd < j) {
      float lo[3], hi[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        lo[ax] = sa[ax * n + j];
        hi[ax] = sa[(3 + ax) * n + j];
      }
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const int i = 32 * wd + bit;
        bool ok = i < j;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          ok = ok && lo[ax] <= sa[(3 + ax) * n + i] && hi[ax] >= sa[ax * n + i];
        m |= ok ? 1u << bit : 0u;
      }
      m &= live_bits[wd];
      if (m) atomicAdd(&s.sdeg[j], __popc(m));
    }
    s.smask[j * kBpWords + wd] = m;
  }
  __syncthreads();
  // warp 0: the capped degrees (in sdeg), each owner's first slot (an
  // exclusive warp scan with carry, in sbase), the count and the drops
  if (tid < 32) {
    const int L = T < 32 ? T : 32, lane = tid % 32;
    int carry = 0;
    for (int c0 = 0; c0 < n; c0 += L) {
      const int j = c0 + lane;
      const int deg = j < n ? s.sdeg[j] : 0, capped = min(deg, a.D);
      const int incl = warp_scan(capped, lane, L);
      if (j < n) {
        s.sbase[j] = carry + incl - capped;
        s.sdeg[j] = capped;
        if (deg > capped) atomicAdd(&s.sworld[kBpDropped], deg - capped);
      }
      carry += __shfl_sync(0xffffffffu, incl, L - 1);
    }
    __syncwarp();
    if (lane == 0) {
      a.o_count[wld] = carry;
      a.o_dropped[wld] = s.sworld[kBpDropped];
    }
  }
  __syncthreads();
  // each owner's first min(deg, D) partners, ascending
  for (int j = tid; j < n; j += T) {
    int r = 0, slot = s.sbase[j];
    const int dc = s.sdeg[j];
    for (int wd = 0; wd < nw && r < dc; ++wd) {
      unsigned m = s.smask[j * kBpWords + wd];
      while (m && r < dc) {
        const int i = 32 * wd + __ffs(m) - 1;
        m &= m - 1u;
        if (slot < K) {
          s.sri[slot] = i;
          s.srj[slot] = j;
          s.skv[slot] = 1;
        }
        ++slot;
        ++r;
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += T) {
    const size_t g = static_cast<size_t>(wld) * K + k;
    a.o_rows_i[g] = s.sri[k];
    a.o_rows_j[g] = s.srj[k];
    a.o_kvalid[g] = static_cast<uint8_t>(s.skv[k]);
  }
}

// A warp's sum of v (every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The broadphase outputs of a world that keeps its cache (stable and
// awake): the cached rows and kvalid, also into shared memory, the current
// AABB columns, count = the cached kvalid's sum (warp 0, a warp sum: the
// channel holds 0 and 1, whose sum no order changes), nothing dropped.
// Reads only the cache's three row channels.
__device__ void cached_surface(const Smem& s, const Args& a, int wld, int n, int K, int tid,
                               int T) {
  const float* mc = a.mc + static_cast<size_t>(wld) * kMcCh * K;
  for (int k = tid; k < K; k += T) {
    const int ri = static_cast<int>(mc[k]), rj = static_cast<int>(mc[K + k]);
    const bool kv = mc[2 * K + k] > 0.5f;
    const size_t g = static_cast<size_t>(wld) * K + k;
    a.o_rows_i[g] = ri;
    a.o_rows_j[g] = rj;
    a.o_kvalid[g] = kv ? 1 : 0;
    s.sri[k] = clamp_row(ri, n);
    s.srj[k] = clamp_row(rj, n);
    s.skv[k] = kv ? 1 : 0;
  }
  const size_t g0 = static_cast<size_t>(wld) * 3 * n;
  for (int i = tid; i < 3 * n; i += T) {
    a.o_aabb_lo[g0 + i] = a.aabb_lo[g0 + i];
    a.o_aabb_hi[g0 + i] = a.aabb_hi[g0 + i];
  }
  if (tid < 32) {
    float cnt = 0.0f;
    for (int k = tid; k < K; k += 32) cnt = cnt + mc[2 * K + k];
    cnt = warp_sum(cnt);
    if (tid == 0) {
      a.o_count[wld] = static_cast<int>(cnt);
      a.o_dropped[wld] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// The manifold cache (physics/pairs.py cache_contacts / refresh_contacts)
// ---------------------------------------------------------------------------

// Slot k's manifold (with its point count) in body frames at the pair
// poses A, B.
__device__ void cache_store(float* sc, int K, int k, const Manifold& c, int npts, const Side& A,
                            const Side& B) {
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const V3 rA = qrot_inv(A.rot, sub(c.p[p], A.pos));
    const V3 rB = qrot_inv(B.rot, sub(c.p[p], B.pos));
    sc[(kCRA + p) * K + k] = rA.x;
    sc[(kCRA + 4 + p) * K + k] = rA.y;
    sc[(kCRA + 8 + p) * K + k] = rA.z;
    sc[(kCRB + p) * K + k] = rB.x;
    sc[(kCRB + 4 + p) * K + k] = rB.y;
    sc[(kCRB + 8 + p) * K + k] = rB.z;
    sc[(kCDepth0 + p) * K + k] = c.d[p];
  }
  const V3 nl = qrot_inv(A.rot, c.n);
  sc[kCNLoc * K + k] = nl.x;
  sc[(kCNLoc + 1) * K + k] = nl.y;
  sc[(kCNLoc + 2) * K + k] = nl.z;
  sc[kCOk * K + k] = c.ok ? 1.0f : 0.0f;
  sc[kCNpts * K + k] = static_cast<float>(npts);
}

// The cache of a dead slot, which the plain version computes like any
// other: rows 0 and 0, body 0's pose with w = 1 (the dead-slot quat), no
// contact (zero points and normal, depths -1e9).
__device__ void cache_dead(float* sc, int K, int k, V3 p0, Q4 q0) {
  const Q4 q = Q4{1.0f, q0.x, q0.y, q0.z};
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  const V3 r = qrot_inv(q, sub(zero, p0));
  const V3 nl = qrot_inv(q, zero);
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    sc[(kCRA + p) * K + k] = r.x;
    sc[(kCRA + 4 + p) * K + k] = r.y;
    sc[(kCRA + 8 + p) * K + k] = r.z;
    sc[(kCRB + p) * K + k] = r.x;
    sc[(kCRB + 4 + p) * K + k] = r.y;
    sc[(kCRB + 8 + p) * K + k] = r.z;
    sc[(kCDepth0 + p) * K + k] = kNegBig;
  }
  sc[kCNLoc * K + k] = nl.x;
  sc[(kCNLoc + 1) * K + k] = nl.y;
  sc[(kCNLoc + 2) * K + k] = nl.z;
  sc[kCOk * K + k] = 0.0f;
  sc[kCNpts * K + k] = 0.0f;
}

// Slot k's cached manifold at the pair poses A, B: each point the midpoint
// of its anchors, the normal rotated with A, the depth moved by the anchors'
// divergence along it.
__device__ void cache_refresh(const float* sc, int K, int k, const Side& A, const Side& B,
                              Manifold& c) {
  c.n = qrot(A.rot, mk(sc[kCNLoc * K + k], sc[(kCNLoc + 1) * K + k], sc[(kCNLoc + 2) * K + k]));
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const V3 rA = mk(sc[(kCRA + p) * K + k], sc[(kCRA + 4 + p) * K + k],
                     sc[(kCRA + 8 + p) * K + k]);
    const V3 rB = mk(sc[(kCRB + p) * K + k], sc[(kCRB + 4 + p) * K + k],
                     sc[(kCRB + 8 + p) * K + k]);
    const V3 pA = add(A.pos, qrot(A.rot, rA));
    const V3 pB = add(B.pos, qrot(B.rot, rB));
    c.d[p] = sc[(kCDepth0 + p) * K + k] - dot(c.n, sub(pB, pA));
    c.p[p] = scl(add(pA, pB), 0.5f);
  }
  c.ok = sc[kCOk * K + k] > 0.5f;
}

// Where a substep's contacts come from: pair_contacts (kFresh); pair_contacts
// kept in the cache (kBuild, contact refresh's substep 0); the cache
// (kRefresh); the cache after a rebuild of it (kResolveBuild) or as kept
// (kResolveKeep), persistence's substep 0.
enum ContactMode { kFresh = 0, kBuild, kRefresh, kResolveBuild, kResolveKeep };

// A manifold and its lambdas in a stash entry at sst (channel stride KS).
__device__ __forceinline__ void stash_store(float* sst, int KS, const Manifold& c,
                                            const float (&lam)[kPts]) {
  sst[kSOk * KS] = c.ok ? 1.0f : 0.0f;
  sst[(kSN + 0) * KS] = c.n.x;
  sst[(kSN + 1) * KS] = c.n.y;
  sst[(kSN + 2) * KS] = c.n.z;
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    sst[(kSP + 3 * p) * KS] = c.p[p].x;
    sst[(kSP + 3 * p + 1) * KS] = c.p[p].y;
    sst[(kSP + 3 * p + 2) * KS] = c.p[p].z;
    sst[(kSD + p) * KS] = c.d[p];
    sst[(kSLam + p) * KS] = lam[p];
  }
}
__device__ __forceinline__ void stash_load(const float* sst, int KS, Manifold& c,
                                           float (&lam)[kPts]) {
  c.ok = sst[kSOk * KS] > 0.5f;
  c.n = mk(sst[kSN * KS], sst[(kSN + 1) * KS], sst[(kSN + 2) * KS]);
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    c.p[p] = mk(sst[(kSP + 3 * p) * KS], sst[(kSP + 3 * p + 1) * KS], sst[(kSP + 3 * p + 2) * KS]);
    c.d[p] = sst[(kSD + p) * KS];
    lam[p] = sst[(kSLam + p) * KS];
  }
}

// Stages every hull row's world-space data (Hulls) at its post-integrate
// pose, one thread an item (a vertex, edge direction, SAT axis or face of a
// row), each value as the per-pair code computes it (hull_vert's qrot and
// add; a face's offset face_d + n . pos).  The other rows stage nothing.
__device__ void stage_hulls(const Hulls& h, const float* sb, const Table& tab, int n, int tid,
                            int T) {
  const int R = tab.vm + tab.em + tab.sm + tab.fm;
  for (int it = tid; it < n * R; it += T) {
    const int b = it / R, r = it - b * R;
    const int o = obj_of(sb, b, n);
    if (tab.prim(o) != kPrimHull) continue;
    const V3 pos = ld3(sb, kIPos, b, n);
    const Q4 rot = ld4(sb, kIRot, b, n);
    float* q = h.s + b * h.stride;
    V3 v;
    if (r < tab.vm) {
      v = add(qrot(rot, tab.vert(o, r)), pos);
      q += 3 * r;
    } else if (r < tab.vm + tab.em) {
      v = qrot(rot, ld3g(tab.edge_dir(o, r - tab.vm)));
      q += h.oe + 3 * (r - tab.vm);
    } else if (r < tab.vm + tab.em + tab.sm) {
      v = qrot(rot, ld3g(tab.sat(o, r - tab.vm - tab.em)));
      q += h.os + 3 * (r - tab.vm - tab.em);
    } else {
      const float* F = tab.face(o, r - tab.vm - tab.em - tab.sm);
      v = qrot(rot, ld3g(F));
      q += h.of + 4 * (r - tab.vm - tab.em - tab.sm);
      q[3] = __ldg(F + 3) + dot(v, pos);
    }
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
  }
}

// Steps 2-9 of a substep, from the post-integrate pose and velocities
// (kIPos, kIRot, kIV, kIW) and the substep start (kPrevPos, kPrevRot):
// leaves the new pose in kPos/kRot (dynamic rows only) and the velocities
// in kV/kW (zero on the other rows).  WIN: kernel 5's window layout (the
// entries' rows, pass contributions, stash, list entries and, in the fused
// kernel's windowed specialisations, manifold cache by work entry, those
// past the window in the global scratch).  GEN: the general-hull
// contact paths (pair_contacts, warp_hull_hull) from the hull rows staged
// once a substep (stage_hulls), and round r's work entries dealt to the
// threads lane-major across the warps (entry r T + lane nw + warp, nw
// warps), so that the hull pairs at the head of the work list spread over
// every warp instead of filling the first.  Ends with a barrier.
template <bool CACHE, bool WIN, bool GEN>
__device__ void solve_substep(const Smem& s, const Table& tab, int n, int K, int kc, float h1,
                              float rest1, float relax, float spec, bool bounce, int mode,
                              int tid, int T) {
  float* sb = s.sb;
  const int *sri = s.sri, *srj = s.srj, *skv = s.skv, *soff = s.soff, *slist = s.slist;

  const bool fresh = !CACHE || mode == kFresh || mode == kBuild || mode == kResolveBuild;
  const Hulls hs = hulls_at(s.shull, tab);
  if (GEN && fresh) {
    stage_hulls(hs, sb, tab, n, tid, T);
    __syncthreads();
  }
  if (CACHE && !WIN && mode == kResolveBuild) {
    const V3 p0 = ld3(sb, kIPos, 0, n);
    const Q4 q0 = ld4(sb, kIRot, 0, n);
    for (int k = tid; k < K; k += T)
      if (k >= kc || !skv[k]) cache_dead(s.scache, K, k, p0, q0);
  }

  // (2-4) per valid slot, in work-list order: gather, contacts, positional
  // pass.  The manifold and lambdas of a thread's first entry stay with
  // the thread until the velocity pass; the others wait in the stash.  The
  // loop runs in whole warps (warp_box_box's shuffles): a lane past the
  // list works on the warp's first entry and drops out before the pass.
  const int nwork = s.sworld[kWorkCount];
  const int lane = tid % 32, nw = T > 32 ? T / 32 : 1, warp = tid / 32;
  const int glo = GEN ? hull_group_min(tab) : 1;
  Manifold own;
  float own_lam[kPts];
  // e0: the warp's first entry of the round
  for (int e0 = GEN ? warp : tid - lane; e0 < nwork; e0 += T) {
    const int e = e0 + (GEN ? lane * nw : lane);
    const bool act = e < nwork;
    // the slot (or kernel 5's entry) whose contributions this is
    const int k = WIN ? e : s.swork[act ? e : e0];
    Side S[2];
    Body Bd[2];
    int rows[2];
    if (WIN) {
      entry_rows(s, act ? e : e0, rows);
    } else {
      rows[0] = sri[k];
      rows[1] = srj[k];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int b = rows[q];
      Bd[q].pos = ld3(sb, kIPos, b, n);
      Bd[q].rot = ld4(sb, kIRot, b, n);
      Bd[q].obj = obj_of(sb, b, n);
      S[q].pos = Bd[q].pos;
      S[q].rot = Bd[q].rot;
      S[q].prev_pos = ld3(sb, kPrevPos, b, n);
      S[q].im = sb[kIm * n + b];
      S[q].ii = ld3(sb, kIi, b, n);
      S[q].mu = sb[kMuS * n + b];
    }
    Manifold c;
    int npts = 0;
    if (fresh) {
      // box-box pairs on lane groups where the registers are free (the
      // cache specialisations; see min_blocks), on their own lane elsewhere;
      // general hull pairs on lane groups
      const bool hull2 = act && tab.prim(Bd[0].obj) == kPrimHull &&
                         tab.prim(Bd[1].obj) == kPrimHull;
      const bool bb = CACHE && !GEN && hull2;
      if (CACHE && !GEN) warp_box_box<CACHE>(Bd, tab, spec, bb, lane, c, &npts);
      if (GEN) warp_hull_hull<CACHE>(Bd, rows, tab, hs, spec, hull2, lane, glo, c, &npts);
      if (act && !bb && !(GEN && hull2))
        pair_contacts<CACHE, GEN>(Bd[0], Bd[1], rows[0], rows[1], tab, hs, spec, c, &npts);
    }
    if (!act) continue;
    if (CACHE && WIN && (mode == kBuild || mode == kRefresh)) {
      // the entry's cache in the window or the scratch (no persistence here)
      int cs;
      float* sc = cache_at(s, e, &cs);
      if (mode == kBuild)
        cache_store(sc, cs, 0, c, npts, S[0], S[1]);
      else
        cache_refresh(sc, cs, 0, S[0], S[1], c);
    }
    if (CACHE && !WIN && (mode == kBuild || mode == kResolveBuild))
      cache_store(s.scache, K, k, c, npts, S[0], S[1]);
    if (CACHE && !WIN && (mode == kRefresh || mode == kResolveBuild || mode == kResolveKeep))
      cache_refresh(s.scache, K, k, S[0], S[1], c);
    float pA[9], pB[9], lam[kPts];
    positional_pass(S[0], S[1], c, relax, pA, pB, lam);
    if (e < T) {
      own = c;
#pragma unroll
      for (int p = 0; p < kPts; ++p) own_lam[p] = lam[p];
    } else {
      int ks;
      float* st = stash_at<WIN>(s, T, e, &ks);
      stash_store(st, ks, c, lam);
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      *pack_at<WIN>(s, K, q, k) = pA[q];
      *pack_at<WIN>(s, K, 9 + q, k) = pB[q];
    }
  }
  __syncthreads();

  // (5-6) segment sum (A sides, then B sides, ascending slots) and the
  // pose update / velocity recovery
  for (int b = tid; b < n; b += T) {
    // A non-dynamic body (inverse mass and inertia zero) receives only
    // zero contributions: its sum is skipped, with the same result.
    float acc[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) acc[q] = 0.0f;
    if (sb[kDyn * n + b] > 0.5f)
      for (int i = soff[b]; i < soff[b + 1]; ++i) {
        const int ent = WIN ? list_at(s, i) : slist[i];
        const int k = ent >> 1, side = ent & 1;
#pragma unroll
        for (int q = 0; q < 9; ++q) acc[q] = acc[q] + *pack_at<WIN>(s, K, 9 * side + q, k);
      }
    const V3 pos_i = ld3(sb, kIPos, b, n);
    const Q4 rot_i = ld4(sb, kIRot, b, n);
    const V3 pp = ld3(sb, kPrevPos, b, n);
    const Q4 pr = ld4(sb, kPrevRot, b, n);
    const V3 p2 = add(pos_i, mk(acc[0], acc[1], acc[2]));
    const Q4 dq = qmul(Q4{0.0f, acc[3], acc[4], acc[5]}, rot_i);
    const Q4 r2 = qnormalize(Q4{rot_i.w + 0.5f * dq.w, rot_i.x + 0.5f * dq.x,
                                rot_i.y + 0.5f * dq.y, rot_i.z + 0.5f * dq.z});
    const V3 v2 = mk((p2.x - pp.x - acc[6]) / h1, (p2.y - pp.y - acc[7]) / h1,
                     (p2.z - pp.z - acc[8]) / h1);
    const Q4 dqv = qmul(r2, Q4{pr.w, -pr.x, -pr.y, -pr.z});
    const bool pos_w = dqv.w >= 0.0f;
    const V3 w2 = mk(pos_w ? 2.0f * dqv.x / h1 : -2.0f * dqv.x / h1,
                     pos_w ? 2.0f * dqv.y / h1 : -2.0f * dqv.y / h1,
                     pos_w ? 2.0f * dqv.z / h1 : -2.0f * dqv.z / h1);
    st3(sb, kP2, b, n, p2);
    st4(sb, kR2, b, n, r2);
    st3(sb, kV2, b, n, v2);
    st3(sb, kW2, b, n, w2);
  }
  __syncthreads();

  // (7-8) per valid slot: re-gather at the post-solve poses, velocity pass
  // (the entries dealt as in the positional loop, so a thread's first is
  // the one it kept)
  for (int e = GEN ? lane * nw + warp : tid; e < nwork; e += T) {
    const int k = WIN ? e : s.swork[e];
    Side S[2];
    int rows[2];
    if (WIN) {
      entry_rows(s, e, rows);
    } else {
      rows[0] = sri[k];
      rows[1] = srj[k];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int b = rows[q];
      S[q].pos = ld3(sb, kP2, b, n);
      S[q].rot = ld4(sb, kR2, b, n);
      S[q].v = ld3(sb, kV2, b, n);
      S[q].w = ld3(sb, kW2, b, n);
      S[q].pv = ld3(sb, kIV, b, n);
      S[q].pw = ld3(sb, kIW, b, n);
      S[q].im = sb[kIm * n + b];
      S[q].ii = ld3(sb, kIi, b, n);
      S[q].mu = sb[kMuD * n + b];
      S[q].rest = tab.rest(obj_of(sb, b, n));
    }
    Manifold c = own;
    float lam[kPts];
#pragma unroll
    for (int p = 0; p < kPts; ++p) lam[p] = own_lam[p];
    if (e >= T) {
      int ks;
      const float* st = stash_at<WIN>(s, T, e, &ks);
      stash_load(st, ks, c, lam);
    }
    float pA[6], pB[6];
    velocity_pass(S[0], S[1], c, lam, h1, rest1, bounce, spec, pA, pB);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      *pack_at<WIN>(s, K, q, k) = pA[q];
      *pack_at<WIN>(s, K, 6 + q, k) = pB[q];
    }
  }
  __syncthreads();

  // (9) segment sum; dynamic rows take the solve, the others keep their
  // pose and get zero velocity
  for (int b = tid; b < n; b += T) {
    const bool dyn = sb[kDyn * n + b] > 0.5f;
    float acc[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[q] = 0.0f;
    if (dyn)
      for (int i = soff[b]; i < soff[b + 1]; ++i) {
        const int ent = WIN ? list_at(s, i) : slist[i];
        const int k = ent >> 1, side = ent & 1;
#pragma unroll
        for (int q = 0; q < 6; ++q) acc[q] = acc[q] + *pack_at<WIN>(s, K, 6 * side + q, k);
      }
    const V3 v3 = add(ld3(sb, kV2, b, n), mk(acc[0], acc[1], acc[2]));
    const V3 w3 = add(ld3(sb, kW2, b, n), mk(acc[3], acc[4], acc[5]));
    const V3 zero = mk(0.0f, 0.0f, 0.0f);
    if (dyn) {
      st3(sb, kPos, b, n, ld3(sb, kP2, b, n));
      st4(sb, kRot, b, n, ld4(sb, kR2, b, n));
    }
    st3(sb, kV, b, n, dyn ? v3 : zero);
    st3(sb, kW, b, n, dyn ? w3 : zero);
  }
  __syncthreads();
}

// An asleep world: pose and velocity unchanged, every stash the current state.
__device__ void passthrough(const Args& a, int wld, int n, int tid, int T) {
  const size_t g0 = static_cast<size_t>(wld) * n;
  for (int i = tid; i < 3 * n; i += T) {
    const size_t g = 3 * g0 + i;
    const float p = a.pos[g], v = a.v[g], w = a.w[g];
    a.o_pos[g] = a.o_prev_pos[g] = a.o_ps_pos[g] = p;
    a.o_v[g] = a.o_ps_v[g] = v;
    a.o_w[g] = a.o_ps_w[g] = w;
  }
  for (int i = tid; i < 4 * n; i += T) {
    const size_t g = 4 * g0 + i;
    a.o_rot[g] = a.o_prev_rot[g] = a.o_ps_rot[g] = a.rot[g];
  }
}

// The fused kernel, specialised for its options (kOpt* bits): REFRESH
// (contact refresh), SLEEP (active), BP (the in-kernel broadphase), PERSIST
// (the persistent manifold cache; with BP and REFRESH), WIN (the windowed
// layout, without BP or PERSIST; sleep read from a.active when it is given,
// so that a windowed specialisation serves both).  OPTS = 0 is the kernel
// without options.
// CTAs an SM each specialisation is compiled for (__launch_bounds__'s
// second argument, which caps the registers a thread at 65536 / (128 x
// that)): 4 where shared memory lets 4 worlds share an SM at K = 256; 3
// for their general-hull twins, whose staged hull rows (~24 KB at 65 rows of
// the prism's) leave room for 3; with a manifold cache (33 floats a slot
// more) shared memory allows 2, and the registers are left free; the
// windowed specialisations are sized for kWinBlocks.
template <int OPTS>
constexpr int min_blocks() {
  return (OPTS & (kOptRefresh | kOptPersist)) != 0 ? 1
         : (OPTS & kOptWin) != 0                   ? kWinBlocks
         : (OPTS & kOptHull) != 0                  ? kHullBlocks
                                                   : kMinBlocks;
}

template <int OPTS>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<OPTS>()) fused_substep_kernel(Args a) {
  constexpr bool REFRESH = (OPTS & kOptRefresh) != 0, SLEEP = (OPTS & kOptSleep) != 0;
  constexpr bool BP = (OPTS & kOptBp) != 0, PERSIST = (OPTS & kOptPersist) != 0;
  constexpr bool CACHE = REFRESH || PERSIST, GEN = (OPTS & kOptHull) != 0;
  constexpr bool WIN = (OPTS & kOptWin) != 0, BODY = (OPTS & kOptBody) != 0;
  static_assert(!(WIN && (BP || PERSIST)), "the windowed layout has no broadphase or persistence");
  static_assert(WIN || !BODY, "the bodies-in-scratch layout is a windowed one");
  extern __shared__ float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, K = a.K;
  int wld = blockIdx.x;
  if (SLEEP && PERSIST) {
    // the awake worlds, listed by asleep_surface_kernel (which did the
    // asleep ones); the CTAs past the list's length have nothing to do
    if (wld >= *a.work_count) return;
    wld = a.work_list[wld];
  } else if ((SLEEP || (WIN && a.active)) && !a.active[wld]) {
    passthrough(a, wld, n, tid, T);
    return;
  }
  const Smem s =
      WIN ? carve_fused_window<BODY>(
                smem, n, K, a.kw, CACHE, T,
                a.scratch ? a.scratch + static_cast<size_t>(wld) *
                                            (CACHE ? kWinCacheCh : kScratchCh) * (K - a.kw)
                          : nullptr,
                BODY ? a.bodies + static_cast<size_t>(wld) * a.bstride : nullptr)
          : carve(smem, n, K, BP, CACHE, T);
  float* sb = s.sb;
  const size_t b0 = static_cast<size_t>(wld) * n;

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    for (int c = 0; c < 3; ++c) {
      sb[(kPos + c) * n + b] = a.pos[3 * g + c];
      sb[(kV + c) * n + b] = a.v[3 * g + c];
      sb[(kW + c) * n + b] = a.w[3 * g + c];
    }
    for (int c = 0; c < 4; ++c) sb[(kRot + c) * n + b] = a.rot[4 * g + c];
    const int o = a.obj[g];
    const bool dy = a.dyn[g] != 0;
    if (a.im) {
      // the static columns as given
      for (int c = 0; c < 3; ++c) sb[(kIi + c) * n + b] = a.ii[3 * g + c];
      sb[kIm * n + b] = a.im[g];
      sb[kMuS * n + b] = a.mu_s[g];
      sb[kMuD * n + b] = a.mu_d[g];
    } else {
      // from the object table at the body's object, mass and inertia zero
      // on non-dynamic rows
      for (int c = 0; c < 3; ++c) sb[(kIi + c) * n + b] = dy ? a.tab.inv_inertia(o, c) : 0.0f;
      sb[kIm * n + b] = dy ? a.tab.inv_mass(o) : 0.0f;
      sb[kMuS * n + b] = a.tab.mu_s(o);
      sb[kMuD * n + b] = a.tab.mu_d(o);
    }
    sb[kDyn * n + b] = dy ? 1.0f : 0.0f;
    sb[kObj * n + b] = __int_as_float(o);
    // stashes for a zero-substep call: the current state
    st3(sb, kPrevPos, b, n, ld3(sb, kPos, b, n));
    st4(sb, kPrevRot, b, n, ld4(sb, kRot, b, n));
    st3(sb, kIPos, b, n, ld3(sb, kPos, b, n));
    st4(sb, kIRot, b, n, ld4(sb, kRot, b, n));
    st3(sb, kIV, b, n, ld3(sb, kV, b, n));
    st3(sb, kIW, b, n, ld3(sb, kW, b, n));
  }
  // the candidate slots: kept in the cache, from the broadphase, or given
  const bool keep = PERSIST && a.stable[wld] != 0;
  if (keep) {
    cached_surface(s, a, wld, n, K, tid, T);
    const float* mc = a.mc + static_cast<size_t>(wld) * kMcCh * K;
    for (int k = tid; k < K; k += T)
      for (int c = 0; c < kCacheCh; ++c) s.scache[c * K + k] = mc[(kMcRows + c) * K + k];
  } else if (BP) {
    __syncthreads();
    inkernel_broadphase(s, a, wld, n, K, tid, T);
  } else if (!WIN) {
    stage_rows(s, a.rows_i, a.rows_j, a.kvalid, wld, n, K, tid, T);
  }
  // the slot lists and the work list (the windowed layout's by work entry,
  // from the caller's rows)
  int kc;
  if constexpr (WIN)
    kc = finish_slots_win(s, a.tab, a.rows_i, a.rows_j, a.kvalid, wld, n, K, tid, T);
  else
    kc = finish_slots(s, a.tab, n, K, tid, T);
  const float h1 = a.h[wld], rest1 = a.rest_thr[wld];
  const V3 grav = mk(a.gravity[3 * wld], a.gravity[3 * wld + 1], a.gravity[3 * wld + 2]);

  for (int step = 0; step < a.num_substeps; ++step) {
    // (1) integrate (_integrate), stash the substep start
    for (int b = tid; b < n; b += T) {
      const V3 p = ld3(sb, kPos, b, n), v = ld3(sb, kV, b, n), w = ld3(sb, kW, b, n);
      const Q4 rot = ld4(sb, kRot, b, n);
      st3(sb, kPrevPos, b, n, p);
      st4(sb, kPrevRot, b, n, rot);
      const float im = sb[kIm * n + b];
      const V3 ii = ld3(sb, kIi, b, n);
      const size_t g = b0 + b;
      const V3 f = mk(a.ext_f[3 * g], a.ext_f[3 * g + 1], a.ext_f[3 * g + 2]);
      const V3 tq = mk(a.ext_t[3 * g], a.ext_t[3 * g + 1], a.ext_t[3 * g + 2]);
      const bool live = sb[kDyn * n + b] > 0.5f && im > 0.0f;
      const V3 vn = live ? mk(v.x + h1 * (grav.x + f.x * im), v.y + h1 * (grav.y + f.y * im),
                              v.z + h1 * (grav.z + f.z * im))
                         : v;
      const V3 posn = live ? add(p, scl(vn, h1)) : p;
      const V3 inertia = mk(ii.x > 0.0f ? 1.0f / fmaxf(ii.x, 1e-12f) : 0.0f,
                            ii.y > 0.0f ? 1.0f / fmaxf(ii.y, 1e-12f) : 0.0f,
                            ii.z > 0.0f ? 1.0f / fmaxf(ii.z, 1e-12f) : 0.0f);
      V3 om_b = qrot_inv(rot, w);
      const V3 gyro = cross(om_b, mk(inertia.x * om_b.x, inertia.y * om_b.y, inertia.z * om_b.z));
      const V3 tau_b = qrot_inv(rot, tq);
      om_b = mk(om_b.x + h1 * ii.x * (tau_b.x - gyro.x), om_b.y + h1 * ii.y * (tau_b.y - gyro.y),
                om_b.z + h1 * ii.z * (tau_b.z - gyro.z));
      const V3 wn = live ? qrot(rot, om_b) : w;
      const Q4 dq = qmul(Q4{0.0f, wn.x, wn.y, wn.z}, rot);
      const float hh = 0.5f * h1;
      const Q4 rotn = live ? qnormalize(Q4{rot.w + hh * dq.w, rot.x + hh * dq.x,
                                           rot.y + hh * dq.y, rot.z + hh * dq.z})
                           : rot;
      st3(sb, kIPos, b, n, posn);
      st4(sb, kIRot, b, n, rotn);
      st3(sb, kIV, b, n, vn);
      st3(sb, kIW, b, n, wn);
    }
    __syncthreads();
    // (2-9), the contacts as the options say
    int mode = kFresh;
    if (PERSIST && step == 0)
      mode = keep ? kResolveKeep : kResolveBuild;
    else if (REFRESH && step == 0 && a.num_substeps > 1)
      mode = kBuild;
    else if (REFRESH && step > 0)
      mode = kRefresh;
    solve_substep<CACHE, WIN, GEN>(s, a.tab, n, K, kc, h1, rest1, a.relax, a.spec, a.bounce != 0,
                                   mode, tid, T);
  }

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    const bool kept_v = a.keep_v && sb[kDyn * n + b] < 0.5f;
    for (int c = 0; c < 3; ++c) {
      a.o_pos[3 * g + c] = sb[(kPos + c) * n + b];
      a.o_v[3 * g + c] = kept_v ? a.v[3 * g + c] : sb[(kV + c) * n + b];
      a.o_w[3 * g + c] = kept_v ? a.w[3 * g + c] : sb[(kW + c) * n + b];
      a.o_prev_pos[3 * g + c] = sb[(kPrevPos + c) * n + b];
      a.o_ps_pos[3 * g + c] = sb[(kIPos + c) * n + b];
      a.o_ps_v[3 * g + c] = sb[(kIV + c) * n + b];
      a.o_ps_w[3 * g + c] = sb[(kIW + c) * n + b];
    }
    for (int c = 0; c < 4; ++c) {
      a.o_rot[4 * g + c] = sb[(kRot + c) * n + b];
      a.o_prev_rot[4 * g + c] = sb[(kPrevRot + c) * n + b];
      a.o_ps_rot[4 * g + c] = sb[(kIRot + c) * n + b];
    }
  }
  if (PERSIST && !keep) {
    // a rebuilt world's cache out: the broadphase's rows and the manifold
    // that substep 0 built in shared memory; and its anchors, the step's
    // starting pose, valid unless the degree cap dropped pairs.  A kept
    // world writes none of its cache (it stays in place).  o_mc may be
    // a.mc, and a call on the same inputs repeats bit for bit: a world
    // that rebuilds never reads its cache, one that keeps it never writes
    // it, and no world touches another's.
    float* mo = a.o_mc + static_cast<size_t>(wld) * kMcCh * K;
    for (int k = tid; k < K; k += T) {
      mo[k] = static_cast<float>(s.sri[k]);
      mo[K + k] = static_cast<float>(s.srj[k]);
      mo[2 * K + k] = s.skv[k] ? 1.0f : 0.0f;
      for (int c = 0; c < kCacheCh; ++c) mo[(kMcRows + c) * K + k] = s.scache[c * K + k];
    }
    if (a.o_apos) {
      for (int i = tid; i < 3 * n; i += T) a.o_apos[3 * b0 + i] = a.pos[3 * b0 + i];
      for (int i = tid; i < 4 * n; i += T) a.o_arot[4 * b0 + i] = a.rot[4 * b0 + i];
      if (tid == 0) a.o_valid[wld] = s.sworld[kBpDropped] == 0 ? 1 : 0;
    }
  }
}

// Row g of a [.., 3] or [.., 4] float column in device memory.
__device__ __forceinline__ V3 ldg3(const float* p, size_t g) {
  return mk(p[3 * g], p[3 * g + 1], p[3 * g + 2]);
}
__device__ __forceinline__ Q4 ldg4(const float* p, size_t g) {
  return Q4{p[4 * g], p[4 * g + 1], p[4 * g + 2], p[4 * g + 3]};
}
__device__ __forceinline__ void stg3(float* p, size_t g, V3 v) {
  p[3 * g] = v.x;
  p[3 * g + 1] = v.y;
  p[3 * g + 2] = v.z;
}
__device__ __forceinline__ void stg4(float* p, size_t g, Q4 q) {
  p[4 * g] = q.w;
  p[4 * g + 1] = q.x;
  p[4 * g + 2] = q.y;
  p[4 * g + 3] = q.z;
}

struct Args1 {
  // the body columns: with FULL the state's (pos, rot, v, w, obj, the
  // response type resp and the row mask, ext_f, ext_t); without it the
  // post-integrate pose and velocities, the substep start (prev_pos,
  // prev_rot) and the static columns (im, ii, mu_s, mu_d, obj, dyn)
  const float *pos, *rot, *v, *w, *prev_pos, *prev_rot, *im, *ii, *mu_s, *mu_d;
  const int* obj;
  const uint8_t* dyn;
  const float *h, *rest_thr;
  const int *rows_i, *rows_j;
  const uint8_t* kvalid;
  Table tab;
  int n, K, bounce;
  float relax, spec;
  float *o_pos, *o_rot, *o_v, *o_w;
  float* scratch;  // [W, kScratchCh, substep_scratch(K)], or null when K <= kWindow
  // FULL: the integrate's inputs, the stashes out, the joints (JointConstraint
  // fields [W, J, ...], their row mask) and the entity store [W, E] the
  // joints' handles are looked up in (the body archetype's index arch)
  const int* resp;
  const uint8_t* mask;
  const float *ext_f, *ext_t, *gravity;
  int resp_dynamic;
  float *o_prev_pos, *o_prev_rot, *o_ps_pos, *o_ps_rot, *o_ps_v, *o_ps_w;
  int J, E, arch, id_bits, gen_bits;
  const int *j_e1, *j_e2, *j_type;
  const uint8_t* j_mask;
  const float *j_ar1, *j_ar2, *j_sep, *j_a1, *j_a2, *j_r1, *j_r2;
  const int *e_arch, *e_row, *e_gen;
  // BODY: the body scratch [W, bstride] (body_scratch_floats); jg: the
  // joints' rows in it too (substep_layout_smem)
  float* bodies;
  size_t bstride;
  int jg;
};

// solver.integrate for one body: semi-implicit Euler with the gyroscopic
// term, for a dynamic body with mass (live); the others keep their state.
__device__ __forceinline__ void integrate_t(V3 p, Q4 rot, V3 v, V3 w, float im, V3 ii, V3 f,
                                            V3 tq, bool live, float h, V3 g, V3& pn, Q4& rn,
                                            V3& vn, V3& wn) {
  vn = live ? mk(v.x + h * (g.x + f.x * im), v.y + h * (g.y + f.y * im),
                 v.z + h * (g.z + f.z * im))
            : v;
  pn = live ? mk(p.x + h * vn.x, p.y + h * vn.y, p.z + h * vn.z) : p;
  const V3 inertia = mk(ii.x > 0.0f ? 1.0f / fmaxf(ii.x, 1e-12f) : 0.0f,
                        ii.y > 0.0f ? 1.0f / fmaxf(ii.y, 1e-12f) : 0.0f,
                        ii.z > 0.0f ? 1.0f / fmaxf(ii.z, 1e-12f) : 0.0f);
  V3 om_b = qrot_inv_t(rot, w);
  const V3 gyro = cross_t(om_b, mk(inertia.x * om_b.x, inertia.y * om_b.y, inertia.z * om_b.z));
  const V3 tau_b = qrot_inv_t(rot, tq);
  om_b = mk(om_b.x + h * ii.x * (tau_b.x - gyro.x), om_b.y + h * ii.y * (tau_b.y - gyro.y),
            om_b.z + h * ii.z * (tau_b.z - gyro.z));
  wn = live ? qrot_t(rot, om_b) : w;
  const Q4 d = qmul(Q4{0.0f, wn.x, wn.y, wn.z}, rot);
  rn = live ? qnormalize_t(Q4{rot.w + h * (0.5f * d.w), rot.x + h * (0.5f * d.x),
                              rot.y + h * (0.5f * d.y), rot.z + h * (0.5f * d.z)})
            : rot;
}

// The body row of entity handle e (StateManager.lookup): -1 unless the
// handle is live (its generation current) and its entity in archetype arch.
// The handle is an int32 field's: widened to 64 bits as the port (and the
// JAX package) widen it under 64-bit handles, its id and generation masks
// built in 64 bits, so that the 32 id bits of GEM_TPU_ENTITY_64 are
// defined (an int32 field then holds generation 0).
__device__ __forceinline__ int joint_row(const Args1& a, size_t w0, int e) {
  const long long h = e;
  const long long id_mask = (1LL << a.id_bits) - 1, gen_mask = (1LL << a.gen_bits) - 1;
  const int id = static_cast<int>(h & id_mask);
  const long long gen = (h >> a.id_bits) & gen_mask;
  const size_t g = w0 + min(max(id, 0), a.E - 1);
  const int arch = a.e_arch[g];
  const bool live = e >= 0 && arch >= 0 && (a.e_gen[g] & gen_mask) == gen;
  return live && arch == a.arch ? a.e_row[g] : -1;
}


// One live joint's contributions to its two bodies (solver.solve_joints,
// term by term): out[0..5] body 1's (dx, dw), out[6..11] body 2's.  x, q,
// im, ii: the bodies' pose after the substep and their inverse mass and
// inertia (zero unless dynamic).
__device__ void joint_terms(const Args1& a, size_t g, const V3 (&x)[2], const Q4 (&q)[2],
                            const float (&im)[2], const V3 (&ii)[2], float (&out)[kJointCh]) {
  const bool fixed = a.j_type[g] == 0;
  const float relax = a.relax;
  // angular: Fixed 2 vec((q1 aq1)(q2 aq2)^-1), Hinge a1w x a2w
  const Q4 o0 = qnormalize_t(qmul(q[0], ldg4(a.j_ar1, g)));
  const Q4 o1 = qnormalize_t(qmul(q[1], ldg4(a.j_ar2, g)));
  const Q4 diff = qmul(o0, Q4{o1.w, -o1.x, -o1.y, -o1.z});
  const V3 dq = fixed ? mk(2.0f * diff.x, 2.0f * diff.y, 2.0f * diff.z)
                      : cross_t(qrot_t(q[0], ldg3(a.j_a1, g)), qrot_t(q[1], ldg3(a.j_a2, g)));
  const float mag = sqrtf(dot(dq, dq));
  const float md = fmaxf(mag, 1e-12f);
  const V3 dir = mk(dq.x / md, dq.y / md, dq.z / md);
  V3 nl[2];
  float wa = 0.0f;
#pragma unroll
  for (int sd = 0; sd < 2; ++sd) {
    nl[sd] = qrot_inv_t(q[sd], dir);
    const float ws = nl[sd].x * ii[sd].x * nl[sd].x + nl[sd].y * ii[sd].y * nl[sd].y +
                     nl[sd].z * ii[sd].z * nl[sd].z;
    wa = sd ? wa + ws : ws;
  }
  const float dla = (mag > 1e-9f && wa > 1e-12f ? mag / fmaxf(wa, 1e-12f) : 0.0f) * relax;
  V3 dw[2];
#pragma unroll
  for (int sd = 0; sd < 2; ++sd)
    dw[sd] = qrot_t(q[sd], mk(ii[sd].x * nl[sd].x * dla, ii[sd].y * nl[sd].y * dla,
                              ii[sd].z * nl[sd].z * dla));
  // positional: Fixed keeps the separation along the attachment x axis and
  // zero along the others; Hinge pins the attachment points
  const V3 rw[2] = {qrot_t(q[0], ldg3(a.j_r1, g)), qrot_t(q[1], ldg3(a.j_r2, g))};
  const V3 dr = sub(add(x[1], rw[1]), add(x[0], rw[0]));
  const V3 a1 = qrot_t(o0, mk(1.0f, 0.0f, 0.0f)), b1 = qrot_t(o0, mk(0.0f, 1.0f, 0.0f));
  const V3 c1 = cross_t(a1, b1);
  const float as = dot(dr, a1) - a.j_sep[g], bs = dot(dr, b1), cs = dot(dr, c1);
  const V3 corr = fixed ? mk(as * a1.x + bs * b1.x + cs * c1.x, as * a1.y + bs * b1.y + cs * c1.y,
                             as * a1.z + bs * b1.z + cs * c1.z)
                        : dr;
  const float cmag = sqrtf(dot(corr, corr));
  const float cd = fmaxf(cmag, 1e-12f);
  const V3 nrm = mk(corr.x / cd, corr.y / cd, corr.z / cd);
  float wp = 0.0f;
#pragma unroll
  for (int sd = 0; sd < 2; ++sd) {
    const V3 r = qrot_inv_t(q[sd], cross_t(rw[sd], nrm));
    const float ws = im[sd] + (r.x * ii[sd].x * r.x + r.y * ii[sd].y * r.y + r.z * ii[sd].z * r.z);
    wp = sd ? wp + ws : ws;
  }
  const float dlp = (cmag > 1e-9f && wp > 1e-12f ? cmag / fmaxf(wp, 1e-12f) : 0.0f) * relax;
  const V3 pimp = mk(dlp * nrm.x, dlp * nrm.y, dlp * nrm.z);
#pragma unroll
  for (int sd = 0; sd < 2; ++sd) {
    const V3 p = sd ? mk(-pimp.x, -pimp.y, -pimp.z) : pimp;
    const V3 r = qrot_inv_t(q[sd], cross_t(rw[sd], p));
    const V3 dwp = qrot_t(q[sd], mk(ii[sd].x * r.x, ii[sd].y * r.y, ii[sd].z * r.z));
    const V3 turn = sd ? dw[1] : mk(-dw[0].x, -dw[0].y, -dw[0].z);
    float* o = out + 6 * sd;
    o[0] = p.x * im[sd];
    o[1] = p.y * im[sd];
    o[2] = p.z * im[sd];
    o[3] = turn.x + dwp.x;
    o[4] = turn.y + dwp.y;
    o[5] = turn.z + dwp.z;
  }
}

// Kernel 5 (JAX _make_kernel): one substep of a world with joints.  FULL:
// the whole substep node in one launch — the integrate from the state's
// columns (the per-object constants from the table, masked by dynamic =
// the response type and the row mask), steps 2-9, the joint solve on the
// post-substep pose (one thread a joint: the handles' rows, then both
// sides' terms into shared memory; then one thread a body adds side 1's
// terms over the joints in joint order, then side 2's, and applies them)
// and the writeback (dynamic rows take the solve, the others keep their
// pose and velocity), with the three stashes out.  Without FULL, steps
// 2-9 alone from the caller's post-integrate pose and velocities (the JAX
// kernel's contract).
// BODY: the bodies in a global scratch (kOptBody).
template <bool FULL, bool GEN, bool BODY>
__global__ void __launch_bounds__(kSubstepThreads, kSubstepBlocks) substep_kernel(Args1 a) {
  extern __shared__ float smem[];
  const int wld = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, K = a.K, J = FULL ? a.J : 0;
  const Smem s = carve_window<BODY>(
      smem, n, K, J, T,
      a.scratch ? a.scratch + static_cast<size_t>(wld) * kScratchCh * substep_scratch(K) : nullptr,
      BODY ? a.bodies + static_cast<size_t>(wld) * a.bstride : nullptr, BODY && a.jg != 0);
  float* sb = s.sb;
  const size_t b0 = static_cast<size_t>(wld) * n;
  const float h1 = a.h[wld];

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    if (FULL) {
      const int o = a.obj[g];
      const bool dy = a.resp[g] == a.resp_dynamic && a.mask[g] != 0;
      const float im = dy ? a.tab.inv_mass(o) : 0.0f;
      const V3 ii = dy ? mk(a.tab.inv_inertia(o, 0), a.tab.inv_inertia(o, 1),
                            a.tab.inv_inertia(o, 2))
                       : mk(0.0f, 0.0f, 0.0f);
      const V3 p = ldg3(a.pos, g), v = ldg3(a.v, g), w = ldg3(a.w, g);
      const Q4 rot = ldg4(a.rot, g);
      V3 pn, vn, wn;
      Q4 rn;
      integrate_t(p, rot, v, w, im, ii, ldg3(a.ext_f, g), ldg3(a.ext_t, g), dy && im > 0.0f, h1,
                  mk(a.gravity[3 * wld], a.gravity[3 * wld + 1], a.gravity[3 * wld + 2]), pn, rn,
                  vn, wn);
      st3(sb, kPrevPos, b, n, p);
      st4(sb, kPrevRot, b, n, rot);
      st3(sb, kPos, b, n, pn);
      st4(sb, kRot, b, n, rn);
      st3(sb, kIPos, b, n, pn);
      st4(sb, kIRot, b, n, rn);
      st3(sb, kIV, b, n, vn);
      st3(sb, kIW, b, n, wn);
      st3(sb, kIi, b, n, ii);
      sb[kIm * n + b] = im;
      sb[kMuS * n + b] = a.tab.mu_s(o);
      sb[kMuD * n + b] = a.tab.mu_d(o);
      sb[kDyn * n + b] = dy ? 1.0f : 0.0f;
      sb[kObj * n + b] = __int_as_float(o);
    } else {
      for (int c = 0; c < 3; ++c) {
        const float p = a.pos[3 * g + c], v = a.v[3 * g + c], w = a.w[3 * g + c];
        sb[(kPos + c) * n + b] = p;
        sb[(kIPos + c) * n + b] = p;
        sb[(kIV + c) * n + b] = v;
        sb[(kIW + c) * n + b] = w;
        sb[(kPrevPos + c) * n + b] = a.prev_pos[3 * g + c];
        sb[(kIi + c) * n + b] = a.ii[3 * g + c];
      }
      for (int c = 0; c < 4; ++c) {
        sb[(kRot + c) * n + b] = a.rot[4 * g + c];
        sb[(kIRot + c) * n + b] = a.rot[4 * g + c];
        sb[(kPrevRot + c) * n + b] = a.prev_rot[4 * g + c];
      }
      sb[kIm * n + b] = a.im[g];
      sb[kMuS * n + b] = a.mu_s[g];
      sb[kMuD * n + b] = a.mu_d[g];
      sb[kDyn * n + b] = a.dyn[g] ? 1.0f : 0.0f;
      sb[kObj * n + b] = __int_as_float(a.obj[g]);
    }
  }
  const int kc = finish_slots_win(s, a.tab, a.rows_i, a.rows_j, a.kvalid, wld, n, K, tid, T);
  solve_substep<false, true, GEN>(s, a.tab, n, K, kc, h1, a.rest_thr[wld], a.relax, a.spec,
                             a.bounce != 0, kFresh, tid, T);

  if (!FULL) {
    for (int b = tid; b < n; b += T) {
      const size_t g = b0 + b;
      for (int c = 0; c < 3; ++c) {
        a.o_pos[3 * g + c] = sb[(kPos + c) * n + b];
        a.o_v[3 * g + c] = sb[(kV + c) * n + b];
        a.o_w[3 * g + c] = sb[(kW + c) * n + b];
      }
      for (int c = 0; c < 4; ++c) a.o_rot[4 * g + c] = sb[(kRot + c) * n + b];
    }
    return;
  }

  // the joints: each live one's rows and terms (a dead one costs its mask)
  const size_t j0 = static_cast<size_t>(wld) * J, e0 = static_cast<size_t>(wld) * a.E;
  bool any = false;
  for (int j = tid; j < J; j += T) {
    const size_t g = j0 + j;
    const int r1 = a.j_mask[g] ? joint_row(a, e0, a.j_e1[g]) : -1;
    const int r2 = a.j_mask[g] ? joint_row(a, e0, a.j_e2[g]) : -1;
    const bool live = r1 >= 0 && r2 >= 0;
    s.sjr[j] = live && r1 < n ? r1 : -1;
    s.sjr[J + j] = live && r2 < n ? r2 : -1;
    if (!live) continue;
    any = true;
    const int rows[2] = {min(r1, n - 1), min(r2, n - 1)};
    V3 x[2], ii[2];
    Q4 q[2];
    float im[2];
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      x[sd] = ld3(sb, kPos, rows[sd], n);
      q[sd] = ld4(sb, kRot, rows[sd], n);
      im[sd] = sb[kIm * n + rows[sd]];
      ii[sd] = ld3(sb, kIi, rows[sd], n);
    }
    float out[kJointCh];
    joint_terms(a, g, x, q, im, ii, out);
#pragma unroll
    for (int c = 0; c < kJointCh; ++c) s.sjv[c * J + j] = out[c];
  }
  const bool joints = __syncthreads_or(any) != 0;

  // each body: its joint sums (side 1's over the joints in order, then side
  // 2's), the pose they move it to, and the writeback
  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    float acc1[6], acc2[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) acc1[c] = acc2[c] = 0.0f;
    if (joints)
      for (int j = 0; j < J; ++j) {
        if (s.sjr[j] == b)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc1[c] = acc1[c] + s.sjv[c * J + j];
        if (s.sjr[J + j] == b)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc2[c] = acc2[c] + s.sjv[(6 + c) * J + j];
      }
    const V3 p = ld3(sb, kPos, b, n);
    const Q4 r = ld4(sb, kRot, b, n);
    const V3 pj =
        mk(p.x + (acc1[0] + acc2[0]), p.y + (acc1[1] + acc2[1]), p.z + (acc1[2] + acc2[2]));
    const Q4 rj = rot_delta_t(r, mk(acc1[3] + acc2[3], acc1[4] + acc2[4], acc1[5] + acc2[5]));
    const bool dy = sb[kDyn * n + b] > 0.5f;
    const V3 p0 = ld3(sb, kPrevPos, b, n);
    const Q4 r0 = ld4(sb, kPrevRot, b, n);
    const V3 v = dy ? ld3(sb, kV, b, n) : ldg3(a.v, g);
    const V3 w = dy ? ld3(sb, kW, b, n) : ldg3(a.w, g);
    stg3(a.o_pos, g, dy ? pj : p0);
    stg4(a.o_rot, g, dy ? rj : r0);
    stg3(a.o_v, g, v);
    stg3(a.o_w, g, w);
    stg3(a.o_prev_pos, g, p0);
    stg4(a.o_prev_rot, g, r0);
    stg3(a.o_ps_pos, g, ld3(sb, kIPos, b, n));
    stg4(a.o_ps_rot, g, ld4(sb, kIRot, b, n));
    stg3(a.o_ps_v, g, ld3(sb, kIV, b, n));
    stg3(a.o_ps_w, g, ld3(sb, kIW, b, n));
  }
}

// Raises a kernel's dynamic shared-memory limit to smem when needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The staged hull rows' bytes (Hulls) for n rows of a table's sections
// (hull_stage_bytes in ops/substep_kernel.py): 0 for all-box tables.
size_t hull_stage_bytes(int n, const Table& tab) {
  if (!tab.h) return 0;
  return sizeof(float) * static_cast<size_t>(n) * hull_stride(tab.vm, tab.em, tab.sm, tab.fm);
}

// The shared memory of the fused kernel's specialisation OPTS at n bodies
// and K slots with a table's hull rows: the windowed layout at its window kw
// (fused_window), or the slot layout.
template <int OPTS>
size_t fused_smem(int n, int K, int kw, size_t hull) {
  constexpr bool bp = (OPTS & kOptBp) != 0;
  constexpr bool cache = (OPTS & (kOptRefresh | kOptPersist)) != 0;
  if ((OPTS & kOptBody) != 0) return body_window_smem_bytes(n, kw, block_threads(n, K), cache);
  if ((OPTS & kOptWin) != 0)
    return fused_window_smem_bytes(n, kw, block_threads(n, K), cache) + hull;
  return smem_bytes(n, K, bp, cache) + hull;
}

// The window of the fused kernel's windowed specialisation OPTS (kOptWin)
// at n bodies and K slots with hull bytes of staged rows: the bodies-in-
// scratch one's (body_window) exactly where the windowed layout's
// (fused_window) is 0, else 0 for OPTS of the wrong layout.
template <int OPTS>
int fused_layout_window(int n, int K, size_t hull) {
  constexpr bool cache = (OPTS & (kOptRefresh | kOptPersist)) != 0;
  const int kw = fused_window(n, K, cache, hull);
  if ((OPTS & kOptBody) == 0) return kw;
  return kw == 0 ? body_window(n, K, cache) : 0;
}

template <int OPTS>
cudaError_t launch_fused(const Args& a, int W, cudaStream_t stream) {
  if constexpr (!builds((OPTS & kOptHull) != 0)) {
    return cudaErrorInvalidValue;
  } else {
    const size_t hull = hull_stage_bytes(a.n, a.tab);
    if ((OPTS & kOptWin) != 0) {
      // the window the wrapper sized its scratch for must be this layout's
      const int kw = fused_layout_window<OPTS>(a.n, a.K, hull);
      if (kw < 1 || kw != a.kw || (kw < a.K && !a.scratch)) return cudaErrorInvalidValue;
      if ((OPTS & kOptBody) != 0 && !a.bodies) return cudaErrorInvalidValue;
    }
    const size_t smem = fused_smem<OPTS>(a.n, a.K, a.kw, hull);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(fused_substep_kernel<OPTS>, smem);
    if (err != cudaSuccess) return err;
    fused_substep_kernel<OPTS><<<W, block_threads(a.n, a.K), smem, stream>>>(a);
    return cudaGetLastError();
  }
}

// Kernel 5's layout and shared memory at n bodies, K slots, J joints and
// hull bytes of staged hull rows: the window layout where it fits kMaxSmem
// (*body false), else the bodies in a global scratch (*body true), with
// the joints' rows there too where they do not fit beside the window
// (*jg true).
size_t substep_layout_smem(int n, int K, int J, size_t hull, bool* body, bool* jg) {
  const size_t smem = substep_smem_bytes(n, K, J) + hull;
  *body = smem > kMaxSmem;
  *jg = *body && substep_body_smem_bytes(n, K, J) > kMaxSmem;
  if (!*body) return smem;
  return substep_body_smem_bytes(n, K, *jg ? 0 : J);
}

template <bool FULL, bool GEN, bool BODY>
cudaError_t launch_substep(const Args1& a, int W, size_t smem, cudaStream_t stream) {
  if constexpr (!builds(GEN)) {
    return cudaErrorInvalidValue;
  } else {
    if (smem > kMaxSmem || (BODY && !a.bodies)) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(substep_kernel<FULL, GEN, BODY>, smem);
    if (err != cudaSuccess) return err;
    substep_kernel<FULL, GEN, BODY><<<W, substep_threads(a.n, a.K), smem, stream>>>(a);
    return cudaGetLastError();
  }
}

// Kernel 5's launch with or without its integrate and joints (FULL), in the
// layout and specialisation its shapes and table take.
template <bool FULL>
cudaError_t launch_substep_any(Args1 a, int W, cudaStream_t stream) {
  bool body, jg;
  const size_t smem = substep_layout_smem(a.n, a.K, FULL ? a.J : 0,
                                          hull_stage_bytes(a.n, a.tab), &body, &jg);
  const bool gen = a.tab.h != nullptr;
  a.jg = jg ? 1 : 0;
  a.bstride = body_scratch_floats(
      a.n, gen ? hull_stride(a.tab.vm, a.tab.em, a.tab.sm, a.tab.fm) : 0, jg ? a.J : 0);
  if (body)
    return gen ? launch_substep<FULL, true, true>(a, W, smem, stream)
               : launch_substep<FULL, false, true>(a, W, smem, stream);
  return gen ? launch_substep<FULL, true, false>(a, W, smem, stream)
             : launch_substep<FULL, false, false>(a, W, smem, stream);
}

// CTAs an SM of a kernel at `threads` a CTA and smem bytes of shared memory.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, size_t smem, int* blocks) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

// hull_floats: the staged floats a row of the general-hull twins (0 for the
// box specialisations).
template <int OPTS>
cudaError_t occupancy_fused(int n, int K, int hull_floats, int* threads, int* blocks) {
  *threads = block_threads(n, K);
  if constexpr (!builds((OPTS & kOptHull) != 0)) {
    return cudaErrorInvalidValue;
  } else {
    const size_t stage = sizeof(float) * static_cast<size_t>(n) * hull_floats;
    const int kw = (OPTS & kOptWin) != 0 ? fused_layout_window<OPTS>(n, K, stage) : 0;
    if ((OPTS & kOptWin) != 0 && kw < 1) return cudaErrorInvalidValue;
    return occupancy_of(fused_substep_kernel<OPTS>, *threads,
                        fused_smem<OPTS>(n, K, kw, stage), blocks);
  }
}

// The same for kernel 5 in the specialisation <FULL, GEN> at `threads` a
// CTA and smem bytes, with its bodies in the scratch (body) or not.
template <bool FULL, bool GEN>
cudaError_t occupancy_substep(int threads, size_t smem, bool body, int* blocks) {
  if constexpr (!builds(GEN)) {
    return cudaErrorInvalidValue;
  } else {
    return body ? occupancy_of(substep_kernel<FULL, GEN, true>, threads, smem, blocks)
                : occupancy_of(substep_kernel<FULL, GEN, false>, threads, smem, blocks);
  }
}

// ---------------------------------------------------------------------------
// The world flags and the asleep worlds (persistent manifolds and sleep)
// ---------------------------------------------------------------------------

// Worlds a CTA of the two world kernels below: one warp a world.
constexpr int kWorldWarps = 8;
// pi as float32 (what the plain version's math.pi becomes times a float32)
constexpr float kPi = 3.14159265358979323846f;

struct FlagArgs {
  const float *pos, *rot, *v, *w, *ext_f, *ext_t;
  const uint8_t* dyn;
  const int* obj;
  const float *scale, *delta_t;
  const int* quiet;
  const float *apos, *arot;
  const int* valid;
  Table tab;
  int W, n, frames;
  float thr2, half_margin;
  int *o_quiet, *o_asleep;
  uint8_t *o_active, *o_stable;
};


// The world flags of the fused node (physics/__init__.py; its plain version
// is ops/substep_kernel.py world_flags_plain), one warp a world, its lanes
// over the bodies, any() by warp votes:
//   SLEEP:   the sleep classifier: a world is quiet when no dynamic body
//            has |v|^2 + |w|^2 > thr^2 and none has an external force or
//            torque; quiet_steps counts quiet steps (saturating at frames),
//            asleep = quiet_steps >= frames, active = !asleep;
//   PERSIST: the stability predicate: stable = valid and no dynamic body
//            is forced or has moved (|dpos| + pi |dq| r, since the anchors)
//            plus can move ((|v| + |w| r) dt) by margin / 2, r = the
//            object's bounding radius x its largest scale.
// The arithmetic is the plain version's, term by term: sums of squares in
// component order, IEEE sqrtf, -fmad=false, the thresholds rounded to
// float32 as PyTorch rounds a Python float beside a float32 tensor.
template <bool SLEEP, bool PERSIST>
__global__ void __launch_bounds__(32 * kWorldWarps) world_flags_kernel(FlagArgs a) {
  const int lane = threadIdx.x % 32;
  const int wld = blockIdx.x * kWorldWarps + threadIdx.x / 32;
  if (wld >= a.W) return;
  const int n = a.n;
  const float dt = PERSIST ? a.delta_t[wld] : 0.0f;
  bool forced = false, fast = false, moving = false;
  for (int b = lane; b < n; b += 32) {
    const size_t g = static_cast<size_t>(wld) * n + b;
    if (!a.dyn[g]) continue;
    const V3 f = ldg3(a.ext_f, g), tq = ldg3(a.ext_t, g);
    forced = forced || f.x != 0.0f || f.y != 0.0f || f.z != 0.0f || tq.x != 0.0f ||
             tq.y != 0.0f || tq.z != 0.0f;
    const V3 v = ldg3(a.v, g), w = ldg3(a.w, g);
    if (SLEEP) fast = fast || dot(v, v) + dot(w, w) > a.thr2;
    if (PERSIST) {
      const V3 s = ldg3(a.scale, g);
      const float rad = a.tab.bound_radius(a.obj[g]) * fmaxf(fmaxf(s.x, s.y), s.z);
      const float carry = (sqrtf(dot(v, v)) + sqrtf(dot(w, w)) * rad) * dt;
      const V3 dp = sub(ldg3(a.pos, g), ldg3(a.apos, g));
      const Q4 q = ldg4(a.rot, g), aq = ldg4(a.arot, g);
      const float qw = q.w - aq.w, qx = q.x - aq.x, qy = q.y - aq.y, qz = q.z - aq.z;
      const float dq = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz);
      const float move = sqrtf(dot(dp, dp)) + kPi * dq * rad + carry;
      moving = moving || move >= a.half_margin;
    }
  }
  forced = __any_sync(0xffffffffu, forced);
  if (SLEEP) fast = __any_sync(0xffffffffu, fast);
  if (PERSIST) moving = __any_sync(0xffffffffu, moving);
  if (lane == 0) {
    if (SLEEP) {
      const bool quiet = !(fast || forced);
      const int qs = min(quiet ? a.quiet[wld] + 1 : 0, a.frames);
      const bool asleep = qs >= a.frames;
      a.o_quiet[wld] = qs;
      a.o_asleep[wld] = asleep ? 1 : 0;
      a.o_active[wld] = asleep ? 0 : 1;
    }
    if (PERSIST) a.o_stable[wld] = (a.valid[wld] > 0 && !(moving || forced)) ? 1 : 0;
  }
}

struct SurfArgs {
  const float *pos, *rot, *v, *w;
  const uint8_t* active;
  const float *mc, *aabb_lo, *aabb_hi;
  int W, n, K;
  float *o_pos, *o_rot, *o_v, *o_w, *o_prev_pos, *o_prev_rot, *o_ps_pos, *o_ps_rot, *o_ps_v,
      *o_ps_w;
  float *o_aabb_lo, *o_aabb_hi;
  int *o_rows_i, *o_rows_j;
  uint8_t* o_kvalid;
  int *o_count, *o_dropped;
  int *work_list, *work_count;
  int vec;  // every pointer 16-byte aligned (else every copy goes float by float)
};

// The asleep worlds of fused_substep_kernel<refresh+sleep+bp+persist>,
// and the list of the others, before it runs (its plain version is
// ops/substep_kernel.py asleep_surface_plain).  An asleep world's outputs:
// pose and velocity unchanged, every stash the current state (the
// passthrough), its cached rows and kvalid (the cache's three row
// channels, the only ones it reads: an asleep world neither reads its
// manifold nor writes any of its cache), the current AABB columns, count =
// the cached kvalid's sum (a warp sum), nothing dropped.  CTA 0 lists the
// awake worlds in ascending order (a block scan of the active flags over
// chunks of 256 worlds), their count in work_count and -1 past it.  The
// other threads copy, 16 bytes a load and a store: the [W, n, 3] columns
// four floats a thread (a float4 whose floats are not all in asleep
// worlds goes float by float), the rotations one body a thread; and a
// warp a world takes its slots four at a time and sums its count (float by
// float where a pointer is not 16-byte aligned).  The
// copies are the kernel's bytes; few registers and no shared memory keep
// 48 warps an SM with 16-byte accesses in flight.
constexpr int kSurfThreads = 256;
__global__ void __launch_bounds__(kSurfThreads, 6) asleep_surface_kernel(SurfArgs a) {
  const int W = a.W, n = a.n, K = a.K;
  if (blockIdx.x == 0) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    __shared__ int tot[kSurfThreads / 32];
    int carry = 0;
    for (int c0 = 0; c0 < W; c0 += kSurfThreads) {
      const int wld = c0 + threadIdx.x;
      const bool on = wld < W && a.active[wld];
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) tot[warp] = __popc(m);
      __syncthreads();
      int base = carry, all = 0;
      for (int q = 0; q < kSurfThreads / 32; ++q) {
        base += q < warp ? tot[q] : 0;
        all += tot[q];
      }
      if (on) a.work_list[base + __popc(m & ((1u << lane) - 1u))] = wld;
      carry += all;
      __syncthreads();
    }
    for (int i = carry + threadIdx.x; i < W; i += kSurfThreads) a.work_list[i] = -1;
    if (threadIdx.x == 0) *a.work_count = carry;
    return;
  }
  const size_t t = static_cast<size_t>(blockIdx.x - 1) * kSurfThreads + threadIdx.x;
  const size_t nt = static_cast<size_t>(gridDim.x - 1) * kSurfThreads;
  const uint8_t* active = a.active;
  // the [W, n, 3] columns: pos, v, w and the AABB, four floats a thread
  const size_t n3 = static_cast<size_t>(W) * 3 * n, per = 3 * static_cast<size_t>(n);
  for (size_t e = 4 * t; e < n3; e += 4 * nt) {
    if (a.vec && e + 3 < n3 && !active[e / per] && !active[(e + 3) / per]) {
      const float4 p = *reinterpret_cast<const float4*>(a.pos + e);
      const float4 v = *reinterpret_cast<const float4*>(a.v + e);
      const float4 w = *reinterpret_cast<const float4*>(a.w + e);
      const float4 lo = *reinterpret_cast<const float4*>(a.aabb_lo + e);
      const float4 hi = *reinterpret_cast<const float4*>(a.aabb_hi + e);
      *reinterpret_cast<float4*>(a.o_pos + e) = p;
      *reinterpret_cast<float4*>(a.o_prev_pos + e) = p;
      *reinterpret_cast<float4*>(a.o_ps_pos + e) = p;
      *reinterpret_cast<float4*>(a.o_v + e) = v;
      *reinterpret_cast<float4*>(a.o_ps_v + e) = v;
      *reinterpret_cast<float4*>(a.o_w + e) = w;
      *reinterpret_cast<float4*>(a.o_ps_w + e) = w;
      *reinterpret_cast<float4*>(a.o_aabb_lo + e) = lo;
      *reinterpret_cast<float4*>(a.o_aabb_hi + e) = hi;
      continue;
    }
    for (size_t g = e; g < e + 4 && g < n3; ++g) {
      if (active[g / per]) continue;
      const float p = a.pos[g], v = a.v[g], w = a.w[g];
      a.o_pos[g] = p;
      a.o_prev_pos[g] = p;
      a.o_ps_pos[g] = p;
      a.o_v[g] = v;
      a.o_ps_v[g] = v;
      a.o_w[g] = w;
      a.o_ps_w[g] = w;
      a.o_aabb_lo[g] = a.aabb_lo[g];
      a.o_aabb_hi[g] = a.aabb_hi[g];
    }
  }
  // the rotations, one body (a float4) a thread
  const size_t bodies = static_cast<size_t>(W) * n;
  for (size_t b = t; b < bodies; b += nt) {
    if (active[b / n]) continue;
    if (a.vec) {
      const float4 r = *reinterpret_cast<const float4*>(a.rot + 4 * b);
      *reinterpret_cast<float4*>(a.o_rot + 4 * b) = r;
      *reinterpret_cast<float4*>(a.o_prev_rot + 4 * b) = r;
      *reinterpret_cast<float4*>(a.o_ps_rot + 4 * b) = r;
      continue;
    }
    for (size_t g = 4 * b; g < 4 * b + 4; ++g) {
      const float r = a.rot[g];
      a.o_rot[g] = r;
      a.o_prev_rot[g] = r;
      a.o_ps_rot[g] = r;
    }
  }
  // the cached rows, a warp a world: four slots a lane at a time when K is
  // a multiple of 4, and the count
  const int lane = threadIdx.x % 32;
  for (size_t wld = t / 32; wld < static_cast<size_t>(W); wld += nt / 32) {
    if (active[wld]) continue;
    const float* mc = a.mc + wld * kMcCh * K;
    const size_t g0 = wld * K;
    float cnt = 0.0f;
    if (a.vec && K % 4 == 0) {
      for (int k = 4 * lane; k < K; k += 128) {
        const float4 ri = *reinterpret_cast<const float4*>(mc + k);
        const float4 rj = *reinterpret_cast<const float4*>(mc + K + k);
        const float4 kv = *reinterpret_cast<const float4*>(mc + 2 * K + k);
        *reinterpret_cast<int4*>(a.o_rows_i + g0 + k) =
            make_int4(static_cast<int>(ri.x), static_cast<int>(ri.y), static_cast<int>(ri.z),
                      static_cast<int>(ri.w));
        *reinterpret_cast<int4*>(a.o_rows_j + g0 + k) =
            make_int4(static_cast<int>(rj.x), static_cast<int>(rj.y), static_cast<int>(rj.z),
                      static_cast<int>(rj.w));
        *reinterpret_cast<uchar4*>(a.o_kvalid + g0 + k) =
            make_uchar4(kv.x > 0.5f ? 1 : 0, kv.y > 0.5f ? 1 : 0, kv.z > 0.5f ? 1 : 0,
                        kv.w > 0.5f ? 1 : 0);
        cnt = cnt + kv.x + kv.y + kv.z + kv.w;
      }
    } else {
      for (int k = lane; k < K; k += 32) {
        const float kv = mc[2 * K + k];
        a.o_rows_i[g0 + k] = static_cast<int>(mc[k]);
        a.o_rows_j[g0 + k] = static_cast<int>(mc[K + k]);
        a.o_kvalid[g0 + k] = kv > 0.5f ? 1 : 0;
        cnt = cnt + kv;
      }
    }
    cnt = warp_sum(cnt);
    if (lane == 0) {
      a.o_count[wld] = static_cast<int>(cnt);
      a.o_dropped[wld] = 0;
    }
  }
}

template <bool SLEEP, bool PERSIST>
cudaError_t launch_flags(const FlagArgs& a, cudaStream_t stream) {
  const int blocks = (a.W + kWorldWarps - 1) / kWorldWarps;
  world_flags_kernel<SLEEP, PERSIST><<<blocks, 32 * kWorldWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

// The general-hull rows of a launch (Table::h): hull, the device table of
// pairs.py ObjTables.hull_table, and dims, a host array of its floats an
// object and the table's faces, SAT axes, edge directions, corner slots a
// face and full edges; both null for all-box tables (at most kMaxBoxVerts
// verts a hull, of any with SUBSTEP_WIDE_BOX).  False when they break the
// layout or this build has no specialisation for them.  No count is
// capped: the launch refuses only what its shared memory cannot hold
// (kMaxSmem, with the staged rows).
bool set_hull(Table& tab, const void* hull, const void* dims) {
  if (!hull) return kWideBox || tab.vm <= kMaxBoxVerts;
  if (!builds(true)) return false;
  if (!dims) return false;
  const int* d = static_cast<const int*>(dims);
  tab.h = static_cast<const float*>(hull);
  tab.hs = d[0];
  tab.fm = d[1];
  tab.sm = d[2];
  tab.em = d[3];
  tab.fvm = d[4];
  tab.efm = d[5];
  return tab.fm >= 1 && tab.sm >= 1 && tab.em >= 1 && tab.fvm >= 1 && tab.efm >= 1 &&
         tab.hs == kHullHead + tab.fm * (kFaceHead + kCornerFl * tab.fvm) + 3 * tab.sm +
                       3 * tab.em + 6 * tab.efm;
}

// The fused kernel's specialisations without the general-hull bit, each
// also compiled with it (the windowed ones serve sleep too: the launch
// drops kOptSleep from their bits).
#define SUBSTEP_SPECIALISATIONS(X)                                                      \
  X(0) X(kOptRefresh) X(kOptSleep) X(kOptRefresh | kOptSleep) X(kOptBp)                 \
  X(kOptBp | kOptRefresh) X(kOptPersist | kOptBp | kOptRefresh)                         \
  X(kOptPersist | kOptBp | kOptRefresh | kOptSleep) X(kOptWin) X(kOptWin | kOptRefresh) \
  X(kOptWin | kOptBody) X(kOptWin | kOptBody | kOptRefresh)

}  // namespace

// The launch shape and occupancy of the fused kernel's specialisation
// `opts` (fused_substep_launch's option bits, kOptHull for the general-hull
// one, kOptWin for the windowed one, kOptBody with it for the bodies in a
// global scratch) at n bodies and K slots,
// with hull_floats staged floats a row for the general-hull one
// (hull_stage_floats in ops/substep_kernel.py): threads a CTA and CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int fused_substep_occupancy(int opts, int n, int K, int hull_floats, int* threads,
                                       int* blocks) {
  cudaError_t err;
  if (opts & kOptWin) opts &= ~kOptSleep;
  switch (opts) {
#define SUBSTEP_OCC(c)                                                                 \
  case (c): err = occupancy_fused<(c)>(n, K, 0, threads, blocks); break;               \
  case (c) | kOptHull:                                                                 \
    err = occupancy_fused<(c) | kOptHull>(n, K, hull_floats, threads, blocks);         \
    break;
    SUBSTEP_SPECIALISATIONS(SUBSTEP_OCC)
#undef SUBSTEP_OCC
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The same for kernel 5 (substep_kernel) at n bodies, K slots and J joints,
// with its integrate, joints and writeback (full) or without, for all-box
// tables (hull 0) or general hulls (hull the staged floats a row), in the
// layout those shapes take (the bodies in a global scratch where the window
// layout does not fit).
extern "C" int substep_occupancy(int n, int K, int J, int full, int hull, int* threads,
                                 int* blocks) {
  *threads = substep_threads(n, K);
  bool body, jg;
  const size_t smem =
      substep_layout_smem(n, K, full ? J : 0,
                          sizeof(float) * static_cast<size_t>(n) * (hull > 0 ? hull : 0), &body,
                          &jg);
  const int t = *threads;
  cudaError_t err;
  if (full)
    err = hull ? occupancy_substep<true, true>(t, smem, body, blocks)
               : occupancy_substep<true, false>(t, smem, body, blocks);
  else
    err = hull ? occupancy_substep<false, true>(t, smem, body, blocks)
               : occupancy_substep<false, false>(t, smem, body, blocks);
  return static_cast<int>(err);
}

extern "C" int fused_substep_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* im,
    const void* ii, const void* mu_s, const void* mu_d, const void* obj, const void* ext_f,
    const void* ext_t, const void* dyn, const void* h, const void* gravity,
    const void* rest_thr, const void* rows_i, const void* rows_j, const void* kvalid,
    const void* table, int num_objects, int vm, int W, int n, int K, int num_substeps,
    float relaxation, float speculative, int bounce, void* o_pos, void* o_rot, void* o_v,
    void* o_w, void* o_prev_pos, void* o_prev_rot, void* o_ps_pos, void* o_ps_rot,
    void* o_ps_v, void* o_ps_w, int opts, int degree, float inflate, const void* scale,
    const void* live, const void* dtv, const void* active, const void* stable, const void* mc,
    const void* aabb_lo, const void* aabb_hi, void* o_aabb_lo, void* o_aabb_hi, void* o_rows_i,
    void* o_rows_j, void* o_kvalid, void* o_count, void* o_dropped, void* o_mc, void* o_apos,
    void* o_arot, void* o_valid, const void* work_list, const void* work_count, int keep_v,
    const void* hull, const void* hull_dims, int window, void* scratch, void* bodies,
    void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || num_substeps < 0 || num_objects <= 0 || vm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opts & kOptWin) && (opts & (kOptBp | kOptPersist)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opts & kOptBody) && !(opts & kOptWin)) return static_cast<int>(cudaErrorInvalidValue);
  if ((opts & kOptBp) && (n > kMaxBpRows || degree < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opts & kOptPersist) && (opts & kOptSleep) && (!work_list || !work_count))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.im = static_cast<const float*>(im);
  a.ii = static_cast<const float*>(ii);
  a.mu_s = static_cast<const float*>(mu_s);
  a.mu_d = static_cast<const float*>(mu_d);
  a.obj = static_cast<const int*>(obj);
  a.ext_f = static_cast<const float*>(ext_f);
  a.ext_t = static_cast<const float*>(ext_t);
  a.dyn = static_cast<const uint8_t*>(dyn);
  a.h = static_cast<const float*>(h);
  a.gravity = static_cast<const float*>(gravity);
  a.rest_thr = static_cast<const float*>(rest_thr);
  a.rows_i = static_cast<const int*>(rows_i);
  a.rows_j = static_cast<const int*>(rows_j);
  a.kvalid = static_cast<const uint8_t*>(kvalid);
  a.tab = Table{static_cast<const float*>(table), kTableFixed + 3 * vm, vm};
  if (!set_hull(a.tab, hull, hull_dims)) return static_cast<int>(cudaErrorInvalidValue);
  a.n = n;
  a.K = K;
  a.num_substeps = num_substeps;
  a.bounce = bounce;
  a.relax = relaxation;
  a.spec = speculative;
  a.o_pos = static_cast<float*>(o_pos);
  a.o_rot = static_cast<float*>(o_rot);
  a.o_v = static_cast<float*>(o_v);
  a.o_w = static_cast<float*>(o_w);
  a.o_prev_pos = static_cast<float*>(o_prev_pos);
  a.o_prev_rot = static_cast<float*>(o_prev_rot);
  a.o_ps_pos = static_cast<float*>(o_ps_pos);
  a.o_ps_rot = static_cast<float*>(o_ps_rot);
  a.o_ps_v = static_cast<float*>(o_ps_v);
  a.o_ps_w = static_cast<float*>(o_ps_w);
  a.scale = static_cast<const float*>(scale);
  a.live = static_cast<const uint8_t*>(live);
  a.dtv = static_cast<const float*>(dtv);
  a.active = static_cast<const uint8_t*>(active);
  a.stable = static_cast<const uint8_t*>(stable);
  a.mc = static_cast<const float*>(mc);
  a.aabb_lo = static_cast<const float*>(aabb_lo);
  a.aabb_hi = static_cast<const float*>(aabb_hi);
  a.D = degree;
  a.inflate = inflate;
  a.o_aabb_lo = static_cast<float*>(o_aabb_lo);
  a.o_aabb_hi = static_cast<float*>(o_aabb_hi);
  a.o_rows_i = static_cast<int*>(o_rows_i);
  a.o_rows_j = static_cast<int*>(o_rows_j);
  a.o_kvalid = static_cast<uint8_t*>(o_kvalid);
  a.o_count = static_cast<int*>(o_count);
  a.o_dropped = static_cast<int*>(o_dropped);
  a.o_mc = static_cast<float*>(o_mc);
  a.o_apos = static_cast<float*>(o_apos);
  a.o_arot = static_cast<float*>(o_arot);
  a.o_valid = static_cast<int*>(o_valid);
  a.work_list = static_cast<const int*>(work_list);
  a.work_count = static_cast<const int*>(work_count);
  a.keep_v = keep_v;
  a.kw = window;
  a.scratch = static_cast<float*>(scratch);
  a.bodies = static_cast<float*>(bodies);
  a.bstride = body_scratch_floats(n, hull ? hull_stride(a.tab.vm, a.tab.em, a.tab.sm, a.tab.fm) : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hull) opts |= kOptHull;
  if (opts & kOptWin) opts &= ~kOptSleep;
  cudaError_t err;
  switch (opts) {
#define SUBSTEP_LAUNCH(c)                                                         \
  case (c): err = launch_fused<(c)>(a, W, st); break;                             \
  case (c) | kOptHull: err = launch_fused<(c) | kOptHull>(a, W, st); break;
    SUBSTEP_SPECIALISATIONS(SUBSTEP_LAUNCH)
#undef SUBSTEP_LAUNCH
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The world flags (world_flags_kernel): opts bit 1 the sleep classifier
// (thr2 = the threshold squared, frames), bit 2 the stability predicate
// (half_margin = the persistence margin / 2).  Outputs of an option left
// out are not written (their pointers may be null).
extern "C" int world_flags_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* ext_f,
    const void* ext_t, const void* dyn, const void* obj, const void* scale,
    const void* delta_t, const void* quiet, const void* apos, const void* arot,
    const void* valid, const void* table, int num_objects, int vm, int W, int n, int opts,
    float thr2, int frames, float half_margin, void* o_quiet, void* o_asleep, void* o_active,
    void* o_stable, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || num_objects <= 0 || vm < 0 || opts < 1 || opts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  FlagArgs a;
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.ext_f = static_cast<const float*>(ext_f);
  a.ext_t = static_cast<const float*>(ext_t);
  a.dyn = static_cast<const uint8_t*>(dyn);
  a.obj = static_cast<const int*>(obj);
  a.scale = static_cast<const float*>(scale);
  a.delta_t = static_cast<const float*>(delta_t);
  a.quiet = static_cast<const int*>(quiet);
  a.apos = static_cast<const float*>(apos);
  a.arot = static_cast<const float*>(arot);
  a.valid = static_cast<const int*>(valid);
  a.tab = Table{static_cast<const float*>(table), kTableFixed + 3 * vm, vm};
  a.W = W;
  a.n = n;
  a.frames = frames;
  a.thr2 = thr2;
  a.half_margin = half_margin;
  a.o_quiet = static_cast<int*>(o_quiet);
  a.o_asleep = static_cast<int*>(o_asleep);
  a.o_active = static_cast<uint8_t*>(o_active);
  a.o_stable = static_cast<uint8_t*>(o_stable);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (opts) {
    case 1: err = launch_flags<true, false>(a, st); break;
    case 2: err = launch_flags<false, true>(a, st); break;
    default: err = launch_flags<true, true>(a, st); break;
  }
  return static_cast<int>(err);
}

// The asleep worlds' outputs and the awake worlds' list
// (asleep_surface_kernel), before fused_substep_launch with the options
// refresh, sleep, bp and persist; its output pointers are that call's.
extern "C" int asleep_surface_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* active,
    const void* mc, const void* aabb_lo, const void* aabb_hi, int W, int n, int K, void* o_pos,
    void* o_rot, void* o_v, void* o_w, void* o_prev_pos, void* o_prev_rot, void* o_ps_pos,
    void* o_ps_rot, void* o_ps_v, void* o_ps_w, void* o_aabb_lo, void* o_aabb_hi,
    void* o_rows_i, void* o_rows_j, void* o_kvalid, void* o_count, void* o_dropped,
    void* work_list, void* work_count, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SurfArgs a;
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.active = static_cast<const uint8_t*>(active);
  a.mc = static_cast<const float*>(mc);
  a.aabb_lo = static_cast<const float*>(aabb_lo);
  a.aabb_hi = static_cast<const float*>(aabb_hi);
  a.W = W;
  a.n = n;
  a.K = K;
  a.o_pos = static_cast<float*>(o_pos);
  a.o_rot = static_cast<float*>(o_rot);
  a.o_v = static_cast<float*>(o_v);
  a.o_w = static_cast<float*>(o_w);
  a.o_prev_pos = static_cast<float*>(o_prev_pos);
  a.o_prev_rot = static_cast<float*>(o_prev_rot);
  a.o_ps_pos = static_cast<float*>(o_ps_pos);
  a.o_ps_rot = static_cast<float*>(o_ps_rot);
  a.o_ps_v = static_cast<float*>(o_ps_v);
  a.o_ps_w = static_cast<float*>(o_ps_w);
  a.o_aabb_lo = static_cast<float*>(o_aabb_lo);
  a.o_aabb_hi = static_cast<float*>(o_aabb_hi);
  a.o_rows_i = static_cast<int*>(o_rows_i);
  a.o_rows_j = static_cast<int*>(o_rows_j);
  a.o_kvalid = static_cast<uint8_t*>(o_kvalid);
  a.o_count = static_cast<int*>(o_count);
  a.o_dropped = static_cast<int*>(o_dropped);
  a.work_list = static_cast<int*>(work_list);
  a.work_count = static_cast<int*>(work_count);
  const void* ptrs[] = {pos, rot, v, w, mc, aabb_lo, aabb_hi, o_pos, o_rot, o_v, o_w,
                        o_prev_pos, o_prev_rot, o_ps_pos, o_ps_rot, o_ps_v, o_ps_w, o_aabb_lo,
                        o_aabb_hi, o_rows_i, o_rows_j, o_kvalid};
  a.vec = 1;
  for (const void* q : ptrs) a.vec &= (reinterpret_cast<uintptr_t>(q) % 16) == 0 ? 1 : 0;
  // a thread a body (and with it a float4 of the 3-wide columns), and at
  // least a warp a world, after CTA 0 (the list)
  const size_t bodies = static_cast<size_t>(W) * n;
  const size_t work = bodies > static_cast<size_t>(W) * 32 ? bodies : static_cast<size_t>(W) * 32;
  const int blocks = 1 + static_cast<int>((work + kSurfThreads - 1) / kSurfThreads);
  asleep_surface_kernel<<<blocks, kSurfThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5 without its integrate and joints (the JAX kernel's contract):
// steps 2-9 from the post-integrate pose and velocities.  scratch: [W,
// kScratchCh, substep_scratch(K)] floats, or null when K <= kWindow.
extern "C" int substep_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* prev_pos,
    const void* prev_rot, const void* im, const void* ii, const void* mu_s, const void* mu_d,
    const void* obj, const void* dyn, const void* h, const void* rest_thr, const void* rows_i,
    const void* rows_j, const void* kvalid, const void* table, int num_objects, int vm, int W,
    int n, int K, float relaxation, float speculative, int bounce, void* o_pos, void* o_rot,
    void* o_v, void* o_w, void* scratch, const void* hull, const void* hull_dims, void* bodies,
    void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || num_objects <= 0 || vm < 0 ||
      (substep_scratch(K) > 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  Args1 a = {};
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.prev_pos = static_cast<const float*>(prev_pos);
  a.prev_rot = static_cast<const float*>(prev_rot);
  a.im = static_cast<const float*>(im);
  a.ii = static_cast<const float*>(ii);
  a.mu_s = static_cast<const float*>(mu_s);
  a.mu_d = static_cast<const float*>(mu_d);
  a.obj = static_cast<const int*>(obj);
  a.dyn = static_cast<const uint8_t*>(dyn);
  a.h = static_cast<const float*>(h);
  a.rest_thr = static_cast<const float*>(rest_thr);
  a.rows_i = static_cast<const int*>(rows_i);
  a.rows_j = static_cast<const int*>(rows_j);
  a.kvalid = static_cast<const uint8_t*>(kvalid);
  a.tab = Table{static_cast<const float*>(table), kTableFixed + 3 * vm, vm};
  if (!set_hull(a.tab, hull, hull_dims)) return static_cast<int>(cudaErrorInvalidValue);
  a.n = n;
  a.K = K;
  a.bounce = bounce;
  a.relax = relaxation;
  a.spec = speculative;
  a.o_pos = static_cast<float*>(o_pos);
  a.o_rot = static_cast<float*>(o_rot);
  a.o_v = static_cast<float*>(o_v);
  a.o_w = static_cast<float*>(o_w);
  a.scratch = static_cast<float*>(scratch);
  a.bodies = static_cast<float*>(bodies);
  return static_cast<int>(launch_substep_any<false>(a, W, static_cast<cudaStream_t>(stream)));
}

// Kernel 5 with its integrate, joint solve and writeback: the kernel-mode
// substep node of a world with joints in one launch.  Body columns [W, n]:
// pos, rot, v, w, obj, resp (response type; dynamic = resp_dynamic and the
// row mask), mask, ext_f, ext_t; h, rest_thr [W], gravity [W, 3]; the
// candidate rows [W, K]; the joints [W, J]: e1, e2, joint_type, attach_rot1/2,
// separation, a1/a2_local, r1/r2, their mask; the entity store [W, E]
// (loc_arch, loc_row, gen), the body archetype's index arch and the entity
// handles' id and generation bits (20 and 11 by default, 32 and 31 with
// 64-bit handles).  Outputs [W, n]: pos, rot, v, w, prev_pos, prev_rot,
// ps_pos, ps_rot, ps_v, ps_w.  bodies: the body scratch [W,
// body_scratch_floats] where the shapes take the bodies in a global scratch
// (else null).
extern "C" int substep_node_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* obj,
    const void* resp, const void* mask, const void* ext_f, const void* ext_t, const void* h,
    const void* gravity, const void* rest_thr, const void* rows_i, const void* rows_j,
    const void* kvalid, const void* table, int num_objects, int vm, int W, int n, int K,
    float relaxation, float speculative, int bounce, int resp_dynamic, int J, const void* j_e1,
    const void* j_e2, const void* j_type, const void* j_ar1, const void* j_ar2,
    const void* j_sep, const void* j_a1, const void* j_a2, const void* j_r1, const void* j_r2,
    const void* j_mask, int E, const void* e_arch, const void* e_row, const void* e_gen,
    int arch, int id_bits, int gen_bits, void* o_pos, void* o_rot, void* o_v, void* o_w,
    void* o_prev_pos, void* o_prev_rot, void* o_ps_pos, void* o_ps_rot, void* o_ps_v,
    void* o_ps_w, void* scratch, const void* hull, const void* hull_dims, void* bodies,
    void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || J < 0 || E <= 0 || num_objects <= 0 || vm < 0 || id_bits < 1 ||
      id_bits > 32 || gen_bits < 1 || gen_bits > 31 || id_bits + gen_bits > 63 ||
      (substep_scratch(K) > 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  Args1 a = {};
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.obj = static_cast<const int*>(obj);
  a.resp = static_cast<const int*>(resp);
  a.mask = static_cast<const uint8_t*>(mask);
  a.ext_f = static_cast<const float*>(ext_f);
  a.ext_t = static_cast<const float*>(ext_t);
  a.h = static_cast<const float*>(h);
  a.gravity = static_cast<const float*>(gravity);
  a.rest_thr = static_cast<const float*>(rest_thr);
  a.rows_i = static_cast<const int*>(rows_i);
  a.rows_j = static_cast<const int*>(rows_j);
  a.kvalid = static_cast<const uint8_t*>(kvalid);
  a.tab = Table{static_cast<const float*>(table), kTableFixed + 3 * vm, vm};
  if (!set_hull(a.tab, hull, hull_dims)) return static_cast<int>(cudaErrorInvalidValue);
  a.n = n;
  a.K = K;
  a.bounce = bounce;
  a.relax = relaxation;
  a.spec = speculative;
  a.resp_dynamic = resp_dynamic;
  a.J = J;
  a.j_e1 = static_cast<const int*>(j_e1);
  a.j_e2 = static_cast<const int*>(j_e2);
  a.j_type = static_cast<const int*>(j_type);
  a.j_ar1 = static_cast<const float*>(j_ar1);
  a.j_ar2 = static_cast<const float*>(j_ar2);
  a.j_sep = static_cast<const float*>(j_sep);
  a.j_a1 = static_cast<const float*>(j_a1);
  a.j_a2 = static_cast<const float*>(j_a2);
  a.j_r1 = static_cast<const float*>(j_r1);
  a.j_r2 = static_cast<const float*>(j_r2);
  a.j_mask = static_cast<const uint8_t*>(j_mask);
  a.E = E;
  a.e_arch = static_cast<const int*>(e_arch);
  a.e_row = static_cast<const int*>(e_row);
  a.e_gen = static_cast<const int*>(e_gen);
  a.arch = arch;
  a.id_bits = id_bits;
  a.gen_bits = gen_bits;
  a.o_pos = static_cast<float*>(o_pos);
  a.o_rot = static_cast<float*>(o_rot);
  a.o_v = static_cast<float*>(o_v);
  a.o_w = static_cast<float*>(o_w);
  a.o_prev_pos = static_cast<float*>(o_prev_pos);
  a.o_prev_rot = static_cast<float*>(o_prev_rot);
  a.o_ps_pos = static_cast<float*>(o_ps_pos);
  a.o_ps_rot = static_cast<float*>(o_ps_rot);
  a.o_ps_v = static_cast<float*>(o_ps_v);
  a.o_ps_w = static_cast<float*>(o_ps_w);
  a.scratch = static_cast<float*>(scratch);
  a.bodies = static_cast<float*>(bodies);
  return static_cast<int>(launch_substep_any<true>(a, W, static_cast<cudaStream_t>(stream)));
}
