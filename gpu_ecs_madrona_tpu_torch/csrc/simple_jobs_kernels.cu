// The simple_jobs tick in one kernel for Hopper (sm_90a).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file
// (ctypes).  The launch goes on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// fused_simple_jobs_step_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/simple_jobs_kernel.py:
//   fused_simple_jobs_step (_make_kernel).
//   Computes, per world of n0 bodies ([W, n0, 3] positions, [W, n0, 4]
//   w-first quaternions, row-major as the port stores them):
//     1. clamp each position to the world bounds;
//     2. the AABB of the rotated +-1 cube about it: p -+ e, e_a = sum_b |R_ab|;
//     3. the ordered overlap pairs (a, b), a != b, on closed slabs;
//     4. the capped rank compaction: row a keeps its first D = degree_cap
//        partners in ascending b, at slots base[a] + r with base the
//        exclusive prefix of min(deg, D) over rows; slots at or past K are
//        cut (and not counted as dropped); dropped = sum(deg) - total;
//     5. each kept slot's normal normalize(p_b - p_a), post-clamp;
//     6. the push over EVERY overlapping pair (not the capped list), on
//        positions centred on the world's mean, skipping coincident pairs
//        (d2 <= 1e-12, whose direction is undefined):
//          translation_a = p_a - 2 sum_b rsqrt(d2_ab) (pc_b - pc_a).
//   Outputs: translation, lo, hi [W, n0, 3]; ab [W, K, 2] int32 and normals
//   [W, K, 3] (zero past min(total, K)); counts = total, dropped and, where
//   the caller asks for them, the node's zero counters [W] int32.
//
// What bounds it: at 1024 worlds x 100 bodies x K = 1600 slots a call
// moves W (n0 28 B in + n0 36 B out + K 20 B out + 8 B) ~ 39 MB, ~12 us at
// 3.35 TB/s, against ~10M ordered-pair tests of a few operations each
// (well under 1 us at 67 TFLOP/s).  The bytes bound it, and 82% of them are
// the K-slot buffers, nearly all zero tail at the example's states (a few
// pairs a world once the bodies have been pushed apart).  1024 worlds are
// one partial wave of ~7.8 CTAs an SM, so no later CTA hides an earlier
// one's chain: the design drains the zeros beside the chain, not after it.
//
// Design: one CTA a world: a compute thread a row slot (n0 rounded up to
// 64, at least 128: 4 warps at the example's 100 bodies; n0 <= 1024) and,
// where it fits in 1024 threads (n0 <= 960), one producer warp.  Past 1024
// bodies the rounds layout below takes the same steps.
//   0. The producer warp queues the world's whole ab and normals spans as
//      zeros on the copy engine (bulk stores of a 2 KB zero buffer in
//      shared memory, cp.async.bulk), waits for them to be written and
//      leaves.  Its threads never wait on the compute threads' barrier
//      (named barrier 1), and the copy engine's stores take no issue slot
//      or load-store queue entry from them.  (Zeros stored by the threads
//      themselves, or bulk stores issued by a compute thread, stalled the
//      chain behind the drain: PERF.md, PR 12.)  Without a producer warp a
//      compute thread queues them.
//   1. The compute threads load their body before anything else, then
//      clamp and take the AABB; lo, hi and the clamped position staged as
//      float4s.
//   2. The world's mean in a fixed order (a shuffle tree a warp, then the
//      warps' sums in warp order); each row's half-precision box about the
//      mean, rounded outward (lo down, hi up), so that three half2
//      compares stand for the six float ones and never miss an overlap;
//      pad rows get NaN boxes, which overlap nothing.
//   3. Candidate bits: word k of row c holds row c's half-box overlaps with
//      rows 64k..64k+63 (u64, word-major [chunks][rows]).  Each unordered
//      pair of 64-row chunks is tested once, in units of 16 rows i a warp:
//      the warp holds chunk cj's 64 boxes in registers (two a lane), row
//      i's box is broadcast from shared memory, two ballots give row i's
//      word cj, and the predicates kept by lane j give row j's word ci (a
//      shared atomicOr a unit).  ~16 warp instructions test 64 pairs, where
//      a thread a row walking every b took ~20 for 32.
//   4. One thread a row walks its candidate bits in ascending b, re-tests
//      each in float32 on the closed slabs (the plain version's
//      overlap_grid), clears the filter's false positives from its words,
//      and adds the push of the exact overlaps in the push tree's order
//      (PushTree).  Degrees, ranks and slots come from the exact words
//      only.
//   5. base, total and dropped by warp shuffles: an inclusive scan a warp,
//      then each warp scans the warps' totals (no thread-0 loop, no
//      atomics).
//   6. lo, hi and the translation leave as 16-byte stores from shared
//      memory; then, once the producer's zeros are written (the whole CTA's
//      barrier 0), the slots: rows write their partners and normals into a
//      shared stage of kStage slots, a chunk of slots at a time (n0 = 1000,
//      K = 4096 is 80 KB of slots), and the compute threads write the
//      stage's spans of ab and normals as 16-byte stores, with scalar
//      stores only at a span's unaligned head and tail (K * 8 and K * 12
//      bytes need not be multiples of 16).  One thread writes counts,
//      dropped and the node's zero counters.
//   Two instantiations: <160, 8> for 128 compute threads (the example: 8
//   CTAs an SM, one wave at 1024 worlds, which caps it at 48 registers)
//   and <1024, 1> for the rest.
//
// The rounds layout (fused_simple_jobs_rounds_kernel), past kMaxBodies
// bodies, where a thread a row slot and a bit grid of np^2 / 8 bytes no
// longer fit one CTA (2048 bodies: 512 KB): 1024 threads, every warp
// computing (the slot tail's zeros come last, only past min(total, K)).
// Step 1 clamps and takes the AABB a row at a time; the rows (lo, hi and
// the position less the world's mean, 48 bytes a row) stay in shared memory
// while they fit beside a block's words (n0 <= 3,776), else in a global
// scratch.  Then the rows a block of R (whole chunks, 256 at 2,048 bodies)
// at a time, in row order:
//   A. the block's exact overlap words in shared memory: each unordered
//      chunk pair (ci in the block, cj >= ci) tested once, float32 on the
//      closed slabs (no half-box filter, so no re-test), units of 16 rows a
//      warp with chunk cj's 64 boxes in registers; two ballots give a row's
//      word cj, and each lane keeps its rows' 16-bit quarter of word ci,
//      stored into the block's words when cj is in the block, else into
//      the scratch's lower triangle [nc][np] for cj's block, which copies
//      it in before its own step A (each quarter and word one writer);
//   B. the degrees (popcounts), then C the capped degrees' exclusive
//      prefix a block at a time (warp 0, carried across blocks);
//   D. a warp a row for its push and slots: lane l walks chunk l's word
//      (chunks 2l and 2l + 1 past 32 chunks) in ascending b, the push in
//      PushTree's order (below), the partners of the first 32 ranks into
//      the warp's stage, which lane k turns into slot base + k (ab as an
//      int2, the normals through the stage as consecutive floats); ranks
//      past 32 (a cap D above 32) in further windows.
// At 1024 worlds x 2048 bodies, K = 32768: ~805 MB of outputs (0.24 ms at
// 3.35 TB/s) against the W n0 (n0 - 1) / 2 ~ 2.15G unordered pair tests
// of ~6 operations and, at main_simple_jobs_large's state, ~482M
// overlapping ordered pairs of ~20 (0.3373 ms at 67 TFLOP/s): the pair
// tests bound it.  The world's mean is summed as the layout before this
// one summed it (992 threads' rows first), so the outputs are its bit for
// bit.
//
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain version (ops/simple_jobs_kernel.py), so the
// clamped positions and the AABBs come out bit-identical and so do the
// overlap decisions and every integer output.  The push sums a row's
// partners in a fixed tree (PushTree): each chunk's partners in ascending
// b into the chunk's partial, then the chunks' partials pairwise in chunk
// order, on the kernel's own mean (the rounds layout: a lane's chunk
// partials, then a shuffle butterfly over the lanes, the same tree).  A row of a dense stepped world sums
// ~110-190 pushes to |sum| ~180; added one after another their rounding
// grew with the count (6.2e-4 from float64 on an H100, PERF.md), in the
// tree with its depth.  rsqrtf is the SFU's approximate reciprocal square
// root (about 2 ulp).  Every sum runs in a fixed order and the only
// atomics are integer ORs, so a repeated launch is bit-identical.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase markers: empty in the kernel as built; tools/simple_jobs_ab.py
// --phases defines them to add up each phase's clock64() cycles, with
// SJ_SYNC() (the compute threads' barrier) before each reading.  In the
// rounds layout phase 3 is steps A-B, 4 the push and slots, 5 the prefix, 6
// the tail's zeros.
#ifndef SJ_PHASE
#define SJ_PHASE_START
#define SJ_PHASE(k)
#endif
#define SJ_SYNC() compute_sync(tc)

namespace {

constexpr int kMaxBodies = 1024;   // the one-block layout's bodies at most (the rounds layout past it)
constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 128;   // compute threads: 4 warps at the example's 100 bodies
constexpr int kSmallCtas = 8;      // CTAs an SM the small launch is built for
constexpr int kChunk = 64;         // rows j a warp holds (two a lane), bits a word
constexpr int kUnit = 16;          // rows i of a bit-grid unit (divides kChunk)
constexpr int kStage = 512;        // slots staged a chunk
constexpr int kZeroBytes = 2048;   // the bulk stores' zero source
constexpr int kRoundThreads = 1024; // the rounds layout's threads: 32 warps, all computing
constexpr int kBlockRows = 256;    // the rounds layout's rows a block at most
constexpr int kMinBlockRows = 64;  // ... at least (whole chunks), where its rows stay in shared memory
constexpr int kMeanThreads = 992;  // the rounds layout's threads that sum the world's mean
constexpr int kMaxSmem = 232448;   // a CTA's shared memory at most (227 KB)
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

struct Bounds {
  float lo[3];
  float hi[3];
};

__host__ __device__ inline int chunks(int rows) { return (rows + kChunk - 1) / kChunk; }

// Compute threads a CTA: a thread a row slot (n0 rounded up to kChunk), at
// least kMinThreads.
__host__ __device__ inline int compute_threads(int n0) {
  const int np = kChunk * chunks(n0);
  return np > kMinThreads ? np : kMinThreads;
}

// Threads a CTA: the compute threads and, where it fits, one producer warp.
__host__ __device__ inline int block_threads(int n0) {
  const int tc = compute_threads(n0);
  return tc + 32 <= kMaxThreads ? tc + 32 : tc;
}

// A box in half precision about a reference point, rounded outward (lo
// down, hi up), so that a pair that overlaps in float32 overlaps here too.
// Row i's side of a test reads l, h and zi = (lo.z, -hi.z); row j's l, h
// and zj = (hi.z, -lo.z): three half2 compares test the six float ones.
struct alignas(16) HalfBox {
  __half2 l, h, zi, zj;
};

// Shared memory of a world of n0 bodies, np = kChunk chunks(n0) row slots:
// lo, hi and clamped position as float4 [np] each and the half boxes [np]
// (16 bytes a row each); kZeroBytes of zeros; the overlap bits u64 [np /
// kChunk][np]; the slot stage, ab int [2 kStage] and normals float
// [3 kStage]; the warps' position sums float [32 * 3] and slot and drop
// sums int [32 * 2].
size_t smem_bytes(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = 4 * np;
  const size_t words = np / kChunk * np;
  const size_t stage = 5 * kStage;
  const size_t sums = 32 * 3 + 32 * 2;
  return 16 * rows + kZeroBytes + 8 * words + 4 * (stage + sums);
}

struct Smem {
  float4* lo;       // [np]
  float4* hi;       // [np]
  float4* pos;      // [np] clamped, not centred
  HalfBox* hb;      // [np]; the translation (float4) after step 5
  uint4* zero;      // [kZeroBytes / 16]
  u64* bits;        // [nc][np]: word k of row c at bits[k * np + c]
  int* st_ab;       // [2 kStage]
  float* st_nrm;    // [3 kStage]
  float* red;       // [32 * 3]
  int* isum;        // [32 * 2]
  int np;
};

__device__ Smem smem_layout(float4* smem, int n0) {
  Smem s;
  s.np = kChunk * chunks(n0);
  s.lo = smem;
  s.hi = s.lo + s.np;
  s.pos = s.hi + s.np;
  s.hb = reinterpret_cast<HalfBox*>(s.pos + s.np);
  s.zero = reinterpret_cast<uint4*>(s.hb + s.np);
  s.bits = reinterpret_cast<u64*>(s.zero + kZeroBytes / 16);
  s.st_ab = reinterpret_cast<int*>(s.bits + (s.np / kChunk) * s.np);
  s.st_nrm = reinterpret_cast<float*>(s.st_ab + 2 * kStage);
  s.red = s.st_nrm + 3 * kStage;
  s.isum = reinterpret_cast<int*>(s.red + 32 * 3);
  return s;
}

// The rounds layout (n0 > kMaxBodies).  Its shared memory: the rows (lo,
// hi and centred position, 16 bytes a row slot each) where they fit beside
// a block of kMinBlockRows rows' words; a block's words, u64 [rows][ncp]
// (ncp = nc made odd, so that a unit's 16 rows fall in different banks);
// each warp's slot stage, int [32] and float [3 * 32]; the block's degrees
// and bases, int [2 kBlockRows]; the warps' sums, float [32 * 3] and int
// [32 * 2].  The world's slice of a global scratch that the wrapper
// allocates: the lower triangle's words, u64 [nc][np] (row r's word c for
// the chunks c below r's block, written as 16-bit quarters), then the rows
// and a block's words where they do not fit in shared memory.
__host__ __device__ inline int round_ncp(int n0) { return chunks(n0) | 1; }

__host__ __device__ inline size_t rounds_fixed_bytes() {
  return 4 * (static_cast<size_t>(kRoundThreads / 32) * 4 * 32 + 2 * kBlockRows + 32 * 3 +
              32 * 2);
}

__host__ __device__ inline bool rounds_rows_shared(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t block_words = static_cast<size_t>(kMinBlockRows) * round_ncp(n0);
  return 16 * 3 * np + 8 * block_words + rounds_fixed_bytes() <= kMaxSmem;
}

// The rows a block takes (whole chunks, at most kBlockRows): as many as the
// shared memory left holds the words of, or kBlockRows with the words in
// the scratch where not even kMinBlockRows rows' fit.
__host__ __device__ inline int rounds_block_rows(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = rounds_rows_shared(n0) ? 16 * 3 * np : 0;
  const size_t left = kMaxSmem - rounds_fixed_bytes() - rows;
  const size_t fit = left / (8 * static_cast<size_t>(round_ncp(n0))) / kChunk * kChunk;
  const size_t capped = fit < kBlockRows ? fit : kBlockRows;
  return static_cast<int>(fit < kMinBlockRows ? kBlockRows : capped);
}

__host__ __device__ inline bool rounds_words_shared(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = rounds_rows_shared(n0) ? 16 * 3 * np : 0;
  const size_t block_words = static_cast<size_t>(kMinBlockRows) * round_ncp(n0);
  return rows + 8 * block_words + rounds_fixed_bytes() <= kMaxSmem;
}

size_t rounds_smem_bytes(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = rounds_rows_shared(n0) ? 3 * np : 0;
  const size_t words = rounds_words_shared(n0)
                           ? static_cast<size_t>(rounds_block_rows(n0)) * round_ncp(n0) : 0;
  return 16 * rows + 8 * words + rounds_fixed_bytes();
}

__host__ __device__ inline size_t rounds_scratch_bytes(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t lower = np / kChunk * np;
  const size_t rows = rounds_rows_shared(n0) ? 0 : 3 * np;
  const size_t words = rounds_words_shared(n0)
                           ? 0 : static_cast<size_t>(rounds_block_rows(n0)) * round_ncp(n0);
  return 8 * lower + 16 * rows + 8 * words;
}

__device__ inline HalfBox nan_half_box() {
  const __half2 q = __halves2half2(__ushort_as_half(0x7fff), __ushort_as_half(0x7fff));
  return HalfBox{q, q, q, q};
}

// The reference point of a world's half boxes: r where it is finite, else 0.
__device__ inline float3 finite_ref(float3 r) {
  return isfinite(r.x) && isfinite(r.y) && isfinite(r.z) ? r : make_float3(0.0f, 0.0f, 0.0f);
}

__device__ inline HalfBox half_box(float4 l, float4 h, float3 r) {
  const float lx = l.x - r.x, ly = l.y - r.y, lz = l.z - r.z;
  const float hx = h.x - r.x, hy = h.y - r.y, hz = h.z - r.z;
  return HalfBox{__halves2half2(__float2half_rd(lx), __float2half_rd(ly)),
                 __halves2half2(__float2half_ru(hx), __float2half_ru(hy)),
                 __halves2half2(__float2half_rd(lz), __float2half_rd(-hz)),
                 __halves2half2(__float2half_ru(hz), __float2half_ru(-lz))};
}

// The half test of rows i and j: true wherever the float32 test is.
__device__ inline bool half_overlap(const HalfBox& i, const HalfBox& j) {
  return __hble2(i.l, j.h) & __hble2(j.l, i.h) & __hble2(i.zi, j.zj);
}

// The plain version's overlap_grid test of two rows (closed slabs).
__device__ inline bool overlap(float4 li, float4 hi, float4 lj, float4 hj) {
  return (li.x <= hj.x) & (lj.x <= hi.x) & (li.y <= hj.y) & (lj.y <= hi.y) &
         (li.z <= hj.z) & (lj.z <= hi.z);
}

// Bulk (TMA) stores: the copy engine writes shared memory to global memory
// while the threads go on, so the slot spans' zeros drain beside the
// tick's chain instead of queueing in front of its shared-memory traffic.
// bulk_store: `bytes` (a multiple of 16) from src to dst, both 16-byte
// aligned, in the executing thread's bulk group.
__device__ inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))),
                  "r"(bytes) : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// Waits until the executing thread's bulk stores are written, then orders
// them before its later generic accesses (and, through a barrier, the
// CTA's).
__device__ inline void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Orders the CTA's generic writes to shared memory before the copy
// engine's reads of it (with a barrier after).
__device__ inline void fence_shared_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The compute threads' barrier: named barrier 1 over tc threads (the
// producer warp never waits on it).
__device__ inline void compute_sync(int tc) {
  asm volatile("bar.sync 1, %0;" :: "r"(tc) : "memory");
}

// The whole CTA's barrier, reached from the producer's and the compute
// threads' own code (not aligned: they reach it at different instructions).
__device__ inline void cta_sync() {
  asm volatile("barrier.sync 0, %0;" :: "r"(static_cast<int>(blockDim.x)) : "memory");
}

// Zeros over words [0, n) of dst by a team of threads (t its index):
// scalar stores up to its first 16-byte boundary and past its last, bulk
// stores of the zero buffer between (t = 0 issues them; bulk_wait before
// any later store to the span).
__device__ void zero_span(uint32_t* __restrict__ dst, int n, const uint4* zero, int t) {
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int a0 = min(n, (4 - phase) & 3);
  const int a1 = a0 + ((n - a0) & ~3);
  if (t < a0) dst[t] = 0u;
  if (t < n - a1) dst[a1 + t] = 0u;
  if (t == 0)
    for (int i = a0; i < a1; i += kZeroBytes / 4)
      bulk_store(dst + i, zero, static_cast<uint32_t>(min(kZeroBytes, 4 * (a1 - i))));
}

// Words [i0, i1) of a 4-byte word array dst, word i = val(i), by T threads
// (t their index): scalar stores up to the first 16-byte boundary and past
// the last one, 16-byte stores between (consecutive threads, consecutive
// addresses).
template <typename Val>
__device__ void put_words(uint32_t* __restrict__ dst, int i0, int i1, Val val, int t, int T) {
  if (i0 >= i1) return;
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(dst + i0) >> 2) & 3);
  const int a0 = min(i1, i0 + ((4 - phase) & 3));
  const int a1 = a0 + ((i1 - a0) & ~3);
  if (t < a0 - i0) dst[i0 + t] = val(i0 + t);
  for (int i = a0 + 4 * t; i < a1; i += 4 * T)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(val(i), val(i + 1), val(i + 2), val(i + 3));
  if (t < i1 - a1) dst[a1 + t] = val(a1 + t);
}

// Words [i0, i1) of a [rows, 3] float array from float4 rows in shared memory.
__device__ void put_rows3(float* __restrict__ dst, int i0, int i1, const float4* rows, int t,
                          int T) {
  put_words(reinterpret_cast<uint32_t*>(dst), i0, i1, [&](int i) {
    const float4 r = rows[i / 3];
    const int c = i - 3 * (i / 3);
    return __float_as_uint(c == 0 ? r.x : (c == 1 ? r.y : r.z));
  }, t, T);
}

// The sum of the tc compute threads' (x, y, z) in a fixed order: a
// shuffle tree a warp, then the warps' sums in warp order; every compute
// thread gets it (one compute barrier).
__device__ float3 block_sum3(float sx, float sy, float sz, float* red, int tc) {
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(kFull, sx, o);
    sy += __shfl_xor_sync(kFull, sy, o);
    sz += __shfl_xor_sync(kFull, sz, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[3 * warp] = sx;
    red[3 * warp + 1] = sy;
    red[3 * warp + 2] = sz;
  }
  compute_sync(tc);
  float3 sum = make_float3(0.0f, 0.0f, 0.0f);
  for (int v = 0; v < tc >> 5; ++v) {
    sum.x += red[3 * v];
    sum.y += red[3 * v + 1];
    sum.z += red[3 * v + 2];
  }
  return sum;
}

// A row's push sum in a fixed tree order.  Each chunk's partners (word k of
// the row, ascending b) are added one after another into the chunk's
// partial, which push(k) then folds into a binary counter over the chunks:
// level l holds the partial of the 2^l chunks before it until its sibling
// block arrives (left + right), and blocks of 2^L chunks are added to top in
// chunk order.  total(nc) adds the levels that are left from the lowest up
// (each the block left of the sum so far), top last.  The order depends on
// nc alone; L is the instantiation's levels (nc <= 2^L where the layout
// bounds it).
template <int L>
struct PushTree {
  float3 lv[L];
  float3 top;
  __device__ void clear() {
#pragma unroll
    for (int l = 0; l < L; ++l) lv[l] = make_float3(0.0f, 0.0f, 0.0f);
    top = make_float3(0.0f, 0.0f, 0.0f);
  }
  __device__ void push(float3 c, int k) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (((k >> l) & 1) == 0) {
        lv[l] = c;
        return;
      }
      c = make_float3(lv[l].x + c.x, lv[l].y + c.y, lv[l].z + c.z);
    }
    top = make_float3(top.x + c.x, top.y + c.y, top.z + c.z);
  }
  __device__ float3 total(int nc) const {
    float3 s = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int l = 0; l < L; ++l)
      if ((nc >> l) & 1) s = make_float3(lv[l].x + s.x, lv[l].y + s.y, lv[l].z + s.z);
    if (nc >> L) s = make_float3(top.x + s.x, top.y + s.y, top.z + s.z);
    return s;
  }
};
// Levels of the one-block layout's push trees (nc <= kMaxBodies / kChunk =
// 16 chunks; 2 in the small instantiation) and of the rounds layout's (64
// chunks, 4,096 bodies; past that top adds blocks of 64 in order).
constexpr int kTreeLevels = 4, kSmallTreeLevels = 1, kRoundTreeLevels = 6;

// The exclusive prefix of v over the tc compute threads in thread order,
// its total, and the total of drop: a shuffle scan a warp, the warps'
// totals in shared memory, then each warp scans those by shuffles (one
// compute barrier).
struct Scan {
  int base, total, dropped;
};

__device__ Scan block_scan(int v, int drop, int* isum, int tc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = tc >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  for (int o = 16; o > 0; o >>= 1) drop += __shfl_xor_sync(kFull, drop, o);
  if (lane == 31) isum[warp] = x;
  if (lane == 0) isum[32 + warp] = drop;
  compute_sync(tc);
  int t = lane < warps ? isum[lane] : 0;
  int d = lane < warps ? isum[32 + lane] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t += y;
  }
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  const int upto = __shfl_sync(kFull, t, warp);  // warps 0..warp inclusive
  const int total = __shfl_sync(kFull, t, warps - 1);
  return Scan{upto - isum[warp] + x - v, total, d};
}

// Step 3: the candidate bits.  Unit u of the upper triangle's chunk pairs
// (ci <= cj, row-major), part h: rows i0 = kChunk ci + kUnit h .. i0 +
// kUnit - 1 against chunk cj's kChunk rows (j and j + 32 on lane j), one
// warp.  Units go to the tc / 32 compute warps round-robin.  Row words are stored whole
// (one writer); the transposed bits, (row j in cj, word ci < cj), by
// atomicOr.  A bit is set where the half boxes overlap: every overlapping
// pair, and rarely a pair that step 4's float test drops.  The self bit of
// a diagonal block stays set: step 4 clears it.
__device__ void overlap_bits(const Smem& s, int n0, int tc) {
  constexpr int parts = kChunk / kUnit;
  const int lane = threadIdx.x & 31;
  const int warps = tc >> 5;
  const int nc = chunks(n0);
  const int units = nc * (nc + 1) / 2 * parts;
  for (int u = threadIdx.x >> 5; u < units; u += warps) {
    int b = u / parts, ci = 0, row = nc;
    while (b >= row) {
      b -= row;
      ++ci;
      --row;
    }
    const int cj = ci + b;
    const int i0 = kChunk * ci + kUnit * (u % parts);
    if (i0 >= n0) continue;  // warp-uniform: past the last row
    const int j = kChunk * cj + lane;
    const HalfBox j0 = s.hb[j], j1 = s.hb[j + 32];
    u64* out = s.bits + cj * s.np + i0;
    uint32_t c0 = 0u, c1 = 0u;
#pragma unroll
    for (int k = 0; k < kUnit; ++k) {
      const HalfBox bi = s.hb[i0 + k];
      const bool p0 = half_overlap(bi, j0), p1 = half_overlap(bi, j1);
      const u64 w0 = __ballot_sync(kFull, p0), w1 = __ballot_sync(kFull, p1);
      out[k] = w0 | (w1 << 32);  // every lane stores the same word
      if (p0) c0 |= 1u << k;
      if (p1) c1 |= 1u << k;
    }
    if (ci != cj) {
      const int shift = i0 - kChunk * ci;
      u64* col = s.bits + ci * s.np + j;
      if (c0 != 0u) atomicOr(col, static_cast<u64>(c0) << shift);
      if (c1 != 0u) atomicOr(col + 32, static_cast<u64>(c1) << shift);
    }
  }
}

// kMaxT, kMinCtas: the launch bounds of an instantiation (the small one
// holds the example's 128 compute threads and producer warp at kSmallCtas
// CTAs an SM, which caps its registers).
template <int kMaxT, int kMinCtas>
__global__ void __launch_bounds__(kMaxT, kMinCtas)
fused_simple_jobs_step_kernel(const float* __restrict__ pos,
                              const float4* __restrict__ rot, int n0, int K,
                              int D, Bounds bounds,
                              float* __restrict__ translation,
                              float* __restrict__ lo, float* __restrict__ hi,
                              int* __restrict__ ab, float* __restrict__ nrm,
                              int* __restrict__ counts,
                              int* __restrict__ dropped,
                              int* __restrict__ zeros) {
  extern __shared__ float4 smem[];
  const Smem s = smem_layout(smem, n0);
  const int w = blockIdx.x;
  const int a = threadIdx.x;
  const int tc = compute_threads(n0);
  const bool producer = static_cast<int>(blockDim.x) > tc;  // a producer warp queues the zeros
  uint32_t* ab_w = reinterpret_cast<uint32_t*>(ab + static_cast<size_t>(w) * K * 2);
  uint32_t* nrm_w = reinterpret_cast<uint32_t*>(nrm + static_cast<size_t>(w) * K * 3);

  // 0. the slot spans' zeros, queued on the copy engine: by the producer
  // warp, which then waits for them to be written and leaves, or (no room
  // for one) by the compute threads before their loads.
  if (a >= tc) {
    const int lane = a - tc;
    for (int i = lane; i < kZeroBytes / 16; i += 32) s.zero[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_shared_for_bulk();
    __syncwarp();
    zero_span(ab_w, 2 * K, s.zero, lane);
    zero_span(nrm_w, 3 * K, s.zero, lane);
    if (lane == 0) {
      bulk_commit();
      bulk_wait();
    }
    __syncwarp();
    cta_sync();  // the compute threads write the slots after this
    return;
  }
  const bool live = a < n0;
  const int nc = chunks(n0);
  const size_t body = static_cast<size_t>(w) * n0 + a;
  SJ_PHASE_START

  // this body's inputs, loaded before the zeros take the memory system
  float4 q = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (live) {
    q = rot[body];
    gx = pos[body * 3];
    gy = pos[body * 3 + 1];
    gz = pos[body * 3 + 2];
  }
  if (!producer) {
    for (int i = a; i < kZeroBytes / 16; i += tc) s.zero[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_shared_for_bulk();
    compute_sync(tc);
    zero_span(ab_w, 2 * K, s.zero, a);
    zero_span(nrm_w, 3 * K, s.zero, a);
    if (a == 0) bulk_commit();
  }
  SJ_PHASE(0);

  // 1. clamp and AABB, one thread a body; the bit grid's words cleared.
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f), l = p, h = p;
  if (live) {
    const float qw = q.x, qx = q.y, qy = q.z, qz = q.w;
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qw * qz);
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r10 = 2.0f * (qx * qy + qw * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r20 = 2.0f * (qx * qz - qw * qy);
    const float r21 = 2.0f * (qy * qz + qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float ex = fabsf(r00) + fabsf(r01) + fabsf(r02);
    const float ey = fabsf(r10) + fabsf(r11) + fabsf(r12);
    const float ez = fabsf(r20) + fabsf(r21) + fabsf(r22);
    p.x = fminf(fmaxf(gx, bounds.lo[0]), bounds.hi[0]);
    p.y = fminf(fmaxf(gy, bounds.lo[1]), bounds.hi[1]);
    p.z = fminf(fmaxf(gz, bounds.lo[2]), bounds.hi[2]);
    l = make_float4(p.x - ex, p.y - ey, p.z - ez, 0.0f);
    h = make_float4(p.x + ex, p.y + ey, p.z + ez, 0.0f);
    s.lo[a] = l;
    s.hi[a] = h;
    s.pos[a] = p;
  }
  for (int t = a; t < nc * s.np; t += tc) s.bits[t] = 0ull;
  SJ_PHASE(1);

  // 2. the world's mean; the half boxes about it.
  const float3 sum = block_sum3(p.x, p.y, p.z, s.red, tc);  // syncs
  const float fn = static_cast<float>(n0);
  const float3 mean = make_float3(sum.x / fn, sum.y / fn, sum.z / fn);
  if (a < s.np) s.hb[a] = live ? half_box(l, h, finite_ref(mean)) : nan_half_box();
  compute_sync(tc);
  SJ_PHASE(2);

  // 3. the candidate bits.
  overlap_bits(s, n0, tc);
  compute_sync(tc);
  SJ_PHASE(3);

  // 4. row a's exact overlaps in ascending b: its words, degree and push
  // (in the push tree's order).
  int deg = 0;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (live) {
    const float xa = p.x - mean.x, ya = p.y - mean.y, za = p.z - mean.z;
    PushTree<kMaxT == kMaxThreads ? kTreeLevels : kSmallTreeLevels> tree;
    tree.clear();
    for (int k = 0; k < nc; ++k) {
      u64 word = s.bits[k * s.np + a];
      if (k == a / kChunk) word &= ~(1ull << (a % kChunk));
      u64 exact = word;
      float cx = 0.0f, cy = 0.0f, cz = 0.0f;
      while (word != 0ull) {
        const int bit = __ffsll(static_cast<long long>(word)) - 1;
        const int b = kChunk * k + bit;
        word &= word - 1ull;
        if (!overlap(l, h, s.lo[b], s.hi[b])) {
          exact &= ~(1ull << bit);
          continue;
        }
        const float4 pb = s.pos[b];
        const float dx = (pb.x - mean.x) - xa;
        const float dy = (pb.y - mean.y) - ya;
        const float dz = (pb.z - mean.z) - za;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 1e-12f) {
          const float m = rsqrtf(fmaxf(d2, 1e-30f));
          cx += m * dx;
          cy += m * dy;
          cz += m * dz;
        }
      }
      tree.push(make_float3(cx, cy, cz), k);
      s.bits[k * s.np + a] = exact;
      deg += __popcll(exact);
    }
    const float3 t = tree.total(nc);
    ax = t.x;
    ay = t.y;
    az = t.z;
  }
  SJ_PHASE(4);

  // 5. base = the exclusive prefix of the capped degrees; total; dropped.
  const int degc = min(deg, D);
  const Scan sc = block_scan(degc, deg - degc, s.isum, tc);  // syncs
  const int nlive = min(sc.total, K);
  SJ_PHASE(5);

  // 6. the translation staged where the half boxes were (no longer read
  // after the scan's barrier); the counters; lo, hi and the translation
  // out; then, once the zeros are written, the slots, kStage at a time:
  // row a's first partners at base + r.
  float4* s_tr = reinterpret_cast<float4*>(s.hb);
  if (live) s_tr[a] = make_float4(p.x + -2.0f * ax, p.y + -2.0f * ay, p.z + -2.0f * az, 0.0f);
  if (a == 0) {
    counts[w] = sc.total;
    dropped[w] = sc.dropped;
    if (zeros != nullptr) zeros[w] = 0;
  }
  const int row_end = live ? min(sc.base + degc, nlive) : 0;
  for (int s0 = 0; s0 == 0 || s0 < nlive; s0 += kStage) {
    const int s1 = min(s0 + kStage, nlive);
    if (s0 > 0) compute_sync(tc);  // the previous chunk has left the stage
    if (live && sc.base < s1 && row_end > s0) {
      int k = sc.base;
      for (int c = 0; c < nc && k < min(row_end, s1); ++c) {
        u64 word = s.bits[c * s.np + a];
        while (word != 0ull && k < min(row_end, s1)) {
          const int b = kChunk * c + __ffsll(static_cast<long long>(word)) - 1;
          word &= word - 1ull;
          if (k >= s0) {
            const int e = k - s0;
            const float4 pb = s.pos[b];
            const float dx = pb.x - p.x;
            const float dy = pb.y - p.y;
            const float dz = pb.z - p.z;
            const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
            s.st_ab[2 * e] = a;
            s.st_ab[2 * e + 1] = b;
            s.st_nrm[3 * e] = dx * inv;
            s.st_nrm[3 * e + 1] = dy * inv;
            s.st_nrm[3 * e + 2] = dz * inv;
          }
          ++k;
        }
      }
    }
    compute_sync(tc);
    if (s0 == 0) {
      const size_t row3 = static_cast<size_t>(w) * n0 * 3;
      put_rows3(lo + row3, 0, 3 * n0, s.lo, a, tc);
      put_rows3(hi + row3, 0, 3 * n0, s.hi, a, tc);
      put_rows3(translation + row3, 0, 3 * n0, s_tr, a, tc);
      if (!producer && a == 0) bulk_wait();
      cta_sync();  // the zeros are written before the slots
    }
    put_words(ab_w, 2 * s0, 2 * s1, [&](int i) {
      return static_cast<uint32_t>(s.st_ab[i - 2 * s0]);
    }, a, tc);
    put_words(nrm_w, 3 * s0, 3 * s1, [&](int i) {
      return __float_as_uint(s.st_nrm[i - 3 * s0]);
    }, a, tc);
  }
  SJ_PHASE(6);
}

// The rounds layout's step A for the block of chunks [cb, cb + nb) (rows
// r0 = 64 cb on): the exact overlap words, each unordered chunk pair (ci,
// cj), ci in the block and cj >= ci, tested once, in units u = (16 rows of
// ci, cj) a warp, round-robin over the warps.  Lane j holds chunk cj's rows
// j and j + 32 (lo and hi in registers; pad rows NaN, which overlap
// nothing); for each row i0 + k of the unit, row i0 + k's lo and hi are
// broadcast, the plain version's overlap_grid test (closed slabs, float32;
// it is symmetric) runs on both candidates, and two ballots give row i0 +
// k's word cj, which lane k keeps and stores without its own bit; lane j
// keeps bit k of rows j's and j + 32's word ci, a 16-bit quarter of it,
// which it stores off the diagonal: into the block's words where cj is in
// the block, else into the lower triangle lo [nc][np] for cj's block to
// read.  Every quarter and word has one writer (no atomics).
__device__ void round_words(u64* __restrict__ words, u64* __restrict__ lower,
                            const float4* s_lo, const float4* s_hi, int cb, int nb, int nc,
                            int np, int ncp) {
  const int lane = threadIdx.x & 31;
  const int parts = kChunk / kUnit;
  int units = 0;
  for (int t = 0; t < nb; ++t) units += parts * (nc - cb - t);
  const int r0 = kChunk * cb;
  for (int u = threadIdx.x >> 5; u < units; u += kRoundThreads / 32) {
    int q = u / parts, ci = cb;
    while (q >= nc - ci) {
      q -= nc - ci;
      ++ci;
    }
    const int cj = ci + q, part = u % parts;
    const int i0 = kChunk * ci + kUnit * part;
    const int j = kChunk * cj + lane;
    const float4 l0 = s_lo[j], h0 = s_hi[j], l1 = s_lo[j + 32], h1 = s_hi[j + 32];
    u64 mine = 0ull;
    uint32_t c0 = 0u, c1 = 0u;
#pragma unroll
    for (int k = 0; k < kUnit; ++k) {
      const float4 li = s_lo[i0 + k], hi = s_hi[i0 + k];
      const bool p0 = overlap(li, hi, l0, h0), p1 = overlap(li, hi, l1, h1);
      const u64 word = static_cast<u64>(__ballot_sync(kFull, p0)) |
                       (static_cast<u64>(__ballot_sync(kFull, p1)) << 32);
      if (lane == k) mine = word;
      c0 |= static_cast<uint32_t>(p0) << k;
      c1 |= static_cast<uint32_t>(p1) << k;
    }
    const int i = i0 + lane;
    if (cj == ci) mine &= ~(1ull << (i % kChunk));
    if (lane < kUnit) words[static_cast<size_t>(i - r0) * ncp + cj] = mine;
    if (cj != ci) {
      uint16_t* q0 = cj < cb + nb
                         ? reinterpret_cast<uint16_t*>(words + static_cast<size_t>(j - r0) * ncp + ci)
                         : reinterpret_cast<uint16_t*>(lower + static_cast<size_t>(ci) * np + j);
      uint16_t* q1 = cj < cb + nb
                         ? reinterpret_cast<uint16_t*>(words + static_cast<size_t>(j + 32 - r0) * ncp + ci)
                         : reinterpret_cast<uint16_t*>(lower + static_cast<size_t>(ci) * np + j + 32);
      q0[part] = static_cast<uint16_t>(c0);
      q1[part] = static_cast<uint16_t>(c1);
    }
  }
}

// The rounds layout's step B for row a, one warp: lane l walks the exact
// words of chunk l (nc <= 32) or of chunks 2l and 2l + 1 of each block of 64
// chunks in ascending b and adds the pushes one after another into its
// chunk's partial; a lane's two chunks are added left + right, then the
// lanes' partials by a shuffle butterfly (xor 1, 2, 4, 8, 16: each level
// adds the same two values in either order, so every lane ends with the
// same bits), each full block of 64 chunks into top in block order.  That
// is PushTree<kRoundTreeLevels>'s order, zero chunks padding the last
// block (x + 0 is x).  A shuffle scan of the words' popcounts gives each
// chunk's first rank, and the walk puts the partners of ranks below
// min(cnt, 32), the row's first slots, into the warp's stage st_b (step D
// takes them from there).  Returns the push sum.
__device__ float3 round_push(const u64* __restrict__ wrow, const float4* s_pc, int a, int nc,
                             int cnt, int* st_b) {
  static_assert(kChunk == 64 && (1 << kRoundTreeLevels) == kChunk,
                "a block of the butterfly is 64 chunks, two a lane");
  const int lane = threadIdx.x & 31;
  const float4 pa = s_pc[a];
  const bool pair = nc > 32;
  const int staged = min(cnt, 32);
  float3 top = make_float3(0.0f, 0.0f, 0.0f), last = top;
  int done = 0;   // the ranks of the blocks before
  for (int c0 = 0; c0 < nc; c0 += kChunk) {
    const int ca = pair ? c0 + 2 * lane : lane;
    const u64 w0 = ca < nc ? wrow[ca] : 0ull;
    const u64 w1 = pair && ca + 1 < nc ? wrow[ca + 1] : 0ull;
    const int n0 = __popcll(w0), n = n0 + __popcll(w1);
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    for (int h = 0; h < (pair ? 2 : 1); ++h) {
      u64 word = h == 0 ? w0 : w1;
      int q = done + incl - n + (h == 0 ? 0 : n0);   // the rank of word's first partner
      float hx = 0.0f, hy = 0.0f, hz = 0.0f;
      while (word != 0ull) {
        const int b = kChunk * (ca + h) + __ffsll(static_cast<long long>(word)) - 1;
        word &= word - 1ull;
        if (q < staged) st_b[q] = b;
        ++q;
        const float4 pb = s_pc[b];
        const float dx = pb.x - pa.x;
        const float dy = pb.y - pa.y;
        const float dz = pb.z - pa.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 1e-12f) {
          const float m = rsqrtf(fmaxf(d2, 1e-30f));
          hx += m * dx;
          hy += m * dy;
          hz += m * dz;
        }
      }
      if (h == 0) {
        cx = hx;
        cy = hy;
        cz = hz;
      } else {
        cx = cx + hx;
        cy = cy + hy;
        cz = cz + hz;
      }
    }
    done += __shfl_sync(kFull, incl, 31);
    for (int o = 1; o < 32; o <<= 1) {
      cx += __shfl_xor_sync(kFull, cx, o);
      cy += __shfl_xor_sync(kFull, cy, o);
      cz += __shfl_xor_sync(kFull, cz, o);
    }
    if (c0 + kChunk <= nc)
      top = make_float3(top.x + cx, top.y + cy, top.z + cz);
    else
      last = make_float3(cx, cy, cz);
  }
  return nc >= kChunk ? make_float3(top.x + last.x, top.y + last.y, top.z + last.z) : last;
}

// The rounds layout's step D for row a, one warp: slots base + q0 .. base +
// q0 + m - 1 from the partners of ranks q0 .. q0 + m - 1 in the warp's
// stage st_b (m <= 32): lane k makes the k-th normal, stores its ab as one
// int2 (a warp's int2s contiguous), and the normals leave the stage st_n as
// consecutive floats.
__device__ void round_emit(const float4* s_lo, const float4* s_hi, const float4* s_pc, int a,
                           int base, int q0, int m, int2* __restrict__ ab2,
                           float* __restrict__ nrm_s, const int* st_b, float* st_n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < m) {
    const float4 la = s_lo[a], ha = s_hi[a], pa = s_pc[a];   // w: the clamped position
    const int b = st_b[lane];
    const float4 lb = s_lo[b], hb = s_hi[b], cb = s_pc[b];
    const float dx = lb.w - la.w;
    const float dy = hb.w - ha.w;
    const float dz = cb.w - pa.w;
    const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
    ab2[base + q0 + lane] = make_int2(a, b);
    st_n[3 * lane] = dx * inv;
    st_n[3 * lane + 1] = dy * inv;
    st_n[3 * lane + 2] = dz * inv;
  }
  __syncwarp();
  float* out = nrm_s + 3 * static_cast<size_t>(base + q0);
  for (int f = lane; f < 3 * m; f += 32) out[f] = st_n[f];
  __syncwarp();
}

// Step D past a row's first 32 slots (a cap D above 32): the ranks from 32
// to cnt in windows of 32, each window's partners found again from the
// exact words (lane l a chunk of 32 at a time, a shuffle scan of their
// popcounts) and put into the stage, then round_emit.
__device__ void round_slots_past(const u64* __restrict__ wrow, const float4* s_lo,
                                 const float4* s_hi, const float4* s_pc, int a, int nc, int base,
                                 int cnt, int2* __restrict__ ab2, float* __restrict__ nrm_s,
                                 int* st_b, float* st_n) {
  const int lane = threadIdx.x & 31;
  int done = 0;
  for (int g = 0; g < nc && done < cnt; g += 32) {
    const u64 word = g + lane < nc ? wrow[g + lane] : 0ull;
    const int n = __popcll(word);
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int first = done + incl - n;   // this lane's first rank
    const int end = min(done + __shfl_sync(kFull, incl, 31), cnt);
    for (int q0 = max(done, 32); q0 < end; q0 += 32) {
      const int q1 = min(q0 + 32, end);
      u64 w = word;
      int q = first;
      for (; w != 0ull && q < q0; ++q) w &= w - 1ull;
      for (; w != 0ull && q < q1; ++q) {
        st_b[q - q0] = kChunk * (g + lane) + __ffsll(static_cast<long long>(w)) - 1;
        w &= w - 1ull;
      }
      round_emit(s_lo, s_hi, s_pc, a, base, q0, q1 - q0, ab2, nrm_s, st_b, st_n);
    }
    done = end;
  }
}

// The rounds layout (see the notes at the top): 1024 threads, every warp
// computing.  scratch: the global scratch, rounds_scratch_bytes(n0) a world
// (unused where it is 0).
__global__ void __launch_bounds__(kRoundThreads, 1)
fused_simple_jobs_rounds_kernel(const float* __restrict__ pos,
                                const float4* __restrict__ rot, int n0, int K, int D,
                                Bounds bounds, float* __restrict__ translation,
                                float* __restrict__ lo, float* __restrict__ hi,
                                int* __restrict__ ab, float* __restrict__ nrm,
                                int* __restrict__ counts, int* __restrict__ dropped,
                                int* __restrict__ zeros, unsigned char* __restrict__ scratch) {
  extern __shared__ float4 smem[];
  const int w = blockIdx.x;
  const int a = threadIdx.x;
  const int tc = kRoundThreads;
  const int lane = a & 31, warp = a >> 5;
  const int nc = chunks(n0);
  const int np = kChunk * nc;
  const int ncp = round_ncp(n0);
  const int R = rounds_block_rows(n0);
  const bool shared_rows = rounds_rows_shared(n0);
  unsigned char* g = scratch + static_cast<size_t>(w) * rounds_scratch_bytes(n0);
  u64* lower = reinterpret_cast<u64*>(g);   // [nc][np]
  g += 8 * static_cast<size_t>(nc) * np;
  float4* rows = shared_rows ? smem : reinterpret_cast<float4*>(g);
  float4* s_lo = rows;           // lo xyz, the clamped position's x
  float4* s_hi = s_lo + np;      // hi xyz, the clamped position's y
  float4* s_pc = s_hi + np;      // the position less the world's mean xyz, the clamped z
  unsigned char* after = reinterpret_cast<unsigned char*>(shared_rows ? smem + 3 * np : smem);
  u64* words = reinterpret_cast<u64*>(rounds_words_shared(n0)
                                          ? after
                                          : g + (shared_rows ? 0 : 16 * 3 * static_cast<size_t>(np)));
  float* stage = reinterpret_cast<float*>(after + (rounds_words_shared(n0)
                                                       ? 8 * static_cast<size_t>(R) * ncp : 0));
  int* s_deg = reinterpret_cast<int*>(stage + (kRoundThreads / 32) * 4 * 32);
  int* s_base = s_deg + kBlockRows;
  float* red = reinterpret_cast<float*>(s_base + kBlockRows);
  int* isum = reinterpret_cast<int*>(red + 32 * 3);
  SJ_PHASE_START

  // 1. clamp and AABB, a row at a time; each thread's position sum, over
  // rows a + kMeanThreads k (the last warp's threads take none), so that
  // the world's mean is summed in the order the layout took before.
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int r = a; a < kMeanThreads && r < n0; r += kMeanThreads) {
    const size_t body = static_cast<size_t>(w) * n0 + r;
    const float4 q = rot[body];
    const float gx = pos[body * 3], gy = pos[body * 3 + 1], gz = pos[body * 3 + 2];
    const float qw = q.x, qx = q.y, qy = q.z, qz = q.w;
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qw * qz);
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r10 = 2.0f * (qx * qy + qw * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r20 = 2.0f * (qx * qz - qw * qy);
    const float r21 = 2.0f * (qy * qz + qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float ex = fabsf(r00) + fabsf(r01) + fabsf(r02);
    const float ey = fabsf(r10) + fabsf(r11) + fabsf(r12);
    const float ez = fabsf(r20) + fabsf(r21) + fabsf(r22);
    const float px = fminf(fmaxf(gx, bounds.lo[0]), bounds.hi[0]);
    const float py = fminf(fmaxf(gy, bounds.lo[1]), bounds.hi[1]);
    const float pz = fminf(fmaxf(gz, bounds.lo[2]), bounds.hi[2]);
    s_lo[r] = make_float4(px - ex, py - ey, pz - ez, px);
    s_hi[r] = make_float4(px + ex, py + ey, pz + ez, py);
    s_pc[r] = make_float4(0.0f, 0.0f, 0.0f, pz);
    sx += px;
    sy += py;
    sz += pz;
  }
  SJ_PHASE(1);

  // 2. the world's mean; the centred positions; pad rows' boxes NaN, which
  // overlap nothing; lo and hi out.
  const float3 sum = block_sum3(sx, sy, sz, red, tc);  // syncs
  const float fn = static_cast<float>(n0);
  const float3 mean = make_float3(sum.x / fn, sum.y / fn, sum.z / fn);
  for (int r = a; r < np; r += tc) {
    if (r < n0) {
      const float4 l = s_lo[r], h = s_hi[r];
      s_pc[r] = make_float4(l.w - mean.x, h.w - mean.y, s_pc[r].w - mean.z, s_pc[r].w);
    } else {
      const float q = __int_as_float(0x7fffffff);
      s_lo[r] = s_hi[r] = make_float4(q, q, q, q);
    }
  }
  compute_sync(tc);
  const size_t row3 = static_cast<size_t>(w) * n0 * 3;
  put_rows3(lo + row3, 0, 3 * n0, s_lo, a, tc);
  put_rows3(hi + row3, 0, 3 * n0, s_hi, a, tc);
  SJ_PHASE(2);

  // Steps A-D a block of R rows (whole chunks) at a time, in row order: A
  // the block's words (those below its chunks from the lower triangle); B
  // each row's degree and push (the translation out); C the capped
  // degrees' exclusive prefix, carried from block to block (warp 0); D each
  // row's slots.
  int2* ab2 = reinterpret_cast<int2*>(ab) + static_cast<size_t>(w) * K;
  float* nrm_s = nrm + static_cast<size_t>(w) * K * 3;
  int* st_b = reinterpret_cast<int*>(stage + warp * 4 * 32);   // this warp's slot stage
  float* st_n = stage + warp * 4 * 32 + 32;
  int run = 0, drop = 0;   // warp 0's: the slots and drops of the blocks so far
  for (int r0 = 0; r0 < n0; r0 += R) {
    const int rows_here = min(R, n0 - r0);
    const int cb = r0 / kChunk, nb = (rows_here + kChunk - 1) / kChunk;
    for (int t = a; t < cb * kChunk * nb; t += tc) {
      const int c = t / (kChunk * nb), r = t % (kChunk * nb);
      words[static_cast<size_t>(r) * ncp + c] = lower[static_cast<size_t>(c) * np + r0 + r];
    }
    round_words(words, lower, s_lo, s_hi, cb, nb, nc, np, ncp);
    compute_sync(tc);
    for (int r = r0 + warp; r < r0 + rows_here; r += tc / 32) {
      const u64* wrow = words + static_cast<size_t>(r - r0) * ncp;
      int n = 0;
      for (int c = lane; c < nc; c += 32) n += __popcll(wrow[c]);
      n = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(n)));
      if (lane == 0) s_deg[r - r0] = n;
    }
    compute_sync(tc);
    SJ_PHASE(3);

    if (warp == 0) {
      constexpr int per = kBlockRows / 32;
      int v = 0, d = 0;
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int i = per * lane + k;
        const int deg = i < rows_here ? s_deg[i] : 0;
        v += min(deg, D);
        d += deg - min(deg, D);
      }
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      int at = run + x - v;
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int i = per * lane + k;
        if (i < rows_here) {
          s_base[i] = at;
          at += min(s_deg[i], D);
        }
      }
      run += __shfl_sync(kFull, x, 31);
      drop += static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(d)));
    }
    compute_sync(tc);
    SJ_PHASE(5);

    for (int r = r0 + warp; r < r0 + rows_here; r += tc / 32) {
      const u64* wrow = words + static_cast<size_t>(r - r0) * ncp;
      const int base = s_base[r - r0];
      const int cnt = min(base + min(s_deg[r - r0], D), K) - base;
      const float3 t = round_push(wrow, s_pc, r, nc, cnt, st_b);
      if (lane < 3) {
        const float4 pr = lane == 0 ? s_lo[r] : (lane == 1 ? s_hi[r] : s_pc[r]);
        const float tl = lane == 0 ? t.x : (lane == 1 ? t.y : t.z);
        translation[(static_cast<size_t>(w) * n0 + r) * 3 + lane] = pr.w + -2.0f * tl;
      }
      if (cnt > 0) round_emit(s_lo, s_hi, s_pc, r, base, 0, min(cnt, 32), ab2, nrm_s, st_b, st_n);
      if (cnt > 32)
        round_slots_past(wrow, s_lo, s_hi, s_pc, r, nc, base, cnt, ab2, nrm_s, st_b, st_n);
    }
    compute_sync(tc);  // the next block's words overwrite this one's
    SJ_PHASE(4);
  }

  // the counters, then the slot spans' tail past min(total, K) as zeros
  if (a == 0) {
    counts[w] = run;
    dropped[w] = drop;
    if (zeros != nullptr) zeros[w] = 0;
    isum[0] = run;
  }
  compute_sync(tc);
  const int nlive = min(isum[0], K);
  uint32_t* ab_w = reinterpret_cast<uint32_t*>(ab2);
  uint32_t* nrm_w = reinterpret_cast<uint32_t*>(nrm_s);
  put_words(ab_w, 2 * nlive, 2 * K, [](int) { return 0u; }, a, tc);
  put_words(nrm_w, 3 * nlive, 3 * K, [](int) { return 0u; }, a, tc);
  SJ_PHASE(6);
}

// The instantiation a launch at n0 bodies takes: the small one where the
// compute threads are kMinThreads.
typedef void (*KernelFn)(const float*, const float4*, int, int, int, Bounds, float*, float*,
                         float*, int*, float*, int*, int*, int*);

KernelFn kernel_for(int n0) {
  if (compute_threads(n0) == kMinThreads)
    return fused_simple_jobs_step_kernel<kMinThreads + 32, kSmallCtas>;
  return fused_simple_jobs_step_kernel<kMaxThreads, 1>;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// zeros may be null: the node's zero counters are then not written.
// scratch: past kMaxBodies bodies (the rounds layout), where
// rounds_scratch_bytes(n0) > 0, W times that many bytes (scratch_bytes in
// ops/simple_jobs_kernel.py), 16-byte aligned; else unused.
extern "C" int fused_simple_jobs_step_launch(
    const void* pos, const void* rot, int W, int n0, int K, int D,
    float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
    void* translation, void* lo, void* hi, void* ab, void* nrm, void* counts,
    void* dropped, void* zeros, void* scratch, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n0 <= 0 || K <= 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Bounds bounds = {{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n0 > kMaxBodies) {
    if (rounds_scratch_bytes(n0) > 0 &&
        (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = rounds_smem_bytes(n0);
    const cudaError_t err = allow_smem(fused_simple_jobs_rounds_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_simple_jobs_rounds_kernel<<<W, kRoundThreads, smem, st>>>(
        static_cast<const float*>(pos), static_cast<const float4*>(rot), n0, K, D, bounds,
        static_cast<float*>(translation), static_cast<float*>(lo), static_cast<float*>(hi),
        static_cast<int*>(ab), static_cast<float*>(nrm), static_cast<int*>(counts),
        static_cast<int*>(dropped), static_cast<int*>(zeros),
        static_cast<unsigned char*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes(n0);
  const KernelFn kernel = kernel_for(n0);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<W, block_threads(n0), smem, st>>>(
      static_cast<const float*>(pos), static_cast<const float4*>(rot), n0, K, D,
      bounds, static_cast<float*>(translation), static_cast<float*>(lo),
      static_cast<float*>(hi), static_cast<int*>(ab), static_cast<float*>(nrm),
      static_cast<int*>(counts), static_cast<int*>(dropped), static_cast<int*>(zeros));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape at n0 bodies: threads a CTA, dynamic shared bytes and
// CTAs an SM (the occupancy API).
extern "C" int simple_jobs_occupancy(int n0, int* threads, int* smem, int* ctas) {
  if (n0 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n0 > kMaxBodies) {
    const size_t bytes = rounds_smem_bytes(n0);
    *threads = kRoundThreads;
    *smem = static_cast<int>(bytes);
    cudaError_t err = allow_smem(fused_simple_jobs_rounds_kernel, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_simple_jobs_rounds_kernel,
                                                          *threads, bytes);
    return static_cast<int>(err);
  }
  const size_t bytes = smem_bytes(n0);
  const KernelFn kernel = kernel_for(n0);
  *threads = block_threads(n0);
  *smem = static_cast<int>(bytes);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, *threads, bytes);
  return static_cast<int>(err);
}
