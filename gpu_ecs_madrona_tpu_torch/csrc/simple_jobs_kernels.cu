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
// bodies, where a thread a row slot and the np^2 / 8 bytes of the bit grid
// no longer fit one CTA (2048 bodies: 512 KB of words): 992 compute threads
// and the producer warp.  The compute threads take the row slots in rounds
// (row r = a + k 992, ascending within a round as above), each row's state
// in memory between the steps: lo, hi, position and half box (16 bytes a
// row each) in shared memory while they fit (n0 <= 3584), else in the
// world's slice of a global scratch that the wrapper allocates (from
// PyTorch's caching allocator: no device allocation once warm); the bit
// grid's words always there.  Step 3 gives a warp a whole
// 64 x 64 chunk pair: its ballots build the 64 row words of chunk ci and
// the predicates kept by lane j the 64 transposed words of chunk cj, each
// stored whole by one lane (every word of the grid has one writer, so the
// scratch needs no clearing and no atomics).  Step 4 keeps a row's degree
// in the w of its staged translation and step 5 its base in the w of its
// hi; step 5 scans a round at a time (a warp scan, the warps' totals, then
// the rounds' totals in round order); step 6 writes each row's slots from
// its own thread in one pass (no stage: with the words in global memory, a
// stage of kStage slots spent ~80% of a CTA's cycles waiting on them,
// once a chunk, in PERF.md).  The arithmetic, the orders and so
// the outputs are those of the one-block layout; only the world's mean is
// summed in another order (each thread's rows first).  At 1024 worlds x
// 2048 bodies, K = 32768: ~805 MB of bytes (0.24 ms at 3.35 TB/s) against
// the half-box filter's W n0 (n0 - 1) / 2 ~ 2.15G unordered pair tests of
// ~6 operations and, at main_simple_jobs_large's state, ~482M overlapping
// ordered pairs of ~20 (0.3373 ms at 67 TFLOP/s): the pair tests bound it.
//
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain version (ops/simple_jobs_kernel.py), so the
// clamped positions and the AABBs come out bit-identical and so do the
// overlap decisions and every integer output.  The push sums a row's
// partners in a fixed tree (PushTree): each chunk's partners in ascending
// b into the chunk's partial, then the chunks' partials pairwise in chunk
// order, on the kernel's own mean.  A row of a dense stepped world sums
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
// SJ_SYNC() (the compute threads' barrier) before each reading.
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
constexpr int kRoundThreads = 992; // the rounds layout's compute threads (a producer warp beside)
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

// The rounds layout (n0 > kMaxBodies).  Whether a world's rows (lo, hi,
// position and half box, 16 bytes a row slot each) stay in shared memory;
// its dynamic shared memory: those rows where they stay, the zeros and the
// warps' sums; and the bytes of a world's slice of the
// global scratch: the bit grid's words u64 [np / kChunk][np], then the rows
// where they do not stay.
__host__ __device__ inline bool rounds_rows_shared(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = 4 * np;
  const size_t rest = kZeroBytes + 4 * (32 * 3 + 32 * 2);
  return 16 * rows + rest <= kMaxSmem;
}

size_t rounds_smem_bytes(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t rows = rounds_rows_shared(n0) ? 4 * np : 0;
  const size_t sums = 32 * 3 + 32 * 2;
  return 16 * rows + kZeroBytes + 4 * sums;
}

__host__ __device__ inline size_t rounds_scratch_bytes(int n0) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n0));
  const size_t words = np / kChunk * np;
  const size_t rows = rounds_rows_shared(n0) ? 0 : 4 * np;
  return 8 * words + 16 * rows;
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

// The rounds layout's step 3: the candidate bits of whole 64 x 64 chunk
// pairs (ci <= cj, row-major), a pair a warp, round-robin over the
// compute warps.  Lane j holds rows j and j + 32 of chunk cj; for each row
// i0 + k of chunk ci two ballots give its word cj, which lane k (or k - 32)
// keeps, and lane j keeps bit k of rows j's and j + 32's word ci; then each
// lane stores its two row words and, off the diagonal, its two transposed
// words whole.  Every word of [nc][np] is stored once, by one lane.
__device__ void overlap_bits_rounds(u64* __restrict__ bits, const HalfBox* hb, int np, int nc,
                                    int tc) {
  const int lane = threadIdx.x & 31;
  const int warps = tc >> 5;
  const int units = nc * (nc + 1) / 2;
  for (int u = threadIdx.x >> 5; u < units; u += warps) {
    int b = u, ci = 0, row = nc;
    while (b >= row) {
      b -= row;
      ++ci;
      --row;
    }
    const int cj = ci + b;
    const int i0 = kChunk * ci;
    const int j = kChunk * cj + lane;
    const HalfBox j0 = hb[j], j1 = hb[j + 32];
    u64 r0 = 0ull, r1 = 0ull, c0 = 0ull, c1 = 0ull;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const HalfBox bi = hb[i0 + k];
      const bool p0 = half_overlap(bi, j0), p1 = half_overlap(bi, j1);
      const u64 word = static_cast<u64>(__ballot_sync(kFull, p0)) |
                       (static_cast<u64>(__ballot_sync(kFull, p1)) << 32);
      if (k < 32) {
        if (lane == k) r0 = word;
      } else if (lane == k - 32) {
        r1 = word;
      }
      c0 |= static_cast<u64>(p0) << k;
      c1 |= static_cast<u64>(p1) << k;
    }
    bits[static_cast<size_t>(cj) * np + i0 + lane] = r0;
    bits[static_cast<size_t>(cj) * np + i0 + 32 + lane] = r1;
    if (ci != cj) {
      bits[static_cast<size_t>(ci) * np + j] = c0;
      bits[static_cast<size_t>(ci) * np + j + 32] = c1;
    }
  }
}

// The rounds layout (see the notes at the top): 1024 threads, the last warp
// the producer.  scratch: the global scratch, rounds_scratch_bytes(n0) a
// world.
__global__ void __launch_bounds__(kMaxThreads, 1)
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
  const int nc = chunks(n0);
  const int np = kChunk * nc;
  const bool shared_rows = rounds_rows_shared(n0);
  unsigned char* g = scratch + static_cast<size_t>(w) * rounds_scratch_bytes(n0);
  u64* bits = reinterpret_cast<u64*>(g);
  float4* rows = shared_rows ? smem
                             : reinterpret_cast<float4*>(g + 8 * static_cast<size_t>(nc) * np);
  float4* s_lo = rows;
  float4* s_hi = s_lo + np;
  float4* s_pos = s_hi + np;
  HalfBox* s_hb = reinterpret_cast<HalfBox*>(s_pos + np);
  float4* s_tr = reinterpret_cast<float4*>(s_hb);  // the translation and degree, after step 3
  uint4* s_zero = reinterpret_cast<uint4*>(shared_rows ? smem + 4 * np : smem);
  float* red = reinterpret_cast<float*>(s_zero + kZeroBytes / 16);
  int* isum = reinterpret_cast<int*>(red + 32 * 3);
  uint32_t* ab_w = reinterpret_cast<uint32_t*>(ab + static_cast<size_t>(w) * K * 2);
  uint32_t* nrm_w = reinterpret_cast<uint32_t*>(nrm + static_cast<size_t>(w) * K * 3);

  // 0. the producer warp queues the slot spans' zeros and leaves.
  if (a >= tc) {
    const int lane = a - tc;
    for (int i = lane; i < kZeroBytes / 16; i += 32) s_zero[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_shared_for_bulk();
    __syncwarp();
    zero_span(ab_w, 2 * K, s_zero, lane);
    zero_span(nrm_w, 3 * K, s_zero, lane);
    if (lane == 0) {
      bulk_commit();
      bulk_wait();
    }
    __syncwarp();
    cta_sync();  // the compute threads write the slots after this
    return;
  }
  SJ_PHASE_START

  // 1. clamp and AABB, a row at a time; each thread's position sum.
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int r = a; r < n0; r += tc) {
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
    float4 p;
    p.x = fminf(fmaxf(gx, bounds.lo[0]), bounds.hi[0]);
    p.y = fminf(fmaxf(gy, bounds.lo[1]), bounds.hi[1]);
    p.z = fminf(fmaxf(gz, bounds.lo[2]), bounds.hi[2]);
    p.w = 0.0f;
    s_lo[r] = make_float4(p.x - ex, p.y - ey, p.z - ez, 0.0f);
    s_hi[r] = make_float4(p.x + ex, p.y + ey, p.z + ez, 0.0f);
    s_pos[r] = p;
    sx += p.x;
    sy += p.y;
    sz += p.z;
  }
  SJ_PHASE(1);

  // 2. the world's mean; the half boxes about it (a thread reads back only
  // the rows it wrote).
  const float3 sum = block_sum3(sx, sy, sz, red, tc);  // syncs
  const float fn = static_cast<float>(n0);
  const float3 mean = make_float3(sum.x / fn, sum.y / fn, sum.z / fn);
  const float3 ref = finite_ref(mean);
  for (int r = a; r < np; r += tc)
    s_hb[r] = r < n0 ? half_box(s_lo[r], s_hi[r], ref) : nan_half_box();
  compute_sync(tc);
  SJ_PHASE(2);

  // 3. the candidate bits.
  overlap_bits_rounds(bits, s_hb, np, nc, tc);
  compute_sync(tc);
  SJ_PHASE(3);

  // 4. each row's exact overlaps in ascending b: its words, degree and
  // push (in the push tree's order); the translation staged where the half
  // boxes were, the degree in its w.
  for (int r = a; r < n0; r += tc) {
    const float4 l = s_lo[r], h = s_hi[r], p = s_pos[r];
    const float xa = p.x - mean.x, ya = p.y - mean.y, za = p.z - mean.z;
    int deg = 0;
    PushTree<kRoundTreeLevels> tree;
    tree.clear();
    for (int k = 0; k < nc; ++k) {
      u64* at = bits + static_cast<size_t>(k) * np + r;
      u64 word = *at;
      if (k == r / kChunk) word &= ~(1ull << (r % kChunk));
      u64 exact = word;
      float ax = 0.0f, ay = 0.0f, az = 0.0f;
      while (word != 0ull) {
        const int bit = __ffsll(static_cast<long long>(word)) - 1;
        const int b = kChunk * k + bit;
        word &= word - 1ull;
        if (!overlap(l, h, s_lo[b], s_hi[b])) {
          exact &= ~(1ull << bit);
          continue;
        }
        const float4 pb = s_pos[b];
        const float dx = (pb.x - mean.x) - xa;
        const float dy = (pb.y - mean.y) - ya;
        const float dz = (pb.z - mean.z) - za;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 1e-12f) {
          const float m = rsqrtf(fmaxf(d2, 1e-30f));
          ax += m * dx;
          ay += m * dy;
          az += m * dz;
        }
      }
      tree.push(make_float3(ax, ay, az), k);
      *at = exact;
      deg += __popcll(exact);
    }
    const float3 t = tree.total(nc);
    s_tr[r] = make_float4(p.x + -2.0f * t.x, p.y + -2.0f * t.y, p.z + -2.0f * t.z,
                          __int_as_float(deg));
  }
  SJ_PHASE(4);

  // 5. base = the exclusive prefix of the capped degrees over the rows in
  // order, a round at a time, each row's kept in the w of its hi (no
  // thread reads a hi's w before step 6); total; dropped.
  int run = 0, drop = 0;
  for (int r0 = 0; r0 < np; r0 += tc) {
    const int r = r0 + a;
    const int deg = r < n0 ? __float_as_int(s_tr[r].w) : 0;
    const int degc = min(deg, D);
    const Scan sc = block_scan(degc, deg - degc, isum, tc);  // syncs
    if (r < n0) s_hi[r].w = __int_as_float(run + sc.base);
    run += sc.total;
    drop += sc.dropped;
    compute_sync(tc);  // the warps' totals are written again next round
  }
  const int nlive = min(run, K);
  SJ_PHASE(5);
  if (a == 0) {
    counts[w] = run;
    dropped[w] = drop;
    if (zeros != nullptr) zeros[w] = 0;
  }

  // 6. lo, hi and the translation out; then, once the zeros are written,
  // the slots in one pass: each row walks its exact words again and writes
  // its first partners at base + rank itself (a row's slots are
  // contiguous, and the rows' in row order), where a stage would wait on
  // a barrier and on the words' global loads once a chunk of slots.
  const size_t row3 = static_cast<size_t>(w) * n0 * 3;
  put_rows3(lo + row3, 0, 3 * n0, s_lo, a, tc);
  put_rows3(hi + row3, 0, 3 * n0, s_hi, a, tc);
  put_rows3(translation + row3, 0, 3 * n0, s_tr, a, tc);
  cta_sync();  // the zeros are written before the slots
  int2* ab2 = reinterpret_cast<int2*>(ab) + static_cast<size_t>(w) * K;
  float* nrm_s = nrm + static_cast<size_t>(w) * K * 3;
  for (int r = a; r < n0; r += tc) {
    const int base = __float_as_int(s_hi[r].w);
    const int row_end = min(base + min(__float_as_int(s_tr[r].w), D), nlive);
    const float4 p = s_pos[r];
    int k = base;
    for (int c = 0; c < nc && k < row_end; ++c) {
      u64 word = bits[static_cast<size_t>(c) * np + r];
      while (word != 0ull && k < row_end) {
        const int b = kChunk * c + __ffsll(static_cast<long long>(word)) - 1;
        word &= word - 1ull;
        const float4 pb = s_pos[b];
        const float dx = pb.x - p.x;
        const float dy = pb.y - p.y;
        const float dz = pb.z - p.z;
        const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
        ab2[k] = make_int2(r, b);
        nrm_s[3 * k] = dx * inv;
        nrm_s[3 * k + 1] = dy * inv;
        nrm_s[3 * k + 2] = dz * inv;
        ++k;
      }
    }
  }
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
// scratch: past kMaxBodies bodies (the rounds layout) W
// rounds_scratch_bytes(n0) bytes (scratch_bytes in ops/simple_jobs_kernel.py),
// 16-byte aligned; else unused.
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
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = rounds_smem_bytes(n0);
    const cudaError_t err = allow_smem(fused_simple_jobs_rounds_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_simple_jobs_rounds_kernel<<<W, kMaxThreads, smem, st>>>(
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
    *threads = kMaxThreads;
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
