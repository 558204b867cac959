// Collision kernels for Hopper (sm_90a): the collisions example's tick.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file
// (ctypes).  Every launch goes on the caller's stream, allocates nothing,
// and returns cudaGetLastError().
//
// Layout: the port's tensors as they are, row-major [W, n, 3] positions,
// [W, n, 4] w-first quaternions, [W, n] bool (one byte) masks.  Inside a
// CTA each row is staged as 16-byte float4s (lo, hi, position) and, on the
// grid path, a 16-byte half-precision box.
//
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain PyTorch versions (ops/collision_kernel.py),
// so the AABBs come out bit-identical to aabb_plain and the overlap
// decisions, always taken in float32, match the plain version's.  The push
// uses rsqrtf (the SFU's approximate reciprocal square root, about 2 ulp),
// not 1.0f / sqrtf.  Every sum runs in a fixed order and the only atomics
// are integer ORs, so a repeated launch is bit-identical.
//
// The grid path (fused_collisions_step_kernel, and collision_pushes_kernel
// for n <= 640): one CTA of 4 warps a world, in four steps.
//   1. One pass over the rows: each 32-row segment's live count (a
//      ballot) and the positions' sum, in a fixed order (the world's mean:
//      collision_pushes centres on it, as the plain version's
//      pos - pos.mean(dim=1); both kernels' half boxes are taken about it).
//   2. The live rows get consecutive indices in row order and only they
//      are staged, so a dead row costs its mask; rows past the live count,
//      up to a multiple of 64, get a NaN half box, which overlaps nothing.
//      A row's half box is its box about the mean in half precision,
//      rounded outward, so that three half2 compares stand for the six
//      float ones and never miss an overlap.
//   3. The candidate bits: word k of row c holds row c's half-box overlaps
//      with live rows 64k..64k+63 (u64, word-major [words][rows]).  The
//      test is symmetric, so each unordered pair of 64-row chunks
//      (ci <= cj) is tested once, in units of 16 rows i: a warp holds
//      chunk cj's 64 half boxes (two a lane) in registers and walks the
//      unit's rows i with i's half box broadcast from shared memory (one
//      LDS.128); per i two ballots give row i's word cj; the predicates,
//      kept by lane j, give row j's word ci (a shared atomicOr a box a
//      unit).  No row slot without a live row is walked.
//   4. One thread a row walks its row's set bits in ascending j (the order
//      of the plain version's pairs), tests each candidate in float32 and
//      adds the push of the overlapping ones: ~1 bit a row at the example's
//      density, not n.
//
// The tiled path (collision_pushes_kernel for n > 640 or a forced tile):
// one CTA of 8 warps for each (world, block of 32 rows i); lane l of every
// warp owns row i = 32 b + l, and warp w walks the w-th eighth of each
// tile of tile_j rows j staged in shared memory (the float test: 2 LDS.128
// and 6 predicated compares per 32 pairs).  The eight warps' partial sums
// are added in warp order in shared memory: no float atomics, no scratch,
// one launch.  At W = 16, n = 1500 that is 752 CTAs of 8 warps, where the
// parent launched 192 of 4.  A tiled CTA re-reads the world's positions
// for the mean (n x 12 B from L2).
//
// fused_collisions_step_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/collision_kernel.py:
//   fused_collisions_step (_kernel_fused_step).
//   Work: per world, n AABBs and the overlap test of every live pair; at
//   8192 worlds x 108 rows, 65 B a row of traffic (17 us at 3.35 TB/s)
//   against ~81M ordered live-pair tests of 6 compares (7 us at 67
//   TFLOP/s): by the card's peaks the bytes bound it.  What holds it is
//   issuing the pair tests: the parent walked every (row slot, row slot)
//   at ~20 warp instructions a pair; step 3 takes ~16 for 64 unordered
//   pairs, and is still about half of the kernel's time (PERF.md).
//   Writes lo and hi for every row, live or not, as the TPU kernel does.
//
// collision_pushes_kernel<kTiled>
//   Replaces gpu_ecs_madrona_tpu/ops/collision_kernel.py:
//   collision_pushes, both its single-block body (_kernel, the grid path
//   here) and its tiled one (_kernel_tiled, the tiled path), with the
//   centring that the JAX wrapper runs before its call.
//   Work: the same pair tests with the AABBs given, on centred positions;
//   49 B a row of traffic.  The grid path is bound like the fused kernel;
//   the tiled path at W = 16, n = 1500 by its operations (~35M ordered
//   pairs), and its time by the issue of their tests.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // the grid path: 4 warps a world
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;           // rows j a warp holds (two a lane), bits a word
constexpr int kUnit = 16;            // rows i of a grid unit (divides kChunk)
constexpr int kTiledThreads = 256;   // the tiled path: 8 warps a CTA
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kIBlock = 32;          // rows i of a tiled CTA (a lane each)
constexpr int kGridMaxRows = 640;    // fused_fits's bound: the grid path's n
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__host__ __device__ inline int chunks(int rows) { return (rows + kChunk - 1) / kChunk; }

// A box in half precision about a reference point, rounded outward (lo
// down, hi up), so that a pair that overlaps in float32 overlaps here too.
// Row i's side of a test reads l, h and zi = (lo.z, -hi.z); row j's l, h
// and zj = (hi.z, -lo.z): three half2 compares test the six float ones
// (lo_i <= hi_j and lo_j <= hi_i on x, y, z).
struct alignas(16) HalfBox {
  __half2 l, h, zi, zj;
};

// The grid path's shared memory for a world of n rows, np = kChunk
// chunks(n): lo, hi and position as float4 [np] each, the half boxes
// [np], the overlap bits u64 [np / kChunk][np], the live index of each
// row int [np], the live count of each 32-row segment int [np / 32], and
// the centring's warp sums float [kWarps * 3].
size_t grid_smem_bytes(int n) {
  const size_t np = kChunk * static_cast<size_t>(chunks(n));
  const size_t floats = 12 * np + kWarps * 3;
  const size_t halves = 8 * np;
  const size_t words = np / kChunk * np;
  const size_t ints = np + np / 32;
  return 4 * floats + 2 * halves + 8 * words + 4 * ints;
}

// The tiled path's: lo, hi and position as float4 [tile_j] each, the
// warps' partial sums float [kTiledWarps][3][kIBlock], the centring's warp
// sums float [kTiledWarps * 3].
size_t tiled_smem_bytes(int tile_j) {
  const size_t floats = 12 * static_cast<size_t>(tile_j) + kTiledWarps * 3 * kIBlock +
                        kTiledWarps * 3;
  return 4 * floats;
}

struct GridSmem {
  float4* lo;
  float4* hi;
  float4* pos;
  HalfBox* hb;
  u64* bits;        // [nc][np]: word k of row c at bits[k * np + c]
  int* cidx;        // [np]: the live index of row i, or -1
  int* seg;         // [np / 32]
  float* red;       // [kWarps * 3]
  int np;
};

__device__ GridSmem grid_smem(float4* smem, int n) {
  GridSmem s;
  s.np = kChunk * chunks(n);
  s.lo = smem;
  s.hi = s.lo + s.np;
  s.pos = s.hi + s.np;
  s.hb = reinterpret_cast<HalfBox*>(s.pos + s.np);
  s.bits = reinterpret_cast<u64*>(s.hb + s.np);
  s.cidx = reinterpret_cast<int*>(s.bits + (s.np / kChunk) * s.np);
  s.seg = s.cidx + s.np;
  s.red = reinterpret_cast<float*>(s.seg + s.np / 32);
  return s;
}

__device__ inline float nan_f() { return __int_as_float(0x7fc00000); }

__device__ inline float4 nan_box() { return make_float4(nan_f(), nan_f(), nan_f(), 0.0f); }

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

__device__ inline bool overlap(float4 li, float4 hi, float4 lj, float4 hj) {
  return (li.x <= hj.x) & (lj.x <= hi.x) & (li.y <= hj.y) & (lj.y <= hi.y) &
         (li.z <= hj.z) & (lj.z <= hi.z);
}

// The CTA's sum of every thread's (x, y, z) in a fixed order: a shuffle
// tree a warp (lane 0's sum is kept), then the warps' sums in warp order;
// every thread gets it, after a __syncthreads.
template <int T>
__device__ float3 block_sum3(float sx, float sy, float sz, float* red) {
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
  __syncthreads();
  float3 sum = make_float3(0.0f, 0.0f, 0.0f);
  for (int w = 0; w < T / 32; ++w) {
    sum.x += red[3 * w];
    sum.y += red[3 * w + 1];
    sum.z += red[3 * w + 2];
  }
  return sum;
}

// The mean of a world's positions [n, 3] (thread t adds rows t, t + T,
// ...): the plain version's pos.mean(dim=1).
template <int T>
__device__ float3 world_mean(const float* __restrict__ p, int n, float* red) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int i = threadIdx.x; i < n; i += T) {
    sx += p[3 * i];
    sy += p[3 * i + 1];
    sz += p[3 * i + 2];
  }
  const float3 sum = block_sum3<T>(sx, sy, sz, red);
  const float fn = static_cast<float>(n);
  return make_float3(sum.x / fn, sum.y / fn, sum.z / fn);
}

// Step 1, one pass over the world's rows and a __syncthreads: the live
// count of each 32-row segment (a ballot) and the world's mean (the rows
// in world_mean's order); returns the mean and the live rows.
struct WorldScan {
  float3 mean;
  int live;
};

__device__ WorldScan scan_world(const float* __restrict__ pos, const uint8_t* __restrict__ mask,
                                int n, const GridSmem& s) {
  const int lane = threadIdx.x & 31;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s0 = threadIdx.x & ~31; s0 < s.np; s0 += kThreads) {
    const int i = s0 + lane;
    const unsigned b = __ballot_sync(kFull, i < n && mask[i]);
    if (lane == 0) s.seg[s0 >> 5] = __popc(b);
    if (i < n) {
      sx += pos[3 * i];
      sy += pos[3 * i + 1];
      sz += pos[3 * i + 2];
    }
  }
  const float3 sum = block_sum3<kThreads>(sx, sy, sz, s.red);
  int live = 0;
  for (int k = 0; k < s.np / 32; ++k) live += s.seg[k];
  const float fn = static_cast<float>(n);
  return WorldScan{make_float3(sum.x / fn, sum.y / fn, sum.z / fn), live};
}

// Step 2's row loop: calls stage(i, c) for every row i < n, c its live
// index (the live rows before it) or -1 for a dead row, after writing
// s.cidx[i]; the loop runs by whole warps (a ballot a 32-row segment).
template <typename Stage>
__device__ void for_rows(const uint8_t* __restrict__ mask, int n, const GridSmem& s,
                         Stage stage) {
  const int lane = threadIdx.x & 31;
  for (int s0 = threadIdx.x & ~31; s0 < s.np; s0 += kThreads) {
    const int i = s0 + lane;
    const bool live = i < n && mask[i];
    const unsigned b = __ballot_sync(kFull, live);
    int before = 0;
    for (int k = 0; k < (s0 >> 5); ++k) before += s.seg[k];
    if (i < n) {
      const int c = live ? before + __popc(b & ((1u << lane) - 1u)) : -1;
      s.cidx[i] = c;
      stage(i, c);
    }
  }
}

// Step 2's other half: NaN half boxes for the pad rows [L, kChunk
// chunks(L)) and the live chunks' words zeroed.
__device__ void pad_and_clear(const GridSmem& s, int L) {
  const int lp = kChunk * chunks(L);
  for (int c = L + threadIdx.x; c < lp; c += kThreads) s.hb[c] = nan_half_box();
  for (int t = threadIdx.x; t < chunks(L) * s.np; t += kThreads) s.bits[t] = 0ull;
}

// Stages live row c: its float box and position, and its half box about r.
__device__ inline void stage_row(const GridSmem& s, int c, float4 l, float4 h, float4 p,
                                 float3 r) {
  s.lo[c] = l;
  s.hi[c] = h;
  s.pos[c] = p;
  s.hb[c] = half_box(l, h, r);
}

// Step 3: the candidate bits of the live rows.  Unit u of the upper
// triangle's chunk pairs (ci <= cj, row-major), part h: rows i0 = kChunk
// ci + kUnit h .. i0 + kUnit - 1 against chunk cj's kChunk rows (j and j +
// 32 on lane j), one warp.  Units go to the warps round-robin.  Row words
// are stored whole (one writer); the transposed bits, (row j in cj, word
// ci < cj), by atomicOr.  A bit is set where the half boxes overlap: every
// overlapping pair, and rarely a pair that step 4's float test drops.  The
// self bit of a diagonal block stays set: step 4 skips it.
__device__ void overlap_bits(const GridSmem& s, int L) {
  constexpr int parts = kChunk / kUnit;
  const int lane = threadIdx.x & 31;
  const int nc = chunks(L);
  const int units = nc * (nc + 1) / 2 * parts;
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    int b = u / parts, ci = 0, row = nc;
    while (b >= row) {
      b -= row;
      ++ci;
      --row;
    }
    const int cj = ci + b;
    const int i0 = kChunk * ci + kUnit * (u % parts);
    if (i0 >= L) continue;  // warp-uniform: past the last live row
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

// Step 4: delta_i = -2 sum_j m_ij (x_j - x_i) over row i's candidate bits
// in ascending j that pass the float32 test, m_ij = rsqrt(max(d2, 1e-30));
// dead rows get -2 * 0.
__device__ void push_rows(const GridSmem& s, int n, int L, float* __restrict__ delta) {
  const int nc = chunks(L);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    const int c = s.cidx[i];
    if (c >= 0) {
      const float4 pi = s.pos[c], li = s.lo[c], hi = s.hi[c];
      for (int k = 0; k < nc; ++k) {
        u64 w = s.bits[k * s.np + c];
        if (k == c / kChunk) w &= ~(1ull << (c % kChunk));
        while (w != 0ull) {
          const int j = kChunk * k + __ffsll(static_cast<long long>(w)) - 1;
          w &= w - 1ull;
          if (!overlap(li, hi, s.lo[j], s.hi[j])) continue;
          const float4 pj = s.pos[j];
          const float dx = pj.x - pi.x;
          const float dy = pj.y - pi.y;
          const float dz = pj.z - pi.z;
          const float m = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
          ax += m * dx;
          ay += m * dy;
          az += m * dz;
        }
      }
    }
    delta[3 * i] = -2.0f * ax;
    delta[3 * i + 1] = -2.0f * ay;
    delta[3 * i + 2] = -2.0f * az;
  }
}

// Steps 3 and 4 once step 2 has staged the live rows.
__device__ void grid_finish(const GridSmem& s, int n, int L, float* __restrict__ delta) {
  __syncthreads();
  overlap_bits(s, L);
  __syncthreads();
  push_rows(s, n, L, delta);
}

__global__ void __launch_bounds__(kThreads)
fused_collisions_step_kernel(const float* __restrict__ pos,
                             const float4* __restrict__ rot,
                             const uint8_t* __restrict__ mask, int n,
                             float* __restrict__ delta,
                             float* __restrict__ lo,
                             float* __restrict__ hi) {
  extern __shared__ float4 smem[];
  const GridSmem s = grid_smem(smem, n);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const WorldScan ws = scan_world(pos + base * 3, mask + base, n, s);
  const float3 r = finite_ref(ws.mean);

  // AABB of the rotated +-1 cube: p -+ e, e_a = sum_b |R_ab|; written for
  // every row, live or not, as the TPU kernel does.
  for_rows(mask + base, n, s, [&](int i, int c) {
    const float4 q = rot[base + i];
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
    const size_t g = (base + i) * 3;
    const float px = pos[g], py = pos[g + 1], pz = pos[g + 2];
    const float4 l = make_float4(px - ex, py - ey, pz - ez, 0.0f);
    const float4 h = make_float4(px + ex, py + ey, pz + ez, 0.0f);
    lo[g] = l.x;
    lo[g + 1] = l.y;
    lo[g + 2] = l.z;
    hi[g] = h.x;
    hi[g + 1] = h.y;
    hi[g + 2] = h.z;
    if (c >= 0) stage_row(s, c, l, h, make_float4(px, py, pz, 0.0f), r);
  });
  pad_and_clear(s, ws.live);
  grid_finish(s, n, ws.live, delta + base * 3);
}

template <bool kTiled>
__global__ void __launch_bounds__(kTiled ? kTiledThreads : kThreads, kTiled ? 4 : 10)
collision_pushes_kernel(const float* __restrict__ pos,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const uint8_t* __restrict__ mask, int n, int blocks_i,
                        int tile_j, float* __restrict__ delta) {
  extern __shared__ float4 smem[];
  if constexpr (!kTiled) {
    const GridSmem s = grid_smem(smem, n);
    const size_t base = static_cast<size_t>(blockIdx.x) * n;
    const WorldScan ws = scan_world(pos + base * 3, mask + base, n, s);
    const float3 m = ws.mean, r = finite_ref(m);
    for_rows(mask + base, n, s, [&](int i, int c) {
      if (c < 0) return;
      const size_t g = (base + i) * 3;
      stage_row(s, c, make_float4(lo[g], lo[g + 1], lo[g + 2], 0.0f),
                make_float4(hi[g], hi[g + 1], hi[g + 2], 0.0f),
                make_float4(pos[g] - m.x, pos[g + 1] - m.y, pos[g + 2] - m.z, 0.0f), r);
    });
    pad_and_clear(s, ws.live);
    grid_finish(s, n, ws.live, delta + base * 3);
  } else {
    float4* t_lo = smem;                 // [tile_j]
    float4* t_hi = t_lo + tile_j;        // [tile_j]
    float4* t_pos = t_hi + tile_j;       // [tile_j]
    float* part = reinterpret_cast<float*>(t_pos + tile_j);   // [warps][3][kIBlock]
    float* red = part + kTiledWarps * 3 * kIBlock;            // [warps * 3]
    const int w = blockIdx.x / blocks_i;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = (blockIdx.x % blocks_i) * kIBlock + lane;
    const size_t base = static_cast<size_t>(w) * n;
    const float3 mean = world_mean<kTiledThreads>(pos + base * 3, n, red);

    // Row i's box (NaN, overlapping nothing, where i is dead or past n).
    float4 li = nan_box(), hi_i = li;
    float3 pi = make_float3(0.0f, 0.0f, 0.0f);
    if (i < n && mask[base + i]) {
      const size_t g = (base + i) * 3;
      li = make_float4(lo[g], lo[g + 1], lo[g + 2], 0.0f);
      hi_i = make_float4(hi[g], hi[g + 1], hi[g + 2], 0.0f);
      pi = make_float3(pos[g] - mean.x, pos[g + 1] - mean.y, pos[g + 2] - mean.z);
    }
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int t0 = 0; t0 < n; t0 += tile_j) {
      const int cnt = min(tile_j, n - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int t = threadIdx.x; t < cnt; t += kTiledThreads) {
        const size_t g = (base + t0 + t) * 3;
        if (mask[base + t0 + t]) {
          t_lo[t] = make_float4(lo[g], lo[g + 1], lo[g + 2], 0.0f);
          t_hi[t] = make_float4(hi[g], hi[g + 1], hi[g + 2], 0.0f);
          t_pos[t] = make_float4(pos[g] - mean.x, pos[g + 1] - mean.y, pos[g + 2] - mean.z,
                                 0.0f);
        } else {
          t_lo[t] = nan_box();
          t_hi[t] = t_lo[t];
        }
      }
      __syncthreads();
      const int per = (cnt + kTiledWarps - 1) / kTiledWarps;
      const int j0 = warp * per, j1 = min(j0 + per, cnt);
#pragma unroll 4
      for (int jj = j0; jj < j1; ++jj) {
        if (overlap(li, hi_i, t_lo[jj], t_hi[jj]) && t0 + jj != i) {
          const float4 pj = t_pos[jj];
          const float dx = pj.x - pi.x;
          const float dy = pj.y - pi.y;
          const float dz = pj.z - pi.z;
          const float m = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
          ax += m * dx;
          ay += m * dy;
          az += m * dz;
        }
      }
    }
    part[(warp * 3) * kIBlock + lane] = ax;
    part[(warp * 3 + 1) * kIBlock + lane] = ay;
    part[(warp * 3 + 2) * kIBlock + lane] = az;
    __syncthreads();
    if (warp == 0 && i < n) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int v = 0; v < kTiledWarps; ++v) {
        sx += part[(v * 3) * kIBlock + lane];
        sy += part[(v * 3 + 1) * kIBlock + lane];
        sz += part[(v * 3 + 2) * kIBlock + lane];
      }
      float* d = delta + (base + i) * 3;
      d[0] = -2.0f * sx;
      d[1] = -2.0f * sy;
      d[2] = -2.0f * sz;
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int fused_collisions_step_launch(const void* pos, const void* rot,
                                            const void* mask, int W, int n,
                                            void* delta, void* lo, void* hi,
                                            void* stream) {
  if (W <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (n > kGridMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = grid_smem_bytes(n);
  cudaError_t err = allow_smem(fused_collisions_step_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_collisions_step_kernel<<<W, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float4*>(rot),
      static_cast<const uint8_t*>(mask), n, static_cast<float*>(delta),
      static_cast<float*>(lo), static_cast<float*>(hi));
  return static_cast<int>(cudaGetLastError());
}

// tile_j = 0: the grid path (n <= 640); else the tiled path with j tiles of
// tile_j rows (1 <= tile_j <= 1024).
extern "C" int collision_pushes_launch(const void* pos, const void* lo,
                                       const void* hi, const void* mask, int W,
                                       int n, int tile_j, void* delta,
                                       void* stream) {
  if (W <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* l = static_cast<const float*>(lo);
  const float* h = static_cast<const float*>(hi);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* d = static_cast<float*>(delta);
  if (tile_j == 0) {
    if (n > kGridMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = grid_smem_bytes(n);
    cudaError_t err = allow_smem(collision_pushes_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    collision_pushes_kernel<false><<<W, kThreads, smem, st>>>(p, l, h, m, n, 1, 0, d);
  } else {
    if (tile_j < 1 || tile_j > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks_i = (n + kIBlock - 1) / kIBlock;
    const size_t smem = tiled_smem_bytes(tile_j);
    cudaError_t err = allow_smem(collision_pushes_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    collision_pushes_kernel<true><<<W * blocks_i, kTiledThreads, smem, st>>>(
        p, l, h, m, n, blocks_i, tile_j, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of a kernel: which = 0 fused_collisions_step, 1
// collision_pushes' grid path, 2 its tiled path (tile_j rows a tile);
// threads a CTA, dynamic shared bytes and CTAs an SM (the occupancy API).
extern "C" int collision_occupancy(int which, int n, int tile_j, int* threads, int* smem,
                                   int* ctas) {
  size_t bytes = 0;
  cudaError_t err = cudaSuccess;
  *threads = which == 2 ? kTiledThreads : kThreads;
  if (which == 0) {
    bytes = grid_smem_bytes(n);
    err = allow_smem(fused_collisions_step_kernel, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fused_collisions_step_kernel,
                                                          *threads, bytes);
  } else if (which == 1) {
    bytes = grid_smem_bytes(n);
    err = allow_smem(collision_pushes_kernel<false>, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas, collision_pushes_kernel<false>, *threads, bytes);
  } else {
    bytes = tiled_smem_bytes(tile_j);
    err = allow_smem(collision_pushes_kernel<true>, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas, collision_pushes_kernel<true>, *threads, bytes);
  }
  *smem = static_cast<int>(bytes);
  return static_cast<int>(err);
}
