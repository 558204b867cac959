// The simple_jobs tick in one kernel for Hopper (sm_90a).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// and called through the plain C function at the end of this file
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
//     3. the ordered overlap pairs (a, b), a != b;
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
//   [W, K, 3] (zero past min(total, K)); counts = total and dropped [W].
//   Work: at 1024 worlds x 100 bodies x K = 1600 slots a call moves
//   W (n0 28 B in + n0 36 B out + K 20 B out + 8 B) ~ 39 MB, ~12 us at
//   3.35 TB/s, against ~10M ordered-pair tests of a few operations each
//   (well under 1 us at 67 TFLOP/s): the bytes bound it, and most of them
//   are the K-slot buffers, rewritten every call tail zeros included.
//   Design: one CTA per world, one thread per body (blockDim = n0 rounded
//   up to 32, so n0 <= 1024).  The world's clamped positions, lo and hi sit
//   in shared memory; thread a walks b over shared memory (broadcast reads:
//   every thread of a warp reads the same b), builds its row of the overlap
//   mask as 32-bit words in shared memory and accumulates its push in the
//   same pass.  Its degree is __popc over its words; a block-wide exclusive
//   scan of min(deg, D) gives base.  Thread a then walks the set bits of its
//   row in ascending order to write its slots, and the block writes the
//   zero tail as flat, coalesced int and float stores.  No [W, 3, n]
//   transpose, lane padding, triangular matmul or one-hot inverse map: those
//   were the TPU's layout and matrix-unit choices.
//
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain version (ops/simple_jobs_kernel.py), so the
// clamped positions and the AABBs come out bit-identical and so do the
// overlap decisions and every integer output.  rsqrtf is the SFU's
// approximate reciprocal square root (about 2 ulp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBodies = 1024;

struct Bounds {
  float lo[3];
  float hi[3];
};

// Exclusive block-wide scan of v (blockDim a multiple of 32, every thread
// calls it).  s_warp holds 33 ints; returns the prefix, sets *total.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int t = s_warp[w];
      s_warp[w] = acc;
      acc += t;
    }
    s_warp[32] = acc;
  }
  __syncthreads();
  *total = s_warp[32];
  return s_warp[warp] + x - v;
}

__global__ void __launch_bounds__(kMaxBodies)
fused_simple_jobs_step_kernel(const float* __restrict__ pos,
                              const float* __restrict__ rot, int n0, int K,
                              int D, Bounds bounds,
                              float* __restrict__ translation,
                              float* __restrict__ lo, float* __restrict__ hi,
                              int* __restrict__ ab, float* __restrict__ nrm,
                              int* __restrict__ counts,
                              int* __restrict__ dropped) {
  extern __shared__ float smem[];
  const int words = (n0 + 31) >> 5;
  float* s_pos = smem;            // [n0, 3] clamped, not centred
  float* s_lo = s_pos + 3 * n0;   // [n0, 3]
  float* s_hi = s_lo + 3 * n0;    // [n0, 3]
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_hi + 3 * n0);  // [n0, words]
  __shared__ float s_red[32][3];
  __shared__ float s_mean[3];
  __shared__ int s_warp[33];
  __shared__ int s_dropped;

  const int w = blockIdx.x;
  const int a = threadIdx.x;
  const bool live = a < n0;
  const size_t body = static_cast<size_t>(w) * n0 + a;

  // (1) clamp, (2) AABB; written for every body.
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float* q = rot + body * 4;
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qw * qz);
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r10 = 2.0f * (qx * qy + qw * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r20 = 2.0f * (qx * qz - qw * qy);
    const float r21 = 2.0f * (qy * qz + qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float e[3] = {fabsf(r00) + fabsf(r01) + fabsf(r02),
                        fabsf(r10) + fabsf(r11) + fabsf(r12),
                        fabsf(r20) + fabsf(r21) + fabsf(r22)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t g = body * 3 + c;
      p[c] = fminf(fmaxf(pos[g], bounds.lo[c]), bounds.hi[c]);
      const float l = p[c] - e[c];
      const float h = p[c] + e[c];
      lo[g] = l;
      hi[g] = h;
      s_pos[3 * a + c] = p[c];
      s_lo[3 * a + c] = l;
      s_hi[3 * a + c] = h;
    }
  }

  // The world's mean position: warp sums, then the warps' partials in order.
  float sum[3] = {p[0], p[1], p[2]};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) sum[c] += __shfl_down_sync(0xffffffffu, sum[c], o);
  if ((a & 31) == 0)
#pragma unroll
    for (int c = 0; c < 3; ++c) s_red[a >> 5][c] = sum[c];
  if (a == 0) s_dropped = 0;
  __syncthreads();
  if (a == 0) {
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) acc += s_red[i][c];
      s_mean[c] = acc / static_cast<float>(n0);
    }
  }
  __syncthreads();

  // (3) row a of the overlap mask as bits, and (6) the push, in one pass.
  int deg = 0;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float mx = s_mean[0], my = s_mean[1], mz = s_mean[2];
    const float xa = s_pos[3 * a] - mx, ya = s_pos[3 * a + 1] - my,
                za = s_pos[3 * a + 2] - mz;
    const float lxa = s_lo[3 * a], lya = s_lo[3 * a + 1], lza = s_lo[3 * a + 2];
    const float hxa = s_hi[3 * a], hya = s_hi[3 * a + 1], hza = s_hi[3 * a + 2];
    for (int wd = 0; wd < words; ++wd) {
      uint32_t bits = 0u;
      const int b_end = min(32 * wd + 32, n0);
      for (int b = 32 * wd; b < b_end; ++b) {
        if (b == a) continue;
        if (!(lxa <= s_hi[3 * b] && s_lo[3 * b] <= hxa &&
              lya <= s_hi[3 * b + 1] && s_lo[3 * b + 1] <= hya &&
              lza <= s_hi[3 * b + 2] && s_lo[3 * b + 2] <= hza))
          continue;
        bits |= 1u << (b - 32 * wd);
        const float dx = (s_pos[3 * b] - mx) - xa;
        const float dy = (s_pos[3 * b + 1] - my) - ya;
        const float dz = (s_pos[3 * b + 2] - mz) - za;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 > 1e-12f) {
          const float m = rsqrtf(fmaxf(d2, 1e-30f));
          acc[0] += m * dx;
          acc[1] += m * dy;
          acc[2] += m * dz;
        }
      }
      s_bits[a * words + wd] = bits;
      deg += __popc(bits);
    }
  }

  // (4) base = exclusive prefix of the capped degrees; dropped pairs.
  const int degc = min(deg, D);
  if (deg > degc) atomicAdd(&s_dropped, deg - degc);
  int total;
  const int base = block_exclusive_scan(degc, s_warp, &total);  // syncs

  // (4, 5) row a's first degc partners, ascending, at base + r < K.
  if (live) {
    const float xa = s_pos[3 * a], ya = s_pos[3 * a + 1], za = s_pos[3 * a + 2];
    const int keep = max(0, min(degc, K - base));
    int r = 0;
    for (int wd = 0; wd < words && r < keep; ++wd) {
      uint32_t bits = s_bits[a * words + wd];
      while (bits != 0u && r < keep) {
        const int b = 32 * wd + __ffs(bits) - 1;
        bits &= bits - 1u;
        const size_t k = static_cast<size_t>(w) * K + base + r;
        ++r;
        ab[2 * k] = a;
        ab[2 * k + 1] = b;
        const float dx = s_pos[3 * b] - xa;
        const float dy = s_pos[3 * b + 1] - ya;
        const float dz = s_pos[3 * b + 2] - za;
        const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
        nrm[3 * k] = dx * inv;
        nrm[3 * k + 1] = dy * inv;
        nrm[3 * k + 2] = dz * inv;
      }
    }
    float* t = translation + body * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = p[c] + -2.0f * acc[c];
  }

  // The zero tail [min(total, K), K), as flat coalesced stores.
  const size_t first = min(total, K);
  int* ab_w = ab + static_cast<size_t>(w) * K * 2;
  float* nrm_w = nrm + static_cast<size_t>(w) * K * 3;
  for (size_t i = 2 * first + a; i < 2 * static_cast<size_t>(K); i += blockDim.x) ab_w[i] = 0;
  for (size_t i = 3 * first + a; i < 3 * static_cast<size_t>(K); i += blockDim.x) nrm_w[i] = 0.0f;
  if (a == 0) {
    counts[w] = total;
    dropped[w] = s_dropped;
  }
}

}  // namespace

extern "C" int fused_simple_jobs_step_launch(
    const void* pos, const void* rot, int W, int n0, int K, int D,
    float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
    void* translation, void* lo, void* hi, void* ab, void* nrm, void* counts,
    void* dropped, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n0 <= 0 || n0 > kMaxBodies || K <= 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((n0 + 31) / 32) * 32;
  const int words = (n0 + 31) / 32;
  const size_t smem = static_cast<size_t>(n0) * 9 * sizeof(float) +
                      static_cast<size_t>(n0) * words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_simple_jobs_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Bounds bounds = {{lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  fused_simple_jobs_step_kernel<<<W, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(rot), n0, K, D,
      bounds, static_cast<float*>(translation), static_cast<float*>(lo),
      static_cast<float*>(hi), static_cast<int*>(ab), static_cast<float*>(nrm),
      static_cast<int*>(counts), static_cast<int*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
