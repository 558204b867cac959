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
// [W, n, 4] w-first quaternions, [W, n] bool (one byte) masks.  No
// coordinate-major transpose and no padding to 128: those were lane
// choices of the TPU kernels.
//
// Arithmetic: -fmad=false keeps every product and sum separately rounded,
// in the order of the plain PyTorch versions (ops/collision_kernel.py),
// so the AABBs come out bit-identical to aabb_plain and the overlap
// decisions match the plain version's.  The push uses rsqrtf (the SFU's
// approximate reciprocal square root, about 2 ulp), not 1.0f / sqrtf.
//
// fused_collisions_step_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/collision_kernel.py:
//   fused_collisions_step (_kernel_fused_step).
//   Work: per world, n AABBs and an all-pairs loop over n^2 ordered pairs;
//   at 8192 worlds x 108 rows, 65 B a row of traffic (~17 us at 3.35 TB/s)
//   against ~81M live-pair tests of 6 compares (~7 us at 67 TFLOP/s) plus
//   16 more operations for each overlapping pair: by the card's peaks the
//   bytes bound it.  It runs at 0.127 ms on an H100 80GB HBM3 at 700 W
//   (PERF.md); the pair loop's shared-memory loads and compares, issued
//   per pair per thread, are the likely limit (not measured).
//   Design: one CTA per world.  The CTA stages the world's positions and
//   AABBs (9 floats a body) and mask in shared memory, then each thread
//   owns body i (strided by the block size) and loops j over shared
//   memory: every thread of a warp reads the same j, so the reads are
//   broadcasts without bank conflicts.  Nothing [n, n] is stored; pairs
//   that fail the mask or the overlap skip the d2/rsqrt work.
//
// collision_pushes_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/collision_kernel.py:
//   collision_pushes, both its single-block body (_kernel) and its tiled
//   one (_kernel_tiled).
//   Work: the same pair loop with the AABBs given, on positions centred
//   per world by the wrapper; 49 B a row of traffic, and the same pair
//   loop as above.
//   Design: one CTA per (world, tile of 128 bodies i); the CTA walks j in
//   tiles of tile_j bodies staged through shared memory (pos, lo, hi,
//   mask: 37 B a body), so n is unbounded and the loop stops at n without
//   padding.  Each thread keeps its body's sum in registers: no
//   cross-block reduction and no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fused_collisions_step_kernel(const float* __restrict__ pos,
                             const float* __restrict__ rot,
                             const uint8_t* __restrict__ mask, int n,
                             float* __restrict__ delta,
                             float* __restrict__ lo,
                             float* __restrict__ hi) {
  extern __shared__ float smem[];
  float* s_pos = smem;            // [n, 3]
  float* s_lo = s_pos + 3 * n;    // [n, 3]
  float* s_hi = s_lo + 3 * n;     // [n, 3]
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_hi + 3 * n);  // [n]

  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  // (a) AABB of the rotated +-1 cube: p -+ e, e_a = sum_b |R_ab|; written
  // for every row, live or not, as the TPU kernel does.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* q = rot + (base + i) * 4;
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
    for (int a = 0; a < 3; ++a) {
      const size_t g = (base + i) * 3 + a;
      const float p = pos[g];
      const float l = p - e[a];
      const float h = p + e[a];
      lo[g] = l;
      hi[g] = h;
      s_pos[3 * i + a] = p;
      s_lo[3 * i + a] = l;
      s_hi[3 * i + a] = h;
    }
    s_mask[i] = mask[base + i];
  }
  __syncthreads();

  // (b) overlap ^ mask_i ^ mask_j ^ i != j, (c) subtract-first d2 and the
  // push sum_j M_ij (x_j - x_i), M_ij = rsqrt(max(d2, 1e-30)); no centring.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    if (s_mask[i]) {
      const float xi = s_pos[3 * i], yi = s_pos[3 * i + 1], zi = s_pos[3 * i + 2];
      const float lxi = s_lo[3 * i], lyi = s_lo[3 * i + 1], lzi = s_lo[3 * i + 2];
      const float hxi = s_hi[3 * i], hyi = s_hi[3 * i + 1], hzi = s_hi[3 * i + 2];
      for (int j = 0; j < n; ++j) {
        if (j == i || !s_mask[j]) continue;
        if (!(lxi <= s_hi[3 * j] && s_lo[3 * j] <= hxi &&
              lyi <= s_hi[3 * j + 1] && s_lo[3 * j + 1] <= hyi &&
              lzi <= s_hi[3 * j + 2] && s_lo[3 * j + 2] <= hzi))
          continue;
        const float dx = s_pos[3 * j] - xi;
        const float dy = s_pos[3 * j + 1] - yi;
        const float dz = s_pos[3 * j + 2] - zi;
        const float m = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
        ax += m * dx;
        ay += m * dy;
        az += m * dz;
      }
    }
    float* d = delta + (base + i) * 3;
    d[0] = -2.0f * ax;
    d[1] = -2.0f * ay;
    d[2] = -2.0f * az;
  }
}

__global__ void __launch_bounds__(kThreads)
collision_pushes_kernel(const float* __restrict__ pos,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const uint8_t* __restrict__ mask, int n, int tiles_i,
                        int tile_j, float* __restrict__ delta) {
  extern __shared__ float smem[];
  float* s_pos = smem;                 // [tile_j, 3]
  float* s_lo = s_pos + 3 * tile_j;    // [tile_j, 3]
  float* s_hi = s_lo + 3 * tile_j;     // [tile_j, 3]
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_hi + 3 * tile_j);

  const int w = blockIdx.x / tiles_i;
  const int i = (blockIdx.x % tiles_i) * blockDim.x + threadIdx.x;
  const size_t base = static_cast<size_t>(w) * n;

  const bool active = i < n && mask[base + i];
  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  float lxi = 0.0f, lyi = 0.0f, lzi = 0.0f, hxi = 0.0f, hyi = 0.0f, hzi = 0.0f;
  if (active) {
    const size_t g = (base + i) * 3;
    xi = pos[g]; yi = pos[g + 1]; zi = pos[g + 2];
    lxi = lo[g]; lyi = lo[g + 1]; lzi = lo[g + 2];
    hxi = hi[g]; hyi = hi[g + 1]; hzi = hi[g + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int j0 = 0; j0 < n; j0 += tile_j) {
    const int cnt = min(tile_j, n - j0);
    __syncthreads();  // the previous tile is no longer read
    const size_t g0 = (base + j0) * 3;
    for (int t = threadIdx.x; t < 3 * cnt; t += blockDim.x) {
      s_pos[t] = pos[g0 + t];
      s_lo[t] = lo[g0 + t];
      s_hi[t] = hi[g0 + t];
    }
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) s_mask[t] = mask[base + j0 + t];
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < cnt; ++jj) {
      if (j0 + jj == i || !s_mask[jj]) continue;
      if (!(lxi <= s_hi[3 * jj] && s_lo[3 * jj] <= hxi &&
            lyi <= s_hi[3 * jj + 1] && s_lo[3 * jj + 1] <= hyi &&
            lzi <= s_hi[3 * jj + 2] && s_lo[3 * jj + 2] <= hzi))
        continue;
      const float dx = s_pos[3 * jj] - xi;
      const float dy = s_pos[3 * jj + 1] - yi;
      const float dz = s_pos[3 * jj + 2] - zi;
      const float m = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
      ax += m * dx;
      ay += m * dy;
      az += m * dz;
    }
  }
  if (i < n) {
    float* d = delta + (base + i) * 3;
    d[0] = -2.0f * ax;
    d[1] = -2.0f * ay;
    d[2] = -2.0f * az;
  }
}

size_t staged_bytes(int bodies) {
  return static_cast<size_t>(bodies) * (9 * sizeof(float) + 1);
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
  const size_t smem = staged_bytes(n);
  cudaError_t err = allow_smem(fused_collisions_step_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_collisions_step_kernel<<<W, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(rot),
      static_cast<const uint8_t*>(mask), n, static_cast<float*>(delta),
      static_cast<float*>(lo), static_cast<float*>(hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int collision_pushes_launch(const void* pos, const void* lo,
                                       const void* hi, const void* mask, int W,
                                       int n, int tile_j, void* delta,
                                       void* stream) {
  if (W <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int tiles_i = (n + kThreads - 1) / kThreads;
  const size_t smem = staged_bytes(tile_j);
  cudaError_t err = allow_smem(collision_pushes_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  collision_pushes_kernel<<<W * tiles_i, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const uint8_t*>(mask), n,
      tiles_i, tile_j, static_cast<float*>(delta));
  return static_cast<int>(cudaGetLastError());
}
