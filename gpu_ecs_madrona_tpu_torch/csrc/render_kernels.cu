// The batch renderer's pixel kernel for Hopper (sm_90a): TPU kernel 10.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// and called through the plain C function at the end of this file
// (ctypes).  The launch goes on the caller's stream, allocates nothing,
// and returns cudaGetLastError().
//
// render_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/render_kernel.py: PallasRenderKernel
//   (_run -> _make_kernel).  For each (world, pixel) ray: the nearest hit
//   over the world's live instances (spheres; convex hulls by the slab
//   test over their face planes; planes; Moeller-Trumbore over an object's
//   triangle render mesh, which overrides its physics primitive), the
//   winner's unnormalised normal and albedo, then Lambert plus ambient.
//   Output [W, 5, P]: r, g, b, hit, depth (1e9 at a miss).
//
//   Layout: rays [W, 6, P] (ro, rd), inst [W, 12, N] (pos, rot wxyz,
//   scale, obj, mask), channel-major as the TPU kernel's, and an object
//   table [O, S] float32 (ops/render_kernel.py RenderTables.table: prim
//   type, radius, bounding radius, albedo, has-mesh, face count, then F
//   face planes and T triangles), copied to the card once by the wrapper.
//
//   Work: W * P rays against the instances that survive the cull.  The
//   bytes (W (24 P + 48 N + 20 P)) bound it when few instances survive a
//   tile; the ray tests (~25 operations a sphere, ~45 a plane, 75 + 14 F
//   a hull, 115 + 47 T a mesh) when many do.  chip_smoke.py counts both
//   from the timed state and reports the larger (PERF.md).
//
//   Design: one CTA of 128 threads per (world, tile of pixels), one thread
//   per pixel; with the image width given, a tile is a 16 x 8 block of
//   the image, so its rays form a narrow cone.  The CTA stages the
//   world's instance channels in shared memory, builds the tile's view
//   cone with block reductions (the JAX kernel's formula: padded rays
//   excluded, the spread of the ray origins added to each instance's
//   bounding radius, and every instance kept once the widened cone wraps
//   past a half-space, cos_m <= -cos_b), and culls the instances against
//   it, one thread an instance.  The survivors are compacted in index
//   order with warp ballots and a scan over the four warps.  Each thread
//   then loops over the survivors and keeps the best (t, normal, albedo)
//   in registers; every thread of the CTA tests the same instance at the
//   same time, so the branch on its primitive type does not diverge and
//   the shared-memory reads are broadcasts.  The object table is read
//   through the read-only cache, also as broadcasts.  Strict < keeps the
//   first instance in index order on a tie of t.
//
//   The cull widens each bounding sphere by 0.1% plus 1e-3 so that
//   rounding in the cone test cannot drop an instance a ray hits: the cull
//   only decides which instances are tested, never a result.  A tile
//   size changes which instances survive and nothing else.
//
//   Arithmetic: -fmad=false keeps every product and sum rounded on its
//   own, in the plain version's order (render_plain), and sqrtf and / are
//   the IEEE-rounded ones, so the kernel and the plain version agree bit
//   for bit on the same survivors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;
constexpr float kEps = 1e-9f;
constexpr float kCullRel = 1e-3f;
constexpr float kCullAbs = 1e-3f;

// object-table columns (ops/render_kernel.py K_*)
constexpr int kPrim = 0, kRadius = 1, kRBound = 2, kAlbedo = 3, kMesh = 6, kNFace = 7;
constexpr int kFixed = 8, kFace = 4, kTri = 13;
constexpr int kSphere = 0, kHull = 1, kPlane = 2;
// instance channels
constexpr int kPos = 0, kRot = 3, kScl = 7, kObj = 10, kMask = 11, kInst = 12;

struct V3 {
  float x, y, z;
};
struct Q {
  float w, x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// physics/pairs.py qrot / qrot_inv: t = 2 (qv x v); (v + t qw) + qv x t
__device__ __forceinline__ V3 rotate(float qw, V3 qv, V3 v) {
  const V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, qw)), cross(qv, t));
}
__device__ __forceinline__ V3 qrot(Q q, V3 v) { return rotate(q.w, {q.x, q.y, q.z}, v); }
__device__ __forceinline__ V3 qrot_inv(Q q, V3 v) { return rotate(q.w, {-q.x, -q.y, -q.z}, v); }

// x where |x| >= eps, else +-eps by the sign of x (>= 0 is +)
__device__ __forceinline__ float nonzero_sign(float x) {
  return fabsf(x) < kEps ? (x >= 0.0f ? kEps : -kEps) : x;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The ray against one instance: its t (kBig on a miss) and, when t beats
// best_t, its unnormalised normal in n.
__device__ __forceinline__ float trace(const float* __restrict__ tb, int F, int T, V3 ro,
                                       V3 rd, V3 pos, Q rot, V3 scl, float best_t, V3& n) {
  const int prim = static_cast<int>(__ldg(tb + kPrim));
  if (T > 0 && __ldg(tb + kMesh) > 0.5f) {
    // triangle render mesh: Moeller-Trumbore over the object's triangles
    const V3 inv_s = {1.0f / fmaxf(scl.x, kEps), 1.0f / fmaxf(scl.y, kEps),
                      1.0f / fmaxf(scl.z, kEps)};
    const V3 ro_l = mul(qrot_inv(rot, sub(ro, pos)), inv_s);
    const V3 rd_l = mul(qrot_inv(rot, rd), inv_s);
    float t_msh = kBig;
    V3 n_ml = {0.0f, 0.0f, 0.0f};
    const float* tri = tb + kFixed + kFace * F;
    for (int k = 0; k < T; ++k, tri += kTri) {
      if (!(__ldg(tri + 12) > 0.5f)) continue;
      const V3 a = {__ldg(tri), __ldg(tri + 1), __ldg(tri + 2)};
      const V3 e1 = {__ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5)};
      const V3 e2 = {__ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8)};
      const V3 pvec = cross(rd_l, e2);
      const float det = dot(e1, pvec);
      const float inv_det = 1.0f / nonzero_sign(det);
      const V3 tvec = sub(ro_l, a);
      const float u = dot(tvec, pvec) * inv_det;
      const V3 qvec = cross(tvec, e1);
      const float v = dot(rd_l, qvec) * inv_det;
      const float tt = dot(e2, qvec) * inv_det;
      const bool hit = fabsf(det) > kEps && u >= -1e-6f && v >= -1e-6f && u + v <= 1.000001f &&
                       tt > 1e-4f;
      if (hit && tt < t_msh) {
        t_msh = tt;
        n_ml = {__ldg(tri + 9), __ldg(tri + 10), __ldg(tri + 11)};
      }
    }
    if (t_msh < best_t) {
      const V3 nw = qrot(rot, mul(n_ml, inv_s));
      n = dot(nw, rd) > 0.0f ? V3{-nw.x, -nw.y, -nw.z} : nw;
    }
    return t_msh;
  }
  if (prim == kSphere) {
    const float rad = __ldg(tb + kRadius) * scl.x;
    const V3 oc = sub(ro, pos);
    const float b = dot(oc, rd);
    const float c = dot(oc, oc) - rad * rad;
    const float disc = b * b - c;
    const float ts = -b - sqrtf(fmaxf(disc, 0.0f));
    const float t = (disc >= 0.0f && ts > 1e-4f) ? ts : kBig;
    if (t < best_t) n = sub(add(ro, scale(rd, t)), pos);
    return t;
  }
  if (prim == kHull) {
    if (F == 0) return kBig;
    // slab over the face planes, in the unscaled local frame
    const V3 inv_s = {1.0f / fmaxf(scl.x, kEps), 1.0f / fmaxf(scl.y, kEps),
                      1.0f / fmaxf(scl.z, kEps)};
    const V3 ro_l = mul(qrot_inv(rot, sub(ro, pos)), inv_s);
    const V3 rd_l = mul(qrot_inv(rot, rd), inv_s);
    float t_enter = -kBig, t_exit = kBig;
    bool par_out = false;
    V3 n_l = {0.0f, 0.0f, 0.0f};
    const int nf = min(F, static_cast<int>(__ldg(tb + kNFace)));
    const float* fp = tb + kFixed;
    for (int f = 0; f < nf; ++f, fp += kFace) {
      const V3 nrm = {__ldg(fp), __ldg(fp + 1), __ldg(fp + 2)};
      const float denom = dot(nrm, rd_l);
      const float dist = __ldg(fp + 3) - dot(nrm, ro_l);
      const bool small = fabsf(denom) < kEps;
      const float t_f = dist / (small ? (denom >= 0.0f ? kEps : -kEps) : denom);
      if (denom < 0.0f) {
        if (t_f > t_enter) {
          t_enter = t_f;
          n_l = nrm;
        }
      } else {
        t_exit = fminf(t_exit, t_f);
      }
      par_out = par_out || (small && dist < 0.0f);
    }
    const bool hit = t_enter <= t_exit && t_exit > 1e-4f && !par_out;
    const float t = hit ? (t_enter > 1e-4f ? t_enter : t_exit) : kBig;
    if (t < best_t) n = qrot(rot, mul(n_l, inv_s));
    return t;
  }
  // plane: local +z through pos
  const V3 n_p = qrot(rot, {0.0f, 0.0f, 1.0f});
  const float denom = dot(rd, n_p);
  const float tp = dot(sub(pos, ro), n_p) / nonzero_sign(denom);
  const float t = (tp > 1e-4f && fabsf(denom) > 1e-6f) ? tp : kBig;
  if (t < best_t) n = n_p;
  return t;
}

__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ rays, const float* __restrict__ inst,
              const float* __restrict__ table, int O, int S, int F, int T, int P, int N,
              int img_w, int tile_w, int tiles_x, float lx, float ly, float lz, float amb,
              float one_m_amb, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_inst = smem;                                            // [12, N]
  int* s_surv = reinterpret_cast<int*>(s_inst + kInst * N);        // [N]
  __shared__ float s_sum[7][kWarps];
  __shared__ float s_ext[2][kWarps];
  __shared__ int s_count[kWarps];

  const int w = blockIdx.x;
  const int tile_h = kThreads / tile_w;
  const int col = (blockIdx.y % tiles_x) * tile_w + threadIdx.x % tile_w;
  const int row = (blockIdx.y / tiles_x) * tile_h + threadIdx.x / tile_w;
  const int p = row * img_w + col;
  const bool in_range =
      static_cast<int>(threadIdx.x) < tile_w * tile_h && col < img_w && p < P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  V3 ro = {0.0f, 0.0f, 0.0f}, rd = {0.0f, 0.0f, 0.0f};
  if (in_range) {
    const float* r = rays + static_cast<size_t>(w) * 6 * P + p;
    ro = {r[0], r[P], r[2 * P]};
    rd = {r[3 * P], r[4 * P], r[5 * P]};
  }
  const bool pad = !(dot(rd, rd) >= 0.5f);

  const float* src = inst + static_cast<size_t>(w) * kInst * N;
  for (int k = threadIdx.x; k < kInst * N; k += kThreads) s_inst[k] = src[k];

  // the tile's view cone: axis = the mean direction of its rays, cos_m =
  // the least cosine to it, the origins' mean and spread; padded rays out
  const float m = pad ? 0.0f : 1.0f;
  const float part[7] = {rd.x * m, rd.y * m, rd.z * m, ro.x * m, ro.y * m, ro.z * m, m};
  for (int k = 0; k < 7; ++k) {
    const float v = warp_sum(part[k]);
    if (lane == 0) s_sum[k][warp] = v;
  }
  __syncthreads();
  float tot[7];
  for (int k = 0; k < 7; ++k) {
    tot[k] = 0.0f;
    for (int j = 0; j < kWarps; ++j) tot[k] += s_sum[k][j];
  }
  const float count = tot[6];
  const float inv_ax = 1.0f / sqrtf(fmaxf(tot[0] * tot[0] + tot[1] * tot[1] + tot[2] * tot[2],
                                          kEps));
  const V3 ax = {tot[0] * inv_ax, tot[1] * inv_ax, tot[2] * inv_ax};
  const float inv_cnt = 1.0f / fmaxf(count, 1.0f);
  const V3 ro_mean = {tot[3] * inv_cnt, tot[4] * inv_cnt, tot[5] * inv_cnt};
  const V3 dro = sub(ro, ro_mean);
  const float cmin = warp_min(pad ? 1.0f : dot(rd, ax));
  const float smax2 = warp_max(pad ? 0.0f : dot(dro, dro));
  if (lane == 0) {
    s_ext[0][warp] = cmin;
    s_ext[1][warp] = smax2;
  }
  __syncthreads();
  float cos_m = s_ext[0][0], spread2 = s_ext[1][0];
  for (int j = 1; j < kWarps; ++j) {
    cos_m = fminf(cos_m, s_ext[0][j]);
    spread2 = fmaxf(spread2, s_ext[1][j]);
  }
  cos_m = fminf(fmaxf(cos_m, -1.0f), 1.0f);
  const float sin_m = sqrtf(fmaxf(1.0f - cos_m * cos_m, 0.0f));
  const float spread = sqrtf(spread2);

  // cull, one thread an instance, and compact the survivors in index order
  int total = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + threadIdx.x;
    bool keep = false;
    if (i < N && count > 0.0f) {
      const float objf = s_inst[kObj * N + i];
      const int o = static_cast<int>(objf);
      if (s_inst[kMask * N + i] > 0.5f && static_cast<float>(o) == objf && o >= 0 && o < O) {
        const float* tb = table + static_cast<size_t>(o) * S;
        if (static_cast<int>(__ldg(tb + kPrim)) == kPlane) {
          keep = true;
        } else {
          const float smax = fmaxf(fmaxf(s_inst[kScl * N + i], s_inst[(kScl + 1) * N + i]),
                                   s_inst[(kScl + 2) * N + i]);
          const float r_eff = (__ldg(tb + kRBound) * smax + spread) * (1.0f + kCullRel) +
                              kCullAbs;
          const V3 d = sub({s_inst[kPos * N + i], s_inst[(kPos + 1) * N + i],
                            s_inst[(kPos + 2) * N + i]}, ro_mean);
          const float dist = sqrtf(fmaxf(dot(d, d), kEps));
          const float cos_ad = dot(d, ax) / dist;
          const float sin_b = fminf(fmaxf(r_eff / dist, 0.0f), 1.0f);
          const float cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
          keep = cos_m <= -cos_b || cos_ad >= cos_m * cos_b - sin_m * sin_b || dist <= r_eff;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int off = total, chunk = 0;
    for (int j = 0; j < kWarps; ++j) {
      off += j < warp ? s_count[j] : 0;
      chunk += s_count[j];
    }
    if (keep) s_surv[off + __popc(ballot & ((1u << lane) - 1u))] = i;
    __syncthreads();
    total += chunk;
  }

  if (!in_range) return;
  float best_t = kBig;
  V3 best_n = {0.0f, 0.0f, 0.0f}, best_a = {0.0f, 0.0f, 0.0f};
  if (!pad) {
    for (int s = 0; s < total; ++s) {
      const int i = s_surv[s];
      const V3 pos = {s_inst[kPos * N + i], s_inst[(kPos + 1) * N + i],
                      s_inst[(kPos + 2) * N + i]};
      const Q rot = {s_inst[kRot * N + i], s_inst[(kRot + 1) * N + i],
                     s_inst[(kRot + 2) * N + i], s_inst[(kRot + 3) * N + i]};
      const V3 scl = {s_inst[kScl * N + i], s_inst[(kScl + 1) * N + i],
                      s_inst[(kScl + 2) * N + i]};
      const float* tb = table + static_cast<size_t>(s_inst[kObj * N + i]) * S;
      V3 n = best_n;
      const float t = trace(tb, F, T, ro, rd, pos, rot, scl, best_t, n);
      if (t < best_t) {
        best_t = t;
        best_n = n;
        best_a = {__ldg(tb + kAlbedo), __ldg(tb + kAlbedo + 1), __ldg(tb + kAlbedo + 2)};
      }
    }
  }

  // shade: Lambert plus ambient
  float* o = out + static_cast<size_t>(w) * 5 * P + p;
  if (pad) {
    o[0] = 0.0f;
    o[P] = 0.0f;
    o[2 * P] = 0.0f;
    o[3 * P] = 0.0f;
    o[4 * P] = kBig;
    return;
  }
  const bool hit = best_t < kBig * 0.5f;
  const float inv_len = 1.0f / sqrtf(fmaxf(dot(best_n, best_n), kEps));
  const V3 nn = scale(best_n, inv_len);
  const float lam = fmaxf(nn.x * lx + nn.y * ly + nn.z * lz, 0.0f);
  const float shade = amb + one_m_amb * lam;
  const float hitf = hit ? 1.0f : 0.0f;
  o[0] = best_a.x * shade * hitf;
  o[P] = best_a.y * shade * hitf;
  o[2 * P] = best_a.z * shade * hitf;
  o[3 * P] = hitf;
  o[4 * P] = hit ? best_t : kBig;
}

}  // namespace

extern "C" int render_launch(const void* rays, const void* inst, const void* table, int O,
                             int S, int F, int T, int W, int P, int N, int img_w, int tile_w,
                             float lx, float ly, float lz, float amb, float one_m_amb,
                             void* out, void* stream) {
  if (W <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || img_w <= 0 || tile_w <= 0 || tile_w > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_h = kThreads / tile_w;
  const int rows = (P + img_w - 1) / img_w;
  const int tiles_x = (img_w + tile_w - 1) / tile_w;
  const int tiles = tiles_x * ((rows + tile_h - 1) / tile_h);
  const size_t smem = static_cast<size_t>(N) * (kInst + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  render_kernel<<<dim3(W, tiles), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(inst),
      static_cast<const float*>(table), O, S, F, T, P, N, img_w, tile_w, tiles_x, lx, ly, lz,
      amb, one_m_amb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
