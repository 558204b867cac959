// The batch renderer's pixel kernel for Hopper (sm_90a): TPU kernel 10.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file
// (ctypes).  A launch goes on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// render_kernel<VIEWS>
//   Replaces gpu_ecs_madrona_tpu/ops/render_kernel.py: PallasRenderKernel
//   (_run -> _make_kernel), and, with VIEWS, the render node around it
//   (gpu_ecs_madrona_tpu/render/renderer.py BatchRenderer.setup_tasks'
//   render: its camera rays and its RGBA8/depth writeback).  For each
//   pixel ray: the nearest hit over the world's live instances (spheres;
//   convex hulls by the slab test over their face planes; planes;
//   Moeller-Trumbore over an object's triangle render mesh, which
//   overrides its physics primitive), the winner's unnormalised normal and
//   albedo, then Lambert plus ambient.
//
//   Two modes of one traced core:
//     rays   (VIEWS false; ops/render_kernel.py render, the JAX contract):
//            rays [W, 6, P] (ro, rd) and inst [W, 12, N] (pos, rot wxyz,
//            scale, obj, mask), channel-major; out [W, 5, P] float32 r, g,
//            b, hit, depth (1e9 at a miss).
//     views  (VIEWS true; render_views, the render node): the views' eye
//            [W, Vc, 3], rot [W, Vc, 4], tan_fov [W, Vc], mask [W, Vc] and
//            the instances' pos [W, N, 3], rot [W, N, 4], scale [W, N, 3],
//            obj [W, N] int32, mask [W, N] bool as the render_pack node
//            leaves them; each pixel's ray is made in the launch, in
//            ops/render_kernel.py camera_rays' order of operations; out
//            RGBA8 [W, V, H, Wpx] (one 32-bit store a pixel) and depth [W,
//            V, H, Wpx] (inf at a miss), 0 / inf on a dead view.
//   The object table [O, S] float32 (ops/render_kernel.py
//   RenderTables.table: prim type, radius, bounding radius, albedo,
//   has-mesh, face count, then F face planes and T triangles) is copied to
//   the card once by the wrapper.
//
//   Work: the pixel rays against the instances that survive the cull.  The
//   bytes bound it when few instances survive a tile (rays mode W (24 P +
//   48 N + 20 P); views mode W (33 V + 45 N + 8 P)); the ray tests (~25
//   operations a sphere, ~45 a plane, 75 + 14 F a hull, 115 + 47 T a mesh)
//   when many do.  chip_smoke.py counts both from the timed state and
//   reports the larger (PERF.md).
//
//   Design: one CTA of kWarps warps per world (rays mode) or per (world,
//   view) (views mode), or `splits` CTAs sharing one, each walking the
//   image's tiles.  The kernel it replaces ran a CTA per 16 x 8 tile, each
//   re-staging and re-culling the whole world behind four block barriers;
//   most of its time was that fixed cost, not ray tests (~3 spheres a
//   pixel survive the cull at simple_taskgraph's main state).  Here the CTA
//   stages the world's live instances once, compacted in index order, with
//   each one's object-table fields (prim, radius, the bounding radius times
//   the largest scale, albedo, has-mesh) in shared memory: the trace loop
//   reads no global memory but a hull's faces and a mesh's triangles.  In
//   views mode every ray starts at the eye, so the staging also culls the
//   instances against the view's cone (its corner rays') and keeps each
//   survivor's pixel-independent terms: its direction and cone angle from
//   the eye, and the sphere test's eye - pos and |eye - pos|^2 - r^2.
//   After the staging's barriers each warp works alone on 8 x 4 pixel
//   tiles: it builds the tile's view cone with shuffles (the JAX kernel's
//   formula: padded rays excluded, the spread of the ray origins added to
//   each bounding radius, every instance kept once the widened cone wraps
//   past a half-space, cos_m <= -cos_b), culls 32 staged instances at a
//   time, one a lane, with a ballot, and traces the survivors of each
//   ballot in index order: every lane tests the same instance at the same
//   time, so the branch on its primitive does not diverge and the
//   shared-memory reads are broadcasts.  Strict < keeps the first instance
//   in index order on a tie of t.
//
//   Past one block's shared memory (a world's instances at kStageViews or
//   kStageRays bytes each pass kMaxSmem: above 2,421 in the views mode and
//   1,614 in the rays mode, where JAX's kernel holds a world tile's
//   instances in VMEM and loops over them in groups of 8) each mode takes
//   its blocked twin, one template (blocked_twin<VIEWS>) designed for the
//   card: CTAs of kVWarps warps, kVCtas an SM, each filling a stage of
//   survivors: the instances from a cursor on, culled against the cone of
//   the CTA's rays, compacted in index order until the stage holds a.B of
//   them; the survivors, not the instances, are what is blocked, so a CTA
//   whose survivors fit one stage has no block loop.  Every warp then
//   traces its tiles against the stage; each pixel's nearest hit so far
//   (t and the winner's index) waits from stage to stage in shared memory,
//   8 bytes a pixel of the CTA's tiles.  Hulls and meshes are tested only
//   where some pixel ray of the tile passes within their bounding sphere
//   widened by 1% plus 0.01 (kRayRel, kRayAbs) and could still beat that
//   pixel's nearest hit (every hit lies past |ro - pos| - R): like the
//   cull, this decides which instances are tested, never a result.
//     views  (render_views_blocked_kernel) views_splits CTAs an image
//            (blockIdx.y; 2 at 64 x 64), the view's cone from its corner
//            rays, stages of views_stage(H, Wpx) (960 at 64 x 64), each
//            warp's tiles split kVWarps + warp, then every splits kVWarps;
//            the hits in the image's outputs past kCarryMax.  (PERF.md: the
//            blocked kernel before it spent a third of a warp's cycles in
//            its staging and was bound by the trace's issue all the same:
//            a fill alone takes 0.10 ms.)
//     rays   (render_rays_blocked_kernel) rays_splits CTAs an image
//            (4 at 64 x 64), each a strip of the image: the tiles numbered
//            in column-major order, consecutive ones a CTA, so that the
//            strips of an image see alike and each CTA's rays span a
//            quarter of its columns (of a camera's or a sweep's rays, the
//            cone of a strip is narrower than the image's).  Before the
//            first stage the CTA reduces the cone of its rays (JAX's tile
//            formula over all of them: their mean direction, the least
//            cosine to it, their origins' mean and spread, the spread added
//            to every bounding radius; where every ray starts at one point
//            bit for bit, that point and no spread, and the sphere test's
//            terms are staged as in the views mode) and builds each of its
//            tiles' cones once, kept in shared memory beside the carried
//            hits (kRTileBytes a tile; at most kRTiles tiles a CTA);
//            stages of rays_stage(its tiles) (1,056 at 64 x 64).  (PERF.md:
//            the blocked kernel before it ran 9 CTAs of 4 warps an image
//            at 64 x 64, each staging every instance in blocks of 512 with
//            every warp's apex terms, and carried hits in the outputs: 2.6x
//            the views twin on the same rays; bands of tile rows left a
//            camera's CTAs unlike, interleaved rows kept every CTA's cone
//            the image's.)
//   A later stage's instance wins only with a strictly smaller t, so ties
//   keep the first instance in index order, as one pass does; the last
//   stage shades the winner, a winner from an earlier one from its rows
//   read again, its normal made as its trace made it.  Images whose
//   instances fit take the single-stage kernels.
//
//   The cull widens each bounding sphere by 0.1% plus 1e-3 so that
//   rounding in the cone test cannot drop an instance a ray hits: the cull
//   only decides which instances are tested, never a result.  The tile
//   shape, the view's cone, the CTAs an image and the mode change which
//   instances survive and nothing else.
//
//   Arithmetic: -fmad=false keeps every product and sum rounded on its
//   own, in the plain version's order (render_plain, camera_rays), and
//   sqrtf and / are the IEEE-rounded ones, so both modes agree bit for bit
//   with their plain versions on the same survivors; the RGBA8 cast
//   truncates, as the node's does.

#include <cuda_runtime.h>
#include <stdint.h>

// Phase markers: empty in the kernel as built; tools/render_ab.py --phases
// defines them to add up each warp's clock64() cycles by phase (no barrier:
// a phase's cycles include the waits on loads an earlier phase issued).
// RK_PHASES: setup stage_loads cone_cull stage_compact tile_setup carried_load
// RK_PHASES: tile_cull trace carried_store shade block_sync ray_cone
#ifndef RK_PHASE
#define RK_PHASE_START
#define RK_PHASE(k)
#define RK_PHASE_END
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileW = 8, kTileH = 4;   // a warp's pixel tile
constexpr float kBig = 1e9f;
constexpr float kEps = 1e-9f;
constexpr float kCullRel = 1e-3f;
constexpr float kCullAbs = 1e-3f;

// object-table columns (ops/render_kernel.py K_*)
constexpr int kPrim = 0, kRadius = 1, kRBound = 2, kAlbedo = 3, kMesh = 6, kNFace = 7;
constexpr int kFixed = 8, kFace = 4, kTri = 13;
constexpr int kSphere = 0, kHull = 1, kPlane = 2;
// instance channels of the rays mode's pack
constexpr int kPos = 0, kRot = 3, kScl = 7, kObj = 10, kMask = 11, kInst = 12;
// a staged instance's code: prim (2 bits), has-mesh, then the object
constexpr int kCodeMesh = 4, kCodeObj = 4;
// shared bytes an instance (ops/render_kernel.py smem_bytes): the rays
// mode's 4 float4s and each warp's apex terms (a float4 and a float), the
// views mode's 6 float4s
constexpr int kStageRays = 4 * 16 + kWarps * 20, kStageViews = 6 * 16;
constexpr size_t kMaxSmem = 232448;
// The blocked twins, which the launch takes when a world's instances do not
// fit kMaxSmem at once (render_views_blocked_kernel,
// render_rays_blocked_kernel): CTAs of kVWarps warps, kVCtas CTAs an SM; a
// CTA's shared memory holds a stage of survivors (kVEntry bytes each: six
// float4s and the index) and each of its pixels' carried hit (t and the
// winner's index, 8 bytes a pixel).  Views: kVSplits CTAs an image (at
// most one a kVWarps tiles), the carried hits in the image's outputs past
// kCarryMax.  Rays: kRSplits CTAs an image (at most one a kVWarps tiles),
// more where a CTA would have more than kRTiles tiles; kRTileBytes a tile
// of the CTA (its cone, a float4, and its pixels' carried hits).  (Four
// strips an image: PERF.md.)
constexpr int kVSplits = 2;
constexpr int kRSplits = 4;
constexpr int kRTiles = 128;
constexpr int kRTileBytes = 16 + 32 * 8;
// the blocked twin's pixel-ray cull of hulls and meshes: the bounding sphere
// widened by 1% plus 0.01, far past the rounding of its test
constexpr float kRayRel = 1e-2f, kRayAbs = 1e-2f;
constexpr int kVWarps = 8;
constexpr int kVThreads = 32 * kVWarps;
constexpr int kVCtas = 2;
constexpr int kVEntry = 6 * 16 + 4;
constexpr int kCarryMax = 65536;
// a CTA's dynamic shared memory at most: an SM's 228 KB shared by kVCtas
// CTAs, 1 KB reserved a CTA and 1 KB left for its static arrays
constexpr int kVSmem = (kVCtas == 1 ? static_cast<int>(kMaxSmem) : 233472 / kVCtas - 1024) - 1024;

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

// butterfly reductions: every lane ends with the same bits (each step adds
// the same two values, in either order)
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

// JAX's tile cone over a warp's rays (those traced: not padded): their
// count, their unit mean direction ax and the least cosine to it, clamped
// to [-1, 1]
__device__ __forceinline__ float ray_cone(bool traced, V3 rd, V3& ax, float& cos_m) {
  const float m = traced ? 1.0f : 0.0f;
  const float count = warp_sum(m);
  const V3 sum = {warp_sum(rd.x * m), warp_sum(rd.y * m), warp_sum(rd.z * m)};
  ax = scale(sum, 1.0f / sqrtf(fmaxf(dot(sum, sum), kEps)));
  cos_m = fminf(fmaxf(warp_min(traced ? dot(rd, ax) : 1.0f), -1.0f), 1.0f);
  return count;
}

// The ray against one instance: its t (kBig on a miss) and, when t beats
// best_t, its unnormalised normal in n.  tb: the object's table row (its
// faces and triangles).
__device__ __forceinline__ float trace(int prim, bool mesh, float radius,
                                       const float* __restrict__ tb, int F, int T, V3 ro,
                                       V3 rd, V3 pos, Q rot, V3 scl, float best_t, V3& n) {
  if (T > 0 && mesh) {
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
    const float rad = radius * scl.x;
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

struct Args {
  // rays mode
  const float* rays;   // [W, 6, P]
  const float* inst;   // [W, 12, N]
  float* out;          // [W, 5, P]
  int P, img_w;
  // views mode
  const float* eye;            // [W, Vc, 3]
  const float* vrot;           // [W, Vc, 4]
  const float* tan_fov;        // [W, Vc]
  const uint8_t* vmask;        // [W, Vc]
  const float* pos;            // [W, N, 3]
  const float* rot;            // [W, N, 4]
  const float* scl;            // [W, N, 3]
  const int32_t* obj;          // [W, N]
  const uint8_t* mask;         // [W, N]
  uint32_t* rgba;              // [W, V, H, Wpx]
  float* depth;                // [W, V, H, Wpx]
  int Vc, V, H, Wpx;
  // both
  const float* table;  // [O, S]
  int O, S, F, T, N, splits;
  float lx, ly, lz, amb, one_m_amb;
  // the blocked specialisations: the instances staged at a time
  int B;
};

// the RGBA8 channel of x: clamp to [0, 1], times 255, truncated
__device__ __forceinline__ uint32_t to_u8(float x) {
  return static_cast<uint32_t>(fminf(fmaxf(x, 0.0f), 1.0f) * 255.0f);
}

// ops/render_kernel.py camera_rays for pixel (row, col) of an H x Wpx view
// with rotation q and tan_fov tanf, operation for operation
__device__ __forceinline__ V3 camera_ray(int row, int col, int H, int Wpx, Q q, float tanf) {
  const float px = (static_cast<float>(col) + 0.5f) / static_cast<float>(Wpx) * 2.0f - 1.0f;
  const float py = -((static_cast<float>(row) + 0.5f) / static_cast<float>(H) * 2.0f - 1.0f);
  const V3 dc = {px * tanf, 1.0f, py * tanf};
  const V3 u = {q.x, q.y, q.z};
  const V3 uv = cross(u, dc);
  const V3 uuv = cross(u, uv);
  const V3 d = {dc.x + 2.0f * (q.w * uv.x + uuv.x), dc.y + 2.0f * (q.w * uv.y + uuv.y),
                dc.z + 2.0f * (q.w * uv.z + uuv.z)};
  const float nrm = sqrtf(dot(d, d));
  return {d.x / nrm, d.y / nrm, d.z / nrm};
}

// The cone test of the JAX kernel's cull: does a bounding sphere (centre
// at d from the cone's apex, length dist, widened radius r_eff) meet the
// cone (unit axis ax, cos_m, sin_m)?  Every instance is kept once the cone
// wraps past a half-space.
__device__ __forceinline__ bool meets_cone(V3 d, float r_eff, V3 ax, float cos_m, float sin_m) {
  const float dist = sqrtf(fmaxf(dot(d, d), kEps));
  const float cos_ad = dot(d, ax) / dist;
  const float sin_b = fminf(fmaxf(r_eff / dist, 0.0f), 1.0f);
  const float cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
  return cos_m <= -cos_b || cos_ad >= cos_m * cos_b - sin_m * sin_b || dist <= r_eff;
}

// The cull's terms for a staged instance when every ray of a tile starts at
// the apex o (the spread 0): (pos - o) / |pos - o| and cos_b, with sin_b
// in sin_b; cos_b = -2 (and sin_b 0) keeps the instance whatever the cone
// (a plane, or o inside its widened sphere).
__device__ __forceinline__ float4 apex_terms(V3 p, float rbs, bool plane, V3 o, float& sin_b) {
  const float r_eff = rbs * (1.0f + kCullRel) + kCullAbs;
  const V3 d = sub(p, o);
  const float dist = sqrtf(fmaxf(dot(d, d), kEps));
  sin_b = fminf(fmaxf(r_eff / dist, 0.0f), 1.0f);
  float cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
  if (plane || dist <= r_eff) {
    cos_b = -2.0f;
    sin_b = 0.0f;
  }
  return make_float4(d.x / dist, d.y / dist, d.z / dist, cos_b);
}

// The instance that won a pixel in an earlier stage (the blocked twins):
// its normal and albedo, from its rows read again, as the trace and the
// shading of its own stage made them (a sphere without a mesh: the hit point less its
// centre; else the trace's normal).
__device__ __forceinline__ void earlier_winner(const Args& a, bool views, int w, int gid, V3 ro,
                                               V3 rd, float best_t, V3& n, V3& alb) {
  V3 p, s;
  Q q;
  int o;
  if (views) {
    const size_t r = static_cast<size_t>(w) * a.N + gid;
    p = {a.pos[r * 3], a.pos[r * 3 + 1], a.pos[r * 3 + 2]};
    q = {a.rot[r * 4], a.rot[r * 4 + 1], a.rot[r * 4 + 2], a.rot[r * 4 + 3]};
    s = {a.scl[r * 3], a.scl[r * 3 + 1], a.scl[r * 3 + 2]};
    o = a.obj[r];
  } else {
    const int N = a.N;
    const float* src = a.inst + static_cast<size_t>(w) * kInst * N + gid;
    p = {src[kPos * N], src[(kPos + 1) * N], src[(kPos + 2) * N]};
    q = {src[kRot * N], src[(kRot + 1) * N], src[(kRot + 2) * N], src[(kRot + 3) * N]};
    s = {src[kScl * N], src[(kScl + 1) * N], src[(kScl + 2) * N]};
    o = static_cast<int>(src[kObj * N]);
  }
  const float* tb = a.table + static_cast<size_t>(o) * a.S;
  const int prim = static_cast<int>(__ldg(tb + kPrim));
  const bool mesh = __ldg(tb + kMesh) > 0.5f && a.T > 0;
  alb = {__ldg(tb + kAlbedo), __ldg(tb + kAlbedo + 1), __ldg(tb + kAlbedo + 2)};
  if (!mesh && prim == kSphere) {
    n = sub(add(ro, scale(rd, best_t)), p);
  } else {
    n = {0.0f, 0.0f, 0.0f};
    trace(prim, mesh, __ldg(tb + kRadius), tb, a.F, a.T, ro, rd, p, q, s, kBig, n);
  }
}

// Every instance of the world staged at once (a.N): the single-stage
// kernel, taken where the mode's staged bytes fit kMaxSmem.
template <bool VIEWS>
__global__ void __launch_bounds__(kThreads) render_kernel(const Args a) {
  extern __shared__ float4 smem[];
  const int N = a.N;
  // the world's live instances, compacted in index order (in views mode
  // those the view's cone can meet): kStageRays (kStageViews) bytes each
  float4* s_pos = smem;         // pos xyz; rays: bounding radius x largest scale,
                                //   views: sin_b of the instance against the eye
  float4* s_rot = s_pos + N;    // rot wxyz
  float4* s_scl = s_rot + N;    // scale xyz, radius
  float4* s_alb = s_scl + N;    // albedo rgb, code (int bits)
  float4* s_sph = s_alb + N;    // views: eye - pos, the sphere test's |eye - pos|^2 - r^2
  float4* s_cone = s_sph + N;   // views: apex_terms from the eye
  __shared__ int s_count[kWarps];
  RK_PHASE_START

  const int w = VIEWS ? blockIdx.x / a.V : blockIdx.x;
  const int v = VIEWS ? blockIdx.x % a.V : 0;
  const int rows = VIEWS ? a.H : (a.P + a.img_w - 1) / a.img_w;
  const int cols = VIEWS ? a.Wpx : a.img_w;
  const int tiles_x = (cols + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((rows + kTileH - 1) / kTileH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // rays mode: each warp's apex_terms from the last apex its tiles had
  float4* s_apex = s_alb + N + warp * N;
  float* s_apex_sin = reinterpret_cast<float*>(s_alb + N + kWarps * N) + warp * N;

  V3 eye = {0.0f, 0.0f, 0.0f}, view_ax = {0.0f, 0.0f, 0.0f};
  Q vq = {1.0f, 0.0f, 0.0f, 0.0f};
  float tanf = 0.0f, cos_v = -1.0f, sin_v = 0.0f;
  size_t img = 0;   // views: the first pixel of this (world, view)
  if (VIEWS) {
    const int view = w * a.Vc + v;
    img = static_cast<size_t>(blockIdx.x) * a.H * a.Wpx;
    if (a.vmask[view] == 0) {   // a dead view: black, depth inf
      const int npx = a.H * a.Wpx;
      for (int p = blockIdx.y * kThreads + threadIdx.x; p < npx; p += a.splits * kThreads) {
        a.rgba[img + p] = 0u;
        a.depth[img + p] = __int_as_float(0x7f800000);
      }
      return;
    }
    eye = {a.eye[view * 3], a.eye[view * 3 + 1], a.eye[view * 3 + 2]};
    vq = {a.vrot[view * 4], a.vrot[view * 4 + 1], a.vrot[view * 4 + 2], a.vrot[view * 4 + 3]};
    tanf = a.tan_fov[view];
    // the view's cone: its corner pixels' rays bound every ray of the view
    // (a pinhole's rays fill the convex hull of its corners), so the cap
    // about their mean that holds the four holds them all while it is
    // narrower than a half-space
    const V3 c0 = camera_ray(0, 0, a.H, a.Wpx, vq, tanf);
    const V3 c1 = camera_ray(0, a.Wpx - 1, a.H, a.Wpx, vq, tanf);
    const V3 c2 = camera_ray(a.H - 1, 0, a.H, a.Wpx, vq, tanf);
    const V3 c3 = camera_ray(a.H - 1, a.Wpx - 1, a.H, a.Wpx, vq, tanf);
    const V3 sum = add(add(c0, c1), add(c2, c3));
    view_ax = scale(sum, 1.0f / sqrtf(fmaxf(dot(sum, sum), kEps)));
    cos_v = fminf(fminf(dot(c0, view_ax), dot(c1, view_ax)),
                  fminf(dot(c2, view_ax), dot(c3, view_ax)));
    if (!(cos_v > 0.0f)) cos_v = -1.0f;   // wider than a half-space (or NaN): keep all
    sin_v = sqrtf(fmaxf(1.0f - cos_v * cos_v, 0.0f));
  }
  RK_PHASE(0);

  // stage the world's live instances with their object-table fields,
  // compacted in index order
  int M = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + threadIdx.x;
    V3 p = {0.0f, 0.0f, 0.0f}, s = {1.0f, 1.0f, 1.0f};
    Q q = {1.0f, 0.0f, 0.0f, 0.0f};
    int o = 0;
    bool keep = false;
    if (i < N) {
      if (VIEWS) {
        const size_t r = static_cast<size_t>(w) * N + i;
        p = {a.pos[r * 3], a.pos[r * 3 + 1], a.pos[r * 3 + 2]};
        q = {a.rot[r * 4], a.rot[r * 4 + 1], a.rot[r * 4 + 2], a.rot[r * 4 + 3]};
        s = {a.scl[r * 3], a.scl[r * 3 + 1], a.scl[r * 3 + 2]};
        o = a.obj[r];
        keep = a.mask[r] != 0 && o >= 0 && o < a.O;
      } else {
        const float* src = a.inst + static_cast<size_t>(w) * kInst * N + i;
        p = {src[kPos * N], src[(kPos + 1) * N], src[(kPos + 2) * N]};
        q = {src[kRot * N], src[(kRot + 1) * N], src[(kRot + 2) * N], src[(kRot + 3) * N]};
        s = {src[kScl * N], src[(kScl + 1) * N], src[(kScl + 2) * N]};
        const float objf = src[kObj * N];
        o = static_cast<int>(objf);
        keep = src[kMask * N] > 0.5f && static_cast<float>(o) == objf && o >= 0 && o < a.O;
      }
    }
    if (!keep) o = 0;
    const float* tb = a.table + static_cast<size_t>(o) * a.S;
    const int prim = static_cast<int>(__ldg(tb + kPrim));
    const float radius = __ldg(tb + kRadius);
    const float rbs = __ldg(tb + kRBound) * fmaxf(fmaxf(s.x, s.y), s.z);
    RK_PHASE(1);
    float4 sph = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cone = sph;
    float sin_b = 0.0f;
    if (VIEWS && keep) {
      // the terms that do not depend on the pixel: every ray of the view
      // starts at the eye (the origins' spread is 0)
      cone = apex_terms(p, rbs, prim == kPlane, eye, sin_b);
      keep = cone.w < -1.5f ||
             meets_cone(sub(p, eye), rbs * (1.0f + kCullRel) + kCullAbs, view_ax, cos_v, sin_v);
      const V3 oc = sub(eye, p);
      const float rad = radius * s.x;
      sph = make_float4(oc.x, oc.y, oc.z, dot(oc, oc) - rad * rad);
    }
    RK_PHASE(2);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = M, chunk = 0;
    for (int j = 0; j < kWarps; ++j) {
      slot += j < warp ? s_count[j] : 0;
      chunk += s_count[j];
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      const int code = (o << kCodeObj) | (__ldg(tb + kMesh) > 0.5f ? kCodeMesh : 0) | prim;
      s_pos[slot] = make_float4(p.x, p.y, p.z, VIEWS ? sin_b : rbs);
      s_rot[slot] = make_float4(q.w, q.x, q.y, q.z);
      s_scl[slot] = make_float4(s.x, s.y, s.z, radius);
      s_alb[slot] = make_float4(__ldg(tb + kAlbedo), __ldg(tb + kAlbedo + 1),
                                __ldg(tb + kAlbedo + 2), __int_as_float(code));
      if (VIEWS) {
        s_sph[slot] = sph;
        s_cone[slot] = cone;
      }
    }
    M += chunk;
    __syncthreads();
    RK_PHASE(3);
  }

  // trace every tile of the CTA against the staged instances
  V3 apex = {0.0f, 0.0f, 0.0f};   // rays mode: the apex of s_apex (none yet)
  bool apex_ok = false;
  for (int tile = blockIdx.y * kWarps + warp; tile < tiles; tile += a.splits * kWarps) {
    const int row = (tile / tiles_x) * kTileH + lane / kTileW;
    const int col = (tile % tiles_x) * kTileW + lane % kTileW;
    bool valid;
    int p = 0;
    V3 ro = {0.0f, 0.0f, 0.0f}, rd = {0.0f, 0.0f, 0.0f};
    if (VIEWS) {
      valid = row < a.H && col < a.Wpx;
      ro = eye;
      rd = camera_ray(row, col, a.H, a.Wpx, vq, tanf);
    } else {
      p = row * a.img_w + col;
      valid = col < a.img_w && p < a.P;
      if (valid) {
        const float* r = a.rays + static_cast<size_t>(w) * 6 * a.P + p;
        ro = {r[0], r[a.P], r[2 * a.P]};
        rd = {r[3 * a.P], r[4 * a.P], r[5 * a.P]};
      }
    }
    const bool pad = !valid || !(dot(rd, rd) >= 0.5f);

    // the tile's view cone: axis = the mean direction of its rays, cos_m =
    // the least cosine to it; the origins' mean and spread.  In views mode
    // the tile's rays are a pinhole's over a rectangle of pixels, so the
    // cap about its corner rays that holds the four holds them all (the
    // view's cone, per tile): one round of shuffles, not ten
    float count, cos_m;
    V3 ax;
    if (VIEWS) {
      count = __ballot_sync(0xffffffffu, !pad) != 0u ? 1.0f : 0.0f;
      const int r0 = (tile / tiles_x) * kTileH, c0 = (tile % tiles_x) * kTileW;
      const int cl = min(kTileW, a.Wpx - c0) - 1, rl = (min(kTileH, a.H - r0) - 1) * kTileW;
      V3 k[4];
      const int src[4] = {0, cl, rl, rl + cl};
      for (int c = 0; c < 4; ++c)
        k[c] = {__shfl_sync(0xffffffffu, rd.x, src[c]), __shfl_sync(0xffffffffu, rd.y, src[c]),
                __shfl_sync(0xffffffffu, rd.z, src[c])};
      const V3 sum = add(add(k[0], k[1]), add(k[2], k[3]));
      ax = scale(sum, 1.0f / sqrtf(fmaxf(dot(sum, sum), kEps)));
      cos_m = fminf(fminf(dot(k[0], ax), dot(k[1], ax)), fminf(dot(k[2], ax), dot(k[3], ax)));
      cos_m = cos_m > 0.0f ? fminf(cos_m, 1.0f) : -1.0f;   // wider (or NaN): keep all
    } else {
      count = ray_cone(!pad, rd, ax, cos_m);
    }
    const float sin_m = sqrtf(fmaxf(1.0f - cos_m * cos_m, 0.0f));
    V3 ro_mean = eye;
    float spread = 0.0f;
    if (!VIEWS) {
      const float m = pad ? 0.0f : 1.0f;
      const float inv_cnt = 1.0f / fmaxf(count, 1.0f);
      ro_mean = {warp_sum(ro.x * m) * inv_cnt, warp_sum(ro.y * m) * inv_cnt,
                 warp_sum(ro.z * m) * inv_cnt};
      const V3 dro = sub(ro, ro_mean);
      spread = sqrtf(warp_max(pad ? 0.0f : dot(dro, dro)));
    }
    // rays mode, every ray of the tile from one apex (a camera's): the
    // cull's per-instance terms are the last tile's when its apex was the
    // same, else computed once for the tiles that follow
    const bool at_apex = !VIEWS && spread == 0.0f && count > 0.0f;
    if (at_apex && !(apex_ok && apex.x == ro_mean.x && apex.y == ro_mean.y &&
                     apex.z == ro_mean.z)) {
      for (int j = lane; j < M; j += 32) {
        const float4 ps = s_pos[j];
        s_apex[j] = apex_terms({ps.x, ps.y, ps.z}, ps.w,
                               (__float_as_int(s_alb[j].w) & 3) == kPlane, ro_mean,
                               s_apex_sin[j]);
      }
      __syncwarp();
      apex = ro_mean;
      apex_ok = true;
    }

    float best_t = kBig;
    V3 best_n = {0.0f, 0.0f, 0.0f}, best_a = {0.0f, 0.0f, 0.0f};
    int best_k = -1;            // the winner's staged index
    bool best_sphere = false;   // views mode: its normal is still to make
    RK_PHASE(4);
    for (int base = 0; count > 0.0f && base < M; base += 32) {
      const int i = base + lane;
      bool keep = false;
      if (i < M) {
        const float4 ps = s_pos[i];
        if (VIEWS) {
          const float4 c = s_cone[i];
          keep = cos_m <= -c.w ||
                 dot({c.x, c.y, c.z}, ax) >= cos_m * c.w - sin_m * ps.w;
        } else if (at_apex) {
          const float4 c = s_apex[i];
          keep = cos_m <= -c.w ||
                 dot({c.x, c.y, c.z}, ax) >= cos_m * c.w - sin_m * s_apex_sin[i];
        } else {
          keep = (__float_as_int(s_alb[i].w) & 3) == kPlane ||
                 meets_cone(sub({ps.x, ps.y, ps.z}, ro_mean),
                            (ps.w + spread) * (1.0f + kCullRel) + kCullAbs, ax, cos_m, sin_m);
        }
      }
      unsigned bits = __ballot_sync(0xffffffffu, keep);
      // views mode: the staged spheres without a mesh, whose test is the
      // short one below
      const unsigned spheres =
          VIEWS ? __ballot_sync(0xffffffffu, i < M && (__float_as_int(s_alb[i].w) &
                                                       (kCodeMesh | 3)) == kSphere)
                : 0u;
      RK_PHASE(6);
      if (pad) continue;
      // the sphere test with the view's terms staged (oc = eye - pos, c =
      // |oc|^2 - r^2): trace's sphere branch, value for value; its normal
      // waits for the shading, from the winner's t and pos
      auto sphere_t = [&](int k) {
        const float4 sp = s_sph[k];
        const float b = dot({sp.x, sp.y, sp.z}, rd);
        const float disc = b * b - sp.w;
        const float ts = -b - sqrtf(fmaxf(disc, 0.0f));
        return (disc >= 0.0f && ts > 1e-4f) ? ts : kBig;
      };
      auto take_sphere = [&](float t, int k) {
        if (t < best_t) {
          best_t = t;
          best_k = k;
          best_sphere = true;
        }
      };
      while (bits) {
        const int j = __ffs(bits) - 1;
        const unsigned rest = bits & (bits - 1u);
        const int j2 = __ffs(rest) - 1;
        if (VIEWS && ((spheres >> j) & 1u) && rest && ((spheres >> j2) & 1u)) {
          // two spheres in a row: both tests at once, taken in index order
          const float t = sphere_t(base + j), t2 = sphere_t(base + j2);
          take_sphere(t, base + j);
          take_sphere(t2, base + j2);
          bits = rest & (rest - 1u);
          continue;
        }
        bits = rest;
        const int k = base + j;
        if (VIEWS && ((spheres >> j) & 1u)) {
          take_sphere(sphere_t(k), k);
          continue;
        }
        const int code = __float_as_int(s_alb[k].w);
        const int prim = code & 3;
        const bool mesh = (code & kCodeMesh) != 0 && a.T > 0;
        const float4 ps = s_pos[k], qr = s_rot[k], sr = s_scl[k];
        const float* tb = a.table + static_cast<size_t>(code >> kCodeObj) * a.S;
        V3 n = best_n;
        const float t = trace(prim, mesh, sr.w, tb, a.F, a.T, ro, rd, {ps.x, ps.y, ps.z},
                              {qr.x, qr.y, qr.z, qr.w}, {sr.x, sr.y, sr.z}, best_t, n);
        if (t < best_t) {
          best_t = t;
          best_n = n;
          best_k = k;
          best_sphere = false;
        }
      }
      RK_PHASE(7);
    }
    if (best_k >= 0) {
      const float4 al = s_alb[best_k];
      best_a = {al.x, al.y, al.z};
      if (VIEWS && best_sphere) {
        const float4 ps = s_pos[best_k];
        best_n = sub(add(ro, scale(rd, best_t)), {ps.x, ps.y, ps.z});
      }
    }

    if (valid) {
      // shade: Lambert plus ambient
      const bool hit = !pad && best_t < kBig * 0.5f;
      const float inv_len = 1.0f / sqrtf(fmaxf(dot(best_n, best_n), kEps));
      const V3 nn = scale(best_n, inv_len);
      const float lam = fmaxf(nn.x * a.lx + nn.y * a.ly + nn.z * a.lz, 0.0f);
      const float shade = a.amb + a.one_m_amb * lam;
      const float hitf = hit ? 1.0f : 0.0f;
      const float r = pad ? 0.0f : best_a.x * shade * hitf;
      const float g = pad ? 0.0f : best_a.y * shade * hitf;
      const float b = pad ? 0.0f : best_a.z * shade * hitf;
      if (VIEWS) {
        const size_t o = img + static_cast<size_t>(row) * a.Wpx + col;
        a.rgba[o] = to_u8(r) | (to_u8(g) << 8) | (to_u8(b) << 16) | ((hit ? 255u : 0u) << 24);
        a.depth[o] = hit ? best_t : __int_as_float(0x7f800000);
      } else {
        float* o = a.out + static_cast<size_t>(w) * 5 * a.P + p;
        o[0] = r;
        o[a.P] = g;
        o[2 * a.P] = b;
        o[3 * a.P] = hitf;
        o[4 * a.P] = hit ? best_t : kBig;
      }
    }
    RK_PHASE(9);
  }
  RK_PHASE_END
}

// The views mode's blocked twin's layout for an H x Wpx image: its CTAs an
// image; a CTA's carried hits' bytes in shared memory (8 a pixel of its
// tiles; 0: they wait in the image's outputs); the survivors a stage
// holds; and the dynamic shared memory.
__host__ __device__ inline int views_splits(int H, int Wpx) {
  const int tiles = ((Wpx + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  const int most = (tiles + kVWarps - 1) / kVWarps;
  return most < kVSplits ? most : kVSplits;
}

__host__ __device__ inline int views_carry_bytes(int H, int Wpx) {
  const int tiles = ((Wpx + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  const int group = views_splits(H, Wpx) * kVWarps;
  const long long bytes = 8LL * 32 * kVWarps * ((tiles + group - 1) / group);
  return bytes <= kCarryMax ? static_cast<int>(bytes) : 0;
}

__host__ __device__ inline int views_stage(int H, int Wpx) {
  return (kVSmem - views_carry_bytes(H, Wpx)) / kVEntry / 32 * 32;
}

size_t views_blocked_smem(int stage, int H, int Wpx) {
  return static_cast<size_t>(stage) * kVEntry + views_carry_bytes(H, Wpx);
}

// The rays mode's blocked twin's layout: the 8 x 4 tiles of P rays in rows
// of img_w; its CTAs an image of that many tiles (rays_splits: kRSplits, at
// most one a kVWarps tiles, at least enough that a CTA has kRTiles tiles at
// most); a CTA's tiles (consecutive ones in column-major order); the
// survivors a stage holds beside a CTA's tiles' cones and carried hits
// (kRTileBytes a tile); and the dynamic shared memory.
__host__ __device__ inline int ray_tiles(int P, int img_w) {
  const int rows = (P + img_w - 1) / img_w;
  return ((img_w + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH);
}

__host__ __device__ inline int rays_splits(int tiles) {
  const int most = (tiles + kVWarps - 1) / kVWarps;
  const int fit = (tiles + kRTiles - 1) / kRTiles;
  const int splits = most < kRSplits ? most : kRSplits;
  return splits > fit ? splits : fit;
}

__host__ __device__ inline int rays_cta_tiles(int tiles, int splits) {
  return (tiles + splits - 1) / splits;
}

__host__ __device__ inline int rays_stage(int cta_tiles) {
  return (kVSmem - kRTileBytes * cta_tiles) / kVEntry / 32 * 32;
}

size_t rays_blocked_smem(int stage, int cta_tiles) {
  return static_cast<size_t>(stage) * kVEntry + static_cast<size_t>(kRTileBytes) * cta_tiles;
}

// The blocked twins past one block's shared memory (see the notes at the
// top): a.splits CTAs an image (blockIdx.y), each through stages of at
// most a.B survivors, each filled by culling the instances from a cursor
// on against the cone of the CTA's rays (views: the view's cone, the
// single-stage kernel's staging cull, value for value) and compacting them
// in index order until the stage is full; then every warp traces its
// tiles against the stage, each pixel's nearest hit so far carried from
// stage to stage in shared memory (or, for a large view, in its outputs).
// A later stage's instance wins only with a strictly smaller t, so a tie
// keeps the first instance in index order; the last stage shades, a winner
// from an earlier stage from its rows read again.
//
// VIEWS: the rays start at the view's eye (camera_ray), the warps take
// tiles split kVWarps + warp + splits kVWarps j.  Rays mode: the tiles are
// numbered in column-major order, the CTA owns tiles [split cta_tiles,
// ...) (a strip of the image), warp + kVWarps j of them; its cone is
// JAX's tile formula over all its rays (their mean direction, the least
// cosine to it, the origins' spread about their mean added to each
// bounding radius; the common origin and no spread where every ray starts
// at one point bit for bit), reduced across the block, and each tile's
// cone is built once, before the first stage.
template <bool VIEWS>
__device__ __forceinline__ void blocked_twin(const Args& a) {
  extern __shared__ float4 smem[];
  const int N = a.N, C = a.B;
  float4* s_pos = smem;         // pos xyz, sin_b of the instance against the apex
  float4* s_rot = s_pos + C;    // rot wxyz
  float4* s_scl = s_rot + C;    // scale xyz, radius
  float4* s_alb = s_scl + C;    // albedo rgb, code (int bits)
  float4* s_sph = s_alb + C;    // apex - pos, the sphere test's |apex - pos|^2 - r^2
  float4* s_cone = s_sph + C;   // apex_terms from the apex
  int* s_gid = reinterpret_cast<int*>(s_cone + C);
  float* s_ct = reinterpret_cast<float*>(s_gid + C);   // carried t, a pixel
  __shared__ int s_count[kVWarps];
  __shared__ int s_next;
  RK_PHASE_START

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.y;
  // the CTA's tiles: tile0, tile0 + tile_step, ... below tile_end
  int w, tiles_x, tiles_y = 0, tiles, npx = 0, carry_px, tile0, tile_end, tile_step;
  size_t img = 0;
  V3 eye, view_ax;
  Q vq = {1.0f, 0.0f, 0.0f, 0.0f};
  float tanf = 0.0f, cos_v, sin_v;
  float* ct;
  uint32_t* cid;
  float4* s_tile = nullptr;   // rays: each of the CTA's tiles' cone (ax, cos_m)
  bool one_origin = false;    // rays: every ray of the CTA starts at eye, bit for bit
  float spread = 0.0f;        // rays: the origins' spread about eye
  int cursor = 0;
  if constexpr (VIEWS) {
    w = blockIdx.x / a.V;
    const int v = blockIdx.x % a.V;
    const int view = w * a.Vc + v;
    npx = a.H * a.Wpx;
    img = static_cast<size_t>(blockIdx.x) * npx;
    tiles_x = (a.Wpx + kTileW - 1) / kTileW;
    tiles = tiles_x * ((a.H + kTileH - 1) / kTileH);
    tile0 = split * kVWarps + warp;
    tile_end = tiles;
    tile_step = a.splits * kVWarps;
    if (a.vmask[view] == 0) {   // a dead view: black, depth inf
      for (int p = split * kVThreads + threadIdx.x; p < npx; p += a.splits * kVThreads) {
        a.rgba[img + p] = 0u;
        a.depth[img + p] = __int_as_float(0x7f800000);
      }
      return;
    }
    eye = {a.eye[view * 3], a.eye[view * 3 + 1], a.eye[view * 3 + 2]};
    vq = {a.vrot[view * 4], a.vrot[view * 4 + 1], a.vrot[view * 4 + 2], a.vrot[view * 4 + 3]};
    tanf = a.tan_fov[view];
    // the view's cone, as the single-stage kernel makes it
    const V3 c0 = camera_ray(0, 0, a.H, a.Wpx, vq, tanf);
    const V3 c1 = camera_ray(0, a.Wpx - 1, a.H, a.Wpx, vq, tanf);
    const V3 c2 = camera_ray(a.H - 1, 0, a.H, a.Wpx, vq, tanf);
    const V3 c3 = camera_ray(a.H - 1, a.Wpx - 1, a.H, a.Wpx, vq, tanf);
    const V3 csum = add(add(c0, c1), add(c2, c3));
    view_ax = scale(csum, 1.0f / sqrtf(fmaxf(dot(csum, csum), kEps)));
    cos_v = fminf(fminf(dot(c0, view_ax), dot(c1, view_ax)),
                  fminf(dot(c2, view_ax), dot(c3, view_ax)));
    if (!(cos_v > 0.0f)) cos_v = -1.0f;   // wider than a half-space (or NaN): keep all
    sin_v = sqrtf(fmaxf(1.0f - cos_v * cos_v, 0.0f));
    // each pixel's hit so far: t and the winner's index (-1 for none yet),
    // in shared memory at the pixel's slot among this CTA's tiles, or in the
    // image's outputs at the pixel
    carry_px = views_carry_bytes(a.H, a.Wpx) / 8;
    ct = carry_px > 0 ? s_ct : a.depth + img;
    cid = carry_px > 0 ? reinterpret_cast<uint32_t*>(s_ct + carry_px) : a.rgba + img;
  } else {
    w = blockIdx.x;
    tiles_x = (a.img_w + kTileW - 1) / kTileW;
    tiles_y = ((a.P + a.img_w - 1) / a.img_w + kTileH - 1) / kTileH;
    tiles = ray_tiles(a.P, a.img_w);
    const int cta_tiles = rays_cta_tiles(tiles, a.splits);
    const int t0 = split * cta_tiles;
    const int nt = min(cta_tiles, tiles - t0);   // the CTA's strip of tiles
    if (nt <= 0) return;
    tile0 = t0 + warp;
    tile_end = t0 + nt;
    tile_step = kVWarps;
    // after the stage: the tiles' cones, then each pixel's hit so far (t,
    // the winner's index) at its slot among the CTA's tiles
    s_tile = reinterpret_cast<float4*>(s_gid + C);
    carry_px = 32 * cta_tiles;
    ct = reinterpret_cast<float*>(s_tile + cta_tiles);
    cid = reinterpret_cast<uint32_t*>(ct + carry_px);
    // a CTA's ray (tile lt of the CTA, this lane's pixel): ro, rd, and
    // whether it is traced (a pixel of the image with |rd|^2 >= 0.5)
    auto ray = [&](int lt, V3& ro, V3& rd) {
      const int tile = t0 + lt;   // column-major
      const int row = (tile % tiles_y) * kTileH + lane / kTileW;
      const int col = (tile / tiles_y) * kTileW + lane % kTileW;
      const int p = row * a.img_w + col;
      ro = rd = {0.0f, 0.0f, 0.0f};
      if (col < a.img_w && p < a.P) {
        const float* r = a.rays + static_cast<size_t>(w) * 6 * a.P + p;
        ro = {r[0], r[a.P], r[2 * a.P]};
        rd = {r[3 * a.P], r[4 * a.P], r[5 * a.P]};
      }
      return dot(rd, rd) >= 0.5f;
    };
    // the cone of the CTA's rays, reduced across the block: first the
    // count, the sums of rd and ro, and each origin coordinate's least and
    // greatest bits (equal where every ray starts at one point)
    float* red = reinterpret_cast<float*>(s_pos);   // the warps' partials
    float cnt = 0.0f;
    V3 sd = {0.0f, 0.0f, 0.0f}, so = {0.0f, 0.0f, 0.0f};
    int lo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff}, hi[3] = {-0x7fffffff - 1, -0x7fffffff - 1,
                                                                -0x7fffffff - 1};
    for (int lt = warp; lt < nt; lt += kVWarps) {
      V3 ro, rd;
      if (ray(lt, ro, rd)) {
        cnt += 1.0f;
        sd = add(sd, rd);
        so = add(so, ro);
        const int b[3] = {__float_as_int(ro.x), __float_as_int(ro.y), __float_as_int(ro.z)};
        for (int c = 0; c < 3; ++c) {
          lo[c] = min(lo[c], b[c]);
          hi[c] = max(hi[c], b[c]);
        }
      }
    }
    cnt = warp_sum(cnt);
    sd = {warp_sum(sd.x), warp_sum(sd.y), warp_sum(sd.z)};
    so = {warp_sum(so.x), warp_sum(so.y), warp_sum(so.z)};
    for (int c = 0; c < 3; ++c) {
      lo[c] = __reduce_min_sync(0xffffffffu, lo[c]);
      hi[c] = __reduce_max_sync(0xffffffffu, hi[c]);
    }
    if (lane == 0) {
      float* r = red + warp * 16;
      r[0] = cnt;
      r[1] = sd.x, r[2] = sd.y, r[3] = sd.z;
      r[4] = so.x, r[5] = so.y, r[6] = so.z;
      for (int c = 0; c < 3; ++c) {
        r[7 + c] = __int_as_float(lo[c]);
        r[10 + c] = __int_as_float(hi[c]);
      }
    }
    __syncthreads();
    cnt = 0.0f;
    sd = so = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < kVWarps; ++k) {   // every thread sums the warps in order
      const float* r = red + k * 16;
      cnt += r[0];
      sd = add(sd, {r[1], r[2], r[3]});
      so = add(so, {r[4], r[5], r[6]});
      for (int c = 0; c < 3; ++c) {
        lo[c] = min(lo[c], __float_as_int(r[7 + c]));
        hi[c] = max(hi[c], __float_as_int(r[10 + c]));
      }
    }
    view_ax = scale(sd, 1.0f / sqrtf(fmaxf(dot(sd, sd), kEps)));
    one_origin = cnt > 0.0f && lo[0] == hi[0] && lo[1] == hi[1] && lo[2] == hi[2];
    const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
    eye = one_origin ? V3{__int_as_float(lo[0]), __int_as_float(lo[1]), __int_as_float(lo[2])}
                     : scale(so, inv_cnt);
    // then the least cosine to the axis and the origins' greatest distance
    // from eye; and each tile's own cone (JAX's formula over its rays, as
    // the single-stage kernel builds it), kept for every stage
    float cmin = 1.0f, d2 = 0.0f;
    for (int lt = warp; lt < nt; lt += kVWarps) {
      V3 ro, rd;
      const bool traced = ray(lt, ro, rd);
      cmin = fminf(cmin, traced ? dot(rd, view_ax) : 1.0f);
      const V3 dro = sub(ro, eye);
      d2 = fmaxf(d2, traced ? dot(dro, dro) : 0.0f);
      V3 ax;
      float cos_m;
      const float count = ray_cone(traced, rd, ax, cos_m);
      if (lane == 0) s_tile[lt] = make_float4(ax.x, ax.y, ax.z, count > 0.0f ? cos_m : 2.0f);
    }
    cmin = warp_min(cmin);
    d2 = warp_max(d2);
    __syncthreads();   // every thread has read the first partials
    if (lane == 0) {
      red[warp * 2] = cmin;
      red[warp * 2 + 1] = d2;
    }
    __syncthreads();
    for (int k = 0; k < kVWarps; ++k) {
      cmin = fminf(cmin, red[k * 2]);
      d2 = fmaxf(d2, red[k * 2 + 1]);
    }
    cos_v = fminf(fmaxf(cmin, -1.0f), 1.0f);
    sin_v = sqrtf(fmaxf(1.0f - cos_v * cos_v, 0.0f));
    spread = one_origin ? 0.0f : sqrtf(d2);
    if (cnt == 0.0f) cursor = N;   // no ray to trace: every pixel a miss
    __syncthreads();   // the partials are read before the stage overwrites them
    RK_PHASE(11);
  }
  RK_PHASE(0);

  for (bool first = true;; first = false) {
    // fill the stage: the instances from the cursor on, kVThreads at a
    // time, culled against the CTA's cone and compacted in index order
    // until the stage is full (the cursor then at the first survivor left
    // out) or every instance is culled
    int M = 0;
    while (cursor < N && M < C) {
      const int i = cursor + threadIdx.x;
      V3 p = {0.0f, 0.0f, 0.0f}, s = {1.0f, 1.0f, 1.0f};
      Q q = {1.0f, 0.0f, 0.0f, 0.0f};
      int o = 0;
      bool keep = false;
      if (i < N) {
        if constexpr (VIEWS) {
          const size_t r = static_cast<size_t>(w) * N + i;
          p = {a.pos[r * 3], a.pos[r * 3 + 1], a.pos[r * 3 + 2]};
          q = {a.rot[r * 4], a.rot[r * 4 + 1], a.rot[r * 4 + 2], a.rot[r * 4 + 3]};
          s = {a.scl[r * 3], a.scl[r * 3 + 1], a.scl[r * 3 + 2]};
          o = a.obj[r];
          keep = a.mask[r] != 0 && o >= 0 && o < a.O;
        } else {
          const float* src = a.inst + static_cast<size_t>(w) * kInst * N + i;
          p = {src[kPos * N], src[(kPos + 1) * N], src[(kPos + 2) * N]};
          q = {src[kRot * N], src[(kRot + 1) * N], src[(kRot + 2) * N], src[(kRot + 3) * N]};
          s = {src[kScl * N], src[(kScl + 1) * N], src[(kScl + 2) * N]};
          const float objf = src[kObj * N];
          o = static_cast<int>(objf);
          keep = src[kMask * N] > 0.5f && static_cast<float>(o) == objf && o >= 0 && o < a.O;
        }
      }
      if (!keep) o = 0;
      const float* tb = a.table + static_cast<size_t>(o) * a.S;
      const int prim = static_cast<int>(__ldg(tb + kPrim));
      const float radius = __ldg(tb + kRadius);
      const float rbs = __ldg(tb + kRBound) * fmaxf(fmaxf(s.x, s.y), s.z);
      RK_PHASE(1);
      float4 sph = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cone = sph;
      float sin_b = 0.0f;
      const bool mesh = __ldg(tb + kMesh) > 0.5f;
      if (keep) {
        // rays: each bounding radius widened by the origins' spread
        const float rb = VIEWS ? rbs : rbs + spread;
        cone = apex_terms(p, rb, prim == kPlane, eye, sin_b);
        keep = cone.w < -1.5f ||
               meets_cone(sub(p, eye), rb * (1.0f + kCullRel) + kCullAbs, view_ax, cos_v, sin_v);
        const V3 oc = sub(eye, p);
        const float rad = radius * s.x;
        // a sphere without a mesh: the sphere test's c (rays: used where
        // every ray starts at eye); else the radius of the pixel rays' own
        // cull (see the trace below)
        sph = make_float4(oc.x, oc.y, oc.z,
                          prim == kSphere && !mesh ? dot(oc, oc) - rad * rad
                                                   : rbs * (1.0f + kRayRel) + kRayAbs);
      }
      RK_PHASE(2);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int slot = M, batch = 0;
      for (int j = 0; j < kVWarps; ++j) {
        slot += j < warp ? s_count[j] : 0;
        batch += s_count[j];
      }
      slot += __popc(ballot & ((1u << lane) - 1u));
      if (keep && slot < C) {
        const int code = (o << kCodeObj) | (mesh ? kCodeMesh : 0) | prim;
        s_pos[slot] = make_float4(p.x, p.y, p.z, sin_b);
        s_rot[slot] = make_float4(q.w, q.x, q.y, q.z);
        s_scl[slot] = make_float4(s.x, s.y, s.z, radius);
        s_alb[slot] = make_float4(__ldg(tb + kAlbedo), __ldg(tb + kAlbedo + 1),
                                  __ldg(tb + kAlbedo + 2), __int_as_float(code));
        s_sph[slot] = sph;
        s_cone[slot] = cone;
        s_gid[slot] = i;
      }
      if (keep && slot == C) s_next = i;
      __syncthreads();
      if (M + batch <= C) {
        cursor += kVThreads;
        M += batch;
      } else {
        cursor = s_next;
        M = C;
      }
      RK_PHASE(3);
    }
    const bool last = cursor >= N;

    for (int tile = tile0, slot = warp * 32 + lane; tile < tile_end;
         tile += tile_step, slot += kVThreads) {
      // views: tiles in row-major order; rays: in column-major order
      const int row = (VIEWS ? tile / tiles_x : tile % tiles_y) * kTileH + lane / kTileW;
      const int col = (VIEWS ? tile % tiles_x : tile / tiles_y) * kTileW + lane % kTileW;
      bool valid;
      int px;
      V3 ro, rd;
      float count, cos_m;
      V3 ax;
      if constexpr (VIEWS) {
        valid = row < a.H && col < a.Wpx;
        ro = eye;
        rd = camera_ray(row, col, a.H, a.Wpx, vq, tanf);
        px = row * a.Wpx + col;
      } else {
        px = row * a.img_w + col;
        valid = col < a.img_w && px < a.P;
        ro = rd = {0.0f, 0.0f, 0.0f};
        if (valid) {
          const float* r = a.rays + static_cast<size_t>(w) * 6 * a.P + px;
          ro = {r[0], r[a.P], r[2 * a.P]};
          rd = {r[3 * a.P], r[4 * a.P], r[5 * a.P]};
        }
      }
      const bool pad = !valid || !(dot(rd, rd) >= 0.5f);
      if constexpr (VIEWS) {
        // the tile's view cone from its corner rays (the single-stage kernel's)
        count = __ballot_sync(0xffffffffu, !pad) != 0u ? 1.0f : 0.0f;
        const int r0 = (tile / tiles_x) * kTileH, q0 = (tile % tiles_x) * kTileW;
        const int cl = min(kTileW, a.Wpx - q0) - 1, rl = (min(kTileH, a.H - r0) - 1) * kTileW;
        V3 k[4];
        const int src[4] = {0, cl, rl, rl + cl};
        for (int c = 0; c < 4; ++c)
          k[c] = {__shfl_sync(0xffffffffu, rd.x, src[c]), __shfl_sync(0xffffffffu, rd.y, src[c]),
                  __shfl_sync(0xffffffffu, rd.z, src[c])};
        const V3 ksum = add(add(k[0], k[1]), add(k[2], k[3]));
        ax = scale(ksum, 1.0f / sqrtf(fmaxf(dot(ksum, ksum), kEps)));
        cos_m = fminf(fminf(dot(k[0], ax), dot(k[1], ax)), fminf(dot(k[2], ax), dot(k[3], ax)));
        cos_m = cos_m > 0.0f ? fminf(cos_m, 1.0f) : -1.0f;   // wider (or NaN): keep all
      } else {
        // the tile's cone, built before the first stage (2: no ray traced)
        const float4 tc = s_tile[slot >> 5];
        ax = {tc.x, tc.y, tc.z};
        count = tc.w <= 1.0f ? 1.0f : 0.0f;
        cos_m = tc.w;
      }
      const float sin_m = sqrtf(fmaxf(1.0f - cos_m * cos_m, 0.0f));

      float best_t = kBig;
      V3 best_n = {0.0f, 0.0f, 0.0f}, best_a = {0.0f, 0.0f, 0.0f};
      int best_k = -1;            // the winner's staged index
      bool best_sphere = false;   // its normal is still to make
      const int cx = carry_px > 0 ? slot : px;   // the pixel's carried hit
      int best_gid = -1;          // a winner of an earlier stage
      RK_PHASE(4);
      if (!first && valid) {
        best_t = ct[cx];
        best_gid = static_cast<int>(cid[cx]);
      }
      RK_PHASE(5);
      for (int base = 0; count > 0.0f && base < M; base += 32) {
        const int i = base + lane;
        bool keep = false;
        if (i < M) {
          const float4 ps = s_pos[i];
          const float4 c = s_cone[i];
          keep = cos_m <= -c.w || dot({c.x, c.y, c.z}, ax) >= cos_m * c.w - sin_m * ps.w;
        }
        unsigned bits = __ballot_sync(0xffffffffu, keep);
        // the staged spheres without a mesh, whose test is the short one
        // below (rays: where every ray of the CTA starts at eye)
        const unsigned spheres =
            VIEWS || one_origin
                ? __ballot_sync(0xffffffffu, i < M && (__float_as_int(s_alb[i].w) &
                                                       (kCodeMesh | 3)) == kSphere)
                : 0u;
        const unsigned live = __ballot_sync(0xffffffffu, !pad);
        RK_PHASE(6);
        if (pad) continue;
        auto sphere_t = [&](int j) {
          const float4 sp = s_sph[j];
          const float b = dot({sp.x, sp.y, sp.z}, rd);
          const float disc = b * b - sp.w;
          const float ts = -b - sqrtf(fmaxf(disc, 0.0f));
          return (disc >= 0.0f && ts > 1e-4f) ? ts : kBig;
        };
        auto take_sphere = [&](float t, int j) {
          if (t < best_t) {
            best_t = t;
            best_k = j;
            best_sphere = true;
          }
        };
        while (bits) {
          const int j = __ffs(bits) - 1;
          const unsigned rest = bits & (bits - 1u);
          const int j2 = __ffs(rest) - 1;
          if (((spheres >> j) & 1u) && rest && ((spheres >> j2) & 1u)) {
            // two spheres in a row: both tests at once, taken in index order
            const float t = sphere_t(base + j), t2 = sphere_t(base + j2);
            take_sphere(t, base + j);
            take_sphere(t2, base + j2);
            bits = rest & (rest - 1u);
            continue;
          }
          bits = rest;
          const int kk = base + j;
          if ((spheres >> j) & 1u) {
            take_sphere(sphere_t(kk), kk);
            continue;
          }
          const int code = __float_as_int(s_alb[kk].w);
          const int prim = code & 3;
          if (prim != kPlane && (VIEWS || (code & (kCodeMesh | 3)) != kSphere)) {
            // a hull or a mesh: tested only where some pixel ray of the
            // tile passes within its widened bounding sphere (radius R,
            // staged), not behind the ray's origin, and could still beat
            // the pixel's nearest hit (every hit of it lies past |ro - pos|
            // - R; the widening is far past the rounding of these tests)
            const float4 sp = s_sph[kk];
            V3 oc = {sp.x, sp.y, sp.z};   // views: eye - pos
            if constexpr (!VIEWS) {
              const float4 ps = s_pos[kk];
              oc = sub(ro, {ps.x, ps.y, ps.z});
            }
            const float b = dot(oc, rd);
            const float o2 = dot(oc, oc);
            const float r2 = sp.w * sp.w;
            const bool meets = o2 - b * b <= r2 && (b < sp.w || o2 <= r2);
            if (!__any_sync(live, meets && !(best_t < sqrtf(o2) - sp.w))) continue;
          }
          const bool mesh = (code & kCodeMesh) != 0 && a.T > 0;
          const float4 ps = s_pos[kk], qr = s_rot[kk], sr = s_scl[kk];
          const float* tb = a.table + static_cast<size_t>(code >> kCodeObj) * a.S;
          V3 n = best_n;
          const float t = trace(prim, mesh, sr.w, tb, a.F, a.T, ro, rd, {ps.x, ps.y, ps.z},
                                {qr.x, qr.y, qr.z, qr.w}, {sr.x, sr.y, sr.z}, best_t, n);
          if (t < best_t) {
            best_t = t;
            best_n = n;
            best_k = kk;
            best_sphere = false;
          }
        }
        RK_PHASE(7);
      }
      if (!last) {
        // not the last stage: the nearest hit so far waits for the next
        if (best_k >= 0) best_gid = s_gid[best_k];
        if (valid) {
          ct[cx] = best_t;
          cid[cx] = static_cast<uint32_t>(best_gid);
        }
        RK_PHASE(8);
        continue;
      }
      if (best_k >= 0) {
        const float4 al = s_alb[best_k];
        best_a = {al.x, al.y, al.z};
        if (best_sphere) {
          const float4 ps = s_pos[best_k];
          best_n = sub(add(ro, scale(rd, best_t)), {ps.x, ps.y, ps.z});
        }
      } else if (best_gid >= 0) {
        earlier_winner(a, VIEWS, w, best_gid, ro, rd, best_t, best_n, best_a);
      }
      if (valid) {
        // shade: Lambert plus ambient
        const bool hit = !pad && best_t < kBig * 0.5f;
        const float inv_len = 1.0f / sqrtf(fmaxf(dot(best_n, best_n), kEps));
        const V3 nn = scale(best_n, inv_len);
        const float lam = fmaxf(nn.x * a.lx + nn.y * a.ly + nn.z * a.lz, 0.0f);
        const float shade = a.amb + a.one_m_amb * lam;
        const float hitf = hit ? 1.0f : 0.0f;
        const float r = pad ? 0.0f : best_a.x * shade * hitf;
        const float g = pad ? 0.0f : best_a.y * shade * hitf;
        const float b = pad ? 0.0f : best_a.z * shade * hitf;
        if constexpr (VIEWS) {
          a.rgba[img + px] = to_u8(r) | (to_u8(g) << 8) | (to_u8(b) << 16) | ((hit ? 255u : 0u) << 24);
          a.depth[img + px] = hit ? best_t : __int_as_float(0x7f800000);
        } else {
          float* o = a.out + static_cast<size_t>(w) * 5 * a.P + px;
          o[0] = r;
          o[a.P] = g;
          o[2 * a.P] = b;
          o[3 * a.P] = hitf;
          o[4 * a.P] = hit ? best_t : kBig;
        }
      }
      RK_PHASE(9);
    }
    if (last) break;
    __syncthreads();   // the next stage overwrites this one
    RK_PHASE(10);
  }
  RK_PHASE_END
}

__global__ void __launch_bounds__(kVThreads, kVCtas) render_views_blocked_kernel(const Args a) {
  blocked_twin<true>(a);
}

__global__ void __launch_bounds__(kVThreads, kVCtas) render_rays_blocked_kernel(const Args a) {
  blocked_twin<false>(a);
}

// The dynamic shared memory of a mode's single-stage kernel: N instances.
size_t render_smem(bool views, int N) {
  return static_cast<size_t>(N) * (views ? kStageViews : kStageRays);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool VIEWS>
int launch_single(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = render_smem(VIEWS, a.N);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(render_kernel<VIEWS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_kernel<VIEWS><<<dim3(blocks, a.splits), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The views mode's blocked twin: views_splits CTAs an image, a.B
// survivors a stage.
int launch_views_blocked(const Args& a, int blocks, cudaStream_t stream) {
  if (a.B > views_stage(a.H, a.Wpx) || a.splits != views_splits(a.H, a.Wpx))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = views_blocked_smem(a.B, a.H, a.Wpx);
  const cudaError_t err = allow_smem(render_views_blocked_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_views_blocked_kernel<<<dim3(blocks, a.splits), kVThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The rays mode's blocked twin: a.splits CTAs an image (enough that a CTA
// has kRTiles tiles at most), a.B survivors a stage (a multiple of 32).
int launch_rays_blocked(const Args& a, int blocks, cudaStream_t stream) {
  const int tiles = ray_tiles(a.P, a.img_w);
  if (a.splits > 65535 || a.splits < (tiles + kRTiles - 1) / kRTiles || a.B < 32 ||
      a.B % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cta_tiles = rays_cta_tiles(tiles, a.splits);
  if (a.B > rays_stage(cta_tiles)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rays_blocked_smem(a.B, cta_tiles);
  const cudaError_t err = allow_smem(render_rays_blocked_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_rays_blocked_kernel<<<dim3(blocks, a.splits), kVThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// block: 0 for every instance at once, else the survivors a stage of the
// mode's blocked twin holds (ops/render_kernel.py blocked): in
// render_launch at most rays_stage of the CTA's tiles (ops/render_kernel.py
// rays_stage), splits at least enough for kRTiles tiles a CTA; in
// render_views_launch at most views_stage(H, Wpx) (ops/render_kernel.py
// views_stage), splits views_splits(H, Wpx)
extern "C" int render_launch(const void* rays, const void* inst, const void* table, int O,
                             int S, int F, int T, int W, int P, int N, int img_w, int splits,
                             float lx, float ly, float lz, float amb, float one_m_amb,
                             int block, void* out, void* stream) {
  if (W <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || img_w <= 0 || splits <= 0 || block < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.rays = static_cast<const float*>(rays);
  a.inst = static_cast<const float*>(inst);
  a.out = static_cast<float*>(out);
  a.P = P;
  a.img_w = img_w;
  a.table = static_cast<const float*>(table);
  a.O = O, a.S = S, a.F = F, a.T = T, a.N = N, a.splits = splits;
  a.lx = lx, a.ly = ly, a.lz = lz, a.amb = amb, a.one_m_amb = one_m_amb;
  a.B = block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return block == 0 ? launch_single<false>(a, W, st) : launch_rays_blocked(a, W, st);
}

extern "C" int render_views_launch(const void* eye, const void* vrot, const void* tan_fov,
                                   const void* vmask, int Vc, int V, int H, int Wpx,
                                   const void* pos, const void* rot, const void* scl,
                                   const void* obj, const void* mask, const void* table, int O,
                                   int S, int F, int T, int W, int N, int splits, float lx,
                                   float ly, float lz, float amb, float one_m_amb, int block,
                                   void* rgba, void* depth, void* stream) {
  if (W <= 0 || V <= 0 || H <= 0 || Wpx <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0 || Vc < V || splits <= 0 || block < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.eye = static_cast<const float*>(eye);
  a.vrot = static_cast<const float*>(vrot);
  a.tan_fov = static_cast<const float*>(tan_fov);
  a.vmask = static_cast<const uint8_t*>(vmask);
  a.Vc = Vc, a.V = V, a.H = H, a.Wpx = Wpx;
  a.pos = static_cast<const float*>(pos);
  a.rot = static_cast<const float*>(rot);
  a.scl = static_cast<const float*>(scl);
  a.obj = static_cast<const int32_t*>(obj);
  a.mask = static_cast<const uint8_t*>(mask);
  a.rgba = static_cast<uint32_t*>(rgba);
  a.depth = static_cast<float*>(depth);
  a.table = static_cast<const float*>(table);
  a.O = O, a.S = S, a.F = F, a.T = T, a.N = N, a.splits = splits;
  a.lx = lx, a.ly = ly, a.lz = lz, a.amb = amb, a.one_m_amb = one_m_amb;
  a.B = block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return block == 0 ? launch_single<true>(a, W * V, st) : launch_views_blocked(a, W * V, st);
}

template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, size_t smem, int* ctas_per_sm) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem));
}

// CTAs an SM of each mode at N instances, all at once (block 0) or in
// stages of block in the mode's blocked twin at an H x Wpx image (rays:
// H rows of Wpx rays, rays_splits CTAs an image) (cudaOccupancy...), for
// chip_smoke.py's timing line
extern "C" int render_occupancy(int views, int N, int block, int H, int Wpx, int* ctas_per_sm) {
  if (block > 0 && views)
    return occupancy_of(render_views_blocked_kernel, kVThreads,
                        views_blocked_smem(block, H, Wpx), ctas_per_sm);
  if (block > 0) {
    const int tiles = ray_tiles(H * Wpx, Wpx);
    return occupancy_of(render_rays_blocked_kernel, kVThreads,
                        rays_blocked_smem(block, rays_cta_tiles(tiles, rays_splits(tiles))),
                        ctas_per_sm);
  }
  return views ? occupancy_of(render_kernel<true>, kThreads, render_smem(true, N), ctas_per_sm)
               : occupancy_of(render_kernel<false>, kThreads, render_smem(false, N), ctas_per_sm);
}
