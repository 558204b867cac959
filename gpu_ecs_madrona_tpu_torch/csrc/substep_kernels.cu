// The physics step's substeps in one kernel for Hopper (sm_90a).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -Xptxas -v
// and called through the plain C function at the end of this file
// (ctypes).  The launch goes on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// fused_substep_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/substep_kernel.py: _run_fused, the
//   unchunked pallas_call (K <= 128, :1257) and the K-slab chunked one
//   (K > 128, :1241) — one kernel for both capacities, without the in-kernel
//   broadphase, contact refresh, sleep or persistent manifolds.
//   Computes, per world and for each of num_substeps substeps (the JAX
//   kernel's loop, _make_fused_kernel):
//     1. semi-implicit Euler integrate with the gyroscopic term (_integrate);
//     2. per candidate slot, a gather of both bodies' pose and prev_pos;
//     3. pair_contacts (physics/pairs.py): sphere-sphere, sphere-plane,
//        hull-plane (all hull verts), sphere-box and box-box (Gottschalk's
//        15-axis SAT, the incident face clipped against the reference face,
//        an edge-edge point), compacted to the deepest 4 points;
//     4. positional_pass; 5. a segment sum to bodies; 6. the pose update and
//        velocity recovery (_apply_positional_recover); 7. a re-gather at the
//        post-solve poses; 8. velocity_pass (restitution channels when any
//        material bounces); 9. a segment sum; non-dynamic rows keep their pose
//        and get zero v/w.
//   The outputs carry the last substep's stashes (prev pose, post-integrate
//   pose and velocities).  Only all-box object tables are taken (the wrapper
//   raises otherwise): the general-hull SAT waits.
//
// substep_kernel
//   Replaces gpu_ecs_madrona_tpu/ops/substep_kernel.py: _run, the
//   single-substep pallas_call (:1165) that worlds with joints take: steps
//   2-9 above once, from the post-integrate pose and velocities and the
//   substep start the caller passes (it integrates before the call and
//   solves the joints after it, in PyTorch).  Outputs pose and velocities.
//   Both kernels share the layout, the slot lists and steps 2-9
//   (solve_substep), so they cannot drift apart.
//   Work: at 8192 worlds x 65 rows x K = 256 slots a call moves
//   W (65 x 237 B + K x 9 B + 20 B) ~ 145 MB (~0.043 ms at 3.35 TB/s): each
//   body row's inputs and its pose, velocity and six stashes out.  The
//   operations depend on the contacts: a box-box candidate's SAT is ~420
//   fp32 operations a substep, its face clip ~760 more when it touches,
//   and each live contact point ~450 in the two passes; a settled pile of
//   ~90 candidates a world needs a few GFLOP a call (chip_smoke.py counts
//   them from the data), about as long as the bytes at 67 TFLOP/s.  The
//   kernel is far from either: one thread per pair runs SAT, clip and both
//   passes as long dependent chains (145 registers, a 384-byte stack
//   frame, no spills in -Xptxas -v), so few warps hide the latency.
//   Design: one CTA per world.  The world's body state (current, previous,
//   post-integrate and post-solve pose and velocity, the static columns)
//   sits in shared memory, 54 floats a body.  One thread per candidate
//   slot and per body (blockDim = max(n, K) rounded up to 32, at most 128;
//   the threads loop over what is left).  The slot loops stop at the
//   world's last valid slot, so the dead tail of the capacity costs
//   nothing: the chunked TPU kernel's dead-slab skip, by construction, at
//   one-slot granularity.  The pair's
//   manifold and lambdas are stashed per slot in shared memory between the
//   positional and velocity passes, and each pass writes its per-slot
//   contributions there.  The segment sums are deterministic (no float
//   atomics): one thread per body adds its A-side contributions in
//   ascending slot order, then its B-side ones — the plain version's order
//   — walking a per-body list of its slots built once a step; a
//   non-dynamic body (the plane, which meets every pile body) gets only
//   zero contributions and skips its sum.
//
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
constexpr int kMaxVerts = 8;     // table verts per hull (a box has 8)
constexpr int kCand = 12;        // manifold candidates (3 per box-face vertex)
constexpr int kPts = 4;          // manifold points kept
constexpr int kPrimSphere = 0;
constexpr int kPrimHull = 1;
constexpr int kPrimPlane = 2;
constexpr int kMaxThreads = 128;

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

// The object table row: prim_type, sphere_radius, box_half xyz,
// restitution, num_verts, verts (vm x 3), local_aabb_lo xyz, local_aabb_hi
// xyz.
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
  __device__ __forceinline__ int prim(int o) const { return static_cast<int>(t[o * stride]); }
  __device__ __forceinline__ float radius(int o) const { return t[o * stride + 1]; }
  __device__ __forceinline__ float half(int o, int k) const { return t[o * stride + 2 + k]; }
  __device__ __forceinline__ float rest(int o) const { return t[o * stride + 5]; }
  __device__ __forceinline__ int nverts(int o) const { return static_cast<int>(t[o * stride + 6]); }
  __device__ __forceinline__ V3 vert(int o, int v) const {
    const float* p = t + o * stride + 7 + 3 * v;
    return mk(p[0], p[1], p[2]);
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

// The face of a box most aligned with `outward`, as clip inputs.
struct BoxFace {
  V3 poly[4];
  V3 side_n[4];
  float side_d[4];
  V3 n;
  float d;
};
__device__ void box_face(V3 pos, const V3 u[3], const float h[3], V3 outward, BoxFace& f) {
  float score[3], mag[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    score[k] = dot(u[k], outward);
    mag[k] = fabsf(score[k]);
  }
  int sel = 0;
  if (mag[1] > mag[sel]) sel = 1;
  if (mag[2] > mag[sel]) sel = 2;
  const float sgn = score[sel] >= 0.0f ? 1.0f : -1.0f;
  const int s1 = (sel + 1) % 3, s2 = (sel + 2) % 3;
  const V3 n = scl(u[sel], sgn);
  const float hn = h[sel];
  const V3 a = u[s1], b = u[s2];
  const float ha = h[s1], hb = h[s2];
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
__device__ void box_edge(V3 pos, const V3 u[3], const float h[3], int e, V3 n_dir, V3* e0,
                         V3* e1) {
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
__device__ bool box_box(const Body& A, const Body& B, const Table& tab, float spec,
                        V3 cp[kCand], float cd[kCand], V3* normal, int* num) {
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
  V3 fE = cross(uA[eA], uB[eB]);
  fE = scl(fE, 1.0f / fmaxf(norm3(fE, 1e-30f), 1e-12f));

  const float sat_pen = fminf(fminf(minA, minB), minE);
  const bool hit = (sat_pen > -spec) && (sat_pen < kBig * 0.5f);
  const bool faceA = minA <= fminf(minB, minE) * kFaceBias + kSatTieEps;
  const bool faceB = !faceA && (minB <= minE * kFaceBias + kSatTieEps);
  const V3 ab = sub(B.pos, A.pos);
  const V3 f = faceA ? uA[ia] : (faceB ? uB[ib] : fE);
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
    // incident face clipped against the reference face's side planes
    const V3 nrm_inc = faceB ? scl(nrm, -1.0f) : nrm;
    const Body& R = faceB ? B : A;
    const Body& I = faceB ? A : B;
    const V3* uR = faceB ? uB : uA;
    const V3* uI = faceB ? uA : uB;
    const float* hR = faceB ? hB : hA;
    const float* hI = faceB ? hA : hB;
    BoxFace fi, fr;
    box_face(I.pos, uI, hI, scl(nrm_inc, -1.0f), fi);
    box_face(R.pos, uR, hR, nrm_inc, fr);
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
__device__ bool sphere_box(V3 s_pos, float s_rad, const Body& Bx, const Table& tab, float spec,
                           bool flip, V3* normal, V3* point, float* pen_out) {
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
  int ax = 0;
  if (fd[1] < fd[ax]) ax = 1;
  if (fd[2] < fd[ax]) ax = 2;
  const V3 n_in = scl(u[ax], cl[ax] >= 0.0f ? 1.0f : -1.0f);
  const V3 nrm_hs = inside ? n_in : n_out;
  const float pen = inside ? s_rad + fd[ax] : s_rad - dist;
  *normal = flip ? nrm_hs : scl(nrm_hs, -1.0f);
  *point = add(Bx.pos, q_w);
  *pen_out = pen;
  return pen > -spec;
}

__device__ __forceinline__ V3 plane_normal(Q4 rot) {
  return qrot(rot, mk(0.0f, 0.0f, 1.0f));
}

// pair_contacts of physics/pairs.py for one live pair (all-box tables).
// NPTS: also its num_points (candidates past the speculative margin, at
// most kPts) in *npts, which only the manifold cache keeps.
template <bool NPTS>
__device__ void pair_contacts(const Body& A, const Body& B, const Table& tab, float spec,
                              Manifold& out, int* npts) {
  const int pa = tab.prim(A.obj), pb = tab.prim(B.obj);
  V3 cp[kCand];
  float cd[kCand];
#pragma unroll
  for (int c = 0; c < kCand; ++c) {
    cp[c] = mk(0.0f, 0.0f, 0.0f);
    cd[c] = kNegBig;
  }
  bool ok = false;
  V3 n = mk(0.0f, 0.0f, 0.0f);
  int num = 0;
  if (pa == kPrimSphere && pb == kPrimSphere) {
    const float radA = tab.radius(A.obj), radB = tab.radius(B.obj);
    const V3 d = sub(B.pos, A.pos);
    const float dist = norm3(d, 1e-18f);
    n = scl(d, 1.0f / dist);
    const float pen = (radA + radB) - dist;
    cp[0] = add(A.pos, scl(n, radA - 0.5f * pen));
    cd[0] = pen;
    ok = pen > -spec;
    num = 1;
  } else if ((pa == kPrimSphere && pb == kPrimPlane) || (pa == kPrimPlane && pb == kPrimSphere)) {
    const bool flip = pa == kPrimPlane;
    const Body& S = flip ? B : A;
    const Body& Pl = flip ? A : B;
    const V3 p_n = plane_normal(Pl.rot);
    const float p_d = dot(p_n, Pl.pos);
    const float c_dist = dot(S.pos, p_n) - p_d;
    const float pen = tab.radius(S.obj) - c_dist;
    cp[0] = sub(S.pos, scl(p_n, c_dist));
    cd[0] = pen;
    n = flip ? p_n : scl(p_n, -1.0f);
    ok = pen > -spec;
    num = 1;
  } else if ((pa == kPrimHull && pb == kPrimPlane) || (pa == kPrimPlane && pb == kPrimHull)) {
    const bool flip = pa == kPrimPlane;
    const Body& H = flip ? B : A;
    const Body& Pl = flip ? A : B;
    const V3 p_n = plane_normal(Pl.rot);
    const float p_d = dot(p_n, Pl.pos);
    const int nv = tab.nverts(H.obj);
    for (int v = 0; v < tab.vm; ++v) {
      const V3 vw = add(qrot(H.rot, tab.vert(H.obj, v)), H.pos);
      const float vd = dot(vw, p_n) - p_d;
      const float pen_v = v < nv ? -vd : kNegBig;
      cp[v] = vw;
      cd[v] = pen_v;
      num += pen_v > -spec ? 1 : 0;
    }
    n = flip ? p_n : scl(p_n, -1.0f);
    ok = num > 0;
  } else if ((pa == kPrimSphere && pb == kPrimHull) || (pa == kPrimHull && pb == kPrimSphere)) {
    const bool flip = pa == kPrimHull;
    const Body& S = flip ? B : A;
    const Body& Bx = flip ? A : B;
    float pen;
    ok = sphere_box(S.pos, tab.radius(S.obj), Bx, tab, spec, flip, &n, &cp[0], &pen);
    cd[0] = pen;
    num = 1;
  } else if (pa == kPrimHull && pb == kPrimHull) {
    ok = box_box(A, B, tab, spec, cp, cd, &n, &num);
  }
  // deepest 4 (first index wins ties), as pairs.py's compaction
#pragma unroll
  for (int s = 0; s < kPts; ++s) {
    int best = 0;
#pragma unroll
    for (int c = 1; c < kCand; ++c)
      if (cd[c] > cd[best]) best = c;
    out.d[s] = cd[best];
    out.p[s] = cp[best];
    cd[best] = kNegBig;
  }
  out.ok = ok;
  out.n = n;
  if (NPTS) *npts = num < kPts ? num : kPts;
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

// The dynamic shared memory for n bodies and K slots, with the broadphase's
// AABBs, degrees and bases (bp) and the manifold cache (cache).
size_t smem_bytes(int n, int K, bool bp, bool cache) {
  const size_t nn = static_cast<size_t>(n), kk = static_cast<size_t>(K);
  const size_t floats = kBodyCh * nn + (kSlotCh + kPackCh) * kk + (cache ? kCacheCh * kk : 0) +
                        (bp ? kAabbCh * nn : 0);
  const size_t ints = 5 * kk + nn + 1 + 4 + (bp ? 2 * nn : 0);
  return sizeof(float) * floats + sizeof(int) * ints;
}

// A world's shared memory, carved from the dynamic block (smem_bytes).
struct Smem {
  float *sb, *sst, *spk;
  float* scache;  // kCacheCh K (cache only)
  float* saabb;   // kAabbCh n (bp only)
  int *sri, *srj, *skv;
  int* soff;    // n + 1: each body's first entry in slist
  int* slist;   // 2 K: (slot << 1 | side) per body, A sides first
  int* sworld;  // 4 world scalars
  int *sdeg, *sbase;  // n each (bp only): owner degree, first slot
};

__device__ __forceinline__ Smem carve(float* smem, int n, int K, bool bp, bool cache) {
  Smem s;
  s.sb = smem;
  s.sst = s.sb + kBodyCh * n;
  s.spk = s.sst + kSlotCh * K;
  float* f = s.spk + kPackCh * K;
  s.scache = cache ? f : nullptr;
  f += cache ? kCacheCh * K : 0;
  s.saabb = bp ? f : nullptr;
  f += bp ? kAabbCh * n : 0;
  s.sri = reinterpret_cast<int*>(f);
  s.srj = s.sri + K;
  s.skv = s.srj + K;
  s.soff = s.skv + K;
  s.slist = s.soff + n + 1;
  s.sworld = s.slist + 2 * K;
  s.sdeg = bp ? s.sworld + 4 : nullptr;
  s.sbase = bp ? s.sworld + 4 + n : nullptr;
  return s;
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

// After the staging: kc = 1 + the last valid slot (the slot loops stop
// there; candidate slots are a validity prefix, so this skips the dead
// tail), and each body's list of its pair sides, A sides in ascending slot
// order then B sides: the segment sums walk these lists instead of every
// slot.  Starts and ends with a barrier.
__device__ int finish_slots(const Smem& s, int n, int K, int tid, int T) {
  const int *sri = s.sri, *srj = s.srj, *skv = s.skv;
  int *soff = s.soff, *slist = s.slist;
  __shared__ int s_kc;
  if (tid == 0) s_kc = 0;
  __syncthreads();
  for (int k = tid; k < K; k += T)
    if (skv[k]) atomicMax(&s_kc, k + 1);
  __syncthreads();
  const int kc = s_kc;
  for (int b = tid; b < n; b += T) {
    int cnt = 0;
    for (int k = 0; k < kc; ++k)
      if (skv[k]) cnt += (sri[k] == b ? 1 : 0) + (srj[k] == b ? 1 : 0);
    soff[b + 1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    soff[0] = 0;
    for (int b = 0; b < n; ++b) soff[b + 1] += soff[b];
  }
  __syncthreads();
  for (int b = tid; b < n; b += T) {
    int e = soff[b];
    for (int k = 0; k < kc; ++k)
      if (skv[k] && sri[k] == b) slist[e++] = k << 1;
    for (int k = 0; k < kc; ++k)
      if (skv[k] && srj[k] == b) slist[e++] = (k << 1) | 1;
  }
  __syncthreads();
  return kc;
}

// ---------------------------------------------------------------------------
// The in-kernel broadphase (JAX _inkernel_broadphase)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool aabb_overlap(const float* sa, int n, int i, int j) {
  bool ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    ok = ok && sa[ax * n + j] <= sa[(3 + ax) * n + i] && sa[(3 + ax) * n + j] >= sa[ax * n + i];
  return ok;
}

// Each body's velocity-expanded AABB from the step's starting pose and
// velocity (the JAX kernel's arithmetic, term by term), then the live pairs
// whose AABBs overlap, owned by the higher row: one thread per owner counts
// its partners, one thread scans the capped degrees into each owner's first
// slot, and each owner writes its first min(deg, D) partners in ascending
// row.  Slots at K and beyond are not written.  Writes the AABB, row and
// count outputs; the slots go to shared memory for finish_slots.
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
  for (int k = tid; k < K; k += T) s.sri[k] = s.srj[k] = s.skv[k] = 0;
  __syncthreads();
  for (int j = tid; j < n; j += T) {
    int deg = 0;
    if (live[j])
      for (int i = 0; i < j; ++i) deg += (live[i] && aabb_overlap(sa, n, i, j)) ? 1 : 0;
    s.sdeg[j] = deg;
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0, all = 0;
    for (int j = 0; j < n; ++j) {
      s.sbase[j] = base;
      base += min(s.sdeg[j], a.D);
      all += s.sdeg[j];
    }
    a.o_count[wld] = base;
    a.o_dropped[wld] = all - base;
  }
  __syncthreads();
  for (int j = tid; j < n; j += T) {
    const int dc = min(s.sdeg[j], a.D);
    int r = 0;
    for (int i = 0; i < j && r < dc; ++i) {
      if (!(live[i] && aabb_overlap(sa, n, i, j))) continue;
      const int slot = s.sbase[j] + r++;
      if (slot < K) {
        s.sri[slot] = i;
        s.srj[slot] = j;
        s.skv[slot] = 1;
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

// The broadphase outputs of a world that keeps its cache (stable, or asleep
// under persistence): the cached rows and kvalid, the current AABB columns,
// count = the cached kvalid's sum, nothing dropped; the slots also go to
// shared memory when s is given, and mc passes through when copy_mc.
__device__ void cached_surface(const Smem* s, const Args& a, int wld, int n, int K, int tid,
                               int T, bool copy_mc) {
  const float* mc = a.mc + static_cast<size_t>(wld) * kMcCh * K;
  for (int k = tid; k < K; k += T) {
    const int ri = static_cast<int>(mc[k]), rj = static_cast<int>(mc[K + k]);
    const bool kv = mc[2 * K + k] > 0.5f;
    const size_t g = static_cast<size_t>(wld) * K + k;
    a.o_rows_i[g] = ri;
    a.o_rows_j[g] = rj;
    a.o_kvalid[g] = kv ? 1 : 0;
    if (s) {
      s->sri[k] = clamp_row(ri, n);
      s->srj[k] = clamp_row(rj, n);
      s->skv[k] = kv ? 1 : 0;
    }
  }
  const size_t g0 = static_cast<size_t>(wld) * 3 * n;
  for (int i = tid; i < 3 * n; i += T) {
    a.o_aabb_lo[g0 + i] = a.aabb_lo[g0 + i];
    a.o_aabb_hi[g0 + i] = a.aabb_hi[g0 + i];
  }
  if (tid == 0) {
    float cnt = 0.0f;
    for (int k = 0; k < K; ++k) cnt = cnt + mc[2 * K + k];
    a.o_count[wld] = static_cast<int>(cnt);
    a.o_dropped[wld] = 0;
  }
  if (copy_mc) {
    float* mo = a.o_mc + static_cast<size_t>(wld) * kMcCh * K;
    for (int i = tid; i < kMcCh * K; i += T) mo[i] = mc[i];
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

// Steps 2-9 of a substep, from the post-integrate pose and velocities
// (kIPos, kIRot, kIV, kIW) and the substep start (kPrevPos, kPrevRot):
// leaves the new pose in kPos/kRot (dynamic rows only) and the velocities
// in kV/kW (zero on the other rows).  Ends with a barrier.
template <bool CACHE>
__device__ void solve_substep(const Smem& s, const Table& tab, int n, int K, int kc, float h1,
                              float rest1, float relax, float spec, bool bounce, int mode,
                              int tid, int T) {
  float *sb = s.sb, *sst = s.sst, *spk = s.spk;
  const int *sri = s.sri, *srj = s.srj, *skv = s.skv, *soff = s.soff, *slist = s.slist;

  if (CACHE && mode == kResolveBuild) {
    const V3 p0 = ld3(sb, kIPos, 0, n);
    const Q4 q0 = ld4(sb, kIRot, 0, n);
    for (int k = tid; k < K; k += T)
      if (k >= kc || !skv[k]) cache_dead(s.scache, K, k, p0, q0);
  }

  // (2-4) per slot: gather, contacts, positional pass
  for (int k = tid; k < kc; k += T) {
    if (!skv[k]) continue;
    Side S[2];
    Body Bd[2];
    const int rows[2] = {sri[k], srj[k]};
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
    if (!CACHE || mode == kFresh || mode == kBuild || mode == kResolveBuild)
      pair_contacts<CACHE>(Bd[0], Bd[1], tab, spec, c, &npts);
    if (CACHE && (mode == kBuild || mode == kResolveBuild))
      cache_store(s.scache, K, k, c, npts, S[0], S[1]);
    if (CACHE && (mode == kRefresh || mode == kResolveBuild || mode == kResolveKeep))
      cache_refresh(s.scache, K, k, S[0], S[1], c);
    float pA[9], pB[9], lam[kPts];
    positional_pass(S[0], S[1], c, relax, pA, pB, lam);
    sst[kSOk * K + k] = c.ok ? 1.0f : 0.0f;
    sst[(kSN + 0) * K + k] = c.n.x;
    sst[(kSN + 1) * K + k] = c.n.y;
    sst[(kSN + 2) * K + k] = c.n.z;
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      sst[(kSP + 3 * p) * K + k] = c.p[p].x;
      sst[(kSP + 3 * p + 1) * K + k] = c.p[p].y;
      sst[(kSP + 3 * p + 2) * K + k] = c.p[p].z;
      sst[(kSD + p) * K + k] = c.d[p];
      sst[(kSLam + p) * K + k] = lam[p];
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      spk[q * K + k] = pA[q];
      spk[(9 + q) * K + k] = pB[q];
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
      for (int e = soff[b]; e < soff[b + 1]; ++e) {
        const int k = slist[e] >> 1, side = slist[e] & 1;
#pragma unroll
        for (int q = 0; q < 9; ++q) acc[q] = acc[q] + spk[(9 * side + q) * K + k];
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

  // (7-8) per slot: re-gather at the post-solve poses, velocity pass
  for (int k = tid; k < kc; k += T) {
    if (!skv[k]) continue;
    Side S[2];
    const int rows[2] = {sri[k], srj[k]};
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
    Manifold c;
    float lam[kPts];
    c.ok = sst[kSOk * K + k] > 0.5f;
    c.n = mk(sst[kSN * K + k], sst[(kSN + 1) * K + k], sst[(kSN + 2) * K + k]);
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      c.p[p] = mk(sst[(kSP + 3 * p) * K + k], sst[(kSP + 3 * p + 1) * K + k],
                  sst[(kSP + 3 * p + 2) * K + k]);
      c.d[p] = sst[(kSD + p) * K + k];
      lam[p] = sst[(kSLam + p) * K + k];
    }
    float pA[6], pB[6];
    velocity_pass(S[0], S[1], c, lam, h1, rest1, bounce, spec, pA, pB);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      spk[q * K + k] = pA[q];
      spk[(6 + q) * K + k] = pB[q];
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
      for (int e = soff[b]; e < soff[b + 1]; ++e) {
        const int k = slist[e] >> 1, side = slist[e] & 1;
#pragma unroll
        for (int q = 0; q < 6; ++q) acc[q] = acc[q] + spk[(6 * side + q) * K + k];
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
// (the persistent manifold cache; with BP and REFRESH).  OPTS = 0 is the
// kernel without options.
template <int OPTS>
__global__ void __launch_bounds__(kMaxThreads) fused_substep_kernel(Args a) {
  constexpr bool REFRESH = (OPTS & kOptRefresh) != 0, SLEEP = (OPTS & kOptSleep) != 0;
  constexpr bool BP = (OPTS & kOptBp) != 0, PERSIST = (OPTS & kOptPersist) != 0;
  constexpr bool CACHE = REFRESH || PERSIST;
  extern __shared__ float smem[];
  const int wld = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, K = a.K;
  if (SLEEP && !a.active[wld]) {
    passthrough(a, wld, n, tid, T);
    if (PERSIST) cached_surface(nullptr, a, wld, n, K, tid, T, true);
    return;
  }
  const Smem s = carve(smem, n, K, BP, CACHE);
  float* sb = s.sb;
  const size_t b0 = static_cast<size_t>(wld) * n;

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    for (int c = 0; c < 3; ++c) {
      sb[(kPos + c) * n + b] = a.pos[3 * g + c];
      sb[(kV + c) * n + b] = a.v[3 * g + c];
      sb[(kW + c) * n + b] = a.w[3 * g + c];
      sb[(kIi + c) * n + b] = a.ii[3 * g + c];
    }
    for (int c = 0; c < 4; ++c) sb[(kRot + c) * n + b] = a.rot[4 * g + c];
    sb[kIm * n + b] = a.im[g];
    sb[kMuS * n + b] = a.mu_s[g];
    sb[kMuD * n + b] = a.mu_d[g];
    sb[kDyn * n + b] = a.dyn[g] ? 1.0f : 0.0f;
    sb[kObj * n + b] = __int_as_float(a.obj[g]);
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
    cached_surface(&s, a, wld, n, K, tid, T, false);
    const float* mc = a.mc + static_cast<size_t>(wld) * kMcCh * K;
    for (int k = tid; k < K; k += T)
      for (int c = 0; c < kCacheCh; ++c) s.scache[c * K + k] = mc[(kMcRows + c) * K + k];
  } else if (BP) {
    __syncthreads();
    inkernel_broadphase(s, a, wld, n, K, tid, T);
  } else {
    stage_rows(s, a.rows_i, a.rows_j, a.kvalid, wld, n, K, tid, T);
  }
  const int kc = finish_slots(s, n, K, tid, T);
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
    solve_substep<CACHE>(s, a.tab, n, K, kc, h1, rest1, a.relax, a.spec, a.bounce != 0, mode,
                         tid, T);
  }

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    for (int c = 0; c < 3; ++c) {
      a.o_pos[3 * g + c] = sb[(kPos + c) * n + b];
      a.o_v[3 * g + c] = sb[(kV + c) * n + b];
      a.o_w[3 * g + c] = sb[(kW + c) * n + b];
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
  if (PERSIST) {
    // the cache out: the rows (as kept, or the broadphase's) and the
    // resolved manifold, which substep 0 left in shared memory
    const float* mi = a.mc + static_cast<size_t>(wld) * kMcCh * K;
    float* mo = a.o_mc + static_cast<size_t>(wld) * kMcCh * K;
    for (int k = tid; k < K; k += T) {
      mo[k] = keep ? mi[k] : static_cast<float>(s.sri[k]);
      mo[K + k] = keep ? mi[K + k] : static_cast<float>(s.srj[k]);
      mo[2 * K + k] = keep ? mi[2 * K + k] : (s.skv[k] ? 1.0f : 0.0f);
      for (int c = 0; c < kCacheCh; ++c) mo[(kMcRows + c) * K + k] = s.scache[c * K + k];
    }
  }
}

struct Args1 {
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
};

// One substep (JAX _make_kernel): the caller integrated; its inputs are the
// post-integrate pose and velocities and the substep start.
__global__ void __launch_bounds__(kMaxThreads) substep_kernel(Args1 a) {
  extern __shared__ float smem[];
  const int wld = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, K = a.K;
  const Smem s = carve(smem, n, K, false, false);
  float* sb = s.sb;
  const size_t b0 = static_cast<size_t>(wld) * n;

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    for (int c = 0; c < 3; ++c) {
      const float p = a.pos[3 * g + c], v = a.v[3 * g + c], w = a.w[3 * g + c];
      sb[(kPos + c) * n + b] = p;
      sb[(kIPos + c) * n + b] = p;
      sb[(kV + c) * n + b] = v;
      sb[(kIV + c) * n + b] = v;
      sb[(kW + c) * n + b] = w;
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
  stage_rows(s, a.rows_i, a.rows_j, a.kvalid, wld, n, K, tid, T);
  const int kc = finish_slots(s, n, K, tid, T);
  solve_substep<false>(s, a.tab, n, K, kc, a.h[wld], a.rest_thr[wld], a.relax, a.spec,
                       a.bounce != 0, kFresh, tid, T);

  for (int b = tid; b < n; b += T) {
    const size_t g = b0 + b;
    for (int c = 0; c < 3; ++c) {
      a.o_pos[3 * g + c] = sb[(kPos + c) * n + b];
      a.o_v[3 * g + c] = sb[(kV + c) * n + b];
      a.o_w[3 * g + c] = sb[(kW + c) * n + b];
    }
    for (int c = 0; c < 4; ++c) a.o_rot[4 * g + c] = sb[(kRot + c) * n + b];
  }
}

// The block size of either kernel for n bodies and K slots; raises the
// kernel's dynamic shared-memory limit to smem when needed.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, int n, int K, size_t smem, int* threads) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int widest = n > K ? n : K;
  *threads = ((widest + 31) / 32) * 32;
  if (*threads > kMaxThreads) *threads = kMaxThreads;
  return cudaSuccess;
}

template <int OPTS>
cudaError_t launch_fused(const Args& a, int W, cudaStream_t stream) {
  constexpr bool bp = (OPTS & kOptBp) != 0;
  constexpr bool cache = (OPTS & (kOptRefresh | kOptPersist)) != 0;
  const size_t smem = smem_bytes(a.n, a.K, bp, cache);
  int threads;
  const cudaError_t err = launch_shape(fused_substep_kernel<OPTS>, a.n, a.K, smem, &threads);
  if (err != cudaSuccess) return err;
  fused_substep_kernel<OPTS><<<W, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

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
    void* o_rows_j, void* o_kvalid, void* o_count, void* o_dropped, void* o_mc, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || num_substeps < 0 || num_objects <= 0 || vm < 0 || vm > kMaxVerts)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((opts & kOptBp) && (n > kMaxThreads || degree < 1))
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
  a.tab = Table{static_cast<const float*>(table), 13 + 3 * vm, vm};
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (opts) {
    case 0: err = launch_fused<0>(a, W, st); break;
    case kOptRefresh: err = launch_fused<kOptRefresh>(a, W, st); break;
    case kOptSleep: err = launch_fused<kOptSleep>(a, W, st); break;
    case kOptRefresh | kOptSleep: err = launch_fused<kOptRefresh | kOptSleep>(a, W, st); break;
    case kOptBp: err = launch_fused<kOptBp>(a, W, st); break;
    case kOptBp | kOptRefresh: err = launch_fused<kOptBp | kOptRefresh>(a, W, st); break;
    case kOptPersist | kOptBp | kOptRefresh:
      err = launch_fused<kOptPersist | kOptBp | kOptRefresh>(a, W, st);
      break;
    case kOptPersist | kOptBp | kOptRefresh | kOptSleep:
      err = launch_fused<kOptPersist | kOptBp | kOptRefresh | kOptSleep>(a, W, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int substep_launch(
    const void* pos, const void* rot, const void* v, const void* w, const void* prev_pos,
    const void* prev_rot, const void* im, const void* ii, const void* mu_s, const void* mu_d,
    const void* obj, const void* dyn, const void* h, const void* rest_thr, const void* rows_i,
    const void* rows_j, const void* kvalid, const void* table, int num_objects, int vm, int W,
    int n, int K, float relaxation, float speculative, int bounce, void* o_pos, void* o_rot,
    void* o_v, void* o_w, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || num_objects <= 0 || vm < 0 || vm > kMaxVerts)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, K, false, false);
  int threads;
  const cudaError_t err = launch_shape(substep_kernel, n, K, smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args1 a;
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
  a.tab = Table{static_cast<const float*>(table), 13 + 3 * vm, vm};
  a.n = n;
  a.K = K;
  a.bounce = bounce;
  a.relax = relaxation;
  a.spec = speculative;
  a.o_pos = static_cast<float*>(o_pos);
  a.o_rot = static_cast<float*>(o_rot);
  a.o_v = static_cast<float*>(o_v);
  a.o_w = static_cast<float*>(o_w);
  substep_kernel<<<W, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
