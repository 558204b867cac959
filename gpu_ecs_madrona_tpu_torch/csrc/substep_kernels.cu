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
// restitution, num_verts, verts (vm x 3).
struct Table {
  const float* t;
  int stride;
  int vm;
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
__device__ void pair_contacts(const Body& A, const Body& B, const Table& tab, float spec,
                              Manifold& out) {
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
  (void)num;
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

size_t smem_bytes(int n, int K) {
  return sizeof(float) * (static_cast<size_t>(kBodyCh) * n +
                          static_cast<size_t>(kSlotCh + kPackCh) * K) +
         sizeof(int) * (5 * static_cast<size_t>(K) + n + 1);
}

__global__ void __launch_bounds__(kMaxThreads) fused_substep_kernel(Args a) {
  extern __shared__ float smem[];
  const int wld = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, K = a.K;
  float* sb = smem;
  float* sst = sb + kBodyCh * n;
  float* spk = sst + kSlotCh * K;
  int* sri = reinterpret_cast<int*>(spk + kPackCh * K);
  int* srj = sri + K;
  int* skv = srj + K;
  int* soff = skv + K;      // n + 1: each body's first entry in slist
  int* slist = soff + n + 1;  // 2 K: (slot << 1 | side) per body, A sides first
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
  // kc = 1 + the last valid slot: the slot loops stop there (candidate
  // slots are a validity prefix, so this skips the dead tail)
  __shared__ int s_kc;
  if (tid == 0) s_kc = 0;
  __syncthreads();
  for (int k = tid; k < K; k += T) {
    const size_t g = static_cast<size_t>(wld) * K + k;
    sri[k] = min(max(a.rows_i[g], 0), n - 1);
    srj[k] = min(max(a.rows_j[g], 0), n - 1);
    skv[k] = a.kvalid[g] ? 1 : 0;
    if (skv[k]) atomicMax(&s_kc, k + 1);
  }
  const float h1 = a.h[wld], rest1 = a.rest_thr[wld];
  const V3 grav = mk(a.gravity[3 * wld], a.gravity[3 * wld + 1], a.gravity[3 * wld + 2]);
  __syncthreads();
  const int kc = s_kc;

  // Each body's pair sides, A sides in ascending slot order then B sides
  // (the candidate rows are fixed for the step): the segment sums walk
  // these lists instead of every slot.
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

    // (2-4) per slot: gather, pair_contacts, positional pass
    for (int k = tid; k < kc; k += T) {
      if (!skv[k]) continue;
      Side S[2];
      Body Bd[2];
      const int rows[2] = {sri[k], srj[k]};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int b = rows[s];
        Bd[s].pos = ld3(sb, kIPos, b, n);
        Bd[s].rot = ld4(sb, kIRot, b, n);
        Bd[s].obj = obj_of(sb, b, n);
        S[s].pos = Bd[s].pos;
        S[s].rot = Bd[s].rot;
        S[s].prev_pos = ld3(sb, kPrevPos, b, n);
        S[s].im = sb[kIm * n + b];
        S[s].ii = ld3(sb, kIi, b, n);
        S[s].mu = sb[kMuS * n + b];
      }
      Manifold c;
      pair_contacts(Bd[0], Bd[1], a.tab, a.spec, c);
      float pA[9], pB[9], lam[kPts];
      positional_pass(S[0], S[1], c, a.relax, pA, pB, lam);
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
      for (int s = 0; s < 2; ++s) {
        const int b = rows[s];
        S[s].pos = ld3(sb, kP2, b, n);
        S[s].rot = ld4(sb, kR2, b, n);
        S[s].v = ld3(sb, kV2, b, n);
        S[s].w = ld3(sb, kW2, b, n);
        S[s].pv = ld3(sb, kIV, b, n);
        S[s].pw = ld3(sb, kIW, b, n);
        S[s].im = sb[kIm * n + b];
        S[s].ii = ld3(sb, kIi, b, n);
        S[s].mu = sb[kMuD * n + b];
        S[s].rest = a.tab.rest(obj_of(sb, b, n));
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
      velocity_pass(S[0], S[1], c, lam, h1, rest1, a.bounce != 0, a.spec, pA, pB);
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
    void* o_ps_v, void* o_ps_w, void* stream) {
  if (W <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0 || K <= 0 || num_substeps < 0 || num_objects <= 0 || vm < 0 || vm > kMaxVerts)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_substep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int widest = n > K ? n : K;
  int threads = ((widest + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
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
  a.tab = Table{static_cast<const float*>(table), 7 + 3 * vm, vm};
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
  fused_substep_kernel<<<W, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
