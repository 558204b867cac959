"""The batch renderer's pixel kernel: wrapper, plain version, launch
counter, and ``RenderKernel``, which packs its inputs and unpacks its
outputs.

Counterpart of ``gpu_ecs_madrona_tpu/ops/render_kernel.py``
(``PallasRenderKernel``, ``_run`` -> ``_make_kernel``).  For each (world,
pixel) ray, ``render`` finds the nearest hit over the world's live
instances:

  - spheres (t > 1e-4);
  - convex hulls: the slab test over the object's face planes, the exit t
    when the ray starts inside;
  - planes (local +z; |denom| > 1e-6);
  - for objects with a triangle render mesh, Moeller-Trumbore over the
    mesh's triangles, which override the physics primitive;

keeps the winner's unnormalised normal (hull normal / scale; mesh normal
flipped toward the ray) and albedo, and shades it Lambert plus ambient.

Layout, channel-major as the TPU kernel's:

    rays  [W, 6, P]   ro xyz, rd xyz
    inst  [W, 12, N]  pos xyz, rot wxyz, scale xyz, obj, mask
    out   [W, 5, P]   r g b hit depth (f32; BIG = 1e9 at a miss)

A padded ray (|rd|^2 < 0.5, RenderKernel's padding) comes out as a miss; so
does every ray against an instance whose mask is 0 or whose object id is
outside the tables.  A world's instances that do not fit one block's shared
memory at once (``blocked``: above 1,614 rows in the rays mode, 2,421 in the
views mode) go to the mode's blocked twin, which stages the survivors of
its CTA's cone in stages (``rays_stage``, ``views_stage``), each pixel's
nearest hit carried from stage to stage; the outputs are the same.

On CUDA tensors ``render`` launches ``csrc/render_kernels.cu`` (its notes
say what bounds it and how it is laid out) or raises; on CPU tensors it
runs ``render_plain``, which tests every (pixel, instance) pair in the
kernel's order of operations, chunked over worlds to bound memory, without
the kernel's cull: the cull is conservative, so the two agree.  The
nearest hit wins; on a tie of t the first instance in index order (the
kernel's strict ``<``).

``render_views`` is the render node in one launch of the same kernel's
views mode: the views and instances as the render_pack node leaves them
in, RGBA8 [W, V, H, Wpx, 4] and depth [W, V, H, Wpx] out, each pixel's ray
made in the launch in ``camera_rays``' order of operations.  On CPU
tensors it runs ``render_views_plain``: ``camera_rays``, ``pack``,
``render_plain`` and ``observations`` composed, the node's route before
its views mode.  Launches of both modes are counted in
``RenderKernel.launches``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.ops import _build
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk
from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL, PRIM_PLANE, PRIM_SPHERE

BIG = 1e9
EPS = 1e-9

# instance channels (channel-major [W, C_INST, N])
I_POS = 0     # 0:3
I_ROT = 3     # 3:7 (w,x,y,z)
I_SCALE = 7   # 7:10
I_OBJ = 10
I_MASK = 11
C_INST = 12

# output channels
O_R, O_G, O_B, O_HIT, O_DEPTH = range(5)
C_OUT = 5

# The kernel's object table, one row of float32 per object: these fixed
# columns, then (nx, ny, nz, d) for each of F_used face planes, then
# (a, e1, e2, n, live) for each of T_used triangles (13 floats).
K_PRIM, K_RADIUS, K_RBOUND, K_ALBEDO, K_MESH, K_NFACE = 0, 1, 2, 3, 6, 7
K_FIXED = 8
K_FACE, K_TRI = 4, 13

# The kernel's launch (csrc/render_kernels.cu): CTAs of WARPS warps, one per
# world in the rays mode and per (world, view) in the views mode, or
# ``splits`` CTAs sharing one; each warp traces TILE_W x TILE_H pixel tiles.
# A CTA keeps STAGE_RAYS (rays mode: 4 float4s, and each warp's cull terms
# from its tiles' apex, a float4 and a float) or STAGE_VIEWS (views mode: 6
# float4s) bytes an instance in shared memory, at most 227 KB a block on an
# H100.
WARPS = 4
TILE_W, TILE_H = 8, 4
STAGE_RAYS, STAGE_VIEWS = 4 * 16 + WARPS * 20, 6 * 16
MAX_SMEM_BYTES = 227 * 1024
# A world whose instances do not fit MAX_SMEM_BYTES at once takes the
# mode's blocked twin (csrc/render_kernels.cu render_views_blocked_kernel,
# render_rays_blocked_kernel): CTAs of VIEWS_WARPS warps, VIEWS_CTAS CTAs an
# SM, each through stages of the survivors of its cone, VIEWS_ENTRY bytes
# each (six float4s and the index), each pixel's nearest hit carried in
# shared memory (8 bytes a pixel of the CTA's tiles); VIEWS_SMEM dynamic
# shared bytes a CTA at most.  Views mode: views_splits(H, Wpx) CTAs an
# image (VIEWS_SPLITS, at most one a VIEWS_WARPS tiles), stages of
# views_stage(H, Wpx) survivors of the view's cone, the carried hits in the
# image's outputs past CARRY_MAX bytes.  Rays mode: rays_splits(tiles) CTAs
# an image (RAYS_SPLITS, at most one a VIEWS_WARPS tiles, more where a CTA
# would have more than RAYS_TILES tiles), each a strip of the image (the
# tiles in column-major order, rays_pixel_cta) whose rays' cone it culls
# against, stages of rays_stage(its tiles) survivors beside
# RAYS_TILE_BYTES a tile (the tile's cone and its pixels' carried hits).
VIEWS_SPLITS = 2
VIEWS_WARPS = 8
VIEWS_CTAS = 2
VIEWS_ENTRY = 6 * 16 + 4
CARRY_MAX = 65536
VIEWS_SMEM = (MAX_SMEM_BYTES if VIEWS_CTAS == 1 else 233472 // VIEWS_CTAS - 1024) - 1024
RAYS_SPLITS = 4
RAYS_TILES = 128
RAYS_TILE_BYTES = 16 + 32 * 8
# the cull's widening of each bounding sphere, relative and absolute (the
# .cu's kCullRel, kCullAbs): far past the rounding of the cone test
CULL_REL, CULL_ABS = 1e-3, 1e-3
# CTAs a launch aims for (132 SMs x 16, two waves of 8 CTAs an SM): images
# are split until the grid has them, so that the last wave is short and
# small world counts still fill the card (the fastest of 1056, 2112, 4096
# and 8192 on an H100 at simple_taskgraph's 1024 views: PERF.md)
MIN_CTAS = 2112
MAX_SPLITS = 65535
# elements of one [worlds, P, N] block of the plain version
PLAIN_BLOCK = 1 << 23


class RenderTables:
    """The object manager, albedo and (optional) triangle render meshes as
    numpy, the JAX class's fields one for one (float64 copies of the
    float32 tables; ``tri_n`` the float64 cross product of the edges).

    ``r_bound``: each object's bounding radius for the kernel's cull, the
    norm of its local AABB's farthest corner, widened to its render
    mesh's farthest vertex.  An object manager without ``local_aabb_lo``
    gets max(2.0, sphere_radius): the JAX kernel's fallback, kept as it is
    (a hull wider than 2.0 is then culled too early)."""

    def __init__(self, objmgr, albedo, mesh_tables=None):
        om = {k: np.asarray(v) for k, v in objmgr.items()}
        self.O = int(om["prim_type"].shape[0])
        self.prim_type = [int(x) for x in om["prim_type"]]
        self.radius = [float(x) for x in om["sphere_radius"]]
        self.Fm = int(om["face_normals"].shape[1])
        self.face_n = om["face_normals"].astype(np.float64)   # [O, F, 3]
        self.face_d = om["face_d"].astype(np.float64)         # [O, F]
        self.num_faces = [int(x) for x in om["num_faces"]]
        self.albedo = np.asarray(albedo, np.float64)          # [O, 3]
        used = [self.num_faces[o] for o in range(self.O) if self.prim_type[o] == PRIM_HULL]
        self.F_used = max(used) if used else 0
        if "local_aabb_lo" in om:
            self.r_bound = [float(np.linalg.norm(np.maximum(
                np.abs(om["local_aabb_lo"][o]), np.abs(om["local_aabb_hi"][o]))))
                for o in range(self.O)]
        else:
            self.r_bound = [max(2.0, self.radius[o]) for o in range(self.O)]
        if mesh_tables is not None and np.asarray(mesh_tables["has_mesh"]).any():
            self.has_mesh = [bool(x) for x in mesh_tables["has_mesh"]]
            self.tri_a = np.asarray(mesh_tables["tri_a"], np.float64)
            self.tri_e1 = np.asarray(mesh_tables["tri_e1"], np.float64)
            self.tri_e2 = np.asarray(mesh_tables["tri_e2"], np.float64)
            self.tri_mask = np.asarray(mesh_tables["tri_mask"], bool)
            self.tri_n = np.cross(self.tri_e1, self.tri_e2)   # [O, T, 3]
            self.T_used = int(self.tri_mask.sum(axis=1).max())
        else:
            self.has_mesh = [False] * self.O
            self.tri_a = self.tri_e1 = self.tri_e2 = self.tri_n = np.zeros((self.O, 0, 3))
            self.tri_mask = np.zeros((self.O, 0), bool)
            self.T_used = 0
        for o in range(self.O):
            if self.has_mesh[o] and self.tri_mask[o].any():
                tm = self.tri_mask[o]
                corners = np.concatenate([self.tri_a[o][tm], self.tri_a[o][tm] + self.tri_e1[o][tm],
                                          self.tri_a[o][tm] + self.tri_e2[o][tm]], axis=0)
                self.r_bound[o] = max(self.r_bound[o],
                                      float(np.linalg.norm(corners, axis=1).max()))
        self._by_device = {}

    @property
    def stride(self) -> int:
        """Floats per object in the kernel table."""
        return K_FIXED + K_FACE * self.F_used + K_TRI * self.T_used

    def table(self) -> np.ndarray:
        """The kernel table [O, stride] float32 (see K_* above).  A face
        slot past an object's face count, and a triangle slot of an object
        without a mesh or past its triangles, holds zeros, as the JAX
        kernel's folded constants do."""
        rows = np.zeros((self.O, self.stride), np.float64)
        for o in range(self.O):
            rows[o, K_PRIM] = self.prim_type[o]
            rows[o, K_RADIUS] = self.radius[o]
            rows[o, K_RBOUND] = self.r_bound[o]
            rows[o, K_ALBEDO:K_ALBEDO + 3] = self.albedo[o]
            rows[o, K_MESH] = float(self.has_mesh[o])
            rows[o, K_NFACE] = self.num_faces[o]
            for f in range(min(self.F_used, self.num_faces[o])):
                c = K_FIXED + K_FACE * f
                rows[o, c:c + 3] = self.face_n[o, f]
                rows[o, c + 3] = self.face_d[o, f]
            for t in range(self.T_used):
                if not (self.has_mesh[o] and t < self.tri_mask.shape[1] and self.tri_mask[o, t]):
                    continue
                c = K_FIXED + K_FACE * self.F_used + K_TRI * t
                rows[o, c:c + 3] = self.tri_a[o, t]
                rows[o, c + 3:c + 6] = self.tri_e1[o, t]
                rows[o, c + 6:c + 9] = self.tri_e2[o, t]
                rows[o, c + 9:c + 12] = self.tri_n[o, t]
                rows[o, c + 12] = 1.0
        return rows.astype(np.float32)

    def kernel_table(self, device) -> torch.Tensor:
        """``table()`` on ``device``, built and copied once per device, so a
        render call queues no host-to-device copy."""
        dev = torch.device(device)
        t = self._by_device.get(dev)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(self.table()), device=dev)
            self._by_device[dev] = t
        return t

    def key(self):
        return (self.O, tuple(self.prim_type), tuple(self.radius), self.Fm,
                self.face_n.tobytes(), self.face_d.tobytes(), tuple(self.num_faces),
                self.albedo.tobytes(), self.F_used, tuple(self.has_mesh),
                self.tri_a.tobytes(), self.tri_e1.tobytes(), self.tri_e2.tobytes(),
                self.tri_mask.tobytes(), self.T_used, tuple(self.r_bound))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _nonzero_sign(x):
    """x where |x| >= EPS, else +-EPS by the sign of x (>= 0 is +)."""
    return torch.where(torch.abs(x) < EPS, torch.where(x >= 0, EPS, -EPS), x)


def _plain_block(rays, inst, tables: RenderTables, light, ambient):
    """render_plain on one block of worlds: [w, P, N] pair tensors.  Returns
    (out [w, 5, P], each ray's winner [w, P], -1 at a miss)."""
    dev = rays.device
    tab = tables.kernel_table(dev)
    F, T = tables.F_used, tables.T_used
    ro = tuple(rays[:, c, :, None] for c in range(3))               # [w, P, 1]
    rd = tuple(rays[:, 3 + c, :, None] for c in range(3))
    pad = (rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]) < 0.5     # [w, P, 1]

    def ch(c):
        return inst[:, c, None, :]                                   # [w, 1, N]

    pos = tuple(ch(I_POS + c) for c in range(3))
    rot = tuple(ch(I_ROT + c) for c in range(4))
    scl = tuple(ch(I_SCALE + c) for c in range(3))
    obj_f = ch(I_OBJ)
    o = obj_f.to(torch.int64)
    live = (ch(I_MASK) > 0.5) & (o.to(torch.float32) == obj_f) & (o >= 0) & (o < tables.O)
    o = o.clamp(0, tables.O - 1)
    rows = tab[o[:, 0]][:, None]                                     # [w, 1, N, S]

    def col(k):
        return rows[..., k]

    prim = col(K_PRIM)
    is_sph, is_hull = prim == PRIM_SPHERE, prim == PRIM_HULL
    rot = (torch.where(live, rot[0], 1.0),) + rot[1:]

    # sphere
    rad = col(K_RADIUS) * scl[0]
    oc = pk.v3sub(ro, pos)
    b = pk.dot3(oc, rd)
    c = pk.dot3(oc, oc) - rad * rad
    disc = b * b - c
    t_sph = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t_sph = torch.where((disc >= 0) & (t_sph > 1e-4), t_sph, BIG)

    # the ray in the object's unscaled local frame
    inv_s = tuple(1.0 / torch.clamp(s, min=EPS) for s in scl)
    ro_l = tuple(a * s for a, s in zip(pk.qrot_inv(rot, pk.v3sub(ro, pos)), inv_s))
    rd_l = tuple(a * s for a, s in zip(pk.qrot_inv(rot, rd), inv_s))
    zero = torch.zeros_like(t_sph)

    # convex hull: slab over the face planes
    if F:
        t_enter = torch.full_like(t_sph, -BIG)
        t_exit = torch.full_like(t_sph, BIG)
        par_out = torch.zeros_like(pad & live)
        n_l = (zero, zero, zero)
        nfaces = col(K_NFACE)
        for f in range(F):
            k = K_FIXED + K_FACE * f
            nf = (col(k), col(k + 1), col(k + 2))
            fval = nfaces > f
            denom = pk.dot3(nf, rd_l)
            dist = col(k + 3) - pk.dot3(nf, ro_l)
            small = torch.abs(denom) < EPS
            t_f = dist / torch.where(small, torch.where(denom >= 0, EPS, -EPS), denom)
            upd = (denom < 0) & fval & (t_f > t_enter)
            t_enter = torch.where(upd, t_f, t_enter)
            n_l = tuple(torch.where(upd, a, cur) for a, cur in zip(nf, n_l))
            exiting = ~(denom < 0) & fval
            t_exit = torch.where(exiting, torch.minimum(t_exit, t_f), t_exit)
            par_out = par_out | (fval & small & (dist < 0))
        hit_h = (t_enter <= t_exit) & (t_exit > 1e-4) & ~par_out
        t_hull = torch.where(t_enter > 1e-4, t_enter, t_exit)
        t_hull = torch.where(hit_h & is_hull, t_hull, BIG)
        nh = pk.qrot(rot, tuple(a * s for a, s in zip(n_l, inv_s)))
    else:
        t_hull = torch.full_like(t_sph, BIG)
        nh = (zero, zero, zero)

    # plane (local +z)
    one = torch.ones_like(pos[0])
    n_p = pk.qrot(rot, (torch.zeros_like(pos[0]), torch.zeros_like(pos[0]), one))
    denom_p = pk.dot3(rd, n_p)
    t_pl = pk.dot3(pk.v3sub(pos, ro), n_p) / _nonzero_sign(denom_p)
    t_pl = torch.where((t_pl > 1e-4) & (torch.abs(denom_p) > 1e-6), t_pl, BIG)

    t_i = torch.where(is_sph, t_sph, torch.where(is_hull, t_hull, t_pl))
    ns = pk.v3sub(pk.v3add(ro, pk.v3scale(rd, t_i)), pos)
    n_i = tuple(torch.where(is_sph, a, torch.where(is_hull, h, p))
                for a, h, p in zip(ns, nh, n_p))

    # triangle render mesh: Moeller-Trumbore, overriding the primitive
    if T:
        t_msh = torch.full_like(t_sph, BIG)
        n_ml = (zero, zero, zero)
        for tt in range(T):
            k = K_FIXED + K_FACE * F + K_TRI * tt
            a_t = (col(k), col(k + 1), col(k + 2))
            e1 = (col(k + 3), col(k + 4), col(k + 5))
            e2 = (col(k + 6), col(k + 7), col(k + 8))
            n_t = (col(k + 9), col(k + 10), col(k + 11))
            live_t = col(k + 12) > 0.5
            pvec = pk.cross3(rd_l, e2)
            det = pk.dot3(e1, pvec)
            inv_det = 1.0 / _nonzero_sign(det)
            tvec = pk.v3sub(ro_l, a_t)
            u = pk.dot3(tvec, pvec) * inv_det
            qvec = pk.cross3(tvec, e1)
            v = pk.dot3(rd_l, qvec) * inv_det
            t_t = pk.dot3(e2, qvec) * inv_det
            hit_t = (live_t & (torch.abs(det) > EPS) & (u >= -1e-6) & (v >= -1e-6)
                     & (u + v <= 1 + 1e-6) & (t_t > 1e-4))
            t_t = torch.where(hit_t, t_t, BIG)
            upd = t_t < t_msh
            t_msh = torch.where(upd, t_t, t_msh)
            n_ml = tuple(torch.where(upd, a, cur) for a, cur in zip(n_t, n_ml))
        n_mw = pk.qrot(rot, tuple(a * s for a, s in zip(n_ml, inv_s)))
        flip = pk.dot3(n_mw, rd) > 0
        is_mesh = col(K_MESH) > 0.5
        t_i = torch.where(is_mesh, t_msh, t_i)
        n_i = tuple(torch.where(is_mesh, torch.where(flip, -a, a), cur)
                    for a, cur in zip(n_mw, n_i))
    t_i = torch.where(live, t_i, BIG)

    # the nearest hit, the first instance in index order on a tie
    best_t = t_i.amin(dim=2, keepdim=True)                           # [w, P, 1]
    win = (t_i == best_t).to(torch.uint8).argmax(dim=2, keepdim=True)
    hit = best_t < BIG * 0.5

    def pick(x):
        return torch.where(hit, torch.gather(x.expand(t_i.shape), 2, win), 0.0)

    best_n = tuple(pick(a) for a in n_i)
    alb = tuple(pick(col(K_ALBEDO + c)) for c in range(3))
    inv_len = 1.0 / torch.sqrt(torch.clamp(pk.dot3(best_n, best_n), min=EPS))
    best_n = pk.v3scale(best_n, inv_len)
    lam = torch.clamp(best_n[0] * light[0] + best_n[1] * light[1] + best_n[2] * light[2],
                      min=0.0)
    shade = ambient + (1.0 - ambient) * lam
    hitf = torch.where(hit, 1.0, 0.0)
    out = [a * shade * hitf for a in alb] + [hitf, torch.where(hit, best_t, BIG)]
    out = torch.cat(out, dim=2).transpose(1, 2)                     # [w, 5, P]
    miss = torch.tensor([0.0, 0.0, 0.0, 0.0, BIG], device=dev)[None, :, None]
    return (torch.where(pad.transpose(1, 2), miss, out),
            torch.where(hit & ~pad, win, -1)[..., 0])


def render_plain(rays, inst, *, tables: RenderTables, light, ambient: float,
                 winners: bool = False):
    """The plain PyTorch version of the render kernel (see the module doc):
    rays [W, 6, P], inst [W, 12, N] float32 -> out [W, 5, P] float32.
    ``light``: the unit vector toward the light (3 floats).  ``winners``:
    also each ray's winning instance row [W, P] int64 (-1 at a miss)."""
    W, _, P = rays.shape
    N = inst.shape[2]
    out = torch.empty((W, C_OUT, P), dtype=torch.float32, device=rays.device)
    win = torch.full((W, P), -1, dtype=torch.int64, device=rays.device)
    if N == 0:
        out[:] = torch.tensor([0.0, 0.0, 0.0, 0.0, BIG], device=rays.device)[None, :, None]
        return (out, win) if winners else out
    step = max(1, PLAIN_BLOCK // max(1, P * N))
    for w0 in range(0, W, step):
        out[w0:w0 + step], win[w0:w0 + step] = _plain_block(
            rays[w0:w0 + step], inst[w0:w0 + step], tables, light, ambient)
    return (out, win) if winners else out


# ---------------------------------------------------------------------------
# The render node's camera rays and observations
# ---------------------------------------------------------------------------


def pixel_ndc(n: int, device):
    """The centres of n pixels in [-1, 1], ((i + 0.5) / n) * 2 - 1, each step
    rounded on its own as the kernel rounds it: the division is by a tensor,
    since PyTorch on the card multiplies by the reciprocal of a Python
    scalar divisor."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i + 0.5) / torch.full_like(i, float(n)) * 2.0 - 1.0


def camera_rays(views, V: int, H: int, Wpx: int):
    """Pinhole rays of the first V views (``ctx.data["render"]["__views__"]``):
    (ro, d) [W, V, H, Wpx, 3], looking down +y in camera space with +z up,
    rotated by each view's rotation; NDC in [-1, 1].

    Every product, sum and norm is its own elementwise operation in a fixed
    order, so the card and the kernel's views mode round them alike: the
    rotation is quat_rotate's v + 2 (w uv + u x uv) with uv = u x v, each
    cross product's components written out (physics/pairs.py cross3, no
    fused multiply-add), and |d| adds its squares in component order."""
    eye, rot, tanf = views["eye"][:, :V], views["rot"][:, :V], views["tan_fov"][:, :V]
    W, dev = eye.shape[0], eye.device
    px = pixel_ndc(Wpx, dev)[None, None, None, :]                     # [1, 1, 1, Wpx]
    py = -pixel_ndc(H, dev)[None, None, :, None]                      # [1, 1, H, 1]
    tanf = tanf[:, :, None, None]
    shape = (W, V, H, Wpx)
    v = ((px * tanf).expand(shape), torch.ones(shape, device=dev), (py * tanf).expand(shape))
    q = tuple(rot[:, :, None, None, c] for c in range(4))
    u = q[1:]
    uv = pk.cross3(u, v)
    uuv = pk.cross3(u, uv)
    d = tuple(a + 2.0 * (q[0] * b + c) for a, b, c in zip(v, uv, uuv))
    n = torch.sqrt(pk.dot3(d, d))
    d = torch.stack([a / n for a in d], dim=-1)
    return eye[:, :, None, None, :].expand(d.shape), d


def observations(rgb, hit, depth, alive):
    """The render node's outputs from rgb [W, V, H, Wpx, 3] in [0, 1], hit
    and depth [W, V, H, Wpx] and the views' alive [W, V]: (RGBA8 [W, V, H,
    Wpx, 4], alpha 255 on a hit; depth, inf at a miss), both 0 / inf on a
    dead view.  The cast truncates, as the JAX node's does."""
    rgba = torch.cat([rgb, torch.where(hit[..., None], 1.0, 0.0)], dim=-1)
    rgba8 = (torch.clamp(rgba, 0, 1) * 255).to(torch.uint8)
    depth = torch.where(hit, depth, math.inf)
    alive = alive[:, :, None, None]
    return (torch.where(alive[..., None], rgba8, 0), torch.where(alive, depth, math.inf))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("render_kernels")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.render_launch.argtypes = [P, P, P] + [I] * 9 + [F] * 5 + [I] + [P, P]
        lib.render_launch.restype = I
        lib.render_views_launch.argtypes = ([P] * 4 + [I] * 4 + [P] * 6 + [I] * 7 + [F] * 5
                                            + [I] + [P] * 3)
        lib.render_views_launch.restype = I
        lib.render_occupancy.argtypes = [I, I, I, I, I, P]
        lib.render_occupancy.restype = I
        lib._typed = True
    return lib


def blocked(N: int, views: bool = False) -> bool:
    """Whether the mode takes N instances in stages (their STAGE_RAYS or
    STAGE_VIEWS bytes each pass MAX_SMEM_BYTES)."""
    return N * (STAGE_VIEWS if views else STAGE_RAYS) > MAX_SMEM_BYTES


def views_splits(H: int, Wpx: int) -> int:
    """The views mode's blocked twin: its CTAs an H x Wpx image
    (views_splits in the .cu)."""
    tiles = -(-Wpx // TILE_W) * -(-H // TILE_H)
    return min(-(-tiles // VIEWS_WARPS), VIEWS_SPLITS)


def views_carry_bytes(H: int, Wpx: int) -> int:
    """The views mode's blocked twin: the shared bytes of a CTA's carried
    hits at an H x Wpx image (8 a pixel of its tiles), or 0 where they pass
    CARRY_MAX and wait in the image's outputs (views_carry_bytes in the
    .cu)."""
    tiles = -(-Wpx // TILE_W) * -(-H // TILE_H)
    nbytes = 8 * 32 * VIEWS_WARPS * -(-tiles // (views_splits(H, Wpx) * VIEWS_WARPS))
    return nbytes if nbytes <= CARRY_MAX else 0


def views_stage(H: int, Wpx: int) -> int:
    """The survivors a stage of the views mode's blocked twin holds at an H x
    Wpx image: what VIEWS_SMEM leaves beside the carried hits, a multiple of
    32 (views_stage in the .cu)."""
    return (VIEWS_SMEM - views_carry_bytes(H, Wpx)) // VIEWS_ENTRY // 32 * 32


def views_blocked_stage(H: int, Wpx: int) -> int:
    """The stage a views-mode blocked launch asks for: views_stage (the card
    tests patch this to hold a smaller one to the kernel's)."""
    return views_stage(H, Wpx)


def image_tiles(H: int, Wpx: int) -> int:
    """The 8 x 4 tiles of an H x Wpx image."""
    return -(-Wpx // TILE_W) * -(-H // TILE_H)


def rays_splits(tiles: int) -> int:
    """The rays mode's blocked twin: its CTAs an image of ``tiles`` tiles
    (rays_splits in the .cu)."""
    return max(min(-(-tiles // VIEWS_WARPS), RAYS_SPLITS), -(-tiles // RAYS_TILES))


def rays_stage(cta_tiles: int) -> int:
    """The survivors a stage of the rays mode's blocked twin holds beside a
    CTA's ``cta_tiles`` tiles (their cones and carried hits), a multiple of
    32 (rays_stage in the .cu)."""
    return (VIEWS_SMEM - RAYS_TILE_BYTES * cta_tiles) // VIEWS_ENTRY // 32 * 32


def rays_blocked_splits(tiles: int) -> int:
    """The CTAs an image a rays-mode blocked launch asks for: rays_splits
    (the card tests patch this to hold more of them to the kernel's)."""
    return rays_splits(tiles)


def rays_blocked_stage(cta_tiles: int) -> int:
    """The stage a rays-mode blocked launch asks for: rays_stage (the card
    tests patch this to hold a smaller one to the kernel's)."""
    return rays_stage(cta_tiles)


def _blocked_stage(views: bool, H: int, Wpx: int) -> int:
    """The survivors a stage of the mode's blocked twin holds at an H x Wpx
    image (rays: H rows of Wpx rays, rays_splits CTAs an image)."""
    if views:
        return views_stage(H, Wpx)
    tiles = image_tiles(H, Wpx)
    return rays_stage(-(-tiles // rays_splits(tiles)))


def stage_blocks(N: int, views: bool = False, H: int = 64, Wpx: int = 64) -> int:
    """The stages a CTA fills for N instances at an H x Wpx image (rays: H
    rows of Wpx rays): 1 when they fit at once; in a blocked twin the
    stages at most (its cone may leave fewer survivors)."""
    if not blocked(N, views):
        return 1
    return -(-N // _blocked_stage(views, H, Wpx))


def smem_bytes(N: int, views: bool = False, H: int = 64, Wpx: int = 64) -> int:
    """The kernel's dynamic shared memory for N instances: STAGE_RAYS or
    STAGE_VIEWS bytes each, or blocked: the twin's stage and its CTA's
    carried hits (rays: and tile cones) at an H x Wpx image."""
    if not blocked(N, views):
        return N * (STAGE_VIEWS if views else STAGE_RAYS)
    if views:
        return views_stage(H, Wpx) * VIEWS_ENTRY + views_carry_bytes(H, Wpx)
    tiles = image_tiles(H, Wpx)
    cta_tiles = -(-tiles // rays_splits(tiles))
    return rays_stage(cta_tiles) * VIEWS_ENTRY + RAYS_TILE_BYTES * cta_tiles


def rays_pixel_cta(P: int, img_w: int, splits: int, device="cpu"):
    """The rays-mode blocked twin's CTA of each of P pixels in rows of
    img_w: its tiles are numbered in column-major order and CTA s owns
    tiles [s cta_tiles, (s + 1) cta_tiles), a strip of whole tile columns
    where splits divides them."""
    tiles = tile_shape(P, img_w)[3]
    rows = -(-P // img_w)
    tiles_y = -(-rows // TILE_H)
    px = torch.arange(P, device=device)
    tile = (px % img_w) // TILE_W * tiles_y + px // img_w // TILE_H
    return tile // -(-tiles // splits)


def rays_cta_cull(rays, inst, tables: RenderTables, img_w: int, splits: int = None):
    """The rays-mode blocked twin's staging cull, in PyTorch: for each CTA
    of each world (``splits`` of them, rays_splits by default), whether
    each instance is staged.  rays [W, 6, P], inst [W, 12, N] float32 ->
    keep [W, splits, N] bool.

    The kernel's formula in float32 (its sums in another order): the CTA's
    traced rays (|rd|^2 >= 0.5) are those of its tiles (rays_pixel_cta);
    its cone's axis is their mean direction, cos_m the least cosine to it
    (clamped to [-1, 1]); its apex their common origin where they all start at one
    point bit for bit (spread 0), else their origins' mean, spread the
    greatest distance from it.  An instance is staged where it is live and
    a plane, or its bounding sphere (r_bound x its largest scale, plus the
    spread, widened by CULL_REL and CULL_ABS) meets the cone."""
    W, _, P = rays.shape
    dev = rays.device
    splits = rays_splits(tile_shape(P, img_w)[3]) if splits is None else int(splits)
    cta = rays_pixel_cta(P, img_w, splits, dev)
    ro, rd = rays[:, 0:3].transpose(1, 2), rays[:, 3:6].transpose(1, 2)    # [W, P, 3]
    traced = pk.dot3(rd.unbind(-1), rd.unbind(-1)) >= 0.5                # [W, P]
    obj_f = inst[:, I_OBJ]
    o = obj_f.to(torch.int64)
    live = (inst[:, I_MASK] > 0.5) & (o.to(torch.float32) == obj_f) & (o >= 0) & (o < tables.O)
    row = tables.kernel_table(dev)[o.clamp(0, tables.O - 1)]             # [W, N, S]
    rbs = row[..., K_RBOUND] * inst[:, I_SCALE:I_SCALE + 3].amax(1)
    plane = row[..., K_PRIM] == PRIM_PLANE
    pos = inst[:, I_POS:I_POS + 3].transpose(1, 2)                       # [W, N, 3]
    keep = torch.zeros((W, splits, inst.shape[2]), dtype=torch.bool, device=dev)
    for split in range(splits):
        m = traced & (cta == split)[None]
        mf = m.to(torch.float32)[..., None]
        cnt = m.sum(1)
        sd = (rd * mf).sum(1)                                            # [W, 3]
        ax = sd / torch.sqrt(torch.clamp(pk.dot3(sd.unbind(-1), sd.unbind(-1)), min=EPS))[:, None]
        cos_m = torch.where(m, pk.dot3(rd.unbind(-1), tuple(c[:, None] for c in ax.unbind(-1))),
                            1.0).amin(1).clamp(-1.0, 1.0)
        sin_m = torch.sqrt(torch.clamp(1.0 - cos_m * cos_m, min=0.0))
        bits = ro.contiguous().view(torch.int32)
        big = torch.iinfo(torch.int32).max
        lo = torch.where(m[..., None], bits, big).amin(1)
        hi = torch.where(m[..., None], bits, -big - 1).amax(1)
        one = (cnt > 0) & (lo == hi).all(-1)
        apex = torch.where(one[:, None], lo.view(torch.float32),
                           (ro * mf).sum(1) / torch.clamp(cnt, min=1)[:, None].to(torch.float32))
        dro = ro - apex[:, None]
        d2 = torch.where(m, pk.dot3(dro.unbind(-1), dro.unbind(-1)), 0.0).amax(1)
        spread = torch.where(one, 0.0, torch.sqrt(d2))
        r_eff = (rbs + spread[:, None]) * (1.0 + CULL_REL) + CULL_ABS   # [W, N]
        d = pos - apex[:, None]
        dist = torch.sqrt(torch.clamp(pk.dot3(d.unbind(-1), d.unbind(-1)), min=EPS))
        cos_ad = pk.dot3(d.unbind(-1), tuple(c[:, None] for c in ax.unbind(-1))) / dist
        sin_b = torch.clamp(r_eff / dist, 0.0, 1.0)
        cos_b = torch.sqrt(torch.clamp(1.0 - sin_b * sin_b, min=0.0))
        meets = ((cos_m[:, None] <= -cos_b)
                 | (cos_ad >= cos_m[:, None] * cos_b - sin_m[:, None] * sin_b) | (dist <= r_eff))
        keep[:, split] = live & (plane | meets) & (cnt > 0)[:, None]
    return keep


def tile_shape(P: int, img_w: int):
    """(img_w, tile_w, tile_h, tiles): pixel p is (row p // img_w, column
    p % img_w); a warp's tile is tile_w x tile_h pixels, one a lane."""
    rows = -(-P // img_w)
    tiles = -(-img_w // TILE_W) * -(-rows // TILE_H)
    return img_w, TILE_W, TILE_H, tiles


def launch_splits(blocks: int, tiles: int) -> int:
    """The CTAs that share one image (a world, or a (world, view)): enough
    that ``blocks`` images make MIN_CTAS CTAs, at most a CTA per WARPS
    tiles."""
    return max(1, min(-(-MIN_CTAS // max(blocks, 1)), -(-tiles // WARPS), MAX_SPLITS))


def kernel_fits(N: int, views: bool = False) -> str:
    """'' when the kernel's mode takes N instances (any N >= 1: past
    MAX_SMEM_BYTES in blocks), else why not."""
    if N < 1:
        return f"N={N} instances: the kernel needs at least one"
    return ""


def occupancy(N: int, views: bool = False, H: int = 64, Wpx: int = 64) -> int:
    """CTAs an SM of the mode's kernel at N instances (a blocked twin at an
    H x Wpx image, rays: H rows of Wpx rays; needs the card)."""
    n = ctypes.c_int(0)
    block = _blocked_stage(views, H, Wpx) if blocked(N, views) else 0
    rc = _lib().render_occupancy(int(views), N, block, H, Wpx, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"render occupancy failed with cudaError {rc}")
    return n.value


def render(rays, inst, *, tables: RenderTables, light, ambient: float, img_w: int):
    """rays [W, 6, P], inst [W, 12, N] float32 -> out [W, 5, P] float32 (see
    the module doc).  ``img_w``: pixels per image row, so the kernel's
    tiles are 2-D blocks of the image.  CPU tensors: the plain version.
    CUDA tensors: the kernel (its blocked twin where the instances do not
    fit at once), or a raise (bad input, tables or shapes the kernel does
    not take, a failed launch) — never the plain version."""
    if rays.device != inst.device:
        raise ValueError(f"render: rays on {rays.device}, inst on {inst.device}")
    for name, t, c in (("rays", rays, 6), ("inst", inst, C_INST)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[1] != c:
            raise ValueError(f"render: {name} must be float32 [W, {c}, *], got {t.dtype} "
                             f"{list(t.shape)}")
    if rays.shape[0] != inst.shape[0]:
        raise ValueError(f"render: {rays.shape[0]} worlds of rays, {inst.shape[0]} of inst")
    if len(light) != 3:
        raise ValueError("render: light must have 3 components")
    if int(img_w) < 1:
        raise ValueError(f"render: img_w must be a positive image width, got {img_w}")
    if rays.device.type == "cpu":
        return render_plain(rays, inst, tables=tables, light=light, ambient=ambient)
    if rays.device.type != "cuda":
        raise ValueError(f"render: no kernel for device {rays.device}")
    if not (rays.is_contiguous() and inst.is_contiguous()):
        raise ValueError("render: rays and inst must be contiguous")
    W, _, P = rays.shape
    N = inst.shape[2]
    why = kernel_fits(N)
    if why:
        raise NotImplementedError(f"render: {why}")
    table = tables.kernel_table(rays.device)
    out = torch.empty((W, C_OUT, P), dtype=torch.float32, device=rays.device)
    if W == 0 or P == 0:
        return out
    tiles = tile_shape(P, img_w)[3]
    if blocked(N):   # the blocked twin: strips of tiles, stages of survivors
        splits = rays_blocked_splits(tiles)
        block = rays_blocked_stage(-(-tiles // splits))
        if splits > MAX_SPLITS:
            raise NotImplementedError(
                f"render: {tiles} tiles an image take {splits} CTAs an image in the blocked "
                f"twin, past the grid's {MAX_SPLITS}")
    else:
        splits, block = launch_splits(W, tiles), 0
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    rc = _lib().render_launch(
        rays.data_ptr(), inst.data_ptr(), table.data_ptr(), tables.O, tables.stride,
        tables.F_used, tables.T_used, W, P, N, img_w, splits,
        float(light[0]), float(light[1]), float(light[2]), float(ambient),
        float(1.0 - ambient), block, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"render: kernel launch failed with cudaError {rc}")
    RenderKernel.launches += 1
    return out


def pack(ro, rd, pos, rot, scale, obj, mask):
    """(rays [W, 6, P], inst [W, 12, N]) from ro/rd [W, P0, 3] and the
    instance arrays [W, N, ...]; P is P0 padded to a multiple of 128 with
    zero rays, as PallasRenderKernel pads it."""
    W, P0, _ = ro.shape
    P = max(128, -(-P0 // 128) * 128)
    rays = torch.zeros((W, 6, P), dtype=torch.float32, device=ro.device)
    rays[:, 0:3, :P0] = ro.transpose(1, 2)
    rays[:, 3:6, :P0] = rd.transpose(1, 2)
    inst = torch.cat([pos.transpose(1, 2), rot.transpose(1, 2), scale.transpose(1, 2),
                      obj.to(torch.float32)[:, None, :],
                      mask.to(torch.float32)[:, None, :]], dim=1).contiguous()
    return rays, inst


def _check_views(views, pos, rot, scale, obj, mask, light, height, width, max_views):
    """render_views' input checks: (W, N, the views' capacity Vc)."""
    vmask = views["mask"]
    if vmask.dim() != 2 or mask.dim() != 2:
        raise ValueError("render_views: the views' and the instances' masks must be [W, *], "
                         f"got {list(vmask.shape)} and {list(mask.shape)}")
    (W, Vc), N = vmask.shape, mask.shape[1]
    for name, t, dtype, shape in (
            ("views['eye']", views["eye"], torch.float32, (W, Vc, 3)),
            ("views['rot']", views["rot"], torch.float32, (W, Vc, 4)),
            ("views['tan_fov']", views["tan_fov"], torch.float32, (W, Vc)),
            ("views['mask']", vmask, torch.bool, (W, Vc)),
            ("pos", pos, torch.float32, (W, N, 3)), ("rot", rot, torch.float32, (W, N, 4)),
            ("scale", scale, torch.float32, (W, N, 3)), ("obj", obj, torch.int32, (W, N)),
            ("mask", mask, torch.bool, (W, N))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"render_views: {name} must be {dtype} {list(shape)} ({W} worlds, "
                             f"{Vc} views, {N} instances), got {t.dtype} {list(t.shape)}")
    devices = {str(t.device) for t in (*views.values(), pos, rot, scale, obj, mask)}
    if len(devices) != 1:
        raise ValueError(f"render_views: inputs on more than one device: {sorted(devices)}")
    if not 1 <= int(max_views) <= Vc:
        raise ValueError(f"render_views: max_views={max_views}, but the views hold {Vc}")
    if int(height) < 1 or int(width) < 1:
        raise ValueError(f"render_views: a {height} x {width} image")
    if len(light) != 3:
        raise ValueError("render_views: light must have 3 components")
    return W, N, Vc


def render_views_plain(views, pos, rot, scale, obj, mask, *, tables: RenderTables, light,
                       ambient: float, height: int, width: int, max_views: int):
    """The plain version of the render kernel's views mode: the node's route
    before it, ``camera_rays`` -> ``pack`` -> ``render_plain`` ->
    ``observations`` (see ``render_views``)."""
    V, H, Wpx = int(max_views), int(height), int(width)
    ro, d = camera_rays(views, V, H, Wpx)
    W, P0 = ro.shape[0], V * H * Wpx
    rays, inst = pack(ro.reshape(W, P0, 3), d.reshape(W, P0, 3), pos, rot, scale, obj, mask)
    out = render_plain(rays, inst, tables=tables, light=light, ambient=ambient)[:, :, :P0]
    return observations(out[:, O_R:O_B + 1].transpose(1, 2).reshape(W, V, H, Wpx, 3),
                        (out[:, O_HIT] > 0.5).reshape(W, V, H, Wpx),
                        out[:, O_DEPTH].reshape(W, V, H, Wpx), views["mask"][:, :V])


def render_views(views, pos, rot, scale, obj, mask, *, tables: RenderTables, light,
                 ambient: float, height: int, width: int, max_views: int):
    """The render node in one launch: the first ``max_views`` views of
    ``views`` (``ctx.data["render"]["__views__"]``: eye [W, Vc, 3], rot
    [W, Vc, 4] float32, tan_fov [W, Vc] float32, mask [W, Vc] bool) traced
    against the instances pos [W, N, 3], rot [W, N, 4], scale [W, N, 3]
    float32, obj [W, N] int32, mask [W, N] bool.  Returns (RGBA8 [W, V, H,
    Wpx, 4] uint8, alpha 255 on a hit; depth [W, V, H, Wpx] float32, inf at
    a miss), 0 / inf on a dead view.  CPU tensors: ``render_views_plain``.
    CUDA tensors: the kernel's views mode (blocked as ``render``), bit for
    bit that route on the card, or a raise — never the plain version."""
    W, N, Vc = _check_views(views, pos, rot, scale, obj, mask, light, height, width,
                            max_views)
    kw = dict(tables=tables, light=light, ambient=ambient, height=height, width=width,
              max_views=max_views)
    dev = pos.device
    if dev.type == "cpu":
        return render_views_plain(views, pos, rot, scale, obj, mask, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_views: no kernel for device {dev}")
    ins = (views["eye"], views["rot"], views["tan_fov"], views["mask"], pos, rot, scale, obj,
           mask)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("render_views: the views and instances must be contiguous")
    why = kernel_fits(N, views=True)
    if why:
        raise NotImplementedError(f"render_views: {why}")
    V, H, Wpx = int(max_views), int(height), int(width)
    table = tables.kernel_table(dev)
    rgba = torch.empty((W, V, H, Wpx, 4), dtype=torch.uint8, device=dev)
    depth = torch.empty((W, V, H, Wpx), dtype=torch.float32, device=dev)
    if W == 0:
        return rgba, depth
    if blocked(N, views=True):   # the blocked twin: stages of survivors
        splits, block = views_splits(H, Wpx), views_blocked_stage(H, Wpx)
    else:
        splits, block = launch_splits(W * V, image_tiles(H, Wpx)), 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().render_views_launch(
        *(t.data_ptr() for t in ins[:4]), Vc, V, H, Wpx, *(t.data_ptr() for t in ins[4:]),
        table.data_ptr(), tables.O, tables.stride, tables.F_used, tables.T_used, W, N, splits,
        float(light[0]), float(light[1]), float(light[2]), float(ambient),
        float(1.0 - ambient), block, rgba.data_ptr(), depth.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"render_views: kernel launch failed with cudaError {rc}")
    RenderKernel.launches += 1
    return rgba, depth


class RenderKernel:
    """Pack rays and instances channel-major (P padded to a multiple of
    128 with zero rays, as PallasRenderKernel does), run ``render``,
    unpack.  PallasRenderKernel's signature without its TPU settings
    (interpret mode, block sizes).

    ``launches`` counts the kernel launches (class-wide)."""

    launches = 0

    def __init__(self, object_manager, object_albedo, light_dir, ambient: float,
                 mesh_tables=None):
        self.tables = RenderTables(object_manager, object_albedo, mesh_tables)
        ld = np.asarray(light_dir, np.float64)
        ld = -ld / np.linalg.norm(ld)
        self.light = (float(ld[0]), float(ld[1]), float(ld[2]))
        self.ambient = float(ambient)

    def pack(self, ro, rd, pos, rot, scale, obj, mask):
        """(rays [W, 6, P], inst [W, 12, N]) from ro/rd [W, P0, 3] and the
        instance arrays [W, N, ...] (``pack``)."""
        return pack(ro, rd, pos, rot, scale, obj, mask)

    def render(self, rays, inst, img_w: int, P0: int):
        """``render`` on packed (rays, inst) with this kernel's tables and
        light, unpacked to its first P0 rays: (rgb [W, P0, 3] f32 in
        [0, 1], hit [W, P0] bool, depth [W, P0] f32 with BIG at misses)."""
        out = render(rays, inst, tables=self.tables, light=self.light, ambient=self.ambient,
                     img_w=img_w)[:, :, :P0]
        return out[:, O_R:O_B + 1].transpose(1, 2), out[:, O_HIT] > 0.5, out[:, O_DEPTH]

    def render_views(self, views, pos, rot, scale, obj, mask, *, height: int, width: int,
                     max_views: int):
        """``render_views`` with this kernel's tables and light."""
        return render_views(views, pos, rot, scale, obj, mask, tables=self.tables,
                            light=self.light, ambient=self.ambient, height=height,
                            width=width, max_views=max_views)

    def __call__(self, ro, rd, pos, rot, scale, obj, mask, img_w: int):
        """ro/rd [W, P0, 3] pixel rays; instance arrays [W, N, ...].  Returns
        what ``self.render`` does."""
        rays, inst = self.pack(ro, rd, pos, rot, scale, obj, mask)
        return self.render(rays, inst, img_w, ro.shape[1])
