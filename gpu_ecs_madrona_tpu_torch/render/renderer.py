"""BatchRenderer — RGB and depth observations for all worlds (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/render/renderer.py`` (reference
src/mw/render/vk/batch_renderer.cpp + shaders/basic.comp).  Each pixel's
camera ray meets the instances analytically: spheres, convex hulls (the
exact slab test over their face planes), planes, and, for objects with a
triangle render mesh, the mesh's triangles (Moeller-Trumbore), which
override the physics primitive.  Shading is Lambert plus ambient with a
per-object albedo.  Rendering is a taskgraph node; the observations are
rgb [W, views, H, Wpx, 4] uint8 and depth [W, views, H, Wpx] float32
(inf at a miss or a dead view), the reference's rgbPtr/depthPtr layout
batched over worlds.

Routes (``RendererConfig.backend``):
  "auto", "pallas": the render kernel's views mode (ops/render_kernel.py
      render_views: on the card the node is one launch of the CUDA kernel,
      camera rays, trace and RGBA8/depth writeback; on the CPU its plain
      version, the rays-mode route composed).  The kernel runs
      the exact hull test only: with ``exact_hulls=False`` "pallas" raises,
      and "auto" takes the "xla" route on the CPU, as in JAX, but raises on
      the card, naming backend="xla", so that nothing there takes the
      batched route unasked.
  "xla": the JAX package's batched path in PyTorch, dense or tiled
      (``tile_size``), on either device.  It builds [pixels, instances]
      tensors, so it is never taken unless asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.state import batched_gather
from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID, TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.ops.render_kernel import (RenderKernel, camera_rays,
                                                         observations)
from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL, PRIM_PLANE, PRIM_SPHERE
from gpu_ecs_madrona_tpu_torch.utils import importer
from gpu_ecs_madrona_tpu_torch.utils import math as m

BIG = 1e9


@dataclasses.dataclass
class RendererConfig:
    """reference BatchRenderer::Config: render width/height, max views."""

    width: int = 64
    height: int = 64
    max_views: int = 1
    # simple directional light
    light_dir: tuple = (0.3, 0.3, -1.0)
    ambient: float = 0.2
    # exact convex-hull intersection (slab test over face planes); False
    # takes the cheaper OBB proxy (exact for boxes only) on the "xla" route
    exact_hulls: bool = True
    # max triangles per render mesh (padded table width)
    max_tris: int = 128
    # "auto" | "pallas" (the render kernel) | "xla" (see the module doc)
    backend: str = "auto"
    # "xla" route: tile_size > 0 splits the image into tile_size^2-pixel
    # tiles, each culls instances against its view cone and ray-tests only
    # its nearest max_instances_per_tile survivors (width and height must
    # be divisible by tile_size)
    tile_size: int = 0
    max_instances_per_tile: int = 32


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _safe(x, eps=1e-9):
    """x where |x| >= eps, else +-eps by the sign of x (>= 0 is +)."""
    return torch.where(torch.abs(x) < eps, torch.where(x >= 0, eps, -eps), x)


class BatchRenderer:
    """Builds a render taskgraph node over the packed instance and view
    buffers of render.interop.RenderingSystem.setup_tasks.

    ``render_meshes`` maps object id -> (verts [V, 3], tris [T, 3]) or an
    importer SourceMesh (utils/importer.py: its faces fan-triangulated by
    ``index_mesh``).  Objects with a render mesh trace its triangles; the
    others their analytic primitive.  The tables live in
    numpy and are copied to each device once, when a node first runs
    there."""

    def __init__(self, cfg: RendererConfig, object_manager: Dict[str, Any],
                 object_albedo=None, render_meshes: Dict[int, Any] = None):
        if cfg.backend not in ("xla", "pallas", "auto"):
            raise ValueError(f"unknown renderer backend {cfg.backend!r}; "
                             "expected 'xla', 'pallas', or 'auto'")
        self.cfg = cfg
        self.objmgr = {k: np.asarray(v) for k, v in object_manager.items()}
        num_objs = self.objmgr["prim_type"].shape[0]
        if object_albedo is None:
            # deterministic distinct colors per object type, in float32
            hues = (torch.arange(num_objs, dtype=torch.float32) * 0.37) % 1.0
            object_albedo = torch.stack([0.5 + 0.5 * torch.cos(2 * math.pi * (hues + s))
                                         for s in (0.0, 0.33, 0.67)], dim=-1).numpy()
        self.albedo = np.asarray(object_albedo, np.float32)

        # padded per-object triangle tables
        Tm = cfg.max_tris
        tri_a = np.zeros((num_objs, Tm, 3), np.float32)
        tri_e1 = np.zeros((num_objs, Tm, 3), np.float32)
        tri_e2 = np.zeros((num_objs, Tm, 3), np.float32)
        tri_mask = np.zeros((num_objs, Tm), bool)
        has_mesh = np.zeros(num_objs, bool)
        for oid, mesh in (render_meshes or {}).items():
            if hasattr(mesh, "vertices"):  # SourceMesh: triangulate fans
                verts, _, _, tris = importer.index_mesh(mesh)
            else:
                verts, tris = mesh
                verts = np.asarray(verts, np.float32)
                tris = np.asarray(tris, np.int32)
            if len(tris) > Tm:
                raise ValueError(f"render mesh for object {oid} has {len(tris)} "
                                 f"triangles > max_tris={Tm}")
            a = verts[tris[:, 0]]
            tri_a[oid, :len(tris)] = a
            tri_e1[oid, :len(tris)] = verts[tris[:, 1]] - a
            tri_e2[oid, :len(tris)] = verts[tris[:, 2]] - a
            tri_mask[oid, :len(tris)] = True
            has_mesh[oid] = True
        # bounding radius of each RENDER mesh (may exceed the physics hull)
        mesh_radius = np.zeros(num_objs, np.float32)
        for oid in range(num_objs):
            if has_mesh[oid]:
                tm = tri_mask[oid]
                vs = np.concatenate([tri_a[oid][tm], tri_a[oid][tm] + tri_e1[oid][tm],
                                     tri_a[oid][tm] + tri_e2[oid][tm]], axis=0)
                if len(vs):
                    mesh_radius[oid] = float(np.linalg.norm(vs, axis=1).max())
        self.mesh = {"tri_a": tri_a, "tri_e1": tri_e1, "tri_e2": tri_e2, "tri_mask": tri_mask,
                     "has_mesh": has_mesh, "mesh_radius": mesh_radius}
        self.any_mesh = bool(has_mesh.any())
        self._by_device = {}

        # The kernel implements the exact-hull slab test only: an explicit
        # "pallas" request that cannot be honoured is an error, not a
        # fallback with other hull semantics.
        if cfg.backend == "pallas" and not cfg.exact_hulls:
            raise ValueError("backend='pallas' unavailable: exact_hulls=False (the "
                             "pixel-tile kernel implements the exact-hull slab test "
                             "only); use backend='auto' or 'xla'")
        self._kernel = None
        if cfg.backend in ("pallas", "auto") and cfg.exact_hulls:
            self._kernel = RenderKernel(object_manager, self.albedo, cfg.light_dir,
                                        cfg.ambient,
                                        mesh_tables=self.mesh if self.any_mesh else None)

    @property
    def route(self) -> str:
        """"kernel" (ops/render_kernel.py) or "xla" (the batched path)."""
        return "kernel" if self._kernel is not None else "xla"

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """The object, albedo and mesh tables as tensors on ``device``."""
        dev = torch.device(device)
        tabs = self._by_device.get(dev)
        if tabs is None:
            src = dict(self.objmgr, albedo=self.albedo, **self.mesh)
            tabs = {}
            for k, a in src.items():
                dtype = (torch.bool if a.dtype == bool else
                         torch.int64 if a.dtype.kind in "iu" else torch.float32)
                tabs[k] = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
            light = torch.tensor(self.cfg.light_dir, dtype=torch.float32)
            tabs["light"] = (-light / torch.sqrt((light * light).sum())).to(dev)
            self._by_device[dev] = tabs
        return tabs

    def init_buffers(self, ctx: Context):
        """Pre-create the output buffers in ctx.data (a stable state)."""
        cfg = self.cfg
        W, dev = ctx.num_worlds, ctx.device
        shape = (W, cfg.max_views, cfg.height, cfg.width)
        user = dict(ctx.data)
        user["render_out"] = {
            "rgb": torch.zeros(shape + (4,), dtype=torch.uint8, device=dev),
            "depth": torch.full(shape, math.inf, dtype=torch.float32, device=dev),
        }
        ctx.data = user

    # -- ray-primitive intersections (basic.comp analogs) ------------------

    @staticmethod
    def _ray_sphere(ro, rd, center, radius):
        """ro/rd [..., 3] broadcast against center [..., 3], radius [...]."""
        oc = ro - center
        b = (oc * rd).sum(-1)
        c = (oc * oc).sum(-1) - radius * radius
        disc = b * b - c
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc >= 0) & (t > 1e-4)
        t = torch.where(hit, t, BIG)
        normal = (ro + rd * t[..., None]) - center
        normal = normal / torch.clamp(_norm(normal), min=1e-9)
        return t, normal

    @staticmethod
    def _ray_obb(ro, rd, center, rot, half):
        """Oriented-box slab test in the box's local frame."""
        ro_l = m.quat_inv_rotate(rot, ro - center)
        rd_l = m.quat_inv_rotate(rot, rd)
        inv = 1.0 / _safe(rd_l)
        t0 = (-half - ro_l) * inv
        t1 = (half - ro_l) * inv
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = tmax >= torch.clamp(tmin, min=1e-4)
        t = torch.where(hit, torch.where(tmin > 1e-4, tmin, tmax), BIG)
        # local normal: the axis of the entry face
        p_l = ro_l + rd_l * t[..., None]
        an = torch.abs(p_l / torch.clamp(half, min=1e-9))
        axis = torch.argmax(an, dim=-1)
        n_l = F.one_hot(axis, 3).to(ro.dtype) * torch.sign(p_l)
        return t, m.quat_rotate(rot, n_l)

    @staticmethod
    def _ray_plane(ro, rd, center, rot):
        up = torch.zeros_like(center)
        up[..., 2] = 1.0
        n = m.quat_rotate(rot, up)
        denom = (rd * n).sum(-1)
        t = ((center - ro) * n).sum(-1) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        hit = (t > 1e-4) & (torch.abs(denom) > 1e-6)
        return torch.where(hit, t, BIG), torch.broadcast_tensors(n, rd)[0]

    # -- exact convex hull: slab test over face planes ----------------------

    @staticmethod
    def _ray_convex_core(ro, rd, center, rot, scale, fnorm_l, face_d, fmask):
        """Shared slab math.  fnorm_l [..., F, 3] local face normals,
        face_d [..., F], fmask [..., F]; nonuniform scale by unscaling the
        ray (t is preserved)."""
        ro_l = m.quat_inv_rotate(rot, ro - center) / scale
        rd_l = m.quat_inv_rotate(rot, rd) / scale
        denom = (fnorm_l * rd_l[..., None, :]).sum(-1)                 # [..., F]
        dist = face_d - (fnorm_l * ro_l[..., None, :]).sum(-1)
        t_f = dist / _safe(denom)
        entering = denom < 0
        t_enter = torch.where(entering & fmask, t_f, -BIG).amax(-1)
        t_exit = torch.where((~entering) & fmask, t_f, BIG).amin(-1)
        # a ray parallel to a face plane and outside it misses
        parallel_out = (fmask & (torch.abs(denom) < 1e-9) & (dist < 0)).any(-1)
        hit = (t_enter <= t_exit) & (t_exit > 1e-4) & ~parallel_out
        t = torch.where(t_enter > 1e-4, t_enter, t_exit)
        return torch.where(hit, t, BIG), t_f, entering

    @staticmethod
    def _ray_convex_t(ro, rd, center, rot, scale, fnorm_l, face_d, fmask):
        return BatchRenderer._ray_convex_core(ro, rd, center, rot, scale, fnorm_l, face_d,
                                              fmask)[0]

    @staticmethod
    def _ray_convex(ro, rd, center, rot, scale, fnorm_l, face_d, fmask):
        """t and the world-space normal of the entry face."""
        t, t_f, entering = BatchRenderer._ray_convex_core(
            ro, rd, center, rot, scale, fnorm_l, face_d, fmask)
        score = torch.where(entering & fmask, t_f, -BIG)
        fidx = torch.argmax(score, dim=-1)
        oh = fidx[..., None] == torch.arange(fmask.shape[-1], device=fmask.device)
        n_l = torch.where(oh[..., None], fnorm_l, 0.0).sum(-2)
        # normals transform by the inverse-transpose: n / scale, renormalised
        n_w = m.quat_rotate(rot, n_l / scale)
        return t, n_w / torch.clamp(_norm(n_w), min=1e-9)

    # -- triangle mesh: Moeller-Trumbore over the padded triangle table ----

    @staticmethod
    def _ray_mesh_core(ro, rd, center, rot, scale, tri_a, e1, e2, tmask):
        """ro/rd [..., 3]; triangle tables [..., T, 3] in local space;
        returns t [..., T] (BIG at a miss).  Scale by unscaling the ray."""
        ro_l = (m.quat_inv_rotate(rot, ro - center) / scale)[..., None, :]
        rd_l = (m.quat_inv_rotate(rot, rd) / scale)[..., None, :]
        pvec = _cross(rd_l, e2)
        det = (e1 * pvec).sum(-1)
        inv_det = 1.0 / _safe(det)
        tvec = ro_l - tri_a
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = _cross(tvec, e1)
        v = (rd_l * qvec).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        hit = (tmask & (torch.abs(det) > 1e-9) & (u >= -1e-6) & (v >= -1e-6)
               & (u + v <= 1 + 1e-6) & (t > 1e-4))
        return torch.where(hit, t, BIG)

    @staticmethod
    def _ray_mesh_t(ro, rd, center, rot, scale, tri_a, e1, e2, tmask):
        return BatchRenderer._ray_mesh_core(ro, rd, center, rot, scale, tri_a, e1, e2,
                                            tmask).amin(-1)

    @staticmethod
    def _ray_mesh(ro, rd, center, rot, scale, tri_a, e1, e2, tmask):
        """t and the world normal of the nearest triangle, flipped toward
        the ray origin (two-sided, like basic.comp)."""
        t_tri = BatchRenderer._ray_mesh_core(ro, rd, center, rot, scale, tri_a, e1, e2, tmask)
        t, ti = t_tri.min(dim=-1)
        oh = (ti[..., None] == torch.arange(tmask.shape[-1], device=tmask.device))[..., None]
        n_l = _cross(torch.where(oh, e1, 0.0).sum(-2), torch.where(oh, e2, 0.0).sum(-2))
        n_w = m.quat_rotate(rot, n_l / scale)
        n_w = n_w / torch.clamp(_norm(n_w), min=1e-9)
        n_w = torch.where((n_w * rd).sum(-1, keepdim=True) > 0, -n_w, n_w)
        return t, n_w

    # t-only variants for the all-instances pass

    @staticmethod
    def _ray_sphere_t(ro, rd, center, radius):
        oc = ro - center
        b = (oc * rd).sum(-1)
        c = (oc * oc).sum(-1) - radius * radius
        disc = b * b - c
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        return torch.where((disc >= 0) & (t > 1e-4), t, BIG)

    @staticmethod
    def _ray_obb_t(ro, rd, center, rot, half):
        return BatchRenderer._ray_obb(ro, rd, center, rot, half)[0]

    @staticmethod
    def _ray_plane_t(ro, rd, center, rot):
        return BatchRenderer._ray_plane(ro, rd, center, rot)[0]

    def _pass1_tiled(self, tabs, d, eye, pos, rot, scale, obj, imask, ptype, radius):
        """Tile-culled primary-ray pass (RendererConfig.tile_size): each
        tile_size^2-pixel tile culls the instances against its view cone
        (sphere against cone), keeps the nearest max_instances_per_tile
        survivors (planes first: they are infinite), and its pixels test
        only those.  Returns (best_t, best_i) in [W, V, H, Wpx] image
        layout, best_i a global instance index."""
        cfg = self.cfg
        tsz, M = cfg.tile_size, cfg.max_instances_per_tile
        W, V, Hh, Ww = d.shape[:4]
        N = pos.shape[1]
        M = min(M, N)
        Th, Tw = Hh // tsz, Ww // tsz
        T, p = Th * Tw, tsz * tsz

        d_t = d.reshape(W, V, Th, tsz, Tw, tsz, 3).permute(0, 1, 2, 4, 3, 5, 6)\
               .reshape(W, V, T, p, 3)
        # tile view cone: mean direction, min cosine over the tile's rays
        d_sum = d_t.sum(3)
        d_c = d_sum / _norm(d_sum)
        cos_t = (d_t * d_c[:, :, :, None, :]).sum(-1).amin(3)
        cos_t = torch.clamp(cos_t, 1e-3, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))

        # instance bounding spheres against the tile cones
        half = (tabs["local_aabb_hi"][obj] - tabs["local_aabb_lo"][obj]) * 0.5 * scale
        r_i = _norm(half)[..., 0]
        r_i = torch.where(ptype == PRIM_SPHERE, radius, r_i)          # [W, N]
        if self.any_mesh:
            r_mesh = tabs["mesh_radius"][obj] * scale.amax(-1)
            r_i = torch.where(tabs["has_mesh"][obj], r_mesh, r_i)
        c = pos[:, None] - eye[:, :, None]                            # [W, V, N, 3]
        a_ax = (c[:, :, None] * d_c[:, :, :, None]).sum(-1)           # [W, V, T, N]
        cc = (c * c).sum(-1)[:, :, None, :]
        qq = torch.sqrt(torch.clamp(cc - a_ax * a_ax, min=0.0))
        r4 = r_i[:, None, None, :]
        hit = (qq * cos_t[..., None] - a_ax * sin_t[..., None] <= r4) & (a_ax >= -r4)
        is_plane4 = (ptype == PRIM_PLANE)[:, None, None, :]
        hit = (hit | is_plane4) & imask[:, None, None, :]
        # nearest first; planes always outrank bounded instances
        score = torch.where(hit, torch.where(is_plane4, BIG, -a_ax), -BIG)
        srt = torch.sort(score, dim=-1, descending=True, stable=True)
        vals, tidx = srt.values[..., :M], srt.indices[..., :M]       # [W, V, T, M]
        tvalid = vals > -BIG * 0.5

        flat_idx = tidx.reshape(W, V * T * M)

        def g(x):
            return batched_gather(x, flat_idx).reshape((W, V, T, M) + x.shape[2:])

        pos_t, rot_t, scale_t = g(pos), g(rot), g(scale)
        obj_t, rad_t, ptype_t = g(obj), g(radius), g(ptype)
        ro6 = eye[:, :, None, None, None, :]
        d6 = d_t[:, :, :, :, None, :]

        def i6(x):
            return x[:, :, :, None]

        ts_ = self._ray_sphere_t(ro6, d6, i6(pos_t), i6(rad_t))
        if cfg.exact_hulls:
            fd = tabs["face_d"][obj_t]
            fm = torch.arange(fd.shape[-1], device=fd.device) < tabs["num_faces"][obj_t][..., None]
            tb = self._ray_convex_t(ro6, d6, i6(pos_t), i6(rot_t), i6(scale_t),
                                    i6(tabs["face_normals"][obj_t]), i6(fd), i6(fm))
        else:
            half_t = (tabs["local_aabb_hi"][obj_t] - tabs["local_aabb_lo"][obj_t]) * 0.5 * scale_t
            tb = self._ray_obb_t(ro6, d6, i6(pos_t), i6(rot_t), i6(half_t))
        tp_ = self._ray_plane_t(ro6, d6, i6(pos_t), i6(rot_t))
        pt6 = i6(ptype_t)
        t_all = torch.where(pt6 == PRIM_SPHERE, ts_, torch.where(pt6 == PRIM_HULL, tb, tp_))
        if self.any_mesh:
            tm6 = self._ray_mesh_t(ro6, d6, i6(pos_t), i6(rot_t), i6(scale_t),
                                   i6(tabs["tri_a"][obj_t]), i6(tabs["tri_e1"][obj_t]),
                                   i6(tabs["tri_e2"][obj_t]), i6(tabs["tri_mask"][obj_t]))
            t_all = torch.where(i6(tabs["has_mesh"][obj_t]), tm6, t_all)
        t_all = torch.where(i6(tvalid), t_all, BIG)                  # [W, V, T, p, M]
        best_t, best_m = t_all.min(dim=-1)
        best_i = torch.gather(tidx[:, :, :, None, :].expand(W, V, T, p, M), -1,
                              best_m[..., None])[..., 0]

        def untile(x):
            return x.reshape(W, V, Th, Tw, tsz, tsz).permute(0, 1, 2, 4, 3, 5)\
                    .reshape(W, V, Hh, Ww)

        return untile(best_t), untile(best_i)

    # -- node ---------------------------------------------------------------

    def camera_rays(self, views):
        """Pinhole rays of the views (``ctx.data["render"]["__views__"]``):
        (ro, d) [W, V, H, Wpx, 3] (ops/render_kernel.py camera_rays)."""
        cfg = self.cfg
        return camera_rays(views, cfg.max_views, cfg.height, cfg.width)

    @staticmethod
    def instances(render_in, instance_archetypes):
        """(pos, rot, scale, obj, mask) [W, N, ...]: the packed instances of
        the archetypes, in order, as one flat list."""
        insts = [render_in[arch.name] for arch in instance_archetypes]
        keys = ("pos", "rot", "scale", "obj_id", "mask")
        if len(insts) == 1:
            return tuple(insts[0][k] for k in keys)
        return tuple(torch.cat([i[k] for i in insts], dim=1) for k in keys)

    def kernel_inputs(self, render_in, instance_archetypes):
        """The render kernel's rays-mode inputs (rays, inst) for
        ``ctx.data["render"]``: the node's route before its views mode, for
        the callers that hold the two modes against each other; the image
        width is ``cfg.width``."""
        ro, d = self.camera_rays(render_in["__views__"])
        W = ro.shape[0]
        return self._kernel.pack(ro.reshape(W, -1, 3), d.reshape(W, -1, 3),
                                 *self.instances(render_in, instance_archetypes))

    def setup_tasks(self, builder: TaskGraphBuilder, deps: Sequence[NodeID],
                    instance_archetypes: Sequence[Archetype]) -> NodeID:
        """Append the render node (the analog of BatchRenderer::render each
        step, cuda_exec.cpp:1787-1793)."""
        cfg = self.cfg
        if self._kernel is None and cfg.backend == "auto" and builder.mgr.device.type == "cuda":
            raise ValueError("renderer backend='auto' with exact_hulls=False has no kernel "
                             "on the card (the kernel runs the exact hull test only); ask "
                             "for backend='xla' to take the batched route there")

        def render(ctx: Context):
            user = dict(ctx.data)
            render_in = user["render"]
            views = render_in["__views__"]
            V, Hh, Ww = cfg.max_views, cfg.height, cfg.width
            inst = self.instances(render_in, instance_archetypes)
            if self._kernel is not None:
                # one launch of the kernel's views mode: rays, trace, RGBA8
                rgb8, depth = self._kernel.render_views(
                    views, *(t.contiguous() for t in inst), height=Hh, width=Ww, max_views=V)
            else:
                ro, d = self.camera_rays(views)
                rgb, hit, best_t = self._render_batched(ctx, d, ro, views["eye"][:, :V], *inst)
                rgb8, depth = observations(rgb, hit, best_t, views["mask"][:, :V])
            user["render_out"] = {"rgb": rgb8, "depth": depth}
            ctx.data = user

        return builder.add_node(render, deps, name="batch_render")

    def _render_batched(self, ctx, d, ro, eye, pos, rot, scale, obj, imask):
        """The "xla" route: (rgb [W, V, H, Wpx, 3], hit, best_t)."""
        cfg = self.cfg
        tabs = self.tables(ctx.device)
        W, V, Hh, Ww = d.shape[:4]
        obj = obj.long()
        ptype = tabs["prim_type"][obj]                                 # [W, N]
        radius = tabs["sphere_radius"][obj] * scale[..., 0]
        half = (tabs["local_aabb_hi"][obj] - tabs["local_aabb_lo"][obj]) * 0.5 * scale
        alb = tabs["albedo"][obj]                                      # [W, N, 3]

        if cfg.tile_size > 0 and Hh % cfg.tile_size == 0 and Ww % cfg.tile_size == 0:
            best_t, best_i = self._pass1_tiled(tabs, d, eye, pos, rot, scale, obj, imask,
                                               ptype, radius)
        else:
            # pass 1 (dense): t for every (pixel, instance), [W, V, H, Wpx, N]
            ro5, d5 = ro[..., None, :], d[..., None, :]

            def inst5(x):
                return x[:, None, None, None]

            ts = self._ray_sphere_t(ro5, d5, inst5(pos), inst5(radius))
            if cfg.exact_hulls:
                fd = tabs["face_d"][obj]
                fm = torch.arange(fd.shape[-1], device=fd.device) < tabs["num_faces"][obj][..., None]
                tb = self._ray_convex_t(ro5, d5, inst5(pos), inst5(rot), inst5(scale),
                                        inst5(tabs["face_normals"][obj]), inst5(fd), inst5(fm))
            else:
                tb = self._ray_obb_t(ro5, d5, inst5(pos), inst5(rot), inst5(half))
            tp = self._ray_plane_t(ro5, d5, inst5(pos), inst5(rot))
            pt5 = inst5(ptype)
            t_all = torch.where(pt5 == PRIM_SPHERE, ts, torch.where(pt5 == PRIM_HULL, tb, tp))
            if self.any_mesh:
                tm = self._ray_mesh_t(ro5, d5, inst5(pos), inst5(rot), inst5(scale),
                                      inst5(tabs["tri_a"][obj]), inst5(tabs["tri_e1"][obj]),
                                      inst5(tabs["tri_e2"][obj]), inst5(tabs["tri_mask"][obj]))
                t_all = torch.where(inst5(tabs["has_mesh"][obj]), tm, t_all)
            t_all = torch.where(inst5(imask), t_all, BIG)
            best_t, best_i = t_all.min(dim=-1)                         # [W, V, H, Wpx]

        # pass 2: the winning instance's data per pixel, its normal again
        flat_i = best_i.reshape(W, V * Hh * Ww)

        def gw(x):
            return batched_gather(x, flat_i).reshape((W, V, Hh, Ww) + x.shape[2:])

        wpos, wrot, wtype, wobj = gw(pos), gw(rot), gw(ptype), gw(obj)
        best_alb = gw(alb)
        _, n_s = self._ray_sphere(ro, d, wpos, gw(radius))
        if cfg.exact_hulls:
            wfd = tabs["face_d"][wobj]
            wfm = torch.arange(wfd.shape[-1], device=wfd.device) < tabs["num_faces"][wobj][..., None]
            _, n_b = self._ray_convex(ro, d, wpos, wrot, gw(scale),
                                      tabs["face_normals"][wobj], wfd, wfm)
        else:
            _, n_b = self._ray_obb(ro, d, wpos, wrot, gw(half))
        _, n_p = self._ray_plane(ro, d, wpos, wrot)
        best_n = torch.where((wtype == PRIM_SPHERE)[..., None], n_s,
                             torch.where((wtype == PRIM_HULL)[..., None], n_b, n_p))
        if self.any_mesh:
            _, n_m = self._ray_mesh(ro, d, wpos, wrot, gw(scale), tabs["tri_a"][wobj],
                                    tabs["tri_e1"][wobj], tabs["tri_e2"][wobj],
                                    tabs["tri_mask"][wobj])
            best_n = torch.where(tabs["has_mesh"][wobj][..., None], n_m, best_n)

        hit = best_t < BIG * 0.5
        light = tabs["light"]
        lambert = torch.clamp((best_n * light).sum(-1), min=0.0)
        shade = cfg.ambient + (1 - cfg.ambient) * lambert
        rgb = torch.where(hit[..., None], best_alb * shade[..., None], 0.0)
        return rgb, hit, best_t
