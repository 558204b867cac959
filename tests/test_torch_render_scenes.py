"""Render-kernel test scenes, in numpy (no JAX; data only, no tests): shared by
tests/test_torch_render_kernel.py and tests/test_torch_render_node.py (the
port against the JAX kernel and node), tests/test_torch_cuda.py and
chip_smoke.py (the CUDA kernel against its plain version and the views
mode against the rays mode's route).

Each scene is a dict: the object manager ``om``, ``albedo``,
``mesh_tables`` (or None), the pixel rays ``ro``/``rd`` [W, P, 3], the
instance arrays ``pos``/``rot``/``scale``/``obj``/``mask`` [W, N, ...] and
``img_w``, the rays' image width (the kernel's 2-D tiles).
"""

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.models.simple_taskgraph import _sphere_mesh
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.physics import assets

LIGHT_DIR = (0.3, 0.3, -1.0)
AMBIENT = 0.2
S2 = 1 / np.sqrt(2)


def camera_rays(eye, quat, fov_degrees, res):
    """The renderer's pinhole rays for one view: (ro, rd) [res * res, 3]
    float32, row-major pixels."""
    tanf = np.float32(np.tan(np.radians(fov_degrees) / 2))
    ys = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 - 1
    px, py = np.meshgrid(ys, -ys)
    d = np.stack([px * tanf, np.ones_like(px), py * tanf], -1).reshape(-1, 3)
    w, u = np.float32(quat[0]), np.asarray(quat[1:], np.float32)
    uv = np.cross(u, d)
    d = d + 2.0 * (w * uv + np.cross(u, uv))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(np.asarray(eye, np.float32), d.shape).copy(), d


def _views(cams, res):
    """cams: per world, a list of (eye, quat, fov) views -> ro, rd [W, P, 3]."""
    ro, rd = [], []
    for views in cams:
        rays = [camera_rays(e, q, f, res) for e, q, f in views]
        ro.append(np.concatenate([r[0] for r in rays]))
        rd.append(np.concatenate([r[1] for r in rays]))
    return np.stack(ro), np.stack(rd)


def mesh_tables(num_objs, meshes, max_tris=128):
    """The renderer's padded triangle tables for {object id: (verts, tris)}."""
    ta = np.zeros((num_objs, max_tris, 3), np.float32)
    te1, te2 = ta.copy(), ta.copy()
    tm = np.zeros((num_objs, max_tris), bool)
    hm = np.zeros(num_objs, bool)
    for o, (v, t) in meshes.items():
        a = v[t[:, 0]]
        ta[o, :len(t)] = a
        te1[o, :len(t)] = v[t[:, 1]] - a
        te2[o, :len(t)] = v[t[:, 2]] - a
        tm[o, :len(t)] = True
        hm[o] = True
    return {"has_mesh": hm, "tri_a": ta, "tri_e1": te1, "tri_e2": te2, "tri_mask": tm}


def _box_sphere_plane():
    loader = assets.PhysicsLoader(max_verts=8, max_faces=6, max_edges=3, max_face_verts=4,
                                  max_full_edges=12)
    loader.load_objects([assets.make_box((0.6, 0.4, 0.5)), assets.make_sphere(0.7),
                         assets.make_plane()])
    return loader.get_object_manager()


ALBEDO3 = np.array([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.5, 0.5, 0.5]], np.float32)


def _pallas_instances(W):
    """tests/test_render_pallas.py's instances (box, sphere, plane, a
    rotated and scaled box) and two dead rows; world w shifted 0.3 w in x."""
    pos = np.array([[0.0, 3.0, 0.6], [1.2, 4.0, 0.8], [0.0, 0.0, 0.0], [-1.1, 3.5, 0.5],
                    [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    pos = pos[None] + (np.arange(W, dtype=np.float32) * 0.3)[:, None, None] * \
        np.array([1.0, 0.0, 0.0], np.float32)
    rot = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0], [S2, 0, 0, S2], [1, 0, 0, 0],
                    [1, 0, 0, 0]], np.float32)
    scale = np.array([[1, 1, 1], [1, 1, 1], [1, 1, 1], [1.5, 1.0, 0.8], [1, 1, 1], [1, 1, 1]],
                     np.float32)
    obj = np.array([0, 1, 2, 0, 0, 0], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 0], bool)

    def tile(a):
        return np.broadcast_to(a, (W,) + a.shape).copy()
    return dict(pos=pos.astype(np.float32), rot=tile(rot), scale=tile(scale), obj=tile(obj),
                mask=tile(mask))


def pallas_scene(W=2, res=16):
    """tests/test_render_pallas.py:28-56: the camera at (0, -2, 1.2), 70
    degrees, looking +y."""
    ro, rd = _views([[((0.0, -2.0, 1.2), (1.0, 0, 0, 0), 70.0)]] * W, res)
    return dict(om=_box_sphere_plane(), albedo=ALBEDO3, mesh_tables=None, ro=ro, rd=rd,
                img_w=res, **_pallas_instances(W))


def two_views(W=2, res=16):
    """tests/test_render.py:269: a unit sphere at (0, 0, 1); view 0 at y = -5
    looking +y, view 1 at y = 9 looking -y; a dead second row."""
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_sphere(1.0)])
    cams = [[((0.0, -5.0, 1.0), (1.0, 0, 0, 0), 90.0), ((0.0, 9.0, 1.0), (0.0, 0, 0, 1.0), 90.0)]]
    ro, rd = _views(cams * W, res)

    def tile(a):
        return np.broadcast_to(np.asarray(a), (W,) + np.asarray(a).shape).copy()
    return dict(om=loader.get_object_manager(), albedo=np.array([[0.7, 0.6, 0.2]], np.float32),
                mesh_tables=None, ro=ro, rd=rd, img_w=res,
                pos=tile(np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0]], np.float32)),
                rot=tile(np.array([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32)),
                scale=tile(np.ones((2, 3), np.float32)), obj=tile(np.zeros(2, np.int32)),
                mask=tile(np.array([True, False])))


def inside(W=2, res=8):
    """The pallas scene's instances seen from inside: world 0's camera in
    the box, world 1's in the sphere, each with two back-to-back views
    (+y and -y), so a tile of 128 rays spans both views and its cone wraps
    past a half-space."""
    cams = []
    for w in range(W):
        eye = (0.0 + 0.3 * w, 3.0, 0.6) if w % 2 == 0 else (1.2 + 0.3 * w, 4.0, 0.8)
        cams.append([(eye, (1.0, 0, 0, 0), 120.0), (eye, (0.0, 0, 0, 1.0), 120.0)])
    ro, rd = _views(cams, res)
    return dict(om=_box_sphere_plane(), albedo=ALBEDO3, mesh_tables=None, ro=ro, rd=rd,
                img_w=res, **_pallas_instances(W))


def sphere_mesh(W=2, res=16, n_lat=3, n_lon=4):
    """simple_taskgraph's objects (a unit sphere and a plane) with a
    lat-long render mesh of radius 0.5 on the sphere (models/
    simple_taskgraph.py _sphere_mesh, here coarser), three spheres, a
    ground plane and a dead row."""
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_sphere(1.0), assets.make_plane()])
    om = loader.get_object_manager()
    mt = mesh_tables(2, {0: _sphere_mesh(0.5, n_lat, n_lon)})
    ro, rd = _views([[((0.0, -3.0, 1.5), (1.0, 0, 0, 0), 90.0)]] * W, res)
    pos = np.array([[0.0, 1.0, 1.0], [1.0, 2.0, 1.5], [-0.8, 0.5, 0.8], [0.0, 0.0, 0.0],
                    [0.0, 0.0, 0.0]], np.float32)
    pos = pos[None] + (np.arange(W, dtype=np.float32) * 0.2)[:, None, None] * \
        np.array([0.0, 0.0, 1.0], np.float32)
    q = np.array([np.cos(0.3), 0.0, np.sin(0.3), 0.0], np.float32)
    rot = np.array([q, [1, 0, 0, 0], q, [1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    scale = np.array([[1, 1, 1], [1.5, 1.0, 0.8], [1, 1, 1], [1, 1, 1], [1, 1, 1]], np.float32)

    def tile(a):
        return np.broadcast_to(a, (W,) + a.shape).copy()
    return dict(om=om, albedo=np.array([[0.8, 0.3, 0.3], [0.4, 0.6, 0.4]], np.float32),
                mesh_tables=mt, ro=ro, rd=rd, img_w=res, pos=pos.astype(np.float32),
                rot=tile(rot), scale=tile(scale), obj=tile(np.array([0, 0, 0, 1, 0], np.int32)),
                mask=tile(np.array([True, True, True, True, False])))


def prism_mesh(W=2, res=16):
    """The imported-hull pile's objects (tests/test_torch_hull_scenes.py:
    the hexagonal prism, a sphere, the plane) with the prism's importer
    SourceMesh as its render mesh, through the renderer's SourceMesh
    branch (index_mesh's fan triangles): three prisms at three rotations
    and scales, a sphere, the ground plane and a dead row."""
    import test_torch_hull_scenes as hs
    from gpu_ecs_madrona_tpu_torch.render import renderer
    from gpu_ecs_madrona_tpu_torch.utils import importer
    om = hs.hull_object_manager(assets, importer)
    mesh = importer.parse_obj_bytes(hs.prism_obj().encode())
    mt = renderer.BatchRenderer(renderer.RendererConfig(backend="xla"), om,
                                render_meshes={0: mesh}).mesh
    ro, rd = _views([[((0.0, -3.0, 1.5), (1.0, 0, 0, 0), 90.0)]] * W, res)
    pos = np.array([[0.0, 1.0, 1.0], [1.2, 2.0, 1.5], [-1.0, 0.8, 0.6], [0.3, 0.2, 2.2],
                    [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    pos = pos[None] + (np.arange(W, dtype=np.float32) * 0.2)[:, None, None] * \
        np.array([0.0, 0.0, 1.0], np.float32)
    q1 = np.array([np.cos(0.4), np.sin(0.4), 0.0, 0.0], np.float32)
    q2 = np.array([np.cos(0.7), 0.0, 0.0, np.sin(0.7)], np.float32)
    rot = np.array([q1, q2, [1, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]],
                   np.float32)
    scale = np.array([[1, 1, 1], [1.5, 1.0, 0.8], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1]],
                     np.float32)

    def tile(a):
        return np.broadcast_to(a, (W,) + a.shape).copy()
    return dict(om=om, albedo=np.array([[0.8, 0.5, 0.2], [0.3, 0.3, 0.8], [0.4, 0.6, 0.4]],
                                       np.float32),
                mesh_tables=mt, ro=ro, rd=rd, img_w=res, pos=pos.astype(np.float32),
                rot=tile(rot), scale=tile(scale),
                obj=tile(np.array([0, 0, 0, 1, 2, 0], np.int32)),
                mask=tile(np.array([True, True, True, True, True, False])))


def inside_wrapping(W=2):
    """The inside scene at 6 x 6: its two views stack as 12 rows, so the
    kernel's 8 x 4 tile over rows 4-7 spans both back-to-back views and its
    cone wraps."""
    return inside(W, res=6)


SCENES = {"pallas_scene": pallas_scene, "two_views": two_views, "inside": inside,
          "sphere_mesh": sphere_mesh, "prism_mesh": prism_mesh}
# the CUDA kernel's cases: the scenes and a tile whose cone wraps
CARD_SCENES = dict(SCENES, inside_wrapping=inside_wrapping)


# -- the views mode: views as the render_pack node leaves them ---------------

def random_views(seed, W, cap, dead=()):
    """Views as the render_pack node leaves them: eye [W, cap, 3], unit
    rotations [W, cap, 4], tan_fov [W, cap], mask [W, cap] (False at each
    (world, view) of ``dead``), made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(W, cap, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((W, cap), bool)
    for w, v in dead:
        mask[w, v] = False
    return {"eye": rng.uniform(-2.0, 2.0, (W, cap, 3)).astype(np.float32), "rot": q,
            "tan_fov": rng.uniform(0.3, 1.5, (W, cap)).astype(np.float32), "mask": mask}


def torch_views(views, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in views.items()}


# name: (W, views of the camera archetype, max_views, dead (world, view), H,
# Wpx, the scene: the pallas scene's hulls, sphere and plane, the sphere
# mesh scene's triangle meshes, or the prism's importer SourceMesh)
VIEW_CASES = {"one_view": (2, 1, 1, (), 16, 16, "pallas_scene"),
              "two_views_dead": (3, 2, 2, ((1, 1), (2, 0)), 16, 16, "pallas_scene"),
              "24x40": (2, 2, 2, ((0, 1),), 24, 40, "pallas_scene"),
              "18x30": (4, 3, 2, ((3, 1),), 18, 30, "pallas_scene"),
              "mesh": (2, 2, 2, (), 16, 16, "sphere_mesh"),
              "source_mesh": (2, 2, 2, ((1, 1),), 16, 16, "prism_mesh")}


def view_case(name, device="cpu"):
    """A view case over a scene's instances (the pallas scene: box, sphere,
    plane, a rotated and scaled box, two dead rows; or the sphere mesh
    scene): random views about the scene's camera (the first dead view's
    rotation NaN: a dead view's garbage is never seen), the instances as
    [W, N, ...] tensors.  Returns (RenderKernel, views, (pos, rot, scale,
    obj, mask), V, H, Wpx)."""
    W, cap, V, dead, H, Wpx, scene = VIEW_CASES[name]
    sc = SCENES[scene](W=W)
    views = random_views(5, W, cap, dead)
    views["eye"] = views["eye"] * np.float32(0.2) + sc["ro"][:, :1]
    # rotations near the identity, so that the views see the scene
    views["rot"][..., 0] += np.float32(3.0)
    views["rot"] /= np.linalg.norm(views["rot"], axis=-1, keepdims=True)
    if dead:
        w, v = dead[0]
        views["rot"][w, v] = np.nan
    k = rk.RenderKernel(sc["om"], sc["albedo"], LIGHT_DIR, AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    inst = tuple(torch.from_numpy(sc[key]).to(device)
                 for key in ("pos", "rot", "scale", "obj", "mask"))
    return k, torch_views(views, device), inst, V, H, Wpx


def node_route(k, views, inst, V, H, Wpx):
    """The render node's route before its views mode: camera_rays, pack,
    the rays-mode render (the kernel on the card), the RGBA8/depth
    epilogue."""
    ro, d = rk.camera_rays(views, V, H, Wpx)
    W = ro.shape[0]
    rays, packed = k.pack(ro.reshape(W, -1, 3), d.reshape(W, -1, 3), *inst)
    rgb, hit, depth = k.render(rays, packed, Wpx, V * H * Wpx)
    return rk.observations(rgb.reshape(W, V, H, Wpx, 3), hit.reshape(W, V, H, Wpx),
                           depth.reshape(W, V, H, Wpx), views["mask"][:, :V])


# -- scenes past one block's shared memory -----------------------------------

# instance rows a world of the large scenes: past what one block's shared
# memory stages at once in either mode (2,421 in the views mode, 1,614 in
# the rays mode), so the kernel stages them in blocks
LARGE_ROWS = 4096
# the large scenes' objects: the pallas scene's box, sphere and plane, the
# imported prism with its importer SourceMesh as its render mesh, and a
# sphere of radius 0.5 with a lat-long triangle render mesh
LARGE_ALBEDO = np.array([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.5, 0.5, 0.5], [0.8, 0.5, 0.2],
                         [0.3, 0.3, 0.8]], np.float32)
LARGE_PRISM, LARGE_MESH_SPHERE = 3, 4


def large_object_manager():
    """The large scenes' objects packed by PhysicsLoader() at its defaults:
    box, sphere, plane, the imported prism, the small sphere."""
    import test_torch_hull_scenes as hs
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_box((0.6, 0.4, 0.5)), assets.make_sphere(0.7),
                         assets.make_plane(), hs.prism_object(), assets.make_sphere(0.5)])
    return loader.get_object_manager()


def large_render_meshes(importer):
    """The large scenes' render meshes for a renderer's ``render_meshes``,
    from a package's utils.importer module: the prism's SourceMesh (parsed
    from its .obj text; the renderer's SourceMesh branch fans its faces
    into triangles) and the small sphere's lat-long triangles."""
    import test_torch_hull_scenes as hs
    return {LARGE_PRISM: importer.parse_obj_bytes(hs.prism_obj().encode()),
            LARGE_MESH_SPHERE: _sphere_mesh(0.5, 3, 4)}


def large_objects():
    """(object manager, albedo, render meshes, mesh tables) of the large
    scenes; the tables the port's renderer builds from the meshes."""
    from gpu_ecs_madrona_tpu_torch.render import renderer
    from gpu_ecs_madrona_tpu_torch.utils import importer
    om, meshes = large_object_manager(), large_render_meshes(importer)
    mt = renderer.BatchRenderer(renderer.RendererConfig(backend="xla"), om,
                                render_meshes=meshes).mesh
    return om, LARGE_ALBEDO, meshes, mt


def large_instances(W, N=LARGE_ROWS, seed=11):
    """N instance rows a world made from a seed with numpy: boxes and
    spheres at random poses and scales in front of the pallas scene's
    camera (x in [-6, 6], y in [0.5, 24], z in [0, 5]), a quarter of them
    drawn with a render mesh instead (a box row as the prism's SourceMesh,
    a sphere row as the lat-long sphere mesh), row 0 the ground plane,
    every 16th row from row 5 dead."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform((-6.0, 0.5, 0.0), (6.0, 24.0, 5.0), (W, N, 3)).astype(np.float32)
    rot = rng.normal(size=(W, N, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    scale = rng.uniform(0.1, 0.5, (W, N, 3)).astype(np.float32)
    obj = rng.integers(0, 2, (W, N)).astype(np.int32)
    obj = np.where(rng.integers(0, 4, (W, N)) == 0, obj + LARGE_PRISM, obj).astype(np.int32)
    mask = np.ones((W, N), bool)
    mask[:, 5::16] = False
    pos[:, 0] = 0.0
    rot[:, 0] = (1.0, 0.0, 0.0, 0.0)
    scale[:, 0] = 1.0
    obj[:, 0] = 2
    return dict(pos=pos, rot=rot, scale=scale, obj=obj, mask=mask)


def large_scene(W=2, res=16, N=LARGE_ROWS, seed=11):
    """large_instances seen by the pallas scene's camera at (0, -2, 1.2), 70
    degrees, looking +y, res x res rays a world."""
    ro, rd = _views([[((0.0, -2.0, 1.2), (1.0, 0, 0, 0), 70.0)]] * W, res)
    om, albedo, _, mt = large_objects()
    return dict(om=om, albedo=albedo, mesh_tables=mt, ro=ro, rd=rd, img_w=res,
                **large_instances(W, N, seed))


def large_view_case(W=2, H=16, Wpx=16, N=LARGE_ROWS, device="cpu", seed=11):
    """large_instances under one random view a world about the large
    scene's camera (as view_case makes them).  Returns (RenderKernel,
    views, (pos, rot, scale, obj, mask), V, H, Wpx)."""
    views = random_views(seed, W, 1)
    views["eye"] = views["eye"] * np.float32(0.2) + np.float32([0.0, -2.0, 1.2])
    views["rot"][..., 0] += np.float32(3.0)
    views["rot"] /= np.linalg.norm(views["rot"], axis=-1, keepdims=True)
    om, albedo, _, mt = large_objects()
    k = rk.RenderKernel(om, albedo, LIGHT_DIR, AMBIENT, mesh_tables=mt)
    sc = large_instances(W, N, seed)
    inst = tuple(torch.from_numpy(sc[key]).to(device)
                 for key in ("pos", "rot", "scale", "obj", "mask"))
    return k, torch_views(views, device), inst, 1, H, Wpx
