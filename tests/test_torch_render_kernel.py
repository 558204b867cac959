"""The render kernel's plain version (ops/render_kernel.py) against the JAX
package's Pallas render kernel in interpret mode, on the CPU.

Four scenes (tests/test_torch_render_scenes.py), W = 2: tests/test_render_pallas.py's
(box, sphere, plane, a rotated and scaled box, two dead rows), two views
(tests/test_render.py:269), cameras inside a hull and inside a sphere, and
a sphere render mesh.  Hit masks exact; depth at hits rtol 1e-4, atol 1e-3;
RGBA8 within 1 (tests/test_render_pallas.py's tolerances: the two differ
in reduction order and in rsqrt against 1 / sqrt).  RenderTables equals
the JAX class field by field.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpu_ecs_madrona_tpu.ops.render_kernel import PallasRenderKernel
from gpu_ecs_madrona_tpu.ops.render_kernel import RenderTables as JRenderTables

import test_torch_render_scenes as scenes
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk

INPUTS = ("ro", "rd", "pos", "rot", "scale", "obj", "mask")


def rgba8(rgb, hit):
    rgba = np.concatenate([rgb, hit[..., None].astype(np.float32)], -1)
    return (np.clip(rgba, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module", params=sorted(scenes.SCENES))
def scene(request):
    return request.param, scenes.SCENES[request.param]()


def test_render_plain_matches_jax_kernel(scene):
    name, sc = scene
    jk = PallasRenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                            interpret=True, mesh_tables=sc["mesh_tables"])
    want = [np.asarray(x) for x in jk(*(jnp.asarray(sc[k]) for k in INPUTS))]
    pk = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                         mesh_tables=sc["mesh_tables"])
    got = [x.numpy() for x in pk(*(torch.from_numpy(sc[k]) for k in INPUTS), img_w=sc["img_w"])]
    hit = want[1]
    assert hit.any() and (not hit.all() or name == "inside"), name
    np.testing.assert_array_equal(got[1], hit, err_msg=name)
    np.testing.assert_allclose(got[2][hit], want[2][hit], rtol=1e-4, atol=1e-3, err_msg=name)
    assert (got[2][~hit] == rk.BIG).all()
    diff = rgba8(got[0], got[1]).astype(np.int32) - rgba8(want[0], want[1]).astype(np.int32)
    assert np.abs(diff).max() <= 1, name
    if name == "two_views":
        # the nearest depth of each view: 5 - 1 and 9 - 1 minus the grid's
        # off-axis overshoot (tests/test_render.py:343-350)
        depth = got[2].reshape(2, 2, -1)
        np.testing.assert_allclose(depth[:, 0].min(1), 4.0, atol=0.15)
        np.testing.assert_allclose(depth[:, 1].min(1), 8.0, atol=0.5)


def test_render_tables_match_jax(scene):
    _, sc = scene
    want = JRenderTables(sc["om"], sc["albedo"], sc["mesh_tables"])
    got = rk.RenderTables(sc["om"], sc["albedo"], sc["mesh_tables"])
    for field in ("O", "prim_type", "radius", "Fm", "num_faces", "F_used", "r_bound",
                  "has_mesh", "T_used"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("face_n", "face_d", "albedo", "tri_a", "tri_e1", "tri_e2", "tri_mask",
                  "tri_n"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.key() == want.key()


def test_render_tables_fallback_bounding_radius_is_2():
    """ROADMAP Queue 3: without local AABBs in the object manager, the
    kernel's cull takes max(2.0, sphere_radius) as every object's bounding
    radius (gpu_ecs_madrona_tpu/ops/render_kernel.py:87), so a hull wider
    than 2 can be culled from a tile it shows in.  Reproduced, not fixed."""
    om = dict(scenes.pallas_scene()["om"])
    om.pop("local_aabb_lo")
    om.pop("local_aabb_hi")
    got = rk.RenderTables(om, scenes.ALBEDO3)
    assert got.r_bound == [2.0, 2.0, 2.0]
    assert got.r_bound == JRenderTables(om, scenes.ALBEDO3).r_bound
    om["sphere_radius"] = np.array([0.0, 3.5, 0.0], np.float32)
    assert rk.RenderTables(om, scenes.ALBEDO3).r_bound == [2.0, 3.5, 2.0]


def test_kernel_table_layout():
    """The kernel's object table: the fixed columns, the face planes of the
    hull (zero past its face count), the triangles of the mesh object."""
    sc = scenes.sphere_mesh()
    t = rk.RenderTables(sc["om"], sc["albedo"], sc["mesh_tables"])
    tab = t.table()
    assert tab.shape == (2, rk.K_FIXED + rk.K_TRI * t.T_used) and t.F_used == 0
    assert list(tab[:, rk.K_PRIM]) == [0.0, 2.0] and list(tab[:, rk.K_MESH]) == [1.0, 0.0]
    np.testing.assert_array_equal(tab[:, rk.K_ALBEDO:rk.K_ALBEDO + 3], sc["albedo"])
    live = tab[0, rk.K_FIXED + 12::rk.K_TRI]
    assert live.sum() == t.T_used == 16 and not tab[1, rk.K_FIXED:].any()
    box = rk.RenderTables(scenes.pallas_scene()["om"], scenes.ALBEDO3)
    assert box.F_used == 6 and box.table()[0, rk.K_NFACE] == 6


def test_first_instance_wins_a_tie():
    """Two coincident spheres of different objects: the lower row's albedo
    (the kernel's strict <)."""
    loader = scenes.assets.PhysicsLoader()
    loader.load_objects([scenes.assets.make_sphere(1.0), scenes.assets.make_sphere(1.0)])
    alb = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    k = rk.RenderKernel(loader.get_object_manager(), alb, scenes.LIGHT_DIR, scenes.AMBIENT)
    ro, rd = scenes.camera_rays((0.0, -4.0, 0.0), (1.0, 0, 0, 0), 40.0, 8)
    for first in (0, 1):
        rgb, hit, _ = k(torch.from_numpy(ro)[None], torch.from_numpy(rd)[None],
                        torch.zeros((1, 2, 3)), torch.tensor([[[1.0, 0, 0, 0]] * 2]),
                        torch.ones((1, 2, 3)), torch.tensor([[first, 1 - first]]),
                        torch.ones((1, 2), dtype=torch.bool), img_w=8)
        assert hit.any()
        assert (rgb[hit][:, first] > 0).all() and (rgb[hit][:, 1 - first] == 0).all()


def test_render_wrapper_rejects_bad_input():
    sc = scenes.pallas_scene()
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT)
    rays, inst = k.pack(*(torch.from_numpy(sc[key]) for key in INPUTS))
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, img_w=sc["img_w"])
    with pytest.raises(ValueError, match="float32"):
        rk.render(rays.double(), inst, **kw)
    with pytest.raises(ValueError, match="inst"):
        rk.render(rays, inst[:, :11], **kw)
    with pytest.raises(ValueError, match="worlds"):
        rk.render(rays, inst[:1], **kw)
    with pytest.raises(ValueError, match="light"):
        rk.render(rays, inst, **dict(kw, light=(1.0, 0.0)))
    with pytest.raises(ValueError, match="img_w"):
        rk.render(rays, inst, **dict(kw, img_w=0))
    assert rk.RenderKernel.launches == 0


def test_kernel_fits_and_tiles():
    assert rk.kernel_fits(104) == ""
    assert "at least one" in rk.kernel_fits(0)
    # the views mode keeps 6 float4s an instance, the rays mode 4 and each
    # warp's cull terms (a float4 and a float)
    assert rk.smem_bytes(104, views=True) == 104 * 96 and rk.smem_bytes(104) == 104 * 144
    # past one block's 227 KB (2,421 instances in the views mode, 1,614 in
    # the rays mode) the mode's blocked twin stages its cone's survivors in
    # stages: any count is taken
    assert not rk.blocked(2421, views=True) and rk.blocked(2422, views=True)
    assert not rk.blocked(1614) and rk.blocked(1615)
    assert rk.kernel_fits(2000, views=True) == "" and rk.stage_blocks(2000, views=True) == 1
    for N, views in ((5000, False), (2000, False), (3000, True), (4096, True), (4096, False)):
        assert rk.kernel_fits(N, views) == "" and rk.blocked(N, views)
        if views:   # the blocked twin: stages of survivors beside a 64 x 64 image's hits
            assert rk.stage_blocks(N, views) == -(-N // rk.views_stage(64, 64))
            assert rk.smem_bytes(N, views) == (rk.views_stage(64, 64) * rk.VIEWS_ENTRY
                                               + rk.views_carry_bytes(64, 64)) <= rk.VIEWS_SMEM
        else:   # the rays twin: 64 x 64 rays in four strips of 32 tiles
            assert rk.rays_splits(128) == 4 and rk.rays_stage(32) == 1056
            assert rk.stage_blocks(N, views) == -(-N // 1056)
            assert rk.smem_bytes(N) == (1056 * rk.VIEWS_ENTRY + 32 * rk.RAYS_TILE_BYTES
                                        ) <= rk.VIEWS_SMEM
    # a warp's tile is 8 x 4 pixels: 128 tiles a 64 x 64 image
    assert rk.tile_shape(4096, 64) == (64, 8, 4, 128)
    # the inside scene: its two 8 x 8 views stack as 16 rows, four tiles,
    # each inside one view (inside_wrapping's 6 x 6 views share a tile)
    assert rk.tile_shape(128, 8) == (8, 8, 4, 4)
    assert rk.tile_shape(72, 6) == (6, 8, 4, 3)
    assert rk.tile_shape(640, 24) == (24, 8, 4, 21)
    # CTAs sharing an image: enough for MIN_CTAS, at most one a WARPS tiles
    assert rk.launch_splits(1024, 128) == 3
    assert rk.launch_splits(2, 128) == 32 and rk.launch_splits(2, 4) == 1
    assert rk.launch_splits(8192, 128) == 1


def test_padded_rays_are_misses():
    """RenderKernel pads P to a multiple of 128 with zero rays; they come out
    as misses and are cut before the outputs are returned."""
    sc = scenes.pallas_scene(res=10)
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT)
    rays, inst = k.pack(*(torch.from_numpy(sc[key]) for key in INPUTS))
    assert rays.shape[2] == 128
    out = rk.render(rays, inst, tables=k.tables, light=k.light, ambient=k.ambient, img_w=10)
    pad = out[:, :, 100:]
    assert (pad[:, :4] == 0).all() and (pad[:, 4] == rk.BIG).all()
    rgb, hit, depth = k(*(torch.from_numpy(sc[key]) for key in INPUTS), img_w=10)
    assert rgb.shape == (2, 100, 3) and hit.shape == depth.shape == (2, 100)
    assert torch.equal(depth, out[:, 4, :100])


def test_launch_mirror_matches_the_cu():
    """ops/render_kernel.py's launch constants (warps a CTA, the tile, the
    shared bytes an instance of each mode) equal csrc/render_kernels.cu's."""
    import re
    from pathlib import Path
    src = (Path(rk.__file__).resolve().parents[1] / "csrc" / "render_kernels.cu").read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    tile = re.search(r"constexpr int kTileW = (\d+), kTileH = (\d+);", src)
    stage = re.search(r"constexpr int kStageRays = ([^,]+), kStageViews = ([^;]+);", src)
    assert warps == rk.WARPS
    assert (int(tile.group(1)), int(tile.group(2))) == (rk.TILE_W, rk.TILE_H)
    env = {"kWarps": warps}
    assert eval(stage.group(1), env) == rk.STAGE_RAYS
    assert eval(stage.group(2), env) == rk.STAGE_VIEWS
    cull = [float(re.search(rf"constexpr float {k} = ([\d.e-]+)f;", src).group(1))
            for k in ("kCullRel", "kCullAbs")]
    assert cull == [rk.CULL_REL, rk.CULL_ABS]


def test_blocked_layout_matches_the_cu():
    """The shared-memory limit (kMaxSmem) in csrc/render_kernels.cu is the
    wrapper's MAX_SMEM_BYTES; its render_smem is smem_bytes at one stage
    (the staged bytes an instance, no index); the blocked twins' constants
    and layout functions are the wrapper's."""
    import re
    from pathlib import Path
    cu = (Path(rk.__file__).resolve().parents[1] / "csrc" / "render_kernels.cu").read_text()
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", cu).group(1)) == \
        rk.MAX_SMEM_BYTES
    body = cu[cu.index("size_t render_smem("):]
    assert "static_cast<size_t>(N) * (views ? kStageViews : kStageRays)" in \
        body[:body.index("\n}\n")]
    # the blocked twins: their constants, and views_stage /
    # views_carry_bytes / views_blocked_smem evaluated from the .cu
    const = {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", cu)}
    env = {"kMaxSmem": rk.MAX_SMEM_BYTES, "kTileW": rk.TILE_W, "kTileH": rk.TILE_H}
    for name in ("kVSplits", "kVWarps", "kVThreads", "kVCtas", "kVEntry", "kCarryMax", "kVSmem",
                 "kRSplits", "kRTiles", "kRTileBytes"):
        expr = const[name].replace("static_cast<int>(kMaxSmem)", "kMaxSmem").replace("/", "//")
        expr = re.sub(r"\((\w+) == 1 \? (.+?) : (.+)\) - 1024",
                      r"((\2) if \1 == 1 else (\3)) - 1024", expr)
        env[name] = eval(expr, {}, env)
    assert (env["kVSplits"], env["kVWarps"], env["kVCtas"], env["kVEntry"], env["kCarryMax"],
            env["kVSmem"]) == (rk.VIEWS_SPLITS, rk.VIEWS_WARPS, rk.VIEWS_CTAS, rk.VIEWS_ENTRY,
                               rk.CARRY_MAX, rk.VIEWS_SMEM)
    assert (env["kRSplits"], env["kRTiles"], env["kRTileBytes"]) == (
        rk.RAYS_SPLITS, rk.RAYS_TILES, rk.RAYS_TILE_BYTES)

    def cu_fn(name, **args):
        """The .cu's function ``name`` evaluated in Python: its const
        lines in order, then its return; calls of views_splits and
        views_carry_bytes evaluated the same way."""
        body = cu[cu.index(f" {name}(int "):]
        body = body[:body.index("\n}\n")]
        scope = dict(env, **args)

        def py(expr):
            expr = " ".join(expr.split())
            expr = re.sub(r"static_cast<[\w ]+>", "", expr).replace("8LL", "8").replace("/", "//")
            for fn in ("views_splits", "views_carry_bytes"):
                if f"{fn}(H, Wpx)" in expr:
                    expr = expr.replace(f"{fn}(H, Wpx)",
                                        str(cu_fn(fn, H=scope["H"], Wpx=scope["Wpx"])))
            return re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)", expr)

        for var, expr in re.findall(r"const (?:int|long long) (\w+) = (.*?);", body, re.S):
            scope[var] = eval(py(expr), {}, scope)
        return eval(py(re.search(r"return (.*?);", body, re.S).group(1)), {}, scope)

    for H, Wpx in ((64, 64), (24, 40), (96, 96), (8, 8), (90, 91), (128, 64), (256, 256)):
        assert cu_fn("views_splits", H=H, Wpx=Wpx) == rk.views_splits(H, Wpx) >= 1
        assert cu_fn("views_carry_bytes", H=H, Wpx=Wpx) == rk.views_carry_bytes(H, Wpx)
        assert cu_fn("views_stage", H=H, Wpx=Wpx) == rk.views_stage(H, Wpx) > 0
        stage = rk.views_stage(H, Wpx)
        smem = cu_fn("views_blocked_smem", stage=stage, H=H, Wpx=Wpx)
        assert smem == rk.smem_bytes(4096, True, H, Wpx) <= rk.VIEWS_SMEM
    # the rays mode's blocked twin: P rays in rows of img_w (a partial last
    # row among them), its strips of tiles, stages and shared memory
    for P, img_w in ((4096, 64), (640, 24), (128, 8), (72, 6), (40960, 160), (1 << 20, 1024),
                     (4097, 64)):
        tiles = cu_fn("ray_tiles", P=P, img_w=img_w)
        assert tiles == rk.tile_shape(P, img_w)[3]
        splits = cu_fn("rays_splits", tiles=tiles)
        assert splits == rk.rays_splits(tiles) >= 1
        cta = cu_fn("rays_cta_tiles", tiles=tiles, splits=splits)
        assert cta == -(-tiles // splits) <= rk.RAYS_TILES
        assert cu_fn("rays_stage", cta_tiles=cta) == rk.rays_stage(cta) >= 32
        smem = cu_fn("rays_blocked_smem", stage=rk.rays_stage(cta), cta_tiles=cta)
        assert smem <= rk.VIEWS_SMEM
        if P % img_w == 0:
            assert smem == rk.smem_bytes(4096, False, P // img_w, img_w)



@pytest.mark.parametrize("rays", ["camera", "sweep", "many_origins"])
def test_rays_cta_cone_keeps_every_winner(rays):
    """The rays-mode blocked twin stages only the instances that meet its
    CTA's cone (rk.rays_cta_cull, the kernel's formula): on the large scene
    (2 worlds, 16 x 16, 4,096 rows) under its camera, under a 360-degree
    sweep from its eye (whose strips' cones span 90 degrees or more) and
    under rays from many origins, every pixel's winner in render_plain is
    staged by the pixel's CTA, for the default strips and for 2, 4 and 8 of
    them; the cull keeps less than the whole world."""
    sc = scenes.large_scene(W=2, res=16)
    k = rk.RenderKernel(sc["om"], sc["albedo"], scenes.LIGHT_DIR, scenes.AMBIENT,
                        mesh_tables=sc["mesh_tables"])
    ro, rd = sc["ro"], sc["rd"]
    if rays == "sweep":
        ro, rd = scenes.sweep_rays(sc["ro"][:, 0], 16, 16)
    if rays == "many_origins":   # each ray from a point of its own within 0.3
        ro = ro + np.random.default_rng(5).uniform(-0.3, 0.3, ro.shape).astype(np.float32)
    rays_t, inst = k.pack(*(torch.from_numpy(a) for a in (ro, rd, sc["pos"], sc["rot"],
                                                          sc["scale"], sc["obj"], sc["mask"])))
    _, win = rk.render_plain(rays_t, inst, tables=k.tables, light=k.light, ambient=k.ambient,
                             winners=True)
    w, p = torch.nonzero(win >= 0, as_tuple=True)
    assert len(p) > 100
    for splits in (None, 2, 4, 8):
        keep = rk.rays_cta_cull(rays_t, inst, k.tables, 16, splits)
        cta = rk.rays_pixel_cta(rays_t.shape[2], 16, keep.shape[1])
        assert bool(keep[w, cta[p], win[w, p]].all()), (rays, splits)
        assert not bool(keep.all()), (rays, splits)
