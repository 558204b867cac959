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
    # the rays mode) the kernel stages them in blocks of BLOCK, each with its
    # index: any count is taken
    assert not rk.blocked(2421, views=True) and rk.blocked(2422, views=True)
    assert not rk.blocked(1614) and rk.blocked(1615)
    assert rk.kernel_fits(2000, views=True) == "" and rk.stage_blocks(2000, views=True) == 1
    for N, views in ((5000, False), (2000, False), (3000, True), (4096, True), (4096, False)):
        assert rk.kernel_fits(N, views) == "" and rk.blocked(N, views)
        assert rk.stage_blocks(N, views) == -(-N // rk.BLOCK)
        stage = rk.STAGE_VIEWS if views else rk.STAGE_RAYS
        assert rk.smem_bytes(N, views) == rk.BLOCK * (stage + 4) <= rk.MAX_SMEM_BYTES
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


def test_blocked_layout_matches_the_cu():
    """The blocked specialisations' block (kBlock) and shared-memory limit
    (kMaxSmem) in csrc/render_kernels.cu are the wrapper's BLOCK and
    MAX_SMEM_BYTES; its render_smem is smem_bytes (an index, 4 bytes, more
    an instance when blocked)."""
    import re
    from pathlib import Path
    cu = (Path(rk.__file__).resolve().parents[1] / "csrc" / "render_kernels.cu").read_text()
    assert int(re.search(r"constexpr int kBlock = (\d+);", cu).group(1)) == rk.BLOCK
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", cu).group(1)) == \
        rk.MAX_SMEM_BYTES
    body = cu[cu.index("size_t render_smem("):]
    assert "static_cast<size_t>(block) * (stage + sizeof(int))" in body[:body.index("\n}\n")]

