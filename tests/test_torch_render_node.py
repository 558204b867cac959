"""The render node's camera rays, its views-mode wrapper and the node itself
against the JAX package and against the node's route of rays, kernel and
epilogue, on the CPU.

  - ``camera_rays`` against the JAX node's rays (gpu_ecs_madrona_tpu/
    render/renderer.py, its camera-ray lines) from the same views, atol
    1e-6; and bit for bit against the same formulas written out in numpy,
    each cross product's components and each norm's squares added in
    component order;
  - ``render_views_plain`` bit for bit against the route it replaces
    (``camera_rays`` -> ``RenderKernel.pack`` -> ``render_plain`` -> the
    RGBA8/depth epilogue), one and two views, dead views, 24 x 40 and
    18 x 30 images, a triangle-mesh scene
    (tests/test_torch_render_scenes.py VIEW_CASES);
  - the render node against the JAX node on the JAX kernel route in
    interpret mode (tests/test_render_pallas.py's tolerances: RGBA8 within
    1, depth rtol 1e-4 / atol 1e-3, hit masks equal);
  - ``render_views``' input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.utils import math as jm

import test_torch_render_scenes as scenes
from test_torch_render import build
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk


def jax_rays(views, V, H, Wpx):
    """The JAX node's camera rays (gpu_ecs_madrona_tpu/render/renderer.py,
    BatchRenderer.setup_tasks' render), evaluated by JAX."""
    W = views["eye"].shape[0]
    ys = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H * 2 - 1
    xs = (jnp.arange(Wpx, dtype=jnp.float32) + 0.5) / Wpx * 2 - 1
    px, py = jnp.meshgrid(xs, -ys)
    eye = jnp.asarray(views["eye"])[:, :V]
    vrot = jnp.asarray(views["rot"])[:, :V]
    tanf = jnp.asarray(views["tan_fov"])[:, :V]
    d_cam = jnp.stack([jnp.broadcast_to(px, (W, V, H, Wpx)) * tanf[..., None, None],
                       jnp.ones((W, V, H, Wpx)),
                       jnp.broadcast_to(py, (W, V, H, Wpx)) * tanf[..., None, None]], axis=-1)
    d = jm.quat_rotate(vrot[:, :, None, None, :], d_cam)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return np.asarray(jnp.broadcast_to(eye[:, :, None, None, :], d.shape)), np.asarray(d)


def numpy_rays(views, V, H, Wpx):
    """The rays written out in numpy float32, one rounding an operation:
    cross products by component, |d|^2 as ((x0 x0 + x1 x1) + x2 x2); the
    square root through torch.sqrt on the same CPU."""
    f = np.float32

    def ndc(n):
        return (np.arange(n, dtype=f) + f(0.5)) / f(n) * f(2) - f(1)

    tanf = views["tan_fov"][:, :V, None, None]
    shape = tanf.shape[:2] + (H, Wpx)
    v = (np.broadcast_to(ndc(Wpx)[None, None, None, :] * tanf, shape),
         np.ones(shape, f), np.broadcast_to(-ndc(H)[None, None, :, None] * tanf, shape))
    q = [views["rot"][:, :V, None, None, c] for c in range(4)]

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    uv = cross(q[1:], v)
    uuv = cross(q[1:], uv)
    d = [a + f(2) * (q[0] * b + c) for a, b, c in zip(v, uv, uuv)]
    sq = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    n = torch.sqrt(torch.from_numpy(np.ascontiguousarray(sq))).numpy()
    return np.stack([a / n for a in d], axis=-1)


@pytest.mark.parametrize("V,H,Wpx", [(1, 16, 16), (2, 24, 40)], ids=["16x16", "2x24x40"])
def test_camera_rays_match_jax(V, H, Wpx):
    views = scenes.random_views(3, 3, 2)
    ro, d = rk.camera_rays(scenes.torch_views(views), V, H, Wpx)
    jro, jd = jax_rays(views, V, H, Wpx)
    assert tuple(d.shape) == jd.shape == (3, V, H, Wpx, 3) and d.dtype == torch.float32
    np.testing.assert_array_equal(ro.numpy(), jro)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-6, rtol=0)


@pytest.mark.parametrize("V,H,Wpx", [(1, 16, 16), (2, 24, 40)], ids=["16x16", "2x24x40"])
def test_camera_rays_add_in_component_order(V, H, Wpx):
    views = scenes.random_views(4, 3, 2)
    _, d = rk.camera_rays(scenes.torch_views(views), V, H, Wpx)
    want = numpy_rays(views, V, H, Wpx)
    assert np.array_equal(d.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", list(scenes.VIEW_CASES))
def test_render_views_plain_matches_the_old_route(case):
    k, views, inst, V, H, Wpx = scenes.view_case(case)
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, height=H, width=Wpx,
              max_views=V)
    rk.RenderKernel.launches = 0
    rgb, depth = rk.render_views(views, *inst, **kw)
    plain = rk.render_views_plain(views, *inst, **kw)
    want = scenes.node_route(k, views, inst, V, H, Wpx)
    assert rk.RenderKernel.launches == 0
    W = views["eye"].shape[0]
    assert rgb.shape == (W, V, H, Wpx, 4) and rgb.dtype == torch.uint8
    assert depth.shape == (W, V, H, Wpx) and depth.dtype == torch.float32
    for got in ((rgb, depth), plain):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    alive = views["mask"][:, :V]
    assert bool(torch.isfinite(depth[alive]).any())
    assert (rgb[~alive] == 0).all() and torch.isinf(depth[~alive]).all()
    hit = torch.isfinite(depth)
    assert torch.equal(rgb[..., 3] == 255, hit) and bool(((rgb[..., 3] == 0) | hit).all())


@pytest.mark.parametrize("views,res", [(((0, (0.0, -2.0, 1.5), (1.0, 0, 0, 0)),), 16),
                                       (((1, (0.0, 9.0, 1.0), (0.0, 0, 0, 1.0)),
                                         (0, (0.0, -5.0, 1.0), (1.0, 0, 0, 0))), 16)],
                         ids=["one_view", "two_views"])
def test_render_node_matches_jax_kernel_route(views, res):
    """The port's node (the views mode's plain version on the CPU) against
    the JAX node on its Pallas kernel route (interpret mode on the CPU),
    one step of tests/test_render_tiles.py's scene from one state."""
    jsim = build("jax", backend="pallas", views=views, cam_cap=len(views), res=res)
    psim = build("port", backend="auto", views=views, cam_cap=len(views), res=res)
    psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    jsim.step()
    psim.step()
    jr = jax.tree_util.tree_map(np.asarray, jsim.state)["user"]["render_out"]
    pr = state_to_numpy(psim.state)["user"]["render_out"]
    hit = np.isfinite(jr["depth"])
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isfinite(pr["depth"]), hit)
    np.testing.assert_allclose(pr["depth"][hit], jr["depth"][hit], rtol=1e-4, atol=1e-3)
    assert np.abs(pr["rgb"].astype(np.int32) - jr["rgb"].astype(np.int32)).max() <= 1


def test_render_views_rejects_bad_input():
    k, views, inst, V, H, Wpx = scenes.view_case("two_views_dead")
    kw = dict(tables=k.tables, light=k.light, ambient=k.ambient, height=H, width=Wpx,
              max_views=V)
    rk.RenderKernel.launches = 0
    with pytest.raises(ValueError, match="float32"):
        rk.render_views(dict(views, eye=views["eye"].double()), *inst, **kw)
    with pytest.raises(ValueError, match="float32"):
        rk.render_views(views, inst[0].double(), *inst[1:], **kw)
    with pytest.raises(ValueError, match="int32"):
        rk.render_views(views, *inst[:3], inst[3].long(), inst[4], **kw)
    with pytest.raises(ValueError, match="bool"):
        rk.render_views(views, *inst[:4], inst[4].float(), **kw)
    with pytest.raises(ValueError, match="device"):
        rk.render_views(views, inst[0].to("meta"), *inst[1:], **kw)
    with pytest.raises(ValueError, match="views"):
        rk.render_views(views, *inst, **dict(kw, max_views=3))
    with pytest.raises(ValueError, match="views"):
        rk.render_views(views, *inst, **dict(kw, max_views=0))
    with pytest.raises(ValueError, match="worlds"):
        rk.render_views(views, *(x[:1] for x in inst), **kw)
    with pytest.raises(ValueError, match="image"):
        rk.render_views(views, *inst, **dict(kw, width=0))
    assert rk.RenderKernel.launches == 0
