"""The port's render interop, renderer routes and raycast against the JAX
package, on the CPU.

  - the render_pack node: instance buffers and view routing by view_idx,
    with a dead view slot, leaf by leaf against JAX (exact);
  - the "xla" route, dense, tiled, and tiled with a triangle render mesh,
    on tests/test_render_tiles.py's scenes from one JAX-initialised state:
    RGBA8 equal, hit masks equal, depth np.allclose (that file's own
    tolerances);
  - the route each backend takes (the kernel's plain version on the CPU;
    "auto" without exact hulls refused for the card);
  - physics.raycast on tests/test_physics.py:254's scene and
    tests/test_render.py:97's octahedron.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.core import base as jbase
from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.render import interop as jinterop
from gpu_ecs_madrona_tpu.render import renderer as jrenderer

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.ops import render_kernel as rk
from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.render import interop, renderer

PKG = {"jax": (JArchetype, jbase, jassets, jinterop, jrenderer),
       "port": (Archetype, base, assets, interop, renderer)}


def _l_prism():
    """tests/test_render_tiles.py's L-shaped prism (verts, tris)."""
    v2 = [(0, 0), (1.2, 0), (1.2, 0.5), (0.5, 0.5), (0.5, 1.2), (0, 1.2)]
    verts = [(x - 0.6, y - 0.6, z) for z in (-0.4, 0.4) for (x, y) in v2]
    tris = []
    for (a, b, c) in [(0, 1, 2), (0, 2, 3), (0, 3, 4), (0, 4, 5)]:
        tris += [(a, b, c), (6 + a, 6 + c, 6 + b)]
    for i in range(6):
        j = (i + 1) % 6
        tris += [(i, j, 6 + j), (i, 6 + j, 6 + i)]
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def build(pkg, backend="xla", tile_size=0, max_per_tile=32, mesh=False, res=32, W=2,
          views=((0, (0.0, -2.0, 1.5), (1.0, 0, 0, 0)),), cam_cap=1):
    """tests/test_render_tiles.py's scene in either package: a grid of
    spheres and boxes (9 with the mesh, 24 without) and a ground plane, and
    one camera row per entry of ``views`` (view_idx, eye, quat) in a camera
    archetype of ``cam_cap`` rows.  Returns the executor."""
    Arch, bmod, amod, imod, rmod = PKG[pkg]
    loader = amod.PhysicsLoader()
    loader.load_objects([amod.make_sphere(0.5), amod.make_box((0.6, 0.6, 0.6) if mesh
                                                              else (0.4, 0.4, 0.4)),
                         amod.make_plane()])
    om = loader.get_object_manager()
    Ball = Arch("RTBall", [bmod.Position, bmod.Rotation, bmod.Scale, bmod.ObjectID])
    Cam = Arch("RTCam", [bmod.Position, bmod.Rotation, imod.ActiveView])
    rend = rmod.BatchRenderer(
        rmod.RendererConfig(width=res, height=res, max_views=len(views), backend=backend,
                            tile_size=tile_size, max_instances_per_tile=max_per_tile,
                            max_tris=32),
        om, render_meshes={1: _l_prism()} if mesh else None)
    n = 9 if mesh else 24
    idx = np.arange(n)
    if mesh:
        pos = np.stack([(idx % 3 - 1) * 2.0, 4.0 + (idx % 2) * 2.5, (idx // 3) * 1.5 + 0.6], -1)
    else:
        pos = np.stack([(idx % 5 - 2) * 1.6, 4.0 + (idx % 3) * 2.0, (idx // 5) * 1.4 + 0.6], -1)
    pos = np.concatenate([pos, np.zeros((1, 3))]).astype(np.float32)
    oid = np.concatenate([idx % 2, [2]]).astype(np.int32)

    def conv(a, dt=np.float32):
        a = np.broadcast_to(np.asarray(a, dt), (W,) + np.asarray(a).shape).copy()
        return jnp.asarray(a) if pkg == "jax" else torch.from_numpy(a)

    class World:
        @staticmethod
        def register_types(registry):
            bmod.register_types(registry)
            imod.RenderingSystem.register_types(registry)
            registry.register_archetype(Ball, capacity=n + 2)
            registry.register_archetype(Cam, capacity=cam_cap)

        @staticmethod
        def init(ctx, init_data=None):
            ctx.data = {}
            imod.RenderingSystem.init(ctx, renderable_archetypes=[Ball], view_archetype=Cam,
                                      max_views=len(views))
            rend.init_buffers(ctx)
            ctx.make_entities(Ball, counts=n + 1, max_new=n + 1, values={
                bmod.Position: conv(pos), bmod.Rotation: conv([[1.0, 0, 0, 0]] * (n + 1)),
                bmod.Scale: conv(np.ones((n + 1, 3))), bmod.ObjectID: conv(oid, np.int32)})
            for vi, eye, quat in views:
                ctx.make_entities(Cam, counts=1, max_new=1, values={
                    bmod.Position: conv([eye]), bmod.Rotation: conv([quat]),
                    imod.ActiveView: imod.RenderingSystem.setup_view(ctx, 90.0, view_idx=vi)})

        @staticmethod
        def setup_tasks(builder):
            pack = imod.RenderingSystem.setup_tasks(builder, [], [Ball], Cam)
            rend.setup_tasks(builder, [pack], [Ball])

    if pkg == "jax":
        return JTaskGraphExecutor(World, JExecutorConfig(num_worlds=W, max_entities_per_world=64,
                                                         seed=0, donate=False))
    return TaskGraphExecutor(World, ExecutorConfig(num_worlds=W, max_entities_per_world=64,
                                                   seed=0, device="cpu"))


def one_step_both(**kw):
    """One step of the scene in JAX and in the port from JAX's initial
    state; returns both states as numpy."""
    jsim = build("jax", **kw)
    psim = build("port", **kw)
    psim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    jsim.step()
    psim.step()
    return jax.tree_util.tree_map(np.asarray, jsim.state), state_to_numpy(psim.state), psim


def test_render_pack_matches_jax():
    """Views created in row order 1, 0 route to slots 0 and 1 by view_idx;
    the camera archetype's third row has no entity, so slot 2 is dead."""
    views = ((1, (0.0, 9.0, 1.0), (0.0, 0, 0, 1.0)), (0, (0.0, -5.0, 1.0), (1.0, 0, 0, 0)))
    want, got, psim = one_step_both(backend="auto", views=views, cam_cap=3, res=16)
    for key in ("RTBall", "__views__"):
        for leaf, a in want["user"]["render"][key].items():
            b = got["user"]["render"][key][leaf]
            assert a.dtype == b.dtype and np.array_equal(a, b), (key, leaf)
    v = got["user"]["render"]["__views__"]
    assert v["mask"].tolist() == [[True, True, False]] * 2
    np.testing.assert_array_equal(v["eye"][:, 0], [[0.0, -5.0, 1.0]] * 2)
    np.testing.assert_array_equal(v["eye"][:, 1], [[0.0, 9.0, 1.0]] * 2)
    # observations: [W, 2 views, 16, 16]; both views see the scene
    rgb, depth = psim.rgb_observations(), psim.depth_observations()
    assert rgb.shape == (2, 2, 16, 16, 4) and rgb.dtype == torch.uint8
    assert depth.shape == (2, 2, 16, 16) and torch.isfinite(depth[:, :2]).any()
    jr = want["user"]["render_out"]
    hit = np.isfinite(jr["depth"])
    np.testing.assert_array_equal(np.isfinite(depth.numpy()), hit)
    np.testing.assert_allclose(depth.numpy()[hit], jr["depth"][hit], rtol=1e-4, atol=1e-3)
    assert np.abs(rgb.numpy().astype(int) - jr["rgb"].astype(int)).max() <= 1


def test_dead_view_renders_black_and_inf():
    """A view slot whose mask is off renders black with depth inf; the
    live view beside it renders as it would alone."""
    from gpu_ecs_madrona_tpu_torch.core.context import Context
    cam = (0.0, -2.0, 1.5), (1.0, 0, 0, 0)
    _, alone, _ = one_step_both(backend="auto", views=((0,) + cam,), cam_cap=2, res=16)
    psim = build("port", backend="auto", views=((0,) + cam, (1,) + cam), cam_cap=2, res=16)
    ctx = Context(psim.mgr, psim.state)
    nodes = {nd.name: nd for nd in psim.graph.nodes}
    nodes["render_pack"].run(ctx)
    user = dict(ctx.data)
    user["render"] = dict(user["render"])
    user["render"]["__views__"] = dict(user["render"]["__views__"],
                                       mask=torch.tensor([[True, False]] * 2))
    ctx.data = user
    nodes["batch_render"].run(ctx)
    out = ctx.data["render_out"]
    assert (out["rgb"][:, 1] == 0).all() and torch.isinf(out["depth"][:, 1]).all()
    assert torch.isfinite(out["depth"][:, 0]).any()
    assert torch.equal(out["rgb"][:, 0], torch.from_numpy(alone["user"]["render_out"]["rgb"][:, 0]))


@pytest.mark.parametrize("tile_size,max_per_tile,mesh", [(0, 32, False), (16, 32, False),
                                                         (16, 4, False), (16, 16, True)],
                         ids=["dense", "tiled", "tiled_capped", "tiled_mesh"])
def test_xla_route_matches_jax(tile_size, max_per_tile, mesh):
    want, got, _ = one_step_both(backend="xla", tile_size=tile_size,
                                    max_per_tile=max_per_tile, mesh=mesh)
    jr, pr = want["user"]["render_out"], got["user"]["render_out"]
    finite = np.isfinite(jr["depth"])
    assert finite.any() and (jr["rgb"][..., 3] > 0).any()
    assert np.array_equal(np.isfinite(pr["depth"]), finite)
    assert np.allclose(pr["depth"][finite], jr["depth"][finite])
    assert np.array_equal(pr["rgb"], jr["rgb"])


def test_route_selection():
    om = assets.PhysicsLoader()
    om.load_objects([assets.make_sphere(1.0)])
    om = om.get_object_manager()

    def route(**kw):
        return renderer.BatchRenderer(renderer.RendererConfig(**kw), om).route

    assert route() == "kernel" and route(backend="pallas") == "kernel"
    assert route(backend="xla") == "xla" and route(backend="xla", tile_size=8) == "xla"
    assert route(exact_hulls=False) == "xla"
    with pytest.raises(ValueError, match="exact_hulls=False"):
        route(backend="pallas", exact_hulls=False)
    with pytest.raises(ValueError, match="unknown renderer backend"):
        route(backend="vulkan")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_without_exact_hulls_takes_xla_only_on_the_cpu(device):
    """"auto" with exact_hulls=False has no kernel: the render node is built
    on the "xla" route for the CPU, as in JAX, and refused for the card,
    naming backend="xla" (the node is only built here, nothing runs)."""
    om = assets.PhysicsLoader()
    om.load_objects([assets.make_sphere(1.0)])
    rend = renderer.BatchRenderer(renderer.RendererConfig(exact_hulls=False),
                                  om.get_object_manager())
    added = []
    builder = type("Builder", (), {
        "mgr": type("Mgr", (), {"device": torch.device(device)})(),
        "add_node": lambda self, fn, deps, name: added.append(name) or name})()
    if device == "cpu":
        assert rend.setup_tasks(builder, [], []) == "batch_render" and added == ["batch_render"]
    else:
        with pytest.raises(ValueError, match="backend='xla'"):
            rend.setup_tasks(builder, [], [])
        assert added == []


def test_kernel_route_on_cpu_is_the_plain_version():
    """"auto" on CPU tensors runs the kernel's plain version: no launch, and
    the JAX XLA path's image within tests/test_render_pallas.py's tolerances."""
    rk.RenderKernel.launches = 0
    want, got, _ = one_step_both(backend="auto")
    assert rk.RenderKernel.launches == 0
    jr, pr = want["user"]["render_out"], got["user"]["render_out"]
    hit = np.isfinite(jr["depth"])
    np.testing.assert_array_equal(np.isfinite(pr["depth"]), hit)
    np.testing.assert_allclose(pr["depth"][hit], jr["depth"][hit], rtol=1e-4, atol=1e-3)
    assert np.abs(pr["rgb"].astype(int) - jr["rgb"].astype(int)).max() <= 1


def _raycast_both(om, pos, rot, scale, obj, mask, origins, dirs):
    want = jphys.raycast(*(jnp.asarray(a) for a in (pos, rot, scale, obj, mask)), om,
                         jnp.asarray(origins), jnp.asarray(dirs))
    got = phys.raycast(*(torch.from_numpy(np.asarray(a)) for a in (pos, rot, scale, obj, mask)),
                       om, torch.from_numpy(origins), torch.from_numpy(dirs))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_raycast_matches_jax():
    """tests/test_physics.py:254: a plane (row 0) and a unit sphere at z = 5;
    a ray down onto the sphere hits it at t = 4, an offset one the plane at
    t = 10; a third ray points away and misses; a dead row never hits."""
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_box((1.0, 1.0, 1.0)), assets.make_sphere(1.0),
                         assets.make_plane()])
    om = loader.get_object_manager()
    W = 2
    pos = np.zeros((W, 3, 3), np.float32)
    pos[:, 1, 2] = 5.0
    pos[:, 2] = (0.0, 0.0, 2.0)
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (W, 3, 1))
    scale = np.ones((W, 3, 3), np.float32)
    obj = np.tile(np.array([2, 1, 0], np.int32), (W, 1))
    mask = np.tile(np.array([True, True, False]), (W, 1))
    origins = np.tile(np.array([[0.0, 0.0, 10.0], [5.0, 5.0, 10.0], [0.0, 0.0, 10.0]],
                               np.float32), (W, 1, 1))
    dirs = np.tile(np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], np.float32),
                   (W, 1, 1))
    (jrow, jt), (row, t) = _raycast_both(om, pos, rot, scale, obj, mask, origins, dirs)
    assert row.dtype == np.int32 and t.dtype == np.float32
    np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(row, [[1, 0, -1]] * W)
    np.testing.assert_allclose(t, jt, atol=1e-5)
    np.testing.assert_allclose(t[:, :2], [[4.0, 10.0]] * W, atol=1e-4)
    assert np.isinf(t[:, 2]).all()


def test_raycast_exact_hull_matches_jax():
    """tests/test_render.py:97: an off-centre ray down onto the octahedron
    meets its slanted face at t = 9.5 (the OBB proxy would say 9)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32)
    faces = [np.array(f) for f in ([0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                                   [1, 2, 5], [3, 1, 5], [0, 3, 5])]
    loader = assets.PhysicsLoader(max_verts=8, max_faces=8, max_edges=16, max_face_verts=4,
                                  max_full_edges=16)
    loader.load_objects([assets.convex_hull_from_mesh(verts, faces)])
    om = loader.get_object_manager()
    W = 2
    args = (np.zeros((W, 1, 3), np.float32), np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                                     (W, 1, 1)),
            np.ones((W, 1, 3), np.float32), np.zeros((W, 1), np.int32), np.ones((W, 1), bool),
            np.tile(np.array([[0.5, 0.0, 10.0]], np.float32), (W, 1, 1)),
            np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (W, 1, 1)))
    (jrow, jt), (row, t) = _raycast_both(om, *args)
    np.testing.assert_array_equal(row, jrow)
    assert (row == 0).all()
    np.testing.assert_allclose(t, jt, atol=1e-6)
    np.testing.assert_allclose(t, 9.5, atol=1e-5)
