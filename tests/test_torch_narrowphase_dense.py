"""The dense contact mode's pieces against the JAX package (CPU):
physics/narrowphase.py ``narrowphase_dense`` and physics/solver.py
``solve_positions`` / ``solve_velocities``.

The same numpy inputs (made from a seed) go through both packages' dense
narrowphase: a random pile of boxes and spheres on a plane, boxes resting
on the plane, spheres overlapping spheres, two boxes crossed edge on edge
(tests/test_physics.py:553), a pile with a speculative margin, and a pile
of general hulls (a triangulated cube and a quickhulled octahedron).
``ok`` and ``num_points`` must be equal; normals, points and depths of the
valid contacts within 1e-5.  The solves take JAX's contacts and the same
bodies: positions and rotations within 1e-5, lambdas within 1e-5,
velocities within 1e-4 (a velocity is an impulse over a mass).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.physics import narrowphase as jnph
from gpu_ecs_madrona_tpu.physics import solver as jsolver

from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.physics import narrowphase as nph
from gpu_ecs_madrona_tpu_torch.physics import solver

BOX, SPHERE, PLANE = 0, 1, 2
KEYS = ("ok", "num_points", "normal", "points", "depth")


def physics_loader(pkg):
    loader = pkg.PhysicsLoader()
    loader.load_objects([pkg.make_box((1.0, 1.0, 1.0), inv_mass=1.0),
                         pkg.make_sphere(1.0, inv_mass=1.0), pkg.make_plane()])
    return loader.get_object_manager()


def general_hull_loader(pkg):
    box = pkg.make_box((0.5, 0.5, 0.5))
    tris = []
    for loop in box.faces:
        tris += [np.asarray([loop[0], loop[1], loop[2]]), np.asarray([loop[0], loop[2], loop[3]])]
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32) * 0.7
    loader = pkg.PhysicsLoader(max_verts=8, max_faces=8, max_edges=6, max_face_verts=4,
                               max_full_edges=12)
    loader.load_objects([pkg.convex_hull_from_mesh(box.verts, tris),
                         pkg.convex_hull_from_mesh(octa, [], hull_mode="quickhull"),
                         pkg.make_plane()])
    return loader.get_object_manager()


LOADERS = {"physics": physics_loader, "general": general_hull_loader}


def unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def pile(seed, W=3, n=12, spread=1.5, objects=(BOX, SPHERE)):
    """A plane in row 0 and a random pile above it; one dead row."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (W, n, 3)).astype(np.float32)
    pos[..., 2] += spread
    rot = unit_quats(rng, (W, n))
    obj = rng.choice(np.asarray(objects, np.int32), (W, n)).astype(np.int32)
    pos[:, 0], rot[:, 0], obj[:, 0] = 0.0, (1.0, 0.0, 0.0, 0.0), PLANE
    mask = np.ones((W, n), bool)
    mask[W // 2, n // 2] = False
    return pos, rot, obj, mask


def boxes_on_plane():
    """Boxes (half extent 1) resting 0.02 into the plane, tilted a little."""
    rng = np.random.default_rng(4)
    W, n = 2, 5
    pos = np.zeros((W, n, 3), np.float32)
    pos[:, 1:, 0] = np.arange(1, n) * 3.0
    pos[:, 1:, 2] = 0.98
    ang = rng.uniform(-0.05, 0.05, (W, n)).astype(np.float32)
    rot = np.stack([np.cos(ang / 2), np.sin(ang / 2), 0 * ang, 0 * ang], -1).astype(np.float32)
    obj = np.full((W, n), BOX, np.int32)
    obj[:, 0] = PLANE
    rot[:, 0] = (1.0, 0.0, 0.0, 0.0)
    return pos, rot, obj, np.ones((W, n), bool)


def spheres():
    """Unit spheres overlapping each other along a line and the plane."""
    W, n = 2, 5
    pos = np.zeros((W, n, 3), np.float32)
    pos[:, 1:, 0] = np.arange(1, n) * 1.7
    pos[:, 1:, 2] = 0.9
    pos[1, 1:, 1] = np.array([0.0, 0.3, -0.2, 0.1], np.float32)
    obj = np.full((W, n), SPHERE, np.int32)
    obj[:, 0] = PLANE
    rot = np.zeros((W, n, 4), np.float32)
    rot[..., 0] = 1.0
    return pos, rot, obj, np.ones((W, n), bool)


def edge_edge():
    """Two unit boxes crossed like an X, edge on edge 0.1 deep
    (tests/test_physics.py:553)."""
    c, s = math.cos(math.pi / 8), math.sin(math.pi / 8)
    pos = np.array([[[0.0, 0.0, 0.0], [0.0, 0.0, 2 * math.sqrt(2.0) - 0.1]]], np.float32)
    rot = np.array([[[c, s, 0.0, 0.0], [c, 0.0, s, 0.0]]], np.float32)
    return pos, rot, np.zeros((1, 2), np.int32), np.ones((1, 2), bool)


CASES = {
    "pile": ("physics", pile(0), 0.0),
    "boxes_on_plane": ("physics", boxes_on_plane(), 0.0),
    "spheres": ("physics", spheres(), 0.0),
    "edge_edge": ("physics", edge_edge(), 0.0),
    "speculative": ("physics", pile(1, spread=2.5), 0.5),
    "general_hulls": ("general", pile(2, n=10, spread=1.0, objects=(0, 1)), 0.0),
}


def jax_contacts(loader, inputs, speculative):
    om = {k: jnp.asarray(v) for k, v in LOADERS[loader](jassets).items()}
    out = jax.jit(lambda *a: jnph.narrowphase_dense(*a, om, speculative=speculative))(*inputs)
    return {k: np.asarray(v) for k, v in out.items()}


def port_contacts(loader, inputs, speculative):
    out = nph.narrowphase_dense(*(torch.from_numpy(x) for x in inputs),
                                LOADERS[loader](assets), speculative=speculative)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def contacts():
    """{case: (JAX contacts, port contacts)}."""
    return {name: (jax_contacts(*c), port_contacts(*c)) for name, c in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_narrowphase_dense_matches_jax(contacts, case):
    want, got = contacts[case]
    assert set(got) == set(KEYS)
    assert got["num_points"].dtype == np.int32 and got["ok"].dtype == bool
    np.testing.assert_array_equal(got["ok"], want["ok"])
    np.testing.assert_array_equal(got["num_points"], want["num_points"])
    ok = want["ok"]
    assert ok.any(), f"{case}: no contact"
    for k in ("normal", "points", "depth"):
        np.testing.assert_allclose(got[k][ok], want[k][ok], atol=1e-5, rtol=0, err_msg=k)
    # the pairs that are not valid carry the defaults
    assert not got["ok"][~np.triu(np.ones(ok.shape[1:], bool), 1)[None].repeat(len(ok), 0)].any()


def test_edge_edge_contact_point(contacts):
    """tests/test_physics.py:553's gates on the port: one contact at the
    closest point of the crossed edges (x = y = 0), 0.1 deep."""
    got = contacts["edge_edge"][1]
    assert got["ok"][0, 0, 1] and got["num_points"][0, 0, 1] == 1
    pt = got["points"][0, 0, 1, 0]
    assert abs(pt[0]) < 1e-4 and abs(pt[1]) < 1e-4, pt
    np.testing.assert_allclose(pt[2], math.sqrt(2.0) - 0.05, atol=0.02)
    np.testing.assert_allclose(got["depth"][0, 0, 1, 0], 0.1, atol=1e-4)
    np.testing.assert_allclose(abs(got["normal"][0, 0, 1, 2]), 1.0, atol=1e-5)


def test_speculative_margin_adds_near_misses(contacts):
    """The margin keeps contacts up to 0.5 apart (depth > -0.5), some of
    them separated."""
    got = contacts["speculative"][1]
    deepest = got["depth"][..., 0][got["ok"]]
    assert (deepest > -0.5).all() and (deepest <= 0).any()


def bodies(seed, pos, obj, om, W, n):
    """Solver inputs for the bodies of a case: per-object constants, prior
    poses 0.02 back, random velocities; row 0 and one more row static."""
    rng = np.random.default_rng(seed)
    dyn = np.ones((W, n), bool)
    dyn[:, 0] = False
    dyn[:, -1] = False
    return dict(
        inv_mass=om["inv_mass"][obj], inv_inertia=om["inv_inertia"][obj],
        mu_s=om["mu_s"][obj], mu_d=om["mu_d"][obj], rest=om["restitution"][obj],
        prev_pos=(pos - rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32),
        prev_rot=unit_quats(rng, (W, n)),
        v=rng.normal(size=(W, n, 3)).astype(np.float32),
        w=rng.normal(size=(W, n, 3)).astype(np.float32),
        pre_v=rng.normal(size=(W, n, 3)).astype(np.float32),
        pre_w=rng.normal(size=(W, n, 3)).astype(np.float32),
        dyn=dyn, h=np.full((W,), 1 / 240, np.float32),
        rthr=np.full((W,), 2 * 9.8 / 240, np.float32))


def solve_both(case, contacts, speculative):
    loader, (pos, rot, obj, mask), _ = CASES[case]
    W, n = obj.shape
    b = bodies(7, pos, obj, LOADERS[loader](assets), W, n)
    want_c = contacts[case][0]
    out = {}
    for name, mod, conv, done in (
            ("jax", jsolver, jnp.asarray, np.asarray),
            ("port", solver, torch.from_numpy, lambda t: t.numpy())):
        c = {k: conv(np.array(v)) for k, v in want_c.items()}
        x = {k: conv(np.ascontiguousarray(v)) for k, v in b.items()}
        p, r = conv(pos), conv(rot)
        p2, r2, lam, bias = mod.solve_positions(
            p, r, c, x["inv_mass"], x["inv_inertia"], x["mu_s"], x["prev_pos"], x["prev_rot"],
            x["dyn"], relaxation=0.7)
        v3, w3 = mod.solve_velocities(
            p2, r2, x["v"], x["w"], c, lam, x["inv_mass"], x["inv_inertia"], x["mu_d"],
            x["pre_v"], x["pre_w"], x["dyn"], x["h"], x["rthr"], rest_coef=x["rest"],
            speculative=speculative)
        out[name] = [done(t) for t in (p2, r2, lam, bias, v3, w3)]
    return out


@pytest.mark.parametrize("case", ["pile", "speculative", "boxes_on_plane"])
def test_contact_solve_matches_jax(contacts, case):
    out = solve_both(case, contacts, CASES[case][2])
    names = ("pos", "rot", "lambda_n", "bias_dpos", "v", "w")
    tols = (1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-4)
    moved = False
    for name, tol, want, got in zip(names, tols, out["jax"], out["port"]):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)
        moved |= name == "lambda_n" and bool((got > 0).any())
    assert moved, "no positional impulse in the case"


def test_ordered_sum_is_a_fixed_tree():
    """ordered_sum adds halves elementwise: the same bits for any leading
    shape, and the exact sum of small integers."""
    x = torch.randn(7, 33, 5, generator=torch.Generator().manual_seed(0))
    whole = solver.ordered_sum(x, 1)
    parts = torch.cat([solver.ordered_sum(x[:3], 1), solver.ordered_sum(x[3:], 1)])
    assert torch.equal(whole, parts)
    ints = torch.arange(33.0)[None, :, None].expand(2, 33, 3)
    assert torch.equal(solver.ordered_sum(ints, 1), torch.full((2, 3), 528.0))
