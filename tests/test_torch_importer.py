"""The port's importer (utils/importer.py), IOManager (utils/io.py) and
SourceMesh render meshes against the JAX package's, array for array.

The cases are those of tests/test_importer.py (cube, degenerate faces,
multi-object files, the indexing pass and its normal fallback, the
quickhull clouds, non-convex meshes rejected and hulled, import_object
into PhysicsLoader) plus the hexagonal prism of
tests/test_torch_hull_scenes.py.  The JAX package parses with its native
extension where it is built (``importer.HAS_NATIVE``) and with its Python
parser always; the port has the Python parser only: it equals that parser
always, and the native one wherever the JAX package's two agree (they
differ on a face corner that is not a number).
"""

import dataclasses

import numpy as np
import pytest

from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.render import renderer as jrenderer
from gpu_ecs_madrona_tpu.utils import importer as jimporter
from gpu_ecs_madrona_tpu.utils import io as jio
from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.render import renderer
from gpu_ecs_madrona_tpu_torch.utils import importer
from gpu_ecs_madrona_tpu_torch.utils import io as tio

import test_torch_hull_scenes as hs

CUBE_OBJ = b"""
# comment line
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
vn 0 0 1
vt 0 0
f 1/1/1 2/1/1 3/1/1 4/1/1
f 5 8 7 6
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 4 8 5 -8
"""

MULTI_OBJ = b"""
o first
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
f 1/1/1 2/2/1 3/3/1 4/1/1
o second
v 2 0 0
v 3 0 0
v 2 1 0
f 5//1 6// 7
"""

# odd input the parser must treat as the JAX one does: a two-corner face,
# an index out of range, a trailing comment, a g group, a relative normal
# index and a vt without its second coordinate
ODD_OBJ = b"""
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
vt 0.5
vn 1 0 0
f 1 2
f 1 2 9 3
g tail
f 1/1/-1 3/1/1 4 # a comment
f -4 -3 -2
"""

# a corner that is not a number: the JAX package's Python parser skips the
# corner, its native parser drops the face; the port is the Python parser
BAD_TOKEN_OBJ = b"v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x 3\n"

CASES = {"cube": CUBE_OBJ, "multi": MULTI_OBJ, "odd": ODD_OBJ,
         "degenerate": b"v 0 0 0\nv 1 0 0\nf 1 2\n", "empty": b"",
         "prism": hs.prism_obj().encode()}
PYTHON_ONLY = {"bad_token": BAD_TOKEN_OBJ}


def assert_same(a, b):
    """Equal arrays (dtype and value), lists of them, or scalars."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif a is None or isinstance(a, (str, int, float)):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def assert_mesh_same(a, b):
    for f in dataclasses.fields(jimporter.SourceMesh):
        assert_same(getattr(a, f.name), getattr(b, f.name))


def test_no_native_parser():
    assert importer.HAS_NATIVE is False


@pytest.mark.parametrize("case", sorted(CASES) + sorted(PYTHON_ONLY))
def test_parse_full_matches_jax_python_parser(case):
    data = CASES.get(case, PYTHON_ONLY.get(case))
    assert_same(list(importer._parse_obj_python_full(data)),
                list(jimporter._parse_obj_python_full(data)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_multi_matches_jax(case):
    """parse_obj_multi equals the JAX package's (its native parser where
    built) mesh for mesh."""
    mine, theirs = importer.parse_obj_multi(CASES[case]), jimporter.parse_obj_multi(CASES[case])
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert_mesh_same(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_bytes_and_python_single_match_jax(case):
    assert_mesh_same(importer.parse_obj_bytes(CASES[case]),
                     jimporter.parse_obj_bytes(CASES[case]))
    assert_mesh_same(importer._parse_obj_python(CASES[case]),
                     jimporter._parse_obj_python(CASES[case]))


@pytest.mark.skipif(not jimporter.HAS_NATIVE, reason="the JAX package's native parser is not built")
@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_matches_jax_native_parser(case):
    """The JAX package's own test_native_matches_python, with the port in
    the Python parser's place."""
    (v_b, nv, vn_b, nvn, vt_b, nvt, cv_b, cn_b, ct_b, fo_b, oo_b,
     names) = jimporter._native.parse_obj_full(CASES[case])
    native = [np.frombuffer(v_b, np.float32).reshape(nv, 3),
              np.frombuffer(vn_b, np.float32).reshape(nvn, 3),
              np.frombuffer(vt_b, np.float32).reshape(nvt, 2)]
    native += [np.frombuffer(x, np.int32) for x in (cv_b, cn_b, ct_b, fo_b, oo_b)]
    assert_same(list(importer._parse_obj_python_full(CASES[case])), native + [list(names)])


def test_parse_cube_and_degenerate_faces():
    mesh = importer.parse_obj_bytes(CUBE_OBJ)
    assert mesh.vertices.shape == (8, 3) and len(mesh.faces) == 6
    assert all(len(f) == 4 for f in mesh.faces)
    assert mesh.faces[5][-1] == 0          # -8 is vertex 0
    assert len(importer.parse_obj_bytes(CASES["degenerate"]).faces) == 0


def test_multi_object_parse():
    meshes = importer.parse_obj_multi(MULTI_OBJ)
    assert [m.name for m in meshes] == ["first", "second"]
    np.testing.assert_array_equal(meshes[1].faces[0], [4, 5, 6])
    np.testing.assert_array_equal(meshes[1].face_normals[0], [0, -1, -1])
    np.testing.assert_array_equal(meshes[0].face_uvs[0], [0, 1, 2, 0])


@pytest.mark.parametrize("case,obj", [("cube", 0), ("multi", 0), ("multi", 1), ("odd", 0),
                                      ("odd", 1), ("prism", 0)])
def test_index_mesh_matches_jax(case, obj):
    """The indexing pass (dedup of (v, vn, vt) corners, fan triangles, face
    normals where a corner has no vn) equals the JAX package's."""
    meshes = importer.parse_obj_multi(CASES[case])
    jmeshes = jimporter.parse_obj_multi(CASES[case])
    assert_same(list(importer.index_mesh(meshes[obj])), list(jimporter.index_mesh(jmeshes[obj])))


def test_index_mesh_dedup_and_normal_fallback():
    pos, nrm, uv, tris = importer.index_mesh(importer.parse_obj_multi(MULTI_OBJ)[0])
    assert tris.shape == (2, 3) and pos.shape == (4, 3) and uv.shape == (4, 2)
    np.testing.assert_array_equal(tris[0], [0, 1, 2])
    _, nrm, _, _ = importer.index_mesh(importer.parse_obj_bytes(b"v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                                                b"f 1 2 3\n"))
    np.testing.assert_allclose(nrm, np.tile([0, 0, 1.0], (3, 1)), atol=1e-6)


@pytest.mark.parametrize("cloud", ["cube", "normal"])
def test_quickhull_matches_jax(cloud):
    rng = np.random.default_rng(3 if cloud == "cube" else 11)
    if cloud == "cube":
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], np.float64)
        pts = np.vstack([corners, rng.uniform(-0.9, 0.9, (50, 3))])
    else:
        pts = rng.normal(size=(200, 3))
    hv, hf = assets.quickhull(pts)
    jv, jf = jassets.quickhull(pts)
    assert_same(hv, jv)
    assert_same(list(hf), list(jf))
    assert assets.is_convex_mesh(hv, hf)
    if cloud == "cube":
        assert hv.shape[0] == 8


def _l_prism():
    base2d = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float64)
    verts = np.vstack([np.column_stack([base2d, np.zeros(6)]),
                       np.column_stack([base2d, np.ones(6)])])
    bottom = np.array([5, 4, 3, 2, 1, 0])
    return verts, [bottom, bottom[::-1] + 6] + [
        np.array([i, (i + 1) % 6, 6 + (i + 1) % 6, 6 + i]) for i in range(6)]


def test_nonconvex_rejected_and_hulled(tmp_path):
    verts, faces = _l_prism()
    assert not assets.is_convex_mesh(verts, faces)
    with pytest.raises(ValueError, match="not convex"):
        assets.convex_hull_from_mesh(verts, faces)
    obj = assets.convex_hull_from_mesh(verts, faces, hull_mode="quickhull")
    jobj = jassets.convex_hull_from_mesh(verts, faces, hull_mode="quickhull")
    assert obj.verts.shape[0] == 10
    assert_same(obj.verts, jobj.verts)
    assert_same(list(obj.faces), list(jobj.faces))
    # the importer's route too: the .obj of the L prism, validated and hulled
    lines = [f"v {float(x)!r} {float(y)!r} {float(z)!r}" for x, y, z in verts]
    lines += ["f " + " ".join(str(int(i) + 1) for i in f) for f in faces]
    path = tmp_path / "l.obj"
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="not convex"):
        importer.import_object(str(path))
    assert importer.import_object(str(path), hull_mode="quickhull").verts.shape[0] == 10


def object_managers(tmp_path, data, **kw):
    """The port's and the JAX package's object managers of one .obj file
    imported with ``kw``."""
    p = tmp_path / "obj.obj"
    p.write_bytes(data)
    mine = assets.PhysicsLoader().load_objects([importer.import_object(str(p), **kw)])
    theirs = jassets.PhysicsLoader().load_objects([jimporter.import_object(str(p), **kw)])
    return mine.get_object_manager(), theirs.get_object_manager()


@pytest.mark.parametrize("case,kw", [("cube", {}), ("prism", dict(inv_mass=1.0, mu_s=0.6,
                                                                   mu_d=0.4)),
                                     ("prism", dict(hull_mode="quickhull", restitution=0.0))])
def test_import_object_into_physics_matches_jax(tmp_path, case, kw):
    mine, theirs = object_managers(tmp_path, CASES[case], **kw)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert_same(mine[k], theirs[k])
    assert mine["prim_type"][0] == assets.PRIM_HULL
    if case == "cube":
        assert (mine["num_verts"][0], mine["num_faces"][0], mine["num_edges"][0]) == (8, 6, 3)
        np.testing.assert_allclose(mine["local_aabb_lo"][0], [-1, -1, -1])
    else:
        # 12 verts; 2 hexagons and 6 quads; 4 SAT axes (the caps' shared
        # axis, three side pairs); 4 edge directions; 18 edges
        assert (mine["num_verts"][0], mine["num_faces"][0], mine["num_sat_axes"][0],
                mine["num_edges"][0], mine["num_full_edges"][0]) == (12, 8, 4, 4, 18)


def test_prism_object_manager_equals_jax():
    """The hull pile's object manager (tests/test_torch_hull_scenes.py):
    the prism, a sphere and the plane, packed at PhysicsLoader()'s
    defaults, array for array the JAX package's."""
    mine = hs.hull_object_manager(assets, importer)
    theirs = hs.hull_object_manager(jassets, jimporter)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert_same(mine[k], theirs[k])
    assert list(mine["prim_type"]) == [assets.PRIM_HULL, assets.PRIM_SPHERE, assets.PRIM_PLANE]
    assert mine["hull_is_box"][0] == 0


@pytest.mark.parametrize("what", ["load", "load_obj"])
def test_io_manager_matches_jax(tmp_path, what):
    """IOManager's futures: the file's bytes, or its parse through the
    importer (the JAX package's through its own)."""
    p = tmp_path / "prism.obj"
    p.write_bytes(CASES["prism"])
    mine, theirs = tio.IOManager(num_workers=2), jio.IOManager(num_workers=2)
    try:
        a, b = getattr(mine, what)(str(p)).result(), getattr(theirs, what)(str(p)).result()
    finally:
        mine.shutdown()
        theirs.shutdown()
    if what == "load":
        assert a == b == CASES["prism"]
    else:
        assert isinstance(a, importer.SourceMesh)
        assert_mesh_same(a, b)


@pytest.mark.parametrize("case", ["prism", "cube", "multi"])
def test_source_mesh_render_tables_match_jax(case):
    """A SourceMesh render mesh (fan triangles of index_mesh) gives the
    renderer's triangle tables and bounding radii of the JAX package's,
    array for array; beside a (verts, tris) mesh on another object."""
    om = hs.hull_object_manager(assets, importer)
    mesh = importer.parse_obj_bytes(CASES[case])
    jmesh = jimporter.parse_obj_bytes(CASES[case])
    tri = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), np.array([[0, 1, 2]]))
    mine = renderer.BatchRenderer(renderer.RendererConfig(backend="xla"), om,
                                  render_meshes={0: mesh, 1: tri})
    theirs = jrenderer.BatchRenderer(jrenderer.RendererConfig(backend="xla"), om,
                                     render_meshes={0: jmesh, 1: tri})
    for k in ("tri_a", "tri_e1", "tri_e2", "tri_mask", "has_mesh", "mesh_radius"):
        assert_same(mine.mesh[k], np.asarray(getattr(theirs, k)))
    n_tris = len(importer.index_mesh(mesh)[3])
    assert mine.mesh["tri_mask"][0].sum() == n_tris and mine.mesh["has_mesh"][:2].all()


def test_source_mesh_over_max_tris_is_refused():
    mesh = importer.parse_obj_bytes(CASES["prism"])        # 20 fan triangles
    om = hs.hull_object_manager(assets, importer)
    with pytest.raises(ValueError, match="max_tris"):
        renderer.BatchRenderer(renderer.RendererConfig(backend="xla", max_tris=19), om,
                               render_meshes={0: mesh})
