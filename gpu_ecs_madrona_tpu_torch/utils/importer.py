"""Mesh importer — .obj files into hull-ready and render-ready arrays.

The port's own copy of the JAX package's ``utils/importer.py`` (numpy
only; the port never imports the JAX package or its native extension).
Counterpart of reference src/common/importer.cpp (loadOBJ,
importer.cpp:35-409; ImportedObject::importObject:411-435).  The parse is
the pure-Python one, whose outputs equal the JAX package's Python and
native parsers array for array.  Coverage matches the reference parser:
positions, normals (vn), uvs (vt), v/vt/vn composite corners, negative
(relative) indices, multi-object files (o/g), and an attribute-dedup
indexing pass (the meshoptimizer generateVertexRemap/remapVertexBuffer
analog, importer.cpp:150-216).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from gpu_ecs_madrona_tpu_torch.physics.assets import convex_hull_from_mesh

# No native parser in the port: the Python one is the only route.
HAS_NATIVE = False


@dataclasses.dataclass
class SourceMesh:
    """reference imp::SourceMesh (importer.hpp): vertices + face loops,
    plus optional per-corner normal/uv indices (importer.cpp:120-148)."""

    vertices: np.ndarray            # [V, 3] float32
    faces: List[np.ndarray]         # position-index loops (winding kept)
    name: str = ""
    normals: Optional[np.ndarray] = None        # [N, 3] float32 (vn pool)
    uvs: Optional[np.ndarray] = None            # [T, 2] float32 (vt pool)
    face_normals: Optional[List[np.ndarray]] = None  # per-corner vn idx, -1 absent
    face_uvs: Optional[List[np.ndarray]] = None      # per-corner vt idx, -1 absent


def parse_obj_multi(data: bytes) -> List[SourceMesh]:
    """Parse every object in a .obj buffer (reference loadOBJ builds one
    SourceMesh per o/g group, importer.cpp:383-409)."""
    verts, normals, uvs, cv, cn, ct, fo, oo, names = _parse_obj_python_full(data)

    meshes: List[SourceMesh] = []
    for o in range(len(oo) - 1):
        f0, f1 = int(oo[o]), int(oo[o + 1])
        faces = [cv[fo[f]:fo[f + 1]].copy() for f in range(f0, f1)]
        fns = [cn[fo[f]:fo[f + 1]].copy() for f in range(f0, f1)]
        fts = [ct[fo[f]:fo[f + 1]].copy() for f in range(f0, f1)]
        meshes.append(SourceMesh(
            vertices=verts, faces=faces,
            name=names[o] if o < len(names) else "",
            normals=normals if len(normals) else None,
            uvs=uvs if len(uvs) else None,
            face_normals=fns, face_uvs=fts,
        ))
    return meshes


def parse_obj_bytes(data: bytes) -> SourceMesh:
    """Single-mesh view: all objects' faces merged (back-compat; the
    vertex pool is shared so merging is just face concatenation)."""
    meshes = parse_obj_multi(data)
    if not meshes:
        return SourceMesh(vertices=np.zeros((0, 3), np.float32), faces=[])
    if len(meshes) == 1:
        return meshes[0]
    first = meshes[0]
    merged = dataclasses.replace(
        first,
        faces=[f for m in meshes for f in m.faces],
        face_normals=[f for m in meshes for f in (m.face_normals or [])],
        face_uvs=[f for m in meshes for f in (m.face_uvs or [])],
        name=first.name,
    )
    return merged


def _parse_obj_python_full(data: bytes):
    """The parse: the JAX package's pure-Python mirror of its native
    parse_obj_full, line for line."""
    verts: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    cv: List[int] = []
    cn: List[int] = []
    ct: List[int] = []
    fo: List[int] = [0]
    oo: List[int] = []
    names: List[str] = []
    open_obj = False

    def begin_object(name: str):
        nonlocal open_obj
        if open_obj:
            oo.append(len(fo) - 1)
        names.append(name)
        if not oo:
            oo.append(0)
        open_obj = True

    def resolve(idx: int, count: int) -> int:
        r = idx - 1 if idx > 0 else count + idx
        return r if 0 <= r < count else -1

    for line in data.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if line.startswith("v "):
            p = line.split()
            verts.append([float(p[1]), float(p[2]), float(p[3])])
        elif line.startswith("vn "):
            p = line.split()
            normals.append([float(p[1]), float(p[2]), float(p[3])])
        elif line.startswith("vt "):
            p = line.split()
            uvs.append([float(p[1]), float(p[2]) if len(p) > 2 else 0.0])
        elif line.startswith(("o ", "g ")):
            begin_object(line[2:].strip())
        elif line.startswith("f "):
            if not open_obj:
                begin_object("")
            start = len(cv)
            for tok in line.split()[1:]:
                if tok.startswith("#"):
                    break
                parts = tok.split("/")
                try:
                    iv = int(parts[0])
                except ValueError:
                    continue
                rv = resolve(iv, len(verts))
                if rv < 0:
                    continue
                cv.append(rv)
                ct.append(resolve(int(parts[1]), len(uvs))
                          if len(parts) > 1 and parts[1] else -1)
                cn.append(resolve(int(parts[2]), len(normals))
                          if len(parts) > 2 and parts[2] else -1)
            if len(cv) - start >= 3:
                fo.append(len(cv))
            else:
                del cv[start:], cn[start:], ct[start:]
    if open_obj or names:
        oo.append(len(fo) - 1)
    else:
        oo.append(0)
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(normals, np.float32).reshape(-1, 3),
            np.asarray(uvs, np.float32).reshape(-1, 2),
            np.asarray(cv, np.int32), np.asarray(cn, np.int32),
            np.asarray(ct, np.int32), np.asarray(fo, np.int32),
            np.asarray(oo, np.int32), names)


def _parse_obj_python(data: bytes) -> SourceMesh:
    """Pure-Python single-mesh parse (back-compat; merged view)."""
    verts, normals, uvs, cv, cn, ct, fo, oo, names = (
        _parse_obj_python_full(data))
    faces = [cv[fo[f]:fo[f + 1]].copy() for f in range(len(fo) - 1)]
    return SourceMesh(vertices=verts, faces=faces,
                      normals=normals if len(normals) else None,
                      uvs=uvs if len(uvs) else None)


def index_mesh(mesh: SourceMesh) -> Tuple[np.ndarray, Optional[np.ndarray],
                                          Optional[np.ndarray], np.ndarray]:
    """Attribute-dedup indexing pass (the meshoptimizer
    generateVertexRemap analog, reference importer.cpp:150-216): unique
    (v, vn, vt) corner triples become single render vertices; faces are
    fan-triangulated (importer.cpp:220-260 does the same for >3-gons).

    Returns (positions [Vd,3], normals [Vd,3] or None, uvs [Vd,2] or None,
    tri_indices [T,3] int32).  Corners without a vn get a face normal;
    corners without a vt get (0,0).
    """
    corners = []   # (v_idx, n_idx, t_idx) per corner, faces triangulated
    tri_corner_rows = []
    face_nrm = []  # computed face normal per tri (fallback)
    fns = mesh.face_normals or [np.full(len(f), -1, np.int32)
                                for f in mesh.faces]
    fts = mesh.face_uvs or [np.full(len(f), -1, np.int32)
                            for f in mesh.faces]
    V = mesh.vertices
    for f, (loop, nloop, tloop) in enumerate(zip(mesh.faces, fns, fts)):
        p0, p1, p2 = V[loop[0]], V[loop[1]], V[loop[2]]
        n = np.cross(p1 - p0, p2 - p0)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 1e-12 else np.array([0.0, 0.0, 1.0], np.float32)
        for k in range(1, len(loop) - 1):
            tri = []
            for c in (0, k, k + 1):
                corners.append((int(loop[c]), int(nloop[c]), int(tloop[c])))
                tri.append(len(corners) - 1)
                face_nrm.append(n)
            tri_corner_rows.append(tri)
    if not corners:
        return (np.zeros((0, 3), np.float32), None, None,
                np.zeros((0, 3), np.int32))

    triples = np.asarray(corners, np.int64)
    # corners lacking vn fall back to a per-face normal: make their dedup
    # key unique per (vertex, face normal) by keying on the corner row for
    # missing attributes of distinct normals
    keys = triples.copy()
    fnrm = np.asarray(face_nrm, np.float32)
    missing_n = keys[:, 1] < 0
    if missing_n.any():
        # quantized face normal as the dedup key for missing vn
        qn = np.round(fnrm * 8192.0).astype(np.int64)
        packed = (qn[:, 0] + (1 << 20)) * (1 << 42) + \
                 (qn[:, 1] + (1 << 20)) * (1 << 21) + (qn[:, 2] + (1 << 20))
        keys[missing_n, 1] = -2 - (packed[missing_n] % (1 << 60))
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # first corner row for each unique key
    first_row = np.full(len(uniq), -1, np.int64)
    for row, u in enumerate(inverse):
        if first_row[u] < 0:
            first_row[u] = row

    positions = V[triples[first_row, 0]].astype(np.float32)
    has_any_n = mesh.normals is not None or missing_n.any()
    normals_out = None
    if has_any_n:
        normals_out = np.empty((len(uniq), 3), np.float32)
        for u, row in enumerate(first_row):
            ni = triples[row, 1]
            if ni >= 0 and mesh.normals is not None:
                normals_out[u] = mesh.normals[ni]
            else:
                normals_out[u] = fnrm[row]
    uvs_out = None
    if mesh.uvs is not None:
        uvs_out = np.zeros((len(uniq), 2), np.float32)
        for u, row in enumerate(first_row):
            ti = triples[row, 2]
            if ti >= 0:
                uvs_out[u] = mesh.uvs[ti]
    tris = np.asarray([[inverse[c] for c in tri] for tri in tri_corner_rows],
                      np.int32)
    return positions, normals_out, uvs_out, tris


def load_obj(path: str) -> SourceMesh:
    """reference loadOBJ (importer.cpp:35): single merged mesh view."""
    with open(path, "rb") as f:
        return parse_obj_bytes(f.read())


def load_objs(path: str) -> List[SourceMesh]:
    """All objects in the file (reference ImportedObject::importObject,
    importer.cpp:411-435, keeps one SourceMesh per object)."""
    with open(path, "rb") as f:
        return parse_obj_multi(f.read())


def import_object(path: str, inv_mass=1.0, mu_s=0.5, mu_d=0.5,
                  inv_inertia=(1.0, 1.0, 1.0), restitution=0.3,
                  hull_mode: str = "validate"):
    """Load an .obj as a physics hull SourceObject (reference
    PhysicsLoader::loadHullFromDisk, physics_assets.cpp).

    hull_mode: see physics/assets.py convex_hull_from_mesh — "validate"
    (default) rejects non-convex input with a ValueError, "quickhull"
    replaces the mesh with its convex hull, "trust" skips the check.
    """
    mesh = load_obj(path)
    return convex_hull_from_mesh(mesh.vertices, mesh.faces, inv_mass=inv_mass,
                                 mu_s=mu_s, mu_d=mu_d, inv_inertia=inv_inertia,
                                 restitution=restitution, hull_mode=hull_mode)
