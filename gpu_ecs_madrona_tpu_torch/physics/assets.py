"""Physics assets: collision geometry + rigid-body metadata per object type.

The port's own copy of ``gpu_ecs_madrona_tpu/physics/assets.py`` (numpy
only, so the two packages build the same object manager array for array;
the port never imports the JAX package's).  Counterpart of reference
PhysicsLoader / ObjectManager (include/madrona/physics_assets.hpp,
src/physics/physics_assets.cpp) and the half-edge mesh (physics.hpp
geometry::HalfEdgeMesh):

The reference packs pointer-linked half-edge meshes into GPU buffers; the
batched pipeline needs rectangular, padded, masked arrays instead.  An
ObjectManager here is a dict of arrays over the object-type axis O:
    prim_type [O]           0=sphere, 1=hull, 2=plane (physics.hpp:245-257)
    sphere_radius [O]
    verts [O, Vmax, 3]  + num_verts [O]
    face_normals [O, Fmax, 3], face_d [O, Fmax]  + num_faces [O]
    face_vert_idx [O, Fmax, FVmax] + face_nverts [O, Fmax]
        (vertex-index loops per face, padded by repeating the last valid
         index — the analog of the reference half-edge face traversal,
         physics.hpp:76-146, needed for incident-face manifold clipping)
    edge_dirs [O, Emax, 3]  + num_edges [O]   (unique edge directions, SAT)
    edge_v0/edge_v1 [O, EFmax] + num_full_edges [O]
        (full undirected edge list as vertex indices — supporting-edge
         lookup for edge-edge contacts)
    local_aabb_lo/hi [O, 3]
    inv_mass [O], inv_inertia [O, 3], mu_s [O], mu_d [O]
      (RigidBodyMetadata, physics.hpp:247-253)

These are *constants* held by the physics systems (moved to the device
once, as small tensors: physics/pairs.py ObjTables) — the analog of the
reference's ObjectManager living in unified device memory — rather than
threaded through the state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PRIM_SPHERE = 0
PRIM_HULL = 1
PRIM_PLANE = 2


@dataclasses.dataclass
class SourceObject:
    """One registered object type (reference SourceObject/SourceMesh,
    importer.hpp)."""

    prim_type: int
    sphere_radius: float = 1.0
    verts: Optional[np.ndarray] = None          # [V, 3] convex hull vertices
    faces: Optional[List[np.ndarray]] = None    # list of vertex-index loops
    inv_mass: float = 1.0
    inv_inertia: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mu_s: float = 0.5
    mu_d: float = 0.5
    # restitution coefficient: the reference applies a hardcoded e=0.3 to
    # every contact above the 2*|g|*h threshold (physics.cpp:842-845); here
    # it is a per-object material property defaulting to the same 0.3
    # (pairs combine by average, like mu_d at physics.cpp:916)
    restitution: float = 0.3
    # set for axis-aligned box hulls (make_box): enables the analytic
    # OBB SAT fast path (Gottschalk tests, no vertex-support loops)
    box_half: Optional[Tuple[float, float, float]] = None


def make_box(half_extents=(1.0, 1.0, 1.0), inv_mass=1.0, mu_s=0.5, mu_d=0.5,
             restitution=0.3) -> SourceObject:
    """Convex box hull with analytic inverse inertia (solid cuboid)."""
    hx, hy, hz = half_extents
    verts = np.array(
        [[sx * hx, sy * hy, sz * hz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    )
    # faces as CCW loops (outward normals)
    faces = [
        np.array([1, 3, 7, 5]),  # +x
        np.array([0, 4, 6, 2]),  # -x
        np.array([2, 6, 7, 3]),  # +y
        np.array([0, 1, 5, 4]),  # -y
        np.array([4, 5, 7, 6]),  # +z
        np.array([0, 2, 3, 1]),  # -z
    ]
    if inv_mass > 0:
        m = 1.0 / inv_mass
        ix = 12.0 / (m * (4 * hy * hy + 4 * hz * hz))
        iy = 12.0 / (m * (4 * hx * hx + 4 * hz * hz))
        iz = 12.0 / (m * (4 * hx * hx + 4 * hy * hy))
        inv_inertia = (ix, iy, iz)
    else:
        inv_inertia = (0.0, 0.0, 0.0)
    return SourceObject(PRIM_HULL, verts=verts, faces=faces, inv_mass=inv_mass,
                        inv_inertia=inv_inertia, mu_s=mu_s, mu_d=mu_d,
                        restitution=restitution,
                        box_half=(float(hx), float(hy), float(hz)))


def make_sphere(radius=1.0, inv_mass=1.0, mu_s=0.5, mu_d=0.5,
                restitution=0.3) -> SourceObject:
    if inv_mass > 0:
        m = 1.0 / inv_mass
        i = 1.0 / (0.4 * m * radius * radius)
        inv_inertia = (i, i, i)
    else:
        inv_inertia = (0.0, 0.0, 0.0)
    return SourceObject(PRIM_SPHERE, sphere_radius=radius, inv_mass=inv_mass,
                        inv_inertia=inv_inertia, mu_s=mu_s, mu_d=mu_d,
                        restitution=restitution)


def make_plane(mu_s=0.5, mu_d=0.5, restitution=0.3) -> SourceObject:
    """Static z=0 ground plane in object space (normal +z), reference
    CollisionPrimitive::Plane (physics.hpp:264)."""
    return SourceObject(PRIM_PLANE, inv_mass=0.0, inv_inertia=(0, 0, 0),
                        mu_s=mu_s, mu_d=mu_d, restitution=restitution)


def merge_coplanar_faces(verts: np.ndarray, faces: List[np.ndarray],
                         angle_eps: float = 1e-5,
                         dist_eps: float = 1e-6) -> List[np.ndarray]:
    """Merge adjacent coplanar faces into single polygon loops.

    Triangulated meshes (the common .obj export) describe each flat hull
    face as a fan of triangles.  SAT and incident-face clipping need the
    true polygon: clipping against a half-face patch halves the contact
    manifold, and duplicate coplanar normals waste SAT axis tests.  The
    reference's half-edge construction has the same expectation
    (physics.hpp:76-146 operates on polygon faces).

    Greedy plane bucketing, then boundary-edge chaining per bucket
    (interior edges appear in two faces of the bucket and cancel); falls
    back to the unmerged faces for any bucket that does not chain into a
    single loop (non-convex or inconsistently wound input).  Collinear
    interior vertices of merged loops are dropped.  Asset-load time only.
    """
    verts = np.asarray(verts, np.float64)
    planes = []                     # (normal, d) per input face
    for loop in faces:
        loop = np.asarray(loop)
        p0, p1, p2 = verts[loop[0]], verts[loop[1]], verts[loop[2]]
        n = np.cross(p1 - p0, p2 - p0)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 1e-12 else np.zeros(3)
        planes.append((n, float(np.dot(n, p0))))

    groups: List[List[int]] = []
    for i, (n, d) in enumerate(planes):
        for g in groups:
            gn, gd = planes[g[0]]
            if np.dot(n, gn) > 1.0 - angle_eps and abs(d - gd) < dist_eps:
                g.append(i)
                break
        else:
            groups.append([i])

    def chain(group: List[int]):
        # directed boundary edges = edges whose reverse is absent in group
        directed = []
        for fi in group:
            loop = list(faces[fi])
            for a, b in zip(loop, loop[1:] + loop[:1]):
                directed.append((int(a), int(b)))
        dirset = set(directed)
        boundary = [(a, b) for (a, b) in directed if (b, a) not in dirset]
        if not boundary:
            return None
        nxt = {}
        for a, b in boundary:
            if a in nxt:            # non-manifold boundary
                return None
            nxt[a] = b
        start = boundary[0][0]
        loop, cur = [start], nxt[start]
        while cur != start:
            if cur in (set(loop)) or cur not in nxt:
                return None
            loop.append(cur)
            cur = nxt[cur]
        if len(loop) != len(boundary):
            return None             # multiple loops (holes)
        # drop collinear interior vertices
        out = []
        nloop = len(loop)
        for k in range(nloop):
            a = verts[loop[(k - 1) % nloop]]
            b = verts[loop[k]]
            c = verts[loop[(k + 1) % nloop]]
            if np.linalg.norm(np.cross(b - a, c - b)) > 1e-10:
                out.append(loop[k])
        return np.asarray(out if len(out) >= 3 else loop)

    merged: List[np.ndarray] = []
    for g in groups:
        if len(g) == 1:
            merged.append(np.asarray(faces[g[0]]))
            continue
        loop = chain(g)
        if loop is None:
            merged.extend(np.asarray(faces[fi]) for fi in g)
        else:
            merged.append(loop)
    return merged


def is_convex_mesh(verts: np.ndarray, faces: List[np.ndarray],
                   tol: float = 1e-4) -> bool:
    """True iff every face plane has ALL vertices on one side (winding-
    agnostic: real .obj files often mix face winding, and the SAT pipeline
    dedups axes up to sign anyway).  The validation the reference's
    hull-consuming PhysicsLoader (physics_assets.cpp) leaves implicit."""
    verts = np.asarray(verts, np.float64)
    scale = max(1.0, float(np.abs(verts).max(initial=0.0)))
    for loop in faces:
        loop = np.asarray(loop)
        p0, p1, p2 = verts[loop[0]], verts[loop[1]], verts[loop[2]]
        n = np.cross(p1 - p0, p2 - p0)
        ln = np.linalg.norm(n)
        if ln < 1e-12:
            continue
        n = n / ln
        s = (verts - p0) @ n
        if (s > tol * scale).any() and (s < -tol * scale).any():
            return False
    return True


def quickhull(points: np.ndarray, tol: float = 1e-9):
    """3D quickhull: convex hull of a point cloud.

    Returns (hull_verts [V,3] float32, faces: list of CCW triangle index
    arrays into hull_verts).  From-scratch replacement for the convex-hull
    construction a from-scratch framework needs where the reference simply
    assumes pre-hulled assets (physics_assets.cpp consumes hulls as-is).
    """
    pts = np.asarray(points, np.float64)
    npts = len(pts)
    if npts < 4:
        raise ValueError("quickhull needs >= 4 points")
    scale = max(1.0, float(np.abs(pts).max()))
    eps = tol * scale + 1e-12

    # initial simplex: extremes along x, then farthest point / line / plane
    i0 = int(np.argmin(pts[:, 0]))
    i1 = int(np.argmax(pts[:, 0]))
    if i0 == i1:
        raise ValueError("degenerate point cloud (all x equal)")
    d = pts[i1] - pts[i0]
    t = np.cross(d, pts - pts[i0])
    i2 = int(np.argmax(np.sum(t * t, axis=1)))
    n = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    ln = np.linalg.norm(n)
    if ln < eps:
        raise ValueError("degenerate point cloud (collinear)")
    dist = (pts - pts[i0]) @ (n / ln)
    i3 = int(np.argmax(np.abs(dist)))
    if abs(dist[i3]) < eps:
        raise ValueError("degenerate point cloud (coplanar)")
    if dist[i3] > 0:  # ensure i0,i1,i2 CCW seen from outside
        i1, i2 = i2, i1

    faces = {}   # fid -> (a, b, c)
    planes = {}  # fid -> (n_unit, d)
    next_fid = [0]

    def add_face(a, b, c):
        fid = next_fid[0]
        next_fid[0] += 1
        nn = np.cross(pts[b] - pts[a], pts[c] - pts[a])
        lnn = np.linalg.norm(nn)
        nn = nn / lnn if lnn > 1e-300 else nn
        faces[fid] = (a, b, c)
        planes[fid] = (nn, float(nn @ pts[a]))
        return fid

    for tri in ((i0, i1, i2), (i0, i2, i3), (i2, i1, i3), (i1, i0, i3)):
        add_face(*tri)

    # conflict sets: per face, outside points
    alive = np.ones(npts, bool)
    for i in (i0, i1, i2, i3):
        alive[i] = False

    def outside_of(fid, cand_idx):
        nn, dd = planes[fid]
        s = pts[cand_idx] @ nn - dd
        return cand_idx[s > eps], s[s > eps]

    conflicts = {}
    cand = np.flatnonzero(alive)
    claimed = np.zeros(npts, bool)
    for fid in list(faces):
        free = cand[~claimed[cand]]
        out, s = outside_of(fid, free)
        conflicts[fid] = list(out)
        claimed[out] = True

    work = [fid for fid in faces if conflicts.get(fid)]
    while work:
        fid = work.pop()
        if fid not in faces or not conflicts.get(fid):
            continue
        out = conflicts[fid]
        nn, dd = planes[fid]
        far = max(out, key=lambda i: pts[i] @ nn - dd)
        # visible set: BFS over faces whose plane sees `far`
        visible = set()
        stack = [fid]
        # edge -> face map for adjacency
        edge_face = {}
        for f, (a, b, c) in faces.items():
            for e in ((a, b), (b, c), (c, a)):
                edge_face[e] = f
        while stack:
            f = stack.pop()
            if f in visible or f not in faces:
                continue
            nf, df = planes[f]
            if pts[far] @ nf - df > -eps:
                visible.add(f)
                a, b, c = faces[f]
                for e in ((b, a), (c, b), (a, c)):  # neighbors share
                    nb = edge_face.get(e)
                    if nb is not None and nb not in visible:
                        stack.append(nb)
        # horizon: edges of visible faces whose neighbor is not visible
        horizon = []
        for f in visible:
            a, b, c = faces[f]
            for e in ((a, b), (b, c), (c, a)):
                nb = edge_face.get((e[1], e[0]))
                if nb is None or nb not in visible:
                    horizon.append(e)
        # orphaned conflict points of removed faces
        orphans = set()
        for f in visible:
            orphans.update(conflicts.pop(f, ()))
            del faces[f], planes[f]
        orphans.discard(far)
        # new fan from horizon to far
        new_fids = [add_face(a, b, far) for (a, b) in horizon]
        cand2 = np.fromiter(orphans, np.int64) if orphans else \
            np.zeros(0, np.int64)
        claimed2 = np.zeros(npts, bool)
        for nf in new_fids:
            free = cand2[~claimed2[cand2]]
            out2, _ = outside_of(nf, free)
            conflicts[nf] = list(out2)
            claimed2[out2] = True
            if len(out2):
                work.append(nf)

    used = sorted({i for tri in faces.values() for i in tri})
    remap = {old: new for new, old in enumerate(used)}
    hull_verts = pts[used].astype(np.float32)
    hull_faces = [np.array([remap[a], remap[b], remap[c]], np.int32)
                  for (a, b, c) in faces.values()]
    return hull_verts, hull_faces


def convex_hull_from_mesh(verts: np.ndarray, faces: List[np.ndarray],
                          inv_mass=1.0, mu_s=0.5, mu_d=0.5,
                          inv_inertia=(1.0, 1.0, 1.0),
                          restitution=0.3,
                          merge_coplanar: bool = True,
                          hull_mode: str = "validate") -> SourceObject:
    """Wrap a mesh (e.g. loaded from .obj via utils.importer) as a hull
    object (reference PhysicsLoader::loadHullFromDisk,
    physics_assets.cpp).  Coplanar triangle fans are merged into polygon
    faces by default (see merge_coplanar_faces).

    hull_mode — the convex-input contract (the reference assumes hulled
    input and would silently mis-collide otherwise):
      "validate"  (default) raise ValueError on non-convex input
      "quickhull" replace the mesh with its convex hull (from-scratch
                  quickhull; the framework-side hulling the reference
                  delegates to its asset pipeline)
      "trust"     skip the check (reference behavior)
    """
    verts = np.asarray(verts, np.float32)
    faces = [np.asarray(f) for f in faces]
    if hull_mode == "quickhull":
        verts, faces = quickhull(verts)
    elif hull_mode == "validate":
        if not is_convex_mesh(verts, faces):
            raise ValueError(
                "mesh is not convex; pass hull_mode='quickhull' to take "
                "its convex hull, or 'trust' to use it as-is (silently "
                "wrong contacts, the reference's implicit behavior)")
    elif hull_mode != "trust":
        raise ValueError(f"unknown hull_mode {hull_mode!r}")
    if merge_coplanar:
        faces = merge_coplanar_faces(verts, faces)
    return SourceObject(PRIM_HULL, verts=np.asarray(verts, np.float32),
                        faces=faces,
                        inv_mass=inv_mass, inv_inertia=tuple(inv_inertia),
                        mu_s=mu_s, mu_d=mu_d, restitution=restitution)


class PhysicsLoader:
    """Collects SourceObjects, packs the padded ObjectManager arrays
    (reference PhysicsLoader::loadObjects, physics_assets.cpp)."""

    def __init__(self, max_verts: int = 32, max_faces: int = 32, max_edges: int = 16,
                 max_face_verts: int = 8, max_full_edges: int = 48):
        self.objects: List[SourceObject] = []
        self.max_verts = max_verts
        self.max_faces = max_faces
        self.max_edges = max_edges
        self.max_face_verts = max_face_verts
        self.max_full_edges = max_full_edges

    def load_objects(self, objs: Sequence[SourceObject]) -> "PhysicsLoader":
        self.objects.extend(objs)
        return self

    def get_object_manager(self) -> Dict[str, np.ndarray]:
        """Pack into the padded array dict (all numpy; systems convert)."""
        O = max(len(self.objects), 1)
        Vm, Fm, Em = self.max_verts, self.max_faces, self.max_edges
        FVm, EFm = self.max_face_verts, self.max_full_edges
        mgr = {
            "prim_type": np.zeros(O, np.int32),
            "sphere_radius": np.ones(O, np.float32),
            "verts": np.zeros((O, Vm, 3), np.float32),
            "num_verts": np.zeros(O, np.int32),
            "face_normals": np.zeros((O, Fm, 3), np.float32),
            "face_d": np.zeros((O, Fm), np.float32),
            "num_faces": np.zeros(O, np.int32),
            "face_vert_idx": np.zeros((O, Fm, FVm), np.int32),
            "face_nverts": np.zeros((O, Fm), np.int32),
            "edge_dirs": np.zeros((O, Em, 3), np.float32),
            "num_edges": np.zeros(O, np.int32),
            # face normals deduped up to sign: SAT penetration along n and
            # -n is the same min(maxA-minB, maxB-minA), so a box tests 3
            # face axes, not 6 (the solver re-orients the winning axis)
            "sat_axes": np.zeros((O, Fm, 3), np.float32),
            "num_sat_axes": np.zeros(O, np.int32),
            "edge_v0": np.zeros((O, EFm), np.int32),
            "edge_v1": np.zeros((O, EFm), np.int32),
            "num_full_edges": np.zeros(O, np.int32),
            "local_aabb_lo": np.zeros((O, 3), np.float32),
            "local_aabb_hi": np.zeros((O, 3), np.float32),
            "box_half": np.zeros((O, 3), np.float32),
            "hull_is_box": np.zeros(O, np.int32),
            "inv_mass": np.zeros(O, np.float32),
            "inv_inertia": np.zeros((O, 3), np.float32),
            "mu_s": np.zeros(O, np.float32),
            "mu_d": np.zeros(O, np.float32),
            "restitution": np.zeros(O, np.float32),
        }
        for i, obj in enumerate(self.objects):
            mgr["prim_type"][i] = obj.prim_type
            if obj.box_half is not None:
                mgr["box_half"][i] = obj.box_half
                mgr["hull_is_box"][i] = 1
            mgr["inv_mass"][i] = obj.inv_mass
            mgr["inv_inertia"][i] = obj.inv_inertia
            mgr["mu_s"][i] = obj.mu_s
            mgr["mu_d"][i] = obj.mu_d
            mgr["restitution"][i] = obj.restitution
            if obj.prim_type == PRIM_SPHERE:
                r = obj.sphere_radius
                mgr["sphere_radius"][i] = r
                mgr["local_aabb_lo"][i] = (-r, -r, -r)
                mgr["local_aabb_hi"][i] = (r, r, r)
            elif obj.prim_type == PRIM_PLANE:
                # infinite in x/y; broadphase treats planes specially
                mgr["local_aabb_lo"][i] = (-1e8, -1e8, -1e8)
                mgr["local_aabb_hi"][i] = (1e8, 1e8, 0.0)
            else:
                v = obj.verts
                if v.shape[0] > Vm:
                    raise ValueError(
                        f"hull {i} has {v.shape[0]} verts > max_verts={Vm}"
                    )
                mgr["verts"][i, : v.shape[0]] = v
                mgr["num_verts"][i] = v.shape[0]
                mgr["local_aabb_lo"][i] = v.min(axis=0)
                mgr["local_aabb_hi"][i] = v.max(axis=0)
                centroid = v.mean(axis=0)
                nf = 0
                edge_set = []
                full_edges = []
                for loop in obj.faces:
                    p0, p1, p2 = v[loop[0]], v[loop[1]], v[loop[2]]
                    n = np.cross(p1 - p0, p2 - p0)
                    norm = np.linalg.norm(n)
                    if norm < 1e-12:
                        continue
                    n = n / norm
                    # orient outward
                    if np.dot(n, p0 - centroid) < 0:
                        n = -n
                    if nf >= Fm:
                        raise ValueError(f"hull {i} has > max_faces={Fm} faces")
                    mgr["face_normals"][i, nf] = n
                    mgr["face_d"][i, nf] = np.dot(n, p0)
                    if len(loop) > FVm:
                        raise ValueError(
                            f"hull {i} face has {len(loop)} verts > max_face_verts={FVm}")
                    # pad the loop by repeating the last valid index: padded
                    # entries duplicate a real corner, which is harmless for
                    # the masked manifold candidate set
                    padded = list(loop) + [loop[-1]] * (FVm - len(loop))
                    mgr["face_vert_idx"][i, nf] = padded
                    mgr["face_nverts"][i, nf] = len(loop)
                    nf += 1
                    for a, b in zip(loop, np.roll(loop, -1)):
                        d = v[b] - v[a]
                        dn = np.linalg.norm(d)
                        if dn < 1e-12:
                            continue
                        key = (min(int(a), int(b)), max(int(a), int(b)))
                        if key not in full_edges:
                            full_edges.append(key)
                        d = d / dn
                        # dedupe parallel directions (SAT only needs unique)
                        if not any(
                            abs(abs(np.dot(d, e)) - 1.0) < 1e-6 for e in edge_set
                        ):
                            edge_set.append(d)
                mgr["num_faces"][i] = nf
                sat = []
                for nrm in mgr["face_normals"][i, :nf]:
                    if not any(abs(abs(np.dot(nrm, s)) - 1.0) < 1e-6
                               for s in sat):
                        sat.append(nrm.copy())
                for k, s in enumerate(sat):
                    mgr["sat_axes"][i, k] = s
                mgr["num_sat_axes"][i] = len(sat)
                if len(edge_set) > Em:
                    raise ValueError(f"hull {i} has {len(edge_set)} unique edge dirs > max_edges={Em}")
                for k, d in enumerate(edge_set):
                    mgr["edge_dirs"][i, k] = d
                mgr["num_edges"][i] = len(edge_set)
                if len(full_edges) > EFm:
                    raise ValueError(
                        f"hull {i} has {len(full_edges)} edges > max_full_edges={EFm}")
                for k, (a, b) in enumerate(full_edges):
                    mgr["edge_v0"][i, k] = a
                    mgr["edge_v1"][i, k] = b
                mgr["num_full_edges"][i] = len(full_edges)
        # Derived position arrays (object-local space), precomputed here so
        # the narrowphase never gathers by vertex index on device:
        #   edge_p0/edge_p1 [O, EFm, 3] — full-edge endpoint positions
        #   face_verts     [O, Fm, FVm, 3] — face corner positions
        v_all = mgr["verts"]
        oidx = np.arange(O)[:, None]
        mgr["edge_p0"] = v_all[oidx, mgr["edge_v0"]]
        mgr["edge_p1"] = v_all[oidx, mgr["edge_v1"]]
        mgr["face_verts"] = v_all[np.arange(O)[:, None, None], mgr["face_vert_idx"]]

        # Incident-face clipping tables (reference narrowphase clips the
        # incident face against the reference face's side planes,
        # narrowphase.cpp manifold generation).  Precomputed per face edge
        # in LOCAL space so the device never walks vertex-index loops:
        #   face_verts_next [O, Fm, FVm, 3] — next vertex in the loop (wrap)
        #   face_side_n     [O, Fm, FVm, 3] — outward side-plane unit normal
        #   face_side_d     [O, Fm, FVm]    — side-plane offset (n . v0)
        #   face_slot_valid [O, Fm, FVm]    — 1.0 while slot < face_nverts
        mgr["face_verts_next"] = np.zeros_like(mgr["face_verts"])
        mgr["face_side_n"] = np.zeros_like(mgr["face_verts"])
        mgr["face_side_d"] = np.zeros(mgr["face_verts"].shape[:3], np.float32)
        mgr["face_slot_valid"] = np.zeros(
            mgr["face_verts"].shape[:3], np.float32)
        FVm_t = mgr["face_verts"].shape[2]
        for i in range(O):
            for f in range(int(mgr["num_faces"][i])):
                nv = int(mgr["face_nverts"][i, f])
                poly = mgr["face_verts"][i, f, :nv]
                n = mgr["face_normals"][i, f]
                centroid = poly.mean(axis=0)
                for e in range(nv):
                    v0, v1 = poly[e], poly[(e + 1) % nv]
                    mgr["face_verts_next"][i, f, e] = v1
                    s = np.cross(v1 - v0, n)
                    sl = np.linalg.norm(s)
                    if sl < 1e-12:
                        continue
                    s = s / sl
                    # orient outward of the face polygon regardless of the
                    # loop winding (importers are not winding-consistent)
                    if np.dot(s, v0 - centroid) < 0:
                        s = -s
                    mgr["face_side_n"][i, f, e] = s
                    mgr["face_side_d"][i, f, e] = np.dot(s, v0)
                    mgr["face_slot_valid"][i, f, e] = 1.0
                # padded vert slots repeat the last vertex (degenerate
                # edges, masked by face_slot_valid)
                for e in range(nv, FVm_t):
                    mgr["face_verts_next"][i, f, e] = poly[nv - 1]

        # Trim padded row axes to the max actually used: the pair-major
        # narrowphase computes over EVERY padded row (masked, not skipped),
        # so table width is directly proportional to VPU work per pair.
        def trim(key, count_key, axis=1, floor=1):
            hi = max(int(mgr[count_key].max()), floor)
            hi = min(hi, mgr[key].shape[axis])
            mgr[key] = np.ascontiguousarray(
                np.take(mgr[key], range(hi), axis=axis))

        # verts floor 4: the dense narrowphase picks deepest-4 manifolds
        # with a fixed top_k(…, 4) over the vert axis
        trim("verts", "num_verts", floor=4)
        trim("face_normals", "num_faces")
        trim("face_d", "num_faces")
        trim("face_vert_idx", "num_faces")
        trim("face_nverts", "num_faces")
        trim("face_verts", "num_faces")
        trim("face_verts_next", "num_faces")
        trim("face_side_n", "num_faces")
        trim("face_side_d", "num_faces")
        trim("face_slot_valid", "num_faces")
        # trim the per-face vertex-slot axis to the max loop length used
        fv_hi = max(int(mgr["face_nverts"].max()), 3)
        fv_hi = min(fv_hi, mgr["face_verts"].shape[2])
        for key in ("face_verts", "face_verts_next", "face_side_n",
                    "face_side_d", "face_slot_valid", "face_vert_idx"):
            mgr[key] = np.ascontiguousarray(
                np.take(mgr[key], range(fv_hi), axis=2))
        trim("sat_axes", "num_sat_axes")
        trim("edge_dirs", "num_edges")
        trim("edge_p0", "num_full_edges")
        trim("edge_p1", "num_full_edges")
        trim("edge_v0", "num_full_edges")
        trim("edge_v1", "num_full_edges")
        return mgr
