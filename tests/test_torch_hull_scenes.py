"""Scenes of imported convex hulls (numpy and the port's modules only; the
scenes, no tests): shared by tests/test_torch_importer.py,
test_torch_hull_pile.py, test_torch_cuda.py and chip_smoke.py.

  - prism_obj: the .obj text of a hexagonal prism (a regular hexagon of
    circumradius 0.5 at z = +-0.5; 12 verts, 8 faces wound outward), or of
    a prism of ``sides`` sides (LARGE_SIDES: a 24-sided prism of 48 verts,
    24-vertex caps and 72 full edges, past PhysicsLoader()'s defaults).
  - hull_objects: [the prism imported from a temporary .obj file, rigid_bench's
    sphere 0.5, its plane], from either package's ``assets`` and
    ``importer`` modules; hull_object_manager packs them with
    PhysicsLoader() at its defaults.
  - hull_world: rigid_bench's World class of either package with that
    object manager as its ``objmgr`` class attribute (object 0, the box,
    becomes the prism); hull_pile the port's executor of it.
  - HULL_PILE / HULL_SETTLED: the main path's configurations (rigid_bench
    at main_rigid's width; the settled pile's options with prisms).
  - large_hull_object_manager / large_hull_pile: the same with the 24-sided
    prism for object 0, packed by a PhysicsLoader with its caps raised to
    take it (LARGE_LOADER).
  - padded_verts: an object manager with its vert axis padded (an all-box
    table wider than a box's 8 verts a hull, as a merged object manager
    may be); live_vert_box: one with its first box carrying up to 20 real
    verts (the corners, then edge midpoints).
"""

import math
import os
import tempfile

import numpy as np

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL

PRISM_RADIUS = 0.5
PRISM_HALF_HEIGHT = 0.5
# the large hull: a 24-sided prism, and the PhysicsLoader caps that take it
# (its 48 verts, 24 corners a cap and 72 full edges are past the defaults'
# 32, 8 and 48)
LARGE_SIDES = 24
LARGE_LOADER = dict(max_verts=64, max_face_verts=24, max_full_edges=96)


def prism_obj(radius=PRISM_RADIUS, half=PRISM_HALF_HEIGHT, sides=6) -> str:
    """A prism of ``sides`` sides (a hexagonal one by default) as .obj text:
    verts 1..sides the bottom polygon (counter-clockwise seen from above),
    the next ``sides`` the top one; the bottom face, the top face and the
    side quads, each wound counter-clockwise seen from outside."""
    lines = ["# hexagonal prism" if sides == 6 else f"# prism of {sides} sides", "o prism"]
    for z in (-half, half):
        for k in range(sides):
            a = 2.0 * math.pi / sides * k
            lines.append(f"v {radius * math.cos(a)!r} {radius * math.sin(a)!r} {z!r}")
    lines.append("f " + " ".join(str(k) for k in range(sides, 0, -1)))
    lines.append("f " + " ".join(str(sides + k) for k in range(1, sides + 1)))
    for k in range(sides):
        b0, b1 = k + 1, (k + 1) % sides + 1
        lines.append(f"f {b0} {b1} {b1 + sides} {b0 + sides}")
    return "\n".join(lines) + "\n"


def write_prism(directory, sides=6) -> str:
    """prism_obj(sides=sides) written to ``directory``/prism.obj; returns
    the path."""
    path = os.path.join(directory, "prism.obj")
    with open(path, "w") as f:
        f.write(prism_obj(sides=sides))
    return path


def hull_objects(assets, importer, sides=6):
    """[the imported prism, sphere 0.5, plane] with rigid_bench's materials,
    from a package's physics ``assets`` and ``utils.importer`` modules: the
    prism of ``sides`` sides written to a temporary .obj file and read back
    with ``importer.import_object(path, inv_mass=1.0, mu_s=0.6, mu_d=0.4)``."""
    with tempfile.TemporaryDirectory() as d:
        prism = importer.import_object(write_prism(d, sides), inv_mass=1.0, mu_s=0.6, mu_d=0.4)
    return [prism, assets.make_sphere(0.5, inv_mass=1.0, mu_s=0.6, mu_d=0.4),
            assets.make_plane(mu_s=0.8, mu_d=0.6)]


def hull_object_manager(assets, importer):
    """hull_objects packed by PhysicsLoader() at its defaults."""
    return assets.PhysicsLoader().load_objects(hull_objects(assets, importer)) \
        .get_object_manager()


def large_hull_object_manager(assets, importer):
    """hull_objects with the 24-sided prism, packed by PhysicsLoader with
    its caps raised to LARGE_LOADER."""
    return assets.PhysicsLoader(**LARGE_LOADER).load_objects(
        hull_objects(assets, importer, LARGE_SIDES)).get_object_manager()


def padded_verts(om, vm):
    """om with its vert axis padded to vm verts a hull (zero verts past each
    row's count)."""
    om = dict(om)
    om["verts"] = np.pad(om["verts"], ((0, 0), (0, vm - om["verts"].shape[1]), (0, 0)))
    return om


def live_vert_box(om, live):
    """om (an all-box table) with its first box carrying ``live`` real verts
    (8 < live <= 20): its 8 corners, then the midpoints of live - 8 of its
    12 edges, the 4 vertical ones first, then those along x and along y (on
    its surface, so the hull is the same box); the vert axis padded to live
    rounded up to 8."""
    om = padded_verts(om, -(-live // 8) * 8)
    o = int(np.flatnonzero(om["prim_type"] == PRIM_HULL)[0])
    hx, hy, hz = om["box_half"][o]
    corners = [(sx, sy) for sx in (-1, 1) for sy in (-1, 1)]
    mids = ([(sx * hx, sy * hy, 0.0) for sx, sy in corners]
            + [(0.0, sy * hy, sz * hz) for sy, sz in corners]
            + [(sx * hx, 0.0, sz * hz) for sx, sz in corners])
    om["verts"] = om["verts"].copy()
    om["verts"][o, 8:live] = mids[:live - 8]
    om["num_verts"] = om["num_verts"].copy()
    om["num_verts"][o] = live
    return om


def hull_world(bench, om):
    """rigid_bench's World class of module ``bench`` (either package's
    models/rigid_bench.py) with object manager ``om``; its ``with_config``
    keeps it."""
    return type("HullPileWorld", (bench.RigidBenchWorld,), {"objmgr": om})


# the main path (8192 worlds x 64 bodies + a plane, K = 256, prisms and
# spheres), and the settled pile's options with prisms for boxes
HULL_PILE = dict(num_worlds=8192, num_bodies=64, contact_mode="pallas")
HULL_SETTLED = dict(HULL_PILE, **rb.SETTLED_PILE)


def hull_pile(cfg, device="cpu", large=False):
    """The port's rigid_bench executor of configuration ``cfg`` with the
    imported prism (with ``large`` the 24-sided one) as object 0, on
    ``device``."""
    from gpu_ecs_madrona_tpu_torch.physics import assets
    from gpu_ecs_madrona_tpu_torch.utils import importer
    make = large_hull_object_manager if large else hull_object_manager
    World = hull_world(rb, make(assets, importer)).with_config(cfg)
    return TaskGraphExecutor(World, ExecutorConfig(
        num_worlds=cfg.num_worlds, max_entities_per_world=cfg.num_bodies + 8, seed=cfg.seed,
        device=device))


def prism_object():
    """The imported prism alone (the port's importer), e.g. as the joint
    scene's body (tests/test_torch_joint_scenes.py joint_world's ``body``)."""
    from gpu_ecs_madrona_tpu_torch.physics import assets
    from gpu_ecs_madrona_tpu_torch.utils import importer
    return hull_objects(assets, importer)[0]


def stack_prisms(sim, per_column=4):
    """Executor ``sim`` (a hull pile of prisms only, body_mix "boxes") with
    its dynamic bodies put in upright columns of ``per_column`` prisms
    resting face on face (z = 0.5, 1.5, ...), the columns on a grid 2
    apart, at rest: a state where the prism pairs are face-face contacts
    at rest, with parallel faces and parallel edge directions (the SAT's
    ties and the 1e-6 cut of near-parallel edges)."""
    import torch
    from gpu_ecs_madrona_tpu_torch.core import base
    from gpu_ecs_madrona_tpu_torch.physics import components as comp
    pos = sim.mgr.column(sim.state, rb.Body, base.Position).clone()
    dev, n = pos.device, pos.shape[1] - 1
    idx = torch.arange(n, device=dev)
    column, level = idx // per_column, idx % per_column
    side = math.ceil(math.sqrt(-(-n // per_column)))
    centre = (side - 1) / 2.0
    pos[:, 1:] = torch.stack([((column % side).float() - centre) * 2.0,
                              ((column // side).float() - centre) * 2.0,
                              0.5 + level.float()], -1)
    rot = sim.mgr.column(sim.state, rb.Body, base.Rotation).clone()
    rot[:, 1:] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    vel = sim.mgr.column(sim.state, rb.Body, comp.Velocity)
    state = sim.mgr.set_column(sim.state, rb.Body, base.Position, pos)
    state = sim.mgr.set_column(state, rb.Body, base.Rotation, rot)
    sim.state = sim.mgr.set_column(state, rb.Body, comp.Velocity,
                                   {k: torch.zeros_like(v) for k, v in vel.items()})
    return sim
