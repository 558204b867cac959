"""Scenes of imported convex hulls (numpy and the port's modules only; the
scenes, no tests): shared by tests/test_torch_importer.py,
test_torch_hull_pile.py, test_torch_cuda.py and chip_smoke.py.

  - prism_obj: the .obj text of a hexagonal prism (a regular hexagon of
    circumradius 0.5 at z = +-0.5; 12 verts, 8 faces wound outward).
  - hull_objects: [the prism imported from a temporary .obj file, rigid_bench's
    sphere 0.5, its plane], from either package's ``assets`` and
    ``importer`` modules; hull_object_manager packs them with
    PhysicsLoader() at its defaults.
  - hull_world: rigid_bench's World class of either package with that
    object manager as its ``objmgr`` class attribute (object 0, the box,
    becomes the prism); hull_pile the port's executor of it.
  - HULL_PILE / HULL_SETTLED: the main path's configurations (rigid_bench
    at main_rigid's width; the settled pile's options with prisms).
"""

import math
import os
import tempfile

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb

PRISM_RADIUS = 0.5
PRISM_HALF_HEIGHT = 0.5


def prism_obj(radius=PRISM_RADIUS, half=PRISM_HALF_HEIGHT) -> str:
    """A hexagonal prism as .obj text: verts 1-6 the bottom hexagon
    (counter-clockwise seen from above), 7-12 the top one; the bottom face,
    the top face and six side quads, each wound counter-clockwise seen
    from outside."""
    lines = ["# hexagonal prism", "o prism"]
    for z in (-half, half):
        for k in range(6):
            a = math.pi / 3.0 * k
            lines.append(f"v {radius * math.cos(a)!r} {radius * math.sin(a)!r} {z!r}")
    lines.append("f 6 5 4 3 2 1")
    lines.append("f 7 8 9 10 11 12")
    for k in range(6):
        b0, b1 = k + 1, (k + 1) % 6 + 1
        lines.append(f"f {b0} {b1} {b1 + 6} {b0 + 6}")
    return "\n".join(lines) + "\n"


def write_prism(directory) -> str:
    """prism_obj written to ``directory``/prism.obj; returns the path."""
    path = os.path.join(directory, "prism.obj")
    with open(path, "w") as f:
        f.write(prism_obj())
    return path


def hull_objects(assets, importer):
    """[the imported prism, sphere 0.5, plane] with rigid_bench's materials,
    from a package's physics ``assets`` and ``utils.importer`` modules: the
    prism written to a temporary .obj file and read back with
    ``importer.import_object(path, inv_mass=1.0, mu_s=0.6, mu_d=0.4)``."""
    with tempfile.TemporaryDirectory() as d:
        prism = importer.import_object(write_prism(d), inv_mass=1.0, mu_s=0.6, mu_d=0.4)
    return [prism, assets.make_sphere(0.5, inv_mass=1.0, mu_s=0.6, mu_d=0.4),
            assets.make_plane(mu_s=0.8, mu_d=0.6)]


def hull_object_manager(assets, importer):
    """hull_objects packed by PhysicsLoader() at its defaults."""
    return assets.PhysicsLoader().load_objects(hull_objects(assets, importer)) \
        .get_object_manager()


def hull_world(bench, om):
    """rigid_bench's World class of module ``bench`` (either package's
    models/rigid_bench.py) with object manager ``om``; its ``with_config``
    keeps it."""
    return type("HullPileWorld", (bench.RigidBenchWorld,), {"objmgr": om})


# the main path (8192 worlds x 64 bodies + a plane, K = 256, prisms and
# spheres), and the settled pile's options with prisms for boxes
HULL_PILE = dict(num_worlds=8192, num_bodies=64, contact_mode="pallas")
HULL_SETTLED = dict(HULL_PILE, **rb.SETTLED_PILE)


def hull_pile(cfg, device="cpu"):
    """The port's rigid_bench executor of configuration ``cfg`` with the
    imported prism as object 0, on ``device``."""
    from gpu_ecs_madrona_tpu_torch.physics import assets
    from gpu_ecs_madrona_tpu_torch.utils import importer
    World = hull_world(rb, hull_object_manager(assets, importer)).with_config(cfg)
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
