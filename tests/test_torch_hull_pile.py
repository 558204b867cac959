"""The imported-hull pile of the port against the JAX package (CPU).

The scene is tests/test_torch_hull_scenes.py's: rigid_bench with object 0
the hexagonal prism read from an .obj file by each package's importer,
here 4 worlds x 8 bodies (prisms and spheres) dropped close together, so
that prisms meet prisms, spheres and the plane.  The port's fused-kernel
mode (``contact_mode="pallas"``, its plain version on the CPU) is held to
JAX's ``"pairs"`` mode, the reference JAX's own tests hold its kernel to
(tests/test_torch_physics.py's notes), from one JAX-initialised state:

  - the broadphase: candidate rows, masks, counts and overflow exact,
    AABBs atol 1e-5;
  - one step: positions, rotations and pose stashes atol 1e-4, velocities
    atol 1e-3;
  - ten steps: test_torch_physics_world.py's multi-step gates (rtol 1e-4,
    atol 8e-2 on positions), with the measured deviation much smaller.

Also: the kernel's limits take these tables and refuse, by name, tables
over its caps; contact_mode "auto" at 65 rows takes the fused node with
them.  One JAX executor serves both comparisons (one compile, module
fixture).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import RigidBodyPhysicsSystem as JPhysics
from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.utils import importer as jimporter

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem, assets
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk
from gpu_ecs_madrona_tpu_torch.utils import importer

import test_torch_hull_scenes as hs

PILE = dict(num_worlds=4, num_bodies=8, spawn_xy=1.5, spawn_h=4.0, seed=0)
BODY = "RigidBenchBody"
STEPS = 10


def to_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


def jax_world(**over):
    om = hs.hull_object_manager(jassets, jimporter)
    return hs.hull_world(jrb, om).with_config(jrb.RigidBenchConfig(**{**PILE, **over}))


def port_world(**over):
    om = hs.hull_object_manager(assets, importer)
    return hs.hull_world(rb, om).with_config(rb.RigidBenchConfig(**{**PILE, **over}))


def executors(jworld, pworld):
    n = PILE["num_bodies"] + 8
    return (JTaskGraphExecutor(jworld, JExecutorConfig(num_worlds=PILE["num_worlds"],
                                                       max_entities_per_world=n, seed=0,
                                                       donate=False)),
            TaskGraphExecutor(pworld, ExecutorConfig(num_worlds=PILE["num_worlds"],
                                                     max_entities_per_world=n, seed=0,
                                                     device="cpu")))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's pairs-mode hull pile: its initial state, after one step and
    after STEPS steps, from one executor (one compile)."""
    sim = executors(jax_world(contact_mode="pairs"), port_world())[0]
    out = {0: to_np(sim.state)}
    sim.step()
    out[1] = to_np(sim.state)
    sim.run(STEPS - 1)
    out[STEPS] = to_np(sim.state)
    return out


def body_err(a, b, comp):
    ca, cb = a["arch"][BODY]["comps"][comp], b["arch"][BODY]["comps"][comp]
    return {f: float(np.abs(ca[f] - cb[f]).max()) for f in ca}


def port_run(state, steps):
    psim = executors(jax_world(), port_world(contact_mode="pallas"))[1]
    psim.state = state_from_numpy(state, "cpu")
    sk.FusedSubstepKernel.launches = 0
    psim.run(steps)
    assert sk.FusedSubstepKernel.launches == 0       # CPU: the plain version
    assert "physics_substeps_fused" in psim.graph.node_names
    return state_to_numpy(psim.state)


def test_hull_tables_are_general():
    tables = pk.ObjTables(port_world().objmgr)
    assert not tables.all_box
    assert tables.hull_dims() == (696, 8, 4, 4, 6, 18)
    t = tables.hull_table("cpu")
    assert tuple(t.shape) == (3, 696) and tables.hull_table("cpu") is t
    # the prism's counts lead its row; its first face is the bottom hexagon
    assert t[0, :4].tolist() == [8.0, 4.0, 4.0, 18.0]
    np.testing.assert_allclose(t[0, 4:8].numpy(), [0.0, 0.0, -1.0, 0.5], atol=1e-6)
    assert tables.kernel_table("cpu").shape[1] == 20 + 3 * tables.Vm


def test_broadphase_matches_jax(jax_run):
    class JBp(jax_world()):
        @classmethod
        def setup_tasks(cls, builder):
            JPhysics.setup_broadphase_tasks(builder, [], jrb.Body, cls.objmgr,
                                            dense_degree=cls.config.dense_degree)

    class PBp(port_world()):
        @classmethod
        def setup_tasks(cls, builder):
            RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], rb.Body, cls.objmgr,
                                                          dense_degree=cls.config.dense_degree)

    jsim, psim = executors(JBp, PBp)
    jsim.state = jax.tree_util.tree_map(jnp.asarray, jax_run[1])
    psim.state = state_from_numpy(jax_run[1], "cpu")
    jsim.step()
    psim.step()
    a, b = to_np(jsim.state), state_to_numpy(psim.state)
    assert a["arch"]["CandidateRowsTemporary"]["mask"].sum() > 0
    for name in ("CandidateTemporary", "CandidateRowsTemporary"):
        np.testing.assert_array_equal(a["arch"][name]["mask"], b["arch"][name]["mask"])
        for comp, fields in a["arch"][name]["comps"].items():
            for f, v in fields.items():
                np.testing.assert_array_equal(v, b["arch"][name]["comps"][comp][f],
                                              err_msg=f"{name}.{comp}.{f}")
    for name in a["overflow"]:
        np.testing.assert_array_equal(a["overflow"][name], b["overflow"][name])
    assert max(body_err(a, b, "CollisionAABB").values()) <= 1e-5


def test_one_step_matches_jax_pairs(jax_run):
    want, got = jax_run[1], port_run(jax_run[0], 1)
    for comp, atol in (("Position", 1e-4), ("Rotation", 1e-4), ("SubstepPrevState", 1e-4),
                       ("PreSolvePositional", 1e-4), ("Velocity", 1e-3),
                       ("PreSolveVelocity", 1e-3), ("CollisionAABB", 1e-5)):
        err = body_err(want, got, comp)
        assert max(err.values()) <= atol, (comp, err)
    for name in want["overflow"]:
        np.testing.assert_array_equal(want["overflow"][name], got["overflow"][name])
    for name in ("CandidateTemporary", "CandidateRowsTemporary", "ContactTemporary",
                 "CollisionEventTemporary"):
        assert not got["arch"][name]["mask"].any(), name


def test_ten_steps_match_jax_pairs(jax_run):
    want, got = jax_run[STEPS], port_run(jax_run[0], STEPS)
    wp = want["arch"][BODY]["comps"]["Position"]
    gp = got["arch"][BODY]["comps"]["Position"]
    (key,) = wp
    assert np.isfinite(gp[key]).all()
    np.testing.assert_allclose(gp[key], wp[key], rtol=1e-4, atol=8e-2)
    # the bodies fell and met: the pile is lower than its spawn
    assert gp[key][:, 1:, 2].max() < jax_run[0]["arch"][BODY]["comps"]["Position"][key][
        :, 1:, 2].max()


def test_kernel_fits_hull_tables_and_refuses_over_the_caps():
    """The kernel takes the prism's tables at the main path's shapes with
    every option, and any table PhysicsLoader() builds at its defaults;
    over a cap it refuses by name."""
    tables = pk.ObjTables(port_world().objmgr)
    for K in (256, 128):
        for bp, cache in ((False, False), (True, True), (False, True), (True, False)):
            assert sk.kernel_fits(tables, 65, K, bp, cache) == ""
    assert sk.kernel_fits(tables, 104, 1000, single=True, joints=64) == ""
    # PhysicsLoader()'s defaults, filled: 32 verts, 32 faces, 16 edge
    # directions, 8 corners a face, 48 full edges (an untrimmed table)
    om = dict(port_world().objmgr)
    full = {"verts": 32, "face_normals": 32, "sat_axes": 32, "edge_dirs": 16, "edge_p0": 48}
    assert sk.kernel_fits(pk.ObjTables(_widen(om, full, fvm=8)), 65, 256) == ""
    for key, cap, what in (("verts", 33, "verts"), ("face_normals", 33, "faces"),
                           ("edge_dirs", 17, "edge directions"), ("edge_p0", 49, "full edges")):
        why = sk.kernel_fits(pk.ObjTables(_widen(om, {key: cap})), 65, 256)
        assert why.startswith("general-hull tables with") and what in why, why
    why = sk.kernel_fits(pk.ObjTables(_widen(om, {}, fvm=9)), 65, 256)
    assert "verts per face" in why and "> 8" in why


def _widen(om, rows, fvm=None):
    """om with the row axis of each table group in ``rows`` padded to the
    given count (zeros: padded rows, masked by the counts), and the face
    corner axis to ``fvm``."""
    groups = {"verts": ("verts",),
              "face_normals": ("face_normals", "face_d", "face_verts", "face_verts_next",
                               "face_side_n", "face_side_d", "face_slot_valid"),
              "sat_axes": ("sat_axes",), "edge_dirs": ("edge_dirs",),
              "edge_p0": ("edge_p0", "edge_p1")}
    out = dict(om)
    for group, count in rows.items():
        for k in groups[group]:
            a = out[k]
            pad = [(0, 0)] * a.ndim
            pad[1] = (0, count - a.shape[1])
            out[k] = np.pad(a, pad)
    if fvm is not None:
        for k in ("face_verts", "face_verts_next", "face_side_n", "face_side_d",
                  "face_slot_valid"):
            a = out[k]
            pad = [(0, 0)] * a.ndim
            pad[2] = (0, fvm - a.shape[2])
            out[k] = np.pad(a, pad)
    return out


def test_auto_mode_takes_the_fused_node_with_hulls():
    """At 65 body rows "auto" is the fused kernel's node with the prism's
    tables too (on the card: the general-hull specialisation)."""
    sim = TaskGraphExecutor(port_world(num_worlds=1, num_bodies=64, contact_mode="auto"),
                            ExecutorConfig(num_worlds=1, max_entities_per_world=72, seed=0,
                                           device="cpu"))
    assert "physics_substeps_fused" in sim.graph.node_names


def test_hull_settled_configuration_is_the_settled_pile_with_prisms():
    assert hs.HULL_SETTLED == dict(hs.HULL_PILE, **rb.SETTLED_PILE)
    assert hs.HULL_SETTLED["body_mix"] == "boxes" and hs.HULL_PILE["num_worlds"] == 8192
    om = port_world().objmgr
    assert int(om["prim_type"][rb.OBJ_BOX]) == assets.PRIM_HULL
    assert int(om["num_verts"][rb.OBJ_BOX]) == 12
