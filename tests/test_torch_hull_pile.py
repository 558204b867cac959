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

Also: the kernel's limits take these tables, larger ones (the 24-sided
prism, counts past PhysicsLoader()'s defaults) and refuse, by name, tables
whose staged hull rows pass the shared-memory budget; contact_mode "auto"
at 65 rows takes the fused node with them.  One JAX executor serves both comparisons (one compile, module
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


# kernel_fits' cases: tables and the shape they are asked at, the main path's
# 65 rows at K = 256 unless given; True where the kernel takes them
FIT_CASES = {
    # the prism at the main path's shapes with every option, kernel 5's
    "prism": dict(),
    # PhysicsLoader()'s defaults filled (an untrimmed table): 32 verts, 32
    # faces, 16 edge directions, 8 corners a face, 48 full edges
    "loader_defaults_filled": dict(rows={"verts": 32, "face_normals": 32, "sat_axes": 32,
                                         "edge_dirs": 16, "edge_p0": 48}, fvm=8),
    # each count past those defaults (which the kernels refused before
    # their hull rows were staged in shared memory)
    "past_the_defaults": dict(rows={"verts": 33, "face_normals": 33, "edge_dirs": 17,
                                    "edge_p0": 49}, fvm=9),
    # the 24-sided prism (48 verts, 24-vertex caps, 72 full edges)
    "large_prism": dict(large=True),
    # rows whose staged data passes the budget the kernel's shared memory
    # leaves them: refused with the in-kernel broadphase, taken with the
    # bodies in the scratch otherwise
    "over_the_budget": dict(rows={"verts": 600}, fits=False),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_kernel_fits_hull_tables_and_refuses_over_the_caps(case):
    """The kernels take any general-hull table whose staged rows fit the
    shared memory beside the rest of the kernel (the prism's at the main
    path's shapes with every option and kernel 5's, the defaults filled,
    counts past them, the 24-sided prism).  A table over that budget is
    refused by name where the kernel keeps its rows in shared memory, with
    the in-kernel broadphase, saying which budget broke; without it the
    fused kernel and kernel 5 take it with the bodies and the hull rows in
    the global scratch (past one block's slot layout the windowed one,
    whose smallest window the bodies and the hull rows leave no room for)."""
    spec = FIT_CASES[case]
    om = hs.large_hull_object_manager(assets, importer) if spec.get("large") else \
        dict(port_world().objmgr)
    if "rows" in spec:
        om = _widen(om, spec["rows"], fvm=spec.get("fvm"))
    tables = pk.ObjTables(om)
    assert not tables.all_box
    why = sk.kernel_fits(tables, 65, 256)
    if not spec.get("fits", True):
        bp_why = sk.kernel_fits(tables, 65, 256, bp=True)
        assert bp_why.startswith("general-hull tables staged at"), bp_why
        assert "hull-row budget" in bp_why, bp_why
        rows = sk.smem_bytes(65, 256, bp=True)
        assert rows + sk.hull_stage_bytes(tables, 65) > sk.MAX_SMEM_BYTES
        assert str(sk.hull_stage_bytes(tables, 65)) in bp_why
        assert f"over the {sk.MAX_SMEM_BYTES - rows} B of the hull-row budget" in bp_why, bp_why
        # without the broadphase: the windowed layout's smallest window does
        # not fit beside the bodies and the hull rows, so both go to the
        # scratch; kernel 5 likewise
        assert why == "" and sk.windowed(tables, 65, 256)
        assert sk.fused_window(65, 256, False, sk.hull_stage_bytes(tables, 65)) == 0
        assert sk.fused_bodies(tables, 65, 256)
        assert sk.substep_bodies(tables, 104, 1000, 64)
        assert sk.kernel_fits(tables, 104, 1000, single=True, joints=64) == ""
        # the same table at fewer rows fits the shared memory
        assert sk.kernel_fits(tables, 9, 32, bp=True) == ""
        return
    assert why == ""
    if case == "prism":
        for K in (256, 128):
            for bp, cache in ((False, False), (True, True), (False, True), (True, False)):
                assert sk.kernel_fits(tables, 65, K, bp, cache) == ""
        assert sk.kernel_fits(tables, 104, 1000, single=True, joints=64) == ""


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
