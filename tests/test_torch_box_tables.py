"""All-box tables wider than a box's 8 verts a hull, in the port against
the JAX package (CPU).

Such a table is a hand-built or merged object manager whose vert axis is
wider than a box's 8.  The box paths keep box-box and sphere-box analytic
on the half extents; the hull-plane path takes every live vertex of the
row as a candidate (pairs.py's max(Vm, 12)), the deepest 4 kept in
(depth, index) order, which the kernels merge as they read the verts at
the table's stride.  Here:

  - pair_contacts on tables padded to 9 and 32 verts, and on a box row
    with 12 or 20 real verts (its 8 corners and the midpoints of 4 or all
    12 of its edges), against JAX's: ok and num_points exact, the rest atol
    1e-5 (tests/test_torch_physics_contacts.py's gates);
  - a kernel-mode step (the fused kernel's plain version here) of a pile
    of boxes on the padded tables: bit for bit the step on the box table,
    and against JAX's pairs mode on the same padded tables (poses atol
    1e-4, velocities 1e-3, AABBs 1e-5).
"""

import jax
import numpy as np
import pytest

from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk

import test_torch_physics_contacts as contacts
from test_torch_hull_scenes import live_vert_box, padded_verts as padded

PILE = dict(num_worlds=2, num_bodies=24, num_substeps=2, body_mix="boxes", spawn_xy=2.0,
            spawn_h=3.0, seed=4, contact_mode="pallas", max_candidates=128)
BODY = "RigidBenchBody"


def twelve_vert_box(om):
    """om (an all-box table) with its first box carrying 12 real verts: its
    8 corners, then the midpoints of its 4 vertical edges."""
    return live_vert_box(om, 12)


def assert_contacts_match(om, cases):
    pos, rot, obj = cases
    a, b = contacts.contacts_both(om, pos, rot, obj)
    np.testing.assert_array_equal(a["ok"], b["ok"])
    np.testing.assert_array_equal(a["num_points"], b["num_points"])
    for k in ("normal", "points", "depth"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=0, err_msg=k)
    return a, b


def contact_cases(which, om):
    return contacts.clip_cases() if which == "clip" else contacts.random_cases(
        objects=om["prim_type"].shape[0])


@pytest.mark.parametrize("which", ["clip", "random"])
@pytest.mark.parametrize("vm", [9, 32])
def test_pair_contacts_on_padded_box_tables_match_jax(vm, which):
    om = contacts._box_om([(0.5, 0.5, 0.5), (0.2, 0.2, 0.5), (1.0, 1.0, 0.5)], True)
    wide = padded(om, vm)
    assert sk.pk.ObjTables(wide).all_box and sk.pk.ObjTables(wide).Vm == vm
    a, b = assert_contacts_match(wide, contact_cases(which, wide))
    assert a["ok"].sum() >= (6 if which == "clip" else 40)
    # the padding changes nothing: the box table's own contacts
    _, own = contacts.contacts_both(om, *contact_cases(which, om))
    for k in b:
        np.testing.assert_array_equal(b[k], own[k], err_msg=k)


@pytest.mark.parametrize("which", ["clip", "random"])
def test_pair_contacts_on_a_twelve_vert_box_match_jax(which):
    om = twelve_vert_box(contacts._box_om([(0.5, 0.5, 0.5), (0.2, 0.2, 0.5),
                                           (1.0, 1.0, 0.5)], True))
    tables = sk.pk.ObjTables(om)
    assert tables.all_box and tables.Vm == 16 and int(om["num_verts"][0]) == 12
    assert sk.kernel_fits(tables, 65, 256) == ""
    a, _ = assert_contacts_match(om, contact_cases(which, om))
    # box 0 (12 candidates) meets the plane (object 4) in some pair
    pos, rot, obj = contact_cases(which, om)
    K = obj.shape[1] // 2
    assert ((obj[:, :K] == 0) & (obj[:, K:] == 4) & a["ok"]).any()


@pytest.mark.parametrize("which", ["clip", "random"])
def test_pair_contacts_on_a_twenty_vert_box_match_jax(which):
    """Past 12 live verts: more live hull-plane candidates than pairs.py's
    12 floor, every one a candidate."""
    om = live_vert_box(contacts._box_om([(0.5, 0.5, 0.5), (0.2, 0.2, 0.5),
                                         (1.0, 1.0, 0.5)], True), 20)
    tables = sk.pk.ObjTables(om)
    assert tables.all_box and tables.Vm == 24 and int(om["num_verts"][0]) == 20
    assert sk.wide_box(tables) and sk.kernel_fits(tables, 65, 256) == ""
    a, _ = assert_contacts_match(om, contact_cases(which, om))
    pos, rot, obj = contact_cases(which, om)
    K = obj.shape[1] // 2
    assert ((obj[:, :K] == 0) & (obj[:, K:] == 4) & a["ok"]).any()


def bench_world(pkg, om):
    """rigid_bench's pile (PILE) with object manager ``om``: the port's
    (CPU) or JAX's (pairs mode) executor."""
    if pkg == "port":
        cfg = rb.RigidBenchConfig(**PILE)
        World = type("WideBoxBench", (rb.RigidBenchWorld.with_config(cfg),), {"objmgr": om})
        return TaskGraphExecutor(World, ExecutorConfig(
            num_worlds=PILE["num_worlds"], max_entities_per_world=PILE["num_bodies"] + 8,
            seed=0, device="cpu"))
    cfg = jrb.RigidBenchConfig(**dict(PILE, contact_mode="pairs"))
    World = type("WideBoxBench", (jrb.RigidBenchWorld.with_config(cfg),), {"objmgr": om})
    return JTaskGraphExecutor(World, JExecutorConfig(
        num_worlds=PILE["num_worlds"], max_entities_per_world=PILE["num_bodies"] + 8, seed=0,
        donate=False))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's pairs-mode pile on the 32-vert table: its state after 3 steps
    (the boxes on the plane and each other) and after one more."""
    jsim = bench_world("jax", padded(rb.RigidBenchWorld.objmgr, 32))
    jsim.run(3)
    before = jax.tree_util.tree_map(np.asarray, jsim.state)
    jsim.step()
    return before, jax.tree_util.tree_map(np.asarray, jsim.state)


def port_step(om, state):
    sim = bench_world("port", om)
    assert "physics_substeps_fused" in sim.graph.node_names
    sim.state = state_from_numpy(state, "cpu")
    sk.FusedSubstepKernel.launches = 0
    sim.step()
    assert sk.FusedSubstepKernel.launches == 0       # CPU: the plain version
    return state_to_numpy(sim.state)


@pytest.mark.parametrize("vm", [9, 32])
def test_kernel_mode_step_on_padded_box_tables(vm, jax_steps):
    """The fused node's step on the padded table: bit for bit the box
    table's, and kernel_fits takes the table for every launch."""
    om = padded(rb.RigidBenchWorld.objmgr, vm)
    tables = sk.pk.ObjTables(om)
    n, K = PILE["num_bodies"] + 1, PILE["max_candidates"]
    assert tables.all_box and tables.Vm == vm
    for kw in (dict(), dict(cache=True), dict(bp=True), dict(single=True, joints=64)):
        assert sk.kernel_fits(tables, n, K, **kw) == "", kw
    got = port_step(om, jax_steps[0])
    own = port_step(rb.RigidBenchWorld.objmgr, jax_steps[0])
    comps_a, comps_b = got["arch"][BODY]["comps"], own["arch"][BODY]["comps"]
    for comp in comps_a:
        for f in comps_a[comp]:
            np.testing.assert_array_equal(comps_a[comp][f], comps_b[comp][f], err_msg=comp)


def test_kernel_mode_step_on_a_32_vert_box_table_matches_jax(jax_steps):
    before, after = jax_steps
    got = port_step(padded(rb.RigidBenchWorld.objmgr, 32), before)
    for comp, atol in (("Position", 1e-4), ("Rotation", 1e-4), ("Velocity", 1e-3),
                       ("CollisionAABB", 1e-5)):
        ca, cb = after["arch"][BODY]["comps"][comp], got["arch"][BODY]["comps"][comp]
        err = {f: float(np.abs(ca[f] - cb[f]).max()) for f in ca}
        assert max(err.values()) <= atol, (comp, err)
