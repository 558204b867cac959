"""The reference engine binary's physics goldens through the port alone (no
JAX), in both contact modes, and the options that raised until the dense
contact mode and the sap broadphase were ported (each builds, resolves to
its nodes and steps; "auto"'s thresholds at 48 and 192 body rows).

tests/goldens/*.bin are trajectories of the reference's BVH broadphase ->
SAT narrowphase -> XPBD solver (tools/ref_golden/golden_gen; see
tests/test_reference_golden.py, whose gates and tiers these are: the
1-substep scenes in the quick tier, the 4-substep and rocking-cube ones,
5-12 s each here, marked slow):
  - pre-contact free flight <= 1e-5; the first 10 ticks after first
    contact <= 0.06; the whole horizon <= 1.2 (2.5 for the toppling
    stack); the restitution bounce peak within 0.08; all cubes come to
    rest on the plane (cubes_fall);
  - the free-fall ticks bit-level (<= 1e-5) in every channel;
  - the fixed-joint chain (cube_chain_ss4, ~13 s here, so in the quick
    tier), in "pairs" mode with its own gates (below).
"contact_mode='pallas'" is the fused substep kernel's plain version here
(the CUDA kernel runs these scenes in chip_smoke.py's golden_physics).
"""

import os
import struct

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import (
    BODY_COMPONENTS, RigidBodyPhysicsSystem, assets, make_fixed_joint)
from gpu_ecs_madrona_tpu_torch.physics.components import (
    RESPONSE_DYNAMIC, RESPONSE_STATIC, ResponseType, Velocity)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".bin"), "rb") as f:
        d = f.read()
    assert d[:4] == b"GLD1"
    T1, W, K, ss = struct.unpack("<4i", d[4:20])
    dt = struct.unpack("<f", d[20:24])[0]
    return np.frombuffer(d[24:], np.float32).reshape(T1, W, K, 13).copy(), W, K, ss, dt


def run_equivalent(golden, W, K, substeps, dt, ticks, contact_mode, joint=False):
    """The golden's scene in the port (plane row 0, the cubes after it),
    initial state from its tick 0; returns [ticks + 1, W, K, 13].
    joint=True recreates cube_chain's Fixed joint between the two cubes
    (the reference's setupFixed(a, b, id, id, (0, 0, -0.6), (0, 0, 0.6),
    0), as tests/test_reference_golden.py builds it)."""
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_plane(mu_s=0.5, mu_d=0.5),
                         assets.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.5, mu_d=0.5)])
    mgr = loader.get_object_manager()
    Body = Archetype("GoldenBody", BODY_COMPONENTS)
    init0 = golden[0]

    class World:
        @staticmethod
        def register_types(r):
            RigidBodyPhysicsSystem.register_types(r, max_candidates=64, max_contacts=64,
                                                  max_joints=4 if joint else 0)
            r.register_archetype(Body, capacity=K + 1)
            r.export_column(Body, base.Position, 0)
            r.export_column(Body, base.Rotation, 1)
            r.export_column(Body, Velocity, 2)

        @staticmethod
        def init(ctx, init_data=None):
            Wn = ctx.num_worlds
            ctx.data = {"_": torch.zeros((Wn, 1))}
            RigidBodyPhysicsSystem.init(ctx, delta_t=dt, num_substeps=substeps)
            pos = np.zeros((Wn, K + 1, 3), np.float32)
            rot = np.zeros((Wn, K + 1, 4), np.float32)
            rot[..., 0] = 1.0
            vel = np.zeros((Wn, K + 1, 3), np.float32)
            omega = np.zeros((Wn, K + 1, 3), np.float32)
            oid = np.zeros((Wn, K + 1), np.int32)
            resp = np.full((Wn, K + 1), RESPONSE_STATIC, np.int32)
            pos[:, 1:], rot[:, 1:] = init0[..., 0:3], init0[..., 3:7]
            vel[:, 1:], omega[:, 1:] = init0[..., 7:10], init0[..., 10:13]
            oid[:, 1:] = 1
            resp[:, 1:] = RESPONSE_DYNAMIC
            t = torch.from_numpy
            ents = ctx.make_entities(Body, counts=K + 1, max_new=K + 1, values={
                base.Position: t(pos), base.Rotation: t(rot),
                base.Scale: torch.ones((Wn, K + 1, 3)), base.ObjectID: t(oid),
                Velocity: {"linear": t(vel), "angular": t(omega)}, ResponseType: t(resp)})
            if joint:
                ident = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(Wn, 1, 4)
                make_fixed_joint(ctx, ents[:, 1:2], ents[:, 2:3], ident, ident,
                                 torch.tensor([0.0, 0.0, -0.6]).expand(Wn, 1, 3),
                                 torch.tensor([0.0, 0.0, 0.6]).expand(Wn, 1, 3),
                                 torch.zeros((Wn, 1)))

        @staticmethod
        def setup_tasks(builder):
            bp = RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, mgr)
            sub = RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], substeps, Body, mgr,
                                                             contact_mode=contact_mode)
            RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [sub])

    sim = TaskGraphExecutor(World, ExecutorConfig(num_worlds=W, max_entities_per_world=K + 8,
                                                  seed=0, device="cpu"))
    out = np.zeros((ticks + 1, W, K, 13), np.float32)
    out[0] = init0
    for t in range(1, ticks + 1):
        sim.step()
        vel = sim.get_exported(2)[0]
        out[t] = np.concatenate([sim.get_exported(0)[0][:, 1:].numpy(),
                                 sim.get_exported(1)[0][:, 1:].numpy(),
                                 vel["linear"][:, 1:].numpy(), vel["angular"][:, 1:].numpy()],
                                axis=-1)
    return out


def first_contact_tick(golden, support=0.52):
    zmin = golden[..., 2].min(axis=(1, 2))
    hit = zmin < support
    return int(np.argmax(hit)) if hit.any() else golden.shape[0]


@pytest.mark.parametrize("mode", ["pairs", "pallas"])
@pytest.mark.parametrize("name", ["cubes_fall_ss1", "cube_pair_ss1", "cube_stack_ss1",
                                  "cube_bounce_ss1"] + [
    pytest.param(n, marks=pytest.mark.slow)
    for n in ("cubes_fall_ss4", "cube_pair_ss4", "cube_stack_ss4", "cube_bounce_ss4",
              "cube_rock_ss1", "cube_rock_ss4")])
def test_golden_trajectory(name, mode):
    golden, W, K, ss, dt = load_golden(name)
    T = golden.shape[0] - 1
    mine = run_equivalent(golden, W, K, ss, dt, T, mode)
    perr = np.abs(mine[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
    # cube_rock drops only 0.05 onto its edge: contact is when the centre
    # has fallen that far
    support = golden[0, ..., 2].min() - 0.045 if name.startswith("cube_rock") else 0.52
    fc = first_contact_tick(golden, support)
    if fc > 1:
        assert perr[:fc].max() <= 1e-5, perr[:fc].max()
    assert perr[:min(fc + 10, T)].max() <= 0.06, perr[:min(fc + 10, T)].max()
    horizon = 2.5 if name.startswith("cube_stack") else 1.2
    assert perr.max() <= horizon, perr.max()
    assert np.isfinite(mine).all()
    if name.startswith("cube_bounce"):
        fc2 = first_contact_tick(golden)
        g_peak = golden[fc2:, ..., 2].max(axis=0)
        m_peak = mine[fc2:, ..., 2].max(axis=0)
        assert np.abs(g_peak - m_peak).max() <= 0.08, (g_peak, m_peak)
    if name.startswith("cubes_fall"):
        m_final, g_final = mine[-1, ..., 2], golden[-1, ..., 2]
        assert (m_final > 0.3).all() and (m_final < 4.0).all()
        assert np.abs(np.sort(m_final, axis=None) - np.sort(g_final, axis=None)).max() <= 0.6


def test_golden_fixed_joint_chain():
    """cube_chain_ss4 (the reference's setupFixed + handleJointConstraint,
    physics.cpp:560-648) in "pairs" mode, with
    tests/test_reference_golden.py::test_golden_fixed_joint_chain's gates:
    a 2-cube chain swings, falls and lands; the early trajectory agrees,
    the whole horizon stays bounded, the joint holds its 1.2 anchor
    separation in both engines, and both come to rest near the plane.  The
    kernel mode misses the early gate, as the JAX package's does
    (test_torch_joint_golden.py pins that)."""
    golden, W, K, ss, dt = load_golden("cube_chain_ss4")
    T = golden.shape[0] - 1
    mine = run_equivalent(golden, W, K, ss, dt, T, "pairs", joint=True)
    perr = np.abs(mine[..., 0:3] - golden[..., 0:3]).max(axis=(1, 2, 3))
    assert perr[:10].max() <= 0.02, perr[:10].max()
    assert perr.max() <= 1.5, perr.max()
    for t in range(0, T + 1, 10):
        sep_m = np.linalg.norm(mine[t, :, 0, :3] - mine[t, :, 1, :3], axis=-1)
        sep_g = np.linalg.norm(golden[t, :, 0, :3] - golden[t, :, 1, :3], axis=-1)
        assert np.abs(sep_m - 1.2).max() < 0.15, (t, sep_m)
        assert np.abs(sep_g - 1.2).max() < 0.15, (t, sep_g)
    assert (mine[-1, :, :, 2] < 2.0).all() and (golden[-1, :, :, 2] < 2.0).all()
    assert np.isfinite(mine).all()


@pytest.mark.parametrize("mode", ["pairs", "pallas"])
def test_golden_free_fall_bitexact(mode):
    golden, W, K, ss, dt = load_golden("cubes_fall_ss1")
    fc = first_contact_tick(golden)
    assert fc >= 15
    mine = run_equivalent(golden, W, K, ss, dt, fc - 1, mode)
    assert np.abs(mine[:fc - 1] - golden[:fc - 1]).max() <= 1e-5


# -- the options that raised until the dense contact mode and sap were ported


def _bench(num_bodies=4, **kw):
    return rb.make_executor(rb.RigidBenchConfig(num_worlds=1, num_bodies=num_bodies, **kw),
                            device="cpu")


def _node(sim, name):
    return next(nd for nd in sim.graph.nodes if nd.name == name).run


# what: (configuration, substep route, broadphase node)
FORMERLY_UNPORTED = {
    "contact_mode=dense": (dict(contact_mode="dense"), "dense", "find_overlaps"),
    "auto at 48 rows or fewer": (dict(contact_mode="auto", num_bodies=47), "dense",
                                 "find_overlaps"),
    "broadphase sap": (dict(contact_mode="pallas", broadphase_mode="sap"), "fused",
                       "find_overlaps_sap"),
    "auto broadphase above 192 rows": (dict(contact_mode="pallas", num_bodies=192), "fused",
                                       "find_overlaps_sap"),
}


@pytest.mark.parametrize("what", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_options_build(what):
    """Each configuration that raised NotImplementedError before the dense
    contact mode and sap were ported builds, resolves to its nodes and
    steps: the dense mode's per-substep nodes (with their world block) or
    the fused kernel's node, the dense or the sap broadphase node."""
    cfg, route, bp = FORMERLY_UNPORTED[what]
    sim = _bench(**cfg)
    assert _node(sim, "bp_find_overlaps").__name__ == bp
    if route == "dense":
        assert phys.FUSED_NODE not in sim.graph.node_names
        assert _node(sim, "physics_substep_3").world_block == 1
    else:
        assert "physics_substep_0" not in sim.graph.node_names
        assert _node(sim, phys.FUSED_NODE).kernel is not None
    sim.step()
    pos, mask = sim.get_exported(0)
    assert bool(pos[mask].isfinite().all())


@pytest.mark.parametrize("bodies,route", [(47, "dense"), (48, "fused")])
def test_auto_contact_mode_threshold(bodies, route):
    """contact_mode="auto": dense at 48 body rows (47 bodies and the
    plane), the fused kernel at 49."""
    names = _bench(num_bodies=bodies, contact_mode="auto").graph.node_names
    assert (phys.FUSED_NODE in names) == (route == "fused")


@pytest.mark.parametrize("bodies,bp", [(191, "find_overlaps"), (192, "find_overlaps_sap")])
def test_auto_broadphase_threshold(bodies, bp):
    """broadphase_mode="auto": the dense grid at 192 body rows, sap at 193."""
    assert _node(_bench(num_bodies=bodies, contact_mode="pallas"),
                 "bp_find_overlaps").__name__ == bp


@pytest.mark.parametrize("spawn,body_mix", [("uniform", "alternate"), ("grid", "boxes")])
def test_port_spawn(spawn, body_mix):
    """The port's own spawn (its generator, not JAX's draws): the plane in
    row 0, the pile inside its spawn region with unit quaternions and the
    configured object mix, the same from one seed, other from another."""
    def state(seed):
        cfg = rb.RigidBenchConfig(num_worlds=3, num_bodies=10, spawn=spawn, body_mix=body_mix,
                                  seed=seed)
        sim = rb.make_executor(cfg, device="cpu")
        return sim, sim.get_exported(0)[0], sim.get_exported(1)[0]
    sim, pos, rot = state(0)
    _, pos_again, rot_again = state(0)
    _, pos_other, _ = state(1)
    assert torch.equal(pos, pos_again) and torch.equal(rot, rot_again)
    assert not torch.equal(pos, pos_other)
    assert torch.equal(pos[:, 0], torch.zeros(3, 3))
    pile = pos[:, 1:]
    if spawn == "uniform":
        assert (pile[..., :2].abs() <= 8.0).all() and (pile[..., 2] >= 1.0).all()
        assert (pile[..., 2] <= 12.0).all()
    else:
        assert (pile[..., 2] - 1.2).abs().max() <= 0.15
    assert torch.allclose(torch.linalg.vector_norm(rot, dim=-1), torch.ones(3, 11), atol=1e-5)
    obj = sim.mgr.column(sim.state, rb.Body, base.ObjectID)
    assert (obj[:, 0] == rb.OBJ_PLANE).all()
    want = torch.zeros(10, dtype=torch.int32) if body_mix == "boxes" else \
        torch.arange(10, dtype=torch.int32) % 2
    assert torch.equal(obj[:, 1:], want.expand(3, 10))


def test_auto_contact_mode_is_the_kernel_above_48_rows():
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=1, num_bodies=60, contact_mode="auto"),
                           device="cpu")
    assert "physics_substeps_fused" in sim.graph.node_names


def test_kernel_refuses_general_hulls_on_the_card_path():
    """The CUDA route takes general hulls whose staged rows fit its shared
    memory (here the box taken as a general hull, also padded to 40 table
    verts, past PhysicsLoader()'s default 32); those whose rows do not (here
    600 table verts at 65 rows) it takes with the bodies and hull rows in a
    global scratch, and refuses them, by name, only with the in-kernel
    broadphase, which keeps its rows in shared memory; all-box tables take
    the box paths."""
    om = dict(rb.default_object_manager())
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    assert sk.kernel_fits(sk.pk.ObjTables(om), 65, 256) == ""
    om["verts"] = np.pad(om["verts"], ((0, 0), (0, 32), (0, 0)))
    assert sk.kernel_fits(sk.pk.ObjTables(om), 65, 256) == ""
    om["verts"] = np.pad(om["verts"], ((0, 0), (0, 560), (0, 0)))
    tables = sk.pk.ObjTables(om)
    assert sk.kernel_fits(tables, 65, 256) == "" and sk.fused_bodies(tables, 65, 256)
    assert sk.kernel_fits(tables, 65, 256, single=True, joints=64) == ""
    why = sk.kernel_fits(tables, 65, 128, bp=True)
    assert why.startswith("general-hull tables staged at") and "600 verts" in why, why
    assert f"need {sk.hull_stage_bytes(tables, 65)} B" in why and "hull-row budget" in why
    assert sk.kernel_fits(sk.pk.ObjTables(rb.default_object_manager()), 65, 256) == ""


@pytest.mark.parametrize("n,K,fits", [(65, 256, "slots"), (65, 128, "slots"),
                                      (65, 1024, "slots"), (1024, 1024, False),
                                      (65, 2000, "window")])
def test_kernel_fits_checks_shared_memory(n, K, fits):
    """Shapes whose slot layout passes the 227 KB a block may have take the
    windowed layout (as do those whose slot layout leaves one CTA an SM, at
    65 rows from K = 539), and those whose bodies leave it no room (``fits``
    False: no layout in one block) the bodies in a global scratch; the
    in-kernel broadphase, which has neither, refuses such shapes with a
    reason that names the limit, not launched to fail."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    why = sk.kernel_fits(tables, n, K)
    assert why == ""
    assert (sk.smem_bytes(n, K) <= sk.MAX_SMEM_BYTES) == (fits == "slots")
    assert sk.windowed(tables, n, K) == (fits != "slots"
                                         or sk.smem_bytes(n, K) > sk.TWO_CTA_BYTES)
    assert sk.fused_bodies(tables, n, K) == (not fits)
    if fits != "slots" and n <= sk.MAX_BP_ROWS:
        why = sk.kernel_fits(tables, n, K, bp=True)
        assert "shared memory" in why and str(sk.MAX_SMEM_BYTES) in why, why


def test_kernel_table_is_built_once_per_device():
    """The kernel's object table is copied to a device once, not on every
    step (a copy from host memory would make the host wait for the
    stream)."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    t = tables.kernel_table("cpu")
    assert tables.kernel_table(torch.device("cpu")) is t
    assert t.dtype == torch.float32 and tuple(t.shape) == (tables.O, 20 + 3 * tables.Vm)
