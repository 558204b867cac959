"""The fused kernel's options at the world level (CPU, the kernel's plain
version): contact refresh, world sleep, the in-kernel broadphase and
persistent manifolds through the physics system's nodes.

  - the port's counterparts of the JAX package's scenarios
    (tests/test_manifold_persist.py:90,106,123,209, tests/test_sleep.py:73,
    86,103, tests/test_contact_refresh.py:25,40), with their gates: the
    persistent path follows the rebuilding one while bodies fall (atol
    8e-2), stops rebuilding once settled and rebuilds on a kick the same
    step, freezes bit for bit asleep; sleep engages, wakes on a push and
    changes nothing while every world is awake; refresh settles like the
    full narrowphase;
  - two reference oddities of the persistence predicate, reproduced and
    pinned (ROADMAP Queue 3: entity churn keeps the cache; the carry term
    has no acceleration allowance);
  - the option combinations the JAX package refuses, refused with its
    ValueErrors (tests/test_contact_refresh.py:110's hinge is the
    refresh-with-joints case);
  - the JAX world of tests/test_manifold_persist.py (2 worlds: a plane, a
    resting box and a falling one) with persistence and sleep, JAX at
    ``substep_wt=1`` (the port's one CTA a world), from one JAX-initialised
    state: positions, SleepState, ManifoldPersist and CollisionAABB atol
    1e-4 (integers exact) over 50 steps, through its fall, rebuilds,
    stable steps and world 0's sleep (world 1, dropped from higher, stays
    awake longer).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import Archetype as JArchetype
from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu import base as jbase
from gpu_ecs_madrona_tpu import physics as jphys
from gpu_ecs_madrona_tpu.physics import components as jcomp

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import components as comp

PLANE, BOX = 0, 1
# tests/test_manifold_persist.py's scene: a box resting on the plane, one
# dropped beside it; tests/test_sleep.py's: the resting box alone
TWO_BOXES = [(PLANE, (0.0, 0, 0), comp.RESPONSE_STATIC),
             (BOX, (0.0, 0, 0.499), comp.RESPONSE_DYNAMIC),
             (BOX, (2.5, 0.2, 1.2), comp.RESPONSE_DYNAMIC)]
ONE_BOX = TWO_BOXES[:2]


def scene(pkg="port", bodies=TWO_BOXES, num_worlds=2, broadphase="fused", refresh=True,
          persist=False, sleep=0.0, frames=3, joints=0, substep_wt=None, register=None,
          contact_mode="pallas", capacity=4):
    """A world of ``bodies`` in either package (``pkg`` "port" or "jax"),
    the options as the JAX tests set them (degree cap 8, 16 candidates,
    margin 0.05); returns the executor."""
    if pkg == "jax":
        physics, bmod, cmod, Arch = jphys, jbase, jcomp, JArchetype

        def conv(x, dt=np.float32):
            return jnp.asarray(np.asarray(x, dt))
    else:
        physics, bmod, cmod, Arch = phys, base, comp, Archetype

        def conv(x, dt=np.float32):
            return torch.from_numpy(np.array(x, dt))
    loader = physics.assets.PhysicsLoader()
    loader.load_objects([physics.assets.make_plane(), physics.assets.make_box((0.5, 0.5, 0.5))])
    om = loader.get_object_manager()
    Body = Arch("OptionBody", physics.BODY_COMPONENTS)
    register = persist if register is None else register

    class World:
        @staticmethod
        def register_types(r):
            physics.RigidBodyPhysicsSystem.register_types(r, max_candidates=16,
                                                          max_contacts=16, max_joints=joints)
            r.register_archetype(Body, capacity=capacity)
            if register:
                physics.RigidBodyPhysicsSystem.register_persistent_manifolds(r, Body, 16)
            r.export_column(Body, bmod.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            W, nb = ctx.num_worlds, len(bodies)
            ctx.data = {"_": conv(np.zeros((W, 1)))}
            physics.RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=4)

            def tile(a, dt=np.float32):
                a = np.asarray(a)
                return conv(np.broadcast_to(a, (W,) + a.shape), dt)
            ctx.make_entities(Body, counts=nb, max_new=nb, values={
                bmod.Position: tile([b[1] for b in bodies]),
                bmod.Rotation: tile([[1.0, 0, 0, 0]] * nb),
                bmod.Scale: tile(np.ones((nb, 3))),
                bmod.ObjectID: tile([b[0] for b in bodies], np.int32),
                cmod.ResponseType: tile([b[2] for b in bodies], np.int32)})

        @staticmethod
        def setup_tasks(builder):
            bp = physics.RigidBodyPhysicsSystem.setup_broadphase_tasks(
                builder, [], Body, om, mode=broadphase, dense_degree=8)
            ss = physics.RigidBodyPhysicsSystem.setup_substep_tasks(
                builder, [bp], 4, Body, om, contact_mode=contact_mode, substep_wt=substep_wt,
                contact_refresh=refresh, manifold_persist=persist, persist_margin=0.05,
                sleep_threshold=sleep, sleep_frames=frames)
            physics.RigidBodyPhysicsSystem.setup_cleanup_tasks(builder, [ss])

    World.Body = Body
    if pkg == "jax":
        return JTaskGraphExecutor(World, JExecutorConfig(
            num_worlds=num_worlds, max_entities_per_world=8, seed=0, donate=False))
    return TaskGraphExecutor(World, ExecutorConfig(num_worlds=num_worlds,
                                                   max_entities_per_world=8, seed=0,
                                                   device="cpu"))


def positions(sim):
    return sim.get_exported(0)[0].numpy().copy()


def singleton(sim, name):
    s = sim.mgr.get_singleton(sim.state, sim.mgr.registry.singletons[name])
    return {k: v.clone() for k, v in s.items()}


def kick(sim, wld, row, v):
    """Set body ``row``'s linear velocity in world ``wld`` (all worlds when
    wld is None)."""
    Body = sim.world_cls.Body
    vel = sim.mgr.column(sim.state, Body, comp.Velocity)
    lin = vel["linear"].clone()
    lin[slice(None) if wld is None else wld, row] = torch.tensor(v)
    sim.state = sim.mgr.set_column(sim.state, Body, comp.Velocity,
                                   {"linear": lin, "angular": vel["angular"]})


# -- persistent manifolds (tests/test_manifold_persist.py) ---------------------


def test_persist_matches_baseline_while_falling():
    """While the dropped box falls and lands every world rebuilds every
    step; the trajectory follows the refresh-only path within the JAX
    test's post-impact tolerance."""
    outs = {}
    for persist in (False, True):
        sim = scene(persist=persist)
        sim.run(30)
        outs[persist] = positions(sim)
        assert np.isfinite(outs[persist]).all()
    np.testing.assert_allclose(outs[True], outs[False], atol=8e-2)


@pytest.fixture(scope="module")
def settled():
    """The persistent scene after 120 steps (both boxes resting)."""
    sim = scene(persist=True)
    sim.run(120)
    return sim.state


def test_persist_skip_engages_when_settled(settled):
    """Once resting, the cache stops rebuilding: anchors unchanged over 15
    more steps, bodies still."""
    sim = scene(persist=True)
    sim.state = settled
    mp0 = singleton(sim, "ManifoldPersist")
    assert (mp0["valid"] == 1).all()
    p0 = positions(sim)
    sim.run(15)
    assert torch.equal(singleton(sim, "ManifoldPersist")["apos"], mp0["apos"])
    np.testing.assert_allclose(positions(sim), p0, atol=5e-3)


def test_persist_rebuilds_on_disturbance_and_recontacts(settled):
    """A kick breaks stability the same step (anchors move), and the kicked
    box lands back on the plane instead of tunnelling."""
    sim = scene(persist=True)
    sim.state = settled
    apos0 = singleton(sim, "ManifoldPersist")["apos"]
    kick(sim, None, 2, [1.5, 0.5, 3.0])
    sim.run(1)
    assert not torch.equal(singleton(sim, "ManifoldPersist")["apos"], apos0)
    sim.run(89)
    pos, mask = sim.get_exported(0)
    assert torch.isfinite(pos[mask]).all()
    assert (pos[:, 1:3, 2] > 0.3).all(), pos[..., 2]


def test_sleep_composes_with_persist_and_freezes_bitexactly():
    sim = scene(persist=True, sleep=0.02, frames=3)
    sim.run(140)
    assert (singleton(sim, "SleepState")["asleep"] == 1).all()
    p0, apos0 = positions(sim), singleton(sim, "ManifoldPersist")["apos"]
    sim.run(25)
    np.testing.assert_array_equal(positions(sim), p0)
    assert torch.equal(singleton(sim, "ManifoldPersist")["apos"], apos0)


def test_persist_oddity_entity_churn_keeps_the_cache(settled):
    """A JAX reference oddity, reproduced (ADVICE.md, physics/__init__.py:
    1163): the stability predicate watches only the motion of live dynamic
    rows and external forces, so destroying a body in a stable world does
    not rebuild its cache: the world stays stable, and the kept candidate
    rows still name the dead row."""
    sim = scene(persist=True)
    sim.state = settled
    ctx = Context(sim.mgr, sim.state)
    ctx.destroy_entities(ctx.entity_column(sim.world_cls.Body)[:, 2:3])
    sim.state = ctx.state
    assert not sim.mgr.row_mask(sim.state, sim.world_cls.Body)[:, 2].any()
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, sim.world_cls.Body, None)
    assert kw["stable"].all()
    mc = kw["mcache"]
    assert ((mc[:, 1] == 2) & (mc[:, 2] > 0.5)).any(1).all()


def test_persist_oddity_carry_ignores_acceleration():
    """A JAX reference oddity, reproduced (ADVICE.md, physics/__init__.py:
    1157): the predicate's carry term (|v| + |w| r) dt has no acceleration
    allowance, so a box at rest in mid-air, its cache built where it is,
    counts as stable though gravity moves it within the step."""
    sim = scene(bodies=[TWO_BOXES[0], (BOX, (0.0, 0.0, 3.0), comp.RESPONSE_DYNAMIC)],
                persist=True)
    sim.step()
    Body = sim.world_cls.Body
    mp = singleton(sim, "ManifoldPersist")
    vel = sim.mgr.column(sim.state, Body, comp.Velocity)
    sim.state = sim.mgr.set_column(sim.state, Body, comp.Velocity,
                                   {"linear": torch.zeros_like(vel["linear"]),
                                    "angular": torch.zeros_like(vel["angular"])})
    sim.state = sim.mgr.set_singleton(sim.state, sim.mgr.registry.singletons["ManifoldPersist"],
                                      dict(mp, apos=sim.mgr.column(sim.state, Body, base.Position),
                                           arot=sim.mgr.column(sim.state, Body, base.Rotation)))
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, Body, None)
    assert (mp["valid"] == 1).all() and kw["stable"].all()
    z0 = positions(sim)[:, 1, 2]
    sim.step()
    assert (positions(sim)[:, 1, 2] < z0).all()          # it fell, from a kept cache


# -- world sleep (tests/test_sleep.py) -------------------------------------------


def resting(sleep, frames=3):
    return scene(bodies=ONE_BOX, broadphase="dense", refresh=False, sleep=sleep, frames=frames)


def test_resting_world_falls_asleep_and_freezes():
    sim = resting(0.02)
    sim.run(20)
    assert (singleton(sim, "SleepState")["asleep"] == 1).all()
    p = positions(sim)
    sim.run(30)
    np.testing.assert_array_equal(positions(sim), p)


def test_sleep_off_matches_sleep_on_while_active():
    outs = []
    for thr in (0.0, 0.02):
        sim = resting(thr, frames=6)
        Body = sim.world_cls.Body
        pos = sim.mgr.column(sim.state, Body, base.Position).clone()
        pos[:, 1, 2] = 1.5
        sim.state = sim.mgr.set_column(sim.state, Body, base.Position, pos)
        sim.run(5)
        outs.append(positions(sim))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_woken_by_external_velocity():
    sim = resting(0.02)
    sim.run(20)
    assert (singleton(sim, "SleepState")["asleep"] == 1).all()
    kick(sim, 0, 1, [0.0, 0.0, 3.0])
    before = positions(sim)
    sim.run(3)
    asleep = singleton(sim, "SleepState")["asleep"]
    assert asleep[0] == 0 and asleep[1] == 1
    after = positions(sim)
    assert not np.array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])


# -- contact refresh (tests/test_contact_refresh.py) -----------------------------


def test_refresh_settles_like_full_narrowphase():
    """A chaotic pile with and without refresh: nothing falls through, the
    same envelope, bounded divergence over 50 steps."""
    out = {}
    for refresh in (False, True):
        sim = rb.make_executor(rb.RigidBenchConfig(
            num_worlds=4, num_bodies=10, seed=5, contact_mode="pallas",
            broadphase_mode="dense", contact_refresh=refresh), device="cpu")
        sim.run(50)
        pos, mask = sim.get_exported(0)
        out[refresh] = (pos.numpy(), mask.numpy())
    (pF, mk), (pR, _) = out[False], out[True]
    assert np.isfinite(pR[mk]).all()
    zF, zR = pF[mk][:, 2], pR[mk][:, 2]
    assert zR.min() > -0.6
    assert abs(zR.max() - zF.max()) < 2.0
    assert abs(np.median(zR) - np.median(zF)) < 1.0
    assert np.abs(pF - pR)[mk].max() < 2.5


def test_refresh_resting_contact_stable():
    outs = []
    for refresh in (False, True):
        sim = scene(bodies=ONE_BOX, broadphase="dense", refresh=refresh)
        sim.run(60)
        outs.append(positions(sim)[:, 1, 2])
    zF, zR = outs
    assert np.abs(zF - 0.5).max() < 0.02
    assert np.abs(zR - zF).max() < 0.02


# -- the option combinations the JAX package refuses -----------------------------


REFUSED = {
    "fused broadphase above 128 rows": (dict(capacity=129), "capacity <= 128"),
    "fused broadphase with joints": (dict(joints=4, refresh=False), "without joints"),
    "fused broadphase outside pallas": (dict(contact_mode="pairs"), "contact_mode='pallas'"),
    "sleep outside the fused kernel": (dict(broadphase="dense", refresh=False,
                                            contact_mode="pairs", sleep=0.02), "sleep_threshold"),
    "sleep with joints": (dict(broadphase="dense", refresh=False, joints=4, sleep=0.02),
                          "sleep_threshold"),
    "fused broadphase with sleep but no persistence": (dict(sleep=0.02), "manifold_persist"),
    "persistence without the fused broadphase": (dict(broadphase="dense", persist=True),
                                                 "broadphase mode 'fused'"),
    "persistence without refresh": (dict(refresh=False, persist=True), "contact_refresh"),
    "persistence without the singleton": (dict(persist=True, register=False),
                                          "register_persistent_manifolds"),
    "refresh with joints (the hinge scene)": (dict(broadphase="dense", joints=4),
                                              "contact_refresh requires"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_option_combinations_refused(case):
    kwargs, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        scene(**kwargs)


def test_kernel_refuses_persistence_without_its_options():
    with pytest.raises(ValueError, match="persist_margin requires"):
        sk.FusedSubstepKernel(rb.default_object_manager(), 4, bp_degree=12,
                              persist_margin=0.05)


def test_persistent_manifold_singleton_matches_jax():
    """register_persistent_manifolds: the JAX singleton's fields, shapes
    and dtypes (K = 128 for 16 candidates), so states convert 1:1."""
    mine = scene(persist=True).state["singleton"]["ManifoldPersist"]
    theirs = scene("jax", persist=True, substep_wt=1).state["singleton"]["ManifoldPersist"]
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert tuple(mine[k].shape) == v.shape and str(mine[k].dtype)[6:] == str(v.dtype), k


# -- against the JAX world -------------------------------------------------------


def test_persist_sleep_world_matches_jax():
    """The JAX package's persistence-and-sleep scene (2 worlds), JAX's
    kernel interpreted at wt = 1, 50 steps from one state."""
    jsim = scene("jax", persist=True, sleep=0.02, frames=3, substep_wt=1)
    # world 1's dropped box starts higher: the worlds differ
    jpos = np.array(jsim.mgr.column(jsim.state, jsim.world_cls.Body, jbase.Position))
    jpos[1, 2, 2] = 2.0
    jsim.state = jsim.mgr.set_column(jsim.state, jsim.world_cls.Body, jbase.Position,
                                     jnp.asarray(jpos))
    sim = scene(persist=True, sleep=0.02, frames=3)
    sim.state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    body, kept, rebuilt = "OptionBody", 0, 0
    apos = None
    for step in range(50):
        jsim.step()
        sim.step()
        a = jax.tree_util.tree_map(np.asarray, jsim.state)
        b = state_to_numpy(sim.state)
        for c in ("Position", "Rotation"):
            np.testing.assert_allclose(b["arch"][body]["comps"][c]["value"],
                                       a["arch"][body]["comps"][c]["value"], rtol=0,
                                       atol=1e-4, err_msg=f"{c} step {step}")
        for f in ("lo", "hi"):
            np.testing.assert_allclose(b["arch"][body]["comps"]["CollisionAABB"][f],
                                       a["arch"][body]["comps"]["CollisionAABB"][f], rtol=0,
                                       atol=1e-4, err_msg=f"aabb {f} step {step}")
        for f in ("quiet_steps", "asleep"):
            np.testing.assert_array_equal(b["singleton"]["SleepState"][f],
                                          a["singleton"]["SleepState"][f], err_msg=f)
        mp_a, mp_b = a["singleton"]["ManifoldPersist"], b["singleton"]["ManifoldPersist"]
        np.testing.assert_array_equal(mp_b["valid"], mp_a["valid"])
        np.testing.assert_array_equal(mp_b["mc"][:, :3], mp_a["mc"][:, :3])
        for f in ("mc", "apos", "arot"):
            np.testing.assert_allclose(mp_b[f], mp_a[f], rtol=0, atol=1e-4,
                                       err_msg=f"{f} step {step}")
        if apos is not None:
            moved = (mp_b["apos"] != apos).any(axis=(1, 2))
            awake = b["singleton"]["SleepState"]["asleep"] == 0
            rebuilt += int(moved.sum())
            kept += int((~moved & awake).sum())
        apos = mp_b["apos"]
    # the run rebuilt, kept caches while awake, and slept
    assert rebuilt > 0 and kept > 0
    assert (a["singleton"]["SleepState"]["asleep"] == 1).any()
