"""Rigid-body physics of the port against the JAX package (CPU).

Inputs are JAX-initialised states converted leaf by leaf
(interop.state_from_numpy), or numpy poses made from a seed; the JAX side
runs on the CPU as its own tests run it.  The Pallas substep kernel runs
only interpreted there (its tests are marked slow), so the port's fused
kernel mode (``contact_mode="pallas"``, its plain version on the CPU) is
held against JAX's ``"pairs"`` mode, the reference JAX's own test holds the
kernel to (tests/test_physics.py:360-379).  Tolerances:

  - object managers: equal array for array;
  - broadphase: candidate rows, masks, counts and overflow counters exact
    (dense_degree 12 and 0), AABBs atol 1e-5;
  - one step (4 substeps) from a mid-pile state: positions, rotations and
    pose stashes atol 1e-4, velocities atol 1e-3 (they are position
    differences over h = 1/240, so they carry 240 times the rounding);
pair_contacts and the contact and event tables are in
test_torch_physics_contacts.py, the
multi-step worlds in test_torch_physics_world.py, the reference binary's
goldens in test_torch_physics_golden.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import RigidBodyPhysicsSystem as JPhysics
from gpu_ecs_madrona_tpu.physics import assets as jassets

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import RigidBodyPhysicsSystem, assets

PILE = dict(num_worlds=4, num_bodies=20, spawn_xy=3.0, spawn_h=4.0, seed=0)
BODY = "RigidBenchBody"


def to_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


def jax_pile(K=128, D=12, steps=3, **over):
    """A JAX pairs-mode rigid_bench pile after ``steps`` steps."""
    cfg = jrb.RigidBenchConfig(contact_mode="pairs", max_candidates=K, dense_degree=D,
                               **{**PILE, **over})
    sim = jrb.make_executor(cfg, donate=False)
    sim.run(steps)
    return sim


def port_pile(mode, K=128, D=12, **over):
    cfg = rb.RigidBenchConfig(contact_mode=mode, max_candidates=K, dense_degree=D,
                              **{**PILE, **over})
    return rb.make_executor(cfg, device="cpu")


@pytest.fixture(scope="module")
def pile():
    """A JAX pairs-mode pile after 3 steps (``before``) and after one more
    (``after``), from one executor (one compile)."""
    sim = jax_pile()
    before = to_np(sim.state)
    sim.step()
    return {"before": before, "after": to_np(sim.state)}


@pytest.fixture(scope="module")
def pile_state(pile):
    return pile["before"]


def body_err(a, b, comp):
    """Largest |a - b| per field of a body component (numpy states)."""
    ca, cb = a["arch"][BODY]["comps"][comp], b["arch"][BODY]["comps"][comp]
    return {f: float(np.abs(ca[f] - cb[f]).max()) for f in ca}


# ---------------------------------------------------------------------------
# assets
# ---------------------------------------------------------------------------


def golden_loader(pkg):
    loader = pkg.PhysicsLoader()
    loader.load_objects([pkg.make_plane(mu_s=0.5, mu_d=0.5),
                         pkg.make_box((0.5, 0.5, 0.5), inv_mass=1.0, mu_s=0.5, mu_d=0.5)])
    return loader.get_object_manager()


def general_hull_loader(pkg):
    """A triangulated cube (merged back to quads) and a quickhulled
    octahedron: the general-hull paths."""
    box = pkg.make_box((0.5, 0.5, 0.5))
    tris = []
    for loop in box.faces:
        tris += [np.asarray([loop[0], loop[1], loop[2]]), np.asarray([loop[0], loop[2], loop[3]])]
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32) * 0.7
    loader = pkg.PhysicsLoader(max_verts=8, max_faces=8, max_edges=6, max_face_verts=4,
                               max_full_edges=12)
    loader.load_objects([pkg.convex_hull_from_mesh(box.verts, tris),
                         pkg.convex_hull_from_mesh(octa, [], hull_mode="quickhull"),
                         pkg.make_sphere(0.4), pkg.make_plane()])
    return loader.get_object_manager()


_MATH_CASES = {
    "quat_mul": lambda m, q, r, v, mask: m.quat_mul(q, r),
    "quat_normalize": lambda m, q, r, v, mask: m.quat_normalize(q * 3.0),
    "quat_inv_rotate": lambda m, q, r, v, mask: m.quat_inv_rotate(q, v),
    "quat_integrate": lambda m, q, r, v, mask: m.quat_integrate(q, v, 1.0 / 240.0),
    "quat_to_mat": lambda m, q, r, v, mask: m.quat_to_mat(q),
    "mask_cumsum_last": lambda m, q, r, v, mask: m.mask_cumsum_last(mask),
}


@pytest.mark.parametrize("fn", sorted(_MATH_CASES))
def test_math_additions_match_jax(fn):
    """utils/math's quaternion helpers and mask_cumsum_last against the JAX
    package's on one seeded batch: atol 1e-6 (the mask cumsum exact)."""
    from gpu_ecs_madrona_tpu.utils import math as jm
    from gpu_ecs_madrona_tpu_torch.utils import math as tm
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, 7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.normal(size=(5, 7, 4)).astype(np.float32)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    mask = rng.random((5, 7, 33)) < 0.4
    want = np.asarray(_MATH_CASES[fn](jm, *(jnp.asarray(x) for x in (q, r, v, mask))))
    got = _MATH_CASES[fn](tm, *(torch.from_numpy(x) for x in (q, r, v, mask))).numpy()
    assert got.shape == want.shape
    if fn == "mask_cumsum_last":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["rigid_bench", "golden", "general_hulls"])
def test_object_manager_matches_jax(which):
    if which == "rigid_bench":
        a, b = jrb.default_object_manager(), rb.default_object_manager()
    elif which == "golden":
        a, b = golden_loader(jassets), golden_loader(assets)
    else:
        a, b = general_hull_loader(jassets), general_hull_loader(assets)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# broadphase
# ---------------------------------------------------------------------------


def _bp_only(world, physics, D):
    class BroadphaseOnly(world):
        @classmethod
        def setup_tasks(cls, builder):
            physics.setup_broadphase_tasks(builder, [], world_body(world), cls.objmgr,
                                           mode="dense", dense_degree=D)
    return BroadphaseOnly


def world_body(world):
    return jrb.Body if issubclass(world, jrb.RigidBenchWorld) else rb.Body


@pytest.mark.parametrize("D", [12, 0])
def test_broadphase_matches_jax(pile_state, D):
    """One broadphase (no cleanup, so the temporaries stay in the state)
    from the same mid-pile state: the candidate tables match exactly."""
    jw = _bp_only(jrb.RigidBenchWorld.with_config(jrb.RigidBenchConfig(
        max_candidates=128, dense_degree=D, **PILE)), JPhysics, D)
    jsim = JTaskGraphExecutor(jw, JExecutorConfig(num_worlds=4, max_entities_per_world=28,
                                                  seed=0, donate=False))
    jsim.state = jax.tree_util.tree_map(jnp.asarray, pile_state)
    jsim.step()
    pw = _bp_only(rb.RigidBenchWorld.with_config(rb.RigidBenchConfig(
        max_candidates=128, dense_degree=D, **PILE)), RigidBodyPhysicsSystem, D)
    psim = TaskGraphExecutor(pw, ExecutorConfig(num_worlds=4, max_entities_per_world=28,
                                                seed=0, device="cpu"))
    psim.state = state_from_numpy(pile_state, "cpu")
    psim.step()
    a, b = to_np(jsim.state), state_to_numpy(psim.state)
    for name in ("CandidateTemporary", "CandidateRowsTemporary"):
        np.testing.assert_array_equal(a["arch"][name]["mask"], b["arch"][name]["mask"])
        for comp, fields in a["arch"][name]["comps"].items():
            for f, v in fields.items():
                np.testing.assert_array_equal(v, b["arch"][name]["comps"][comp][f],
                                              err_msg=f"{name}.{comp}.{f}")
    for name in a["overflow"]:
        np.testing.assert_array_equal(a["overflow"][name], b["overflow"][name], err_msg=name)
    assert max(body_err(a, b, "CollisionAABB").values()) <= 1e-5
    np.testing.assert_array_equal(a["arch"][BODY]["comps"]["LeafID"]["value"],
                                  b["arch"][BODY]["comps"]["LeafID"]["value"])
    counts = a["arch"]["CandidateRowsTemporary"]["mask"].sum(1)
    assert counts.min() > 0


# ---------------------------------------------------------------------------
# one step, both modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pairs", "pallas"])
def test_one_step_matches_jax_pairs(pile, mode):
    want = pile["after"]
    psim = port_pile(mode)
    psim.state = state_from_numpy(pile["before"], "cpu")
    sk.FusedSubstepKernel.launches = 0
    psim.step()
    got = state_to_numpy(psim.state)
    assert sk.FusedSubstepKernel.launches == 0       # CPU: the plain version
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


def test_segment_sum_adds_in_slot_order():
    """Each body's sum is its A-side contributions in ascending slot order,
    then its B-side ones, added one after the other from 0 (the kernel's
    order), bit for bit; dead slots add nothing."""
    rng = np.random.default_rng(11)
    W, n, K, C = 3, 7, 40, 4
    ri = torch.from_numpy(rng.integers(0, n, (W, K)))
    rj = torch.from_numpy(rng.integers(0, n, (W, K)))
    kvalid = torch.from_numpy(rng.random((W, K)) < 0.8)
    # magnitudes far apart, so any other order rounds differently
    scale = 10.0 ** rng.integers(-6, 6, (C, W, K))
    packA = tuple(torch.from_numpy((rng.normal(size=(W, K)) * s).astype(np.float32))
                  for s in scale)
    packB = tuple(torch.from_numpy((rng.normal(size=(W, K)) * s).astype(np.float32))
                  for s in scale[::-1])
    base = torch.arange(W)[:, None] * n
    got = sk.pk.segment_sum(packA, packB, (ri + base).reshape(-1), (rj + base).reshape(-1),
                            kvalid, W, n)
    want = torch.zeros((C, W, n), dtype=torch.float32)
    for w in range(W):
        for rows, pack in ((ri, packA), (rj, packB)):
            for k in range(K):
                if kvalid[w, k]:
                    for c in range(C):
                        want[c, w, rows[w, k]] += pack[c][w, k]
    for c in range(C):
        assert torch.equal(got[c], want[c]), c
