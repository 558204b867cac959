"""The single-substep kernel (TPU kernel 5) and the joint solve of the port
against the JAX package, on the CPU.

  - ``substep_plain`` (the kernel's plain version) against JAX's
    ``SubstepKernel`` in interpret mode, on a settling pile of boxes and
    spheres with its candidate pairs, with and without restitution: pose
    atol 1e-4, velocities atol 1e-3 (the physics slice's tolerances); and
    one substep of the fused plain version equal to the integrate plus
    ``substep_plain``, bit for bit;
  - ``solver.solve_joints`` against JAX's on seeded Fixed and Hinge joints,
    dead rows and invalid handles among them: atol 1e-5.
A world with joints, step by step, is in test_torch_joint_world.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ecs_madrona_tpu.ops import substep_kernel as jsk
from gpu_ecs_madrona_tpu.physics import solver as jsolver

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import solver

# -- the kernel's plain version against the interpreted Pallas kernel --------


def pile_inputs():
    """The single-substep kernel's inputs on a settling pile: the port's
    rigid_bench (2 worlds x 24 bodies on a grid over the plane) after 20
    steps, its next broadphase's candidates, and the integrate of the
    next substep (the kernel's caller integrates)."""
    sim = rb.make_executor(rb.RigidBenchConfig(
        num_worlds=2, num_bodies=24, spawn="grid", spawn_xy=2.0, spawn_h=1.2, seed=0,
        contact_mode="pallas", max_candidates=128, dense_degree=12), device="cpu")
    sim.run(20)
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body,
                                                             rb.RigidBenchWorld.objmgr)
    assert int(kw["kvalid"].sum(1).min()) >= 10
    return {k: x.numpy() for k, x in phys.RigidBodyPhysicsSystem.substep_kernel_inputs(kw).items()}


@pytest.fixture(scope="module")
def pile():
    return pile_inputs()


@pytest.mark.parametrize("restitution", [True, False])
def test_substep_plain_matches_jax_kernel(pile, restitution):
    om = dict(rb.default_object_manager())
    if not restitution:
        om["restitution"] = np.zeros_like(om["restitution"])
    args = pile
    jout = jsk.SubstepKernel(om, relaxation=0.7, interpret=True)(
        **{k: jnp.asarray(v) for k, v in args.items()})
    kern = sk.SubstepKernel(om, relaxation=0.7)
    assert kern.tables.any_restitution == restitution
    sk.SubstepKernel.launches = 0
    got = kern(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in args.items()})
    assert sk.SubstepKernel.launches == 0        # CPU: the plain version
    for name, g, j, atol in zip(sk.SUBSTEP_KEYS, got, jout, (1e-4, 1e-4, 1e-3, 1e-3)):
        assert g.shape == j.shape and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=atol, err_msg=name)
    # the contacts moved the pile
    assert np.abs(got[0].numpy() - args["pos"]).max() > 1e-4


def test_substep_plain_is_one_step_of_the_fused_loop(pile):
    """One substep of the fused plain version equals the integrate plus
    substep_plain: the two kernels share steps 2-9."""
    a = {k: torch.from_numpy(v) for k, v in pile.items()}
    tables = sk.pk.ObjTables(rb.default_object_manager())
    zero = torch.zeros_like(a["v"])
    fused = sk.fused_substep_plain(
        a["prev_pos"], a["prev_rot"], a["v"], a["w"], a["im"], a["ii"], a["mu_s"], a["mu_d"],
        a["obj"], zero, zero, a["dyn"], a["h"], torch.zeros((2, 3)),
        a["restitution_threshold"], a["rows_i"], a["rows_j"], a["kvalid"], tables=tables,
        num_substeps=1, relaxation=0.7)
    one = sk.substep_plain(fused["ps_pos"], fused["ps_rot"], fused["ps_v"], fused["ps_w"],
                           fused["prev_pos"], fused["prev_rot"], a["im"], a["ii"], a["mu_s"],
                           a["mu_d"], a["obj"], a["dyn"], a["h"], a["restitution_threshold"],
                           a["rows_i"], a["rows_j"], a["kvalid"], tables=tables,
                           relaxation=0.7)
    for k in sk.SUBSTEP_KEYS:
        assert torch.equal(fused[k], one[k]), k


# -- the joint solve -----------------------------------------------------------


def joint_inputs(seed, kind, W=3, n=9, J=6):
    rng = np.random.default_rng(seed)

    def unit_q(shape):
        q = rng.normal(size=shape + (4,)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    jt = {"fixed": np.zeros((W, J)), "hinge": np.ones((W, J)),
          "mixed": rng.integers(0, 2, (W, J))}[kind].astype(np.int32)
    joints = {"e1": np.zeros((W, J), np.int32), "e2": np.zeros((W, J), np.int32),
              "joint_type": jt, "attach_rot1": unit_q((W, J)), "attach_rot2": unit_q((W, J)),
              "separation": rng.uniform(0, 1, (W, J)).astype(np.float32)}
    for f in ("a1_local", "a2_local", "b1_local", "b2_local", "r1", "r2"):
        joints[f] = rng.normal(size=(W, J, 3)).astype(np.float32)
    rows1 = rng.integers(0, n, (W, J)).astype(np.int32)
    rows2 = ((rows1 + rng.integers(1, n, (W, J))) % n).astype(np.int32)
    rows2[0, 1] = -1                               # an invalid handle
    jmask = rng.random((W, J)) < 0.8
    jmask[0, 0] = True
    joints["attach_rot1"][~jmask] = np.nan         # garbage in dead rows
    body = dict(pos=rng.normal(size=(W, n, 3)).astype(np.float32), rot=unit_q((W, n)),
                inv_mass=rng.uniform(0, 2, (W, n)).astype(np.float32),
                inv_inertia=rng.uniform(0, 6, (W, n, 3)).astype(np.float32))
    body["inv_mass"][:, 0] = 0.0
    body["inv_inertia"][:, 0] = 0.0
    return body, joints, rows1, rows2, jmask


@pytest.mark.parametrize("kind", ["fixed", "hinge", "mixed"])
def test_solve_joints_matches_jax(kind):
    body, joints, rows1, rows2, jmask = joint_inputs(4, kind)
    jp, jr = jsolver.solve_joints(
        *(jnp.asarray(body[k]) for k in ("pos", "rot", "inv_mass", "inv_inertia")),
        {k: jnp.asarray(v) for k, v in joints.items()}, jnp.asarray(rows1), jnp.asarray(rows2),
        jnp.asarray(jmask), relaxation=0.7)
    t = torch.from_numpy
    pp, pr = solver.solve_joints(
        *(t(body[k]) for k in ("pos", "rot", "inv_mass", "inv_inertia")),
        {k: t(v) for k, v in joints.items()}, t(rows1), t(rows2), t(jmask), relaxation=0.7)
    assert np.isfinite(pp.numpy()).all() and np.isfinite(pr.numpy()).all()
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    assert np.abs(pp.numpy() - body["pos"]).max() > 1e-3        # the joints pulled
