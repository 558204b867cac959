"""Contact refresh on a pile past one block's shared memory, in the port
against the JAX package (CPU).

rigid_bench at 2 worlds x 200 boxes + the plane (201 rows, K = 800) with
contact_refresh: the fused kernel's slot layout with the manifold cache
needs 301,996 B, past the 227 KB of one block (its ceiling there is 160
bodies), so on the card the kernel runs its windowed "refresh+win"
specialisation, bit for bit its plain version (tests/test_torch_cuda.py).

  - the port's "auto" (the fused kernel's plain version, sap) against JAX's
    "pairs" mode from one JAX-initialised state at one substep a step, where
    the refresh builds its cache from the substep's fresh contacts and
    moves nothing: one step (positions, rotations and pose stashes atol
    1e-4, velocities atol 1e-3, AABBs 1e-5, overflow exact) and ten steps
    (positions atol 1e-3, velocities 1e-2), one JAX executor (one compile,
    module fixture);
  - at two substeps, where the second substep moves the cached manifold
    with the bodies, the plain version against JAX's fused kernel with
    contact refresh (interpret mode, one world a block) on the port's state
    after 3 steps: positions, rotations and pose stashes atol 1e-4,
    velocities atol 1e-3 (``slow``: JAX's chunked kernel at K = 800 runs
    ~3 minutes interpreted on the CPU).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_ecs_madrona_tpu.ops.substep_kernel import FusedSubstepKernel as JFusedSubstepKernel

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk

from test_torch_large_piles import assert_one_step, assert_steps, jax_pile, port_run, port_sim

PILE = dict(num_worlds=2, num_bodies=200, num_substeps=1, body_mix="boxes", seed=0)
STEPS = 10
POSE_KEYS = ("pos", "rot", "prev_pos", "prev_rot", "ps_pos", "ps_rot")


@pytest.fixture(scope="module")
def jax_run():
    return jax_pile(PILE, STEPS)


def test_refresh_pile_takes_the_windowed_layout():
    """201 rows at K = 800 with the manifold cache pass one block's shared
    memory; the windowed layout takes them."""
    tables = sk.pk.ObjTables(rb.RigidBenchWorld.objmgr)
    n, K = PILE["num_bodies"] + 1, 4 * PILE["num_bodies"]
    assert sk.smem_bytes(n, K, cache=True) == 301996 > sk.MAX_SMEM_BYTES
    assert sk.windowed(tables, n, K, cache=True) and sk.kernel_fits(tables, n, K,
                                                                  cache=True) == ""


def test_refresh_pile_one_step_matches_jax_pairs(jax_run):
    assert_one_step(jax_run[1], port_run(jax_run[0], 1, PILE, contact_refresh=True))


def test_refresh_pile_ten_steps_match_jax_pairs(jax_run):
    assert_steps(jax_run[STEPS], port_run(jax_run[0], STEPS, PILE, contact_refresh=True))


@pytest.mark.slow
def test_refresh_two_substeps_matches_jax_fused_kernel():
    sim = port_sim(PILE, num_substeps=2, body_mix="alternate", contact_refresh=True)
    sim.run(3)
    kw = phys.RigidBodyPhysicsSystem.next_step_kernel_inputs(sim, rb.Body,
                                                             rb.RigidBenchWorld.objmgr)
    assert int(kw["kvalid"].sum()) > 0
    kern = sk.FusedSubstepKernel(rb.RigidBenchWorld.objmgr, 2, relaxation=0.7,
                                 contact_refresh=True)
    want = kern.plain(**kw)
    jkern = JFusedSubstepKernel(rb.RigidBenchWorld.objmgr, 2, relaxation=0.7, interpret=True,
                                wt=1, contact_refresh=True)
    im, ii, mu_s, mu_d = sk.object_columns(kw["obj"], kw["dyn"], kern.tables)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in dict(kw, im=im, ii=ii, mu_s=mu_s,
                                                          mu_d=mu_d).items()}
    got = jkern(**jkw)
    for k in sk.OUT_KEYS:
        np.testing.assert_allclose(want[k].numpy(), np.asarray(got[k]), rtol=0,
                                   atol=1e-4 if k in POSE_KEYS else 1e-3, err_msg=k)
