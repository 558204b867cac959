"""simple_jobs past the one-block layout (kernel 4 at more than 1,024
bodies) in the port against the JAX package, on the CPU.

The JAX kernel has no bound on its body count; the port's kernel takes
such shapes in its rounds layout, whose plain version is what the port
runs here.  Tolerances as tests/test_torch_simple_jobs.py's: integers
exact, AABBs atol 1e-5, normals 1e-5, the translation 1e-4 for one call
and 1e-3 on the fused model path.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.models import simple_jobs as jsj
from gpu_ecs_madrona_tpu.ops import simple_jobs_kernel as jk
from gpu_ecs_madrona_tpu_torch.models import simple_jobs as sj
from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk

import test_torch_simple_jobs as base
import test_torch_simple_jobs_cases as cases

BOUNDS = (sj.BOUNDS_LO, sj.BOUNDS_HI)
NAMES = ("translation", "lo", "hi", "ab", "normals", "counts", "dropped")
ATOL = {"translation": 1e-4, "lo": 1e-5, "hi": 1e-5, "normals": 1e-5}


@pytest.mark.parametrize("n0", [1100, pytest.param(1536, marks=pytest.mark.slow)])
def test_kernel_plain_past_one_block_matches_jax_interpret(n0):
    """W = 1 world of n0 cubes over the example's bounds, K = 16 n0 slots,
    D = 32: the port's plain version (the rounds layout's on the card)
    against the JAX kernel in interpret mode.  The world is dense enough
    that rows pass the degree cap."""
    assert sk.rounds(n0) and sk.fused_fits(n0)
    pos, rot = cases.bodies(11, 1, n0, 10.0)
    K, D = 16 * n0, 32
    want = [np.asarray(x) for x in jk.fused_simple_jobs_step(
        pos, rot, n0=n0, K=K, degree_cap=D, bounds=BOUNDS, interpret=True)]
    got = [x.numpy() for x in sk.fused_simple_jobs_step(
        torch.from_numpy(pos), torch.from_numpy(rot), n0=n0, K=K, degree_cap=D,
        bounds=BOUNDS)]
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ATOL:
            np.testing.assert_allclose(g, w, atol=ATOL[name], rtol=0, err_msg=name)
            assert np.isfinite(g).all(), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(want[5][0]) > 1000 and int(want[6][0]) > 0   # many pairs, some dropped


def test_fused_model_past_one_block_matches_jax():
    """simple_jobs with fused=True at 1,100 objects (one world, K = 17,600,
    D = 32): two steps of the port's fused node (the kernel's plain version
    here) against JAX's (its Pallas kernel in interpret mode), each from
    JAX's state before it, every leaf compared.  (Carried over two steps,
    the two push sums' orders move the positions by up to ~1e-3, and the
    next step's normals by more than their 1e-5 in this dense world.)"""
    n0 = 1100
    d = dict(num_worlds=1, num_objects=n0, max_pairs=16 * n0, degree_cap=32, seed=5,
             fused=True)
    jsim = jsj.make_executor(jsj.SimpleJobsConfig(**d), donate=False)
    psim = sj.make_executor(sj.SimpleJobsConfig(**d), device="cpu")
    assert psim.graph.node_names == ["fused_step"]
    for t in range(2):
        psim.state = base.converted(jsim)
        jsim.step()
        psim.step()
        base.assert_states_match(jsim.state, psim.state, 1e-3, f"fused n0={n0} step {t + 1}")
    ab = np.asarray(jax.device_get(jsim.state["user"]["contacts_ab"]))
    assert (ab != 0).any(-1).sum() > 1000
