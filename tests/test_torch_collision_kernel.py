"""The port's collision kernels (ops/collision_kernel.py) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_ops.py runs
them.  On the CPU the wrappers take their plain versions and count no
launch (tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card).  Tolerances: pushes atol 1e-4
(tests/test_ops.py:30,111), AABBs atol 1e-5.
"""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.ops import collision_kernel as jk
from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck


def box_inputs(seed, W, n, half, extent, dead):
    """Positions uniform in [-half, half]^3, AABBs pos -+ extent, the last
    ``dead`` rows of every world dead."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (W, n, 3)).astype(np.float32)
    mask = np.ones((W, n), bool)
    if dead:
        mask[:, -dead:] = False
    return pos, pos - extent, pos + extent, mask


def quats(seed, W, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(W, n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(autouse=True)
def counters():
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0


CASES = {
    # name: (seed, W, n, half, extent, dead, force_tile)
    "padding": (3, 4, 37, 5.0, 1.3, 5, 0),        # test_ops.py:22-30
    "tiled": (11, 2, 200, 5.0, 0.8, 7, 128),      # test_ops.py:63-73
    "dead_rows": (5, 2, 16, 1.0, 2.0, 12, 0),     # test_ops.py:33-42
}


@pytest.mark.parametrize("case", list(CASES))
def test_collision_pushes_matches_jax(case):
    seed, W, n, half, extent, dead, tile = CASES[case]
    pos, lo, hi, mask = box_inputs(seed, W, n, half, extent, dead)
    want = np.asarray(jk.collision_pushes(pos, lo, hi, mask, interpret=True,
                                          force_tile=tile))
    got = ck.collision_pushes(*t(pos, lo, hi, mask), force_tile=tile).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.isfinite(got).all()
    assert (got[~mask] == 0).all()  # dead rows receive no pushes
    assert ck.collision_pushes.launches == 0


def test_collision_pushes_close_pair():
    """A near-coincident pair at |x| ~ 50 gets a unit-normal push of
    magnitude 2, not a cancellation explosion (test_ops.py:80-91)."""
    pos = np.zeros((1, 2, 3), np.float32)
    pos[0, 0] = [50.0, 50.0, 50.0]
    pos[0, 1] = [50.02, 50.0, 50.0]
    lo, hi, mask = pos - 0.5, pos + 0.5, np.ones((1, 2), bool)
    want = np.asarray(jk.collision_pushes(pos, lo, hi, mask, interpret=True,
                                          force_tile=128))
    got = ck.collision_pushes(*t(pos, lo, hi, mask)).numpy()
    assert abs(np.linalg.norm(got[0, 0]) - 2.0) < 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_collisions_step_matches_jax(seed):
    W, n = 4, 24
    pos, _, _, mask = box_inputs(seed, W, n, 4.0, 1.0, 3)
    rot = quats(seed + 100, W, n)
    wd, wlo, whi = (np.asarray(x) for x in jk.fused_collisions_step(
        pos, rot, mask, interpret=True))
    delta, lo, hi = (x.numpy() for x in ck.fused_collisions_step(*t(pos, rot, mask)))
    np.testing.assert_allclose(lo, wlo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(hi, whi, atol=1e-5, rtol=0)
    np.testing.assert_allclose(delta, wd, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()
    assert np.abs(delta).max() > 0  # the case has overlapping pairs
    assert ck.fused_collisions_step.launches == 0


def test_fused_bound_raises():
    n = 800  # n_pad = 896: 896^2 * 12 B > 6 MB
    z = torch.zeros((1, n, 3))
    with pytest.raises(ValueError):
        ck.fused_collisions_step(z, torch.zeros((1, n, 4)), torch.ones((1, n), dtype=torch.bool))
