"""Tests of the port that need a CUDA card (marked ``cuda``; each skips
without one).  This file imports neither JAX nor the JAX package, so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Each CUDA kernel is held against its plain PyTorch version on the card
(lo/hi atol 1e-5, pushes atol 1e-4), and the collisions slice on the card
against the same slice on the CPU (plain versions), positions atol 1e-4.
"""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ck.fused_collisions_step.launches = 0
    ck.collision_pushes.launches = 0
    return torch.device("cuda")


def inputs(seed, W, n, half, dead, dev):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (W, n, 3)).astype(np.float32)
    q = rng.normal(size=(W, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((W, n), bool)
    mask[:, n - dead:] = False
    return (torch.from_numpy(pos).to(dev), torch.from_numpy(q).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("W,n", [(64, 108), (3, 300)])
def test_fused_collisions_step_matches_plain(card, W, n):
    pos, rot, mask = inputs(7, W, n, 10.0, 8, card)
    delta, lo, hi = ck.fused_collisions_step(pos, rot, mask)
    torch.cuda.synchronize()
    assert ck.fused_collisions_step.launches == 1
    plo, phi = ck.aabb_plain(pos, rot)
    torch.testing.assert_close(lo, plo, atol=1e-5, rtol=0)
    torch.testing.assert_close(hi, phi, atol=1e-5, rtol=0)
    want = ck.pushes_plain(pos, lo, hi, mask, center=False)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W,n,tile", [(64, 108, 0), (4, 700, 32), (2, 1500, 1024)])
def test_collision_pushes_matches_plain(card, W, n, tile):
    pos, _, mask = inputs(9, W, n, n ** (1 / 3) * 2.0, 5, card)
    lo, hi = pos - 1.0, pos + 1.0
    delta = ck.collision_pushes(pos, lo, hi, mask, force_tile=tile)
    torch.cuda.synchronize()
    assert ck.collision_pushes.launches == 1
    want = ck.collision_pushes_plain(pos, lo, hi, mask)
    torch.testing.assert_close(delta, want, atol=1e-4, rtol=0)
    assert (delta[~mask] == 0).all()


@pytest.mark.cuda
def test_wrappers_reject_bad_input(card):
    pos, rot, mask = inputs(1, 2, 16, 3.0, 2, card)
    with pytest.raises(ValueError):
        ck.fused_collisions_step(pos.double(), rot, mask)
    with pytest.raises(ValueError):
        ck.collision_pushes(pos.transpose(0, 1).contiguous().transpose(0, 1),
                            pos - 1, pos + 1, mask)
    with pytest.raises(ValueError):
        ck.collision_pushes(pos, pos - 1, pos + 1, mask.cpu())
    assert ck.collision_pushes.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused,use_kernel", [(True, False), (False, True), (False, False)],
                         ids=["fused", "pushes", "gram"])
def test_slice_on_card_matches_cpu(card, fused, use_kernel):
    """Five steps of the collisions slice on the card and on the CPU from
    the same state; kernel launches = steps on the card."""
    cfg = col.CollisionsConfig(num_worlds=8, num_objects=40, max_pairs=512, seed=5,
                               fused=fused, use_kernel=use_kernel)
    cpu = col.make_executor(cfg, device="cpu")
    gpu = col.make_executor(cfg, device="cuda")
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), card)
    for _ in range(5):
        cpu.step()
        gpu.step()
    torch.cuda.synchronize()
    launches = ck.fused_collisions_step.launches + ck.collision_pushes.launches
    assert launches == (5 if (fused or use_kernel) else 0)
    a, b = state_to_numpy(cpu.state), state_to_numpy(gpu.state)
    got = b["arch"]["CubeObject"]["comps"]["Translation"]["value"]
    want = a["arch"]["CubeObject"]["comps"]["Translation"]["value"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for name in ("CubeObject", "CollisionCandidate", "Contact"):
        np.testing.assert_array_equal(b["overflow"][name], a["overflow"][name])
        np.testing.assert_array_equal(b["arch"][name]["mask"], a["arch"][name]["mask"])
