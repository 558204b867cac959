"""The order in which kernel 4 sums a row's pushes, replayed on the CPU.

``csrc/simple_jobs_kernels.cu`` sums a row's pushes in a fixed tree
(``PushTree``): each 64-row chunk's partners in ascending b into the
chunk's partial, then the chunks' partials pairwise in chunk order (a
binary counter over the chunks, ``kRoundTreeLevels`` levels in the rounds
layout).  This replays that order in float32 on synthetic rows like a dense
stepped world's (~190 partners pushing one way, |sum| ~ 120-180) and holds
it against the push in float64: no farther than the plain version's sum
(``centred_pushes``), up to one float32 ulp of the sum (the last addition's
rounding, which no order avoids), and nearer than the partners added one
after another in ascending b, the order the kernel took before.
"""

import re
from pathlib import Path

import numpy as np
import torch

from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk

CU = (Path(sk.__file__).resolve().parents[1] / "csrc" / "simple_jobs_kernels.cu").read_text()
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", CU).group(1))
LEVELS = int(re.search(r"kRoundTreeLevels = (\d+);", CU).group(1))
N, ROWS, DEGREE = 2048, 48, 190


def world(seed):
    """One world of N bodies whose first ROWS rows each sit in a corner with
    DEGREE partners (random rows past ROWS) on one side of it: positions
    [N, 3] float32 and the overlap mask [N, N]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-40.0, 40.0, size=(N, 3)).astype(np.float32)
    ok = np.zeros((N, N), bool)
    for a in range(ROWS):
        corner = (9.5 + rng.uniform(0.0, 0.3, 3)).astype(np.float32)
        pos[a] = corner
        b = np.sort(rng.choice(np.arange(ROWS, N), DEGREE, replace=False))
        u = -np.abs(rng.normal(size=(DEGREE, 3)))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pos[b] = (corner + u * rng.uniform(0.2, 1.8, (DEGREE, 1))).astype(np.float32)
        ok[a, b] = True
    return pos, ok


def terms(pos, ok):
    """Each row's float32 push terms [ROWS, N, 3], m_ab (pc_b - pc_a), as the
    plain version (and the kernel) form them."""
    p = torch.from_numpy(pos)[None]
    pc = p - p.mean(dim=1, keepdim=True)
    diff = (pc[:, None, :, :] - pc[:, :, None, :])[0, :ROWS]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    m = torch.where(torch.from_numpy(ok[:ROWS]) & (d2 > 1e-12),
                    torch.rsqrt(d2.clamp(min=1e-30)), 0.0)
    return (m[..., None] * diff).numpy()


def ascending(t, partners):
    s = np.zeros(3, np.float32)
    for b in partners:
        s = s + t[b]
    return s


def tree(t, partners, levels=LEVELS):
    """PushTree's order: chunk partials in ascending b, a binary counter over
    the chunks, the levels left added from the lowest up, top last."""
    nc = -(-N // CHUNK)
    lv = [np.zeros(3, np.float32) for _ in range(levels)]
    top = np.zeros(3, np.float32)
    for k in range(nc):
        c = np.zeros(3, np.float32)
        for b in partners[(partners >= CHUNK * k) & (partners < CHUNK * (k + 1))]:
            c = c + t[b]
        for level in range(levels):
            if not (k >> level) & 1:
                lv[level] = c
                break
            c = lv[level] + c
        else:
            top = top + c
    s = np.zeros(3, np.float32)
    for level in range(levels):
        if (nc >> level) & 1:
            s = lv[level] + s
    if nc >> levels:
        s = top + s
    return s


def test_tree_order_against_float64():
    for seed in range(3):
        pos, ok = world(seed)
        t = terms(pos, ok)
        plain = (sk.centred_pushes(torch.from_numpy(pos)[None],
                                   torch.from_numpy(ok)[None])[0, :ROWS] / -2.0).numpy()
        p64 = pos.astype(np.float64)
        pc64 = p64 - p64.mean(axis=0)
        d64 = pc64[None, :, :] - pc64[:ROWS, None, :]
        d2 = (d64 * d64).sum(-1)
        m64 = np.where(ok[:ROWS] & (d2 > 1e-12), 1.0 / np.sqrt(np.maximum(d2, 1e-30)), 0.0)
        exact = (m64[..., None] * d64).sum(axis=1)
        err = {"tree": 0.0, "ascending": 0.0, "plain": 0.0}
        for r in range(ROWS):
            partners = np.nonzero(ok[r])[0]
            for name, got in (("tree", tree(t[r], partners)),
                              ("ascending", ascending(t[r], partners)), ("plain", plain[r])):
                err[name] = max(err[name], float(np.abs(got - exact[r]).max()))
        ulp = float(np.spacing(np.float32(np.abs(exact).max())))
        assert np.abs(exact).max() > 100.0
        assert err["tree"] <= err["plain"] + ulp, (seed, err, ulp)
        assert err["tree"] < err["ascending"] / 3.0, (seed, err)


def test_tree_order_depends_on_the_chunk_count_alone():
    # the same partial sums in another chunk layout: a tree of 2^L chunks or
    # fewer never reaches top, and adding more levels leaves such trees be
    rng = np.random.default_rng(7)
    t = rng.normal(size=(N, 3)).astype(np.float32)
    partners = np.sort(rng.choice(N, 300, replace=False))
    assert np.array_equal(tree(t, partners, LEVELS), tree(t, partners, LEVELS + 2))
    assert np.array_equal(tree(t, partners), tree(t, partners))


def test_stepped_gate_is_tight_and_shared():
    """chip_smoke.py gates the stepped translation against float64 at
    SJL_F64_ATOL, the card tests at the same value, no more than twice the
    largest distance of the plain version from float64 measured on an H100
    (1.71e-4; the gate was 1.25e-3 while the kernel added the pushes one
    after another)."""
    root = Path(sk.__file__).resolve().parents[2]
    smoke = re.search(r"^SJL_F64_ATOL = ([0-9.e-]+)$", (root / "chip_smoke.py").read_text(),
                      re.M)
    card = re.search(r"^SJ_STEPPED_F64_ATOL = ([0-9.e-]+)$",
                     (root / "tests" / "test_torch_cuda.py").read_text(), re.M)
    assert float(smoke.group(1)) == float(card.group(1)) <= 3.5e-4
