"""simple_jobs kernel cases, in numpy (no JAX; data only, no tests): shared by
tests/test_torch_simple_jobs.py (the plain version against the JAX kernel),
tests/test_torch_cuda.py and chip_smoke.py (the CUDA kernel against its
plain version).

Each maker returns (pos [W, n0, 3], rot [W, n0, 4] w-first) float32 arrays.
"""

import numpy as np


def bodies(seed, W, n0, half):
    """Cubes uniform in a box of half-width ``half`` about (0, 0, 5), some
    outside the simple_jobs bounds (the kernel clamps), random rotations."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (W, n0, 3)).astype(np.float32)
    pos[..., 2] += 5.0
    q = rng.normal(size=(W, n0, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return pos, q.astype(np.float32)


def touching_grid(W, nx, ny, nz):
    """Unrotated unit cubes on a lattice of spacing exactly 2.0: neighbours'
    AABBs meet on closed slabs (faces, edges and corners), so every
    neighbour pair sits on the overlap test's tie.  World w's lattice starts
    at (-4, -4, 2) + 0.1 w: world 0's coordinates are exact in half
    precision, the others' are not, so the kernel's half-precision filter
    has to round outward to keep the ties.  n0 = nx ny nz."""
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    lattice = np.stack([ix, iy, iz], -1).reshape(-1, 3).astype(np.float32) * np.float32(2.0)
    origin = np.array([-4.0, -4.0, 2.0], np.float32)
    pos = np.stack([(origin + np.float32(0.1 * w)) + lattice for w in range(W)])
    rot = np.zeros(pos.shape[:2] + (4,), np.float32)
    rot[..., 0] = 1.0
    return pos.astype(np.float32), rot


def dense_cluster(seed, W, n0):
    """Every cube within 0.5 of (0, 0, 5) on each axis: each overlaps all the
    others, so each row passes any degree cap below n0 - 1."""
    pos, rot = bodies(seed, W, n0, 0.5)
    return pos, rot
