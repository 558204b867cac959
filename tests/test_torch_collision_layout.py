"""The collision kernels' launch shapes and shared-memory layout, on the CPU.

``ops/collision_kernel.py`` mirrors what ``csrc/collision_kernels.cu``
launches: the grid path (one CTA a world) and the tiled path (one CTA a
world and 32-row block), their threads and their shared bytes.  These tests
hold the mirror to the .cu's constants and its ``grid_smem_bytes`` and
``tiled_smem_bytes`` (read from the source and evaluated here), and pin the
shapes that the main paths and the tiled timing launch.
"""

import re
from pathlib import Path

import pytest

from gpu_ecs_madrona_tpu_torch.ops import collision_kernel as ck

CU = (Path(ck.__file__).resolve().parents[1] / "csrc" / "collision_kernels.cu").read_text()


def cu_constants():
    """The .cu's integer constexprs, those divided by another included."""
    out = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", CU)}
    for name, other, div in re.findall(r"constexpr int (k\w+) = (k\w+) / (\d+);", CU):
        out[name] = out[other] // int(div)
    return out


def cu_bytes(func, **env):
    """The .cu's ``func`` (a shared-bytes formula of its one argument)
    evaluated in Python."""
    body = CU[CU.index(f"size_t {func}("):]
    body = body[:body.index("\n}\n")]
    env = dict(cu_constants(), **env)
    for name, expr in re.findall(r"const size_t (\w+) =\s*(.*?);", body, re.S):
        expr = " ".join(expr.split()).replace("static_cast<size_t>", "").replace("/", "//")
        env[name] = eval(expr.replace("chunks(n)", "(-(-n // kChunk))"), {}, env)
    ret = re.search(r"return (.*?);", body).group(1).replace("/", "//")
    return eval(ret, {}, env)


def test_constants_match_the_cu():
    c = cu_constants()
    assert ck.GRID_THREADS == c["kThreads"] and ck.GRID_WARPS == c["kWarps"]
    assert ck.TILED_THREADS == c["kTiledThreads"] and ck.TILED_WARPS == c["kTiledWarps"]
    assert ck.I_BLOCK == c["kIBlock"] == 32
    assert ck.GRID_MAX_ROWS == c["kGridMaxRows"]
    assert ck.CHUNK == c["kChunk"] == 64        # two rows j a lane, 64-bit words
    assert c["kChunk"] % c["kUnit"] == 0


@pytest.mark.parametrize("n", [1, 31, 32, 37, 64, 65, 108, 300, 640])
def test_grid_smem_mirror_equals_the_cu(n):
    assert ck.grid_smem_bytes(n) == cu_bytes("grid_smem_bytes", n=n)


@pytest.mark.parametrize("tile", [1, 32, 128, 1024])
def test_tiled_smem_mirror_equals_the_cu(tile):
    assert ck.tiled_smem_bytes(tile) == cu_bytes("tiled_smem_bytes", tile_j=tile)


def test_grid_path_takes_every_n_the_fused_kernel_takes():
    assert ck.fused_fits(ck.GRID_MAX_ROWS) and not ck.fused_fits(ck.GRID_MAX_ROWS + 1)
    # at the bound the bit grid alone passes 48 KB: the launch raises the
    # kernel's dynamic shared limit (allow_smem), within the card's 227 KB
    assert 48 * 1024 < ck.grid_smem_bytes(ck.GRID_MAX_ROWS) <= 227 * 1024
    assert (ck.GRID_MAX_ROWS // 64) * ck.GRID_MAX_ROWS * 8 > 48 * 1024


def test_main_path_shapes():
    # collisions at 8192 worlds: 108 rows (100 cubes + 8), both kernels on
    # the grid path, one CTA of 4 warps a world
    for kernel in ("fused", "pushes"):
        shape = ck.launch_shape(8192, 108, kernel)
        assert shape == {"path": "grid", "ctas": 8192, "threads": 128,
                         "smem": ck.grid_smem_bytes(108)}
    # 128 row slots (two 64-row chunks): float4 lo, hi, position and a
    # half box a row, two 64-bit words a row, a live index a row, four
    # segment counts, the centring's 4 x 3 warp sums
    assert ck.grid_smem_bytes(108) == (4 * (12 * 128 + 12) + 2 * 8 * 128 + 8 * 2 * 128
                                       + 4 * (128 + 4))


@pytest.mark.parametrize("W,n,force,tile,ctas", [(16, 1500, 0, 128, 752),
                                                 (16, 1500, 1024, 1024, 752),
                                                 (4, 700, 32, 32, 88),
                                                 (2, 1500, 1024, 1024, 94),
                                                 (64, 108, 32, 32, 256)])
def test_tiled_shapes(W, n, force, tile, ctas):
    shape = ck.launch_shape(W, n, "pushes", force)
    assert shape == {"path": "tiled", "tile_j": tile, "ctas": ctas, "threads": 256,
                     "smem": ck.tiled_smem_bytes(tile)}
    # kernel 3's timing shape: at least ~8 warps an SM on 132 SMs
    if (W, n) == (16, 1500):
        assert shape["ctas"] * shape["threads"] // 32 >= 8 * 132
