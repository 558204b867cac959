"""The simple_jobs kernel's launch shape and shared-memory layout, on the CPU.

``ops/simple_jobs_kernel.py`` mirrors what ``csrc/simple_jobs_kernels.cu``
launches: one CTA a world, its threads and its shared bytes.  These tests
hold the mirror to the .cu's constants, its ``block_threads`` and its
``smem_bytes`` (read from the source and evaluated here), and pin the shape
that the main path launches.
"""

import re
from pathlib import Path

import pytest

from gpu_ecs_madrona_tpu_torch.ops import simple_jobs_kernel as sk

CU = (Path(sk.__file__).resolve().parents[1] / "csrc" / "simple_jobs_kernels.cu").read_text()
SMEM_LIMIT = 232448        # a CTA's shared memory on an H100 (227 KB)


def cu_constants():
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", CU)}


def cu_smem_bytes(n0):
    """The .cu's smem_bytes(n0) evaluated in Python."""
    body = CU[CU.index("size_t smem_bytes(int n0)"):]
    body = body[:body.index("\n}\n")]
    env = dict(cu_constants(), n0=n0)
    for name, expr in re.findall(r"const size_t (\w+) =\s*(.*?);", body, re.S):
        expr = " ".join(expr.split()).replace("static_cast<size_t>", "").replace("/", "//")
        env[name] = eval(expr.replace("chunks(n0)", "(-(-n0 // kChunk))"), {}, env)
    return eval(re.search(r"return (.*?);", body).group(1).replace("/", "//"), {}, env)


def test_constants_match_the_cu():
    c = cu_constants()
    assert sk.MAX_BODIES == c["kMaxBodies"] == 1024
    assert sk.MAX_THREADS == c["kMaxThreads"] == 1024
    assert sk.MIN_THREADS == c["kMinThreads"] and sk.MIN_THREADS % 32 == 0
    assert sk.CHUNK == c["kChunk"] == 64          # two rows j a lane, 64-bit words
    assert sk.STAGE == c["kStage"] and sk.STAGE % 4 == 0
    assert sk.ZERO_BYTES == c["kZeroBytes"] and sk.ZERO_BYTES % 16 == 0
    assert c["kChunk"] % c["kUnit"] == 0


@pytest.mark.parametrize("n0", [1, 31, 37, 64, 65, 100, 129, 640, 1000, 1024])
def test_smem_mirror_equals_the_cu(n0):
    assert sk.smem_bytes(n0) == cu_smem_bytes(n0)


@pytest.mark.parametrize("n0", [1, 37, 100, 129, 950, 961, 1000, 1024])
def test_every_row_slot_has_a_thread(n0):
    """A compute thread a row slot (the bit grid's pad rows included), whole
    warps, a producer warp where it fits in 1024 threads, and the shared
    bytes within a CTA's limit."""
    np_ = -(-n0 // sk.CHUNK) * sk.CHUNK
    tc = sk.compute_threads(n0)
    assert tc % 32 == 0 and tc >= np_ and tc == max(sk.MIN_THREADS, np_)
    assert sk.block_threads(n0) == (tc + 32 if n0 <= 960 else tc) <= 1024
    assert sk.smem_bytes(n0) <= SMEM_LIMIT


def test_main_path_shape():
    # simple_jobs at 1024 worlds x 100 bodies: 128 row slots, 4 compute
    # warps and the producer warp a world; float4 lo, hi, position and a
    # half box a row slot, 2 KB of zeros, two 64-bit words a row slot, the
    # 512-slot stage, the warps' sums
    shape = sk.launch_shape(1024, 100)
    assert shape == {"ctas": 1024, "threads": 160, "smem": sk.smem_bytes(100)}
    assert sk.smem_bytes(100) == (16 * 4 * 128 + 2048 + 8 * 2 * 128
                                  + 4 * (5 * 512 + 160))
    # eight CTAs an SM fit its 228 KB (1 KB reserved a CTA): one wave at 1024 worlds
    assert 8 * (sk.smem_bytes(100) + 1024) <= 228 * 1024
