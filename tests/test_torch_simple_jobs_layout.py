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


def cu_size(fn, n0, _memo=None):
    """The .cu's host function ``fn(int n0)`` (smem_bytes,
    rounds_smem_bytes, rounds_scratch_bytes and the functions they call)
    evaluated in Python: its ``const size_t`` lines in order, then its
    return, each call of another such function replaced by its value."""
    memo = {} if _memo is None else _memo
    if fn in memo:
        return memo[fn]
    start = re.search(r"\b%s\((int n0)?\) \{" % fn, CU)
    body = CU[start.end():]
    body = body[:body.index("\n}\n")]
    env = dict(cu_constants(), n0=n0)

    def py(expr):
        expr = " ".join(expr.split())
        expr = re.sub(r"static_cast<\w+>", "", expr).replace("/", "//")
        for call in set(re.findall(r"\b(\w+)\((?:n0)?\)", expr)):
            if call == "chunks":
                continue
            expr = re.sub(r"\b%s\((n0)?\)" % call, str(cu_size(call, n0, memo)), expr)
        expr = expr.replace("chunks(n0)", "(-(-n0 // kChunk))")
        if "?" in expr and expr.startswith("(") and expr.endswith(")"):
            expr = expr[1:-1]
        return re.sub(r"^(.*?) \? (.*?) : (.*)$", r"(\2) if (\1) else (\3)", expr)

    for name, expr in re.findall(r"const size_t (\w+) =\s*(.*?);", body, re.S):
        env[name] = eval(py(expr), {}, env)
    memo[fn] = eval(py(re.search(r"return (.*?);", body, re.S).group(1)), {}, env)
    return memo[fn]


def cu_smem_bytes(n0):
    """The .cu's smem_bytes(n0) evaluated in Python."""
    return cu_size("smem_bytes", n0)


def test_constants_match_the_cu():
    c = cu_constants()
    assert sk.MAX_BODIES == c["kMaxBodies"] == 1024   # the one-block layout's last
    assert sk.MAX_THREADS == c["kMaxThreads"] == 1024
    assert sk.ROUND_THREADS == c["kRoundThreads"] == sk.MAX_THREADS   # every warp computes
    assert sk.BLOCK_ROWS == c["kBlockRows"] and sk.BLOCK_ROWS % 32 == 0
    assert sk.MIN_BLOCK_ROWS == c["kMinBlockRows"] and sk.UNIT == c["kUnit"]
    assert sk.MAX_SMEM == c["kMaxSmem"] == SMEM_LIMIT
    assert sk.MIN_THREADS == c["kMinThreads"] and sk.MIN_THREADS % 32 == 0
    assert sk.CHUNK == c["kChunk"] == 64          # two rows j a lane, 64-bit words
    assert sk.STAGE == c["kStage"] and sk.STAGE % 4 == 0
    assert sk.ZERO_BYTES == c["kZeroBytes"] and sk.ZERO_BYTES % 16 == 0
    assert c["kChunk"] % c["kUnit"] == 0


@pytest.mark.parametrize("n0", [1, 31, 37, 64, 65, 100, 129, 640, 1000, 1024])
def test_smem_mirror_equals_the_cu(n0):
    assert sk.smem_bytes(n0) == cu_smem_bytes(n0)


@pytest.mark.parametrize("n0", [1, 37, 100, 129, 950, 961, 1000, 1024, 1025, 2048, 3776, 3777, 3584,
                                3585, 4096, 10000])
def test_every_row_slot_has_a_thread(n0):
    """Up to 1024 bodies a compute thread a row slot (the bit grid's pad
    rows included), whole warps and a producer warp where it fits in 1024
    threads; past it 992 compute threads take the row slots in rounds
    beside the producer warp.  The shared bytes stay within a CTA's limit
    at every n0, the rows moving to the global scratch past 3584 bodies."""
    np_ = -(-n0 // sk.CHUNK) * sk.CHUNK
    tc = sk.compute_threads(n0)
    assert tc % 32 == 0 and sk.fused_fits(n0)
    if n0 <= sk.MAX_BODIES:
        assert not sk.rounds(n0) and tc >= np_ and tc == max(sk.MIN_THREADS, np_)
        assert sk.block_threads(n0) == (tc + 32 if n0 <= 960 else tc) <= 1024
        assert sk.smem_bytes(n0) <= SMEM_LIMIT and sk.scratch_bytes(n0) == 0
    else:
        assert sk.rounds(n0) and tc == sk.ROUND_THREADS and sk.block_threads(n0) == 1024
        assert sk.rounds_smem_bytes(n0) <= SMEM_LIMIT
        # the rows stay in shared memory beside a block of 64 rows' words up
        # to 3,776 bodies; a block's words stay there at every count here
        assert sk.rounds_rows_shared(n0) == (n0 <= 3776) and sk.rounds_words_shared(n0)
        R = sk.rounds_block_rows(n0)
        assert R % sk.CHUNK == 0 and sk.MIN_BLOCK_ROWS <= R <= 256
        ncp = -(-n0 // sk.CHUNK) | 1
        assert sk.rounds_smem_bytes(n0) == ((48 * np_ if n0 <= 3776 else 0) + 8 * R * ncp
                                            + sk.rounds_fixed_bytes())
        lower = 8 * (np_ // sk.CHUNK) * np_      # the lower triangle's words
        assert sk.scratch_bytes(n0) == lower + (0 if n0 <= 3776 else 48 * np_)
        assert sk.scratch_bytes(n0) % 16 == 0


@pytest.mark.parametrize("n0", [1025, 1100, 2048, 3776, 3777, 3584, 3585, 4096, 10000, 30000,
                                200000])
def test_rounds_layout_mirror_equals_the_cu(n0):
    assert sk.rounds_smem_bytes(n0) == cu_size("rounds_smem_bytes", n0)
    assert sk.scratch_bytes(n0) == cu_size("rounds_scratch_bytes", n0)
    assert sk.rounds_block_rows(n0) == cu_size("rounds_block_rows", n0)
    assert sk.rounds_rows_shared(n0) == bool(cu_size("rounds_rows_shared", n0))
    assert sk.rounds_words_shared(n0) == bool(cu_size("rounds_words_shared", n0))


def test_main_path_shape():
    # simple_jobs at 1024 worlds x 100 bodies: 128 row slots, 4 compute
    # warps and the producer warp a world; float4 lo, hi, position and a
    # half box a row slot, 2 KB of zeros, two 64-bit words a row slot, the
    # 512-slot stage, the warps' sums
    shape = sk.launch_shape(1024, 100)
    assert shape == {"ctas": 1024, "threads": 160, "smem": sk.smem_bytes(100), "scratch": 0}
    assert sk.smem_bytes(100) == (16 * 4 * 128 + 2048 + 8 * 2 * 128
                                  + 4 * (5 * 512 + 160))
    # eight CTAs an SM fit its 228 KB (1 KB reserved a CTA): one wave at 1024 worlds
    assert 8 * (sk.smem_bytes(100) + 1024) <= 228 * 1024


def test_large_cell_shape():
    # main_simple_jobs_large, 1024 worlds x 2048 bodies: the rounds layout,
    # 1024 threads (32 warps, all computing), the rows in shared memory (16
    # bytes x 3 a row slot), a block of 256 rows' overlap words (33 u64 a
    # row), each warp's slot stage, the block's degrees and bases, the
    # warps' sums; the global scratch holds the lower triangle's words (0.5
    # GB at 1024 worlds, written once and read once)
    shape = sk.launch_shape(1024, 2048)
    assert shape["threads"] == 1024
    assert sk.rounds_block_rows(2048) == 256
    assert shape["smem"] == (16 * 3 * 2048 + 8 * 256 * 33
                             + 4 * (32 * 128 + 2 * 256 + 32 * 3 + 32 * 2)) <= SMEM_LIMIT
    assert shape["scratch"] == 1024 * 8 * 32 * 2048 == 512 * 2 ** 20   # the lower triangle
