"""The substep kernels' shared-memory layout and launch limits, on the CPU.

``ops/substep_kernel.py``'s ``smem_bytes`` and ``kernel_fits`` decide, before
any launch, whether the CUDA kernels take a shape.  These tests hold the
Python mirror to the layout that ``csrc/substep_kernels.cu`` states (its
``smem_bytes`` and channel constants, read from the source), and pin the
shapes the main paths launch and the limits that refuse the others.
"""

import re
from pathlib import Path

import pytest

from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk

CU = (Path(sk.__file__).resolve().parents[1] / "csrc" / "substep_kernels.cu").read_text()


def cu_constants():
    """The integer constants of the .cu's enums and constexprs."""
    out = {}
    for name, value in re.findall(r"\b(k\w+)\s*=\s*(\d+)\b", CU):
        out.setdefault(name, int(value))
    for name, other, div in re.findall(r"\b(k\w+)\s*=\s*(k\w+) / (\d+)\b", CU):
        out.setdefault(name, out[other] // int(div))
    return out


def cu_smem_bytes(n, K, bp, cache):
    """The .cu's smem_bytes, its float and int counts evaluated in Python,
    plus its static shared ints."""
    body = CU[CU.index("size_t smem_bytes("):]
    body = body[:body.index("\n}\n")]
    c = cu_constants()
    T = min(-(-max(n, K) // 32) * 32, c["kMaxThreads"])   # block_threads
    ks = (-(-K // T) - 1) * T                             # stash_slots
    env = dict(c, nn=n, kk=K, ks=ks, bp=bp, cache=cache)
    counts = {}
    for var in ("floats", "ints"):
        expr = re.search(rf"const size_t {var} = (.*?);", body, re.S).group(1)
        expr = re.sub(r"\((\w+) \? ([^:()]*(?:\([^()]*\)[^:()]*)*) : 0\)", r"(\2 if \1 else 0)",
                      " ".join(expr.split()))
        counts[var] = eval(expr, {}, env)
    static_ints = len(re.findall(r"__shared__ int \w+;", CU))
    return 4 * counts["floats"] + 4 * counts["ints"] + 4 * static_ints


def cu_substep_smem_bytes(n, K, J):
    """The .cu's substep_smem_bytes (kernel 5's window layout) evaluated in
    Python."""
    body = CU[CU.index("size_t substep_smem_bytes("):]
    body = body[:body.index("\n}\n")]
    c = cu_constants()
    ww = min(K, c["kWindow"])
    tt = min(-(-max(n, ww) // 32) * 32, c["kSubstepThreads"])   # substep_threads
    env = dict(c, nn=n, jj=J, ww=ww, tt=tt, ks=max(ww - tt, 0))
    counts = {var: eval(" ".join(re.search(rf"const size_t {var} = (.*?);", body, re.S)
                                 .group(1).split()), {}, env) for var in ("floats", "ints")}
    return 4 * counts["floats"] + 4 * counts["ints"]


@pytest.mark.parametrize("n,K,J", [(104, 1000, 64), (104, 1000, 0), (1, 1, 0), (8, 32, 4),
                                   (65, 256, 4), (200, 600, 10)])
def test_kernel5_smem_mirror_equals_the_cu_layout(n, K, J):
    assert sk.substep_smem_bytes(n, K, J) == cu_substep_smem_bytes(n, K, J)


def test_kernel5_limits_match_the_cu():
    c = cu_constants()
    assert sk.SUBSTEP_THREADS == c["kSubstepThreads"]
    assert sk.SUBSTEP_WINDOW == c["kWindow"]
    assert sk.JOINT_CH == c["kJointCh"]
    # an entry past the window: its pass channels, stash, two rows, two list entries
    assert sk.SCRATCH_CH == c["kScratchCh"] == c["kPackCh"] + c["kSlotCh"] + 4


@pytest.mark.parametrize("n,K", [(1, 1), (65, 128), (65, 256), (104, 1000), (127, 40)])
@pytest.mark.parametrize("bp,cache", [(False, False), (False, True), (True, False),
                                      (True, True)])
def test_smem_mirror_equals_the_cu_layout(n, K, bp, cache):
    assert sk.smem_bytes(n, K, bp, cache) == cu_smem_bytes(n, K, bp, cache)


def test_limits_match_the_cu():
    c = cu_constants()
    assert sk.MAX_BP_ROWS == c["kMaxBpRows"] == 32 * c["kBpWords"]
    assert sk.MAX_TABLE_VERTS == c["kMaxVerts"]
    assert sk.MAX_BOX_TABLE_VERTS == c["kMaxBoxVerts"]
    assert (sk.MAX_HULL_FACES, sk.MAX_HULL_SAT_AXES, sk.MAX_HULL_EDGE_DIRS,
            sk.MAX_HULL_FACE_VERTS, sk.MAX_HULL_FULL_EDGES) == (
        c["kMaxFaces"], c["kMaxSatAxes"], c["kMaxEdgeDirs"], c["kMaxFaceVerts"],
        c["kMaxFullEdges"])
    assert sk.OPT_HULL == c["kOptHull"]
    assert sk.MC_CACHE == c["kCacheCh"]
    assert sk.MAX_SMEM_BYTES == 227 * 1024
    assert sk.MAX_THREADS == c["kMaxThreads"]


@pytest.mark.parametrize("bp,cache", [(False, False), (False, True), (True, False),
                                      (True, True)])
def test_main_shapes_fit_with_every_option(bp, cache):
    """rigid_bench's 8192 x 65 rows at K = 256 and 128, with every option."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    for K in (256, 128):
        assert sk.kernel_fits(tables, 65, K, bp, cache) == ""


def test_single_substep_main_shape_fits():
    """simple_taskgraph's 104 rows at K = 1000 with its 64 joint rows (kernel
    5): within a third of an SM's 228 KB with the 1 KB a block reserves, so
    three worlds share an SM; the scratch holds the entries past the
    window."""
    tables = sk.pk.ObjTables(stg.OBJMGR)
    assert sk.kernel_fits(tables, 104, 1000, single=True, joints=64) == ""
    assert 3 * (sk.substep_smem_bytes(104, 1000, 64) + 1024) <= 228 * 1024
    scratch = sk.substep_scratch(3, 1000, "cpu")
    assert tuple(scratch.shape) == (3, sk.SCRATCH_CH, 1000 - sk.SUBSTEP_WINDOW)
    assert sk.substep_scratch(3, sk.SUBSTEP_WINDOW, "cpu") is None


@pytest.mark.parametrize("bp,cache", [(False, False), (True, True)])
def test_shared_memory_above_227_kb_is_refused(bp, cache):
    """The first K whose layout passes 227 KB is refused by name; the one
    below it fits."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    K = 1
    while sk.smem_bytes(65, K + 1, bp, cache) <= sk.MAX_SMEM_BYTES:
        K += 1
    assert sk.kernel_fits(tables, 65, K, bp, cache) == ""
    why = sk.kernel_fits(tables, 65, K + 1, bp, cache)
    assert "shared memory" in why and str(sk.MAX_SMEM_BYTES) in why


def test_hull_table_layout_matches_the_cu():
    """pairs.ObjTables.hull_table's row (hull_dims) is the .cu's Table::h
    layout: kHullHead counts, Fm faces of kFaceHead + kCornerFl FVm floats,
    3 Sm + 3 Em + 6 EFm floats (set_hull's check)."""
    import numpy as np
    c = cu_constants()
    om = dict(rb.default_object_manager())
    om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    tables = sk.pk.ObjTables(om)
    hs_, Fm, Sm, Em, FVm, EFm = tables.hull_dims()
    assert hs_ == (c["kHullHead"] + Fm * (c["kFaceHead"] + c["kCornerFl"] * FVm) + 3 * Sm
                   + 3 * Em + 6 * EFm)
    assert tuple(tables.hull_table("cpu").shape) == (tables.O, hs_)
    assert sk.pk.ObjTables(rb.default_object_manager()).hull_table("cpu") is None


def test_broadphase_above_128_rows_is_refused():
    tables = sk.pk.ObjTables(rb.default_object_manager())
    assert sk.kernel_fits(tables, 128, 128, bp=True) == ""
    why = sk.kernel_fits(tables, 129, 128, bp=True)
    assert "128 body rows" in why
    assert sk.kernel_fits(tables, 129, 128, bp=False) == ""
