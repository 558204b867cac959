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

CSRC = Path(sk.__file__).resolve().parents[1] / "csrc"
CU = (CSRC / "substep_kernels.cu").read_text()


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
    # all-box tables past a box's verts a hull take the wide-box build of
    # the same source (its box-plane candidates merged as they come), whose
    # library the wrapper picks for them: no table's verts are capped
    assert sk.BOX_VERTS == c["kMaxBoxVerts"] == 8
    assert not hasattr(sk, "MAX_BOX_TABLE_VERTS")
    wide = (CSRC / "substep_wide_box_kernels.cu").read_text()
    assert "#define SUBSTEP_WIDE_BOX" in wide and '#include "substep_kernels.cu"' in wide
    assert "return kWideBox || tab.vm <= kMaxBoxVerts;" in CU
    # no general-hull table count is capped: only the shared memory is
    assert "kMaxVerts" not in c and "kMaxFullEdges" not in c
    assert sk.OPT_HULL == c["kOptHull"]
    assert sk.MC_CACHE == c["kCacheCh"]
    assert sk.MAX_SMEM_BYTES == 227 * 1024 == c["kMaxSmem"]
    assert sk.MAX_THREADS == c["kMaxThreads"]


def hull_tables(which):
    """The imported prism's tables, or the 24-sided prism's."""
    import test_torch_hull_scenes as hs
    from gpu_ecs_madrona_tpu_torch.physics import assets
    from gpu_ecs_madrona_tpu_torch.utils import importer
    make = hs.large_hull_object_manager if which == "large" else hs.hull_object_manager
    return sk.pk.ObjTables(make(assets, importer))


@pytest.mark.parametrize("which", ["prism", "large"])
def test_hull_stage_mirror_equals_the_cu(which):
    """hull_stage_floats is the .cu's hull_stride at the table's counts
    (its world vertices, edge directions and SAT axes, 3 floats each, and
    faces, 4)."""
    body = CU[CU.index("int hull_stride("):]
    expr = re.search(r"return (.*?);", body).group(1)
    tables = hull_tables(which)
    _, Fm, Sm, Em, _, _ = tables.hull_dims()
    want = eval(expr, {}, dict(vm=tables.Vm, em=Em, sm=Sm, fm=Fm))
    assert sk.hull_stage_floats(tables) == want
    assert sk.hull_stage_bytes(tables, 65) == 4 * 65 * want
    assert sk.hull_stage_floats(sk.pk.ObjTables(rb.default_object_manager())) == 0


def test_prism_hull_twin_fits_kHullBlocks_ctas_an_sm():
    """At the imported prism's main shape (65 rows, K = 256) the general-
    hull twin of "none" stages its rows beside the box layout and still fits
    the kHullBlocks CTAs an SM it is compiled for (228 KB an SM, 1 KB a
    block reserved)."""
    c = cu_constants()
    tables = hull_tables("prism")
    need = sk.smem_bytes(65, 256) + sk.hull_stage_bytes(tables, 65)
    assert c["kHullBlocks"] * (need + 1024) <= 228 * 1024
    assert sk.kernel_fits(tables, 65, 256) == ""


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
    """The first K whose slot layout passes 227 KB: with the in-kernel
    broadphase it is refused by name; without it the kernel takes it in its
    windowed layout.  The K below it fits the slot layout."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    K = 1
    while sk.smem_bytes(65, K + 1, bp, cache) <= sk.MAX_SMEM_BYTES:
        K += 1
    assert sk.kernel_fits(tables, 65, K, bp, cache) == ""
    assert not sk.windowed(tables, 65, K, bp, cache)
    why = sk.kernel_fits(tables, 65, K + 1, bp, cache)
    if bp:
        assert "shared memory" in why and str(sk.MAX_SMEM_BYTES) in why
    else:
        assert why == "" and sk.windowed(tables, 65, K + 1, bp, cache)


def cu_window_smem_bytes(n, kw, T, cache):
    """The .cu's fused_window_smem_bytes, its float and int counts evaluated
    in Python."""
    body = CU[CU.index("size_t fused_window_smem_bytes("):]
    body = body[:body.index("\n}\n")]
    env = dict(cu_constants(), nn=n, ww=kw, ks=max(kw - T, 0), cache=cache)
    counts = {}
    for var in ("floats", "ints"):
        expr = " ".join(re.search(rf"const size_t {var} = (.*?);", body, re.S).group(1).split())
        expr = re.sub(r"\((\w+) \? (\w+) : 0\)", r"(\2 if \1 else 0)", expr)
        counts[var] = eval(expr, {}, env)
    return 4 * counts["floats"] + 4 * counts["ints"]


@pytest.mark.parametrize("n,kw,T", [(256, 378, 128), (256, 1020, 128), (512, 695, 128),
                                    (201, 40, 128), (9, 5, 32)])
@pytest.mark.parametrize("cache", [False, True])
def test_window_smem_mirror_equals_the_cu_layout(n, kw, T, cache):
    assert sk.fused_window_smem_bytes(n, kw, T, cache) == cu_window_smem_bytes(n, kw, T, cache)


def test_window_limits_match_the_cu():
    """The windowed layout's option bit, its CTAs an SM, an SM's shared
    memory and a block's reservation, and its scratch channels (kernel 5's
    an entry, and the manifold cache's after them)."""
    c = cu_constants()
    assert sk.OPT_WIN == c["kOptWin"]
    assert sk.WIN_BLOCKS == c["kWinBlocks"] == 2
    assert sk.SM_SMEM_BYTES == c["kSmSmem"] == 228 * 1024
    assert sk.CTA_RESERVED_BYTES == c["kCtaReserved"]
    assert sk.WIN_CACHE_CH == c["kWinCacheCh"] == c["kScratchCh"] + c["kCacheCh"]


# rigid_bench piles past one block's shared memory, K = 4 x bodies: (bodies,
# the manifold cache, the window that lets two CTAs share an SM or the most
# one CTA holds)
WINDOW_SHAPES = {"boxes_239": (239, False, 398), "boxes_255": (255, False, 378),
                 "boxes_511": (511, False, 695), "refresh_200": (200, True, 259),
                 "refresh_255": (255, True, 220)}


@pytest.mark.parametrize("case", sorted(WINDOW_SHAPES))
def test_kernel_fits_takes_the_piles_past_one_block(case):
    """kernel_fits takes rigid_bench at 239, 255 and 511 bodies (and 200
    and 255 with contact refresh) in the windowed layout: its window and
    scratch as stated, within the CTAs an SM it aims at (228 KB an SM, 1 KB
    a block reserved), or one CTA's 227 KB where the bodies leave no room
    for two."""
    bodies, cache, window = WINDOW_SHAPES[case]
    tables = sk.pk.ObjTables(rb.default_object_manager())
    n, K = bodies + 1, 4 * bodies
    assert sk.smem_bytes(n, K, cache=cache) > sk.MAX_SMEM_BYTES
    assert sk.windowed(tables, n, K, cache=cache) and sk.kernel_fits(tables, n, K,
                                                                     cache=cache) == ""
    assert sk.fused_window(n, K, cache) == window < K
    need = sk.fused_window_smem_bytes(n, window, sk.block_threads(n, K), cache)
    ctas = 1 if bodies == 511 else 2
    assert ctas * (need + 1024) <= 228 * 1024 and need <= sk.MAX_SMEM_BYTES
    assert sk.fused_window_smem_bytes(n, window + 1, sk.block_threads(n, K), cache) > (
        228 * 1024 // ctas - 1024 if ctas == 2 else sk.MAX_SMEM_BYTES)
    scratch = sk.fused_scratch(3, K, window, cache, "cpu")
    assert sk.fused_scratch(3, K, K, cache, "cpu") is None
    assert tuple(scratch.shape) == (3, sk.WIN_CACHE_CH if cache else sk.SCRATCH_CH, K - window)
    # the broadphase inside the kernel does not take the window
    assert not sk.windowed(tables, 128, K, bp=True, cache=cache)


@pytest.mark.parametrize("cache,ceiling", [(False, 968), (True, 894)])
def test_windowed_body_ceiling_is_refused_by_name(cache, ceiling):
    """The windowed layout's ceiling: the bodies whose rows leave room for
    its smallest window (a round of the block's 128 threads) beside them.
    Up to it the shapes keep the windowed layout; one body more, which it
    refused by its window budget's name, and 1,023 bodies (1,024 rows) now
    take the bodies in the scratch, with a window that lets WIN_BLOCKS CTAs
    share an SM."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    n, K = ceiling + 1, 4 * ceiling
    assert sk.kernel_fits(tables, n, K, cache=cache) == ""
    assert sk.windowed(tables, n, K, cache=cache) and not sk.fused_bodies(tables, n, K,
                                                                          cache=cache)
    assert sk.fused_layout_window(tables, n, K, cache) == sk.fused_window(n, K, cache) >= 128
    for bodies in (ceiling + 1, 1023):
        n, K = bodies + 1, 4 * bodies
        assert sk.fused_window(n, K, cache) == 0
        assert sk.kernel_fits(tables, n, K, cache=cache) == ""
        assert sk.fused_bodies(tables, n, K, cache=cache)
        kw = sk.fused_layout_window(tables, n, K, cache)
        assert kw == sk.body_window(n, K, cache) > 128
        T = sk.block_threads(n, K)
        budget = 228 * 1024 // sk.WIN_BLOCKS - 1024
        assert sk.body_window_smem_bytes(n, kw, T, cache) <= budget
        assert sk.body_window_smem_bytes(n, kw + 1, T, cache) > budget


def cu_return_expr(name):
    """The expression a one-line .cu function ``name`` returns, with its
    casts and sizeofs taken out (every sizeof there is of a 4-byte type)."""
    body = CU[CU.index(f" {name}("):]
    expr = re.search(r"return (.*?);", body[:body.index("\n}\n")], re.S).group(1)
    expr = re.sub(r"static_cast<\w+>\((\w+)\)", r"\1", " ".join(expr.split()))
    return expr.replace("sizeof(float)", "4").replace("sizeof(int)", "4")


@pytest.mark.parametrize("which", ["boxes", "prism", "large"])
@pytest.mark.parametrize("n", [1, 65, 816, 1024])
def test_body_scratch_mirror_equals_the_cu(which, n):
    """body_bytes and body_scratch_floats are the .cu's: the rows, lists'
    offsets and cursors the window layouts keep in shared memory, and a
    world's slice of the body scratch (with the staged hull rows)."""
    c = cu_constants()
    tables = (sk.pk.ObjTables(rb.default_object_manager()) if which == "boxes"
              else hull_tables(which))
    env = dict(c, nn=n, hull_stride=sk.hull_stage_floats(tables))
    assert sk.body_bytes(n) == eval(cu_return_expr("body_bytes"), {}, env)
    assert sk.body_scratch_floats(n, tables) == eval(cu_return_expr("body_scratch_floats"), {},
                                                     env)
    scratch = sk.body_scratch(3, n, tables, "cpu")
    assert scratch.dtype == sk.torch.float32
    assert tuple(scratch.shape) == (3, sk.body_scratch_floats(n, tables))


def test_body_layout_limits_match_the_cu():
    """The bodies-in-scratch option bit, its body channels, and the budget
    its window is sized for: WIN_BLOCKS CTAs an SM, each the SM's 228 KB
    shared less the 1 KB a block reserves."""
    c = cu_constants()
    assert sk.OPT_BODY == c["kOptBody"] == 64
    assert sk.BODY_CH == c["kBodyCh"]
    assert sk.option_name(sk.OPT_WIN | sk.OPT_BODY | sk.OPT_REFRESH | sk.OPT_HULL) == (
        "refresh+win+bodies+hull")
    body = CU[CU.index(" body_window("):]
    budget = re.search(r"const size_t budget = (.*?);", body[:body.index("\n}\n")]).group(1)
    assert eval(budget.replace("/", "//"), {}, c) == 228 * 1024 // 2 - 1024


# kernel 5's shapes about its window layout's ceiling: (rows, K, joints,
# the bodies in the scratch)
KERNEL5_SHAPES = [(799, 1000, 64, False), (800, 1000, 64, True), (815, 1000, 0, False),
                  (816, 1000, 0, True), (1004, 10000, 64, True), (1068, 10640, 64, True)]


@pytest.mark.parametrize("n,K,J,bodies", KERNEL5_SHAPES)
def test_kernel5_takes_the_bodies_in_scratch_past_its_window_layout(n, K, J, bodies):
    """Kernel 5 keeps its window layout while it fits one block (799 rows
    with simple_taskgraph's 64 joint rows, 815 without joints) and takes
    the bodies in the scratch past it: simple_taskgraph at 1,000 objects
    (1,004 rows, K = 10,000) among them, whose shared memory is then the
    window and the joints, ~50 KB."""
    tables = sk.pk.ObjTables(stg.OBJMGR)
    assert sk.kernel_fits(tables, n, K, single=True, joints=J) == ""
    assert sk.substep_bodies(tables, n, K, J) == bodies
    assert (sk.substep_smem_bytes(n, K, J) > sk.MAX_SMEM_BYTES) == bodies
    need = sk.substep_body_smem_bytes(n, K, J)
    assert need == sk.substep_smem_bytes(n, K, J) - sk.body_bytes(n)
    if bodies:
        assert need < 52 * 1024
    # the general-hull tables' staged rows move with the bodies: the
    # 24-sided prism's at these rows take the scratch too
    large = hull_tables("large")
    assert sk.substep_bodies(large, n, K, J) and sk.kernel_fits(large, n, K, single=True,
                                                                 joints=J) == ""


def test_kernel5_refuses_only_joints_past_one_block():
    """With the bodies in the scratch, kernel 5's shared memory is its window
    and its joints (12 floats and 2 ints each).  Where the joints' rows pass
    227 KB beside the window (J + 1 below; ~3,300 a world), they move to the
    body scratch too, and kernel 5 refuses no joint count: 4,096 joint rows
    (main_joint_rows_large's) and 20,000 fit, in ~50 KB of shared memory."""
    tables = sk.pk.ObjTables(stg.OBJMGR)
    J = 1
    while sk.substep_body_smem_bytes(1004, 10000, J + 1) <= sk.MAX_SMEM_BYTES:
        J += 1
    assert 3000 < J < 3600
    assert sk.kernel_fits(tables, 1004, 10000, single=True, joints=J) == ""
    assert not sk.substep_joints_in_scratch(tables, 1004, 10000, J)
    assert sk.substep_layout_smem_bytes(tables, 1004, 10000, J) == sk.substep_body_smem_bytes(
        1004, 10000, J)
    for joints in (J + 1, 4096, 20000):
        assert sk.kernel_fits(tables, 1004, 10000, single=True, joints=joints) == ""
        assert sk.substep_joints_in_scratch(tables, 1004, 10000, joints)
        smem = sk.substep_layout_smem_bytes(tables, 1004, 10000, joints)
        assert smem == sk.substep_body_smem_bytes(1004, 10000, 0) < 52 * 1024
        assert sk.body_scratch_floats(1004, tables, joints) == (
            sk.body_scratch_floats(1004, tables) + (sk.JOINT_CH + 2) * joints)
    # a few bodies with 4,096 joint rows: the joints alone pass one block,
    # so the bodies go to the scratch with them
    assert sk.substep_bodies(tables, 64, 256, 4096)
    assert sk.substep_joints_in_scratch(tables, 64, 256, 4096)
    assert not sk.substep_bodies(tables, 64, 256, 64)


def test_body_scratch_mirror_equals_the_cu():
    """body_scratch_floats with the joints' rows, as the .cu computes it."""
    c = cu_constants()
    body = CU[CU.index("size_t body_scratch_floats("):]
    ret = re.search(r"return (.*?);", body, re.S).group(1)
    ret = " ".join(ret.split()).replace("static_cast<size_t>", "")
    for n, hs, jg in ((1004, 0, 0), (1004, 0, 4096), (64, 30, 4096), (7, 5, 3)):
        want = eval(ret, {}, dict(c, nn=n, hull_stride=hs, jg=jg))
        tables = sk.pk.ObjTables(stg.OBJMGR)
        assert sk.body_scratch_floats(n, tables, jg) + n * hs == want


@pytest.mark.parametrize("bodies,cache,fits_one_block",
                         [(370, False, True), (371, False, False), (512, False, False),
                          (341, True, True), (342, True, False)])
def test_prism_pile_ceiling_takes_the_bodies_in_scratch(bodies, cache, fits_one_block):
    """The imported-prism pile: its windowed layout, hull rows staged beside
    the bodies, fits up to 370 bodies (341 with contact refresh); past that
    the bodies and the hull rows go to the scratch."""
    tables = hull_tables("prism")
    n, K = bodies + 1, 4 * bodies
    assert sk.windowed(tables, n, K, cache=cache)
    assert sk.kernel_fits(tables, n, K, cache=cache) == ""
    assert sk.fused_bodies(tables, n, K, cache=cache) != fits_one_block
    assert (sk.fused_window(n, K, cache, sk.hull_stage_bytes(tables, n)) > 0) == fits_one_block


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


def test_wide_box_library_follows_the_source_it_includes(tmp_path, monkeypatch):
    """The wide-box build's library name hashes substep_kernels.cu too,
    which it includes: a change there builds both libraries anew."""
    from gpu_ecs_madrona_tpu_torch.ops import _build
    names = ("substep_kernels", "substep_wide_box_kernels")
    assert set(names) <= set(_build.sources())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for name in names:
        (tmp_path / f"{name}.cu").write_bytes((CSRC / f"{name}.cu").read_bytes())
    before = {name: _build.library_path(name) for name in names}
    (tmp_path / "substep_kernels.cu").write_text(CU + "\n// changed\n")
    for name in names:
        assert _build.library_path(name) != before[name], name
