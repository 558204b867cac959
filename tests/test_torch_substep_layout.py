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
    windowed layout.  The K below it fits the slot layout, at one CTA an SM:
    the broadphase launches it, and without it the windowed twin takes it
    too."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    K = 1
    while sk.smem_bytes(65, K + 1, bp, cache) <= sk.MAX_SMEM_BYTES:
        K += 1
    assert sk.kernel_fits(tables, 65, K, bp, cache) == ""
    assert sk.smem_bytes(65, K, bp, cache) > sk.TWO_CTA_BYTES
    assert sk.windowed(tables, 65, K, bp, cache) == (not bp)
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
    """The windowed layout's option bit, its budget (one CTA's kMaxSmem: one
    CTA of up to WIN_THREADS a world, one an SM), and its scratch channels
    (kernel 5's an entry, and the manifold cache's after them)."""
    c = cu_constants()
    assert sk.OPT_WIN == c["kOptWin"]
    fn = CU[CU.index("int fused_window(int n, int K, bool cache, size_t hull) {"):]
    fn = fn[:fn.index("\n}\n")]
    assert fn.count("kMaxSmem") == 2 and "budget" not in fn
    assert sk.MAX_SMEM_BYTES == c["kMaxSmem"]
    assert sk.WIN_CACHE_CH == c["kWinCacheCh"] == c["kScratchCh"] + c["kCacheCh"]


# rigid_bench piles past one block's shared memory, K = 4 x bodies: (bodies,
# the manifold cache, the window: the most entries one CTA's 227 KB holds,
# every slot at 239 and 255 bodies without the cache)
WINDOW_SHAPES = {"boxes_239": (239, False, 956), "boxes_255": (255, False, 1020),
                 "boxes_511": (511, False, 829), "refresh_200": (200, True, 707),
                 "refresh_255": (255, True, 667)}


@pytest.mark.parametrize("case", sorted(WINDOW_SHAPES))
def test_kernel_fits_takes_the_piles_past_one_block(case):
    """kernel_fits takes rigid_bench at 239, 255 and 511 bodies (and 200
    and 255 with contact refresh) in the windowed layout: its window and
    scratch as stated, the most entries one CTA of the twin's block holds
    (one CTA an SM: 228 KB an SM, 1 KB a block reserved, at most 227 KB),
    the scratch only where the window is below K."""
    bodies, cache, window = WINDOW_SHAPES[case]
    tables = sk.pk.ObjTables(rb.default_object_manager())
    n, K = bodies + 1, 4 * bodies
    assert sk.smem_bytes(n, K, cache=cache) > sk.MAX_SMEM_BYTES
    assert sk.windowed(tables, n, K, cache=cache) and sk.kernel_fits(tables, n, K,
                                                                     cache=cache) == ""
    assert sk.fused_window(n, K, cache) == window <= K
    T = sk.WIN_THREADS
    assert T == sk.WIN_THREADS == 384
    need = sk.fused_window_smem_bytes(n, window, T, cache)
    assert need + 1024 <= 228 * 1024 and need <= sk.MAX_SMEM_BYTES
    assert window == K or sk.fused_window_smem_bytes(n, window + 1, T, cache) > (
        sk.MAX_SMEM_BYTES)
    assert sk.fused_scratch(3, K, K, cache, "cpu") is None
    if window < K:
        scratch = sk.fused_scratch(3, K, window, cache, "cpu")
        assert tuple(scratch.shape) == (3, sk.WIN_CACHE_CH if cache else sk.SCRATCH_CH,
                                        sk.win_pitch(K - window))
        assert sk.win_pitch(K - window) % 2 == 0 and 0 <= sk.win_pitch(K - window) - (
            K - window) <= 1
    # the broadphase inside the kernel does not take the window
    assert not sk.windowed(tables, 128, K, bp=True, cache=cache)


@pytest.mark.parametrize("cache,ceiling", [(False, 870), (True, 647)])
def test_windowed_body_ceiling_is_refused_by_name(cache, ceiling):
    """The windowed layout's ceiling: the bodies whose rows leave room for
    its smallest window (a round of the block's 384 threads) beside them.
    Up to it the shapes keep the windowed layout; one body more, which a
    window budget once refused by name, and 1,023 bodies (1,024 rows) take
    the bodies in the scratch, with a window of at most BODY_WIN_ENTRIES
    that fits one CTA's MAX_SMEM_BYTES."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    n, K = ceiling + 1, 4 * ceiling
    assert sk.kernel_fits(tables, n, K, cache=cache) == ""
    assert sk.windowed(tables, n, K, cache=cache) and not sk.fused_bodies(tables, n, K,
                                                                          cache=cache)
    assert sk.fused_layout_window(tables, n, K, cache) == sk.fused_window(n, K, cache) >= 384
    for bodies in (ceiling + 1, 1023):
        n, K = bodies + 1, 4 * bodies
        assert sk.fused_window(n, K, cache) == 0
        assert sk.kernel_fits(tables, n, K, cache=cache) == ""
        assert sk.fused_bodies(tables, n, K, cache=cache)
        kw = sk.fused_layout_window(tables, n, K, cache)
        assert kw == sk.body_window(n, K, cache) > 384
        T = sk.WIN_THREADS
        budget = sk.MAX_SMEM_BYTES
        assert sk.body_window_smem_bytes(n, kw, T, cache) <= budget
        assert kw == sk.BODY_WIN_ENTRIES or sk.body_window_smem_bytes(n, kw + 1, T,
                                                                       cache) > budget


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
    env = dict(c, nn=n, jj=0, J=0, jg=False, hull_stride=sk.hull_stage_floats(tables))
    assert sk.body_bytes(n) == eval(cu_return_expr("body_bytes"), {}, env)
    assert sk.body_scratch_floats(n, tables) == eval(cu_body_scratch_expr(), {}, env)
    scratch = sk.body_scratch(3, n, tables, "cpu")
    assert scratch.dtype == sk.torch.float32
    assert tuple(scratch.shape) == (3, sk.body_scratch_floats(n, tables))


def test_body_layout_limits_match_the_cu():
    """The bodies-in-scratch option bit, its body channels, and the budget
    its window is sized for: one CTA's 227 KB."""
    c = cu_constants()
    assert sk.OPT_BODY == c["kOptBody"] == 64
    assert sk.BODY_CH == c["kBodyCh"]
    assert sk.option_name(sk.OPT_WIN | sk.OPT_BODY | sk.OPT_REFRESH | sk.OPT_HULL) == (
        "refresh+win+bodies+hull")
    body = CU[CU.index(" body_window("):]
    budget = re.search(r"const size_t budget = (.*?);", body[:body.index("\n}\n")]).group(1)
    assert budget == "kMaxSmem" and "body_budget" not in CU


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
    window, the joints, the lists' offsets and cursors, the joint lists and
    the hottest body channels (body_plan), within the twin's budget of one
    CTA an SM."""
    tables = sk.pk.ObjTables(stg.OBJMGR)
    assert sk.kernel_fits(tables, n, K, single=True, joints=J) == ""
    assert sk.substep_bodies(tables, n, K, J) == bodies
    assert (sk.substep_smem_bytes(n, K, J) > sk.MAX_SMEM_BYTES) == bodies
    if bodies:
        plan = sk.substep_body_plan(n, K, J)
        assert sk.substep_layout_smem_bytes(tables, n, K, J) == plan["bytes"] <= (
            sk.MAX_SMEM_BYTES)
        assert plan["offsets"] and plan["joint_lists"] == (J > 0) and plan["hot"] >= 30
    # the general-hull tables' staged rows move with the bodies: the
    # 24-sided prism's at these rows take the scratch too
    large = hull_tables("large")
    assert sk.substep_bodies(large, n, K, J) and sk.kernel_fits(large, n, K, single=True,
                                                                 joints=J) == ""


def test_kernel5_refuses_only_joints_past_one_block():
    """With the bodies in the scratch, kernel 5's shared memory holds its
    window and its joints (12 floats and 2 ints each) first.  Where the
    joints' rows pass the twin's budget beside the window (J + 1 below;
    ~3,600 a world), they move to the body scratch too, and kernel 5 refuses
    no joint count: 4,096 joint rows (main_joint_rows_large's), 20,000 and
    30,000 fit, the joint lists in shared memory while they fit (20,000
    joints), else in the scratch too (30,000)."""
    tables = sk.pk.ObjTables(stg.OBJMGR)
    budget = sk.MAX_SMEM_BYTES
    J = 1
    while sk.substep_body_fixed_bytes(1004, 10000, J + 1) <= budget:
        J += 1
    assert 3000 < J < 4000
    assert sk.kernel_fits(tables, 1004, 10000, single=True, joints=J) == ""
    assert not sk.substep_joints_in_scratch(tables, 1004, 10000, J)
    assert sk.substep_layout_smem_bytes(tables, 1004, 10000, J) == sk.substep_body_smem_bytes(
        1004, 10000, J) <= budget
    for joints, lists in ((J + 1, True), (4096, True), (20000, True), (30000, False)):
        assert sk.kernel_fits(tables, 1004, 10000, single=True, joints=joints) == ""
        assert sk.substep_joints_in_scratch(tables, 1004, 10000, joints)
        smem = sk.substep_layout_smem_bytes(tables, 1004, 10000, joints)
        assert smem == sk.substep_body_smem_bytes(1004, 10000, joints, True) <= budget
        assert sk.substep_body_plan(1004, 10000, joints, True)["joint_lists"] == lists
        assert sk.body_scratch_floats(1004, tables, joints, True) == (
            sk.body_scratch_floats(1004, tables) + (sk.JOINT_CH + 2 + 2) * joints + 2 * 1004)
    # a few bodies with 4,096 joint rows: the joints alone pass one block,
    # so the bodies go to the scratch with them
    assert sk.substep_bodies(tables, 64, 256, 4096)
    assert sk.substep_joints_in_scratch(tables, 64, 256, 4096)
    assert not sk.substep_bodies(tables, 64, 256, 64)


def cu_body_scratch_expr():
    """The .cu's body_scratch_floats return expression, in Python."""
    body = CU[CU.index("size_t body_scratch_floats("):]
    ret = " ".join(re.search(r"return (.*?);", body, re.S).group(1).split())
    ret = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", ret)
    return re.sub(r"\((\w+(?: > 0)?) \? (.+?) : 0\)", r"((\2) if \1 else 0)", ret)


def test_body_scratch_mirror_equals_the_cu():
    """body_scratch_floats with kernel 5's joint lists and, where they are
    in the scratch too, the joints' rows, as the .cu computes it."""
    c = cu_constants()
    expr = cu_body_scratch_expr()
    tables = sk.pk.ObjTables(stg.OBJMGR)
    for n, hs, J, jg in ((1004, 0, 0, False), (1004, 0, 64, False), (1004, 0, 4096, True),
                         (64, 30, 4096, True), (7, 5, 3, False)):
        want = eval(expr, {}, dict(c, nn=n, jj=J, J=J, hull_stride=hs, jg=jg))
        assert sk.body_scratch_floats(n, tables, J, jg) + n * hs == want
    assert sk.body_scratch_floats(1004, tables, 4096, True) == (
        sk.body_scratch_floats(1004, tables) + (sk.JOINT_CH + 2) * 4096 + 2 * 1004 + 2 * 4096)


@pytest.mark.parametrize("bodies,cache,fits_one_block",
                         [(332, False, True), (333, False, False), (512, False, False),
                          (247, True, True), (248, True, False)])
def test_prism_pile_ceiling_takes_the_bodies_in_scratch(bodies, cache, fits_one_block):
    """The imported-prism pile: its windowed layout, hull rows staged beside
    the bodies and a window of at least the block's 384 threads, fits up to
    332 bodies (247 with contact refresh); past that the bodies and the hull
    rows go to the scratch."""
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


# -- the twins past one block, redesigned (the hot body ranks in shared
# memory, kernel 5's joint lists, the twins' own blocks) ------------------


def cu_body_rank():
    """The .cu's body_rank as a Python function of a channel."""
    body = CU[CU.index("constexpr int body_rank(int ch) {"):]
    expr = " ".join(re.search(r"return (.*?);", body[:body.index("\n}\n")], re.S)
                    .group(1).split())
    expr = re.sub(r"//[^:?]*", "", expr)
    parts = [p.strip() for p in expr.split(" : ")]
    c = cu_constants()

    def rank(ch):
        env = dict(c, ch=ch)
        for part in parts[:-1]:
            cond, value = part.split(" ? ")
            if eval(cond.replace("&&", "and"), {}, env):
                return eval(value, {}, env)
        return eval(parts[-1], {}, env)
    return rank


def test_body_ranks_are_a_permutation_grouped_by_vector():
    """body_rank orders the 54 body channels, each once, the pass gathers
    first (object, post-integrate pose, inverse mass and inertia, substep
    start, friction, post-positional-solve pose and velocities), and keeps
    each vector's components on consecutive ranks."""
    c, rank = cu_constants(), cu_body_rank()
    ranks = [rank(ch) for ch in range(c["kBodyCh"])]
    assert sorted(ranks) == list(range(c["kBodyCh"]))
    assert rank(c["kObj"]) == 0
    for first, width in (("kPos", 3), ("kRot", 4), ("kV", 3), ("kW", 3), ("kPrevPos", 3),
                         ("kPrevRot", 4), ("kIPos", 3), ("kIRot", 4), ("kIV", 3), ("kIW", 3),
                         ("kP2", 3), ("kR2", 4), ("kV2", 3), ("kW2", 3), ("kIi", 3)):
        r0 = rank(c[first])
        assert [rank(c[first] + i) for i in range(width)] == list(range(r0, r0 + width)), first
    gathered = ["kIPos", "kIRot", "kIm", "kIi", "kPrevPos", "kMuS", "kMuD", "kObj"]
    assert max(rank(c[k]) for k in gathered) < min(rank(c[k]) for k in ("kP2", "kV", "kPos"))


def test_twin_geometry_matches_the_cu():
    c = cu_constants()
    assert sk.WIN_THREADS == c["kWinThreads"]
    assert sk.BODY_THREADS == c["kBodyThreads"]
    assert sk.BODY_WIN_ENTRIES == c["kBodyWinEntries"]
    pitch = re.search(r"int win_pitch\(int kg\) \{ return (.*?); \}", CU).group(1)
    for kg in (0, 1, 2, 3, 641, 3580):
        assert sk.win_pitch(kg) == eval(pitch.replace("&", "&"), {}, {"kg": kg})
    # the windowed twins launch kWinThreads threads at every shape
    assert "? kWinThreads : block_threads(n, K)" in CU and "win_threads" not in CU
    for n, K in ((256, 1020), (9, 5), (1024, 4092), (40, 100)):
        assert sk.substep_body_threads(n, K) == min(-(-max(n, min(K, c["kWindow"])) // 32) * 32,
                                                    c["kBodyThreads"])


def cu_substep_body_fixed_bytes(n, K, js):
    """The .cu's substep_body_fixed_bytes evaluated in Python."""
    body = CU[CU.index("size_t substep_body_fixed_bytes("):]
    body = body[:body.index("\n}\n")]
    c = cu_constants()
    env = dict(c, ww=min(K, c["kWindow"]), jj=js, tt=sk.substep_body_threads(n, K))
    env["ks"] = max(env["ww"] - env["tt"], 0)
    counts = {var: eval(" ".join(re.search(rf"const size_t {var} = (.*?);", body, re.S)
                                 .group(1).split()), {}, env) for var in ("floats", "ints")}
    return 4 * counts["floats"] + 4 * counts["ints"]


@pytest.mark.parametrize("n,K,J", [(816, 1000, 0), (1004, 10000, 64), (1089, 2048, 4096),
                                   (65, 256, 4096), (8, 8, 20000)])
def test_kernel5_body_fixed_part_mirror_equals_the_cu(n, K, J):
    for js in (0, J):
        assert sk.substep_body_fixed_bytes(n, K, js) == cu_substep_body_fixed_bytes(n, K, js)


# (n, K, J, the joints' rows in the scratch, kernel 5) and (n, K, the cache,
# fused): the twins' shapes on the main paths and the card tests'
PLAN_SHAPES = [(1004, 10000, 64, False, True), (1089, 2048, 4096, True, True),
               (816, 3260, 0, False, True), (65, 256, 4096, True, True),
               (65, 256, 16384, True, True), (20001, 256, 0, False, True),
               (1024, 4092, 0, False, False), (970, 3876, 0, True, False),
               (372, 1484, 0, False, False)]


@pytest.mark.parametrize("n,K,J,flag,kernel5", PLAN_SHAPES)
def test_body_plan_fills_the_budget_in_order(n, K, J, flag, kernel5):
    """The twins' shared memory past their fixed part: the lists' offsets
    and cursors, then kernel 5's joint lists, each where it still fits, then
    as many body ranks as fit; within the twin's budget, and the next rank
    past it (or all 54 in)."""
    if kernel5:
        plan, budget = sk.substep_body_plan(n, K, J, flag), sk.MAX_SMEM_BYTES
        fixed = sk.substep_body_fixed_bytes(n, K, 0 if flag else J)
        assert flag == (sk.substep_body_fixed_bytes(n, K, J) > budget)
    else:
        plan, budget = sk.fused_body_plan(n, K, flag), sk.MAX_SMEM_BYTES
        kw = sk.body_window(n, K, flag)
        assert min(K, sk.WIN_THREADS) <= kw <= max(sk.BODY_WIN_ENTRIES, sk.WIN_THREADS)
        fixed = sk.body_window_smem_bytes(n, kw, sk.WIN_THREADS, flag)
    offs, lists = 4 * (3 * n + 1), 4 * (2 * n + 2 * J) if J else 0
    assert plan["offsets"] == (fixed + offs <= budget)
    used = fixed + (offs if plan["offsets"] else 0)
    assert plan["joint_lists"] == (J > 0 and used + lists <= budget)
    used += lists if plan["joint_lists"] else 0
    assert plan["bytes"] == used + 4 * n * plan["hot"] <= budget
    assert plan["hot"] == sk.BODY_CH or plan["bytes"] + 4 * n > budget



# -- the one-CTA rule: fused shapes whose slot layout leaves one CTA an SM
# take the windowed twin's block ------------------------------------------


def ctas_an_sm(need):
    """CTAs of ``need`` bytes of dynamic shared memory an SM holds by shared
    memory (the .cu's kMaxSmem and the 1 KB a CTA reserves make the SM's
    228 KB)."""
    sm = cu_constants()["kMaxSmem"] + 1024
    return sm // (need + 1024)


def slot_layout_bytes(tables, n, K, bp=False, cache=False):
    return sk.smem_bytes(n, K, bp, cache) + sk.hull_stage_bytes(tables, n)


def test_one_cta_rule_matches_the_cu():
    """The rule's bound is the one the .cu's notes state from its kMaxSmem,
    (kMaxSmem - 1 KB) / 2: the most a CTA may take for two to share an SM."""
    c = cu_constants()
    assert sk.TWO_CTA_BYTES == (c["kMaxSmem"] - 1024) // 2
    assert "(kMaxSmem - 1 KB) / 2" in CU and "TWO_CTA_BYTES" in CU
    assert ctas_an_sm(sk.TWO_CTA_BYTES) == 2 and ctas_an_sm(sk.TWO_CTA_BYTES + 1) == 1


# (tables, n, K, bp, cache): the main paths' fused shapes that keep two or
# more CTAs an SM in the slot layout (main_rigid at K = 256 and 128,
# main_rigid_fused_bp, the settled piles, the imported prism's pile with
# and without the cache, the 24-sided prism at K = 128, rigid_bench at 99
# bodies and at 128, the last before the rule)
SLOT_SHAPES = {"main_rigid_K256": ("boxes", 65, 256, False, False),
               "main_rigid_K128": ("boxes", 65, 128, False, False),
               "main_rigid_fused_bp": ("boxes", 65, 256, True, False),
               "settled": ("boxes", 65, 256, True, True),
               "settled_K128": ("boxes", 65, 128, True, True),
               "refresh_K256": ("boxes", 65, 256, False, True),
               "prism_K256": ("prism", 65, 256, False, False),
               "prism_K128": ("prism", 65, 128, False, False),
               "prism_refresh_K256": ("prism", 65, 256, False, True),
               "prism_settled": ("prism", 65, 256, True, True),
               "large_K128": ("large", 65, 128, False, False),
               "boxes_99": ("boxes", 100, 396, False, False),
               "boxes_128": ("boxes", 129, 512, False, False),
               "refresh_79": ("boxes", 80, 316, False, True)}


def shape_tables(which):
    if which == "boxes":
        return sk.pk.ObjTables(rb.default_object_manager())
    return hull_tables(which)


@pytest.mark.parametrize("case", sorted(SLOT_SHAPES))
def test_shapes_at_two_ctas_keep_the_slot_layout(case):
    """The fused shapes that keep two or more CTAs an SM in the slot layout
    launch it as before: not windowed, their option bits unchanged, taken
    by kernel_fits."""
    which, n, K, bp, cache = SLOT_SHAPES[case]
    tables = shape_tables(which)
    need = slot_layout_bytes(tables, n, K, bp, cache)
    assert need <= sk.TWO_CTA_BYTES and ctas_an_sm(need) >= 2
    assert not sk.windowed(tables, n, K, bp, cache)
    code = (sk.OPT_BP if bp else 0) | (sk.OPT_REFRESH if cache else 0)
    assert sk.fused_route(code, tables, n, K) == code
    assert sk.fused_route(code | sk.OPT_SLEEP, tables, n, K) == code | sk.OPT_SLEEP
    assert sk.kernel_fits(tables, n, K, bp, cache) == ""


# (tables, bodies, the cache): the shapes whose slot layout leaves one CTA
# an SM and whose twin's window holds every slot (K = 4 x bodies, or 256
# for the 24-sided prism's pile): rigid_bench at 129 (the first), 200
# (main_rigid_sap) and 238 bodies (the last whose slot layout fits one
# block), with contact refresh at 80 (the first) and 128, the 24-sided
# prism at main_rigid_hulls_large's 64 bodies, with and without refresh
TWIN_SHAPES = {"boxes_129": ("boxes", 129, False, 516), "main_rigid_sap": ("boxes", 200, False, 800),
               "boxes_238": ("boxes", 238, False, 952), "refresh_80": ("boxes", 80, True, 320),
               "refresh_128": ("boxes", 128, True, 512),
               "large_K256": ("large", 64, False, 256),
               "large_refresh_K256": ("large", 64, True, 256)}


@pytest.mark.parametrize("case", sorted(TWIN_SHAPES))
def test_shapes_at_one_cta_take_the_twin_with_every_slot_in_the_window(case):
    """Where the slot layout leaves one CTA an SM (and fits one block), the
    fused kernel without the broadphase takes the windowed twin ("win",
    "sleep+win", "refresh+win"): its window holds every slot, so no scratch
    is allocated, in a block of WIN_THREADS threads within one CTA's
    MAX_SMEM_BYTES; kernel_fits takes it."""
    which, bodies, cache, K = TWIN_SHAPES[case]
    tables = shape_tables(which)
    n = bodies + 1
    need = slot_layout_bytes(tables, n, K, cache=cache)
    assert sk.TWO_CTA_BYTES < need <= sk.MAX_SMEM_BYTES and ctas_an_sm(need) == 1
    assert sk.windowed(tables, n, K, cache=cache)
    assert not sk.fused_bodies(tables, n, K, cache=cache)
    refresh = sk.OPT_REFRESH if cache else 0
    assert sk.fused_route(refresh, tables, n, K) == refresh | sk.OPT_WIN
    assert sk.fused_route(refresh | sk.OPT_SLEEP, tables, n, K) == (
        refresh | sk.OPT_SLEEP | sk.OPT_WIN)
    window = sk.fused_layout_window(tables, n, K, cache)
    assert window == K
    assert sk.fused_scratch(3, K, window, cache, "cpu") is None
    T = sk.WIN_THREADS
    twin = sk.fused_window_smem_bytes(n, K, T, cache) + sk.hull_stage_bytes(tables, n)
    assert twin <= sk.MAX_SMEM_BYTES
    assert sk.kernel_fits(tables, n, K, cache=cache) == ""
    assert sk.option_name(sk.fused_route(refresh, tables, n, K)
                          | (0 if tables.all_box else sk.OPT_HULL)).endswith(
        "win" if tables.all_box else "win+hull")


@pytest.mark.parametrize("which,cache,slots_past_one_block,bodies_ceiling",
                         [("boxes", False, 239, 870), ("boxes", True, 161, 647),
                          ("prism", False, 174, 332), ("prism", True, 129, 247)])
def test_thresholds_past_one_block_do_not_change(which, cache, slots_past_one_block,
                                                 bodies_ceiling):
    """The rule moves only the shapes between two CTAs an SM and one
    block: the slot layout still passes one block's shared memory from 239
    bodies of boxes (161 with the cache; the imported prism's 174 and 129),
    and the windowed twin's body ceiling (past it "win+bodies") is still 870
    bodies (647; the imported prism's 332 and 247)."""
    tables = shape_tables(which)
    b = slots_past_one_block
    assert slot_layout_bytes(tables, b, 4 * (b - 1), cache=cache) <= sk.MAX_SMEM_BYTES
    assert slot_layout_bytes(tables, b + 1, 4 * b, cache=cache) > sk.MAX_SMEM_BYTES
    for bodies, past in ((bodies_ceiling, False), (bodies_ceiling + 1, True)):
        n, K = bodies + 1, 4 * bodies
        assert sk.windowed(tables, n, K, cache=cache)
        assert sk.fused_bodies(tables, n, K, cache=cache) == past
        assert sk.kernel_fits(tables, n, K, cache=cache) == ""


@pytest.mark.parametrize("n,K,persist", [(128, 512, False), (128, 512, True), (100, 400, True),
                                         (65, 256, True), (128, 900, False)])
def test_broadphase_and_persist_shapes_do_not_change(n, K, persist):
    """The in-kernel broadphase (and persistence, which needs it) has no
    windowed twin: its shapes keep the slot layout at any CTAs an SM (at
    128 rows, K = 512, one), and kernel_fits refuses the slot layout past
    one block by name, as before."""
    tables = sk.pk.ObjTables(rb.default_object_manager())
    assert not sk.windowed(tables, n, K, bp=True, cache=persist)
    code = sk.OPT_BP | (sk.OPT_PERSIST | sk.OPT_REFRESH if persist else 0)
    assert sk.fused_route(code, tables, n, K) == code
    assert sk.fused_route(code | sk.OPT_SLEEP, tables, n, K) == code | sk.OPT_SLEEP
    need = sk.smem_bytes(n, K, True, persist)
    assert (sk.kernel_fits(tables, n, K, bp=True, cache=persist) == "") == (
        need <= sk.MAX_SMEM_BYTES)
    if (n, K) == (128, 512) and not persist:
        assert sk.TWO_CTA_BYTES < need <= sk.MAX_SMEM_BYTES and ctas_an_sm(need) == 1


@pytest.mark.parametrize("which", ["boxes", "prism", "large"])
def test_kernel_fits_refuses_what_it_refused(which):
    """kernel_fits refuses exactly the shapes it refused before the rule:
    with the broadphase, a slot layout past one block (or past 128 rows);
    without it, none (the windowed twin takes them, past its body ceiling
    with the bodies in the scratch)."""
    tables = shape_tables(which)
    for n in (1, 2, 33, 65, 100, 128, 129, 201, 239, 256, 871, 1024):
        for K in (1, 128, 256, 512, 800, 1020, 4092):
            for bp in (False, True):
                for cache in (False, True):
                    why = sk.kernel_fits(tables, n, K, bp, cache)
                    need = sk.smem_bytes(n, K, bp, cache)
                    before = not bp or (n <= sk.MAX_BP_ROWS and need <= sk.MAX_SMEM_BYTES
                                        and need + sk.hull_stage_bytes(tables, n)
                                        <= sk.MAX_SMEM_BYTES)
                    assert (why == "") == before, (n, K, bp, cache, why)

