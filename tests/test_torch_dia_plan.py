"""The DIA kernels' host plans (``kernels.dia_mv_plan``,
``kernels.dia_mm_plan``) on the CPU.

The SpMV plan decides how ``csrc/dia_spmv.cu`` covers a product: R
consecutive rows a thread and the interior rows that run without range
checks.  The SpMM plan decides how ``csrc/dia_spmm.cu`` covers a block
product: V columns per thread and tiles of T rows by Kc columns,
panel-major.  The kernels themselves run only on the card
(``tests/test_torch_dia_card.py``, ``tests/test_torch_spmm_card.py``);
here each plan is held to its rules, and a torch emulation of each
kernel's walk under its plan is held bit for bit against the plain product
(and, for the SpMV, against the JAX package's Pallas kernel in interpret
mode: 1e-12 relative in f64, 1e-6 in f32, where the sums run in another
order).
"""

import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

from pykrylov_tpu.gallery import poisson3d_coo
from pykrylov_tpu.sparse import formats as JF

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.sparse import kernels as K

from test_torch_dia import pallas, rel

N3 = 240 * 240
POISSON240 = (-N3, -240, -1, 0, 1, 240, N3)
OFFSET_SETS = {
    "poisson240": POISSON240,
    "tridiagonal": (-1, 0, 1),
    "far": (-20016, -700, 0, 600, 20014),
    "64 diagonals": tuple(range(-40, 24)),
    "unsorted with duplicates": (5, -3, 0, 5, -3),
    "none": (),
    # the 3-D B-spline Laplacian at n = 240: the kernels' wide path
    "125 B-spline diagonals": tuple(a * N3 + b * 240 + c
                                    for a in range(-2, 3)
                                    for b in range(-2, 3)
                                    for c in range(-2, 3)),
}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16, 17, 32, 64, 65, 200])
@pytest.mark.parametrize("aligned", [True, False])
def test_v_divides_k_and_respects_alignment(k, itemsize, aligned):
    plan = K.dia_mm_plan(POISSON240, k, itemsize, aligned)
    vw = 16 // itemsize
    assert plan.v in (1, vw)
    assert k % plan.v == 0
    if not aligned or k % vw:
        assert plan.v == 1
    else:
        assert plan.v == vw     # 16-byte loads and stores
    # panels: Kc divides K, V divides Kc, and Kc is K halved only while the
    # reuse window exceeds its L2 budget
    assert k % plan.kc == 0 and plan.kc % plan.v == 0
    window = 2 * N3 * plan.kc * itemsize
    if plan.kc < k:
        assert 2 * window > K.L2_WINDOW_BYTES
    if window > K.L2_WINDOW_BYTES:
        assert plan.kc % 2 or (plan.kc // 2) % plan.v
    assert plan.rows == K.MM_ROWS and plan.rows * k < 2 ** 31


@pytest.mark.parametrize("name", sorted(OFFSET_SETS))
@pytest.mark.parametrize("k", [4, 8, 64])
def test_panels_keep_the_reuse_window_within_l2(name, k):
    offsets = OFFSET_SETS[name]
    plan = K.dia_mm_plan(offsets, k, 4, True)
    reach = max((abs(o) for o in offsets), default=0)
    assert k % plan.kc == 0 and plan.kc % plan.v == 0
    # every offset set here fits a panel of 4 columns, so Kc is the widest
    # power-of-two share of K whose window fits
    assert 2 * reach * plan.kc * 4 <= K.L2_WINDOW_BYTES
    assert plan.kc == k or 2 * reach * 2 * plan.kc * 4 > K.L2_WINDOW_BYTES


@pytest.mark.parametrize("kc", [4, 8, 16, 32, 64])
def test_l2_window_sets_the_panel_width(monkeypatch, kc):
    # the window budget is a module constant the variants script and the
    # card tests narrow to force panels
    monkeypatch.setattr(K, "L2_WINDOW_BYTES", 2 * N3 * kc * 4)
    assert K.dia_mm_plan(POISSON240, 64, 4, True).kc == kc
    assert K.dia_mm_plan(POISSON240, 4, 4, True).kc == 4


def test_poisson_plan_at_the_main_paths_widths():
    p8 = K.dia_mm_plan(POISSON240, 8, 4, True)
    assert (p8.v, p8.rows, p8.kc) == (4, K.MM_ROWS, 8)
    p64 = K.dia_mm_plan(POISSON240, 64, 4, True)
    assert p64.kc == 32        # 2 n^2 K 4 B = 29.5 MB > 16 MB at Kc = 64
    assert K.dia_mm_plan(POISSON240, 1, 4, True).v == 1
    assert K.dia_mm_plan(POISSON240, 8, 8, True).v == 2


def test_tile_rows_match_the_kernel_source():
    src = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                       "dia_spmm.cu")
    with open(src) as f:
        rows = re.findall(r"constexpr int kRows = (\d+);", f.read())
    assert rows == [str(K.MM_ROWS)]


def test_wrapper_plan_sees_the_block_alignment():
    m, k = 1000, 8
    data = torch.ones((3, m))
    buf = torch.zeros(m * k + 4)
    aligned = buf[:m * k].view(m, k)
    shifted = buf[1:1 + m * k].view(m, k)     # 4 bytes past 16-byte alignment
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    assert K.dia_matmat_plan(data, (-1, 0, 1), aligned).v == 4
    assert K.dia_matmat_plan(data, (-1, 0, 1), shifted).v == 1
    # f64: two columns make 16 bytes
    assert K.dia_matmat_plan(data.double(), (-1, 0, 1),
                             aligned.double()).v == 2


def emulate(data, offsets, X, plan):
    """The kernel's tile walk in torch: panels of Kc columns, tiles of T
    rows, each term read straight from X where its row lies in [0, n) and
    skipped elsewhere; each product and sum rounded on its own in
    ascending d.  Rows no tile writes stay NaN."""
    ndiag, m = data.shape
    n, k = X.shape
    Y = torch.full((m, k), float("nan"), dtype=X.dtype)
    for p in range(k // plan.kc):
        cols = slice(p * plan.kc, (p + 1) * plan.kc)
        for i0 in range(0, m, plan.rows):
            teff = min(plan.rows, m - i0)
            r = torch.arange(teff)
            acc = torch.zeros((teff, plan.kc), dtype=X.dtype)
            for d, off in enumerate(offsets):
                j = i0 + r + off
                live = (j >= 0) & (j < n)
                xv = X[j.clamp(0, max(n - 1, 0))][:, cols]
                val = data[d, i0:i0 + teff].to(X.dtype)[:, None]
                acc = torch.where(live[:, None], acc + val * xv, acc)
            Y[i0:i0 + teff, cols] = acc
    return Y


@pytest.mark.parametrize("case", [
    ("poisson12", 1728, 1728, (-144, -12, -1, 0, 1, 12, 144), 8, None),
    ("poisson12 K=64, panels of 16", 1728, 1728,
     (-144, -12, -1, 0, 1, 12, 144), 64, 16),
    ("far, rectangular", 700, 650, (-705, -300, 0, 299, 702), 8, 4),
    ("short", 37, 40, (-2, 0, 3), 4, None),
    ("scalar", 500, 500, (-7, 0, 7), 3, None),
    ("64 diagonals", 900, 900, tuple(range(-40, 24)), 4, None),
])
def test_tile_walk_emulation_equals_plain(monkeypatch, case):
    _, m, n, offsets, k, kc = case
    if kc is not None:
        reach = max(abs(o) for o in offsets)
        monkeypatch.setattr(K, "L2_WINDOW_BYTES", 2 * reach * kc * 8)
    rng = np.random.default_rng(m + k)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m)))
    # slots whose column lies outside [0, n) hold NaN: never multiplied
    for d, off in enumerate(offsets):
        i = np.arange(m)
        data[d, torch.from_numpy((i + off < 0) | (i + off >= n))] = \
            float("nan")
    X = torch.from_numpy(rng.standard_normal((n, k)))
    ref = K.dia_matmat_plain(data, offsets, X)
    assert torch.isfinite(ref).all()
    plan = K.dia_mm_plan(offsets, k, 8, True)
    assert plan.kc == (k if kc is None else kc)
    assert torch.equal(emulate(data, offsets, X, plan), ref)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,v", [(8, 2), (64, 2), (3, 1), (1, 1)])
def test_mixed_pair_plans_on_the_f64_block(storage, k, v):
    # f32 or bf16 data with an f64 block computes in f64: V is 16 bytes of
    # f64 columns (2) beside 4- or 2-byte diagonal loads, 1 for odd K; the
    # panel width follows the f64 block's 8-byte items
    m = 1000
    data = torch.ones((3, m), dtype=storage)
    X = torch.zeros((m, k), dtype=torch.float64)
    assert X.data_ptr() % 16 == 0
    plan = K.dia_matmat_plan(data, (-1, 0, 1), X)
    assert plan == K.dia_mm_plan((-1, 0, 1), k, 8, True)
    assert (plan.v, plan.rows, plan.kc) == (v, K.MM_ROWS, k)
    # Poisson n=240 at K=64 in f64: 2 n^2 Kc 8 B fits 16 MB at Kc = 16
    assert K.dia_matmat_plan(torch.ones((7, 8), dtype=storage), POISSON240,
                             torch.zeros((8, 64), dtype=torch.float64)).kc \
        == 16


def test_mixed_pair_tile_walk_equals_plain():
    # the V = 2 tile walk on f32 data and an f64 block, against the plain
    # product of the widened data, bit for bit
    offsets = (-144, -12, -1, 0, 1, 12, 144)
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.standard_normal((7, 1728)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((1728, 8)))
    plan = K.dia_matmat_plan(data, offsets, X)
    assert plan.v == 2
    ref = K.dia_matmat_plain(data, offsets, X)
    assert ref.dtype == torch.float64
    assert torch.equal(emulate(data, offsets, X, plan), ref)
    assert torch.equal(ref, K.dia_matmat_plain(data.double(), offsets, X))


# ---------------------------------------------------------------------------
# the SpMV kernel's plan and walk
# ---------------------------------------------------------------------------

def _source(name):
    path = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                        name + ".cu")
    with open(path) as f:
        return f.read()


# x loads a thread issues ahead of their products: a chunk of
# max(1, MV_TERMS // R) diagonals
MV_TERMS = int(re.search(r"constexpr int kTerms = (\d+);",
                         _source("dia_spmv")).group(1))
# (storage, x dtype) of the five entry points
ENTRIES = {
    "f32": (torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.float32),
    "f64": (torch.float64, torch.float64),
    "f32f64": (torch.float32, torch.float64),
    "bf16f64": (torch.bfloat16, torch.float64),
}
# the odd sizes of the card tests (R = 1: R divides none of them) and sizes
# that every R divides (the row groups)
MV_SIZES = (1, 3, 37, 20011, 100003, 8, 1728, 20016, 100000)


def interior(offsets, m, n):
    """The rows whose every term has its column in [0, n), by brute
    force."""
    rows = [i for i in range(m)
            if all(0 <= i + o < n for o in offsets)]
    return (rows[0], rows[-1] + 1) if rows else None


@pytest.mark.parametrize("itemsize,rw", [(2, 8), (4, 4), (8, 2)])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 12, 37, 1000, 20011, 20016])
@pytest.mark.parametrize("aligned", [True, False])
def test_mv_rows_a_thread_follow_storage_and_alignment(itemsize, rw, m,
                                                       aligned):
    plan = K.dia_mv_plan(POISSON240, m, m, itemsize, aligned)
    assert plan.r in (1, rw)
    # 16 bytes of stored values a group, only where R divides m (each
    # container row then starts 16-byte aligned) and the pointers align
    assert plan.r == (rw if aligned and m % rw == 0 else 1)
    assert m % plan.r == 0
    assert 0 <= plan.lo <= plan.hi <= m


@pytest.mark.parametrize("name", sorted(OFFSET_SETS))
@pytest.mark.parametrize("shape", [(1728, 1728), (20016, 20016),
                                   (20016, 20500), (20500, 20016),
                                   (40000, 1000), (64, 64)])
def test_mv_interior_is_every_row_with_every_term_in_range(name, shape):
    offsets = OFFSET_SETS[name]
    m, n = shape
    plan = K.dia_mv_plan(offsets, m, n, 4, True)
    # no offsets: every row is interior
    want = interior(offsets, m, n) if offsets else (0, m)
    if want is None:
        assert plan.lo == plan.hi
    else:
        assert (plan.lo, plan.hi) == want


@pytest.mark.parametrize("offsets", [(0, 1, 2000), (-3000, 0),
                                     (-2000, 5000), (1001,), (-1001,)])
def test_mv_offsets_past_m_leave_no_interior(offsets):
    plan = K.dia_mv_plan(offsets, 1000, 1000, 4, True)
    assert plan.lo == plan.hi and 0 <= plan.lo <= 1000
    assert interior(offsets, 1000, 1000) is None


def test_mv_poisson_plan_at_the_main_paths_size():
    m = 240 ** 3
    for itemsize, r in ((4, 4), (2, 8), (8, 2)):
        plan = K.dia_mv_plan(POISSON240, m, m, itemsize, True)
        assert plan == (r, N3, m - N3)
    assert K.dia_mv_plan(POISSON240, m, m, 4, False).r == 1


def test_mv_wrapper_plan_sees_alignment_and_storage():
    m = 1000
    buf = torch.zeros(3 * m + 4)
    data = buf[:3 * m].view(3, m)
    shifted = buf[1:1 + 3 * m].view(3, m)     # 4 bytes past alignment
    x = torch.zeros(m + 4)
    assert K.dia_matvec_plan(data, (-1, 0, 1), x[:m]).r == 4
    assert K.dia_matvec_plan(shifted, (-1, 0, 1), x[:m]).r == 1
    assert K.dia_matvec_plan(data, (-1, 0, 1), x[1:1 + m]).r == 1
    # R follows the storage, not the compute type: f32 data with an f64 x
    # takes 4 rows (two 16-byte stores of y), bf16 data 8
    assert K.dia_matvec_plan(data, (-1, 0, 1), x[:m].double()).r == 4
    assert K.dia_matvec_plan(data.to(torch.bfloat16), (-1, 0, 1),
                             x[:m]).r == 8
    assert K.dia_matvec_plan(data.double(), (-1, 0, 1),
                             x[:m].double()).r == 2
    # an m that R does not divide misaligns every row after the first
    assert K.dia_matvec_plan(torch.zeros(3, 1002), (-1, 0, 1),
                             torch.zeros(1002)).r == 1
    # rectangular: the interior follows n
    plan = K.dia_matvec_plan(torch.zeros(2, 1000), (-5, 20),
                             torch.zeros(900))
    assert (plan.r, plan.lo, plan.hi) == (4, 5, 880)


def emulate_mv(data, offsets, x, plan, terms=MV_TERMS):
    """The SpMV kernel's walk in torch: groups of R rows, each diagonal's R
    values of a group read as one load; the loads of a chunk of
    max(1, terms // R) diagonals taken before its products, the products
    added in ascending k, each product and sum rounded on its own;
    interior groups read x without a range check (asserted to lie in
    range), the other groups skip each term whose column lies outside
    [0, n)."""
    ndiag, m = data.shape
    n = x.shape[0]
    ct = torch.promote_types(data.dtype, x.dtype)
    x = x.to(ct)
    r = plan.r
    chunk = max(1, terms // r)
    assert m % r == 0
    starts = torch.arange(0, m, r)
    inside = (starts >= plan.lo) & (starts + r <= plan.hi)
    rows = starts[:, None] + torch.arange(r)
    acc = torch.zeros((m // r, r), dtype=ct)
    for k0 in range(0, ndiag, chunk):
        loads = []
        for k in range(k0, min(k0 + chunk, ndiag)):
            vals = data[k].reshape(-1, r)
            j = rows + offsets[k]
            live = (j >= 0) & (j < n)
            assert bool(live[inside].all())    # the unchecked reads
            live = torch.where(inside[:, None], True, live)
            xv = x[j.clamp(0, max(n - 1, 0))] if n else torch.zeros_like(acc)
            loads.append((vals, xv, live))
        for vals, xv, live in loads:
            acc = torch.where(live, acc + vals.to(ct) * xv, acc)
    return acc.reshape(m)


def poison(data, offsets, n):
    """NaN and inf in every slot whose column lies outside [0, n)."""
    m = data.shape[1]
    i = np.arange(m)
    for k, off in enumerate(offsets):
        out = np.flatnonzero((i + off < 0) | (i + off >= n))
        data[k, torch.from_numpy(out[0::2])] = float("nan")
        data[k, torch.from_numpy(out[1::2])] = float("inf")
    return data


def mv_case(m, n, offsets, entry, seed):
    storage, xdt = ENTRIES[entry]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(
        rng.standard_normal((len(offsets), m))).to(storage)
    data = poison(data, offsets, n)
    x = torch.from_numpy(rng.standard_normal(n)).to(xdt)
    return data, x


def hold_walk(data, offsets, x, terms=(MV_TERMS,)):
    """The emulated walk under the wrapper's plan, bit for bit against the
    plain product, at each budget of terms ahead; returns the plan."""
    ref = K.dia_matvec_plain(data, offsets, x)
    assert torch.isfinite(ref).all()
    plan = K.dia_matvec_plan(data, offsets, x)
    for t in terms:
        assert torch.equal(emulate_mv(data, offsets, x, plan, t), ref)
    return plan


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("m", MV_SIZES)
def test_mv_walk_equals_plain(entry, m):
    # far offsets and the tridiagonal core: an interior from m = 260
    offsets = (-max(1, m // 3), -130, -1, 0, 3, 129)
    data, x = mv_case(m, m, offsets, entry, m)
    plan = hold_walk(data, offsets, x, (MV_TERMS, 32, 1))
    rw = 16 // data.element_size()
    assert plan.r == (rw if m % rw == 0 else 1)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("name,m,n,offsets", [
    ("rectangular, wide", 20016, 21000, (-700, -1, 0, 2, 990)),
    ("rectangular, tall", 20016, 15000, (-700, -1, 0, 2, 990)),
    ("rectangular, R does not divide n", 20016, 20013,
     (-700, -1, 0, 2, 990)),
    ("unsorted with duplicates", 1728, 1728, (5, -3, 0, 5, -3, 144, -144)),
    ("64 diagonals", 4000, 4000, tuple(range(-40, 24))),
    ("past m, no interior", 1000, 1000, (-1200, -3, 0, 2, 1001)),
    ("halo shard, L + 2w rows", 3456 + 2 * 144, 3456 + 2 * 144,
     (-144, -12, -1, 0, 1, 12, 144)),
    ("no diagonals", 64, 64, ()),
    ("125 B-spline diagonals", 1728, 1728,
     tuple(a * 144 + b * 12 + c for a in range(-2, 3) for b in range(-2, 3)
           for c in range(-2, 3))),
    ("125 unsorted, repeated, past m", 2000, 2000,
     tuple(range(600, -600, -10)) + (5, -3, 5, -3000, 1 << 40)),
])
def test_mv_walk_equals_plain_on_container_cases(entry, name, m, n, offsets):
    data, x = mv_case(m, n, offsets, entry, m + n + len(offsets))
    plan = hold_walk(data, offsets, x, (MV_TERMS, 32))
    if name == "past m, no interior":
        assert plan.lo == plan.hi


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_mv_walk_on_misaligned_views(entry):
    # x handed in as the contiguous view x[1:] and data whose rows start
    # misaligned take R = 1, and stay bit for bit
    storage, xdt = ENTRIES[entry]
    m, offsets = 20016, (-144, -12, -1, 0, 1, 12, 144)
    data, x = mv_case(m, m + 1, offsets, entry, 7)
    view = x[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    assert hold_walk(data, offsets, view).r == 1
    buf = torch.zeros(len(offsets) * m + 8, dtype=storage)
    shifted = buf[1:1 + len(offsets) * m].view(len(offsets), m)
    shifted.copy_(data)
    assert hold_walk(shifted, offsets, x[:m]).r == 1


def test_mv_walk_on_transposes():
    from pykrylov_tpu_torch.sparse import formats as F
    rng = np.random.default_rng(3)
    m, offsets = 20016, (-7000, -3, 0, 2, 5, 131)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m)))
    for k, off in enumerate(offsets):
        i = torch.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    t = K.dia_transpose(F.DIA(data.float(), offsets, (m, m)))
    x = torch.from_numpy(rng.standard_normal(m)).float()
    hold_walk(t.data, t.offsets, x)
    hold_walk(t.data, t.offsets, x.double())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_mv_walk_matches_the_pallas_kernel(entry):
    # the JAX package's DIA product as tests/test_torch_dia.py runs it: the
    # Pallas kernel in interpret mode on the same stored values (widened to
    # f64 for the mixed entries, whose compute is f64)
    storage, xdt = ENTRIES[entry]
    rng = np.random.default_rng(21)
    vals, rows, cols, shape = poisson3d_coo(12)
    vals = vals * (1.0 + 0.3 * rng.standard_normal(len(vals)))
    npdt = {torch.float32: np.float32, torch.float64: np.float64,
            torch.bfloat16: ml_dtypes.bfloat16}[storage]
    v = np.asarray(vals, dtype=npdt)
    if xdt == torch.float64:
        v = v.astype(np.float64)
    jdia = JF.dia_from_coo(JF.coo_from_arrays(v, rows, cols, shape),
                           device=False)
    dia = convert.from_numpy(jdia, device="cpu")
    data = dia.data if dia.data.dtype == storage else dia.data.to(storage)
    assert torch.equal(data.to(dia.data.dtype), dia.data)
    xnp = rng.standard_normal(shape[0]).astype(
        np.float64 if xdt == torch.float64 else np.float32)
    x = torch.from_numpy(xnp)
    plan = K.dia_matvec_plan(data, dia.offsets, x)
    assert plan.r == 16 // data.element_size()      # 1728 rows
    y = emulate_mv(data, dia.offsets, x, plan)
    assert torch.equal(y, K.dia_matvec_plain(data, dia.offsets, x))
    assert y.dtype == xdt
    tol = 1e-12 if xdt == torch.float64 else 1e-6
    assert rel(y, pallas(jdia, xnp, 1024)) <= tol
