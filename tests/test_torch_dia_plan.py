"""The DIA SpMM kernel's host plan (``kernels.dia_mm_plan``) on the CPU.

The plan decides how ``csrc/dia_spmm.cu`` covers a block product: V columns
per thread and tiles of T rows by Kc columns, panel-major.  The kernel
itself runs only on the card (``tests/test_torch_spmm_card.py``); here the
plan is held to its rules, and a torch emulation of the kernel's tile walk
under the plan is held bit for bit against the plain product.
"""

import os
import re

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.sparse import kernels as K

N3 = 240 * 240
POISSON240 = (-N3, -240, -1, 0, 1, 240, N3)
OFFSET_SETS = {
    "poisson240": POISSON240,
    "tridiagonal": (-1, 0, 1),
    "far": (-20016, -700, 0, 600, 20014),
    "64 diagonals": tuple(range(-40, 24)),
    "unsorted with duplicates": (5, -3, 0, 5, -3),
    "none": (),
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
