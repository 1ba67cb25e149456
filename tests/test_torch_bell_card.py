"""The SELL SpMV kernel, over the card form of BELL containers, against its
plain version on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_bell_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)

The kernel adds a row's products one by one in slot order, as its plain
version does, so the two agree bit for bit; against the container's own
product (which sums 4-row groups with ``index_add_``) the bound is 1e-12
relative in f64 and 1e-6 in f32 and bf16 storage (f32 sums)."""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import sell as S


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL kernels have no CPU mode)")
    return "cuda"


def wide_window(m=2048, n=90000, far_frac=0.08, heavy=10, seed=11):
    """Banded rows with a scattered tail and a few heavy rows: spans beyond
    256 bands, so the packer segments, with wide segments among them."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(3, 12, m)
    deg[rng.integers(0, m, heavy)] = 300
    rows = np.repeat(np.arange(m), deg)
    far = rng.random(rows.shape) < far_frac
    cols = np.where(far, rng.integers(0, n, rows.shape),
                    (rows * (n // m) + rng.integers(-300, 301, rows.shape)) % n)
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(len(first))
    return vals, rows[first], cols[first], (m, n)


def card_form(dev, window, idx_fmt, dtype, sigma=S.SIGMA):
    """(BELL container of :func:`wide_window`, its card form) on ``dev``."""
    vals, rows, cols, (m, n) = wide_window()
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, (m, n),
                                          device=None),
                        spill_cost=None, window=window, segment=True,
                        idx_fmt=idx_fmt, device=dev)
    b = B.bell_with_values_dtype(b, dtype)
    return b, S.sell_from_levels((b,), m, sigma=sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("window,idx_fmt", [(1, "packed"), (1, "int8"),
                                            (2, "packed")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_kernel_matches_plain(card, dtype, window, idx_fmt):
    b, sell = card_form(card, window, idx_fmt, dtype)
    m, n = b.shape
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n)).to(
        card, xdt)
    before = S.SELL_LAUNCHES
    y = S.sell_matvec(sell, x)
    torch.cuda.synchronize()
    assert S.SELL_LAUNCHES == before + 1
    assert y.shape == (m,) and y.dtype == xdt
    assert torch.equal(y, S.sell_matvec_plain(sell, x))
    ref = B.bell_levels_matvec((b,), x, m)
    err = ((y - ref).abs().max() / ref.abs().max()).item()
    assert err <= (1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_fmt", ["packed", "int8"])
def test_kernel_propagates_non_finite_x_as_plain(card, idx_fmt):
    # the card kernel equals the card form's plain version on a non-finite
    # x: NaN and inf reach exactly the rows whose stored entries read them
    # (the card form has no padding to spread them further)
    b, sell = card_form(card, 1, idx_fmt, torch.float64)
    m, n = b.shape
    x = np.random.default_rng(3).standard_normal(n)
    x[np.random.default_rng(4).integers(0, n, 40)] = np.nan
    x[np.random.default_rng(5).integers(0, n, 10)] = np.inf
    x = torch.from_numpy(x).to(card)
    y = S.sell_matvec(sell, x)
    ref = S.sell_matvec_plain(sell, x)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all()
    assert torch.equal(torch.isnan(y), nan)
    assert torch.equal(y[~nan], ref[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [32, 256, 4096])
def test_kernel_writes_every_row_once(card, sigma):
    # rows without entries come out 0 (y starts uninitialised), and the
    # window of the length sort changes the layout but not one bit of y
    vals, rows, cols, (m, n) = wide_window()
    keep = rows % 7 != 3                  # every seventh row empty
    b = B.bell_from_coo(F.coo_from_arrays(vals[keep], rows[keep], cols[keep],
                                          (m, n), device=None),
                        spill_cost=None, window=1, segment=True, device=card)
    sell = S.sell_from_levels((b,), m, sigma=sigma)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(n)).to(card)
    y = S.sell_matvec(sell, x)
    torch.cuda.synchronize()
    assert torch.equal(y, S.sell_matvec_plain(sell, x))
    assert torch.equal(y, S.sell_matvec(S.sell_from_levels((b,), m), x))
    assert bool((y[3::7] == 0).all()) and bool((y[0::7] != 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window,idx_fmt", [(1, "packed"), (1, "int8"),
                                            (2, "packed")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_pair_matches_plain(card, dtype, window, idx_fmt):
    # f32 or bf16 values with an f64 x: the f32f64 and bf16f64 entries
    # compute in f64, bit for bit the plain version (the widened values'
    # f64 products)
    b, sell = card_form(card, window, idx_fmt, dtype)
    m, n = b.shape
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(n)).to(
        card)
    before = S.SELL_LAUNCHES
    y = S.sell_matvec(sell, x)
    torch.cuda.synchronize()
    assert S.SELL_LAUNCHES == before + 1
    assert y.shape == (m,) and y.dtype == torch.float64
    assert torch.equal(y, S.sell_matvec_plain(sell, x))
    assert torch.equal(y, S.sell_matvec_plain(
        sell._replace(vals=sell.vals.double()), x))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_jacobi_preconditioned_f32_solve_on_bell(card, solver):
    """An f32 BELL operator (1138bus tiled 8 times) with an f64 Jacobi
    preconditioner: every product goes through the SELL kernel's f32f64
    entry, one launch a matvec; this raised before the mixed entries."""
    from pykrylov_tpu_torch import solvers
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import (jacobi_preconditioner,
                                           operator_from_coo)
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=8,
                                                coupling=0)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          fmt="bell", device=card)
    assert A.dtype == torch.float32
    M = jacobi_preconditioner((vals.astype(np.float64), rows, cols, shape),
                              floor=1.0, device=card)
    b = A * torch.full((shape[0],), 8 ** -0.5, device=card)
    before = S.SELL_LAUNCHES
    res = getattr(solvers, solver)(A, b, M=M, rtol=1e-6)
    torch.cuda.synchronize()
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert S.SELL_LAUNCHES - before == int(res.n_matvec)
    if solver == "minres":
        # the single matrix's count (BASELINE config #2), b scaled by
        # 1/sqrt(tiles) so MINRES's beta1 is the single matrix's
        assert abs(int(res.n_iter) - 412) <= 1
