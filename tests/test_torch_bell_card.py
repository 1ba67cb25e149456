"""The BELL kernel against its plain version on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_bell_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)"""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the BELL kernel has no CPU mode)")
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


@pytest.mark.cuda
@pytest.mark.parametrize("window,idx_fmt", [(1, "packed"), (1, "int8"),
                                            (2, "packed")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_kernel_matches_plain(card, dtype, window, idx_fmt):
    # f64 within 1e-12 relative; f32 and bf16 storage (f32 sums) within
    # 1e-6: the plain version adds group sums in another order
    vals, rows, cols, (m, n) = wide_window()
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, (m, n),
                                          device=None),
                        spill_cost=None, window=window, segment=True,
                        idx_fmt=idx_fmt, device=card)
    b = B.bell_with_values_dtype(b, dtype)
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n)).to(
        card, xdt)
    before = B.BELL_LAUNCHES
    y = B.bell_matvec(b, x, m)
    torch.cuda.synchronize()
    assert B.BELL_LAUNCHES == before + 1
    ref = B.bell_matvec_plain(b, x, m)
    err = ((y - ref).abs().max() / ref.abs().max()).item()
    assert err <= (1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_fmt", ["packed", "int8"])
def test_kernel_propagates_non_finite_x_as_plain(card, idx_fmt):
    # the kernel multiplies padding slots as the plain version does, so a
    # NaN in x that only padding reaches gives NaN in both: x is NaN at
    # three band starts (a padding slot's index is 0) that no stored entry
    # of the matrix reaches (765 of the 2048 rows become NaN)
    vals, rows, cols, (m, n) = wide_window()
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, (m, n),
                                          device=None),
                        spill_cost=None, window=1, segment=True,
                        idx_fmt=idx_fmt, device=card)
    x = np.random.default_rng(3).standard_normal(n)
    x[np.setdiff1d(np.arange(0, n, B.LANES), cols)[:3]] = np.nan
    x = torch.from_numpy(x).to(card)
    y = B.bell_matvec(b, x, m)
    ref = B.bell_matvec_plain(b, x, m)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all()
    assert torch.equal(torch.isnan(y), nan)
    err = ((y - ref)[~nan].abs().max() / ref[~nan].abs().max()).item()
    assert err <= 1e-12
