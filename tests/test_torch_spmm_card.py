"""The DIA and BELL SpMM kernels against their plain versions and against
the SpMV kernels on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_spmm_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)

Each SpMM kernel rounds every product and sum in its SpMV kernel's order,
so column k of a block product equals the SpMV kernel on column k bit for
bit; against the plain version the bound is 1e-12 relative in f64 and
1e-6 in f32 (the plain BELL version sums in torch's order)."""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.solvers import cg_batched
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K

from test_torch_bell_card import wide_window


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SpMM kernels have no CPU mode)")
    return "cuda"


def relerr(y, ref):
    return ((y - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_dia_spmm_matches_plain_and_spmv(card, dtype, ncols):
    rng = np.random.default_rng(ncols)
    m = 20011
    offsets = (-9000, -130, -1, 0, 3, 129)
    data = rng.standard_normal((len(offsets), m))
    data = torch.from_numpy(data).to(card, dtype)
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    X = torch.from_numpy(rng.standard_normal((m, ncols))).to(card, xdt)
    before = K.DIA_MM_LAUNCHES
    Y = K.dia_matmat(data, offsets, X)
    torch.cuda.synchronize()
    assert K.DIA_MM_LAUNCHES == before + 1
    assert Y.shape == (m, ncols) and Y.dtype == xdt
    assert torch.equal(Y, K.dia_matmat_plain(data, offsets, X))
    for k in range(ncols):
        assert torch.equal(Y[:, k], K.dia_matvec(data, offsets,
                                                 X[:, k].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 5, 40])
@pytest.mark.parametrize("window,idx_fmt", [(1, "packed"), (1, "int8"),
                                            (2, "packed")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bell_spmm_matches_plain_and_spmv(card, dtype, window, idx_fmt,
                                          ncols):
    vals, rows, cols, (m, n) = wide_window()
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, (m, n),
                                          device=None),
                        spill_cost=None, window=window, segment=True,
                        idx_fmt=idx_fmt, device=card)
    b = B.bell_with_values_dtype(b, dtype)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, ncols))).to(card, dtype)
    before = B.BELL_MM_LAUNCHES
    Y = B.bell_matmat(b, X, m)
    torch.cuda.synchronize()
    assert B.BELL_MM_LAUNCHES == before + 1
    ref = B.bell_matmat_plain(b, X, m)
    assert relerr(Y, ref) <= (1e-12 if dtype == torch.float64 else 1e-6)
    for k in range(ncols):
        assert torch.equal(Y[:, k], B.bell_matvec(b, X[:, k].contiguous(),
                                                  m))
    # a later level adds into the first's Y, as in the SpMV
    out = torch.ones_like(Y)
    B.bell_matmat(b, X, m, out=out)
    assert torch.equal(out, torch.ones_like(Y).add_(Y))


@pytest.mark.cuda
def test_cg_batched_runs_every_block_product_through_the_kernel(card):
    vals, rows, cols, shape = poisson3d_coo(24, dtype=np.float64)
    dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                           device=None), device=card)
    A = K.cuda_dia_operator(dia, symmetric=True)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (shape[0], 4))).to(card)
    rhs = A @ X
    K.DIA_MM_LAUNCHES = 0
    res = cg_batched(A, rhs, rtol=1e-10)
    torch.cuda.synchronize()
    assert K.DIA_MM_LAUNCHES == int(res.n_matvec) > 0
    assert bool(res.converged.all())
    assert relerr(res.x, X) <= 1e-7
