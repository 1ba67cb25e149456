"""The DIA and SELL SpMM kernels against their plain versions and against
the SpMV kernels on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_spmm_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)

Each SpMM kernel rounds every product and sum in its SpMV kernel's order,
so column k of a block product equals the SpMV kernel on column k bit for
bit, and each equals its plain version bit for bit.  The SELL kernels run
over the card form of BELL containers, which is held against the
container's own block product within 1e-12 relative in f64 and 1e-6 in f32
(the container sums 4-row groups in torch's order)."""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.solvers import cg_batched
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_bell_card import card_form


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
    b, sell = card_form(card, window, idx_fmt, dtype)
    m, n = b.shape
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, ncols))).to(card, dtype)
    before = S.SELL_MM_LAUNCHES
    Y = S.sell_matmat(sell, X)
    torch.cuda.synchronize()
    assert S.SELL_MM_LAUNCHES == before + 1
    assert Y.shape == (m, ncols) and Y.dtype == dtype
    assert torch.equal(Y, S.sell_matmat_plain(sell, X))
    ref = B.bell_levels_matmat((b,), X, m)
    assert relerr(Y, ref) <= (1e-12 if dtype == torch.float64 else 1e-6)
    for k in range(ncols):
        assert torch.equal(Y[:, k], S.sell_matvec(sell, X[:, k].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [8, 64, 200])
def test_sell_spmm_bf16_storage_and_wide_blocks(card, ncols):
    # bf16 values with an f32 block, and blocks past 128 columns, which
    # the kernel covers in chunks of 128
    b, sell = card_form(card, 1, "packed", torch.bfloat16)
    m, n = b.shape
    X = torch.from_numpy(np.random.default_rng(ncols).standard_normal(
        (n, ncols))).to(card, torch.float32)
    Y = S.sell_matmat(sell, X)
    torch.cuda.synchronize()
    assert Y.dtype == torch.float32
    assert torch.equal(Y, S.sell_matmat_plain(sell, X))
    for k in (0, ncols // 2, ncols - 1):
        assert torch.equal(Y[:, k], S.sell_matvec(sell, X[:, k].contiguous()))


@pytest.mark.cuda
def test_cg_batched_through_a_bell_operator(card):
    # every block product of a BELL operator is one SELL SpMM launch
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=4,
                                                coupling=0)
    A = B.bell_operator((vals.astype(np.float64), rows, cols, shape),
                        symmetric=True, device=card)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (shape[0], 4))).to(card)
    rhs = A @ X
    S.SELL_MM_LAUNCHES = 0
    S.SELL_LAUNCHES = 0
    res = cg_batched(A, rhs, rtol=1e-6)
    torch.cuda.synchronize()
    assert S.SELL_MM_LAUNCHES == int(res.n_matvec) > 0
    assert S.SELL_LAUNCHES == 0
    assert bool(res.converged.all())


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
