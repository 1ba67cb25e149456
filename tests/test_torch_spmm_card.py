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


def hold_dia_spmm(data, offsets, X):
    """One launch of the DIA SpMM kernel on (data, offsets, X), held bit
    for bit against its plain version and, column by column, against the
    SpMV kernel; returns the block."""
    xdt = torch.promote_types(data.dtype, X.dtype)
    before = K.DIA_MM_LAUNCHES
    Y = K.dia_matmat(data, offsets, X)
    torch.cuda.synchronize()
    assert K.DIA_MM_LAUNCHES == before + 1
    assert Y.shape == (data.shape[1], X.shape[1]) and Y.dtype == xdt
    assert torch.equal(Y, K.dia_matmat_plain(data, offsets, X))
    for k in range(X.shape[1]):
        assert torch.equal(Y[:, k], K.dia_matvec(data, offsets,
                                                 X[:, k].contiguous()))
    return Y


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 5, 8, 16, 17, 32, 64, 65,
                                   200])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_dia_spmm_matches_plain_and_spmv(card, dtype, ncols):
    # m = 20011 is odd: each diagonal's values start misaligned
    rng = np.random.default_rng(ncols)
    m = 20011
    offsets = (-9000, -130, -1, 0, 3, 129)
    data = rng.standard_normal((len(offsets), m))
    data = torch.from_numpy(data).to(card, dtype)
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    X = torch.from_numpy(rng.standard_normal((m, ncols))).to(card, xdt)
    hold_dia_spmm(data, offsets, X)


def _dia_case(name, card, dtype, ncols):
    """(data, offsets, X) of a named container case; slots whose column
    lies outside [0, n) are zero unless the case says otherwise."""
    rng = np.random.default_rng(len(name) + ncols)
    m, n = 3001, 3001
    offsets = (-260, -3, 0, 1, 257)
    if name == "rectangular, n > m":
        n = 3001 + 45
    elif name == "rectangular, n < m":
        n = 3001 - 70
    elif name == "far offsets":
        # 700 is past the wrapper's tile of 256 rows; +-(m + 2) lie
        # wholly outside the matrix
        offsets = (-m - 2, -700, 0, 700, m + 2)
    elif name == "64 diagonals, one cluster":
        offsets = tuple(range(-40, 24))
    elif name == "64 diagonals, scattered":
        offsets = tuple(sorted(rng.choice(np.arange(-2000, 2000), 64,
                                          replace=False).tolist()))
    elif name == "shorter than a tile":
        m = n = 37
        offsets = (-5, 0, 2)
    elif name == "125 diagonals, unsorted, repeated, past m":
        # the kernels' wide path: offsets as int32, the out-of-range ones
        # clamped
        wide = rng.permutation(np.arange(-1500, 1500, 25))[:118].tolist()
        offsets = tuple(wide + wide[:5] + [-m - 9, 4 * m])
    elif name == "4096 diagonals":
        offsets = tuple(range(-2048, 2048))
    vals = rng.standard_normal((len(offsets), m))
    i = np.arange(m)
    for d, off in enumerate(offsets):
        out = (i + off < 0) | (i + off >= n)
        vals[d, out] = (np.nan if d % 2 else np.inf) \
            if name == "non-finite outside" else 0.0
    data = torch.from_numpy(vals).to(card, dtype)
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    X = torch.from_numpy(rng.standard_normal((n, ncols))).to(card, xdt)
    return data, offsets, X


DIA_CASES = ["rectangular, n > m", "rectangular, n < m", "far offsets",
             "64 diagonals, one cluster", "64 diagonals, scattered",
             "shorter than a tile", "non-finite outside",
             "125 diagonals, unsorted, repeated, past m", "4096 diagonals"]


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("name", DIA_CASES)
def test_dia_spmm_containers(card, name, dtype, ncols):
    data, offsets, X = _dia_case(name, card, dtype, ncols)
    Y = hold_dia_spmm(data, offsets, X)
    assert torch.isfinite(Y).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dia_spmm_unaligned_block(card, dtype):
    # X a contiguous slice of a larger buffer, one element past 16-byte
    # alignment: the wrapper takes the scalar path (V = 1)
    m, k = 20011, 8
    data, offsets, _ = _dia_case("far offsets", card, dtype, k)
    data = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (len(offsets), m))).to(card, dtype)
    buf = torch.from_numpy(np.random.default_rng(5).standard_normal(
        m * k + 1)).to(card, dtype)
    X = buf[1:].view(m, k)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    assert K.dia_matmat_plan(data, offsets, X).v == 1
    hold_dia_spmm(data, offsets, X)
    assert K.dia_matmat_plan(data, offsets, X.clone()).v == 16 // \
        X.element_size()


@pytest.mark.cuda
@pytest.mark.parametrize("ncols,kc", [(8, 4), (64, 4), (64, 16), (64, 32)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["far offsets", "non-finite outside",
                                  "64 diagonals, one cluster"])
def test_dia_spmm_column_panels(card, monkeypatch, name, dtype, ncols, kc):
    # a narrower L2 budget makes the wrapper split the block into panels
    # of kc columns, which the kernel walks panel-major in one launch
    data, offsets, X = _dia_case(name, card, dtype, ncols)
    reach = max(abs(o) for o in offsets)
    monkeypatch.setattr(K, "L2_WINDOW_BYTES",
                        2 * reach * kc * X.element_size())
    assert K.dia_matmat_plan(data, offsets, X).kc == kc
    Y = hold_dia_spmm(data, offsets, X)
    assert torch.isfinite(Y).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [3, 8])
def test_dia_spmm_transpose_of_an_unsymmetric_operator(card, ncols):
    # A.T @ X of an unsymmetric cuda-dia operator runs the kernel over the
    # transposed container
    data, offsets, X = _dia_case("square", card, torch.float32, ncols)
    A = K.cuda_dia_operator(F.DIA(data, offsets, (data.shape[1],) * 2))
    At = K.dia_transpose(A.container)
    before = K.DIA_MM_LAUNCHES
    Y = A.T @ X
    torch.cuda.synchronize()
    assert K.DIA_MM_LAUNCHES == before + 1
    assert torch.equal(Y, K.dia_matmat_plain(At.data, At.offsets, X))
    hold_dia_spmm(At.data, At.offsets, X)
    ref = torch.stack([F.dia_rmatvec(A.container, X[:, k])
                       for k in range(ncols)], dim=1)
    assert relerr(Y, ref) <= 1e-6


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


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_pairs_dia(card, dtype, ncols):
    """f32 or bf16 diagonals with an f64 vector or block: the f32f64 and
    bf16f64 entries compute in f64 and equal the plain versions (the
    widened data's f64 products) bit for bit; each block column equals the
    mixed SpMV on it."""
    rng = np.random.default_rng(100 + ncols)
    m = 20011
    offsets = (-9000, -130, -1, 0, 3, 129)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m))).to(
        card, dtype)
    X = torch.from_numpy(rng.standard_normal((m, ncols))).to(card)
    Y = hold_dia_spmm(data, offsets, X)
    assert Y.dtype == torch.float64
    assert torch.equal(Y, K.dia_matmat_plain(data.double(), offsets, X))
    before = K.DIA_LAUNCHES
    y = K.dia_matvec(data, offsets, X[:, 0].contiguous())
    torch.cuda.synchronize()
    assert K.DIA_LAUNCHES == before + 1 and y.dtype == torch.float64
    assert torch.equal(y, K.dia_matvec_plain(data, offsets,
                                             X[:, 0].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_pairs_sell(card, dtype, ncols):
    b, sell = card_form(card, 1, "packed", dtype)
    m, n = b.shape
    X = torch.from_numpy(np.random.default_rng(200 + ncols).standard_normal(
        (n, ncols))).to(card)
    before = (S.SELL_LAUNCHES, S.SELL_MM_LAUNCHES)
    Y = S.sell_matmat(sell, X)
    y = S.sell_matvec(sell, X[:, 0].contiguous())
    torch.cuda.synchronize()
    assert (S.SELL_LAUNCHES, S.SELL_MM_LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)
    assert Y.dtype == y.dtype == torch.float64
    assert torch.equal(Y, S.sell_matmat_plain(sell, X))
    assert torch.equal(y, S.sell_matvec_plain(sell, X[:, 0].contiguous()))
    for k in range(ncols):
        assert torch.equal(Y[:, k], S.sell_matvec(sell, X[:, k].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_jacobi_preconditioned_f32_solve_on_cuda_dia(card, solver):
    """The solve that raised before the mixed entries: an f32 ``cuda-dia``
    operator with an f64 Jacobi preconditioner, so b and every product
    are f64 (f32 data times f64 vectors)."""
    from pykrylov_tpu_torch import solvers
    from pykrylov_tpu_torch.sparse import (cuda_dia_sparse_operator,
                                           jacobi_preconditioner)
    vals, rows, cols, shape = poisson3d_coo(24)
    rng = np.random.default_rng(9)
    d = rng.uniform(1.0, 3.0, shape[0])
    vals = (vals * d[rows] * d[cols]).astype(np.float32)
    A = cuda_dia_sparse_operator(
        F.coo_from_arrays(vals, rows, cols, shape, device=None),
        symmetric=True, device=card)
    assert A.dtype == torch.float32
    M = jacobi_preconditioner((vals.astype(np.float64), rows, cols, shape),
                              device=card)
    assert M.dtype == torch.float64
    b = torch.from_numpy(rng.standard_normal(shape[0])).to(card,
                                                           torch.float32)
    before = K.DIA_LAUNCHES
    res = getattr(solvers, solver)(A, b, M=M, rtol=1e-8)
    torch.cuda.synchronize()
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert K.DIA_LAUNCHES - before == int(res.n_matvec)
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    r = dense @ res.x.cpu().numpy() - b.double().cpu().numpy()
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b.cpu().numpy())
