"""The port's block operators against the JAX package's (the cases of
tests/test_blkop.py), and their block rules.

Both packages apply each block in float64 from the same stored values and
concatenate; only BLAS summation order may differ, so products agree to
1e-13 relative (``RTOL``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
import pykrylov_tpu_torch.ops as tops
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.solvers import cg, cg_batched
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo

DEV = "cpu"  # the port's entry points default to the card
RTOL = 1e-13


def same(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL,
                               atol=1e-14)


@pytest.fixture
def mats(rng):
    A = rng.standard_normal((2, 2))
    A = A + A.T                                   # 2x2 symmetric
    B = rng.standard_normal((2, 3))
    C = rng.standard_normal((3, 3))
    C = C + C.T                                   # 3x3 symmetric
    D = rng.standard_normal((3, 2))
    return A, B, C, D


def both(M, **kw):
    return (tops.MatrixOperator(M, device=DEV, **kw),
            jops.MatrixOperator(jnp.asarray(M), **kw))


def grid_pair(grid, **kw):
    t = [[both(M)[0] for M in row] for row in grid]
    j = [[both(M)[1] for M in row] for row in grid]
    return (tops.BlockLinearOperator(t, **kw),
            jops.BlockLinearOperator(j, **kw))


def test_matvec_vs_dense_and_jax(mats, rng):
    A, B, C, D = mats
    t, j = grid_pair([[A, B], [D, C]])
    M = np.block([[A, B], [D, C]])
    assert t.shape == j.shape == (5, 5)
    x = rng.standard_normal(5)
    same(t * torch.from_numpy(x), j * jnp.asarray(x))
    same(t.T * torch.from_numpy(x), j.T * jnp.asarray(x))
    same(t * torch.from_numpy(x), M @ x)
    same(t.T * torch.from_numpy(x), M.T @ x)


def test_rectangular(mats, rng):
    A, B, C, D = mats
    t, j = grid_pair([[A, B]])
    x, y = rng.standard_normal(5), rng.standard_normal(2)
    same(t * torch.from_numpy(x), j * jnp.asarray(x))
    same(t.T * torch.from_numpy(y), j.T * jnp.asarray(y))
    same(t * torch.from_numpy(x), np.hstack([A, B]) @ x)


def test_symmetric_autofill(mats, rng):
    A, B, C, D = mats
    ops_t = [tops.MatrixOperator(A, symmetric=True, device=DEV),
             tops.MatrixOperator(B, device=DEV),
             tops.MatrixOperator(C, symmetric=True, device=DEV)]
    op = tops.BlockLinearOperator([ops_t[:2], ops_t[2:]], symmetric=True)
    assert op.symmetric
    assert op.blocks[1][0].shape == (3, 2)     # the transpose twin
    x = rng.standard_normal(5)
    same(op * torch.from_numpy(x), np.block([[A, B], [B.T, C]]) @ x)
    jop = jops.BlockLinearOperator(
        [[jops.MatrixOperator(A, symmetric=True), jops.MatrixOperator(B)],
         [jops.MatrixOperator(C, symmetric=True)]], symmetric=True)
    same(op * torch.from_numpy(x), jop * jnp.asarray(x))


def test_hermitian_autofill(rng):
    A = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    A = A + A.conj().T
    B = rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3))
    op = tops.BlockLinearOperator(
        [[tops.MatrixOperator(A, hermitian=True, device=DEV),
          tops.MatrixOperator(B, device=DEV)],
         [tops.IdentityOperator(3, dtype=torch.complex128, device=DEV)]],
        hermitian=True)
    x = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    M = np.block([[A, B], [B.conj().T, np.eye(3)]])
    same(op * torch.from_numpy(x), M @ x)


def test_shape_consistency_errors(mats):
    A, B, C, D = mats
    with pytest.raises(tops.ShapeError):
        grid_pair([[A, B], [C, D]])
    with pytest.raises(tops.ShapeError):
        tops.BlockLinearOperator([[both(A)[0], both(B)[0]], [both(C)[0]]])


def test_non_symmetric_diagonal_raises(mats):
    A, B, C, D = mats
    with pytest.raises(ValueError):
        tops.BlockLinearOperator([[both(A)[0], both(B)[0]], [both(C)[0]]],
                                 symmetric=True)


def test_getitem_contains_setitem(mats, rng):
    A, B, C, D = mats
    opA, opB, opC, opD = (both(M)[0] for M in (A, B, C, D))
    op = tops.BlockLinearOperator([[opA, opB], [opD, opC]])
    assert op[0, 0] is opA
    assert opA in op
    assert len(list(iter(op))) == 4
    newA = tops.MatrixOperator(A * 2, device=DEV)
    op[0, 0] = newA
    assert op[0, 0] is newA
    x = rng.standard_normal(5)
    same(op * torch.from_numpy(x), np.block([[2 * A, B], [D, C]]) @ x)


def test_getitem_row_and_column_orientation(rng):
    # blk[0] is the 1xk block row, blk[:, 0] the kx1 column
    mats = [rng.standard_normal(s) for s in ((2, 2), (2, 3), (4, 2), (4, 3))]
    t = [both(M)[0] for M in mats]
    blk = tops.BlockLinearOperator([t[:2], t[2:]])
    row0 = blk[0]
    assert row0.shape == (2, 5)
    x = rng.standard_normal(5)
    same(row0 * torch.from_numpy(x), mats[0] @ x[:2] + mats[1] @ x[2:])
    assert blk[:, 0].shape == (6, 2)


def test_setitem_validates_and_resets_twins(rng):
    A, B = rng.standard_normal((2, 2)), rng.standard_normal((2, 2))
    blk = tops.BlockLinearOperator([[both(A)[0], both(B)[0]]])
    t_before = blk.T
    with pytest.raises(tops.ShapeError):
        blk[0, 1] = tops.MatrixOperator(np.ones((3, 3)), device=DEV)
    blk[0, 1] = tops.MatrixOperator(2.0 * B, device=DEV)
    assert blk.T is not t_before
    x = rng.standard_normal(2)
    same(blk.T * torch.from_numpy(x), np.concatenate([A.T @ x, 2 * B.T @ x]))


def test_block_diagonal_vs_dense_and_jax(mats, rng):
    A, B, C, D = mats
    t = tops.BlockDiagonalLinearOperator(
        [tops.MatrixOperator(A, symmetric=True, device=DEV),
         tops.MatrixOperator(C, symmetric=True, device=DEV)])
    j = jops.BlockDiagonalLinearOperator(
        [jops.MatrixOperator(A, symmetric=True),
         jops.MatrixOperator(C, symmetric=True)])
    assert t.symmetric
    x = rng.standard_normal(5)
    same(t * torch.from_numpy(x), j * jnp.asarray(x))
    same(t.T * torch.from_numpy(x), j.T * jnp.asarray(x))
    M = np.zeros((5, 5))
    M[:2, :2], M[2:, 2:] = A, C
    same(t * torch.from_numpy(x), M @ x)


def test_block_diagonal_slice_and_errors(mats):
    A, B, C, D = mats
    blocks = [both(A)[0], both(C)[0],
              tops.IdentityOperator(4, dtype=torch.float64, device=DEV)]
    op = tops.BlockDiagonalLinearOperator(blocks)
    sub = op[:2]
    assert isinstance(sub, tops.BlockDiagonalLinearOperator)
    assert sub.shape == (5, 5)
    assert op[2] is blocks[2]
    with pytest.raises(ValueError):
        tops.BlockDiagonalLinearOperator([np.eye(2)])


def test_preconditioner_solve_aliases(mats, rng):
    A, B, C, D = mats
    op = tops.BlockDiagonalPreconditioner(
        [tops.DiagonalOperator(np.array([1., 2.]), device=DEV),
         tops.IdentityOperator(3, dtype=torch.float64, device=DEV)])
    x = torch.from_numpy(rng.standard_normal(5))
    assert torch.equal(op.solve(x), op * x)
    bp = tops.BlockPreconditioner([[both(A)[0], both(B)[0]],
                                   [both(D)[0], both(C)[0]]])
    assert torch.equal(bp.solve(x), bp * x)
    h = tops.BlockHorizontalLinearOperator([both(A)[0], both(B)[0]])
    v = tops.BlockVerticalLinearOperator([both(A)[0], both(D)[0]])
    assert h.shape == (2, 5) and v.shape == (5, 2)


def test_block_rule_reaches_each_blocks_spmm():
    # an (n, K) block goes through each sub-operator's native block rule:
    # a block of kernel operators stays on the kernels (one SpMM a block)
    t = poisson3d_coo(6)
    A = operator_from_coo(*t, symmetric=True, fmt="cuda-dia", device=DEV)
    D = tops.DiagonalOperator(np.linspace(1.0, 2.0, 50), device=DEV)
    op = tops.BlockDiagonalLinearOperator([A, D])
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (op.shape[0], 4)))
    calls = []
    mm = A._mm
    A._mm = lambda Z: calls.append(Z.shape) or mm(Z)
    before = K.DIA_MM_LAUNCHES
    Y = op * X
    assert calls == [(A.shape[0], 4)]
    assert K.DIA_MM_LAUNCHES == before     # the plain version on the CPU
    cols = torch.stack([op * X[:, j] for j in range(4)], 1)
    np.testing.assert_allclose(Y.numpy(), cols.numpy(), rtol=1e-14)


def test_cg_on_a_block_diagonal_operator():
    # CG on blocks of two systems solves both: one product of each block
    # an iteration, and cg_batched through both block rules
    t = poisson3d_coo(6)
    A = operator_from_coo(*t, symmetric=True, fmt="cuda-dia", device=DEV)
    a = np.zeros(t[3])
    np.add.at(a, (t[1], t[2]), t[0])
    c = np.diag(np.linspace(1.0, 3.0, 40)) + 0.1
    op = tops.BlockDiagonalLinearOperator(
        [A, tops.MatrixOperator(c, symmetric=True, device=DEV)])
    rng = np.random.default_rng(4)
    b = rng.standard_normal(op.shape[0])
    res = cg(op, torch.from_numpy(b), rtol=1e-10)
    x = res.x.numpy()
    np.testing.assert_allclose(a @ x[:216], b[:216], atol=1e-8)
    np.testing.assert_allclose(c @ x[216:], b[216:], atol=1e-8)
    B = rng.standard_normal((op.shape[0], 3))
    rb = cg_batched(op, torch.from_numpy(B), rtol=1e-10)
    assert bool(rb.converged.all())
