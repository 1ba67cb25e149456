"""The port's BiCGSTAB, CGS and TFQMR against the JAX package's and the
reference's published numbers, and the convection-diffusion gallery.

The jpwh_991 bmark goldens are the reference's (``BASELINE.md``,
``tests/test_golden.py:64-99``): rhs ``A e``, guess ``1 + arange(n)``,
``matvec_max = 2n``; CGS, TFQMR and BiCGSTAB land within 4 of 82, 84 and
84 matvecs at rtol 1e-8 (70, 70 and 64 with the Jacobi preconditioner,
``floor=1``), and CGS at rtol 1e-5 takes 64 with a residual of 4.72e-3
(within 5%).  On ``convdiff2d`` at n = 16 both packages run in float64 on
the same stored matrix: equal ``n_matvec`` and ``istop``, x within 1e-10
relative.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.gallery import convdiff2d_coo as jax_convdiff2d_coo
from pykrylov_tpu.gallery import convdiff2d_matvec as jax_convdiff2d_matvec
from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.solvers import bicgstab as jax_bicgstab
from pykrylov_tpu.solvers import cgs as jax_cgs
from pykrylov_tpu.solvers import tfqmr as jax_tfqmr
from pykrylov_tpu.solvers.bicgstab import ISTOP_MSG as JAX_BICGSTAB_MSG
from pykrylov_tpu.solvers.cgs import ISTOP_MSG as JAX_CGS_MSG
from pykrylov_tpu.solvers.tfqmr import ISTOP_MSG as JAX_TFQMR_MSG
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery import (convdiff2d_coo, convdiff2d_matvec,
                                        convdiff2d_operator)
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.solvers import bicgstab, cgs, tfqmr
from pykrylov_tpu_torch.sparse import (jacobi_preconditioner,
                                       operator_from_coo, sparse_operator)

DEV = "cpu"  # the port's entry points default to the card

SOLVERS = {"cgs": (cgs, jax_cgs), "tfqmr": (tfqmr, jax_tfqmr),
           "bicgstab": (bicgstab, jax_bicgstab)}
# (matvecs unpreconditioned, with Jacobi floor=1): the reference's bmark
BMARK = {"cgs": (82, 70), "tfqmr": (84, 70), "bicgstab": (84, 64)}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jpwh():
    op = sparse_operator("jpwh_991", device=DEV)
    n = 991
    e = torch.ones(n, dtype=torch.float64)
    return op, op * e, e, 1.0 + torch.arange(n, dtype=torch.float64), n


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_jpwh991_bmark(jpwh, name, jacobi):
    op, b, e, guess, n = jpwh
    M = jacobi_preconditioner("jpwh_991", floor=1.0, device=DEV) \
        if jacobi else None
    res = SOLVERS[name][0](op, b, x0=guess, M=M, rtol=1e-8,
                           matvec_max=2 * n)
    assert bool(res.converged) and int(res.istop) == 0
    assert float(res.resid_norm0) == pytest.approx(8.64e3, rel=0.01)
    assert abs(int(res.n_matvec) - BMARK[name][jacobi]) <= 4
    assert float(torch.linalg.vector_norm(res.x - e)) / np.sqrt(n) < 3e-5


def test_cgs_rtol_1e5(jpwh):
    """BASELINE #4: CGS at reltol 1e-5, 64 matvecs, residual 4.72e-3."""
    op, b, e, guess, n = jpwh
    res = cgs(op, b, x0=guess, rtol=1e-5, matvec_max=2 * n)
    assert bool(res.converged)
    assert abs(int(res.n_matvec) - 64) <= 4
    assert float(res.resid_norm) == pytest.approx(4.72e-3, rel=0.05)


def _decades(hist, n_iter, resid0):
    h = np.asarray(hist)[:n_iter + 1]
    out = {}
    for d in range(int(np.floor(np.log10(resid0))), -14, -1):
        idx = np.flatnonzero(h < 10.0 ** d)
        if len(idx) == 0:
            break
        out[d] = int(idx[0])
    return out


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_jpwh991_history_decades(jpwh, name):
    """The residual histories' decade crossings against the checked-in f64
    oracle, as ``tests/test_golden.py:134-190`` checks them."""
    op, b, e, guess, n = jpwh
    res = SOLVERS[name][0](op, b, x0=guess, rtol=1e-8, matvec_max=2 * n,
                           store_history=True)
    assert bool(res.converged)
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "golden_histories.json")
    with open(path) as f:
        ref = json.load(f)["%s_jpwh991_rtol1e-8" % name]
    assert float(res.resid_norm0) == pytest.approx(ref["resid0"], rel=1e-6)
    got = _decades(res.resid_history, int(res.n_iter),
                   float(res.resid_norm0))
    for d, it in ref["decades"]:
        assert d in got, (name, d, got)
        assert abs(got[d] - it) <= max(2, int(0.05 * it)), (name, d, got)


@pytest.fixture(scope="module")
def convdiff():
    coo = convdiff2d_coo(16, wx=40.0, wy=20.0)
    A = operator_from_coo(*coo, device=DEV)
    jA = jax_operator_from_coo(*jax_convdiff2d_coo(16, wx=40.0, wy=20.0))
    return coo, A, jA


@pytest.mark.parametrize("case", ["plain", "x0", "jacobi", "history"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_convdiff_matches_jax(convdiff, name, case):
    coo, A, jA = convdiff
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.shape[0])
    opts = dict(rtol=1e-10)
    jopts = dict(opts)
    if case == "x0":
        x0 = rng.standard_normal(A.shape[0])
        opts["x0"], jopts["x0"] = torch.from_numpy(x0), jnp.asarray(x0)
    elif case == "jacobi":
        d = 1.0 / np.abs(coo[0][coo[1] == coo[2]])
        opts["M"] = pt.ops.DiagonalOperator(torch.from_numpy(d), device=DEV)
        jopts["M"] = JDiagonal(jnp.asarray(d))
    elif case == "history":
        opts["store_history"] = jopts["store_history"] = True
    solver, jax_solver = SOLVERS[name]
    t = solver(A, torch.from_numpy(b), **opts)
    j = jax_solver(jA, jnp.asarray(b), **jopts)
    assert bool(t.converged) and int(t.istop) == int(j.istop) == 0
    assert int(t.n_matvec) == int(j.n_matvec)
    assert int(t.n_iter) == int(j.n_iter)
    assert rel(t.x.numpy(), j.x) <= 1e-10
    if case == "history":
        # within 1e-5 relative: CGS squares the BiCG residual polynomial
        # and TFQMR runs on CGS's vectors, so the summation order's
        # rounding grows to ~1e-6 by their last rows (BiCGSTAB: ~1e-12)
        k = int(t.n_iter) + 1
        jh = np.asarray(j.resid_history)
        np.testing.assert_allclose(t.resid_history[:k].numpy(), jh[:k],
                                   rtol=1e-5, atol=1e-12 * jh[0])
        assert np.isnan(t.resid_history[k:].numpy()).all()


@pytest.mark.parametrize("name,counted", [("bicgstab", 1), ("cgs", 0),
                                          ("tfqmr", 0)])
def test_guess_matvec_convention(convdiff, name, counted):
    """BiCGSTAB counts the matvec that forms ``r0 = b - A x0``; CGS and
    TFQMR do not (``cgs.py:59-60``, ``tfqmr.py:59-60``)."""
    _, A, _ = convdiff
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        A.shape[0]))
    solver = SOLVERS[name][0]
    cold = solver(A, b, rtol=1e-8)
    # a guess of 0 takes the same steps as no guess, plus the guess matvec
    warm = solver(A, b, x0=torch.zeros_like(b), rtol=1e-8)
    assert int(warm.n_iter) == int(cold.n_iter)
    assert int(warm.n_matvec) == int(cold.n_matvec) + counted


def _rotation(n=12):
    """An orthogonal matrix whose first plane is a quarter turn: with b =
    e_1, r0' A r0 = 0, so BiCGSTAB's shadow product vanishes."""
    R = np.eye(n)
    R[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    b = np.zeros(n)
    b[0] = 1.0
    return R, b


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_breakdown_gives_istop_3(name):
    R, b = _rotation()
    solver, jax_solver = SOLVERS[name]
    t = solver(MatrixOperator(torch.from_numpy(R), device=DEV),
               torch.from_numpy(b), rtol=1e-10)
    j = jax_solver(JMatrix(jnp.asarray(R)), jnp.asarray(b), rtol=1e-10)
    assert int(t.istop) == int(j.istop) == 3
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    assert not bool(t.converged)
    assert torch.isfinite(t.x).all()


def test_istop_tables_match_jax():
    from pykrylov_tpu_torch.solvers.bicgstab import ISTOP_MSG as B
    from pykrylov_tpu_torch.solvers.cgs import ISTOP_MSG as C
    from pykrylov_tpu_torch.solvers.tfqmr import ISTOP_MSG as T
    assert (B, C, T) == (JAX_BICGSTAB_MSG, JAX_CGS_MSG, JAX_TFQMR_MSG)
    assert pt.ISTOP_MSGS["bicgstab"] is B


@pytest.mark.parametrize("n,wx,wy", [(8, 20.0, 10.0), (16, 40.0, 20.0),
                                     (5, -3.0, 7.0), (16, 2049.0, 1024.5)])
def test_convdiff_coo_matches_jax_and_dense(n, wx, wy):
    coo = convdiff2d_coo(n, wx=wx, wy=wy)
    jcoo = jax_convdiff2d_coo(n, wx=wx, wy=wy)
    for a, b in zip(coo[:3], jcoo[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert coo[3] == jcoo[3]
    dense = np.zeros(coo[3])
    np.add.at(dense, (coo[1], coo[2]), coo[0])
    x = np.random.default_rng(n).standard_normal(n * n)
    y = convdiff2d_matvec(torch.from_numpy(x), wx, wy).numpy()
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        y, np.asarray(jax_convdiff2d_matvec(jnp.asarray(x), wx, wy)),
        rtol=1e-12, atol=1e-12)
    op = convdiff2d_operator(n, wx, wy, dtype=torch.float64, device=DEV)
    assert not op.symmetric
    np.testing.assert_allclose((op * torch.from_numpy(x)).numpy(),
                               dense @ x, rtol=1e-12, atol=1e-12)
    # the exact transpose reverses the convection
    np.testing.assert_allclose((op.T * torch.from_numpy(x)).numpy(),
                               dense.T @ x, rtol=1e-12, atol=1e-12)
