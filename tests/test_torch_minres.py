"""The port's MINRES against the JAX package's, on the same inputs.

Both run in float64 on the CPU.  The port carries the Givens rotation, the
norm estimates and the stop tests on host floats; in float64 those are the
JAX package's float64 device scalars, so on a system that converges before
its Krylov space is exhausted the two take the same steps up to summation
order: equal ``istop``, ``n_iter`` and ``n_matvec``, x within 1e-10
relative and residual histories within 1e-8 relative.  In float32 the port
keeps those scalars in float64 where the JAX package rounds them to
float32; the 1138bus/Jacobi golden holds both to the same iteration count
within one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled as jax_load_bundled
from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.solvers import minres as jax_minres
from pykrylov_tpu.solvers.minres import ISTOP_MSG as JAX_ISTOP_MSG
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery import poisson3d_coo, tiled_general_coo
from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import minres
from pykrylov_tpu_torch.solvers.minres import ISTOP_MSG
from pykrylov_tpu_torch.sparse import (coo_from_arrays,
                                       cuda_dia_sparse_operator,
                                       operator_from_coo, sparse_operator)

DEV = "cpu"  # the port's entry points default to the card


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def spectral_system(eigs, seed=3):
    """``Q diag(eigs) Q^T`` with a random orthogonal Q, as
    ``tests/test_solve_frontdoor.py:17`` builds its indefinite system, and
    ``b = A x_true``."""
    n = len(eigs)
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * eigs) @ Q.T
    A = 0.5 * (A + A.T)
    x_true = rng.standard_normal(n)
    return A, x_true, A @ x_true


def gapped(n, lo=1.0, hi=5.0):
    """A spectrum in [-hi, -lo] and [lo, hi] (condition hi/lo), so MINRES
    converges well before n iterations."""
    e = np.linspace(-hi, hi, n)
    return np.where(np.abs(e) < lo, np.where(e < 0, -lo, lo), e)


SYSTEMS = {
    "spd": lambda: spectral_system(np.linspace(1.0, 10.0, 120)),
    "indefinite": lambda: spectral_system(gapped(120)),
}


def both(A, b, M=None, sym=True, **opts):
    """(port result, JAX result) of MINRES on dense A and b (f64)."""
    t = minres(MatrixOperator(torch.from_numpy(A), symmetric=sym,
                              device=DEV), torch.from_numpy(b),
               M=None if M is None else MatrixOperator(
                   torch.from_numpy(M), symmetric=True, device=DEV),
               **opts)
    j = jax_minres(JMatrix(jnp.asarray(A), symmetric=sym), jnp.asarray(b),
                   M=None if M is None else JMatrix(jnp.asarray(M),
                                                    symmetric=True),
                   **opts)
    return t, j


def assert_same(t, j, x_rtol=1e-10, A=None):
    """Equal codes and counts, x within ``x_rtol`` relative; given ``A``
    (a singular system), ``A x`` instead of x, whose null-space part is
    rounding."""
    assert int(t.istop) == int(j.istop)
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    assert bool(t.converged) == bool(j.converged)
    tx, jx = t.x.numpy(), np.asarray(j.x)
    if A is not None:
        tx, jx = A @ tx, A @ jx
    if np.linalg.norm(jx):
        assert rel(tx, jx) <= x_rtol
    else:
        assert not tx.any()


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("rtol", [1e-6, 1e-9])
def test_minres_matches_jax(name, rtol):
    A, x_true, b = SYSTEMS[name]()
    # etol 0 leaves the stop to rtol (code 1)
    t, j = both(A, b, rtol=rtol, etol=0.0, store_history=True)
    assert int(t.istop) == 1
    assert int(t.n_iter) < 0.75 * A.shape[0]   # not an exhausted space
    assert_same(t, j)
    k = int(t.n_iter) + 1
    # residual histories: the estimates phibar, row by row, within 1e-8
    # relative or 1e-12 of the first (rows near the rounding floor)
    jh = np.asarray(j.resid_history)
    np.testing.assert_allclose(t.resid_history[:k].numpy(), jh[:k],
                               rtol=1e-8, atol=1e-12 * jh[0])
    assert np.isnan(t.resid_history[k:].numpy()).all()
    for key in ("Anorm", "Acond", "Arnorm", "ynorm"):
        assert float(t.info[key]) == pytest.approx(float(j.info[key]),
                                                   rel=1e-8)
    assert rel(t.x.numpy(), x_true) <= 100 * rtol


def test_shift_solves_the_shifted_system():
    A, _, b = SYSTEMS["indefinite"]()
    t, j = both(A, b, shift=0.3, rtol=1e-10, etol=0.0, store_history=True,
                verify_final=True)
    assert_same(t, j)
    n = A.shape[0]
    x = t.x.numpy()
    # (A - shift I) x = b to the tolerance; the true residual recorded
    assert np.linalg.norm((A - 0.3 * np.eye(n)) @ x - b) <= \
        1e-8 * np.linalg.norm(b)
    assert float(t.info["true_resid_norm"]) == pytest.approx(
        float(j.info["true_resid_norm"]), abs=1e-10 * np.linalg.norm(b))


def test_history_window_and_iterates():
    A, _, b = SYSTEMS["indefinite"]()
    window = 5
    t, j = both(A, b, rtol=1e-8, window=window, store_history=True,
                store_iterates=True)
    assert_same(t, j)
    k = int(t.n_iter) + 1
    derr = t.info["dir_errors_window"].numpy()
    jderr = np.asarray(j.info["dir_errors_window"])
    assert derr.shape == jderr.shape == (5 * A.shape[0] + 1,)
    # NaN until the window has filled (rows 0..window), then the estimates
    assert np.isnan(derr[:window + 1]).all()
    assert np.isnan(jderr[:window + 1]).all()
    np.testing.assert_allclose(derr[window + 1:k], jderr[window + 1:k],
                               rtol=1e-8)
    assert np.isnan(derr[k:]).all()
    it, jit_ = t.info["iterates"].numpy(), np.asarray(j.info["iterates"])
    assert it.shape == jit_.shape
    np.testing.assert_allclose(it[:k], jit_[:k], rtol=1e-8, atol=1e-12)
    assert np.isnan(it[k:]).all()
    np.testing.assert_array_equal(it[k - 1], t.x.numpy())


def _eigvec_rhs():
    return np.diag([1.0, 2.0, 3.0, 4.0]), np.array([0.0, 1.0, 0.0, 0.0])


def _least_squares():
    # singular (a 3-dimensional null space) and inconsistent: b has a
    # null-space part, so only a least-squares solution exists
    A, _, _ = spectral_system(np.r_[np.zeros(3), gapped(57)])
    return A, np.random.default_rng(7).standard_normal(60)


def _nonsym():
    A = np.diag([2.0, 3.0, 4.0, 5.0])
    A[0, 3] = 1.0
    return A


@pytest.mark.parametrize("code,case", [
    (-1, "eigenvector rhs"), (0, "zero rhs"), (1, "converged"),
    (2, "least squares"), (6, "iteration limit"), (7, "A unsymmetric"),
    (8, "M unsymmetric"), (9, "M indefinite"), (10, "etol window"),
])
def test_every_reachable_code(code, case):
    M = None
    opts = {}
    if case == "eigenvector rhs":
        A, b = _eigvec_rhs()
    elif case == "zero rhs":
        A, b = np.diag([1.0, 2.0, 3.0]), np.zeros(3)
    elif case == "least squares":
        A, b = _least_squares()
        opts = dict(rtol=1e-10)
    elif case == "A unsymmetric":
        A, b = _nonsym(), np.ones(4)
        opts = dict(check=True)
    elif case == "M unsymmetric":
        A, b = np.diag([1.0, 2.0, 3.0, 4.0]), np.ones(4)
        M, opts = _nonsym(), dict(check=True)
    elif case == "M indefinite":
        A, b = np.diag([1.0, 2.0, 3.0, 4.0]), np.ones(4)
        M = -np.eye(4)
    else:
        A, _, b = SYSTEMS["indefinite"]()
        opts = {"converged": dict(rtol=1e-8, etol=0.0),
                "iteration limit": dict(rtol=1e-12, itnlim=7),
                "etol window": dict(rtol=1e-14, etol=0.1)}[case]
    t, j = both(A, b, M=M, sym=case != "A unsymmetric", store_history=True,
                **opts)
    assert int(j.istop) == code
    if case == "least squares":
        # the projection A x of a least-squares x, to the stop's 1e-10 on
        # ||A r|| / (||A|| ||r||)
        assert_same(t, j, x_rtol=1e-6, A=A)
    else:
        assert_same(t, j)
    assert float(t.resid_norm) == pytest.approx(float(j.resid_norm),
                                                rel=1e-8, abs=1e-300)
    assert ISTOP_MSG[code] == JAX_ISTOP_MSG[code]
    assert bool(t.converged) == (code in (0, 1, 2, 3, 4, 10))


def test_istop_table_matches_jax():
    assert ISTOP_MSG == JAX_ISTOP_MSG
    assert pt.ISTOP_MSGS["minres"] is ISTOP_MSG


def test_not_ported_options_raise():
    # replace_every (item 15, verified arithmetic) is ported: ff-MINRES
    # against the JAX package's, in f64 step for step
    A, _, b = SYSTEMS["spd"]()
    op = MatrixOperator(torch.from_numpy(A), symmetric=True, device=DEV)
    t = minres(op, torch.from_numpy(b), rtol=1e-9, replace_every=10)
    j = jax_minres(JMatrix(jnp.asarray(A), symmetric=True), jnp.asarray(b),
                   rtol=1e-9, replace_every=10)
    assert int(t.istop) == int(j.istop) == 1
    for key in ("n_iter", "n_matvec"):
        assert int(getattr(t, key)) == int(getattr(j, key))
    assert int(t.info["n_replacements"]) == int(j.info["n_replacements"])
    assert rel(t.x.numpy(), np.asarray(j.x)) <= 1e-10
    assert set(t.info) == set(j.info)


@pytest.fixture(scope="module")
def bus1138():
    vals, rows, cols, shape = load_bundled("1138bus")
    jv, jr, jc, _ = jax_load_bundled("1138bus")
    assert np.array_equal(vals, jv) and np.array_equal(rows, jr)
    dm = rows == cols
    d = np.zeros(shape[0])
    d[rows[dm]] = vals[dm]
    return vals, rows, cols, shape, 1.0 / np.maximum(np.abs(d), 1.0)


@pytest.mark.parametrize("rtol,golden", [(1e-6, (412,)), (1e-8, (583, 584))])
def test_1138bus_jacobi_golden(bus1138, rtol, golden):
    """BASELINE config #2 (``tests/test_golden.py:101-131``): 412
    iterations at rtol 1e-6 and 583-584 at 1e-8, within one, in float64
    and float32 storage, in both packages."""
    vals, rows, cols, shape, minv = bus1138
    counts = {}
    for dt in (np.float32, np.float64):
        tdt = torch.float32 if dt == np.float32 else torch.float64
        op = sparse_operator((vals.astype(dt), rows, cols, shape),
                             symmetric=True, fmt="ell", device=DEV)
        jop = jax_sparse_operator((vals.astype(dt), rows, cols, shape),
                                  symmetric=True, fmt="ell")
        b = op * torch.ones(shape[0], dtype=tdt)
        t = minres(op, b, M=DiagonalOperator(torch.from_numpy(minv.astype(dt)),
                                             device=DEV),
                   rtol=rtol, itnlim=8000)
        j = jax_minres(jop, jnp.asarray(b.numpy()),
                       M=JDiagonal(jnp.asarray(minv.astype(dt))), rtol=rtol,
                       itnlim=8000)
        assert bool(t.converged) and int(t.istop) == int(j.istop)
        counts[dt] = int(t.n_iter)
        assert abs(int(t.n_iter) - int(j.n_iter)) <= 1
        assert min(abs(int(t.n_iter) - g) for g in golden) <= 1
        if dt == np.float64:
            assert int(t.n_iter) == int(j.n_iter)
            assert rel(t.x.numpy(), j.x) <= 1e-8
    assert abs(counts[np.float32] - counts[np.float64]) <= 1


def test_card_case_tiled_1138bus_f64_jacobi(bus1138):
    """The card's phase 8b at small size: 1138bus tiled 4 times in float32
    storage on the BELL operator, with an f64 Jacobi M, so every product
    is f32 data times an f64 vector (on the CPU, the SELL card form's
    plain version).  The tiles are independent and equal.  MINRES's
    ``Anorm`` estimate includes ``beta1`` (its first ``oldb``), which grows
    as sqrt(tiles) with ``b = A 1``, so ``b = A 1 / sqrt(tiles)`` keeps
    ``beta1`` and every stop test the single matrix's: 412 iterations at
    rtol 1e-6 and 583-584 at 1e-8 (the etol window), within one."""
    _, _, _, shape, minv = bus1138
    vals, rows, cols, tshape = tiled_general_coo("1138bus", tiles=4,
                                                 coupling=0)
    A = operator_from_coo(vals.astype(np.float32), rows, cols, tshape,
                          symmetric=True, fmt="bell", device=DEV)
    assert A.fmt == "bell" and A.dtype == torch.float32
    M = DiagonalOperator(torch.from_numpy(np.tile(minv, 4)), device=DEV)
    b = A * torch.full((tshape[0],), 0.5)
    dense = np.zeros(tshape)
    np.add.at(dense, (rows, cols), vals.astype(np.float32))
    for rtol, golden, code in ((1e-6, (412,), 1), (1e-8, (583, 584), 10)):
        res = minres(A, b, M=M, rtol=rtol, itnlim=8000)
        assert res.x.dtype == torch.float64     # promoted by the f64 M
        assert bool(res.converged) and int(res.istop) == code
        assert min(abs(int(res.n_iter) - g) for g in golden) <= 1
        r = dense @ res.x.numpy() - b.double().numpy()
        assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b.numpy())
    # with b = A 1 instead, beta1 doubles, Anorm grows and MINRES stops at
    # rtol 1e-6 well before the single matrix's 412 iterations
    early = minres(A, A * torch.ones(tshape[0]), M=M, rtol=1e-6, itnlim=8000)
    assert int(early.istop) == 1 and int(early.n_iter) < 400


def test_card_case_shifted_poisson_takes_the_fallback():
    """The card's phase 8 at small size: Poisson n = 12 shifted by a sigma
    midway between its two lowest eigenvalues (one negative eigenvalue),
    on the ``cuda-dia`` operator (on the CPU, the kernel's plain version),
    b standard normal: CG meets the negative pivot and ``solve`` falls back
    to MINRES, which converges."""
    n = 12
    l1 = 12 * np.sin(np.pi / (2 * (n + 1))) ** 2
    l2 = 8 * np.sin(np.pi / (2 * (n + 1))) ** 2 \
        + 4 * np.sin(np.pi / (n + 1)) ** 2
    sigma = 0.5 * (l1 + l2)
    vals, rows, cols, shape = poisson3d_coo(n)
    vals = np.where(rows == cols, vals - sigma, vals)
    A = cuda_dia_sparse_operator(coo_from_arrays(vals, rows, cols, shape,
                                                         device=None),
                                 symmetric=True, device=DEV)
    assert A.fmt == "cuda-dia"
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    ev = np.linalg.eigvalsh(dense)
    assert (ev < 0).sum() == 1
    b = np.random.default_rng(0).standard_normal(shape[0])
    cgr = pt.cg(A, torch.from_numpy(b), rtol=1e-6, check_curvature=True)
    assert int(cgr.istop) == 2
    res = pt.solve(A, torch.from_numpy(b), rtol=1e-6)
    assert bool(res.converged) and int(res.istop) == 1
    assert int(res.n_matvec) == int(res.n_iter)
    assert np.linalg.norm(dense @ res.x.numpy() - b) <= \
        1e-5 * np.linalg.norm(b)
    # SYMMLQ stops on its CG-point estimate against rtol Anorm ynorm, not
    # against ||b||; the card's bound on the true residual is 1e-4
    sym = pt.solve(A, torch.from_numpy(b), method="symmlq", rtol=1e-6)
    assert bool(sym.converged)
    assert np.linalg.norm(dense @ sym.x.numpy() - b) <= \
        1e-4 * np.linalg.norm(b)
