"""The port's LSQR, LSMR, CRAIG and CRAIG-MR against the JAX package's, on
the same inputs.

Both run in float64 on the CPU, the port in eager loops with its scalars
on host floats, the JAX package in fused loops with float64 device
scalars.  They take the same steps up to rounding (``math.hypot`` against
``jnp.hypot``, one fused multiply-add against two roundings, ``||x||``
from a Gram matrix in LSMR), so on systems that converge before their
Krylov space is exhausted (singular values in [1, 2]) the tolerances are:
``n_iter``, ``n_matvec`` and ``istop`` equal; ``x`` and the ``info``
norms within 1e-10 relative; residual histories within 1e-8 relative.
``sym_ortho`` is held bit for bit.  The cases mirror ``tests/test_lls.py``
and check the same closed forms (``lstsq``, the SQD solutions).
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.solvers import craig as jax_craig
from pykrylov_tpu.solvers import craigmr as jax_craigmr
from pykrylov_tpu.solvers import lsmr as jax_lsmr
from pykrylov_tpu.solvers import lsqr as jax_lsqr
from pykrylov_tpu.solvers.lls_common import sym_ortho as jax_sym_ortho
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import craig, craigmr, lsmr, lsqr
from pykrylov_tpu_torch.solvers.lls_common import sym_ortho
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import formats as TF
from pykrylov_tpu_torch.sparse import linop as TL

import chip_smoke

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


X_RTOL = 1e-10
HIST_RTOL = 1e-8

SOLVERS = {"lsqr": (lsqr, jax_lsqr), "lsmr": (lsmr, jax_lsmr),
           "craig": (craig, jax_craig), "craigmr": (craigmr, jax_craigmr)}
INFO_KEYS = {
    "lsqr": ("r1norm", "r2norm", "Anorm", "Acond", "Arnorm", "xnorm",
             "bnorm"),
    "lsmr": ("normr", "normar", "normA", "condA", "normx", "x_nrg2"),
    "craig": ("r1norm", "r2norm", "Arnorm", "xnorm", "rNrgNorm2",
              "xNrgNorm2"),
    "craigmr": ("xNrgNorm2", "trncDirErr"),
}


def rect(m, n, lo=1.0, hi=2.0, seed=0):
    """``U diag(s) V^T`` with random orthonormal U (m x k), V (n x k),
    k = min(m, n), and singular values s evenly in [lo, hi]: the solvers
    converge well before k iterations."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (U * np.linspace(lo, hi, k)) @ V.T


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    if scale == 0:
        return np.abs(a).max() if a.size else 0.0
    return np.abs(a - b).max() / scale


def both(name, A, b, M=None, N=None, **opts):
    """(port result, JAX result) of solver ``name`` on dense A and b."""
    port, jax = SOLVERS[name]
    t = port(MatrixOperator(torch.from_numpy(A), device=DEV),
             torch.from_numpy(b),
             M=None if M is None else DiagonalOperator(
                 torch.from_numpy(M), device=DEV),
             N=None if N is None else DiagonalOperator(
                 torch.from_numpy(N), device=DEV), **opts)
    j = jax(JMatrix(jnp.asarray(A)), jnp.asarray(b),
            M=None if M is None else JDiagonal(jnp.asarray(M)),
            N=None if N is None else JDiagonal(jnp.asarray(N)), **opts)
    return t, j


def assert_same(name, t, j):
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.istop) == int(j.istop)
    assert int(t.n_matvec) == int(j.n_matvec) == 2 * int(t.n_iter)
    assert bool(t.converged) == bool(j.converged)
    assert bool(t.info["optimal"]) == bool(j.info["optimal"])
    assert rel(t.x.numpy(), j.x) <= X_RTOL
    for key in INFO_KEYS[name]:
        # an absolute floor for the estimates that converge to 0 and end at
        # rounding level (Arnorm and the residual of a consistent system)
        assert float(t.info[key]) == pytest.approx(
            float(j.info[key]), rel=X_RTOL, abs=1e-14), key
    assert float(t.resid_norm) == pytest.approx(float(j.resid_norm),
                                                rel=X_RTOL, abs=1e-14)
    assert rel(float(t.resid_norm0), float(j.resid_norm0)) <= X_RTOL
    if name == "craig":
        assert rel(t.info["r"].numpy(), j.info["r"]) <= X_RTOL
    if j.resid_history is not None:
        k = int(j.n_iter) + 1
        th, jh = t.resid_history.numpy(), np.asarray(j.resid_history)
        assert rel(th[:k], jh[:k]) <= HIST_RTOL
        assert np.isnan(th[k:]).all() and np.isnan(jh[k:]).all()


@pytest.fixture
def overdetermined():
    A = rect(120, 50, seed=1)
    rng = np.random.default_rng(2)
    b = A @ rng.standard_normal(50) + 0.01 * rng.standard_normal(120)
    x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
    return A, b, x_ls


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
class TestLsqrLsmr:
    def test_overdetermined_least_squares(self, name, overdetermined):
        A, b, x_ls = overdetermined
        t, j = both(name, A, b, atol=1e-12, btol=1e-12, etol=0.0,
                    itnlim=500, store_history=True)
        assert_same(name, t, j)
        assert bool(t.converged) and int(t.istop) == 2
        np.testing.assert_allclose(t.x.numpy(), x_ls, atol=1e-10)

    def test_consistent_square_system(self, name):
        A = rect(50, 50, seed=3)
        b = A @ np.ones(50)
        t, j = both(name, A, b, atol=1e-12, btol=1e-12, etol=0.0,
                    itnlim=500)
        assert_same(name, t, j)
        assert int(t.istop) == 1
        np.testing.assert_allclose(t.x.numpy(), np.ones(50), atol=1e-9)

    def test_damped(self, name, overdetermined):
        A, b, _ = overdetermined
        damp = 0.5
        t, j = both(name, A, b, damp=damp, atol=1e-13, btol=1e-13,
                    etol=0.0, itnlim=1000, store_history=True)
        assert_same(name, t, j)
        x_damp = np.linalg.solve(A.T @ A + damp ** 2 * np.eye(50), A.T @ b)
        np.testing.assert_allclose(t.x.numpy(), x_damp, atol=1e-9)

    def test_underdetermined_min_norm(self, name):
        A = rect(40, 90, seed=4)
        b = A @ np.random.default_rng(5).standard_normal(90)
        x_mn = A.T @ np.linalg.solve(A @ A.T, b)
        t, j = both(name, A, b, atol=1e-12, btol=1e-12, etol=0.0,
                    itnlim=500)
        assert_same(name, t, j)
        np.testing.assert_allclose(t.x.numpy(), x_mn, atol=1e-8)

    def test_zero_rhs(self, name):
        A = rect(30, 20, seed=6)
        t, j = both(name, A, np.zeros(30))
        assert_same(name, t, j)
        assert bool(t.converged) and int(t.istop) == 0
        np.testing.assert_array_equal(t.x.numpy(), np.zeros(20))

    def test_itnlim(self, name, overdetermined):
        A, b, _ = overdetermined
        t, j = both(name, A, b, atol=0.0, btol=0.0, conlim=0.0, etol=0.0,
                    itnlim=5, store_history=True)
        assert_same(name, t, j)
        assert int(t.istop) == 7 and int(t.n_iter) == 5

    def test_etol_window_stop(self, name, overdetermined):
        # the truncated direct-error window (istop 8) at the defaults
        A, b, _ = overdetermined
        t, j = both(name, A, b, store_history=True)
        assert_same(name, t, j)
        assert int(t.istop) == 8

    def test_norm_estimates(self, name, overdetermined):
        A, b, x_ls = overdetermined
        t, _ = both(name, A, b, atol=1e-12, btol=1e-12, etol=0.0,
                    itnlim=500)
        key = "Anorm" if name == "lsqr" else "normA"
        fro = np.linalg.norm(A, "fro")
        assert 0.1 * fro <= float(t.info[key]) <= 1.5 * fro
        xkey = "xnorm" if name == "lsqr" else "normx"
        assert float(t.info[xkey]) == pytest.approx(np.linalg.norm(x_ls),
                                                    rel=1e-6)

    def test_verify_final(self, name):
        rng = np.random.default_rng(40)
        A = rect(120, 80, seed=7)
        b = rng.standard_normal(120)
        damp = 0.3
        t, j = both(name, A, b, damp=damp, atol=1e-12, btol=1e-12,
                    verify_final=True)
        assert_same(name, t, j)
        x = t.x.numpy()
        rt = b - A @ x
        ar = A.T @ rt - damp ** 2 * x
        for key, want in (("true_resid_norm", np.linalg.norm(rt)),
                          ("true_normar", np.linalg.norm(ar))):
            assert float(t.info[key]) == pytest.approx(want, rel=1e-10,
                                                       abs=1e-14)
            assert float(t.info[key]) == pytest.approx(float(j.info[key]),
                                                       rel=1e-6, abs=1e-12)


class TestLsqrSQD:
    def test_sqd_2x2(self):
        """The reference's demo system (``lls/lsqr.py:457-472``):
        [2 1; 1 -3][r; x] = [2; 0] with M=inv(2), N=inv(3), damp=1."""
        t, j = both("lsqr", np.array([[1.0]]), np.array([2.0]),
                    M=np.array([0.5]), N=np.array([1.0 / 3.0]), damp=1.0,
                    atol=1e-14, btol=1e-14, etol=0.0)
        assert_same("lsqr", t, j)
        assert float(t.x[0]) == pytest.approx(2.0 / 7.0, abs=1e-12)

    def test_weighted_rectangular(self):
        # M and N as diagonal inner weights on a rectangular system
        A = rect(150, 60, seed=8)
        rng = np.random.default_rng(9)
        b = rng.standard_normal(150)
        M = rng.uniform(0.8, 1.25, 150)
        N = rng.uniform(0.8, 1.25, 60)
        for name in ("lsqr", "lsmr", "craig"):
            t, j = both(name, A, b, M=M, N=N, atol=1e-12, btol=1e-12,
                        etol=0.0 if name != "craig" else 1e-14,
                        itnlim=400)
            assert_same(name, t, j)

    def test_wantvar(self):
        A = rect(80, 40, seed=10)
        b = A @ np.ones(40)
        t, j = both("lsqr", A, b, atol=1e-12, btol=1e-12, etol=0.0,
                    itnlim=200, wantvar=True)
        assert_same("lsqr", t, j)
        var = t.info["var"].numpy()
        assert var.shape == (40,) and np.all(var > 0)
        assert rel(var, j.info["var"]) <= X_RTOL
        true_var = np.diag(np.linalg.inv(A.T @ A))
        assert np.linalg.norm(var - true_var) / np.linalg.norm(true_var) \
            < 0.5


class TestCraig:
    def test_sqd_solution(self):
        """Default M=N=I: x solves [I A; A' -I][r;x]=[b;0], i.e.
        x = A'(AA'+I)^{-1} b, and r = b - Ax."""
        A = rect(50, 50, seed=11)
        b = A @ np.ones(50)
        t, j = both("craig", A, b, btol=1e-12, etol=1e-14, itnlim=500)
        assert_same("craig", t, j)
        assert bool(t.converged)
        x_sqd = A.T @ np.linalg.solve(A @ A.T + np.eye(50), b)
        np.testing.assert_allclose(t.x.numpy(), x_sqd, atol=1e-10)
        np.testing.assert_allclose(t.info["r"].numpy(), b - A @ x_sqd,
                                   atol=1e-10)

    def test_underdetermined(self):
        A = rect(40, 90, seed=12)
        b = A @ np.random.default_rng(13).standard_normal(90)
        t, j = both("craig", A, b, btol=1e-12, etol=1e-14, itnlim=500,
                    store_history=True)
        assert_same("craig", t, j)
        x_sqd = A.T @ np.linalg.solve(A @ A.T + np.eye(40), b)
        np.testing.assert_allclose(t.x.numpy(), x_sqd, atol=1e-9)

    def test_matvec_accounting(self):
        A = rect(30, 30, seed=14)
        t, j = both("craig", A, np.ones(30), itnlim=10, btol=0.0, etol=0.0)
        assert_same("craig", t, j)
        assert int(t.istop) == 7 and int(t.n_matvec) == 20

    def test_zero_rhs(self):
        t, j = both("craig", rect(30, 20, seed=15), np.zeros(30))
        assert_same("craig", t, j)
        assert bool(t.converged) and int(t.n_iter) == 0
        np.testing.assert_array_equal(t.x.numpy(), np.zeros(20))

    def test_primal_dual_iterates(self):
        """Reference parity: craig.py:100-101 iterates_p / iterates_d."""
        A = rect(30, 70, seed=16)
        b = A @ np.random.default_rng(17).standard_normal(70)
        t, j = both("craig", A, b, btol=1e-10, etol=1e-12, itnlim=200,
                    store_iterates=True)
        assert_same("craig", t, j)
        k = int(t.n_iter)
        ip, idu = t.info["iterates_p"].numpy(), t.info["iterates_d"].numpy()
        assert ip.shape == (201, 70) and idu.shape == (201, 30)
        assert rel(ip[:k + 1], np.asarray(j.info["iterates_p"])[:k + 1]) \
            <= X_RTOL
        assert rel(idu[:k + 1], np.asarray(j.info["iterates_d"])[:k + 1]) \
            <= X_RTOL
        np.testing.assert_array_equal(ip[k], t.x.numpy())
        np.testing.assert_array_equal(idu[k], t.info["r"].numpy())
        assert np.isnan(ip[k + 1:]).all()

    def test_verify_final(self):
        A = rect(40, 90, seed=18)
        b = A @ np.random.default_rng(19).standard_normal(90)
        t, j = both("craig", A, b, btol=1e-12, etol=0.0, itnlim=400,
                    verify_final=True)
        assert_same("craig", t, j)
        x, r = t.x.numpy(), t.info["r"].numpy()
        assert float(t.info["true_dual_resid"]) == pytest.approx(
            np.linalg.norm(b - A @ x - r), rel=1e-9, abs=1e-14)
        assert float(t.info["true_primal_resid"]) == pytest.approx(
            np.linalg.norm(A.T @ r - x), rel=1e-9, abs=1e-14)
        assert float(t.info["true_dual_resid"]) < 1e-6 * np.linalg.norm(b)
        assert float(t.info["true_primal_resid"]) < 1e-6 * np.linalg.norm(b)


class TestCraigMR:
    def test_regularized_dual_solution(self):
        """CRAIG-MR's iterate is the dual y = (AA' + I)^{-1} b (length m,
        ``craigmr.py:112``)."""
        A = rect(40, 90, seed=20)
        b = A @ np.random.default_rng(21).standard_normal(90)
        t, j = both("craigmr", A, b, etol=1e-13, itnlim=400,
                    store_history=True)
        assert_same("craigmr", t, j)
        assert int(t.istop) == 8 and t.x.shape == (40,)
        np.testing.assert_allclose(
            t.x.numpy(), np.linalg.solve(A @ A.T + np.eye(40), b), atol=1e-9)

    def test_iteration_limit(self):
        t, j = both("craigmr", rect(30, 30, seed=22), np.ones(30), etol=0.0,
                    itnlim=7)
        assert_same("craigmr", t, j)
        assert int(t.istop) == 7 and int(t.n_iter) == 7

    def test_zero_rhs(self):
        t, j = both("craigmr", rect(30, 20, seed=23), np.zeros(30))
        assert_same("craigmr", t, j)
        assert bool(t.converged) and int(t.n_iter) == 0

    def test_verify_final(self):
        A = rect(40, 90, seed=24)
        b = A @ np.random.default_rng(25).standard_normal(90)
        t, j = both("craigmr", A, b, etol=1e-13, itnlim=400,
                    verify_final=True)
        assert_same("craigmr", t, j)
        y = t.x.numpy()
        want = np.linalg.norm(b - A @ (A.T @ y) - y)
        assert float(t.info["true_dual_resid"]) == pytest.approx(
            want, rel=1e-9, abs=1e-14)
        assert float(t.info["true_dual_resid"]) < 1e-6 * np.linalg.norm(b)


def _bits(v):
    return struct.pack("<d", float(v))


def test_sym_ortho_bit_for_bit():
    """sym_ortho against the JAX package's on a grid with zeros, both
    signs and magnitudes far apart (``lls/lsmr.py:495-519``)."""
    vals = (0.0, 1.0, -1.0, 3.0, -4.0, 2.5e-7, -7.3e5, 1e-30, -1e30,
            0.1, -np.pi)
    for a in vals:
        for b in vals:
            port = sym_ortho(a, b)
            ref = jax_sym_ortho(jnp.float64(a), jnp.float64(b))
            assert [_bits(v) for v in port] == [_bits(v) for v in ref], \
                (a, b, port, [float(v) for v in ref])


def test_sym_ortho_reference_branches():
    # sign(0) == 1, and b == 0 takes precedence over a == 0
    assert sym_ortho(0.0, 0.0) == (1.0, 0.0, 0.0)
    assert sym_ortho(-2.0, 0.0) == (-1.0, 0.0, 2.0)
    assert sym_ortho(0.0, -3.0) == (0.0, -1.0, 3.0)
    c, s, r = sym_ortho(3.0, 4.0)
    assert r == 5.0 and c * 3.0 + s * 4.0 == pytest.approx(5.0)


def test_lsqr_normal_eqns_history():
    """Reference parity: lsqr.py:80,304 normal_eqns_resids telemetry."""
    A = rect(60, 25, seed=26)
    rng = np.random.default_rng(27)
    b = A @ np.ones(25) + 0.01 * rng.standard_normal(60)
    t, j = both("lsqr", A, b, atol=1e-10, btol=1e-10, etol=0.0, itnlim=200,
                store_history=True)
    assert_same("lsqr", t, j)
    k = int(t.n_iter)
    ne = t.info["normal_eqns_resids"].numpy()
    assert rel(ne[:k + 1], np.asarray(j.info["normal_eqns_resids"])[:k + 1]) \
        <= HIST_RTOL
    assert ne[k] == pytest.approx(float(t.info["Arnorm"]), rel=1e-12)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_istop_tables_match_jax(name):
    import importlib
    port = importlib.import_module("pykrylov_tpu_torch.solvers." + name)
    ref = importlib.import_module("pykrylov_tpu.solvers." + name)
    assert port.ISTOP_MSG == ref.ISTOP_MSG
    assert pt.ISTOP_MSGS[name] is port.ISTOP_MSG


def _sparse_rect():
    """A 700 x 300 sparse matrix: 2.5 entries a row at random plus a
    diagonal of 4 on the first 300 rows, so its singular values stay away
    from 0."""
    rng = np.random.default_rng(28)
    rows = rng.integers(0, 700, 1750)
    cols = rng.integers(0, 300, 1750)
    vals = rng.standard_normal(1750)
    d = np.arange(300)
    rows, cols = np.concatenate([rows, d]), np.concatenate([cols, d])
    vals = np.concatenate([vals, np.full(300, 4.0)])
    key = rows * 300 + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    first = np.r_[True, key[1:] != key[:-1]]
    sums = np.add.reduceat(vals, np.flatnonzero(first))
    return sums, rows[first], cols[first], (700, 300)


@pytest.mark.parametrize("name", ["lsqr", "craig"])
def test_rectangular_bell_matches_jax(name):
    # a rectangular BELL operator in both packages: the port's products
    # over the card form's plain version (both directions), the JAX
    # package's over the Pallas kernel in interpret mode
    t3 = _sparse_rect()
    top = TB.bell_operator(t3, device=DEV)
    assert top.fmt == "bell" and top.shape == (700, 300)
    assert set(top.cards) == {"fwd", "bwd"}
    jop = JB.bell_operator(JF.coo_from_arrays(*t3, device=False),
                           interpret=True)
    b = np.random.default_rng(29).standard_normal(700)
    opts = dict(btol=1e-10, itnlim=300)
    opts.update(atol=1e-10, etol=0.0) if name == "lsqr" else opts.update(
        etol=1e-12)
    port, jax = SOLVERS[name]
    t = port(top, torch.from_numpy(b), store_history=True, **opts)
    j = jax(jop, jnp.asarray(b), store_history=True, **opts)
    assert_same(name, t, j)
    assert bool(t.converged)


def test_state_estimation_on_cpu():
    # the chip's rectangular case at 2 areas: ``_try_bell`` packs A and
    # A^T (no ELL transpose, no row split, no permutation), the CPU auto
    # policy takes ELL, and ``solve`` (LSMR) meets the certificate
    vals, rows, cols, shape = chip_smoke.se_coo(2)
    assert shape == (5216, 2276) and len(vals) == 2 * 6982
    bell = TL._try_bell(TF.coo_from_arrays(vals, rows, cols, shape,
                                           device=None), False, device=DEV)
    assert isinstance(bell, TB.BellOperator)
    assert set(bell.cards) == {"fwd", "bwd"}
    assert bell._args["bwd_ell"] is None and bell.split_rows == 0
    assert bell.solve_permutation is None
    A = pt.sparse.operator_from_coo(vals, rows, cols, shape, device=DEV)
    assert A.fmt == "ell"
    rng = np.random.default_rng(0)
    ax = A * torch.from_numpy(rng.standard_normal(shape[1]))
    b = ax + 0.01 * ax.abs().mean() * torch.from_numpy(
        rng.standard_normal(shape[0]))
    res = pt.solve(A, b, atol=1e-6, btol=1e-6, etol=0)
    assert int(res.istop) in (1, 2)
    r = b - A * res.x
    fro = np.sqrt((vals.astype(np.float64) ** 2).sum())
    cert = float(torch.linalg.vector_norm(A.T * r)
                 / (fro * torch.linalg.vector_norm(r)))
    assert cert <= 1e-5
