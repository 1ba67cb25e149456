"""The port's Lanczos bounds and Chebyshev preconditioner against the JAX
package's (the cases of tests/test_chebyshev.py).

Both packages start Lanczos from ``np.random.default_rng(seed)``'s vector,
so the Ritz bounds agree to 1e-10 relative in f64 (``BTOL``: k steps of
the same f64 recurrence, summation order aside).  The polynomial's
scalars are host floats here and f64 device scalars there: ``p(A) x``
agrees to 1e-12 (``PTOL``).  Solves with the preconditioner: the same
iteration counts and stop codes, x to 1e-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
from pykrylov_tpu.gallery import poisson1d_operator as jax_poisson1d
from pykrylov_tpu.solvers import cg as jax_cg
from pykrylov_tpu.solvers import cg_batched as jax_cg_batched
from pykrylov_tpu.solvers import minres as jax_minres

from pykrylov_tpu_torch.gallery import poisson1d_coo, poisson3d_coo
from pykrylov_tpu_torch.ops import (ChebyshevOperator, MatrixOperator,
                                    chebyshev_preconditioner, lanczos_bounds)
from pykrylov_tpu_torch.solvers import cg, cg_batched, minres
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.utils import check_positive_definite, check_symmetric

DEV = "cpu"  # the port's entry points default to the card
BTOL = 1e-10
PTOL = 1e-12


def _spd(n=120, cond=1e4, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, np.log10(cond), n)
    return (Q * lam) @ Q.T, lam


def both(a):
    return (MatrixOperator(a, symmetric=True, device=DEV),
            jops.linop_from_ndarray(jnp.asarray(a), symmetric=True))


def test_lanczos_bounds_poisson_match_jax():
    n = 200
    op = operator_from_coo(*poisson1d_coo(n), symmetric=True, device=DEV)
    lmin, lmax = lanczos_bounds(op, k=30, safety=0.05)
    jl = jops.lanczos_bounds(jax_poisson1d(n, dtype=jnp.float64), k=30,
                             safety=0.05)
    np.testing.assert_allclose([float(lmin), float(lmax)],
                               [float(v) for v in jl], rtol=BTOL)
    lam = 2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    assert lam.max() <= float(lmax) <= lam.max() * 1.2
    assert 0 < float(lmin) <= 20 * lam.min()
    # a two-cluster spectrum is pinned in a couple of steps
    d = np.repeat([1.0, 100.0], 25)
    t, j = both(np.diag(d))
    lo, hi = (float(v) for v in lanczos_bounds(t, k=10, safety=0.05))
    np.testing.assert_allclose(
        [lo, hi], [float(v) for v in jops.lanczos_bounds(j, k=10,
                                                          safety=0.05)],
        rtol=BTOL)
    assert d.min() * 0.9 <= lo <= d.min() <= d.max() <= hi <= d.max() * 1.1


def test_lanczos_products_stay_on_the_device():
    # k products through the operator's rule, the scalars on the device:
    # the bounds come back as 0-d tensors
    t = poisson3d_coo(8)
    A = operator_from_coo(*t, symmetric=True, fmt="cuda-dia", device=DEV)
    calls = []
    mv = A._mv
    A._mv = lambda x: calls.append(1) or mv(x)
    lmin, lmax = lanczos_bounds(A, k=16)
    assert len(calls) == 16
    assert lmin.ndim == lmax.ndim == 0 and 0 < float(lmin) < float(lmax)


def test_lanczos_breakdown_masks_padding():
    # v0 = e0 is an eigenvector: the first step breaks down exactly, and
    # the zero rows must not add a spurious 0 Ritz value
    n = 32
    d = np.full(n, 5.0)
    d[0], d[1] = 3.0, 10.0
    t, j = both(np.diag(d))
    v0 = np.zeros(n)
    v0[0] = 1.0
    lmin, lmax = lanczos_bounds(t, k=8, v0=v0, safety=0.0)
    np.testing.assert_allclose([float(lmin), float(lmax)], [3.0, 3.0],
                               rtol=1e-12)
    jl = jops.lanczos_bounds(j, k=8, v0=jnp.asarray(v0), safety=0.0)
    np.testing.assert_allclose([float(lmin), float(lmax)],
                               [float(v) for v in jl], rtol=BTOL)


def test_chebyshev_operator_is_spd_polynomial():
    a, lam = _spd(n=60, cond=100.0, seed=1)
    t, j = both(a)
    M = ChebyshevOperator(t, lam.min(), lam.max(), degree=6)
    jM = jops.ChebyshevOperator(j, lam.min(), lam.max(), degree=6)
    assert M.symmetric and M.shape == (60, 60)
    assert check_symmetric(M) and check_positive_definite(M)
    eye = torch.eye(60, dtype=torch.float64)
    dense = (M * eye).numpy()
    jdense = np.asarray(jM * jnp.eye(60, dtype=jnp.float64))
    np.testing.assert_allclose(dense, jdense, rtol=0,
                               atol=PTOL * np.abs(jdense).max())
    np.testing.assert_allclose(dense, dense.T, atol=1e-10)
    # p(A) A clusters at 1 within the Chebyshev radius
    kappa = lam.max() / lam.min()
    rho = (np.sqrt(kappa) - 1) / (np.sqrt(kappa) + 1)
    radius = 2 * rho ** 6 / (1 + rho ** 12)
    assert np.all(np.abs(np.linalg.eigvalsh(dense @ a) - 1)
                  <= radius * 1.05)


def test_degree_one_and_validation():
    a, lam = _spd(n=20, cond=10.0, seed=2)
    t, _ = both(a)
    M = ChebyshevOperator(t, lam.min(), lam.max(), degree=1)
    x = torch.arange(20.0, dtype=torch.float64)
    theta = (lam.min() + lam.max()) / 2
    np.testing.assert_allclose((M * x).numpy(), x.numpy() / theta,
                               rtol=1e-12)
    with pytest.raises(ValueError):
        ChebyshevOperator(t, 1.0, 2.0, degree=0)
    with pytest.raises(ValueError):
        ChebyshevOperator(MatrixOperator(np.triu(a), device=DEV), 1.0, 2.0)


def test_indefinite_interval_raises():
    a, _ = _spd(n=30, cond=10.0, seed=7)
    ind, _ = both(a - 5.0 * np.eye(30))
    with pytest.raises(ValueError, match="not positive"):
        chebyshev_preconditioner(ind, k_lanczos=20)
    spd_op, _ = both(a)
    with pytest.raises(ValueError, match="not positive"):
        chebyshev_preconditioner(spd_op, bounds=(2.0, 1.0))
    with pytest.raises(ValueError, match="not positive"):
        chebyshev_preconditioner(spd_op, bounds=(torch.tensor(-1.0), 2.0))


def test_cg_iteration_count_drops_as_in_jax():
    a, lam = _spd(n=150, cond=1e4, seed=3)
    t, j = both(a)
    b = a @ np.ones(150)
    plain = cg(t, torch.from_numpy(b), rtol=1e-8)
    M = chebyshev_preconditioner(t, degree=8, k_lanczos=20)
    jM = jops.chebyshev_preconditioner(j, degree=8, k_lanczos=20)
    np.testing.assert_allclose([M.lmin, M.lmax],
                               [float(jM._params[1]), float(jM._params[2])],
                               rtol=BTOL)
    pre = cg(t, torch.from_numpy(b), M=M, rtol=1e-8)
    jpre = jax_cg(j, jnp.asarray(b), M=jM, rtol=1e-8)
    assert bool(pre.converged)
    assert int(pre.n_iter) == int(jpre.n_iter)
    assert int(pre.n_iter) * 3 <= int(plain.n_iter)
    np.testing.assert_allclose(pre.x.numpy(), np.asarray(jpre.x), rtol=1e-8)
    np.testing.assert_allclose(pre.x.numpy(), np.ones(150), rtol=1e-4,
                               atol=1e-6)


def test_minres_and_batched_cg_with_chebyshev():
    a, lam = _spd(n=100, cond=1e3, seed=4)
    t, j = both(a)
    M = chebyshev_preconditioner(t, bounds=(lam.min(), lam.max()), degree=6)
    jM = jops.chebyshev_preconditioner(j, bounds=(lam.min(), lam.max()),
                                       degree=6)
    b = a @ np.ones(100)
    res = minres(t, torch.from_numpy(b), M=M, rtol=1e-10, etol=0.0)
    jres = jax_minres(j, jnp.asarray(b), M=jM, rtol=1e-10, etol=0.0)
    assert bool(res.converged)
    assert int(res.n_iter) == int(jres.n_iter)
    np.testing.assert_allclose(res.x.numpy(), np.ones(100), rtol=1e-5,
                               atol=1e-7)
    rng = np.random.default_rng(5)
    Z = rng.standard_normal((100, 3))
    B = a @ Z
    rb = cg_batched(t, torch.from_numpy(B), M=M, rtol=1e-8)
    jrb = jax_cg_batched(j, jnp.asarray(B), M=jM, rtol=1e-8)
    assert bool(rb.converged.all())
    assert rb.info["n_iter_columns"].tolist() == \
        np.asarray(jrb.info["n_iter_columns"]).tolist()
    np.testing.assert_allclose(rb.x.numpy(), Z, rtol=1e-4, atol=1e-5)
    # the block rule agrees with the columns
    X = torch.from_numpy(rng.standard_normal((100, 2)))
    cols = torch.stack([M * X[:, 0], M * X[:, 1]], 1)
    np.testing.assert_allclose((M * X).numpy(), cols.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_block_rule_runs_through_the_spmm():
    # on a block the recurrence rides A's native block rule: degree - 1
    # block products an application, no per-column products
    t = poisson3d_coo(8)
    A = operator_from_coo(*t, symmetric=True, fmt="cuda-dia", device=DEV)
    M = chebyshev_preconditioner(A, degree=8, k_lanczos=16)
    calls = {"mv": 0, "mm": 0}
    mv, mm = A._mv, A._mm

    def count(key, fn):
        def f(x):
            calls[key] += 1
            return fn(x)
        return f

    A._mv, A._mm = count("mv", mv), count("mm", mm)
    X = torch.from_numpy(np.random.default_rng(6).standard_normal((512, 4)))
    Y = M * X
    assert calls == {"mv": 0, "mm": 7}
    y0 = M * X[:, 0]
    assert calls == {"mv": 7, "mm": 7}
    np.testing.assert_allclose(Y[:, 0].numpy(), y0.numpy(), rtol=1e-12)


def test_preconditioner_protocol_solve_alias():
    a, lam = _spd(n=30, cond=10.0, seed=6)
    t, _ = both(a)
    M = ChebyshevOperator(t, lam.min(), lam.max(), degree=4)
    x = torch.arange(30.0, dtype=torch.float64)
    assert torch.equal(M.solve(x), M * x)
