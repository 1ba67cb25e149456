"""The port's pipelined CG, its block twin and ``solve(method=
"cg_pipelined")`` against the JAX package (the cases of
tests/test_pipelined.py, and the block twin's).

The same f64 inputs go through both packages.  The port's single solver
keeps ``alpha`` and ``beta`` as host floats, the JAX package as f64 device
scalars: the same IEEE operations, so the iteration and matvec counts and
the stop codes must be equal, and x and the residual history agree to
1e-10 relative (``RTOL``; the dots' summation order differs).

The pipelined recurrences amplify rounding: on a dense system with a
condition number of 100 the two packages' residual histories agree to
1e-12 for some 35 iterations and then part chaotically (PERF.md §6), so
the parity systems converge in fewer (condition number 10, rtol at most
1e-8).  On 1138bus with Jacobi (the JAX package's own case, some
900 iterations) the counts are held within 1% and x to the true solution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu
from pykrylov_tpu.ops import DiagonalOperator as JDiag
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu.solvers import cg_pipelined as jax_cg_pipelined
from pykrylov_tpu.solvers import cg_pipelined_batched as jax_batched
from pykrylov_tpu.sparse import jacobi_preconditioner as jax_jacobi
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import (cg_pipelined, cg_pipelined_batched,
                                        ISTOP_MSGS)
from pykrylov_tpu_torch.sparse import jacobi_preconditioner, sparse_operator

DEV = "cpu"  # the port's entry points default to the card
RTOL = 1e-10


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(n=120, cond=10.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.logspace(0, np.log10(cond), n)) @ Q.T


def rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _system(case):
    """(port A, JAX A, port M, JAX M, b, options) of a parity case."""
    if case.startswith("1138bus"):
        A = sparse_operator("1138bus", symmetric=True, device=DEV)
        jA = jax_sparse_operator("1138bus", symmetric=True)
        b = np.array(jA * jnp.ones(1138))
        return (A, jA, jacobi_preconditioner("1138bus", device=DEV),
                jax_jacobi("1138bus"), b,
                dict(rtol=1e-8, maxiter=5000, replace_every=50))
    a = spd(seed=3)
    d = np.exp(np.random.default_rng(5).uniform(-1, 1, 120))
    if case == "M":
        # D^(1/2) A D^(1/2), which M = D^-1 brings back to A's spectrum
        a = np.sqrt(d)[:, None] * a * np.sqrt(d)[None, :]
    b = a @ np.random.default_rng(4).standard_normal(a.shape[0])
    A = MatrixOperator(a, symmetric=True, device=DEV)
    jA = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    d = 1.0 / d
    opts = dict(rtol=1e-8)
    if case == "x0":
        opts["x0"] = 0.1 * np.random.default_rng(5).standard_normal(120)
    if case == "replace_every":
        opts["replace_every"] = 7
    if case == "history":
        opts["store_history"] = True
    if case == "maxiter":
        opts.update(maxiter=9, store_history=True)
    if case == "M":
        return (A, jA, DiagonalOperator(d, device=DEV),
                JDiag(jnp.asarray(d)), b, opts)
    return A, jA, None, None, b, opts


def _same(res, jres):
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    assert int(res.istop) == int(jres.istop)
    assert bool(res.converged) == bool(jres.converged)
    assert set(res.info) == set(jres.info)
    assert rel(res.x.numpy(), jres.x) <= RTOL
    _same_norms(res, jres)


def _same_norms(res, jres):
    # residual norms to RTOL of the initial one: the recurrences carry
    # rounding at the scale of ||r_0||, whatever the residual has fallen to
    scale = RTOL * float(np.max(np.asarray(jres.resid_norm0)))
    np.testing.assert_allclose(res.resid_norm.numpy(),
                               np.asarray(jres.resid_norm), rtol=0,
                               atol=scale)
    if jres.resid_history is not None:
        h, jh = res.resid_history.numpy(), np.asarray(jres.resid_history)
        np.testing.assert_array_equal(np.isnan(h), np.isnan(jh))
        np.testing.assert_allclose(h[~np.isnan(h)], jh[~np.isnan(jh)],
                                   rtol=0, atol=scale)


@pytest.mark.parametrize("case", ["plain", "M", "x0", "replace_every",
                                  "history", "maxiter", "1138bus_jacobi"])
def test_matches_jax(case):
    A, jA, M, jM, b, opts = _system(case)
    jopts = {k: (jnp.asarray(v) if k == "x0" else v)
             for k, v in opts.items()}
    res = cg_pipelined(A, torch.from_numpy(b), M=M, **opts)
    jres = jax_cg_pipelined(jA, jnp.asarray(b), M=jM, **jopts)
    if case == "1138bus_jacobi":
        assert abs(int(res.n_iter) - int(jres.n_iter)) <= \
            0.01 * int(jres.n_iter)
        for x in (res.x.numpy(), np.asarray(jres.x)):
            assert np.linalg.norm(x - 1.0) <= 1e-4 * np.sqrt(1138)
    else:
        _same(res, jres)
    if case == "maxiter":
        assert int(res.istop) == 1 and int(res.n_iter) == 9
    else:
        assert int(res.istop) == 0
    if case in ("replace_every", "1138bus_jacobi"):
        # every replacement restores four recurrences: 4 matvecs each
        k, every = int(res.n_iter), opts["replace_every"]
        assert int(res.n_matvec) == k + 1 + 4 * (k // every)


def test_counts_and_iterations_against_classic_cg():
    # the recurrences are classic CG's in exact arithmetic: the same
    # iteration count on a well-conditioned system, one matvec more (the
    # initial w = A u), and the solution
    a = spd(seed=6)
    b = torch.from_numpy(a @ np.ones(120))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    res = cg_pipelined(A, b, rtol=1e-8)
    ref = pt.cg(A, b, rtol=1e-8)
    assert abs(int(res.n_iter) - int(ref.n_iter)) <= 1
    assert int(res.n_matvec) == int(res.n_iter) + 1
    np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-8)
    assert ISTOP_MSGS["cg_pipelined"][0].startswith("residual small")


def test_stopping_iteration_drops_its_product():
    # the loop enqueues M w and A m before it reads the dots: a solve that
    # stops on its test applies A and M once more than n_matvec counts
    a = spd(seed=7)
    b = torch.from_numpy(a @ np.ones(120))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    M = DiagonalOperator(1.0 / np.diag(a), device=DEV)
    res = cg_pipelined(A, b, M=M, rtol=1e-8)
    assert int(res.istop) == 0
    assert A.nMatvec == 0          # the solver applies A uncounted
    calls = {"A": 0, "M": 0}

    def counted(op, key):
        def mv(x):
            calls[key] += 1
            return op._mv(x)
        return pt.LinearOperator(120, 120, matvec=mv, symmetric=True,
                                 dtype=op.dtype, device=DEV)

    res2 = cg_pipelined(counted(A, "A"), b, M=counted(M, "M"), rtol=1e-8)
    assert torch.equal(res.x, res2.x)
    assert calls["A"] == int(res.n_matvec) + 1
    assert calls["M"] == int(res.n_iter) + 2
    # a solve that hits its cap drops nothing
    calls.update(A=0, M=0)
    capped = cg_pipelined(counted(A, "A"), b, M=counted(M, "M"), maxiter=5)
    assert int(capped.istop) == 1
    assert calls["A"] == int(capped.n_matvec) == 6


def _block_case(case):
    a = spd(n=100, seed=8)
    rng = np.random.default_rng(9)
    d = np.exp(rng.uniform(-1, 1, 100))
    if case == "M":
        a = np.sqrt(d)[:, None] * a * np.sqrt(d)[None, :]
    B = a @ rng.standard_normal((100, 4))
    B[:, 2] *= 1e-3            # a column that converges at another count
    B[:, 3] = 0.0              # a zero column, inactive from the start
    A = MatrixOperator(a, symmetric=True, device=DEV)
    jA = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    opts = dict(rtol=1e-8, atol=1e-30)
    M = jM = None
    if case == "M":
        M, jM = (DiagonalOperator(1.0 / d, device=DEV),
                 JDiag(jnp.asarray(1.0 / d)))
    if case == "x0":
        opts["x0"] = 0.1 * rng.standard_normal((100, 4))
    if case == "replace_every":
        opts["replace_every"] = 9
    if case == "history":
        opts["store_history"] = True
    if case == "maxiter":
        opts.update(maxiter=12, store_history=True)
    return A, jA, M, jM, B, opts


@pytest.mark.parametrize("case", ["plain", "M", "x0", "replace_every",
                                  "history", "maxiter"])
def test_block_twin_matches_jax(case):
    A, jA, M, jM, B, opts = _block_case(case)
    jopts = {k: (jnp.asarray(v) if k == "x0" else v)
             for k, v in opts.items()}
    res = cg_pipelined_batched(A, torch.from_numpy(B), M=M, **opts)
    jres = jax_batched(jA, jnp.asarray(B), M=jM, **jopts)
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    assert res.istop.tolist() == np.asarray(jres.istop).tolist()
    assert res.converged.tolist() == np.asarray(jres.converged).tolist()
    assert res.info["n_iter_columns"].tolist() == \
        np.asarray(jres.info["n_iter_columns"]).tolist()
    assert set(res.info) == set(jres.info)
    assert rel(res.x.numpy(), jres.x) <= RTOL
    _same_norms(res, jres)


def test_block_columns_against_single_solves():
    # each column runs the single-rhs recurrence: its solution is the
    # single solve's, and its count one more (a column counts the
    # iteration whose test stops it, as in the JAX package)
    A, _, M, _, B, opts = _block_case("M")
    res = cg_pipelined_batched(A, torch.from_numpy(B), M=M, **opts)
    for j in range(3):
        one = cg_pipelined(A, torch.from_numpy(B[:, j]), M=M, **opts)
        assert int(res.info["n_iter_columns"][j]) == int(one.n_iter) + 1
        assert rel(res.x[:, j].numpy(), one.x.numpy()) <= RTOL


@pytest.mark.parametrize("shape", ["vector", "block"])
def test_solve_routes_cg_pipelined(shape):
    # solve(method="cg_pipelined") goes to cg_pipelined for a 1-D b and to
    # cg_pipelined_batched for a block, in both packages
    a = spd(n=80, seed=10)
    rng = np.random.default_rng(11)
    b = a @ (rng.standard_normal(80) if shape == "vector"
             else rng.standard_normal((80, 3)))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    jA = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    res = pt.solve(A, torch.from_numpy(b), method="cg_pipelined",
                   rtol=1e-8)
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b), method="cg_pipelined",
                              rtol=1e-8)
    twin = cg_pipelined if shape == "vector" else cg_pipelined_batched
    assert torch.equal(res.x, twin(A, torch.from_numpy(b), rtol=1e-8).x)
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    assert rel(res.x.numpy(), jres.x) <= RTOL
    assert bool(np.all(np.asarray(res.converged)))


# -- float32 on 3-D Poisson: the unstabilised recurrences stall in both ----
# packages (a property of the JAX package's algorithm, not of the port)

def _poisson_f32(n):
    """Both packages' (A, M) of the dense f32 3-D Poisson matrix at grid
    ``n`` with Jacobi M = I/6, the f32 ``b = A 1`` and the f64 matrix."""
    from pykrylov_tpu.gallery import poisson3d_coo
    vals, rows, cols, shape = poisson3d_coo(n)
    a = np.zeros(shape, np.float32)
    np.add.at(a, (rows, cols), vals.astype(np.float32))
    b = a @ np.ones(shape[0], np.float32)
    d = np.full(shape[0], 1 / 6, np.float32)
    port = (MatrixOperator(torch.from_numpy(a), symmetric=True, device=DEV),
            DiagonalOperator(torch.from_numpy(d), device=DEV))
    jax_ = (linop_from_ndarray(jnp.asarray(a), symmetric=True),
            JDiag(jnp.asarray(d)))
    return port, jax_, b, a.astype(np.float64)


def _f32_solves(n, **opts):
    (A, M), (jA, jM), b, a64 = _poisson_f32(n)
    opts = dict(rtol=1e-6, **opts)
    res = cg_pipelined(A, torch.from_numpy(b), M=M, **opts)
    jres = jax_cg_pipelined(jA, jnp.asarray(b), M=jM, **opts)
    classic = pt.cg(A, torch.from_numpy(b), M=M, rtol=1e-6)

    def true_rel(x):
        x = np.asarray(x, np.float64)
        return np.linalg.norm(b - a64 @ x) / np.linalg.norm(b)
    return res, jres, classic, true_rel


@pytest.mark.parametrize("n,count", [(8, 17), (12, 26)])
def test_f32_poisson_small_grids_match_jax(n, count):
    res, jres, classic, true_rel = _f32_solves(n)
    assert int(res.n_iter) == int(jres.n_iter) == int(classic.n_iter) \
        == count
    assert bool(res.converged) and bool(jres.converged)
    assert true_rel(res.x) <= 1e-4 and true_rel(jres.x) <= 1e-4


def test_f32_poisson_n16_stalls_in_both_packages():
    # classic CG converges in 35; neither pipelined recurrence does within
    # 10% more (both run on to thousands of iterations from here)
    res, jres, classic, _ = _f32_solves(16, maxiter=39)
    assert int(classic.n_iter) == 35 and bool(classic.converged)
    assert not bool(res.converged) and not bool(jres.converged)
    assert int(res.n_iter) == int(jres.n_iter) == 39


def test_f32_poisson_n16_replacement_converges_in_both_packages():
    res, jres, classic, true_rel = _f32_solves(16, replace_every=10)
    assert bool(res.converged) and bool(jres.converged)
    assert true_rel(res.x) <= 1e-4 and true_rel(jres.x) <= 1e-4
    # within 20% of classic CG's 35 (the port 35, the JAX package 41)
    for r in (res, jres):
        assert int(r.n_iter) <= 1.2 * int(classic.n_iter)
