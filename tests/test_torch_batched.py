"""The port's block-batched CG and ``solve(A, B)`` against the JAX package.

The same f64 inputs, made with NumPy from a seed, go through
``pykrylov_tpu.solvers.cg_batched`` and the port's ``cg_batched`` (and
``solve``).  Each column of a batched solve follows the single-RHS CG
recurrence up to the reduction order of the dots, which differs between
the two packages and between a batched and a single solve, so:

  * ``istop`` and ``converged`` must agree exactly;
  * per-column iteration counts agree within 10% (``ITER_RTOL``), the
    bound the JAX ``cg_batched`` itself meets against its own single
    ``cg`` in ``tests/test_batched.py::test_preconditioned_columns_match``
    (the tighter +-3 of ``test_columns_match_single_cg`` fails on the JAX
    side);
  * ``x`` agrees within ``X_RTOL`` relative (max norm), a few thousand
    ulps of f64 drift over a few hundred iterations at cond 1e3.

The sparse slice runs the port's operators on the CPU, where the DIA and
BELL wrappers take their kernels' plain versions, against the JAX
package's Pallas operators in interpret mode.  The block routes of
``solve(A, B)`` (``method=``'s twin, ``bicgstab_batched`` on a square
unsymmetric operator, ``lsqr_batched`` on a rectangular one, through the
RCM permuted space too) are held against the JAX package's ``solve`` at
the tolerances of ``tests/test_torch_batched_nonsym.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu import solve as jax_solve
from pykrylov_tpu.gallery import poisson3d_coo
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu.solvers import cg_batched as jax_cg_batched
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.kernels import pallas_dia_operator

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.ops.base import ShapeError
from pykrylov_tpu_torch.solvers import (ISTOP_MSG, cg, cg_batched,
                                        solve_columns)
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo

from test_torch_batched_nonsym import match_jax, unsym
from test_torch_lls import rect

DEV = "cpu"  # the port's entry points default to the card
ITER_RTOL = 0.1
X_RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(n=120, cond=1e3, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, np.log10(cond), n)
    return (Q * lam) @ Q.T


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def columns_match(res, jres, n_iter_rtol=ITER_RTOL, x_rtol=X_RTOL):
    """The port's batched result against the JAX package's, column by
    column, at the module's stated tolerances."""
    np.testing.assert_array_equal(res.istop.numpy(), np.asarray(jres.istop))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    it, jit = (res.info["n_iter_columns"].numpy(),
               np.asarray(jres.info["n_iter_columns"]))
    assert np.all(np.abs(it - jit) <= np.ceil(n_iter_rtol * jit)), (it, jit)
    for j in range(it.shape[0]):
        assert rel(res.x[:, j].numpy(), np.asarray(jres.x)[:, j]) <= x_rtol
    # block iterations = the slowest column's; block products = iterations
    # (plus one for x0)
    assert int(res.n_iter) == int(it.max())


def test_columns_match_jax_and_single_cg():
    # tests/test_batched.py's system: 5 columns, one scaled by 1e3, one
    # with a known solution
    a = spd()
    rng = np.random.default_rng(1)
    B = rng.standard_normal((120, 5))
    B[:, 0] *= 1e3
    B[:, 3] = a @ np.ones(120)
    jres = jax_cg_batched(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                          jnp.asarray(B), rtol=1e-8, store_history=True)
    A = MatrixOperator(a, symmetric=True, device=DEV)
    res = cg_batched(A, torch.from_numpy(B), rtol=1e-8, store_history=True)
    assert res.x.shape == (120, 5) and res.istop.dtype == torch.int32
    columns_match(res, jres)
    assert int(res.n_matvec) == int(res.n_iter)
    for j in range(5):
        single = cg(A, torch.from_numpy(B[:, j]), rtol=1e-8)
        it = int(res.info["n_iter_columns"][j])
        assert abs(it - int(single.n_iter)) <= ITER_RTOL * int(single.n_iter)
        assert rel(res.x[:, j].numpy(), single.x.numpy()) <= X_RTOL
        assert (float(res.resid_norm[j])
                <= max(1e-8, 1e-8 * float(res.resid_norm0[j])) * (1 + 1e-12))
    assert rel(res.x[:, 3].numpy(), np.ones(120)) <= 1e-5
    # the history holds each column's norms up to its own stop, NaN after
    h = res.resid_history.numpy()
    assert h.shape == (2 * 120 + 1, 5)     # maxiter defaults to 2n
    for j in range(5):
        it = int(res.info["n_iter_columns"][j])
        assert np.all(np.isfinite(h[:it + 1, j]))
        assert np.all(np.isnan(h[it + 1:, j]))
        assert h[it, j] == float(res.resid_norm[j])
    assert not bool(res.info["active_at_exit"].any())


def test_jacobi_preconditioned_columns_match_jax():
    a = spd(n=80, cond=1e5, seed=3)
    d = 1.0 / np.diag(a)
    B = np.random.default_rng(4).standard_normal((80, 3))
    jres = jax_cg_batched(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                          jnp.asarray(B), M=JDiagonalOperator(jnp.asarray(d)),
                          rtol=1e-8, maxiter=2000)
    res = cg_batched(MatrixOperator(a, symmetric=True, device=DEV),
                     torch.from_numpy(B), M=DiagonalOperator(d, device=DEV),
                     rtol=1e-8, maxiter=2000)
    assert bool(res.converged.all())
    # at cond 1e5, x is pinned by the stopping rule to O(kappa * rtol)
    # only: compare both with the oracle (as tests/test_batched.py does)
    columns_match(res, jres, x_rtol=float("inf"))
    for j in range(3):
        x_ref = np.linalg.solve(a, B[:, j])
        err = np.linalg.norm(res.x[:, j].numpy() - x_ref)
        assert err < 5e-3 * np.linalg.norm(x_ref)


def test_indefinite_columns_flag_curvature_like_jax():
    d = np.array([2.0, -1.0, 3.0, 4.0, 0.5])
    B = np.stack([np.ones(5), np.r_[1.0, 0.0, 1.0, 1.0, 1.0]], axis=1)
    jres = jax_cg_batched(JDiagonalOperator(jnp.asarray(d)), jnp.asarray(B),
                          check_curvature=True)
    res = cg_batched(DiagonalOperator(d, device=DEV), torch.from_numpy(B),
                     check_curvature=True)
    np.testing.assert_array_equal(res.istop.numpy(), np.asarray(jres.istop))
    np.testing.assert_array_equal(res.info["definite"].numpy(),
                                  np.asarray(jres.info["definite"]))
    np.testing.assert_array_equal(res.info["n_iter_columns"].numpy(),
                                  np.asarray(jres.info["n_iter_columns"]))
    assert res.istop.tolist() == [2, 0]
    assert res.info["definite"].tolist() == [False, True]
    assert ISTOP_MSG[2].startswith("operator appears indefinite")


def test_zero_column_takes_no_iteration():
    a = spd(n=60, seed=5)
    B = np.random.default_rng(6).standard_normal((60, 3))
    B[:, 1] = 0.0
    jres = jax_cg_batched(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                          jnp.asarray(B), rtol=1e-10)
    res = cg_batched(MatrixOperator(a, symmetric=True, device=DEV),
                     torch.from_numpy(B), rtol=1e-10)
    columns_match(res, jres)
    assert int(res.info["n_iter_columns"][1]) == 0
    assert not res.x[:, 1].any()
    assert bool(res.converged[1]) and int(res.istop[1]) == 0


def test_x0_costs_one_block_product_and_matches_jax():
    a = spd(n=90, seed=7)
    rng = np.random.default_rng(8)
    B, X0 = rng.standard_normal((90, 4)), rng.standard_normal((90, 4))
    jres = jax_cg_batched(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                          jnp.asarray(B), x0=jnp.asarray(X0), rtol=1e-9)
    res = cg_batched(MatrixOperator(a, symmetric=True, device=DEV),
                     torch.from_numpy(B), x0=torch.from_numpy(X0), rtol=1e-9)
    columns_match(res, jres)
    assert int(res.n_matvec) == int(res.n_iter) + 1
    assert int(jres.n_matvec) == int(jres.n_iter) + 1
    # the starting guess equal to the solution stops at once
    xs = np.linalg.solve(a, B)
    hit = cg_batched(MatrixOperator(a, symmetric=True, device=DEV),
                     torch.from_numpy(B), x0=xs, rtol=1e-6)
    assert int(hit.n_iter) == 0 and bool(hit.converged.all())


def test_maxiter_cap_reports_istop_1_and_active_columns():
    a = spd(n=100, cond=1e4, seed=9)
    B = np.random.default_rng(10).standard_normal((100, 2))
    jres = jax_cg_batched(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                          jnp.asarray(B), rtol=1e-12, maxiter=7)
    res = cg_batched(MatrixOperator(a, symmetric=True, device=DEV),
                     torch.from_numpy(B), rtol=1e-12, maxiter=7)
    columns_match(res, jres)
    assert res.istop.tolist() == [1, 1] and int(res.n_iter) == 7
    assert bool(res.info["active_at_exit"].all())


def test_shapes():
    A = MatrixOperator(spd(n=10, seed=1), symmetric=True, device=DEV)
    b = torch.ones(10, dtype=torch.float64)
    one = cg_batched(A, b)          # a 1-D rhs is one column
    assert one.x.shape == (10, 1)
    assert cg_batched(A, b, x0=torch.zeros(10, dtype=torch.float64)
                      ).x.shape == (10, 1)
    with pytest.raises(ShapeError):
        cg_batched(A, torch.ones(11, 2, dtype=torch.float64))
    with pytest.raises(ShapeError):
        cg_batched(MatrixOperator(np.ones((10, 12)), device=DEV),
                   torch.ones(12, 2, dtype=torch.float64))
    with pytest.raises(ShapeError, match="x0"):
        cg_batched(A, torch.ones(10, 2, dtype=torch.float64),
                   x0=torch.zeros(2, 10, dtype=torch.float64))
    # replace_every (item 15) is ported: the verified twin against the JAX
    # package's on the same block
    opts = dict(replace_every=50, rtol=1e-12, atol=0.0, maxiter=100)
    ver = cg_batched(A, torch.ones(10, 2, dtype=torch.float64), **opts)
    jver = jax_cg_batched(linop_from_ndarray(jnp.asarray(spd(n=10, seed=1)),
                                             symmetric=True),
                          jnp.ones((10, 2)), **opts)
    assert set(ver.info) == set(jver.info) and "x_lo" in ver.info
    assert ver.istop.tolist() == np.asarray(jver.istop).tolist() == [0, 0]
    assert rel(ver.x.numpy(), jver.x) <= X_RTOL
    two = cg_batched(A, torch.ones(10, 2, dtype=torch.float64))
    assert repr(two).startswith("SolveResult(converged=[True, True], "
                                "istop=[0, 0], n_iter=")
    cols = solve_columns(cg, A, torch.ones(10, 3, dtype=torch.float64))
    assert len(cols) == 3 and all(bool(r.converged) for r in cols)
    with pytest.raises(ValueError, match="solve_columns"):
        solve_columns(cg, A, b)


# --------------------------------------------------------------------------
# solve(A, B): the slice as a whole
# --------------------------------------------------------------------------

def test_solve_block_on_poisson_through_the_dia_block_rule():
    # the port: operator_from_coo(fmt="cuda-dia") on the CPU, whose block
    # product is the SpMM kernel's plain version; JAX: cg_batched over the
    # Pallas DIA operator in interpret mode (padded rows stay zero)
    vals, rows, cols, shape = poisson3d_coo(8)          # 512 rows
    n = shape[0]
    B = np.random.default_rng(11).standard_normal((n, 4))
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          fmt="cuda-dia", device=DEV)
    assert A.fmt == "cuda-dia" and A._mm is not None
    before = K.DIA_MM_LAUNCHES
    res = pt.solve(A, torch.from_numpy(B), rtol=1e-8)
    assert K.DIA_MM_LAUNCHES == before     # plain version on the CPU
    jdia = JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape))
    jop = pallas_dia_operator(jdia, symmetric=True, interpret=True)
    Bp = np.zeros((jop.shape[0], 4))
    Bp[:n] = B
    jres = jax_cg_batched(jop, jnp.asarray(Bp), rtol=1e-8)
    columns_match(res, dataclasses.replace(jres, x=jres.x[:n]))
    assert bool(res.converged.all())
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    r = B - a @ res.x.numpy()
    assert (np.linalg.norm(r, axis=0)
            <= 1e-7 * np.linalg.norm(B, axis=0)).all()


def _sparse_spd(n=700, seed=12):
    """A sparse SPD matrix with banded and scattered entries: random
    symmetric off-diagonals, diagonally dominant."""
    rng = np.random.default_rng(seed)
    nnz = 6 * n
    r = rng.integers(0, n, nnz)
    c = np.where(rng.random(nnz) < 0.8,
                 np.clip(r + rng.integers(-40, 41, nnz), 0, n - 1),
                 rng.integers(0, n, nnz))
    v = rng.standard_normal(nnz)
    a = np.zeros((n, n))
    np.add.at(a, (r, c), v)
    a = a + a.T
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    rr, cc = np.nonzero(a)
    return a, (a[rr, cc], rr, cc, (n, n))


@pytest.mark.parametrize("fmt", ["bell", "bell-rcm"])
def test_solve_block_through_bell_matches_jax(fmt):
    a, t = _sparse_spd()
    n = t[3][0]
    B = np.random.default_rng(13).standard_normal((n, 4))
    X0 = 0.1 * np.random.default_rng(14).standard_normal((n, 4))
    A = operator_from_coo(*t, symmetric=True, fmt=fmt, device=DEV)
    assert A.fmt == "bell" and A._mm is not None
    assert (A.solve_permutation is not None) == (fmt == "bell-rcm")
    res = pt.solve(A, torch.from_numpy(B), x0=torch.from_numpy(X0),
                   rtol=1e-10)
    jop = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                           symmetric=True, interpret=True,
                           reorder=(fmt == "bell-rcm"))
    # the JAX front door: its block branch (cg_batched), in the permuted
    # space for the RCM operator, as the port's
    jres = jax_solve(jop, jnp.asarray(B), x0=jnp.asarray(X0), rtol=1e-10)
    columns_match(res, jres)
    assert int(res.n_matvec) == int(res.n_iter) + 1
    assert rel(res.x.numpy(), np.linalg.solve(a, B)) <= 1e-8


def _route_case(case):
    """(port operator, JAX operator, block, method, the port's batched twin
    that the JAX package's solve(A, B) picks) for a block route."""
    rng = np.random.default_rng(40)
    if case in ("lsqr", "rectangular"):
        a = rect(90, 40, seed=41)
        B = np.stack([a @ np.ones(40), rng.standard_normal(90)], axis=1)
        sym, twin = False, PS.lsqr_batched
    elif case == "minres":
        a = spd(n=60, cond=1e2, seed=42)
        B = rng.standard_normal((60, 3))
        sym, twin = True, PS.minres_batched
    else:
        a = unsym(n=60, seed=43)
        B = rng.standard_normal((60, 3))
        sym, twin = False, PS.bicgstab_batched
    method = None if case in ("unsymmetric", "rectangular") else case
    return (MatrixOperator(a, symmetric=sym, device=DEV),
            linop_from_ndarray(jnp.asarray(a), symmetric=sym), B, method,
            twin)


@pytest.mark.parametrize("case", ["minres", "bicgstab", "lsqr",
                                  "cg_pipelined", "unsymmetric",
                                  "rectangular", "verified"])
def test_unported_block_branches_name_their_item(case):
    # the block branches that ROADMAP item 14 ported route as the JAX
    # package's solve(A, B) does: method= to its batched twin, a square
    # unsymmetric operator to bicgstab_batched, a rectangular one to
    # lsqr_batched, each result the JAX package's at the tolerances of
    # tests/test_torch_batched_nonsym.py; the verified block path of a
    # symmetric operator (item 15) goes to ff cg_batched (replace_every 50,
    # the curvature check on); method="cg_pipelined" (item 16) to
    # cg_pipelined_batched
    spd3 = MatrixOperator(torch.eye(3, dtype=torch.float64) * 2,
                          symmetric=True, device=DEV)
    B3 = torch.ones(3, 2, dtype=torch.float64)
    if case == "cg_pipelined":
        a = spd(n=60, cond=10.0, seed=44)
        B = np.random.default_rng(44).standard_normal((60, 3))
        A = MatrixOperator(a, symmetric=True, device=DEV)
        res = pt.solve(A, torch.from_numpy(B), method=case, rtol=1e-8)
        jres = jax_solve(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                         jnp.asarray(B), method=case, rtol=1e-8)
        assert torch.equal(res.x, PS.cg_pipelined_batched(
            A, torch.from_numpy(B), rtol=1e-8).x)
        assert set(res.info) == set(jres.info)
        assert res.istop.tolist() == np.asarray(jres.istop).tolist()
        assert res.info["n_iter_columns"].tolist() == \
            np.asarray(jres.info["n_iter_columns"]).tolist()
        assert int(res.n_matvec) == int(jres.n_matvec)
        assert rel(res.x.numpy(), jres.x) <= X_RTOL
        assert bool(res.converged.all())
    elif case == "verified":
        a = spd(n=60, cond=1e2, seed=43)
        B = np.random.default_rng(43).standard_normal((60, 3))
        A = MatrixOperator(a, symmetric=True, device=DEV)
        res = pt.solve(A, torch.from_numpy(B), verified=True, rtol=1e-10)
        jres = jax_solve(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                         jnp.asarray(B), verified=True, rtol=1e-10)
        assert set(res.info) == set(jres.info)
        assert res.istop.tolist() == np.asarray(jres.istop).tolist()
        np.testing.assert_array_equal(
            res.info["n_replacements"].numpy(),
            np.asarray(jres.info["n_replacements"]))
        assert int(res.n_matvec) == int(jres.n_matvec)
        assert rel(res.x.numpy(), jres.x) <= X_RTOL
        assert torch.equal(res.x, cg_batched(
            A, torch.from_numpy(B), rtol=1e-10, replace_every=50,
            check_curvature=True).x)
    else:
        A, jA, B, method, twin = _route_case(case)
        opts = dict(atol=1e-10, btol=1e-10, etol=0.0) if twin is \
            PS.lsqr_batched else dict(rtol=1e-10)
        if twin is PS.minres_batched:
            opts["etol"] = 0.0
        res = pt.solve(A, torch.from_numpy(B), method=method, **opts)
        jres = jax_solve(jA, jnp.asarray(B), method=method, **opts)
        match_jax(res, jres)
        assert bool(res.converged.all())
        # the route is the twin's: the same call gives the same bits
        assert torch.equal(res.x, twin(A, torch.from_numpy(B), **opts).x)
    with pytest.raises(ValueError, match="unknown method"):
        pt.solve(spd3, B3, method="gmres")


def test_solve_block_through_an_unsymmetric_rcm_bell_operator():
    # solve(A, B) on an RCM-reordered unsymmetric BellOperator: the block
    # goes to bicgstab_batched in the permuted space (A' X' = P B), and X
    # is un-permuted once; x against the JAX package's solve(A, B)
    a, t = _sparse_spd(n=600, seed=44)
    a = a + np.triu(a, 1) * 0.5                         # unsymmetric
    rr, cc = np.nonzero(a)
    t = (a[rr, cc], rr, cc, a.shape)
    A = operator_from_coo(*t, fmt="bell-rcm", device=DEV)
    assert A.solve_permutation is not None and not A.symmetric
    B = np.random.default_rng(45).standard_normal((600, 3))
    X0 = 0.1 * np.random.default_rng(46).standard_normal((600, 3))
    res = pt.solve(A, torch.from_numpy(B), x0=torch.from_numpy(X0),
                   rtol=1e-10)
    jres = jax_solve(linop_from_ndarray(jnp.asarray(a)), jnp.asarray(B),
                     x0=jnp.asarray(X0), rtol=1e-10)
    match_jax(res, jres)
    assert "n_matvec_columns" in res.info        # BiCGSTAB's
    assert rel(res.x.numpy(), np.linalg.solve(a, B)) <= 1e-8
    # the same solve on the unpermuted operator
    plain = pt.solve(operator_from_coo(*t, fmt="bell", device=DEV),
                     torch.from_numpy(B), x0=torch.from_numpy(X0),
                     rtol=1e-10)
    assert rel(res.x.numpy(), plain.x.numpy()) <= 1e-8


def test_solve_block_with_method_cg_and_default_agree():
    a = spd(n=50, seed=15)
    B = torch.from_numpy(np.random.default_rng(16).standard_normal((50, 3)))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    r1 = pt.solve(A, B, rtol=1e-9)
    r2 = pt.solve(A, B, method="cg", rtol=1e-9)
    assert torch.equal(r1.x, r2.x) and bool(r1.converged.all())
    # a NumPy block goes to the operator's device
    r3 = pt.solve(A, B.numpy(), rtol=1e-9)
    assert torch.equal(r3.x, r1.x)
