"""The port's CG against the JAX package's, on the same stored matrices.

On ``poisson3d_coo(12)`` (κ ≈ 60) the port runs through its
``fmt="cuda-dia"`` operator (on CPU tensors: the kernel's plain version)
and the JAX package through its Pallas DIA operator in interpret mode.
Both take the same float64 steps up to summation order, so the iteration
counts must be equal, the solutions agree to 1e-10 relative and the
residual histories to 1e-9 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.gallery import poisson3d_coo
from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.solvers import cg as jax_cg
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.ops import DiagonalOperator
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.solvers.cg import ISTOP_MSG
from pykrylov_tpu_torch.sparse import sparse_operator

from pykrylov_tpu.solvers.cg import ISTOP_MSG as JAX_ISTOP_MSG

DEV = "cpu"  # the port's entry points default to the card


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def poisson():
    """The same stored Poisson matrix in both packages, plus a scaled
    variant ``D A D`` with a random positive diagonal D for Jacobi."""
    vals, rows, cols, shape = poisson3d_coo(12)
    d = 1.0 + np.random.default_rng(3).uniform(0.0, 2.0, shape[0])
    out = {}
    for name, v in (("A", vals), ("DAD", vals * d[rows] * d[cols])):
        jop = jax_operator_from_coo(v, rows, cols, shape, symmetric=True,
                                    fmt="pallas-dia")
        top = convert.operator_from_numpy(jop.container, symmetric=True,
                                          fmt="cuda-dia", device=DEV)
        assert top.fmt == "cuda-dia"
        out[name] = (top, jop, (v, rows, cols, shape))
    return out


def run_both(top, jop, b, **opts):
    jopts = dict(opts)
    for key in ("x0", "M"):
        if key in opts and opts[key] is not None:
            jopts[key] = opts[key][1]
            opts[key] = opts[key][0]
    return (cg(top, torch.from_numpy(b), **opts),
            jax_cg(jop, jnp.asarray(b), **jopts))


def assert_parity(t, j, history=False):
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    assert int(t.istop) == int(j.istop) and bool(t.converged)
    assert bool(t.converged) == bool(j.converged)
    assert rel(t.x.numpy(), j.x) <= 1e-10
    assert float(t.resid_norm0) == pytest.approx(float(j.resid_norm0),
                                                 rel=1e-12)
    if history:
        np.testing.assert_allclose(t.history(), np.asarray(j.history()),
                                   rtol=1e-9)
        k = int(t.n_iter) + 1
        np.testing.assert_allclose(
            t.info["curvatures"][1:k].numpy(),
            np.asarray(j.info["curvatures"])[1:k], rtol=1e-9)


@pytest.mark.parametrize("case", ["plain", "jacobi", "x0", "history"])
def test_cg_matches_jax(case, poisson):
    rng = np.random.default_rng(0)
    name = "DAD" if case == "jacobi" else "A"
    top, jop, (vals, rows, cols, shape) = poisson[name]
    b = rng.standard_normal(shape[0])
    opts = {"rtol": 1e-10}
    if case == "jacobi":
        d = np.zeros(shape[0])
        np.add.at(d, rows[rows == cols], vals[rows == cols])
        opts["M"] = (DiagonalOperator(torch.from_numpy(1.0 / d), device=DEV),
                     JDiagonal(jnp.asarray(1.0 / d)))
    elif case == "x0":
        x0 = rng.standard_normal(shape[0])
        opts["x0"] = (torch.from_numpy(x0), jnp.asarray(x0))
    elif case == "history":
        opts.update(store_history=True, store_iterates=True,
                    store_resids=True)
    t, j = run_both(top, jop, b, **opts)
    assert_parity(t, j, history=(case == "history"))
    if case == "history":
        k = int(t.n_iter) + 1
        for key in ("iterates", "resids"):
            buf = t.info[key].numpy()
            assert buf.shape == np.asarray(j.info[key]).shape
            np.testing.assert_allclose(buf[:k], np.asarray(j.info[key])[:k],
                                       rtol=1e-9, atol=1e-12)
            assert np.isnan(buf[k:]).all()


def test_cg_jacobi_needs_fewer_iterations(poisson):
    top, _, (vals, rows, cols, shape) = poisson["DAD"]
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(shape[0]))
    d = np.zeros(shape[0])
    np.add.at(d, rows[rows == cols], vals[rows == cols])
    plain = cg(top, b, rtol=1e-10)
    pre = cg(top, b, rtol=1e-10,
             M=DiagonalOperator(torch.from_numpy(1 / d), device=DEV))
    assert bool(pre.converged) and int(pre.n_iter) < int(plain.n_iter)


def test_curvature_check_on_indefinite_operator():
    d = np.array([3.0, 1.0, -2.0, 4.0, 0.5, -1.0])
    b = np.ones(6)
    t = cg(DiagonalOperator(torch.from_numpy(d), device=DEV),
           torch.from_numpy(b),
           check_curvature=True, store_history=True)
    j = jax_cg(JDiagonal(jnp.asarray(d)), jnp.asarray(b),
               check_curvature=True, store_history=True)
    assert int(t.istop) == int(j.istop) == 2
    assert int(t.n_iter) == int(j.n_iter)
    assert not bool(t.info["definite"]) and not bool(j.info["definite"])
    np.testing.assert_allclose(t.info["infinite_descent"].numpy(),
                               np.asarray(j.info["infinite_descent"]),
                               rtol=1e-12)
    np.testing.assert_allclose(t.history(), np.asarray(j.history()),
                               rtol=1e-12)
    assert ISTOP_MSG == JAX_ISTOP_MSG


def test_matvec_budget_and_verify_final(poisson):
    top, jop, (_, _, _, shape) = poisson["A"]
    b = np.random.default_rng(2).standard_normal(shape[0])
    t, j = run_both(top, jop, b, rtol=1e-12, matvec_max=10,
                    verify_final=True)
    assert int(t.istop) == int(j.istop) == 1
    assert int(t.n_iter) == int(j.n_iter) == 10
    assert float(t.info["true_resid_norm"]) == pytest.approx(
        float(j.info["true_resid_norm"]), rel=1e-9)


def test_1138bus_matvec_count():
    # f64 CG at rtol 1e-6 on 1138bus (reference: 1759 matvecs,
    # tests/test_golden.py).  Summation order alone moves the count by a
    # few iterations on this ill-conditioned matrix, hence ±10 against the
    # JAX package and the golden test's ±90 against the reference.
    top = sparse_operator("1138bus", symmetric=True, device=DEV)
    jop = jax_sparse_operator("1138bus", symmetric=True)
    e = np.ones(1138)
    b = (top * torch.from_numpy(e)).numpy()
    t = cg(top, torch.from_numpy(b), rtol=1e-6, matvec_max=2 * 1138)
    j = jax_cg(jop, jnp.asarray(b), rtol=1e-6, matvec_max=2 * 1138)
    assert bool(t.converged) and bool(j.converged)
    assert abs(int(t.n_matvec) - int(j.n_matvec)) <= 10
    assert abs(int(t.n_matvec) - 1759) <= 90
    assert float(t.resid_norm0) == pytest.approx(1.46e3, rel=0.01)
    assert float(t.resid_norm) <= 1e-6 * float(t.resid_norm0)
    assert np.linalg.norm(t.x.numpy() - e) / np.sqrt(1138) < 5e-5
