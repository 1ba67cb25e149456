"""The port's SYMMLQ against the JAX package's, on the same inputs.

Both run in float64 on the CPU, on the systems of
``tests/test_torch_minres.py`` (``tests/test_solve_frontdoor.py:17``'s
construction with a spectrum that converges before the Krylov space is
exhausted).  The port carries the plane rotation, the norm estimates and
the stop tests on host floats, the JAX package's float64 device scalars:
equal ``istop``, ``n_iter`` and ``n_matvec`` (the extra counted matvec for
the true final residual included), x within 1e-10 relative and the
CG-point residual histories within 1e-8 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.solvers import symmlq as jax_symmlq
from pykrylov_tpu.solvers.symmlq import ISTOP_MSG as JAX_ISTOP_MSG

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.solvers import symmlq
from pykrylov_tpu_torch.solvers.symmlq import ISTOP_MSG

from test_torch_minres import SYSTEMS, rel

DEV = "cpu"  # the port's entry points default to the card


def both(A, b, M=None, sym=True, **opts):
    """(port result, JAX result) of SYMMLQ on dense A and b (f64)."""
    t = symmlq(MatrixOperator(torch.from_numpy(A), symmetric=sym,
                              device=DEV), torch.from_numpy(b),
               M=None if M is None else MatrixOperator(
                   torch.from_numpy(M), symmetric=True, device=DEV),
               **opts)
    j = jax_symmlq(JMatrix(jnp.asarray(A), symmetric=sym), jnp.asarray(b),
                   M=None if M is None else JMatrix(jnp.asarray(M),
                                                    symmetric=True),
                   **opts)
    return t, j


def assert_same(t, j, x_rtol=1e-10):
    assert int(t.istop) == int(j.istop)
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    assert bool(t.converged) == bool(j.converged)
    if np.linalg.norm(np.asarray(j.x)):
        assert rel(t.x.numpy(), j.x) <= x_rtol
    else:
        assert not t.x.any()
    assert float(t.resid_norm) == pytest.approx(
        float(j.resid_norm), rel=1e-6, abs=1e-12 * float(j.resid_norm0))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("rtol", [1e-6, 1e-9])
def test_symmlq_matches_jax(name, rtol):
    A, x_true, b = SYSTEMS[name]()
    t, j = both(A, b, rtol=rtol, store_history=True)
    assert int(t.istop) == 1
    assert int(t.n_iter) < 0.75 * A.shape[0]   # not an exhausted space
    assert_same(t, j)
    k = int(t.n_iter) + 1
    jh = np.asarray(j.resid_history)
    np.testing.assert_allclose(t.resid_history[:k].numpy(), jh[:k],
                               rtol=1e-8, atol=1e-12 * jh[0])
    assert np.isnan(t.resid_history[k:].numpy()).all()
    for key in ("Anorm", "Acond", "xnorm", "cgnorm", "lqnorm"):
        assert float(t.info[key]) == pytest.approx(float(j.info[key]),
                                                   rel=1e-8)
    # resid_norm is the true final residual, one counted matvec
    assert int(t.n_matvec) == int(t.n_iter) + 1
    assert float(t.resid_norm) == pytest.approx(
        np.linalg.norm(b - A @ t.x.numpy()), rel=1e-6)
    assert rel(t.x.numpy(), x_true) <= 1e3 * rtol


def test_shift_and_iterates():
    A, _, b = SYSTEMS["indefinite"]()
    t, j = both(A, b, shift=0.3, rtol=1e-9, store_iterates=True,
                verify_final=True)
    assert_same(t, j)
    n = A.shape[0]
    assert np.linalg.norm((A - 0.3 * np.eye(n)) @ t.x.numpy() - b) <= \
        1e-6 * np.linalg.norm(b)
    k = int(t.n_iter) + 1
    it, jit_ = t.info["iterates"].numpy(), np.asarray(j.info["iterates"])
    assert it.shape == jit_.shape == (2 * n + 1, n)
    # the LQ iterates, row by row, within 1e-8 of the solution's scale
    # (the row of the iteration that stops on its tests stays NaN in both)
    np.testing.assert_allclose(it[:k], jit_[:k], rtol=0,
                               atol=1e-8 * np.nanmax(np.abs(jit_[:k])))
    assert np.isnan(it[k - 1]).all()
    assert np.isnan(it[k:]).all()
    assert float(t.info["true_resid_norm"]) == pytest.approx(
        float(j.info["true_resid_norm"]), abs=1e-10 * np.linalg.norm(b))


def _nonsym():
    A = np.diag([2.0, 3.0, 4.0, 5.0])
    A[0, 3] = 1.0
    return A


@pytest.mark.parametrize("code,case", [
    (-1, "eigenvector rhs"), (0, "zero rhs"), (1, "converged"),
    (2, "eps accuracy"), (5, "matvec limit"), (6, "A unsymmetric"),
    (7, "M unsymmetric"), (8, "M indefinite"),
])
def test_every_reachable_code(code, case):
    M = None
    opts = {}
    if case == "eigenvector rhs":
        A, b = np.diag([1.0, 2.0, 3.0, 4.0]), np.array([0.0, 1.0, 0.0, 0.0])
    elif case == "zero rhs":
        A, b = np.diag([1.0, 2.0, 3.0]), np.zeros(3)
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
        A, _, b = SYSTEMS["spd"]()
        opts = {"converged": dict(rtol=1e-8),
                # rtol 0: only the eps test (cgnorm <= Anorm ynorm eps) stops
                "eps accuracy": dict(rtol=0.0),
                "matvec limit": dict(rtol=1e-12, matvec_max=9)}[case]
    t, j = both(A, b, M=M, sym=case != "A unsymmetric", store_history=True,
                **opts)
    assert int(j.istop) == code
    assert_same(t, j)
    assert ISTOP_MSG[code] == JAX_ISTOP_MSG[code]
    assert bool(t.converged) == (code in (0, 1, 2))


def test_default_matvec_cap_and_table():
    A, _, b = SYSTEMS["indefinite"]()
    t, j = both(A, b, rtol=1e-30)
    # matvec_max defaults to 2n + 2 (symmlq.py:87); istop 5 at the cap
    assert int(t.istop) == int(j.istop)
    assert int(t.n_matvec) == int(j.n_matvec) <= 2 * A.shape[0] + 3
    assert ISTOP_MSG == JAX_ISTOP_MSG
    assert pt.ISTOP_MSGS["symmlq"] is ISTOP_MSG
