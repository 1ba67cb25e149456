"""The port's reference-style class API and import paths against the JAX
package's.

Each class solves in both packages in float64 on the same inputs; the
attributes the reference sets after ``solve`` (``generic/generic.py:79-87``
and each solver's own) must agree: counts and codes equal, norms within
1e-10 relative (1e-8 for residual histories, and residuals at rounding
level within 1e-10 of the initial one), as the functional solvers do
(``tests/test_torch_lls.py``).  The import paths and names mirror
``tests/test_import_paths.py``; the cases mirror ``tests/test_compat.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.compat as J
from pykrylov_tpu.gallery import poisson1d_operator as jax_poisson1d
from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.ops import MatrixOperator as JMatrix

import pykrylov_tpu_torch as pt
import pykrylov_tpu_torch.compat as C
from pykrylov_tpu_torch.gallery import poisson1d_operator
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator

from test_torch_lls import rect

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COUNTS = ("converged", "istop", "nMatvec", "nIter")


def _same(t, j, floats=()):
    for key in COUNTS:
        assert getattr(t, key) == getattr(j, key), key
    for key in ("residNorm0",) + tuple(floats):
        assert getattr(t, key) == pytest.approx(getattr(j, key), rel=1e-10,
                                                abs=1e-14), key
    # residuals end near rounding level, where the two packages' sums part:
    # they are held to 1e-10 of the initial residual there
    floor = 1e-10 * j.residNorm0
    assert t.residNorm == pytest.approx(j.residNorm, rel=1e-10, abs=floor)
    np.testing.assert_allclose(np.asarray(t.residHistory),
                               np.asarray(j.residHistory), rtol=1e-8,
                               atol=floor)
    xt, xj = t.x.numpy(), np.asarray(j.x)
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    assert t.x is t.bestSolution
    assert t.acronym == j.acronym and t.name == j.name
    assert t.prefix == j.prefix


def test_cg_reference_protocol():
    """The reference's introductory example (doc/source/introduction.rst):
    1-D Poisson n=100, matrix-free, matvec_max=200 → 50 matvecs."""
    n = 100
    op = poisson1d_operator(n, dtype=torch.float64, device=DEV)
    rhs = op * torch.ones(n, dtype=torch.float64)
    cg = C.CG(op, reltol=1.0e-8)
    cg.solve(rhs, matvec_max=200)
    jop = jax_poisson1d(n, dtype=jnp.float64)
    jcg = J.CG(jop, reltol=1.0e-8)
    jcg.solve(jop * jnp.ones(n, dtype=jnp.float64), matvec_max=200)
    _same(cg, jcg)
    assert cg.converged and abs(cg.nMatvec - 50) <= 2
    assert len(cg.residHistory) == cg.nIter + 1
    assert cg.residHistory[0] == pytest.approx(cg.residNorm0)


def test_cg_precon_kwarg():
    n = 80
    d = np.linspace(1.0, 1e4, n)
    b = np.ones(n)
    plain = C.CG(DiagonalOperator(torch.from_numpy(d), device=DEV),
                 reltol=1e-10)
    plain.solve(b)
    pre = C.CG(DiagonalOperator(torch.from_numpy(d), device=DEV),
               precon=DiagonalOperator(torch.from_numpy(1.0 / d),
                                       device=DEV), reltol=1e-10)
    pre.solve(b)
    jpre = J.CG(JDiagonal(jnp.asarray(d)),
                precon=JDiagonal(jnp.asarray(1.0 / d)), reltol=1e-10)
    jpre.solve(jnp.asarray(b))
    _same(pre, jpre)
    assert pre.converged and pre.nMatvec < plain.nMatvec


@pytest.mark.parametrize("cls", ["BiCGSTAB", "CGS", "TFQMR"])
def test_unsymmetric_classes(cls):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((50, 50)) + 50 * np.eye(50)
    b = A @ np.ones(50)
    ks = getattr(C, cls)(MatrixOperator(torch.from_numpy(A), device=DEV),
                         reltol=1e-10)
    ks.solve(b)
    jks = getattr(J, cls)(JMatrix(jnp.asarray(A)), reltol=1e-10)
    jks.solve(jnp.asarray(b))
    _same(ks, jks)
    assert ks.converged
    np.testing.assert_allclose(ks.bestSolution.numpy(), np.ones(50),
                               rtol=1e-6)


def test_minres_class_attributes():
    op = poisson1d_operator(60, dtype=torch.float64, device=DEV)
    K = C.Minres(op)
    K.solve(op * torch.ones(60, dtype=torch.float64), rtol=1e-12)
    jop = jax_poisson1d(60, dtype=jnp.float64)
    JK = J.Minres(jop)
    JK.solve(jop * jnp.ones(60, dtype=jnp.float64), rtol=1e-12)
    _same(K, JK, ("Anorm", "Acond", "Arnorm", "ynorm", "rnorm"))
    assert K.converged and K.istop in (1, 2, 10)
    assert K.rnorm == K.residNorm


def test_symmlq_class_attributes():
    op = poisson1d_operator(60, dtype=torch.float64, device=DEV)
    K = C.Symmlq(op)
    K.solve(op * torch.ones(60, dtype=torch.float64), rtol=1e-10)
    jop = jax_poisson1d(60, dtype=jnp.float64)
    JK = J.Symmlq(jop)
    JK.solve(jop * jnp.ones(60, dtype=jnp.float64), rtol=1e-10)
    _same(K, JK, ("xNorm", "anorm", "acond"))
    assert K.converged
    assert K.xNorm == pytest.approx(float(torch.linalg.norm(K.x)), rel=1e-6)


def test_lsqr_framework():
    rng = np.random.default_rng(1)
    A = rect(160, 60, seed=1)
    b = A @ np.ones(60) + 0.01 * rng.standard_normal(160)
    K = C.LSQRFramework(MatrixOperator(torch.from_numpy(A), device=DEV))
    K.solve(b, atol=1e-12, btol=1e-12, etol=0.0, wantvar=True)
    JK = J.LSQRFramework(JMatrix(jnp.asarray(A)))
    JK.solve(jnp.asarray(b), atol=1e-12, btol=1e-12, etol=0.0, wantvar=True)
    _same(K, JK, ("r1norm", "r2norm", "Anorm", "Acond", "Arnorm", "xnorm"))
    assert K.optimal == JK.optimal and K.istop == 2
    assert K.nMatvec == 2 * K.nIter
    np.testing.assert_allclose(K.var.numpy(), np.asarray(JK.var), rtol=1e-10)
    x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
    np.testing.assert_allclose(K.x.numpy(), x_ls, atol=1e-9)


def test_lsmr_returns_reference_tuple():
    A = rect(80, 30, seed=2)
    b = A @ np.ones(30)
    K = C.LSMRFramework(MatrixOperator(torch.from_numpy(A), device=DEV))
    out = K.solve(b, atol=1e-12, btol=1e-12, etol=0.0)
    JK = J.LSMRFramework(JMatrix(jnp.asarray(A)))
    jout = JK.solve(jnp.asarray(b), atol=1e-12, btol=1e-12, etol=0.0)
    _same(K, JK, ("normr", "normar", "normA", "condA", "normx"))
    x, istop, itn, normr, normar, normA, condA, normx = out
    assert (istop, itn) == tuple(jout[1:3]) and istop == 1
    np.testing.assert_allclose(x.numpy(), np.ones(30), atol=1e-9)
    assert K.normx == normx and K.optimal


def test_craig_frameworks():
    m, n = 30, 70
    A = rect(m, n, seed=3)
    b = A @ np.random.default_rng(3).standard_normal(n)
    K = C.CRAIGFramework(MatrixOperator(torch.from_numpy(A), device=DEV))
    K.solve(b, btol=1e-12, etol=1e-14)
    JK = J.CRAIGFramework(JMatrix(jnp.asarray(A)))
    JK.solve(jnp.asarray(b), btol=1e-12, etol=1e-14)
    _same(K, JK, ("r1norm", "r2norm", "Arnorm", "xnorm"))
    x_sqd = A.T @ np.linalg.solve(A @ A.T + np.eye(m), b)
    np.testing.assert_allclose(K.x.numpy(), x_sqd, atol=1e-9)
    assert K.r.shape == (m,)

    K2 = C.CRAIGMRFramework(MatrixOperator(torch.from_numpy(A), device=DEV))
    K2.solve(b, etol=1e-13)
    JK2 = J.CRAIGMRFramework(JMatrix(jnp.asarray(A)))
    JK2.solve(jnp.asarray(b), etol=1e-13)
    _same(K2, JK2)
    np.testing.assert_allclose(
        K2.x.numpy(), np.linalg.solve(A @ A.T + np.eye(m), b), atol=1e-9)
    K2.init_data()
    assert K2.x is None and not K2.converged


def test_base_class_and_names_match_jax():
    assert C.__all__ == J.__all__
    for name in J.__all__:
        port, ref = getattr(C, name), getattr(J, name)
        assert port.name == ref.name and port.acronym == ref.acronym
    with pytest.raises(NotImplementedError):
        C.KrylovMethod(None).solve(None)
    assert C.null_log.name == J.null_log.name == "krylov"


# the reference's import paths: each module of the port's package root and
# the names its JAX twin exports
SHIMS = ("cg", "minres", "symmlq", "bicgstab", "cgs", "tfqmr", "lls",
         "linop", "generic", "tools")


@pytest.mark.parametrize("shim", SHIMS)
def test_import_path_exports_match_jax(shim):
    port = importlib.import_module("pykrylov_tpu_torch." + shim)
    ref = importlib.import_module("pykrylov_tpu." + shim)
    if shim == "linop":
        # the port's operator layer so far (queue 1 items 3 and 17 bring
        # the rest); every name it has is one the JAX layer has
        assert set(port.__all__) <= set(ref.__all__)
        assert port.__all__ == pt.ops.__all__
    else:
        assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_reference_import_paths():
    from pykrylov_tpu_torch.cg import CG, solve_cg
    from pykrylov_tpu_torch.minres import Minres
    from pykrylov_tpu_torch.symmlq import Symmlq
    from pykrylov_tpu_torch.bicgstab import BiCGSTAB
    from pykrylov_tpu_torch.cgs import CGS
    from pykrylov_tpu_torch.tfqmr import TFQMR
    from pykrylov_tpu_torch.lls import (LSQRFramework, LSMRFramework,
                                        CRAIGFramework, CRAIGMRFramework,
                                        symOrtho)
    from pykrylov_tpu_torch.generic import KrylovMethod, null_log, \
        SolveResult
    from pykrylov_tpu_torch.linop import (LinearOperator, DiagonalOperator,
                                          ShapeError)
    from pykrylov_tpu_torch.tools import (check_symmetric, machine_epsilon,
                                          roots_quadratic, allowed_types)

    for cls in (CG, Minres, Symmlq, BiCGSTAB, CGS, TFQMR, LSQRFramework,
                LSMRFramework, CRAIGFramework, CRAIGMRFramework):
        assert issubclass(cls, KrylovMethod)
    assert solve_cg is pt.solvers.cg
    assert SolveResult is pt.SolveResult and null_log is C.null_log
    assert LinearOperator is pt.LinearOperator
    assert symOrtho(3.0, 4.0)[2] == 5.0
    assert check_symmetric is pt.check_symmetric
    assert callable(machine_epsilon) and callable(roots_quadratic)
    assert allowed_types and DiagonalOperator and ShapeError


def test_top_level_surface():
    # the package's solver names stay the functions after the import-path
    # modules of the same names are imported
    import pykrylov_tpu_torch.cg  # noqa: F401
    import pykrylov_tpu_torch.tfqmr  # noqa: F401
    for name in ("cg", "minres", "symmlq", "bicgstab", "cgs", "tfqmr",
                 "lsqr", "lsmr", "craig", "craigmr"):
        assert getattr(pt, name) is getattr(pt.solvers, name), name
        assert callable(getattr(pt.solvers, name)), name
    assert callable(pt.solve) and pt.compat is C
    for sub in ("solvers", "sparse", "io", "gallery", "compat"):
        assert getattr(pt, sub) is not None
