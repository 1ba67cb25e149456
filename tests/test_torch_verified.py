"""The port's in-loop verified solvers against the JAX package's: ff-CG
(``cg(replace_every=)``), ff-MINRES (``minres(replace_every=)``), their
block twins (``cg_batched``/``minres_batched`` with ``replace_every``), and
the compensated ``verify_final`` certificates.

The same NumPy inputs, made from a seed, go through both packages on the
CPU.  Tolerances:

  * float64: the same ``istop``, ``n_iter``, ``n_replacements`` and
    ``n_matvec``, x within 1e-10 relative;
  * float32: the same ``istop``, ``n_iter`` and ``n_replacements`` within
    10%, both verified true residuals (of ``x + x_lo``, in float64) at or
    below the target.  The port carries ff-MINRES's scalars as host
    float64 values where the JAX package keeps float32 (hi, lo) pairs, so
    float32 runs agree by contract, not bit for bit;
  * the block twins: each column against the port's single verified
    solver, iterations within 10% and x within 1e-8, and against the JAX
    twin at the same tolerances;
  * the certificates: ``verify_final``'s ``true_resid_norm`` (and
    ``true_normar``) of the same x equal the JAX package's to 1e-6
    relative on float32 ELL and dense operators.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled as jax_load_bundled
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu import solvers as JS
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers.common import (attach_true_lls_residual,
                                               attach_true_residual)
from pykrylov_tpu_torch.sparse import operator_from_coo, sparse_operator

DEV = "cpu"  # the port's entry points default to the card
COUNT_RTOL = 0.1


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the loops are thousands of small launches: torch's intra-op thread
    # pool only adds overhead, and under pytest-xdist it oversubscribes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def full_x(res):
    """``x + x_lo`` in float64 (the double-f32 solution)."""
    return (np.asarray(res.x, np.float64)
            + np.asarray(res.info["x_lo"], np.float64))


def within(a, b, frac=COUNT_RTOL):
    a, b = int(a), int(b)
    return abs(a - b) <= np.ceil(frac * b)


@pytest.fixture(scope="module")
def bus():
    """f32 1138bus as ELL in both packages, the f64 view of the same f32
    values, and Jacobi M = 1/max(|d|, 1) (``tests/test_refine.py``)."""
    vals, rows, cols, shape = jax_load_bundled("1138bus")
    v32 = vals.astype(np.float32)
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), v32.astype(np.float64))
    d = np.zeros(shape[0], np.float32)
    dm = rows == cols
    d[rows[dm]] = v32[dm]
    minv = (1.0 / np.maximum(np.abs(d), 1.0)).astype(np.float32)
    return {"a64": a64, "minv": minv, "shape": shape,
            "op": sparse_operator((v32, rows, cols, shape), symmetric=True,
                                  fmt="ell", device=DEV),
            "jop": jax_sparse_operator((v32, rows, cols, shape),
                                       symmetric=True, fmt="ell")}


def spd(n=200, seed=3):
    """``tests/test_ff.py``'s SPD system: q q^T / 100 + 2 I."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n)) * 0.1
    return q @ q.T + np.eye(n) * 2, rng.standard_normal(n)


def gapped(n=120, seed=3):
    """An indefinite spectrum in [-5, -1] and [1, 5], b = A x_true."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    e = np.linspace(-5, 5, n)
    e = np.where(np.abs(e) < 1, np.where(e < 0, -1, 1), e)
    A = (Q * e) @ Q.T
    A = 0.5 * (A + A.T)
    return A, A @ rng.standard_normal(n)


def shifted_poisson_1d(n=200, nneg=10):
    """``tests/test_refine.py``'s indefinite system: 1-D Poisson shifted
    between its ``nneg``-th and next eigenvalue, f32."""
    a = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    eig = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    a -= 0.5 * (eig[nneg - 1] + eig[nneg]) * np.eye(n)
    return a.astype(np.float32)


def dense_pair(a, sym=True):
    return (MatrixOperator(torch.from_numpy(a), symmetric=sym, device=DEV),
            linop_from_ndarray(jnp.asarray(a), symmetric=sym))


def assert_same_f64(t, j, x_rtol=1e-10):
    assert int(t.istop) == int(j.istop)
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    assert int(t.info["n_replacements"]) == int(j.info["n_replacements"])
    assert rel(t.x.numpy(), j.x) <= x_rtol
    # the verified residuals: near the f64 floor (rtol 1e-11) they are
    # rounding noise of x, so within 1e-10 of ||b|| there
    assert float(t.resid_norm) == pytest.approx(
        float(j.resid_norm), rel=1e-6, abs=1e-10 * float(j.resid_norm0))


# --------------------------------------------------------------------------
# ff-CG
# --------------------------------------------------------------------------

def test_ff_cg_f32_1138bus_reaches_1e6(bus):
    # tests/test_ff.py::test_verified_cg_f32_reaches_1e6 on both packages:
    # unpreconditioned f32 CG with compensated products and replacements
    b64 = bus["a64"] @ np.ones(bus["shape"][0])
    opts = dict(rtol=1e-6, atol=0.0, maxiter=60000, replace_every=1000)
    t = PS.cg(bus["op"], torch.tensor(b64, dtype=torch.float32), **opts)
    j = JS.cg(bus["jop"], jnp.asarray(b64, jnp.float32), **opts)
    assert int(t.istop) == int(j.istop) == 0
    assert within(t.n_iter, j.n_iter)
    assert within(t.info["n_replacements"], j.info["n_replacements"])
    for r in (t, j):
        rn = np.linalg.norm(bus["a64"] @ full_x(r) - b64)
        assert rn <= 2.5e-6 * np.linalg.norm(b64)
        # the ELL storage is compensated: one product a replacement
        assert int(r.n_matvec) == int(r.n_iter) + int(
            r.info["n_replacements"])
    assert t.info["x_lo"].dtype == torch.float32


@pytest.mark.parametrize("replace_every", [10, 25, 1000])
def test_replacement_keeps_exact_arithmetic_results(replace_every):
    # tests/test_ff.py's f64 case: replacement leaves the converged answer
    # in place; the port's ff-CG is the JAX package's, step for step
    a, b = spd()
    top, jop = dense_pair(a)
    r0 = PS.cg(top, torch.from_numpy(b), rtol=1e-12, atol=0.0, maxiter=2000)
    t = PS.cg(top, torch.from_numpy(b), rtol=1e-12, atol=0.0, maxiter=2000,
              replace_every=replace_every)
    j = JS.cg(jop, jnp.asarray(b), rtol=1e-12, atol=0.0, maxiter=2000,
              replace_every=replace_every)
    assert bool(r0.converged) and bool(t.converged)
    np.testing.assert_allclose(t.x.numpy(), r0.x.numpy(), rtol=1e-9,
                               atol=1e-11)
    assert_same_f64(t, j)


@pytest.mark.parametrize("x0,M", [(False, False), (True, False),
                                  (False, True)])
def test_ff_cg_without_a_compensated_product(x0, M):
    # plain DIA storage (the CUDA DIA operator's plain version here) has no
    # compensated product in either package: two applies a replacement
    vals, rows, cols, shape = poisson3d_coo(8)
    n = shape[0]
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    top = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                            fmt="cuda-dia", device=DEV)
    jop = jax_sparse_operator((vals, rows, cols, shape), symmetric=True,
                              fmt="dia")
    assert PS.ffmv.resolve_ff_matvec(top) is None
    opts = dict(rtol=1e-10, replace_every=15, leg_rtol=1e-3)
    g = 0.01 * rng.standard_normal(n) if x0 else None
    d = 1.0 / (6.0 + rng.random(n)) if M else None
    t = PS.cg(top, torch.from_numpy(b),
              x0=None if g is None else torch.from_numpy(g),
              M=None if d is None else DiagonalOperator(torch.from_numpy(d),
                                                        device=DEV), **opts)
    j = JS.cg(jop, jnp.asarray(b), x0=None if g is None else jnp.asarray(g),
              M=None if d is None else JDiagonalOperator(jnp.asarray(d)),
              **opts)
    assert_same_f64(t, j)
    assert int(t.n_matvec) == int(t.n_iter) + int(x0) + 2 * int(
        t.info["n_replacements"])
    assert int(t.info["n_replacements"]) >= 2


def test_ff_cg_curvature_abort():
    # a declared-SPD indefinite operator: the verified loop aborts on
    # nonpositive curvature (istop 2) as the plain one does
    a = shifted_poisson_1d().astype(np.float64)
    top, jop = dense_pair(a)
    b = np.ones(a.shape[0])
    t = PS.cg(top, torch.from_numpy(b), replace_every=20,
              check_curvature=True)
    j = JS.cg(jop, jnp.asarray(b), replace_every=20, check_curvature=True)
    assert int(t.istop) == int(j.istop) == 2
    assert int(t.n_iter) == int(j.n_iter)
    assert not bool(t.info["definite"])
    assert rel(t.info["infinite_descent"].numpy(),
               j.info["infinite_descent"]) <= 1e-10


# --------------------------------------------------------------------------
# ff-MINRES
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rtol,replace_every", [
    (1e-8, 7), (1e-8, 50), (1e-9, 10), (1e-11, 25)])
def test_ff_minres_f64_matches_jax(rtol, replace_every):
    A, b = gapped()
    top, jop = dense_pair(A)
    t = PS.minres(top, torch.from_numpy(b), rtol=rtol,
                  replace_every=replace_every)
    j = JS.minres(jop, jnp.asarray(b), rtol=rtol,
                  replace_every=replace_every)
    assert int(t.istop) == 1
    assert_same_f64(t, j)
    # double-double: the low part is below an ulp of the high part
    assert (t.info["x_lo"].abs() <= 2.3e-16 * t.x.abs()).all()
    rn = np.linalg.norm(A @ full_x(t) - b)
    assert rn <= rtol * np.linalg.norm(b)
    assert float(t.resid_norm) == pytest.approx(rn, rel=1e-6)


@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_ff_minres_without_a_compensated_product(shift):
    # plain DIA storage, f64, with a shift: two applies a Lanczos step and
    # two a verification in both packages
    vals, rows, cols, shape = poisson3d_coo(8)
    b = np.random.default_rng(8).standard_normal(shape[0])
    top = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                            fmt="cuda-dia", device=DEV)
    jop = jax_sparse_operator((vals, rows, cols, shape), symmetric=True,
                              fmt="dia")
    t = PS.minres(top, torch.from_numpy(b), shift=shift, rtol=1e-9,
                  replace_every=10, atol=1e-30)
    j = JS.minres(jop, jnp.asarray(b), shift=shift, rtol=1e-9,
                  replace_every=10, atol=1e-30)
    assert_same_f64(t, j)
    assert int(t.n_matvec) == 2 * (int(t.n_iter) + int(
        t.info["n_replacements"]))


def test_ff_minres_f32_indefinite_matches_jax():
    a32 = shifted_poisson_1d()
    a64 = a32.astype(np.float64)
    b64 = a64 @ np.random.default_rng(5).standard_normal(a32.shape[0])
    top, jop = dense_pair(a32)
    opts = dict(rtol=1e-6, replace_every=50, itnlim=2000)
    t = PS.minres(top, torch.tensor(b64, dtype=torch.float32), **opts)
    j = JS.minres(jop, jnp.asarray(b64, jnp.float32), **opts)
    assert int(t.istop) == int(j.istop) == 1
    assert within(t.n_iter, j.n_iter)
    assert within(t.info["n_replacements"], j.info["n_replacements"])
    for r in (t, j):
        assert np.linalg.norm(a64 @ full_x(r) - b64) <= \
            1e-6 * np.linalg.norm(b64) * (1 + 1e-3)


def test_minres_replace_every_certificate_is_honest(bus):
    # tests/test_refine.py's case on both packages: the reported residual
    # is the true residual of x + x_lo, never a recurrence claim.  On this
    # kappa~1e7 system the JAX package's float32 scalar pairs stall (istop
    # 6 at itnlim 1500, true 1e-3) where the port's host float64 scalars
    # reach the target (istop 1, about 700 iterations): both honest
    b64 = bus["a64"] @ np.ones(bus["shape"][0])
    opts = dict(rtol=1e-6, itnlim=1500, replace_every=50)
    t = PS.minres(bus["op"], torch.tensor(b64, dtype=torch.float32),
                  M=DiagonalOperator(torch.from_numpy(bus["minv"]),
                                     device=DEV), **opts)
    j = JS.minres(bus["jop"], jnp.asarray(b64, jnp.float32),
                  M=JDiagonalOperator(jnp.asarray(bus["minv"])), **opts)
    for r in (t, j):
        true = np.linalg.norm(bus["a64"] @ full_x(r) - b64)
        assert abs(float(r.resid_norm) - true) <= 0.05 * true
        assert int(r.info["n_replacements"]) >= 1
        assert int(r.n_matvec) == int(r.n_iter) + int(
            r.info["n_replacements"])
    assert int(t.istop) == 1 and bool(t.converged)
    assert float(t.resid_norm) <= 1e-6 * np.linalg.norm(b64)


# --------------------------------------------------------------------------
# the block twins
# --------------------------------------------------------------------------

def _columns_vs_single(res, single):
    for k, s in enumerate(single):
        assert int(res.istop[k]) == int(s.istop)
        assert within(res.info["n_iter_columns"][k], s.n_iter)
        assert rel(res.x[:, k].numpy(), s.x.numpy()) <= 1e-8


@pytest.mark.parametrize("fmt", ["dense", "cuda-dia"])
def test_cg_batched_replace_every(fmt):
    if fmt == "dense":
        a, _ = spd(n=120)
        top, jop = dense_pair(a)
    else:
        vals, rows, cols, shape = poisson3d_coo(8)
        top = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                                fmt="cuda-dia", device=DEV)
        jop = jax_sparse_operator((vals, rows, cols, shape),
                                  symmetric=True, fmt="dia")
    n = top.shape[0]
    B = np.random.default_rng(9).standard_normal((n, 3))
    B[:, 2] *= 1e-3
    opts = dict(rtol=1e-10, atol=0.0, replace_every=12, leg_rtol=1e-3)
    t = PS.cg_batched(top, torch.from_numpy(B), **opts)
    j = JS.cg_batched(jop, jnp.asarray(B), **opts)
    assert set(t.info) == set(j.info)
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    np.testing.assert_array_equal(t.info["n_replacements"].numpy(),
                                  np.asarray(j.info["n_replacements"]))
    assert rel(t.x.numpy(), j.x) <= 1e-10
    single = [PS.cg(top, torch.from_numpy(B[:, k]), **opts)
              for k in range(3)]
    _columns_vs_single(t, single)
    for k, s in enumerate(single):
        assert int(t.info["n_replacements"][k]) == int(
            s.info["n_replacements"])


def test_minres_batched_replace_every():
    A, b = gapped()
    top, jop = dense_pair(A)
    rng = np.random.default_rng(10)
    B = np.stack([b, rng.standard_normal(b.shape[0]),
                  np.zeros(b.shape[0])], axis=1)
    opts = dict(rtol=1e-9, replace_every=10)
    t = PS.minres_batched(top, torch.from_numpy(B), **opts)
    j = JS.minres_batched(jop, jnp.asarray(B), **opts)
    assert set(t.info) == set(j.info)
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    np.testing.assert_array_equal(t.converged.numpy(),
                                  np.asarray(j.converged))
    np.testing.assert_array_equal(t.info["n_iter_columns"].numpy(),
                                  np.asarray(j.info["n_iter_columns"]))
    assert int(t.n_matvec) == int(j.n_matvec)
    assert rel(t.x.numpy(), j.x) <= 1e-10
    assert (t.x[:, 2] == 0).all() and bool(t.converged[2])
    single = [PS.minres(top, torch.from_numpy(B[:, k]), **opts)
              for k in range(2)]
    _columns_vs_single(t, single)


def test_minres_batched_ff_products_per_iteration():
    # without a compensated product each Lanczos step is one (n, 2K) block
    # product, and each verification event one more
    vals, rows, cols, shape = poisson3d_coo(8)
    top = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                            fmt="cuda-dia", device=DEV)
    calls = []
    inner = top._mm

    def counted(X):
        calls.append(X.shape[1])
        return inner(X)

    top._mm = counted
    B = np.random.default_rng(11).standard_normal((shape[0], 4))
    res = PS.minres_batched(top, torch.from_numpy(B), rtol=1e-8,
                            replace_every=20)
    assert set(calls) == {8}
    assert len(calls) == int(res.n_matvec) // 2
    assert bool(res.converged.all())


# --------------------------------------------------------------------------
# the compensated certificates
# --------------------------------------------------------------------------

def _certificates(name, op, jop, b64, **opts):
    """``name``'s JAX solve with ``verify_final`` and the port's
    certificate of the same x."""
    j = getattr(JS, name)(jop, jnp.asarray(b64, jnp.float32),
                          verify_final=True, **opts)
    res = dataclasses.replace(
        getattr(PS, name)(op, torch.tensor(b64, dtype=torch.float32),
                          **dict(opts, **({"itnlim": 1} if name != "cg"
                                          else {"maxiter": 1}))),
        x=torch.from_numpy(np.array(j.x)), info={})
    b = torch.tensor(b64, dtype=torch.float32)
    if name == "lsqr":
        t = attach_true_lls_residual(op, b, res)
    else:
        t = attach_true_residual(op, b, res, opts.get("shift", 0.0))
    return t.info, j.info


@pytest.mark.parametrize("name", ["cg", "minres", "lsqr"])
@pytest.mark.parametrize("storage", ["ell", "dense"])
def test_verify_final_certificates_are_compensated(bus, name, storage):
    if storage == "ell":
        op, jop, a64 = bus["op"], bus["jop"], bus["a64"]
        b64 = a64 @ np.ones(a64.shape[0])
    else:
        a64 = spd(n=150)[0].astype(np.float32).astype(np.float64)
        op, jop = dense_pair(a64.astype(np.float32))
        b64 = a64 @ np.random.default_rng(12).standard_normal(150)
    opts = {"cg": {"rtol": 1e-6}, "minres": {"rtol": 1e-8, "shift": 0.0},
            "lsqr": {"atol": 1e-7, "btol": 1e-7}}[name]
    t, j = _certificates(name, op, jop, b64, **opts)
    keys = ("true_resid_norm", "true_normar") if name == "lsqr" else \
        ("true_resid_norm",)
    for key in keys:
        assert float(t[key]) == pytest.approx(float(j[key]), rel=1e-6), key
