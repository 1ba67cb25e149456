"""The port's refinement drivers (``solvers/refine.py``) against the JAX
package's, on the cases of ``tests/test_refine.py`` and the same inputs.

Each case runs ``refined_solve``, ``refined_lls`` or
``refined_solve_batched`` in both packages on the CPU (float32 1138bus and
jpwh_991 as ELL, f32 dense systems, Jacobi M = 1/max(|d|, 1)).
Tolerances:

  * the same ``istop`` (per column for blocks) and leg counts within one;
  * both verified true residuals (of ``x + x_lo``, in float64) at or below
    the case's target, and each reported residual the true one;
  * the live ``show`` rows equal the JAX package's text (a float64 case);
  * float64 x within 1e-10 relative.

Float32 runs agree by contract, not bit for bit: the legs' reductions run
in another order in each package, and ff-MINRES legs carry host float64
scalars in the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu import solve as jax_solve
from pykrylov_tpu import solvers as JS
from pykrylov_tpu.io.datasets import load_bundled as jax_load_bundled
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import MatrixOperator as JMatrixOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu.solvers.refine import ISTOP_MSG as JAX_ISTOP_MSG
from pykrylov_tpu.solvers.result import SolveResult as JSolveResult
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers.refine import ISTOP_MSG
from pykrylov_tpu_torch.solvers.result import SolveResult
from pykrylov_tpu_torch.sparse import sparse_operator

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the loops are thousands of small launches: torch's intra-op thread
    # pool only adds overhead, and under pytest-xdist it oversubscribes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def full_x(res):
    return (np.asarray(res.x, np.float64)
            + np.asarray(res.info["x_lo"], np.float64))


def true_rel(a64, b64, res):
    return np.linalg.norm(a64 @ full_x(res) - b64) / np.linalg.norm(b64)


def f32(b64):
    return torch.tensor(b64, dtype=torch.float32), jnp.asarray(b64,
                                                               jnp.float32)


def solver_pair(name):
    return getattr(PS, name), getattr(JS, name)


def same_contract(t, j, legs=1):
    """The same stop code, leg counts within ``legs``."""
    assert int(t.istop) == int(j.istop), (int(t.istop), int(j.istop))
    assert abs(t.info["n_legs"] - j.info["n_legs"]) <= legs
    assert len(t.info["inner_istop"]) == max(t.info["n_legs"], 1)


def dense_pair(a, sym=False):
    return (MatrixOperator(torch.from_numpy(a), symmetric=sym, device=DEV),
            linop_from_ndarray(jnp.asarray(a), symmetric=sym))


@pytest.fixture(scope="module")
def bus():
    vals, rows, cols, shape = jax_load_bundled("1138bus")
    v32 = vals.astype(np.float32)
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), v32.astype(np.float64))
    d = np.zeros(shape[0], np.float32)
    dm = rows == cols
    d[rows[dm]] = v32[dm]
    minv = (1.0 / np.maximum(np.abs(d), 1.0)).astype(np.float32)
    return {"a64": a64, "b64": a64 @ np.ones(shape[0]),
            "op": sparse_operator((v32, rows, cols, shape), symmetric=True,
                                  fmt="ell", device=DEV),
            "jop": jax_sparse_operator((v32, rows, cols, shape),
                                       symmetric=True, fmt="ell"),
            "M": DiagonalOperator(torch.from_numpy(minv), device=DEV),
            "jM": JDiagonalOperator(jnp.asarray(minv))}


def indefinite_f32(n=200, nneg=10):
    """Shifted 1-D Poisson, symmetric indefinite, f32 storage."""
    a = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    eig = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    a -= 0.5 * (eig[nneg - 1] + eig[nneg]) * np.eye(n)
    a32 = a.astype(np.float32)
    return a32, a32.astype(np.float64)


# --------------------------------------------------------------------------
# refined_solve
# --------------------------------------------------------------------------

def test_refined_minres_f32_verified_1e6_on_hard_system(bus):
    # BASELINE config #2 (MINRES / 1138bus / Jacobi) in f32 through
    # ff-MINRES legs (leg_replace_every="auto")
    b, jb = f32(bus["b64"])
    opts = dict(rtol=1e-6, leg_rtol=1e-2, max_legs=12, leg_maxiter=1200)
    t = PS.refined_solve(PS.minres, bus["op"], b, M=bus["M"], **opts)
    j = JS.refined_solve(JS.minres, bus["jop"], jb, M=bus["jM"], **opts)
    same_contract(t, j)
    for r in (t, j):
        rel = true_rel(bus["a64"], bus["b64"], r)
        assert bool(r.converged) and rel < 2.5e-6, rel
        assert abs(float(r.resid_norm) - rel * np.linalg.norm(
            bus["b64"])) <= 1e-2 * float(r.resid_norm)
    assert float(t.resid_history[0]) == float(t.resid_norm0)
    # the legs are ff-MINRES: each leg's matvecs include its verifications
    assert (t.info["inner_n_matvec"] > t.info["inner_n_iter"]).all()


@pytest.mark.parametrize("name,leg_maxiter", [("minres", 400),
                                              ("symmlq", 400)])
def test_refined_f32_verified_1e6_indefinite(name, leg_maxiter):
    a32, a64 = indefinite_f32()
    b64 = a64 @ np.random.default_rng(5 if name == "minres"
                                      else 6).standard_normal(200)
    top, jop = dense_pair(a32, sym=True)
    b, jb = f32(b64)
    ts, js = solver_pair(name)
    opts = dict(rtol=1e-6, leg_rtol=1e-2, max_legs=30,
                leg_maxiter=leg_maxiter)
    t = PS.refined_solve(ts, top, b, **opts)
    j = JS.refined_solve(js, jop, jb, **opts)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        assert true_rel(a64, b64, r) < 2.5e-6
    assert t.info["n_legs"] >= 2


def test_refined_minres_f32_verified_1e6_kappa1e7_indefinite():
    # 1138bus plus a negative-definite block of 20 (saddle-point-like,
    # kappa ~1e7), f32, through the auto format (ELL in both packages)
    vals, rows, cols, shape = jax_load_bundled("1138bus")
    n0, k = shape[0], 20
    n = n0 + k
    v2 = np.concatenate([vals, -np.logspace(3, 4, k)]).astype(np.float32)
    r2 = np.concatenate([rows, n0 + np.arange(k)])
    c2 = np.concatenate([cols, n0 + np.arange(k)])
    top = sparse_operator((v2, r2, c2, (n, n)), symmetric=True, device=DEV)
    jop = jax_sparse_operator((v2, r2, c2, (n, n)), symmetric=True)
    a64 = np.zeros((n, n))
    np.add.at(a64, (r2, c2), v2.astype(np.float64))
    d = (1.0 / np.abs(np.diag(a64))).astype(np.float32)
    b64 = a64 @ np.ones(n)
    b, jb = f32(b64)
    opts = dict(rtol=1e-6, leg_rtol=1e-2, max_legs=12, leg_maxiter=1200)
    t = PS.refined_solve(PS.minres, top, b, M=DiagonalOperator(
        torch.from_numpy(d), device=DEV), **opts)
    j = JS.refined_solve(JS.minres, jop, jb,
                         M=JDiagonalOperator(jnp.asarray(d)), **opts)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged) and true_rel(a64, b64, r) < 2.5e-6


def test_refined_cg_matches_ff_cg_contract(bus):
    b, jb = f32(bus["b64"])
    opts = dict(rtol=1e-6, leg_rtol=1e-2, max_legs=40)
    t = PS.refined_solve(PS.cg, bus["op"], b, **opts)
    j = JS.refined_solve(JS.cg, bus["jop"], jb, **opts)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        assert true_rel(bus["a64"], bus["b64"], r) < 2.5e-6
        # inner matvecs plus one compensated verification a leg
        inner = int(np.asarray(r.info["inner_n_iter"]).sum())
        assert int(r.n_matvec) == inner + r.info["n_legs"]


@pytest.mark.parametrize("name", ["cgs", "tfqmr", "bicgstab"])
def test_refined_transpose_free_f32(name):
    # jpwh_991 with the reference bmark protocol's guess
    vals, rows, cols, shape = jax_load_bundled("jpwh_991")
    v32 = vals.astype(np.float32)
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), v32.astype(np.float64))
    top = sparse_operator((v32, rows, cols, shape), fmt="ell", device=DEV)
    jop = jax_sparse_operator((v32, rows, cols, shape), fmt="ell")
    b64 = a64 @ np.ones(shape[0])
    b, jb = f32(b64)
    x0 = 1.0 + np.arange(shape[0])
    ts, js = solver_pair(name)
    opts = dict(rtol=1e-6, leg_rtol=1e-2, max_legs=30)
    t = PS.refined_solve(ts, top, b, x0=torch.tensor(x0, dtype=torch.float32),
                         **opts)
    j = JS.refined_solve(js, jop, jb, x0=jnp.asarray(x0, jnp.float32),
                         **opts)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        rn = np.linalg.norm(a64 @ full_x(r) - b64)
        assert rn <= 1.001 * 1e-6 * float(r.resid_norm0)
    assert float(t.resid_norm0) == pytest.approx(float(j.resid_norm0),
                                                 rel=1e-6)


def test_refined_stall_reports_floor(bus):
    # a target below the compensated floor stops with istop 2 or 3, finite,
    # well inside the leg budget
    b, jb = f32(bus["b64"])
    opts = dict(rtol=1e-14, leg_rtol=1e-2, max_legs=60)
    t = PS.refined_solve(PS.minres, bus["op"], b, M=bus["M"], **opts)
    j = JS.refined_solve(JS.minres, bus["jop"], jb, M=bus["jM"], **opts)
    for r in (t, j):
        assert not bool(r.converged)
        assert int(r.istop) in (2, 3)
        assert np.isfinite(float(r.resid_norm))
        assert r.info["n_legs"] < 60
    assert int(t.istop) == int(j.istop)


def test_refined_zero_rhs(bus):
    t = PS.refined_solve(PS.minres, bus["op"],
                         torch.zeros(bus["a64"].shape[0]), rtol=1e-6)
    j = JS.refined_solve(JS.minres, bus["jop"],
                         jnp.zeros(bus["a64"].shape[0], jnp.float32),
                         rtol=1e-6)
    for r in (t, j):
        assert bool(r.converged) and r.info["n_legs"] == 0
        np.testing.assert_array_equal(np.asarray(r.x), 0.0)
    assert int(t.n_matvec) == int(j.n_matvec) == 0


def test_refined_small_norm_rhs_not_floored_by_leg_atol():
    # legs get atol=0: the solvers' absolute default would stop small-norm
    # legs at once and report a reachable target as a floor
    rng = np.random.default_rng(11)
    n = 100
    a = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1)).astype(np.float32)
    x_true = rng.standard_normal(n).astype(np.float32) * 1e-3
    b = (a.astype(np.float64) @ x_true).astype(np.float32)
    top, jop = dense_pair(a)
    t = PS.refined_solve(PS.cg, top, torch.from_numpy(b), rtol=1e-6)
    j = JS.refined_solve(JS.cg, jop, jnp.asarray(b), rtol=1e-6)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        assert float(r.resid_norm) <= 1e-6 * float(r.resid_norm0)


def test_solve_verified_indefinite_falls_back_to_minres_legs():
    # a declared-symmetric indefinite operator: the CG legs abort on
    # curvature and the front door reroutes to refined MINRES legs
    a32, a64 = indefinite_f32()
    b64 = a64 @ np.random.default_rng(13).standard_normal(200)
    b, jb = f32(b64)
    t = pt.solve(MatrixOperator(torch.from_numpy(a32), symmetric=True,
                                device=DEV), b, verified=True, rtol=1e-6,
                 leg_maxiter=400)
    j = jax_solve(JMatrixOperator(jnp.asarray(a32), symmetric=True), jb,
                  verified=True, rtol=1e-6, leg_maxiter=400)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        assert true_rel(a64, b64, r) < 2.5e-6
        # MINRES legs: ff-MINRES's stop codes, never CG's curvature trip
        assert 2 not in np.asarray(r.info["inner_istop"]).tolist()


@pytest.mark.parametrize("name", ["cg", "bicgstab"])
def test_refined_f64_matches_jax(name):
    # float64: the legs are the JAX package's step for step
    rng = np.random.default_rng(14)
    n = 150
    a = rng.standard_normal((n, n)) * 0.1 + 4.0 * np.eye(n)
    if name == "cg":
        a = 0.5 * (a + a.T)
    b = a @ rng.standard_normal(n)
    top, jop = dense_pair(a, sym=name == "cg")
    ts, js = solver_pair(name)
    opts = dict(rtol=1e-13, leg_rtol=1e-3, max_legs=10)
    t = PS.refined_solve(ts, top, torch.from_numpy(b), **opts)
    j = JS.refined_solve(js, jop, jnp.asarray(b), **opts)
    assert int(t.istop) == int(j.istop) == 0
    assert t.info["n_legs"] == j.info["n_legs"]
    assert int(t.n_matvec) == int(j.n_matvec)
    np.testing.assert_array_equal(t.info["inner_n_iter"].numpy(),
                                  np.asarray(j.info["inner_n_iter"]))
    assert np.linalg.norm(full_x(t) - full_x(j)) <= \
        1e-10 * np.linalg.norm(full_x(j))


def test_refined_show_rows_match_jax(capsys):
    rng = np.random.default_rng(15)
    n = 120
    a = rng.standard_normal((n, n)) * 0.1 + 4.0 * np.eye(n)
    b = a @ rng.standard_normal(n)
    top, jop = dense_pair(a)
    opts = dict(rtol=1e-12, leg_rtol=1e-3, max_legs=8, show=True)
    PS.refined_solve(PS.bicgstab, top, torch.from_numpy(b), **opts)
    out_t = capsys.readouterr().out
    JS.refined_solve(JS.bicgstab, jop, jnp.asarray(b), **opts)
    out_j = capsys.readouterr().out
    assert out_t == out_j
    assert len(out_t.splitlines()) >= 3
    assert ISTOP_MSG == JAX_ISTOP_MSG
    assert pt.ISTOP_MSGS["refined_solve"] is ISTOP_MSG


# --------------------------------------------------------------------------
# refined_lls
# --------------------------------------------------------------------------

def lls_f32(cond_exp=3, m=600, n=200, seed=0):
    """An f32-stored dense least-squares problem with singular values
    1..10^cond_exp; the f64 view of the same f32 values is the oracle."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((U * np.logspace(0, cond_exp, n)) @ V.T).astype(np.float32)
    a64 = a.astype(np.float64)
    b = (a64 @ rng.standard_normal(n)
         + 0.01 * rng.standard_normal(m)).astype(np.float32)
    top, jop = dense_pair(a)
    return top, jop, a64, b.astype(np.float64)


def true_test2(a64, b64, res):
    rt = b64 - a64 @ full_x(res)
    return np.linalg.norm(a64.T @ rt) / (np.linalg.norm(a64, 2)
                                         * np.linalg.norm(rt))


def test_refined_lls_beats_single_f32_run():
    top, jop, a64, b64 = lls_f32(cond_exp=3)
    b, jb = f32(b64)
    single = PS.lsqr(top, b, atol=1e-10, btol=1e-10, etol=0.0, itnlim=4000)
    rt = b64 - a64 @ single.x.double().numpy()
    t2_single = np.linalg.norm(a64.T @ rt) / (np.linalg.norm(a64, 2)
                                              * np.linalg.norm(rt))
    opts = dict(atol=1e-4, max_legs=15, leg_tol=1e-3)
    t = PS.refined_lls(PS.lsqr, top, b, **opts)
    j = JS.refined_lls(JS.lsqr, jop, jb, **opts)
    same_contract(t, j)
    for r in (t, j):
        t2 = true_test2(a64, b64, r)
        assert t2 < 2e-3 and t2 < 0.1 * t2_single, (t2, t2_single)
    true_na = np.linalg.norm(a64.T @ (b64 - a64 @ full_x(t)))
    assert abs(float(t.info["true_normar"]) - true_na) <= \
        0.5 * true_na + 1e-3 * np.linalg.norm(a64, 2)
    assert t.info["normar_history"].shape[0] == t.info["n_legs"] + 1


def test_refined_lls_lsmr_legs_well_conditioned():
    top, jop, a64, b64 = lls_f32(cond_exp=1, seed=3)
    b, jb = f32(b64)
    t = PS.refined_lls(PS.lsmr, top, b, atol=1e-5, max_legs=15)
    j = JS.refined_lls(JS.lsmr, jop, jb, atol=1e-5, max_legs=15)
    same_contract(t, j)
    x_ref = np.linalg.lstsq(a64, b64, rcond=None)[0]
    for r in (t, j):
        assert true_test2(a64, b64, r) < 1e-4
        assert np.linalg.norm(full_x(r) - x_ref) < 1e-3 * np.linalg.norm(
            x_ref)


def test_refined_lls_consistent_system_btol_stop():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((300, 80)).astype(np.float32)
    b64 = a.astype(np.float64) @ rng.standard_normal(80)
    top, jop = dense_pair(a)
    b, jb = f32(b64)
    t = PS.refined_lls(PS.lsqr, top, b, btol=1e-5, max_legs=10)
    j = JS.refined_lls(JS.lsqr, jop, jb, btol=1e-5, max_legs=10)
    same_contract(t, j)
    for r in (t, j):
        assert bool(r.converged)
        assert float(r.resid_norm) <= 1e-5 * np.linalg.norm(b64) * 1.01


@pytest.mark.parametrize("kw", ["damp", "M", "N", "M array"])
def test_refined_lls_rejects_damp_and_preconditioners(kw):
    top, jop, a64, b64 = lls_f32(cond_exp=1, m=120, n=40, seed=5)
    b, jb = f32(b64)
    bad = {"damp": {"damp": 0.5},
           "M": {"M": DiagonalOperator(torch.ones(120), device=DEV)},
           "N": {"N": DiagonalOperator(torch.ones(40), device=DEV)},
           "M array": {"M": np.ones(120, np.float32)}}[kw]
    with pytest.raises(ValueError, match="refined_lls does not support"):
        PS.refined_lls(PS.lsqr, top, b, **bad)
    jbad = {"damp": {"damp": 0.5},
            "M": {"M": JDiagonalOperator(jnp.ones(120))},
            "N": {"N": JDiagonalOperator(jnp.ones(40))},
            "M array": {"M": np.ones(120, np.float32)}}[kw]
    with pytest.raises(ValueError, match="refined_lls does not support"):
        JS.refined_lls(JS.lsqr, jop, jb, **jbad)
    # the harmless defaults pass through
    res = PS.refined_lls(PS.lsqr, top, b, damp=0.0, M=None, N=None,
                         max_legs=5)
    assert np.isfinite(float(res.resid_norm))


def test_solve_verified_rectangular_routes_to_refined_lls():
    top, jop, a64, b64 = lls_f32(cond_exp=2, m=300, n=100, seed=9)
    b, jb = f32(b64)
    t = pt.solve(top, b, verified=True, atol=1e-4, max_legs=10)
    j = jax_solve(jop, jb, verified=True, atol=1e-4, max_legs=10)
    assert set(t.info) == set(j.info)
    same_contract(t, j)
    for r in (t, j):
        assert true_test2(a64, b64, r) < 5e-3


def test_refined_lls_atol_stop_without_leg_anorm():
    # a leg solver exposing no Anorm: the verified lower bound
    # ||A'rt||/||rt|| keeps the atol stop armed
    top, jop, a64, b64 = lls_f32(cond_exp=1, seed=11)
    b, jb = f32(b64)

    def bare(mod):
        def lsqr(A, rhs, atol=0.0, btol=0.0, **kw):
            return dataclasses.replace(
                mod.lsqr(A, rhs, atol=atol, btol=btol, **kw), info={})
        return lsqr

    t = PS.refined_lls(bare(PS), top, b, atol=1e-4, max_legs=10)
    j = JS.refined_lls(bare(JS), jop, jb, atol=1e-4, max_legs=10)
    same_contract(t, j)
    assert bool(t.converged) and t.info["n_legs"] < 10


def test_refined_lls_inf_leg_anorm_cannot_fake_convergence():
    top, jop, a64, b64 = lls_f32(cond_exp=2, m=120, n=40, seed=6)
    b, jb = f32(b64)

    def exploding_t(A, rhs, atol=0.0, btol=0.0, **kw):
        return SolveResult(
            x=torch.full((A.shape[1],), float("nan")),
            converged=torch.tensor(False), istop=torch.tensor(7),
            n_iter=torch.tensor(1), n_matvec=torch.tensor(2),
            resid_norm=torch.tensor(float("inf")),
            resid_norm0=torch.tensor(1.0), resid_history=torch.ones(1),
            info={"Anorm": torch.tensor(float("inf"))})

    def exploding_j(A, rhs, atol=0.0, btol=0.0, **kw):
        return JSolveResult(
            x=jnp.full(A.shape[1], jnp.nan, jnp.float32),
            converged=jnp.asarray(False), istop=jnp.asarray(7, jnp.int32),
            n_iter=jnp.asarray(1, jnp.int32),
            n_matvec=jnp.asarray(2, jnp.int32),
            resid_norm=jnp.asarray(jnp.inf), resid_norm0=jnp.asarray(1.0),
            resid_history=jnp.ones(1), info={"Anorm": jnp.asarray(jnp.inf)})

    t = PS.refined_lls(exploding_t, top, b, atol=1e-4, max_legs=5)
    j = JS.refined_lls(exploding_j, jop, jb, atol=1e-4, max_legs=5)
    for r in (t, j):
        assert not bool(r.converged) and int(r.istop) == 2
        assert np.isfinite(float(r.info["anorm"]))
    assert float(t.info["anorm"]) == pytest.approx(float(j.info["anorm"]),
                                                   rel=1e-5)


def test_refined_lls_initial_matvec_count_is_exact():
    # x0=None costs one transpose product (A'b); each leg adds its own
    # count and the verification (one compensated forward product, the
    # dense storage's, and one transpose)
    top, jop, a64, b64 = lls_f32(cond_exp=1, m=120, n=40, seed=8)
    b, jb = f32(b64)
    t = PS.refined_lls(PS.lsqr, top, b, max_legs=4)
    j = JS.refined_lls(JS.lsqr, jop, jb, max_legs=4)
    for r in (t, j):
        inner = int(np.sum(np.asarray(r.info["inner_n_iter"]))) * 2
        assert int(r.n_matvec) == 1 + inner + 2 * int(r.info["n_legs"])
    same_contract(t, j)


# --------------------------------------------------------------------------
# refined_solve_batched
# --------------------------------------------------------------------------

def ginibre(n, shift, seed):
    rng = np.random.default_rng(seed)
    a32 = (rng.standard_normal((n, n)) * 0.1
           + shift * np.eye(n)).astype(np.float32)
    return a32, a32.astype(np.float64), rng


def block_true_rel(a64, B64, res):
    X = full_x(res)
    return (np.linalg.norm(a64 @ X - B64, axis=0)
            / np.maximum(np.linalg.norm(B64, axis=0), 1e-300))


def test_refined_solve_batched_general_f32_per_column():
    a32, a64, rng = ginibre(300, 4.0, 70)
    top, jop = dense_pair(a32)
    B64 = np.stack([a64 @ rng.standard_normal(300) for _ in range(4)], 1)
    B64 = B64.astype(np.float32).astype(np.float64)
    opts = dict(rtol=1e-6, atol=0.0, max_legs=20)
    t = PS.refined_solve_batched(PS.bicgstab_batched, top,
                                 torch.from_numpy(B64.astype(np.float32)),
                                 **opts)
    j = JS.refined_solve_batched(JS.bicgstab_batched, jop,
                                 jnp.asarray(B64, jnp.float32), **opts)
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    assert abs(t.info["n_legs"] - j.info["n_legs"]) <= 1
    for r in (t, j):
        assert bool(np.all(np.asarray(r.converged)))
        rel = block_true_rel(a64, B64, r)
        assert (rel < 2.5e-6).all(), rel
        reported = np.asarray(r.resid_norm) / np.linalg.norm(B64, axis=0)
        assert np.all(np.abs(reported - rel) <= 0.05 * np.maximum(rel,
                                                                  1e-12))
        h = np.asarray(r.resid_history)
        assert h.shape == (r.info["n_legs"] + 1, 4)
        assert np.all(h[0] == np.asarray(r.resid_norm0))
    assert t.info["n_legs"] >= 2


def test_refined_solve_batched_front_door_and_mixed_columns():
    a32, a64, rng = ginibre(200, 3.0, 71)
    top, jop = dense_pair(a32)
    B64 = np.stack([np.zeros(200), a64 @ np.ones(200),
                    a64 @ rng.standard_normal(200)], 1)
    B64 = B64.astype(np.float32).astype(np.float64)
    opts = dict(verified=True, rtol=1e-6, atol=0.0, max_legs=20)
    t = pt.solve(top, torch.from_numpy(B64.astype(np.float32)), **opts)
    j = jax_solve(jop, jnp.asarray(B64, jnp.float32), **opts)
    assert set(t.info) == set(j.info)
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    for r in (t, j):
        assert bool(np.all(np.asarray(r.converged)))
        np.testing.assert_array_equal(full_x(r)[:, 0], 0.0)
        assert (block_true_rel(a64, B64, r)[1:] < 2.5e-6).all()


def test_refined_solve_batched_slow_but_converging_is_converged():
    a32, a64, rng = ginibre(150, 4.0, 80)
    top, jop = dense_pair(a32)
    B64 = np.stack([a64 @ rng.standard_normal(150) for _ in range(2)], 1)
    B32 = B64.astype(np.float32)
    B64 = B32.astype(np.float64)
    # every leg counts as slow, yet convergence is promoted to istop 0
    opts = dict(rtol=1e-6, atol=0.0, max_legs=20, stall_factor=1.0 - 1e-12)
    t = PS.refined_solve_batched(PS.bicgstab_batched, top,
                                 torch.from_numpy(B32), **opts)
    j = JS.refined_solve_batched(JS.bicgstab_batched, jop,
                                 jnp.asarray(B32), **opts)
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    assert bool(t.converged.all())
    # x0 is the verified outer accumulator
    X0 = (np.linalg.solve(a64, B64) + 1e-9).astype(np.float32)
    opts.pop("stall_factor")
    t2 = PS.refined_solve_batched(PS.bicgstab_batched, top,
                                  torch.from_numpy(B32),
                                  x0=torch.from_numpy(X0), **opts)
    j2 = JS.refined_solve_batched(JS.bicgstab_batched, jop,
                                  jnp.asarray(B32), x0=jnp.asarray(X0),
                                  **opts)
    for r in (t2, j2):
        assert bool(np.all(np.asarray(r.converged)))
        r0 = np.asarray(r.resid_norm0)
        assert np.all(r0 < 1e-5)
        assert np.all(np.asarray(r.resid_norm) <= 1e-6 * r0 * (1 + 1e-6))
        assert r.info["n_legs"] <= 6


@pytest.mark.parametrize("method", ["bicgstab", "cgs", "tfqmr"])
def test_verified_blocks_explicit_tf_method(method):
    # an explicit transpose-free method on a symmetric operator goes
    # through block refinement with that method's twin
    a = np.diag(np.linspace(1.0, 10.0, 80)).astype(np.float32)
    top, jop = dense_pair(a, sym=True)
    B = (a.astype(np.float64) @ np.ones((80, 2))).astype(np.float32)
    t = pt.solve(top, torch.from_numpy(B), verified=True, method=method,
                 rtol=1e-6)
    j = jax_solve(jop, jnp.asarray(B), verified=True, method=method,
                  rtol=1e-6)
    assert set(t.info) == set(j.info) and "n_legs" in t.info
    np.testing.assert_array_equal(t.istop.numpy(), np.asarray(j.istop))
    assert bool(t.converged.all())
