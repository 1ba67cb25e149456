"""The port's batched MINRES and SYMMLQ against the JAX package's.

The same f64 inputs, made with NumPy from a seed, go through
``pykrylov_tpu.solvers.{minres,symmlq}_batched`` and the port's twins on
the CPU, and each port column also through the port's own single-RHS
solver, at the tolerances of ``tests/test_torch_batched_nonsym.py``
(:func:`match_jax`): ``istop`` and ``converged`` exact, the ``info`` keys
the same, per-column counts within 10%, x within 1e-8 relative, the
histories within 1e-8 where finite and NaN after each column's stop.

The systems have a gapped spectrum and converge well before n
iterations; the direct-error window (``etol``) is off where a test holds
x, since its stopping iteration is rounding-sensitive.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu import solve as jax_solve
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu import solvers as JS

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator

from test_torch_batched_nonsym import counts, match_jax, match_single

DEV = "cpu"  # the port's entry points default to the card
NAMES = ("minres", "symmlq")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sym(lam, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))
    return (Q * lam) @ Q.T


def indefinite(n=300, seed=5):
    """Eigenvalues in [20, 40] and [-40, -20]: a gapped indefinite
    spectrum (about 50 iterations to 1e-10, far below n)."""
    return sym(np.concatenate([np.linspace(20, 40, n - n // 4),
                               -np.linspace(20, 40, n // 4)]), seed)


def run_both(name, a, B, M=None, **opts):
    """The port's and the JAX package's batched solver on the dense
    symmetric ``a`` (``M``: the diagonal of a preconditioner)."""
    popts, jopts = dict(opts), dict(opts)
    if M is not None:
        popts["M"] = DiagonalOperator(M, device=DEV)
        jopts["M"] = JDiagonalOperator(jnp.asarray(M))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    res = getattr(PS, name + "_batched")(A, torch.from_numpy(B), **popts)
    jres = getattr(JS, name + "_batched")(
        linop_from_ndarray(jnp.asarray(a), symmetric=True), jnp.asarray(B),
        **jopts)
    return A, popts, res, jres


def rtol_opts(name, rtol):
    # MINRES: the direct-error window off (etol 0), so the test on rtol
    # decides the stop
    return dict(rtol=rtol, etol=0.0) if name == "minres" else dict(rtol=rtol)


@pytest.mark.parametrize("name", NAMES)
def test_indefinite_columns_match_jax_and_single(name):
    a = indefinite()
    n = a.shape[0]
    rng = np.random.default_rng(6)
    B = np.stack([a @ np.ones(n), 1e3 * rng.standard_normal(n),
                  rng.standard_normal(n), a @ rng.standard_normal(n)],
                 axis=1)
    opts = rtol_opts(name, 1e-10)
    A, popts, res, jres = run_both(name, a, B, store_history=True, **opts)
    match_jax(res, jres)
    assert bool(res.converged.all())
    assert res.resid_history.shape == jres.resid_history.shape
    for j in range(4):
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), **opts)
        match_single(res, one, j)
    np.testing.assert_allclose(res.x[:, 0].numpy(), np.ones(n), rtol=1e-7)
    if name == "minres":
        assert int(res.n_iter) == int(counts(res).max())
        assert int(res.n_matvec) == int(res.n_iter)
        for key in ("Anorm", "Acond", "Arnorm", "ynorm"):
            np.testing.assert_allclose(res.info[key].numpy(),
                                       np.asarray(jres.info[key]),
                                       rtol=1e-8)
    else:
        # one product before the loop, one an iteration, one after
        assert int(res.n_matvec) == int(counts(res).max())


@pytest.mark.parametrize("name", NAMES)
def test_preconditioned_and_shifted_columns_match_jax(name):
    rng = np.random.default_rng(9)
    n = 200
    q = 0.2 * rng.standard_normal((n, n))
    a = q @ q.T + np.diag(np.linspace(1, 50, n))
    shift = -2.5                    # (A - shift I) stays SPD
    d = 1.0 / np.diag(a)
    B = np.stack([(a - shift * np.eye(n)) @ np.ones(n),
                  rng.standard_normal(n)], axis=1)
    opts = rtol_opts(name, 1e-10)
    A, popts, res, jres = run_both(name, a, B, M=d, shift=shift,
                                   store_history=True, **opts)
    match_jax(res, jres)
    assert bool(res.converged.all())
    for j in range(2):
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), M=popts["M"],
                                shift=shift, **opts)
        match_single(res, one, j)
    np.testing.assert_allclose(res.x[:, 0].numpy(), np.ones(n), rtol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_zero_column_and_freeze(name):
    a = indefinite(n=120, seed=11)
    n = a.shape[0]
    B = np.stack([np.zeros(n), a @ np.ones(n),
                  np.random.default_rng(12).standard_normal(n)], axis=1)
    _, _, res, jres = run_both(name, a, B, store_history=True,
                               **rtol_opts(name, 1e-10))
    match_jax(res, jres)
    assert int(res.istop[0]) == 0 and bool(res.converged[0])
    assert not res.x[:, 0].any() and float(res.resid_norm[0]) == 0.0
    assert int(counts(res)[0]) == 0
    assert not bool(res.info["active_at_exit"].any())


def test_minres_indefinite_preconditioner_istop_9_and_6():
    # istop 9: b'Mb < 0 at entry; istop 6: a later Lanczos step meets
    # beta^2 < 0 under the same indefinite M; the healthy column (M = I on
    # its support) runs on
    n = 40
    a = sym(np.linspace(1, 10, n), 13)
    Md = np.concatenate([np.ones(20), -np.ones(20)])
    rng = np.random.default_rng(14)
    B = np.stack([np.r_[np.zeros(20), np.ones(20)],
                  np.r_[np.ones(20), 0.1 * rng.standard_normal(20)]],
                 axis=1)
    _, _, res, jres = run_both("minres", a, B, M=Md, rtol=1e-10)
    match_jax(res, jres)
    assert res.istop.tolist() == [9, 6]
    assert res.converged.tolist() == [False, False]
    assert int(counts(res)[0]) == 0 and int(counts(res)[1]) >= 1
    assert PS.ISTOP_MSGS["minres_batched"] is PS.ISTOP_MSGS["minres"]


def test_symmlq_indefinite_preconditioner_istop_8():
    n = 40
    a = sym(np.linspace(1, 10, n), 13)
    Md = np.concatenate([np.ones(20), -np.ones(20)])
    B = np.stack([np.r_[np.zeros(20), np.ones(20)],
                  np.r_[np.ones(20), np.zeros(20)]], axis=1)
    _, _, res, jres = run_both("symmlq", a, B, M=Md, rtol=1e-10)
    match_jax(res, jres)
    assert int(res.istop[0]) == 8


@pytest.mark.parametrize("name", NAMES)
def test_eigenvector_rhs_stops_at_once(name):
    # b an eigenvector of A: istop -1 freezes the column at once
    n = 64
    B = np.random.default_rng(60).standard_normal((n, 3))
    _, _, res, jres = run_both(name, 2.0 * np.eye(n), B, rtol=1e-10)
    match_jax(res, jres)
    assert res.istop.tolist() == [-1, -1, -1]
    np.testing.assert_allclose(res.x.numpy(), B / 2.0, rtol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_caps_report_their_codes(name):
    a = indefinite(n=200, seed=15)
    B = np.random.default_rng(16).standard_normal((200, 2))
    cap = dict(itnlim=5) if name == "minres" else dict(matvec_max=5)
    _, _, res, jres = run_both(name, a, B, rtol=1e-14, **cap)
    match_jax(res, jres)
    # MINRES: istop 6 at itnlim; SYMMLQ: the matvec budget, istop 5
    assert res.istop.tolist() == ([6, 6] if name == "minres" else [5, 5])


def test_minres_batched_mode_option_guards():
    A = MatrixOperator(sym(np.linspace(1, 10, 30), 61), symmetric=True,
                       device=DEV)
    B = torch.ones(30, 2, dtype=torch.float64)
    # replace_every (item 15) is ported: the verified mode runs
    ver = PS.minres_batched(A, B, replace_every=10, rtol=1e-8)
    assert "x_lo" in ver.info and bool(ver.converged.all())
    with pytest.raises(ValueError, match="store_history"):
        PS.minres_batched(A, B, replace_every=10, store_history=True)
    with pytest.raises(ValueError, match="etol"):
        PS.minres_batched(A, B, replace_every=10, etol=1e-8)
    with pytest.raises(ValueError, match="atol"):
        PS.minres_batched(A, B, atol=1e-8)
    # replace_every=0 is the plain mode, as in the JAX package
    r0 = PS.minres_batched(A, B, rtol=1e-10)
    r1 = PS.minres_batched(A, B, rtol=1e-10, replace_every=0)
    assert torch.equal(r0.x, r1.x)
    # the verified block route with method="minres" is ff minres_batched
    # (replace_every 50, rtol 1e-6 unless given), the JAX package's route
    res = pt.solve(A, B, method="minres", verified=True)
    jA = linop_from_ndarray(jnp.asarray(sym(np.linspace(1, 10, 30), 61)),
                            symmetric=True)
    jres = jax_solve(jA, jnp.ones((30, 2)), method="minres", verified=True)
    assert set(res.info) == set(jres.info)
    np.testing.assert_array_equal(res.istop.numpy(), np.asarray(jres.istop))
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10, atol=1e-12)
    assert torch.equal(res.x, PS.minres_batched(A, B, rtol=1e-6,
                                                replace_every=50).x)


@pytest.mark.parametrize("name", NAMES)
def test_front_door_routes_to_the_twin(name):
    a = indefinite(n=150, seed=17)
    Xs = np.random.default_rng(18).standard_normal((150, 3))
    A = MatrixOperator(a, symmetric=True, device=DEV)
    B = torch.from_numpy(a @ Xs)
    opts = rtol_opts(name, 1e-10)
    res = pt.solve(A, B, method=name, **opts)
    direct = getattr(PS, name + "_batched")(A, B, **opts)
    assert torch.equal(res.x, direct.x)
    np.testing.assert_allclose(res.x.numpy(), Xs, rtol=1e-6, atol=1e-8)
    jres = jax_solve(linop_from_ndarray(jnp.asarray(a), symmetric=True),
                     jnp.asarray(a @ Xs), method=name, **opts)
    match_jax(res, jres)
