"""The port's batched LSQR, LSMR, CRAIG and CRAIG-MR against the JAX
package's, and the block products every batched solver issues.

The same f64 inputs, made with NumPy from a seed, go through
``pykrylov_tpu.solvers.{lsqr,lsmr,craig,craigmr}_batched`` and the port's
twins on the CPU, and each port column also through the port's own
single-RHS solver, at the tolerances of
``tests/test_torch_batched_nonsym.py`` (:func:`match_jax`): ``istop`` and
``converged`` exact, the ``info`` keys the same, ``n_iter_columns`` within
10%, x within 1e-8 relative, the histories within 1e-8 where finite and
NaN after each column's stop.  The problems have singular values in
[1, 2] and n well above the iteration count; the direct-error window is
off (``etol=0``) where the test on atol and btol should decide.

The sparse cases run a rectangular ``BellOperator`` (its SELL card forms'
plain products in both directions), plain and with a row split, whose
transpose rule is the ``bwd_l``/``bwd_a`` pair.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu import solvers as JS

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.ops.base import ShapeError
from pykrylov_tpu_torch.sparse import bell as TB

from test_torch_batched_nonsym import match_jax, match_single, rel
from test_torch_lls import rect

DEV = "cpu"  # the port's entry points default to the card
NAMES = ("lsqr", "lsmr", "craig", "craigmr")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_both(name, a, B, M=None, N=None, **opts):
    """The port's and the JAX package's batched solver on the dense ``a``
    (``M``, ``N``: the diagonals of the inner preconditioners)."""
    popts, jopts = dict(opts), dict(opts)
    for key, d in (("M", M), ("N", N)):
        if d is not None:
            popts[key] = DiagonalOperator(d, device=DEV)
            jopts[key] = JDiagonalOperator(jnp.asarray(d))
    A = MatrixOperator(a, device=DEV)
    res = getattr(PS, name + "_batched")(A, torch.from_numpy(B), **popts)
    jres = getattr(JS, name + "_batched")(linop_from_ndarray(jnp.asarray(a)),
                                          jnp.asarray(B), **jopts)
    return A, popts, res, jres


def opts_of(name):
    return {"lsqr": dict(atol=1e-10, btol=1e-10, etol=0.0),
            "lsmr": dict(atol=1e-10, btol=1e-10, etol=0.0),
            "craig": dict(btol=1e-12, etol=1e-10, itnlim=200),
            "craigmr": dict(etol=1e-10, itnlim=200)}[name]


def problem(name, seed=1):
    """LSQR and LSMR: an overdetermined 200 x 80 system with a consistent,
    an inconsistent and a scaled column; CRAIG and CRAIG-MR: an
    underdetermined 80 x 200 one (their SQD and least-norm problems)."""
    rng = np.random.default_rng(seed)
    if name.startswith("ls"):
        a = rect(200, 80, seed=seed)
        B = np.stack([a @ np.ones(80), rng.standard_normal(200),
                      1e3 * rng.standard_normal(200)], axis=1)
    else:
        a = rect(80, 200, seed=seed)
        B = np.stack([a @ rng.standard_normal(200) for _ in range(3)],
                     axis=1)
        B[:, 2] *= 1e3
    return a, B


@pytest.mark.parametrize("name", NAMES)
def test_columns_match_jax_and_single(name):
    a, B = problem(name)
    opts = opts_of(name)
    A, _, res, jres = run_both(name, a, B, store_history=True, **opts)
    match_jax(res, jres)
    assert bool(res.converged.all())
    assert int(res.n_iter) == int(res.info["n_iter_columns"].max())
    assert int(res.n_matvec) == 2 * int(res.n_iter)
    for j in range(B.shape[1]):
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), **opts)
        match_single(res, one, j)
    if name == "lsqr" or name == "lsmr":
        for j in range(B.shape[1]):
            x_ref = np.linalg.lstsq(a, B[:, j], rcond=None)[0]
            assert rel(res.x[:, j].numpy(), x_ref) <= 1e-8
    elif name == "craig":
        # the SQD certificates per column (M = N = I): b - Ax = r, A'r = x
        x, r = res.x.numpy(), res.info["r"].numpy()
        assert res.info["r"].shape == (80, 3)
        bn = np.linalg.norm(B, axis=0)
        assert np.all(np.linalg.norm(B - a @ x - r, axis=0) < 1e-8 * bn)
        assert np.all(np.linalg.norm(a.T @ r - x, axis=0) < 1e-8 * bn)
    else:
        y = res.x.numpy()          # the dual block: (AA' + I) y = b
        assert y.shape == (80, 3)
        assert np.all(np.linalg.norm(a @ (a.T @ y) + y - B, axis=0)
                      < 1e-8 * np.linalg.norm(B, axis=0))


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_damped_columns_match_jax_and_tikhonov(name):
    a = rect(150, 60, seed=2)
    B = np.random.default_rng(3).standard_normal((150, 3))
    damp = 0.7
    A, _, res, jres = run_both(name, a, B, damp=damp, store_history=True,
                               **opts_of(name))
    match_jax(res, jres)
    H = a.T @ a + damp ** 2 * np.eye(60)
    for j in range(3):
        x_ref = np.linalg.solve(H, a.T @ B[:, j])
        assert rel(res.x[:, j].numpy(), x_ref) <= 1e-8
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), damp=damp,
                                **opts_of(name))
        match_single(res, one, j)


@pytest.mark.parametrize("name", NAMES)
def test_sqd_preconditioned_columns_match_jax(name):
    a, B = problem(name, seed=6)
    m, n = a.shape
    Md = 1.0 / np.linspace(1, 3, m)
    Nd = 1.0 / np.linspace(1, 2, n)
    opts = opts_of(name)
    A, popts, res, jres = run_both(name, a, B, M=Md, N=Nd,
                                   store_history=True, **opts)
    match_jax(res, jres)
    for j in range(B.shape[1]):
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), M=popts["M"],
                                N=popts["N"], **opts)
        match_single(res, one, j)


@pytest.mark.parametrize("name", NAMES)
def test_zero_column_stops_at_once(name):
    a, B = problem(name, seed=4)
    B[:, 1] = 0.0
    _, _, res, jres = run_both(name, a, B, store_history=True,
                               **opts_of(name))
    match_jax(res, jres)
    assert int(res.istop[1]) == 0 and bool(res.converged[1])
    assert int(res.info["n_iter_columns"][1]) == 0
    assert not res.x[:, 1].any()
    if name == "craig":
        assert not res.info["r"][:, 1].any()


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_caps_and_windows_match_jax(name):
    # the direct-error window stops first (istop 8) and an iteration cap
    # (istop 7)
    a, B = problem(name, seed=8)
    _, _, res, jres = run_both(name, a, B, atol=1e-14, btol=1e-14,
                               store_history=True)
    match_jax(res, jres)
    assert (res.istop == 8).all()
    _, _, cap, jcap = run_both(name, a, B, itnlim=4)
    match_jax(cap, jcap)
    assert cap.istop.tolist() == [7, 7, 7]


def test_lsqr_batched_promotes_preconditioner_dtype():
    # an f64 preconditioner on an f32 system promotes the block (the JAX
    # package's test_lsqr_batched_promotes_preconditioner_dtype)
    a = rect(80, 30, seed=12).astype(np.float32)
    B = np.random.default_rng(13).standard_normal((80, 2)).astype(np.float32)
    M = DiagonalOperator(np.ones(80), device=DEV)
    res = PS.lsqr_batched(MatrixOperator(a, device=DEV),
                          torch.from_numpy(B), M=M, atol=1e-8, btol=1e-8)
    jres = JS.lsqr_batched(linop_from_ndarray(jnp.asarray(a)),
                           jnp.asarray(B),
                           M=JDiagonalOperator(jnp.asarray(np.ones(80))),
                           atol=1e-8, btol=1e-8)
    assert res.x.dtype == torch.float64 and jres.x.dtype == jnp.float64
    assert bool(res.converged.all())
    match_jax(res, jres)


def _rect_with_heavy_rows(m=1200, n=400, heavy=8, seed=21):
    """m x n: three entries a row at random, a diagonal of 4 on the first
    n rows, and ``heavy`` rows of 150 small entries, which the policy
    splits into private blocks."""
    rng = np.random.default_rng(seed)
    hr = rng.choice(m, heavy, replace=False)
    rows = np.concatenate([rng.integers(0, m, 3 * m), np.arange(n),
                           np.repeat(hr, 150)])
    cols = np.concatenate([rng.integers(0, n, 3 * m), np.arange(n),
                           rng.integers(0, n, 150 * heavy)])
    vals = np.concatenate([rng.standard_normal(3 * m), np.full(n, 4.0),
                           0.05 * rng.standard_normal(150 * heavy)])
    a = np.zeros((m, n))
    np.add.at(a, (rows, cols), vals)
    rr, cc = np.nonzero(a)
    return a, (a[rr, cc], rr, cc, (m, n))


@pytest.mark.parametrize("split", [False, True])
def test_lsqr_block_on_a_rectangular_bell_operator(split):
    # the block rules of a rectangular BellOperator in both directions:
    # the "fwd" and "bwd" card forms, or with a row split the folded
    # forward rule and the bwd_l/bwd_a transpose pair
    a, t = _rect_with_heavy_rows()
    A = TB.bell_operator(t, split_rows="auto" if split else 0, device=DEV)
    assert (A.split_rows > 0) == split and A._rmm is not None
    assert set(A.cards) == ({"fwd", "bwd_l", "bwd_a"} if split
                            else {"fwd", "bwd"})
    B = np.random.default_rng(22).standard_normal((1200, 3))
    opts = opts_of("lsqr")
    res = pt.solve(A, torch.from_numpy(B), **opts)     # the rectangular route
    jres = JS.lsqr_batched(linop_from_ndarray(jnp.asarray(a)),
                           jnp.asarray(B), **opts)
    match_jax(res, jres)
    assert bool(res.converged.all())
    for j in range(3):
        x_ref = np.linalg.lstsq(a, B[:, j], rcond=None)[0]
        assert rel(res.x[:, j].numpy(), x_ref) <= 1e-8


def test_lls_shapes():
    A = MatrixOperator(rect(30, 10), device=DEV)
    for name in NAMES:
        solver = getattr(PS, name + "_batched")
        with pytest.raises(ShapeError):
            solver(A, torch.ones(10, 2, dtype=torch.float64))
        one = solver(A, torch.ones(30, dtype=torch.float64))
        assert one.x.shape == ((30, 1) if name == "craigmr" else (10, 1))


def counted(a):
    """A dense operator whose block rules count their calls in ``calls``
    (its 1-D rules raise: a batched solve applies only block rules)."""
    calls = {"A": 0, "A^T": 0}
    t = torch.from_numpy(a)

    def mm(X):
        calls["A"] += 1
        return t @ X

    def rmm(X):
        calls["A^T"] += 1
        return t.T @ X

    def no_mv(x):
        raise AssertionError("a 1-D product in a batched solve")

    def no_rmv(x):
        raise AssertionError("a 1-D product in a batched solve")

    op = pt.LinearOperator(a.shape[1], a.shape[0], matvec=no_mv,
                           matvec_transp=no_rmv, dtype=t.dtype,
                           device=DEV, matmat=mm, matmat_transp=rmm)
    return op, calls


# block products of A (and A^T) a solve issues, as functions of the block
# iterations k: fixed per solver, whatever the columns' states
PRODUCTS = {
    "cg": lambda k: (k, 0),
    "bicgstab": lambda k: (2 * k, 0),
    "cgs": lambda k: (2 * k, 0),
    "tfqmr": lambda k: (2 * k + 1, 0),
    "minres": lambda k: (k, 0),
    "symmlq": lambda k: (k + 2, 0),
    "lsqr": lambda k: (k, k + 1),
    "lsmr": lambda k: (k, k + 1),
    "craig": lambda k: (k, k + 1),
    "craigmr": lambda k: (k, k + 1),
}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_block_products_per_iteration(name):
    # the products a batched solve issues do not depend on which columns
    # are still active (the card's smoke counts kernel launches by these)
    if name in ("lsqr", "lsmr", "craig", "craigmr"):
        a, B = problem(name, seed=30)
        B[:, 1] = 0.0
    else:
        a = rect(120, 120, lo=2.0, hi=4.0, seed=30)
        a = a @ a.T if name in ("cg", "minres", "symmlq") else a
        rng = np.random.default_rng(31)
        B = np.stack([a @ np.ones(120), np.zeros(120),
                      1e3 * rng.standard_normal(120)], axis=1)
    op, calls = counted(a)
    res = getattr(PS, name + "_batched")(op, torch.from_numpy(B))
    k = int(res.n_iter)
    assert k > 0 and calls == dict(zip(("A", "A^T"), PRODUCTS[name](k)))
    # the columns stopped at different iterations
    it = res.info.get("n_iter_columns", res.info.get("n_matvec_columns"))
    assert int(it[1]) == 0 and len(set(it.tolist())) > 1
