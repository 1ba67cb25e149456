"""The port's batched BiCGSTAB, CGS and TFQMR against the JAX package's.

The same f64 inputs, made with NumPy from a seed, go through
``pykrylov_tpu.solvers.{bicgstab,cgs,tfqmr}_batched`` and the port's twins
on the CPU, and each port column also through the port's own single-RHS
solver.  Both packages run the same recurrence with per-column (K,)
scalars; only the reduction order of the dots differs, so
(:func:`match_jax`):

  * ``istop`` and ``converged`` agree exactly, and the ``info`` keys;
  * per-column counts (``n_iter_columns``, else ``n_matvec_columns``)
    agree within 10% (``COUNT_RTOL``);
  * every column's ``x`` agrees within ``X_RTOL`` = 1e-8 relative (max
    norm);
  * the histories agree within ``X_RTOL`` relative, or ``X_RTOL`` times
    the column's initial residual (the late residuals of BiCGSTAB and CGS
    are rounding noise of that size), where both are finite, and each is
    NaN exactly after its column's own stop (rows 1..count finite; the
    same places where the counts agree).

The systems converge well before n iterations (a gapped spectrum), where
the two packages do not part on rounding noise.  The exception is the
reference's bmark protocol on jpwh_991: its guess ``1 + arange(n)`` leaves
a residual ~1e3 times b's, of which rtol 1e-8 pins x only to ~1e-5, and
trajectories part at that level (the port's block and single solves as
much as the two packages).  There, as ``tests/test_batched.py`` does, each
column's true residual is held within 10 times the JAX package's (and the
single solve's) instead of x and the history's values.  complex64 runs the f32
recurrence, whose trajectories part at its own rounding: there the test
runs at rtol 1e-3 and holds x to 1e-3, the answers' own accuracy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu import solvers as JS

from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.ops.base import ShapeError
from pykrylov_tpu_torch.sparse import operator_from_coo

DEV = "cpu"  # the port's entry points default to the card
COUNT_RTOL = 0.1
X_RTOL = 1e-8
NAMES = ("bicgstab", "cgs", "tfqmr")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port = np.asarray(port)
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 0.0
    return np.abs(port - ref).max() / (scale if scale else 1.0)


def counts(res):
    key = ("n_iter_columns" if "n_iter_columns" in res.info
           else "n_matvec_columns")
    return np.asarray(res.info[key])


def match_jax(res, jres, x_rtol=X_RTOL, resid_of=None):
    """The port's batched result against the JAX package's, at the
    module's tolerances; with ``resid_of`` (x -> true residual norms per
    column), the true residuals within 10 times the JAX package's instead
    of x and the history's values."""
    assert set(res.info) == set(jres.info)
    np.testing.assert_array_equal(res.istop.numpy(), np.asarray(jres.istop))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(jres.converged))
    it, jit = counts(res), counts(jres)
    assert np.all(np.abs(it - jit) <= np.ceil(COUNT_RTOL * jit)), (it, jit)
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert x.shape == jx.shape and x.dtype == jx.dtype
    if resid_of is not None:
        r, jr = resid_of(x), resid_of(jx)
        assert np.all(r <= 10 * np.maximum(jr, 1e-10)), (r, jr)
    else:
        for j in range(x.shape[1]):
            assert rel(x[:, j], jx[:, j]) <= x_rtol, (j, rel(x[:, j],
                                                              jx[:, j]))
    if jres.resid_history is not None:
        h, jh = res.resid_history.numpy(), np.asarray(jres.resid_history)
        assert h.shape == jh.shape
        for hist, cnt in ((h, it), (jh, jit)):
            if "n_iter_columns" not in res.info:
                cnt = hist_rows(hist)
            for j, c in enumerate(cnt):
                assert not np.isnan(hist[:c + 1, j]).any()
                assert np.isnan(hist[c + 1:, j]).all()
        fin = ~np.isnan(h) & ~np.isnan(jh)
        tol = X_RTOL * np.abs(jh) + X_RTOL * np.abs(jh[:1])
        assert resid_of is not None or np.all(np.abs(h - jh)[fin]
                                              <= tol[fin])


def hist_rows(hist):
    """The last finite row of each history column: its block iterations
    (the matvec counts of the transpose-free solvers are not rows)."""
    fin = ~np.isnan(hist)
    return [int(np.flatnonzero(fin[:, j]).max()) for j in range(hist.shape[1])]


def match_single(res, single, j, x_rtol=X_RTOL, resid_of=None):
    """Column ``j`` of a port batched result against the port's single-RHS
    solve of that column (with ``resid_of``, as :func:`match_jax`)."""
    assert int(res.istop[j]) == int(single.istop)
    assert bool(res.converged[j]) == bool(single.converged)
    c, s = int(counts(res)[j]), int(
        single.n_iter if "n_iter_columns" in res.info else single.n_matvec)
    assert abs(c - s) <= np.ceil(COUNT_RTOL * s), (j, c, s)
    x, ref = res.x[:, j].numpy(), single.x.numpy()
    if resid_of is not None:
        r, rs = resid_of(x[:, None]), resid_of(ref[:, None])
        assert r[0] <= 10 * max(rs[0], 1e-10), (j, r, rs)
    else:
        assert rel(x, ref) <= x_rtol, (j, rel(x, ref))


def jpwh():
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    return a, (vals, rows, cols, shape)


def unsym(n=240, seed=0):
    """Eigenvalues in [1, 10] with a small nonnormal part: converges in a
    few dozen iterations, far from Krylov exhaustion."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Q * np.linspace(1, 10, n)) @ Q.T
            + 0.5 * np.triu(rng.standard_normal((n, n)), 1) / np.sqrt(n))


def run_both(name, a, B, **opts):
    """The port's and the JAX package's batched solver on the dense ``a``;
    ``opts`` may hold NumPy ``x0`` and a diagonal ``M`` (as its diagonal)."""
    popts, jopts = dict(opts), dict(opts)
    if "x0" in opts:
        popts["x0"] = torch.from_numpy(opts["x0"])
        jopts["x0"] = jnp.asarray(opts["x0"])
    if "M" in opts:
        popts["M"] = DiagonalOperator(opts["M"], device=DEV)
        jopts["M"] = JDiagonalOperator(jnp.asarray(opts["M"]))
    A = MatrixOperator(a, device=DEV)
    res = getattr(PS, name + "_batched")(A, torch.from_numpy(B), **popts)
    jres = getattr(JS, name + "_batched")(linop_from_ndarray(jnp.asarray(a)),
                                          jnp.asarray(B), **jopts)
    return A, popts, res, jres


@pytest.mark.parametrize("name", NAMES)
def test_jpwh_bmark_protocol_matches_jax_and_single(name):
    # the reference bmark trio's protocol (rtol 1e-8, x0 = 1 + arange(n),
    # matvec_max = 2n) on three columns, as tests/test_batched.py runs it
    a, t = jpwh()
    n = a.shape[0]
    rng = np.random.default_rng(7)
    B = np.stack([a @ np.ones(n), a @ rng.standard_normal(n),
                  rng.standard_normal(n)], axis=1)
    x0 = np.tile(1.0 + np.arange(n, dtype=np.float64)[:, None], (1, 3))
    A, popts, res, jres = run_both(name, a, B, x0=x0, rtol=1e-8,
                                   matvec_max=2 * n, store_history=True)

    def resid_of(X):
        return np.linalg.norm(B[:, :X.shape[1]] - a @ X, axis=0)

    match_jax(res, jres, resid_of=resid_of)
    assert bool(res.converged.all()) and res.istop.dtype == torch.int32
    assert int(res.n_matvec) == int(counts(res).max())
    # the same block through the sparse operator the policy picks
    S = operator_from_coo(*t, device=DEV)
    sres = getattr(PS, name + "_batched")(S, torch.from_numpy(B),
                                          **popts)
    match_jax(sres, jres, resid_of=resid_of)
    single = getattr(PS, name)
    for j in range(3):
        one = single(A, torch.from_numpy(B[:, j]), x0=popts["x0"][:, j],
                     rtol=1e-8, matvec_max=2 * n)
        match_single(res, one, j, resid_of=lambda X, j=j: np.linalg.norm(
            B[:, j:j + 1] - a @ X, axis=0))


@pytest.mark.parametrize("name", NAMES)
def test_jacobi_preconditioned_columns_match_jax(name):
    # mixed convergence speeds exercise the freeze masks
    a, _ = jpwh()
    n = a.shape[0]
    d = 1.0 / np.maximum(np.abs(np.diag(a)), 1.0)
    rng = np.random.default_rng(8)
    B = np.stack([a @ np.ones(n), 1e3 * rng.standard_normal(n)], axis=1)
    A, popts, res, jres = run_both(name, a, B, M=d, rtol=1e-8,
                                   matvec_max=2 * n, store_history=True)
    match_jax(res, jres)
    for j in range(2):
        one = getattr(PS, name)(A, torch.from_numpy(B[:, j]), M=popts["M"],
                                rtol=1e-8, matvec_max=2 * n)
        match_single(res, one, j)


@pytest.mark.parametrize("name", NAMES)
def test_zero_column_and_active_at_exit(name):
    a = unsym()
    n = a.shape[0]
    B = np.random.default_rng(1).standard_normal((n, 3))
    B[:, 1] = 0.0
    _, _, res, jres = run_both(name, a, B, rtol=1e-10, store_history=True)
    match_jax(res, jres)
    assert int(res.istop[1]) == 0 and int(counts(res)[1]) == 0
    assert not res.x[:, 1].any()
    assert not bool(res.info["active_at_exit"].any())
    # a cap: every nonzero column still running reports istop 1
    _, _, cap, jcap = run_both(name, a, B, rtol=1e-14, maxiter=3)
    match_jax(cap, jcap)
    assert cap.istop.tolist() == [1, 0, 1] and int(cap.n_iter) == 3
    assert cap.info["active_at_exit"].tolist() == [True, False, True]


@pytest.mark.parametrize("name", NAMES)
def test_breakdown_column_freezes_with_istop_3(name):
    # A = diag(S, D), S a 2x2 rotation block: b = e_1 has b'Ab = 0, so the
    # first shadow product (BiCGSTAB's r0'v, CGS's and TFQMR's sigma)
    # vanishes and the column stops with istop 3; the other column, on D,
    # converges
    n = 60
    rng = np.random.default_rng(3)
    a = np.zeros((n, n))
    a[:2, :2] = [[0.0, 1.0], [-1.0, 0.0]]
    a[2:, 2:] = np.eye(n - 2) + np.diag(np.full(n - 3, 0.5), 1)
    B = np.zeros((n, 2))
    B[0, 0] = 1.0
    B[2:, 1] = rng.standard_normal(n - 2)
    _, _, res, jres = run_both(name, a, B, rtol=1e-10)
    match_jax(res, jres)
    assert res.istop.tolist() == [3, 0]
    assert res.converged.tolist() == [False, True]
    assert PS.ISTOP_MSGS[name + "_batched"][3].startswith("breakdown")


@pytest.mark.parametrize("dtype,rtol,x_rtol", [
    (np.complex64, 1e-3, 1e-3), (np.complex128, 1e-5, X_RTOL)])
@pytest.mark.parametrize("name", NAMES)
def test_complex_blocks_use_unconjugated_dots(name, dtype, rtol, x_rtol):
    # the shadow dots are np.dot's, not inner products: a conjugated dot
    # would give the same answers on every real system and other ones here
    n = 80
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    a = ((Q * np.linspace(1, 4, n)) @ Q.conj().T).astype(dtype)
    B = (rng.standard_normal((n, 2))
         + 1j * rng.standard_normal((n, 2))).astype(dtype)
    _, _, res, jres = run_both(name, a, B, rtol=rtol, atol=0.0)
    match_jax(res, jres, x_rtol=x_rtol)
    assert res.x.dtype == torch.from_numpy(B).dtype
    assert bool(res.converged.all())
    r = B - a @ res.x.numpy()
    assert (np.linalg.norm(r, axis=0)
            <= 2 * rtol * np.linalg.norm(B, axis=0)).all()


@pytest.mark.parametrize("name", NAMES)
def test_x0_block_layout_and_shapes(name):
    a = unsym(n=30, seed=5)
    A = MatrixOperator(a, device=DEV)
    B = torch.from_numpy(np.random.default_rng(6).standard_normal((30, 3)))
    solver = getattr(PS, name + "_batched")
    with pytest.raises(ShapeError, match="x0"):
        solver(A, B, x0=torch.ones(3, 30, dtype=torch.float64))
    with pytest.raises(ShapeError):
        solver(A, torch.ones(31, 2, dtype=torch.float64))
    with pytest.raises(ShapeError):
        solver(MatrixOperator(np.ones((30, 20)), device=DEV),
               torch.ones(20, 2, dtype=torch.float64))
    one = solver(A, B[:, 0], x0=torch.zeros(30, dtype=torch.float64))
    assert one.x.shape == (30, 1) and bool(one.converged.all())
    # a NumPy block goes to the operator's device; the guess solves it
    xs = np.linalg.solve(a, B.numpy())
    hit = solver(A, B.numpy(), x0=xs, rtol=1e-6)
    assert bool(hit.converged.all())
    assert int(hit.n_iter) == 0 or name == "tfqmr"
