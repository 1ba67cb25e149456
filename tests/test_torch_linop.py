"""The port's operator layer against the JAX package's, on the same
matrices and vectors (the cases of tests/test_linop.py).

Both packages compute each product in float64 from the same stored
values; only the order of the BLAS summations may differ, so results are
compared to 1e-13 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
import pykrylov_tpu_torch.ops as tops
from pykrylov_tpu_torch.utils.types import as_dtype

RTOL = 1e-13
DEV = "cpu"  # the port's entry points default to the card


def same(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-14)


@pytest.fixture
def mats():
    A = np.arange(6, dtype=np.float64).reshape(2, 3) + 1
    B = np.arange(6, dtype=np.float64).reshape(3, 2) * 2 + 1
    return A, B


def both(M, **kw):
    return tops.MatrixOperator(torch.from_numpy(M), device=DEV, **kw), \
        jops.MatrixOperator(jnp.asarray(M), **kw)


@pytest.mark.parametrize("form", ["T", "H", "conj"])
def test_transpose_adjoint_conjugate_complex(form, rng):
    M = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    t, j = both(M)
    x = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    if form == "T":
        same(t.T * torch.from_numpy(x), j.T * jnp.asarray(x))
        assert t.T.T is t
    elif form == "H":
        same(t.H * torch.from_numpy(x), j.H * jnp.asarray(x))
        assert t.H.H is t
    else:
        y = rng.standard_normal(4) + 1j * rng.standard_normal(4)
        same(t.bar * torch.from_numpy(y), j.bar * jnp.asarray(y))


def test_closure_operator_infers_adjoint(rng):
    M = rng.standard_normal((2, 3)) + 1j * rng.standard_normal((2, 3))
    Mt = torch.from_numpy(M)
    t = tops.LinearOperator(3, 2, matvec=lambda x: Mt @ x,
                            matvec_transp=lambda x: Mt.T @ x,
                            dtype=torch.complex128, device=DEV)
    j = jops.LinearOperator(3, 2, matvec=lambda x: jnp.asarray(M) @ x,
                            matvec_transp=lambda x: jnp.asarray(M).T @ x,
                            dtype=np.complex128)
    y = np.array([1.0, 1j])
    same(t.H * torch.from_numpy(y), j.H * jnp.asarray(y))
    same(t.rmatvec(torch.from_numpy(y)), j.rmatvec(jnp.asarray(y)))


def test_real_H_is_T(mats):
    t, _ = both(mats[0])
    assert t.H is t.T
    s = tops.MatrixOperator(torch.eye(2, dtype=torch.float64),
                            symmetric=True, device=DEV)
    assert s.T is s


@pytest.mark.parametrize("expr", ["2.5*A", "A*2.5", "-A", "A/2", "A*0"])
def test_scalar_algebra(expr, mats):
    t, j = both(mats[0])
    x = np.array([1.0, -2.0, 0.5])
    tt, jj = eval(expr, {"A": t}), eval(expr, {"A": j})
    assert tt.dtype == as_dtype(jj.dtype)
    same(tt * torch.from_numpy(x), jj * jnp.asarray(x))
    y = np.array([3.0, -1.0])
    same(tt.T * torch.from_numpy(y), jj.T * jnp.asarray(y))
    assert isinstance(tt, tops.ZeroOperator) == isinstance(
        jj, jops.ZeroOperator)


def test_compose_and_its_transpose(mats):
    (ta, ja), (tb, jb) = both(mats[0]), both(mats[1])
    x = np.array([1.0, -2.0])
    same((ta * tb) * torch.from_numpy(x), (ja * jb) * jnp.asarray(x))
    same((ta * tb).T * torch.from_numpy(x), (ja * jb).T * jnp.asarray(x))
    same((ta @ tb) * torch.from_numpy(x), (ja @ jb) * jnp.asarray(x))


@pytest.mark.parametrize("op", ["+", "-"])
def test_add_sub(op, mats):
    ta, ja = both(mats[0])
    tc, jc = both(np.ones((2, 3)))
    x = np.array([1.0, 2.0, 3.0])
    expr = "A %s C" % op
    tt = eval(expr, {"A": ta, "C": tc})
    jj = eval(expr, {"A": ja, "C": jc})
    same(tt * torch.from_numpy(x), jj * jnp.asarray(x))
    y = np.array([1.0, -1.0])
    same(tt.T * torch.from_numpy(y), jj.T * jnp.asarray(y))


@pytest.mark.parametrize("k", [0, 1, 3])
def test_pow(k, mats):
    S = mats[0] @ mats[0].T
    t, j = both(S, symmetric=True)
    x = np.array([1.0, 2.0])
    same((t ** k) * torch.from_numpy(x), (j ** k) * jnp.asarray(x))


def test_to_array(mats, rng):
    ta, ja = both(mats[0])
    tb, jb = both(mats[1])
    d = rng.standard_normal(2)
    td = tops.DiagonalOperator(torch.from_numpy(d), device=DEV)
    jd = jops.DiagonalOperator(jnp.asarray(d))
    same((td * ta * tb + 2 * td).to_array(),
         (jd * ja * jb + 2 * jd).to_array())
    M = mats[0]
    t = tops.LinearOperator(3, 2, matvec=lambda x: torch.from_numpy(M) @ x,
                            dtype=torch.float64, device=DEV)
    same(t.to_array(), M)


def test_special_operators(rng):
    d = np.array([1.0, 4.0, 9.0])
    x = rng.standard_normal(3)
    pairs = [
        (tops.DiagonalOperator(torch.from_numpy(d), device=DEV),
         jops.DiagonalOperator(jnp.asarray(d))),
        (tops.IdentityOperator(3, dtype=torch.float64, device=DEV),
         jops.IdentityOperator(3, dtype=np.float64)),
        (tops.ZeroOperator(3, 3, dtype=torch.float64, device=DEV),
         jops.ZeroOperator(3, 3, dtype=np.float64)),
    ]
    for t, j in pairs:
        same(t * torch.from_numpy(x), j * jnp.asarray(x))
        same(t.T * torch.from_numpy(x), j.T * jnp.asarray(x))
        assert (t.symmetric, t.hermitian) == (j.symmetric, j.hermitian)
    dc = np.array([1.0 + 1j, 2.0 - 1j])
    t, j = tops.DiagonalOperator(torch.from_numpy(dc), device=DEV), \
        jops.DiagonalOperator(jnp.asarray(dc))
    assert (t.symmetric, t.hermitian) == (j.symmetric, j.hermitian)
    xc = np.array([1.0, 1j])
    same(t.H * torch.from_numpy(xc), j.H * jnp.asarray(xc))


DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.mark.parametrize("dt1", DTYPES)
@pytest.mark.parametrize("dt2", DTYPES)
def test_dtype_promotion(dt1, dt2):
    ta, ja = both(np.ones((3, 3), dtype=dt1))
    tb, jb = both(np.ones((3, 3), dtype=dt2))
    for expr in ("A + B", "A * B", "A - B"):
        tt = eval(expr, {"A": ta, "B": tb})
        jj = eval(expr, {"A": ja, "B": jb})
        assert tt.dtype == as_dtype(jj.dtype), expr


@pytest.mark.parametrize("dt", DTYPES)
def test_scalar_promotion(dt):
    t, j = both(np.ones((2, 2), dtype=dt))
    for tt, jj in ((t * 2.0, j * 2.0), (2.0 * t, 2.0 * j), (-t, -j),
                   (t * 1j, j * 1j)):
        assert tt.dtype == as_dtype(jj.dtype)


def test_shape_errors(mats):
    ta, ja = both(mats[0])
    for op, mod, kw in ((ta, tops, {"device": DEV}), (ja, jops, {})):
        with pytest.raises(mod.ShapeError):
            op * np.ones(5)
        with pytest.raises(mod.ShapeError):
            op * op
        with pytest.raises(mod.ShapeError):
            op ** 2
        with pytest.raises(mod.ShapeError):
            op + mod.MatrixOperator(np.ones((3, 2)), **kw)
        with pytest.raises(ValueError):
            op + 3
        with pytest.raises(ZeroDivisionError):
            op / 0
        with pytest.raises(ValueError):
            mod.MatrixOperator(np.ones((2, 2)), **kw) ** (-1)


def test_matvec_count_and_block_apply(mats, rng):
    ta, ja = both(mats[0])
    X = rng.standard_normal((3, 4))
    same(ta * torch.from_numpy(X), ja * jnp.asarray(X))
    ta.reset_counters()
    ta * np.ones(3)
    ta * np.ones(3)
    assert ta.nMatvec == 2


def test_aslinearoperator(mats):
    # a tensor stays on its device
    t = tops.aslinearoperator(torch.from_numpy(mats[0]))
    assert isinstance(t, tops.MatrixOperator) and t.device.type == "cpu"
    assert tops.aslinearoperator(t) is t
    with pytest.raises(ValueError):
        tops.aslinearoperator(lambda x: x)
    with pytest.raises(TypeError):
        tops.aslinearoperator("A")


# --------------------------------------------------------------------------
# the operators of ROADMAP item 3 and ops/cholesky.py
# --------------------------------------------------------------------------


def _coord(A, symmetric=False):
    """COO triples of A's nonzeros (the lower triangle when symmetric)."""
    rows, cols = np.nonzero(np.tril(A) if symmetric else A)
    return A[rows, cols], rows, cols


def test_sqrt_and_abs(rng):
    d = np.array([1.0, 4.0, 9.0])
    x = rng.standard_normal(3)
    t = tops.DiagonalOperator(d, device=DEV)
    same(tops.sqrt(t) * torch.from_numpy(x),
         jops.sqrt(jops.DiagonalOperator(d)) * jnp.asarray(x))
    same(abs(tops.DiagonalOperator(-d, device=DEV)) * torch.from_numpy(x),
         d * x)
    eye = tops.IdentityOperator(3, dtype=torch.float64, device=DEV)
    assert tops.sqrt(eye) is eye and abs(eye) is eye
    zero = tops.ZeroOperator(3, 3, dtype=torch.float64, device=DEV)
    assert tops.sqrt(zero) is zero
    with pytest.raises(ValueError):
        tops.sqrt(tops.DiagonalOperator(np.array([1.0, -1.0]), device=DEV))
    with pytest.raises(NotImplementedError):
        tops.sqrt(tops.MatrixOperator(np.eye(2), device=DEV))


def test_reduced_operators_match_jax(rng):
    A = rng.standard_normal((6, 6))
    t, j = both(A)
    rows, cols = [0, 2, 4], [1, 3, 5]
    red, jred = (tops.ReducedLinearOperator(t, rows, cols),
                 jops.ReducedLinearOperator(j, rows, cols))
    x = rng.standard_normal(3)
    same(red * torch.from_numpy(x), jred * jnp.asarray(x))
    same(red.T * torch.from_numpy(x), jred.T * jnp.asarray(x))
    same(red * torch.from_numpy(x), A[np.ix_(rows, cols)] @ x)
    S = A + A.T
    t, j = both(S, symmetric=True)
    idx = [1, 2, 5]
    sred = tops.SymmetricallyReducedLinearOperator(t, idx)
    assert sred.symmetric
    same(sred * torch.from_numpy(x),
         jops.SymmetricallyReducedLinearOperator(j, idx) * jnp.asarray(x))
    # an (n, K) block goes through the block rule, as column by column
    X = torch.from_numpy(rng.standard_normal((3, 2)))
    same(sred * X, torch.stack([sred * X[:, 0], sred * X[:, 1]], 1))


@pytest.mark.parametrize("symmetric", [False, True])
def test_coord_operator_matches_jax(symmetric, rng):
    A = rng.standard_normal((5, 5) if symmetric else (5, 4))
    if symmetric:
        A = A + A.T
    A[np.abs(A) < 0.5] = 0.0
    vals, rows, cols = _coord(A, symmetric)
    m, n = A.shape
    t = tops.CoordLinearOperator(vals, rows, cols, n, m, symmetric=symmetric,
                                 device=DEV)
    j = jops.CoordLinearOperator(vals, rows, cols, n, m, symmetric=symmetric)
    assert t.symmetric == symmetric and t.hermitian == symmetric
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    same(t * torch.from_numpy(x), j * jnp.asarray(x))
    same(t.T * torch.from_numpy(y), j.T * jnp.asarray(y))
    same(t * torch.from_numpy(x), A @ x)
    X = rng.standard_normal((n, 3))
    same(t * torch.from_numpy(X), A @ X)


def test_linop_from_ndarray(rng):
    A = rng.standard_normal((3, 4))
    op = tops.linop_from_ndarray(A, device=DEV)
    assert isinstance(op, tops.MatrixOperator)
    x = rng.standard_normal(4)
    same(op * torch.from_numpy(x), jops.linop_from_ndarray(A) * jnp.asarray(x))


def test_pysparse_adapter_solves(rng):
    # a scipy matrix (A @ x) and a pysparse-protocol object (matvec(x, y))
    # behind the adapter: products are host calls, CG solves through them
    import scipy.sparse as sp
    from pykrylov_tpu_torch.solvers import cg

    n = 30
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    op = tops.PysparseLinearOperator(A, device=DEV)
    x = rng.standard_normal(n)
    same(op * torch.from_numpy(x), A @ x)
    same(op.T * torch.from_numpy(x), A.T @ x)

    class Pysparse:
        shape, dtype, issym = (n, n), np.float64, True

        def matvec(self, x, y):
            y[:] = A @ x

    pop = tops.PysparseLinearOperator(Pysparse(), device=DEV)
    assert pop.symmetric
    res = cg(pop, torch.from_numpy(A @ np.ones(n)), rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-8)


def test_cholesky_operators(rng):
    import scipy.sparse as sp

    A = rng.standard_normal((6, 6))
    spd = A @ A.T + 6 * np.eye(6)
    x = rng.standard_normal(6)
    for src in (spd, tops.MatrixOperator(spd, symmetric=True, device=DEV)):
        inv = tops.CholeskyOperator(src, device=DEV)
        assert inv.symmetric
        np.testing.assert_allclose((inv * torch.from_numpy(spd @ x)).numpy(),
                                   x, rtol=1e-10)
    same(inv * torch.from_numpy(x), jops.CholeskyOperator(spd)
         * jnp.asarray(x))
    X = rng.standard_normal((6, 3))
    np.testing.assert_allclose((inv * torch.from_numpy(spd @ X)).numpy(), X,
                               rtol=1e-10)
    d = rng.standard_normal(8) ** 2 + 1
    op = tops.HostFactorizationOperator.from_scipy_spd(sp.diags(d).tocsc(),
                                                       device=DEV)
    y = rng.standard_normal(8)
    np.testing.assert_allclose((op * torch.from_numpy(d * y)).numpy(), y,
                               rtol=1e-12)
    host = tops.HostFactorizationOperator(4, lambda r: r / d[:4], device=DEV)
    assert (host * torch.ones(4, dtype=torch.float64)).dtype == torch.float64
