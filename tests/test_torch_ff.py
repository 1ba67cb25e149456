"""The port's double-f32 arithmetic (``utils/ff.py``), its compensated
products and its resolver against the JAX package's.

The same NumPy inputs, made from a seed, go through
``pykrylov_tpu.utils.ff`` and ``pykrylov_tpu_torch.utils.ff`` on the CPU.
Tolerances:

  * every elementwise function (``two_sum``, ``two_prod``, the Dekker
    split, ``ff_renorm``, ``ff_add``, ``ff_add_ff``, ``ff_scale``,
    ``ff_div``, ``ff_mul``, ``ff_sqrt``, ``ff_hypot``): bit for bit, in
    float32 and float64, on inputs spread over 40 binades;
  * the reductions (``ff_sum``, ``ff_vdot`` and their ``_cols`` forms, and
    ``ff_dot2``), whose plain sums of error terms run in another order in
    each package: ``hi + lo`` within ``|hi|·2^-44`` (float32) or
    ``|hi|·2^-100`` (float64);
  * the compensated ELL and dense products (``ell_matvec_ff``,
    ``_ff_dense``): bit for bit (the same elementwise sequence);
  * hypothesis: ``s + e == a + b`` and ``p + e == a·b`` exactly in float64
    for float32 inputs;
  * the resolver: a compensated product exactly where the JAX resolver
    finds one, for every operator kind.
"""

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled as jax_load_bundled
from pykrylov_tpu.ops import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops import IdentityOperator as JIdentityOperator
from pykrylov_tpu.ops import linop_from_ndarray
from pykrylov_tpu.solvers import ffmv as JFF
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator
from pykrylov_tpu.sparse.kernels import pallas_dia_operator
from pykrylov_tpu.utils import ff as jff

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.ops import (DiagonalOperator, IdentityOperator,
                                    MatrixOperator)
from pykrylov_tpu_torch.solvers import ffmv
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import operator_from_coo, sparse_operator
from pykrylov_tpu_torch.utils import ff

DEV = "cpu"  # the port's entry points default to the card
DTYPES = {"f32": (np.float32, 2.0 ** -44), "f64": (np.float64, 2.0 ** -100)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the loops are thousands of small launches: torch's intra-op thread
    # pool only adds overhead, and under pytest-xdist it oversubscribes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spread(rng, n, dt, binades=40, positive=False):
    """Standard normal values scaled over ``binades`` binades."""
    v = rng.standard_normal(n) * 2.0 ** rng.integers(-binades // 2,
                                                     binades // 2, n)
    return (np.abs(v) if positive else v).astype(dt)


def both(fn, *args):
    """``fn`` of the port and of the JAX package on the same arrays, as
    lists of NumPy arrays."""
    t = getattr(ff, fn)(*[torch.from_numpy(a) for a in args])
    j = getattr(jff, fn)(*[jnp.asarray(a) for a in args])
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


# function -> (arity, whether its inputs must be positive)
ELEMENTWISE = {"two_sum": (2, False), "two_prod": (2, False),
               "_split": (1, False), "ff_renorm": (2, False),
               "ff_add": (3, False), "ff_add_ff": (4, False),
               "ff_scale": (3, False), "ff_div": (3, False),
               "ff_div_pair": (4, False), "ff_mul": (4, False),
               "ff_sqrt": (2, True), "ff_hypot": (4, False)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_bit_for_bit(name, dtype):
    dt = DTYPES[dtype][0]
    arity, positive = ELEMENTWISE[name]
    rng = np.random.default_rng(len(name))
    n = 4096
    args = [spread(rng, n, dt, positive=positive) for _ in range(arity)]
    fn = name
    if name == "ff_div_pair":
        fn = "ff_div"
    if name in ("ff_renorm", "ff_sqrt", "ff_add_ff", "ff_div_pair",
                "ff_mul", "ff_hypot", "ff_add"):
        # the lo halves of pairs: canonical, |lo| <= ulp(hi)/2
        for k in range(1, arity, 2):
            lo = args[k - 1] * dt(np.finfo(dt).eps / 4) * rng.random(n)
            args[k] = lo.astype(dt)
        if name == "ff_add":
            args[2] = spread(rng, n, dt)
    t, j = both(fn, *args)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == dt
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 5, 1000, 4096])
@pytest.mark.parametrize("name", ["ff_sum", "ff_vdot", "ff_sum_cols",
                                  "ff_vdot_cols", "ff_dot2"])
def test_reductions_agree_to_twice_working_precision(name, n, dtype):
    dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(n)
    shape = (n, 3) if name.endswith("_cols") else (n,)
    nargs = {"ff_sum": 1, "ff_sum_cols": 1, "ff_dot2": 2}.get(name, 4)
    args = []
    for k in range(nargs):
        v = (rng.standard_normal(shape) + 2.0) * 2.0 ** rng.integers(
            -4, 4, shape)
        if name.startswith("ff_vdot") and k % 2:
            v = args[-1] * dt(np.finfo(dt).eps / 4) * rng.random(shape)
        args.append(v.astype(dt))
    t, j = both(name, *args)
    if name == "ff_dot2":
        # a working-dtype value: both within a few ulps of the exact dot
        exact = np.dot(args[0].astype(np.float64), args[1])
        assert abs(float(t[0]) - float(j[0])) <= 4 * np.finfo(dt).eps * \
            abs(exact)
        return
    (th, tl), (jh, jl) = t, j
    diff = np.abs((th.astype(np.float64) - jh) + (tl.astype(np.float64)
                                                  - jl))
    assert np.all(diff <= np.abs(jh) * tol), (diff, jh)


F32_RANGE = st.floats(min_value=-2.0 ** 60, max_value=2.0 ** 60, width=32,
                      allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None)
@given(F32_RANGE, F32_RANGE)
def test_two_sum_is_error_free(a, b):
    s, e = ff.two_sum(torch.tensor(a, dtype=torch.float32),
                      torch.tensor(b, dtype=torch.float32))
    assert float(s) + float(e) == np.float64(a) + np.float64(b)


@settings(max_examples=300, deadline=None)
@given(F32_RANGE, F32_RANGE)
def test_two_prod_is_error_free(a, b):
    # away from underflow: the product's error must stay a normal float32
    assume(a == 0 or b == 0 or abs(a * b) >= 2.0 ** -100)
    p, e = ff.two_prod(torch.tensor(a, dtype=torch.float32),
                       torch.tensor(b, dtype=torch.float32))
    assert float(p) + float(e) == np.float64(a) * np.float64(b)


@pytest.fixture(scope="module")
def bus_ell():
    vals, rows, cols, shape = jax_load_bundled("1138bus")
    jell = JF.ell_from_coo(JF.coo_from_arrays(
        vals.astype(np.float32), rows, cols, shape, device=False))
    return jell, convert.from_numpy(jell, device=DEV)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_ell_matvec_ff_bit_for_bit(bus_ell, dtype):
    dt = DTYPES[dtype][0]
    jell, tell = bus_ell
    rng = np.random.default_rng(2)
    n = jell.shape[1]
    xh = rng.standard_normal(n).astype(dt)
    xl = (xh * dt(np.finfo(dt).eps / 4) * rng.random(n)).astype(dt)
    jh, jl = JF.ell_matvec_ff(jell, jnp.asarray(xh), jnp.asarray(xl))
    th, tl = F.ell_matvec_ff(tell, torch.from_numpy(xh),
                             torch.from_numpy(xl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_ell_matvec_ff_beats_plain_f32(bus_ell):
    # tests/test_ff.py's case on the port: against the f64 product of the
    # f32-stored matrix, the compensated error is 1000x below the plain
    vals, rows, cols, shape = jax_load_bundled("1138bus")
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals.astype(np.float32).astype(np.float64))
    _, tell = bus_ell
    x = np.random.default_rng(2).standard_normal(shape[1]).astype(
        np.float32)
    ref = a64 @ x.astype(np.float64)
    plain = F.ell_matvec(tell, torch.from_numpy(x)).double().numpy()
    yh, yl = F.ell_matvec_ff(tell, torch.from_numpy(x),
                             torch.zeros(shape[1]))
    comp = yh.double().numpy() + yl.double().numpy()
    assert np.linalg.norm(comp - ref) < 1e-3 * np.linalg.norm(plain - ref)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_ff_dense_bit_for_bit(dtype):
    dt = DTYPES[dtype][0]
    rng = np.random.default_rng(3)
    a = spread(rng, 60 * 45, dt, binades=20).reshape(60, 45)
    xh = spread(rng, 45, dt, binades=20)
    xl = (xh * dt(np.finfo(dt).eps / 4) * rng.random(45)).astype(dt)
    jop = linop_from_ndarray(jnp.asarray(a))
    jh, jl = JFF.resolve_ff_matvec(jop)(jop._params, jnp.asarray(xh),
                                        jnp.asarray(xl))
    th, tl = ffmv.resolve_ff_matvec(MatrixOperator(a, device=DEV))(
        torch.from_numpy(xh), torch.from_numpy(xl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the block form: column by column, as the JAX package's vmap
    X = np.stack([xh, 2 * xh], axis=1)
    Xl = np.stack([xl, 2 * xl], axis=1)
    Yh, Yl = ffmv.resolve_ff_matmat(MatrixOperator(a, device=DEV))(
        torch.from_numpy(X), torch.from_numpy(Xl))
    np.testing.assert_array_equal(Yh[:, 0].numpy(), th.numpy())
    np.testing.assert_array_equal(Yl[:, 1].numpy(), ff.ff_renorm(
        *ffmv.resolve_ff_matvec(MatrixOperator(a, device=DEV))(
            torch.from_numpy(2 * xh), torch.from_numpy(2 * xl)))[1].numpy())


def _triples(n=300, sym=True, seed=4):
    """A sparse matrix with a band and scattered entries (unsymmetric when
    ``sym`` is False), as COO triples."""
    rng = np.random.default_rng(seed)
    a = (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    r, c = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    a[r, c] += 0.1 * rng.standard_normal(2 * n)
    if sym:
        a = 0.5 * (a + a.T)
    rr, cc = np.nonzero(a)
    return a, (a[rr, cc], rr, cc, (n, n))


def _kinds():
    """(name, port operator, JAX operator) for every operator kind."""
    out = []
    for sym in (True, False):
        a, t = _triples(sym=sym)
        tag = "sym" if sym else "unsym"
        for fmt in ("ell", "csr", "coo", "dia"):
            out.append(("%s %s" % (fmt, tag),
                        sparse_operator(t, symmetric=sym, fmt=fmt,
                                        device=DEV),
                        jax_sparse_operator(t, symmetric=sym, fmt=fmt)))
        out.append(("dense %s" % tag,
                    MatrixOperator(a, symmetric=sym, device=DEV),
                    linop_from_ndarray(jnp.asarray(a), symmetric=sym)))
        out.append(("cuda-dia %s" % tag,
                    operator_from_coo(*t, symmetric=sym, fmt="cuda-dia",
                                      device=DEV),
                    pallas_dia_operator(JF.dia_from_coo(JF.coo_from_arrays(
                        *t)), symmetric=sym, interpret=True)))
        out.append(("bell %s" % tag,
                    B.bell_operator(t, symmetric=sym, device=DEV),
                    JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                                     symmetric=sym, interpret=True)))
    rect = np.random.default_rng(5).standard_normal((40, 25))
    out.append(("dense rectangular", MatrixOperator(rect, device=DEV),
                linop_from_ndarray(jnp.asarray(rect))))
    out.append(("diagonal", DiagonalOperator(np.arange(1.0, 11.0),
                                             device=DEV),
                JDiagonalOperator(jnp.arange(1.0, 11.0))))
    return out


KINDS = _kinds()


@pytest.mark.parametrize("kind,derived", [
    (k[0], d) for k in KINDS
    for d in ("A", "A.T", "A - sigma I", "A + A", "2 A")
    if d != "A - sigma I" or k[1].shape[0] == k[1].shape[1]])
def test_resolver_matches_jax(kind, derived):
    _, top, jop = next(k for k in KINDS if k[0] == kind)

    def derive(op, ident):
        if derived == "A.T":
            return op.T
        if derived == "A - sigma I":
            return op - 0.5 * ident(op.shape[0])
        if derived == "A + A":
            return op + op
        if derived == "2 A":
            return 2 * op
        return op

    t = derive(top, lambda n: IdentityOperator(n, dtype=top.dtype,
                                               device=DEV))
    j = derive(jop, lambda n: JIdentityOperator(n))
    tf, jf = ffmv.resolve_ff_matvec(t), JFF.resolve_ff_matvec(j)
    assert (tf is None) == (jf is None)
    assert (ffmv.resolve_ff_matmat(t) is None) == (
        JFF.resolve_ff_matmat(j) is None)
    if tf is not None:
        # the port's product is A's (A^T's for a transpose), to twice the
        # working precision; the JAX resolver hands the transpose of an
        # unsymmetric operator A's product (ROADMAP.md queue 3)
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(
            t.shape[1]))
        yh, yl = tf(x, torch.zeros_like(x))
        ref = t @ x
        assert torch.allclose(yh + yl, ref, rtol=1e-12, atol=1e-12)
