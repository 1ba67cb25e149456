"""The port's row-sharded rectangular operator (``parallel/tall.py``)
against the JAX package's ``TallSkinnyOperator``, on the same numpy inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on a CPU mesh of as many slots (``make_mesh(P, device="cpu")``),
at P = 1, 2, 4 and 8, over a dense matrix (row-block products) and a COO
container (ELL gather/scatter products).  Forward products agree in f64 to
1e-12 relative; ``A^T u`` sums the shards' partials in shard order where
the JAX package takes a ``psum``, so the transposes agree to 1e-10.
LSQR and LSMR take the JAX counts with histories to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.solvers import lsmr as jlsmr
from pykrylov_tpu.solvers import lsqr as jlsqr
from pykrylov_tpu.sparse import formats as JF

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.solvers import lsmr, lsqr
from pykrylov_tpu_torch.sparse import formats as TF

from test_torch_gather import close, _same

DEV = "cpu"  # the port's entry points default to the card
RTOL_T = 1e-10
PS = [1, 2, 4, 8]

jmul = jax.jit(lambda op, v: op * v)
jmul_t = jax.jit(lambda op, v: op.T * v)


def tall(rng, m=203, n=17):
    """A dense m x n matrix with singular values in about [2, 3] (m does
    not divide 2, 4 or 8) and a sparse copy of its nonzeros."""
    q, _ = np.linalg.qr(rng.standard_normal((m, n)))
    a = q * rng.uniform(2, 3, n)
    a[np.abs(a) < 0.05] = 0.0
    rr, cc = np.nonzero(a)
    return a, (a[rr, cc], rr, cc, (m, n))


def pair(rng, P, kind):
    a, trip = tall(rng)
    if kind == "dense":
        js, ts = a, a
    else:
        js = JF.coo_from_arrays(*trip, device=False)
        ts = TF.coo_from_arrays(*trip, device=None)
    return (jpar.TallSkinnyOperator(js, jpar.make_mesh(P)),
            par.TallSkinnyOperator(ts, par.make_mesh(P, device=DEV)), a)


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("P", PS)
def test_products_match_jax(P, kind, rng):
    jo, to, a = pair(rng, P, kind)
    assert (to.shape, to.pad) == (jo.shape, jo.pad)
    assert len(to.container) == P
    m, n = a.shape
    x = rng.standard_normal(n)
    y = to * torch.from_numpy(x)
    close(y, jmul(jo, jnp.asarray(x)))
    assert not y[m:].any()
    u = rng.standard_normal(to.nargout)   # junk in the padded rows too
    close(to.T * par.shard_vector(u, to.mesh),
          jmul_t(jo, jpar.shard_vector(jnp.asarray(u), jo.mesh)), RTOL_T)
    X = rng.standard_normal((n, 3))
    close(to * torch.from_numpy(X), jmul(jo, jnp.asarray(X)))
    U = rng.standard_normal((to.nargout, 3))
    close(to.T * par.shard_vector(U, to.mesh),
          jmul_t(jo, jpar.shard_vector(jnp.asarray(U), jo.mesh)), RTOL_T)


def test_transpose_sums_partials_in_shard_order(rng):
    # A^T u is the sum of the shards' partial products, added in shard
    # order: the same bits as that sum taken by hand
    a, _ = tall(rng)
    op = par.TallSkinnyOperator(a, par.make_mesh(4, device=DEV))
    u = torch.from_numpy(rng.standard_normal(op.nargout))
    L = op.nargout // 4
    ap = torch.zeros((op.nargout, a.shape[1]), dtype=torch.float64)
    ap[:a.shape[0]] = torch.from_numpy(a)
    parts = [ap[k * L:(k + 1) * L].T @ u[k * L:(k + 1) * L]
             for k in range(4)]
    assert torch.equal(op.T * u, parts[0] + parts[1] + parts[2] + parts[3])


def test_f32_matrix_promotes_f64_vectors(rng):
    a, _ = tall(rng)
    op = par.TallSkinnyOperator(a.astype(np.float32),
                                par.make_mesh(2, device=DEV))
    x = torch.from_numpy(rng.standard_normal(a.shape[1]))
    y = op * x
    assert y.dtype == torch.float64
    ref = a.astype(np.float32).astype(np.float64) @ x.numpy()
    np.testing.assert_allclose(y[:a.shape[0]].numpy(), ref, rtol=1e-12)


def test_rejects_a_vector():
    with pytest.raises(ValueError):
        par.TallSkinnyOperator(np.ones(5), par.make_mesh(2, device=DEV))


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("P", PS)
def test_lsqr_and_lsmr_match_jax(P, kind, rng):
    jo, to, a = pair(rng, P, kind)
    b = np.zeros(to.nargout)
    b[:a.shape[0]] = rng.standard_normal(a.shape[0])
    bt = par.shard_vector(b, to.mesh)
    bj = jpar.shard_vector(jnp.asarray(b), jo.mesh)
    kw = dict(atol=1e-10, btol=1e-10, store_history=True)
    _same(lsqr(to, bt, **kw), jlsqr(jo, bj, **kw))
    _same(lsmr(to, bt, **kw), jlsmr(jo, bj, **kw))
    x = lsqr(to, bt, damp=0.7, atol=1e-12, btol=1e-12).x.numpy()
    aug = np.vstack([a, 0.7 * np.eye(a.shape[1])])
    ref = np.linalg.lstsq(aug, np.r_[b[:a.shape[0]], np.zeros(a.shape[1])],
                          rcond=None)[0]
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)
