"""The port's gather-scheduled row-sharded ELL operator against the JAX
package's, on the same numpy inputs at P = 1, 2, 4 and 8 (the JAX side on
the virtual CPU devices of ``tests/conftest.py``, the port on a CPU mesh
of as many slots).

The schedule's arrays must be equal; products and their transposes agree
to 1e-12 relative (1e-10 for the transpose, whose partials the port sums
in shard order where the JAX exchange adds its rounds in turn); CG,
MINRES and LSQR through the operators take the JAX counts with histories
to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.solvers import cg as jcg
from pykrylov_tpu.solvers import lsqr as jlsqr
from pykrylov_tpu.solvers import minres as jminres
from pykrylov_tpu.solvers.ffmv import resolve_ff_matvec as jresolve
from pykrylov_tpu.sparse import formats as JF

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.io.matrix_market import write_matrix_market
from pykrylov_tpu_torch.solvers import cg, lsqr, minres
from pykrylov_tpu_torch.solvers.ffmv import resolve_ff_matvec
from pykrylov_tpu_torch.sparse import formats as TF

DEV = "cpu"  # the port's entry points default to the card
RTOL = 1e-12
RTOL_T = 1e-10
PS = [1, 2, 4, 8]

jmul = jax.jit(lambda op, v: op * v)
jmul_t = jax.jit(lambda op, v: op.T * v)


def close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


def coos(vals, rows, cols, shape):
    return (JF.coo_from_arrays(vals, rows, cols, shape, device=False),
            TF.coo_from_arrays(vals, rows, cols, shape, device=None))


def spd_system(rng, n=300):
    """A sparse SPD matrix with its spectrum in [2, 4]: 2 I plus a
    symmetric random part of small norm."""
    r = rng.integers(0, n, 3 * n)
    c = rng.integers(0, n, 3 * n)
    v = 0.15 * rng.standard_normal(3 * n)
    a = np.zeros((n, n))
    np.add.at(a, (r, c), v)
    a = a + a.T + 3 * np.eye(n)
    rr, cc = np.nonzero(a)
    return a[rr, cc], rr, cc, (n, n)


def tall_system(rng, m=300, n=120):
    """A sparse m x n matrix with singular values in about [2, 2.6]:
    [2 I; R] with a sparse R of small norm, rows shuffled."""
    k = 2 * (m - n)
    r = n + rng.integers(0, m - n, k)
    c = rng.integers(0, n, k)
    v = 0.3 * rng.standard_normal(k)
    rows = np.concatenate([np.arange(n), r])
    cols = np.concatenate([np.arange(n), c])
    vals = np.concatenate([np.full(n, 2.0), v])
    perm = rng.permutation(m)
    return vals, perm[rows], cols, (m, n)


@pytest.mark.parametrize("P", PS)
def test_schedule_arrays_match_jax(P, rng):
    vals, rows, cols, shape = load_bundled("jpwh_991")
    ell = TF.ell_from_coo(TF.coo_from_arrays(vals, rows, cols, shape,
                                             device=None), device=None)
    m = shape[0]
    mp = par.pad_to_multiple(m, P)
    data = np.zeros((mp, ell.data.shape[1]))
    cl = np.zeros((mp, ell.data.shape[1]), dtype=np.int64)
    data[:m], cl[:m] = ell.data, ell.cols
    got = par.build_gather_schedule(cl, data, P, mp // P)
    ref = jpar.build_gather_schedule(cl, data, P, mp // P)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert got[0].dtype == np.asarray(ref[0]).dtype
    assert len(got[1]) == len(ref[1]) == P - 1
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[2] == ref[2]


def test_schedule_skips_dead_padding():
    d, L = 4, 8
    cols = np.zeros((d * L, 2), dtype=np.int64)
    data = np.zeros((d * L, 2))
    cols[:, 0] = np.arange(d * L)
    data[:, 0] = 1.0
    cols_local, send, lens = par.build_gather_schedule(cols, data, d, L)
    assert all(s.shape[1] == 0 for s in send)
    assert not cols_local[:, 1].any()


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("case", ["jpwh_991", "tall", "wide"])
def test_products_and_transposes_match_jax(P, case, rng):
    if case == "jpwh_991":
        trip = load_bundled("jpwh_991")
    else:
        trip = tall_system(rng)
        if case == "wide":
            vals, rows, cols, (m, n) = trip
            trip = (vals, cols, rows, (n, m))
    jc, tc = coos(*trip)
    jm, tm = jpar.make_mesh(P), par.make_mesh(P, device=DEV)
    jo = jpar.GatherEllOperator(jc, jm)
    to = par.GatherEllOperator(tc, tm)
    assert (to.shape, to.pad, to.pad_n) == (jo.shape, jo.pad, jo.pad_n)
    for attr in ("comm_entries_per_matvec", "comm_entries_true",
                 "allgather_entries_per_matvec"):
        assert getattr(to, attr) == getattr(jo, attr)
    x = rng.standard_normal(to.nargin)
    close(to * par.shard_vector(x, tm),
          jmul(jo, jpar.shard_vector(jnp.asarray(x), jm)))
    u = rng.standard_normal(to.nargout)   # junk in the padded rows too
    close(to.T * par.shard_vector(u, tm),
          jmul_t(jo, jpar.shard_vector(jnp.asarray(u), jm)), RTOL_T)


@pytest.mark.parametrize("P", [2, 8])
def test_compensated_product_matches_jax(P, rng):
    jc, tc = coos(*load_bundled("jpwh_991"))
    jm, tm = jpar.make_mesh(P), par.make_mesh(P, device=DEV)
    jo = jpar.GatherEllOperator(jc, jm)
    to = par.GatherEllOperator(tc, tm)
    xh = rng.standard_normal(to.nargin)
    xl = xh * 1e-17
    th, tl = resolve_ff_matvec(to)(torch.from_numpy(xh),
                                   torch.from_numpy(xl))
    jh, jl = jax.jit(jresolve(jo))(jo._params,
                                   jpar.shard_vector(jnp.asarray(xh), jm),
                                   jpar.shard_vector(jnp.asarray(xl), jm))
    # the jitted JAX cascade contracts products differently (a hi part
    # an ulp off here and there): the pairs' values agree
    close(th + tl, np.asarray(jh) + np.asarray(jl))
    # each shard's cascade is the unsharded one over its rows, bit for bit
    # (the unsharded ELL cascade is the JAX one's, tests/test_torch_ff.py)
    ell = TF.ell_from_coo(tc, device=None)
    ref = TF.ell_matvec_ff(
        TF.ELL(torch.from_numpy(ell.data), torch.from_numpy(
            ell.cols.astype(np.int64)), ell.shape),
        torch.from_numpy(xh[:991]), torch.from_numpy(xl[:991]))
    assert torch.equal(th[:991], ref[0]) and torch.equal(tl[:991], ref[1])


def _same(rt, rj, hist=True):
    assert int(rt.istop) == int(rj.istop)
    assert int(rt.n_iter) == int(rj.n_iter)
    assert int(rt.n_matvec) == int(rj.n_matvec)
    if hist:
        k = int(rt.n_iter) + 1
        np.testing.assert_allclose(rt.resid_history[:k].numpy(),
                                   np.asarray(rj.resid_history)[:k],
                                   rtol=1e-10)
    close(rt.x, rj.x, 1e-10)


@pytest.mark.parametrize("P", PS)
def test_cg_and_minres_match_jax(P, rng):
    jc, tc = coos(*spd_system(rng))
    jm, tm = jpar.make_mesh(P), par.make_mesh(P, device=DEV)
    jo = jpar.GatherEllOperator(jc, jm, symmetric=True)
    to = par.GatherEllOperator(tc, tm, symmetric=True)
    b = np.zeros(to.nargin)
    b[:300] = rng.standard_normal(300)
    bj, bt = jpar.shard_vector(jnp.asarray(b), jm), par.shard_vector(b, tm)
    _same(cg(to, bt, rtol=1e-10, store_history=True),
          jcg(jo, bj, rtol=1e-10, store_history=True))
    _same(minres(to, bt, rtol=1e-10, store_history=True),
          jminres(jo, bj, rtol=1e-10, store_history=True))


@pytest.mark.parametrize("P", PS)
def test_lsqr_matches_jax(P, rng):
    jc, tc = coos(*tall_system(rng))
    jm, tm = jpar.make_mesh(P), par.make_mesh(P, device=DEV)
    jo = jpar.GatherEllOperator(jc, jm)
    to = par.GatherEllOperator(tc, tm)
    b = np.zeros(to.nargout)
    b[:300] = rng.standard_normal(300)
    rt = lsqr(to, par.shard_vector(b, tm), atol=1e-10, btol=1e-10,
              store_history=True)
    rj = jlsqr(jo, jpar.shard_vector(jnp.asarray(b), jm), atol=1e-10,
               btol=1e-10, store_history=True)
    _same(rt, rj)


def test_verified_cg_through_gather_matches_jax(rng):
    jc, tc = coos(*spd_system(rng))
    jm, tm = jpar.make_mesh(4), par.make_mesh(4, device=DEV)
    jo = jpar.GatherEllOperator(jc, jm, symmetric=True)
    to = par.GatherEllOperator(tc, tm, symmetric=True)
    b = rng.standard_normal(300)
    rt = cg(to, par.shard_vector(b, tm), rtol=1e-10, replace_every=10)
    rj = jcg(jo, jpar.shard_vector(jnp.asarray(b), jm), rtol=1e-10,
             replace_every=10)
    _same(rt, rj, hist=False)


@pytest.mark.parametrize("P", [1, 4])
def test_gather_ell_from_mtx_matches_monolithic(P, tmp_path, rng):
    vals, rows, cols, shape = load_bundled("jpwh_991")
    path = tmp_path / "jpwh.mtx"
    write_matrix_market(path, vals, rows, cols, shape)
    tm = par.make_mesh(P, device=DEV)
    from_file = par.gather_ell_from_mtx(path, tm, chunk_entries=1000)
    whole = par.GatherEllOperator(coos(vals, rows, cols, shape)[1], tm)
    from pykrylov_tpu.parallel.gather import gather_ell_from_mtx
    jo = gather_ell_from_mtx(path, jpar.make_mesh(P), chunk_entries=1000)
    x = rng.standard_normal(whole.nargin)
    y = from_file * torch.from_numpy(x)
    assert torch.equal(y, whole * torch.from_numpy(x))
    close(y, jmul(jo, jpar.shard_vector(jnp.asarray(x), jo.mesh)))
