"""The port's scheduled-gather SELL operator (``parallel/bell_sharded.py``)
against the JAX package's ``GatherBellOperator``, on the same numpy inputs.

The JAX side runs its BELL Pallas kernels in interpret mode on the 8
virtual CPU devices of ``tests/conftest.py``; the port runs one SELL card
form per shard on a CPU mesh of as many slots (``make_mesh(P,
device="cpu")``), through the SELL kernels' plain versions (the wrappers
take them for CPU tensors), at P = 1, 2, 4 and 8.  Each shard's BELL
packing is held against the JAX packer array for array; products agree
in f64 to 1e-12 relative (1e-10 for the transposes, whose reversed
exchange sums the shards' partials in another order); solves take the
JAX counts with histories to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.parallel.bell_sharded import (
    _pack_local_blocks as jpack)
from pykrylov_tpu.solvers import cg as jcg
from pykrylov_tpu.solvers import lsqr as jlsqr
from pykrylov_tpu.solvers import minres as jminres
from pykrylov_tpu.sparse import formats as JF

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.parallel.bell_sharded import _pack_local_blocks
from pykrylov_tpu_torch.parallel.gather import pad_ell, sharded_ell
from pykrylov_tpu_torch.solvers import cg, lsqr, minres
from pykrylov_tpu_torch.solvers.ffmv import resolve_ff_matvec
from pykrylov_tpu_torch.sparse import formats as TF

from test_torch_gather import close, spd_system, tall_system, _same

DEV = "cpu"  # the port's entry points default to the card
RTOL_T = 1e-10
PS = [1, 2, 4, 8]

jmul = jax.jit(lambda op, v: op * v)
jmul_t = jax.jit(lambda op, v: op.T * v)


def coos(vals, rows, cols, shape):
    return (JF.coo_from_arrays(vals, rows, cols, shape, device=False),
            TF.coo_from_arrays(vals, rows, cols, shape, device=None))


def pair(trip, P, **kw):
    jc, tc = coos(*trip)
    return (jpar.GatherBellOperator(jc, jpar.make_mesh(P), **kw),
            par.GatherBellOperator(tc, par.make_mesh(P, device=DEV), **kw))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("P", PS)
def test_packed_blocks_match_jax(P, transpose):
    data, cols, m, n = pad_ell(TF.coo_from_arrays(
        *load_bundled("jpwh_991"), device=None))
    dp, cols_local, sendidx, _, _, _, Lrow, Lx = sharded_ell(
        data, cols, P, m, n)
    width = Lx + sum(s.shape[1] for s in sendidx)
    got = _pack_local_blocks(dp, cols_local, P, Lrow, width, 64, transpose)
    ref = jpack(dp, cols_local, P, Lrow, width, 64, transpose)
    assert got[1] == tuple(int(v) for v in ref[1])
    for a, b in zip(got[0], ref[0]):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("case", ["jpwh_991", "wide"])
def test_products_match_jax(P, case, rng):
    if case == "jpwh_991":
        trip = load_bundled("jpwh_991")
    else:
        vals, rows, cols, (m, n) = tall_system(rng)
        trip = (vals, cols, rows, (n, m))
    jo, to = pair(trip, P, with_transpose=True)
    tm, jm = to.mesh, jo.mesh
    assert (to.shape, to.pad, to.pad_n) == (jo.shape, jo.pad, jo.pad_n)
    for attr in ("comm_entries_per_matvec", "comm_entries_true",
                 "allgather_entries_per_matvec", "slots_per_device"):
        assert getattr(to, attr) == getattr(jo, attr)
    assert len(to.cards) == len(to.cards_t) == P
    x = rng.standard_normal(to.nargin)
    close(to * par.shard_vector(x, tm),
          jmul(jo, jpar.shard_vector(jnp.asarray(x), jm)))
    u = rng.standard_normal(to.nargout)   # junk in the padded rows too
    close(to.T * par.shard_vector(u, tm),
          jmul_t(jo, jpar.shard_vector(jnp.asarray(u), jm)), RTOL_T)
    X = rng.standard_normal((to.nargin, 3))
    close(to * par.shard_vector(X, tm),
          jmul(jo, jpar.shard_vector(jnp.asarray(X), jm)))
    U = rng.standard_normal((to.nargout, 3))
    close(to.T * par.shard_vector(U, tm),
          jmul_t(jo, jpar.shard_vector(jnp.asarray(U), jm)), RTOL_T)


@pytest.mark.parametrize("P", [2, 8])
def test_products_equal_gather_ell(P, rng):
    # the same schedule with the SELL card form as the local product: the
    # forward rows are the ELL operator's to rounding, and the traffic is
    # the same
    trip = load_bundled("jpwh_991")
    tc = coos(*trip)[1]
    tm = par.make_mesh(P, device=DEV)
    tb = par.GatherBellOperator(tc, tm)
    te = par.GatherEllOperator(tc, tm)
    assert tb.comm_entries_per_matvec == te.comm_entries_per_matvec
    assert tb.comm_entries_true == te.comm_entries_true
    x = torch.from_numpy(rng.standard_normal(tb.nargin))
    close(tb * x, (te * x).numpy())


def test_without_transpose_raises(rng):
    tc = coos(*load_bundled("jpwh_991"))[1]
    op = par.GatherBellOperator(tc, par.make_mesh(4, device=DEV))
    assert op.cards_t is None
    with pytest.raises(Exception):
        op.T * torch.zeros(op.nargout, dtype=torch.float64)


@pytest.mark.parametrize("P", PS)
def test_cg_and_minres_match_jax(P, rng):
    jo, to = pair(spd_system(rng), P, symmetric=True)
    b = np.zeros(to.nargin)
    b[:300] = rng.standard_normal(300)
    bj = jpar.shard_vector(jnp.asarray(b), jo.mesh)
    bt = par.shard_vector(b, to.mesh)
    _same(cg(to, bt, rtol=1e-10, store_history=True),
          jcg(jo, bj, rtol=1e-10, store_history=True))
    _same(minres(to, bt, rtol=1e-10, store_history=True),
          jminres(jo, bj, rtol=1e-10, store_history=True))


@pytest.mark.parametrize("P", PS)
def test_lsqr_matches_jax(P, rng):
    jo, to = pair(tall_system(rng), P, with_transpose=True)
    b = np.zeros(to.nargout)
    b[:300] = rng.standard_normal(300)
    rt = lsqr(to, par.shard_vector(b, to.mesh), atol=1e-10, btol=1e-10,
              store_history=True)
    rj = jlsqr(jo, jpar.shard_vector(jnp.asarray(b), jo.mesh), atol=1e-10,
               btol=1e-10, store_history=True)
    _same(rt, rj)


def test_verified_shadow_matches_jax(rng):
    jo, to = pair(spd_system(rng), 4, symmetric=True, verified_shadow=True)
    ff = resolve_ff_matvec(to)
    assert ff is not None
    # a shadowless operator on the same config keeps no compensated product
    plain = par.GatherBellOperator(coos(*spd_system(rng))[1], to.mesh,
                                   symmetric=True)
    assert resolve_ff_matvec(plain) is None
    b = np.zeros(to.nargin)
    b[:300] = rng.standard_normal(300)
    rt = cg(to, par.shard_vector(b, to.mesh), rtol=1e-10, replace_every=10)
    rj = jcg(jo, jpar.shard_vector(jnp.asarray(b), jo.mesh), rtol=1e-10,
             replace_every=10)
    _same(rt, rj, hist=False)
    # the shadow's compensated product is the ELL one over the same arrays
    te = par.GatherEllOperator(coos(*spd_system(np.random.default_rng(0)))[1],
                               to.mesh, symmetric=True)
    tb = par.GatherBellOperator(
        coos(*spd_system(np.random.default_rng(0)))[1], to.mesh,
        symmetric=True, verified_shadow=True)
    xh = torch.from_numpy(rng.standard_normal(tb.nargin))
    xl = xh * 1e-17
    got = resolve_ff_matvec(tb)(xh, xl)
    ref = resolve_ff_matvec(te)(xh, xl)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_interpret_is_accepted_and_ignored(rng):
    tc = coos(*load_bundled("jpwh_991"))[1]
    tm = par.make_mesh(2, device=DEV)
    a = par.GatherBellOperator(tc, tm, interpret=True)
    b = par.GatherBellOperator(tc, tm, interpret=False)
    x = torch.from_numpy(rng.standard_normal(a.nargin))
    assert torch.equal(a * x, b * x)
