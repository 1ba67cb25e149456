"""The solvers on a mesh of ranks: a spawned gloo world of 4 CPU processes
runs CG (plain, Jacobi, verified over the halo and the gather operators),
MINRES (definite and shifted), pipelined CG, ``cg_batched``, LSQR (gather
and tall), ``bicgstab_batched`` (gather BELL) and the partitioned
MatrixMarket ingestion (``keep=rank``), in f64
(``tests/torch_rank_legs.py``).  The parent holds them to the JAX
package's sharded solves on a 4-device mesh of ``tests/conftest.py``'s
virtual devices: the same iteration counts and stop codes, histories and
x to 1e-10; every rank's counts, stop codes and histories identical bit
for bit; a rank that raises fails the world within its deadline.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.ops import DiagonalOperator as JDiagonal
from pykrylov_tpu.ops import IdentityOperator as JIdentity
from pykrylov_tpu.solvers import (bicgstab_batched as jbicgstab_batched,
                                  cg as jcg, cg_batched as jcg_batched,
                                  cg_pipelined as jcg_pipelined,
                                  lsqr as jlsqr, minres as jminres)
from pykrylov_tpu.sparse import formats as JF

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.io import matrix_market as tmm
from pykrylov_tpu_torch.parallel.launch import RankFailure, spawn_ranks

import torch_rank_legs as L

P = 4
TOL = 1e-10


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    vals, rows, cols, shape = L.general_coo(3, 61, 61, True)
    lower = rows >= cols
    path = tmp_path_factory.mktemp("mtx") / "a.mtx"
    tmm.write_matrix_market(path, vals[lower], rows[lower], cols[lower],
                            shape, symmetry="symmetric")
    return str(path)


@pytest.fixture(scope="module")
def world(mtx_path):
    return spawn_ranks(L.solves, P, P, mtx_path, deadline=150.0)


@pytest.fixture(scope="module")
def jax_solves():
    jm = jpar.make_mesh(P)

    def sh(x):
        return jpar.shard_vector(jnp.asarray(x), jm)

    def jcoo(t):
        return JF.coo_from_arrays(*t, device=False)

    jd = JF.dia_from_coo(jcoo(_poisson()), device=False)
    op = jpar.HaloDiaOperator(jd, jm)
    b = sh(L.vectors(20, 512))
    out = {"cg": jcg(op, b, rtol=1e-10, store_history=True)}
    M = JDiagonal(jpar.replicate(jnp.full(512, 1 / 6.0), jm))
    out["cg_jacobi"] = jcg(op, b, M=M, rtol=1e-10, store_history=True)
    out["minres"] = jminres(op, b, rtol=1e-10, store_history=True)
    eye = JIdentity(512, dtype=np.float64)
    out["minres_indefinite"] = jminres(op - 0.5 * eye, b, rtol=1e-10,
                                       store_history=True)
    out["pipelined"] = jcg_pipelined(op + 2.0 * eye, b, rtol=1e-8,
                                     store_history=True)
    out["cg_batched"] = jcg_batched(op, sh(L.vectors(21, 512, 2)),
                                    rtol=1e-10)
    out["cg_verified"] = jcg(op, b, rtol=1e-10, replace_every=10)
    g = jpar.GatherEllOperator(jcoo(L.general_coo(3, 61, 61, True)), jm,
                               symmetric=True)
    out["cg_verified_gather"] = jcg(
        g, sh(L.padded(L.vectors(22, 61), g.nargout)), rtol=1e-10,
        atol=0.0, replace_every=10)
    r = jpar.GatherEllOperator(jcoo(L.general_coo(3, 45, 29)), jm)
    out["lsqr_gather"] = jlsqr(r, sh(L.padded(L.vectors(23, 45),
                                              r.nargout)),
                               atol=1e-10, btol=1e-10, store_history=True)
    t = jpar.TallSkinnyOperator(L.tall_dense(P), jm)
    out["lsqr_tall"] = jlsqr(t, sh(L.padded(L.vectors(24, 37 * P + 5),
                                            t.nargout)),
                             atol=1e-10, btol=1e-10, store_history=True)
    gb = jpar.GatherEllOperator(jcoo(L.general_coo(6, 70, 70)), jm)
    out["bicgstab_batched"] = jbicgstab_batched(
        gb, sh(L.padded(L.vectors(25, 70, 2), gb.nargout)), rtol=1e-10)
    return out


def _poisson():
    from pykrylov_tpu.gallery import poisson3d_coo
    return poisson3d_coo(8)


SINGLE = ["cg", "cg_jacobi", "minres", "minres_indefinite", "pipelined",
          "cg_verified", "cg_verified_gather", "lsqr_gather", "lsqr_tall"]


def _x(world, key):
    if key == "lsqr_tall":          # replicated: every rank holds all of x
        return world[0][key]["x"]
    return np.concatenate([w[key]["x"] for w in world])


@pytest.mark.parametrize("key", SINGLE)
def test_single_solves_match_jax(world, jax_solves, key):
    got, ref = world[0][key], jax_solves[key]
    assert got["n_iter"] == int(ref.n_iter)
    assert got["istop"] == int(ref.istop)
    assert got["n_matvec"] == int(ref.n_matvec)
    if "hist" in got:
        k = got["n_iter"] + 1
        jh = np.asarray(ref.resid_history)[:k]
        if key == "pipelined":
            # as tests/test_torch_pipelined.py holds them: the recurrences
            # carry rounding at the scale of ||r_0||
            np.testing.assert_allclose(got["hist"][:k], jh, rtol=0,
                                       atol=TOL * jh[0])
        else:
            np.testing.assert_allclose(got["hist"][:k], jh, rtol=TOL)
    xj = np.asarray(ref.x)
    np.testing.assert_allclose(_x(world, key), xj, rtol=0,
                               atol=TOL * np.abs(xj).max())


@pytest.mark.parametrize("key", ["cg_batched", "bicgstab_batched"])
def test_block_solves_match_jax(world, jax_solves, key):
    got, ref = world[0][key], jax_solves[key]
    assert got["n_iter"] == np.asarray(ref.n_iter).tolist()
    assert got["istop"] == np.asarray(ref.istop).tolist()
    xj = np.asarray(ref.x)
    np.testing.assert_allclose(_x(world, key), xj, rtol=0,
                               atol=TOL * np.abs(xj).max())


@pytest.mark.parametrize("key", SINGLE + ["cg_batched", "bicgstab_batched"])
def test_ranks_in_lockstep(world, key):
    # every global scalar is all-reduced: each rank read the same bits,
    # took the same branches and stopped at the same iteration
    first = world[0][key]
    for w in world[1:]:
        assert w[key]["n_iter"] == first["n_iter"]
        assert w[key]["istop"] == first["istop"]
        if "hist" in first:
            np.testing.assert_array_equal(w[key]["hist"], first["hist"])
    if key == "lsqr_tall":
        assert first["x_is_plain"]
        for w in world[1:]:
            np.testing.assert_array_equal(w[key]["x"], first["x"])


def test_partitioned_reader_builds_each_rank(world, mtx_path):
    # each rank kept its own rows of the file; the products equal the
    # slot mesh's operator built from the same file
    tm = par.make_mesh(P, device="cpu")
    ref = par.gather_ell_from_mtx(mtx_path, tm, symmetric=None)
    x = L.padded(L.vectors(26, 61), ref.nargin)
    y = (ref * par.shard_vector(x, tm)).numpy()
    np.testing.assert_allclose(np.concatenate([w["mtx_fwd"] for w in world]),
                               y, rtol=0, atol=1e-12 * np.abs(y).max())
    assert [w["mtx_rows"] for w in world] == [ref.nargout // P] * P
    parts, shape, _ = tmm.read_matrix_market_partitioned(mtx_path, P,
                                                         keep=2)
    assert len(parts) == 1 and shape == (61, 61)
    lrow = ref.nargout // P
    assert ((parts[0][1] >= 2 * lrow) & (parts[0][1] < 3 * lrow)).all()


def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        spawn_ranks(L.raise_on_rank_one, 3, timeout=30.0, deadline=60.0)
    assert time.monotonic() - t0 < 60.0


def test_one_rank_world_is_plain_arithmetic():
    # a one-rank world's all-reduces and rank-order combinations are the
    # identity: the solve is the unsharded one bit for bit
    outs = spawn_ranks(L.solves, 1, 1, deadline=120.0)
    tm = par.make_mesh(1, device="cpu")
    from pykrylov_tpu_torch.solvers import cg
    op = par.HaloDiaOperator(L.poisson_dia(8), tm)
    res = cg(op, par.shard_vector(L.vectors(20, 512), tm), rtol=1e-10,
             store_history=True)
    assert outs[0]["cg"]["n_iter"] == int(res.n_iter)
    np.testing.assert_array_equal(outs[0]["cg"]["x"], res.x.numpy())
    np.testing.assert_array_equal(outs[0]["cg"]["hist"],
                                  res.resid_history.numpy())
    assert torch.get_default_dtype() == torch.float32
