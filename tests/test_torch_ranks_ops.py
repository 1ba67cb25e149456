"""The sharded operators on a mesh of ranks: spawned gloo worlds of 2 and
4 CPU processes against the JAX package's sharded operators and the
port's mesh of slots at the same P, on the same numpy inputs.

Each world runs once per P (``tests/torch_rank_legs.py``, which imports
only the port) and returns every rank's rows; the parent assembles them
and holds each product to 1e-12 relative in f64 against the JAX operator
on ``tests/conftest.py``'s virtual devices and against the slot mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.gallery import poisson3d_coo as jpoisson3d_coo
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.linop import SparseOperator as JSparseOperator

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.parallel.launch import spawn_ranks
from pykrylov_tpu_torch.sparse import formats as TF
from pykrylov_tpu_torch.sparse.linop import SparseOperator

import torch_rank_legs as L

DEV = "cpu"
RTOL = 1e-12
PS = [2, 4]

jmul = jax.jit(lambda op, v: op * v)
jmul_t = jax.jit(lambda op, v: op.T * v)


def close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-300)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def worlds():
    """Every rank's results of :func:`torch_rank_legs.operator_products`
    for each P, one spawned world each."""
    return {P: spawn_ranks(L.operator_products, P, P, deadline=150.0)
            for P in PS}


def rows(worlds, P, key):
    """The ranks' rows of one result, assembled in rank order."""
    return np.concatenate([w[key] for w in worlds[P]])


def jcoo(t):
    return JF.coo_from_arrays(*t, device=False)


def jsh(x, jm):
    return jpar.shard_vector(jnp.asarray(x), jm)


@pytest.mark.parametrize("P", PS)
def test_mesh_of_ranks_info(worlds, P):
    for r, w in enumerate(worlds[P]):
        info = w["info"]
        assert info["process_index"] == r and info["process_count"] == P
        assert info["n_devices"] == P and info["shape"] == {"rows": P}
        assert info["transport"] == "host" and info["platform"] == "cpu"


@pytest.mark.parametrize("P", PS)
def test_halo_products(worlds, P):
    jm = jpar.make_mesh(P)
    jd = JF.dia_from_coo(jcoo(jpoisson3d_coo(8)), device=False)
    jo = jpar.HaloDiaOperator(jd, jm)
    tm = par.make_mesh(P, device=DEV)
    to = par.HaloDiaOperator(L.poisson_dia(8), tm, kernel=True)
    for key, x in (("halo_x", L.vectors(1, 512)),
                   ("halo_X", L.vectors(2, 512, 3))):
        got = rows(worlds, P, key)
        close(got, jmul(jo, jsh(x, jm)))
        close(got, to * par.shard_vector(x, tm))
    # this rank's rows alone build the same operator
    assert all(w["halo_local_equal"] for w in worlds[P])
    close(rows(worlds, P, "halo_b"), to * par.shard_vector(np.ones(512),
                                                           tm))


@pytest.mark.parametrize("name,shape", [("sq", (61, 61)),
                                        ("rect", (45, 29))])
@pytest.mark.parametrize("P", PS)
def test_gather_ell_products(worlds, P, name, shape):
    m, n = shape
    coo = L.general_coo(3, m, n)
    jm = jpar.make_mesh(P)
    jo = jpar.GatherEllOperator(jcoo(coo), jm)
    to = par.GatherEllOperator(TF.coo_from_arrays(*coo, device=None),
                               par.make_mesh(P, device=DEV))
    xn = L.padded(L.vectors(4, n), jo.nargin)
    um = L.padded(L.vectors(5, m), jo.nargout)
    fwd = rows(worlds, P, "ell_%s_fwd" % name)
    bwd = rows(worlds, P, "ell_%s_bwd" % name)
    close(fwd, jmul(jo, jsh(xn, jm)))
    close(bwd, jmul_t(jo, jsh(um, jm)))
    close(fwd, to * par.shard_vector(xn, to.mesh))
    close(bwd, to.T * par.shard_vector(um, to.mesh))
    # the schedule's traffic, counted from each rank's rows alone
    for w in worlds[P]:
        assert w["ell_%s_attrs" % name].tolist() == [
            jo.comm_entries_per_matvec, jo.comm_entries_true,
            jo.allgather_entries_per_matvec]


@pytest.mark.parametrize("key", ["bell_fwd", "bell_bwd", "bell_fwd_K",
                                 "bell_bwd_K"])
@pytest.mark.parametrize("P", PS)
def test_gather_bell_products(worlds, P, key):
    coo = L.general_coo(6, 70, 70)
    jm = jpar.make_mesh(P)
    jo = jpar.GatherEllOperator(jcoo(coo), jm)
    to = par.GatherBellOperator(TF.coo_from_arrays(*coo, device=None),
                                par.make_mesh(P, device=DEV),
                                with_transpose=True)
    x = L.padded(L.vectors(8, 70, 3) if key.endswith("K")
                 else L.vectors(7, 70), to.nargin)
    got = rows(worlds, P, key)
    if "fwd" in key:
        close(got, to * par.shard_vector(x, to.mesh))
        ref = np.stack([np.asarray(jmul(jo, jsh(x[:, k], jm)))
                        for k in range(3)], 1) if x.ndim == 2 \
            else jmul(jo, jsh(x, jm))
    else:
        close(got, to.T * par.shard_vector(x, to.mesh))
        ref = np.stack([np.asarray(jmul_t(jo, jsh(x[:, k], jm)))
                        for k in range(3)], 1) if x.ndim == 2 \
            else jmul_t(jo, jsh(x, jm))
    close(got, ref)
    assert all(w["bell_slots"][0] == to.slots_per_device
               for w in worlds[P])


@pytest.mark.parametrize("name", ["dense", "ell"])
@pytest.mark.parametrize("P", PS)
def test_tall_products(worlds, P, name):
    a = L.tall_dense(P)
    jm = jpar.make_mesh(P)
    jsrc = a if name == "dense" else jcoo(
        (a[np.nonzero(a)],) + np.nonzero(a) + (a.shape,))
    jo = jpar.TallSkinnyOperator(jsrc, jm)
    to = par.TallSkinnyOperator(a, par.make_mesh(P, device=DEV))
    x = L.vectors(9, 9)
    u = L.padded(L.vectors(10, a.shape[0]), jo.nargout)
    close(rows(worlds, P, "tall_%s_fwd" % name), jmul(jo, jnp.asarray(x)))
    # A^T u is on every rank whole, the same bits on every rank, and the
    # slot mesh's shard-order sum bit for bit
    bwd = [w["tall_%s_bwd" % name] for w in worlds[P]]
    assert all(np.array_equal(b, bwd[0]) for b in bwd)
    close(bwd[0], jmul_t(jo, jsh(u, jm)))
    if name == "dense":
        np.testing.assert_array_equal(
            bwd[0], (to.T * par.shard_vector(u, to.mesh)).numpy())


@pytest.mark.parametrize("P", PS)
def test_mesh2d_and_stencil_products(worlds, P):
    jm2 = jpar.make_mesh2d(2, P // 2)
    jo2 = jpar.Halo2DPoissonOperator(8, jm2, dtype=jnp.float64)
    x = L.vectors(11, 512)
    close(rows(worlds, P, "mesh2d"),
          jmul(jo2, jpar.shard_vector_2d(jnp.asarray(x), jm2)))
    tm2 = par.make_mesh2d(2, P // 2, device=DEV)
    to2 = par.Halo2DPoissonOperator(8, tm2, dtype=torch.float64)
    close(rows(worlds, P, "mesh2d"), to2 * par.shard_vector_2d(x, tm2))
    jm = jpar.make_mesh(P)
    jst = jpar.HaloStencilPoisson3DOperator(8, jm, dtype=jnp.float64)
    for key, v in (("stencil_x", L.vectors(1, 512)),
                   ("stencil_X", L.vectors(2, 512, 3))):
        close(rows(worlds, P, key), jmul(jst, jsh(v, jm)))


@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("P", PS)
def test_generic_sharded_products(worlds, P, fmt):
    if fmt == "ell":
        coo = L.general_coo(12, 61, 61)
    else:
        coo = jpoisson3d_coo(4)
    jbuild = {"dia": JF.dia_from_coo, "ell": JF.ell_from_coo}[fmt]
    jop = JSparseOperator(jbuild(jcoo(coo), device=False), None,
                          symmetric=True)
    jm = jpar.make_mesh(P)
    js, jpad = jpar.shard_operator(jop, jm)
    x = L.padded(L.vectors(13, coo[3][0]), coo[3][0] + jpad)
    close(rows(worlds, P, "generic_%s" % fmt), jmul(js, jsh(x, jm)))
    build = {"dia": TF.dia_from_coo, "ell": TF.ell_from_coo}[fmt]
    top = SparseOperator(build(TF.coo_from_arrays(*coo, device=None),
                               device=DEV), None, symmetric=True)
    ts, tpad = par.shard_operator(top, par.make_mesh(P, device=DEV))
    assert tpad == jpad
    close(rows(worlds, P, "generic_%s" % fmt),
          ts * par.shard_vector(x, ts.mesh))


# -- the net: no partial reduction of a rank shard reaches the host ---------

REDUCTIONS = {
    "sum": lambda v, M: v.sum(),
    "torch.sum dim 0": lambda v, M: torch.sum(M, 0),
    "mean": lambda v, M: v.mean(),
    "vdot": lambda v, M: torch.vdot(v, v),
    "dot": lambda v, M: torch.dot(v, v),
    "vector_norm": lambda v, M: torch.linalg.vector_norm(v),
    "norm": lambda v, M: v.norm(),
    "column norms": lambda v, M: torch.linalg.vector_norm(M, dim=0),
    "vecdot": lambda v, M: torch.linalg.vecdot(M, M, dim=0),
    "any": lambda v, M: (v > 0).any(),
    "all": lambda v, M: torch.isfinite(v).all(),
    "max": lambda v, M: v.max(),
    "matmul contracting the rows": lambda v, M: M.T @ M,
    "vector @ vector": lambda v, M: v @ v,
}


@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_row_reductions_of_a_rank_shard_raise(name):
    from pykrylov_tpu_torch.utils import ranks
    v = ranks.shard(torch.arange(6.0))
    M = ranks.shard(torch.ones(6, 2))
    with pytest.raises(ranks.RowReductionError):
        REDUCTIONS[name](v, M)


def test_row_local_work_of_a_rank_shard_stays_marked():
    from pykrylov_tpu_torch.utils import ranks
    v = ranks.shard(torch.arange(6.0))
    M = ranks.shard(torch.ones(6, 2))
    for t in (2 * v + 1, torch.where(v > 2, v, 0.0), M.sum(1),
              torch.linalg.vector_norm(M, dim=1), M @ torch.ones(2, 2),
              torch.maximum(v, v), torch.zeros_like(v), v[1:3]):
        assert isinstance(t, ranks.RankShard)
    # the helpers strip the mark: a global reduction is a plain tensor
    assert ranks.plain(v).sum().item() == 15.0
    assert not isinstance(ranks.plain(v), ranks.RankShard)
