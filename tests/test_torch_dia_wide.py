"""The DIA path past 64 diagonals on the CPU, against the JAX package.

Since the kernels take up to 4096 diagonals, ``operator_from_coo`` takes
the JAX package's ``max_diags`` and ``dia_density_threshold``, and
``HaloDiaOperator`` takes any number of diagonals.  Held here on the
Galerkin Laplacian of quadratic B-splines on an n^3 grid (125 diagonals;
``chip_smoke.bspline_coo``, the matrix of the smoke's phase 22), on a
65-diagonal SPD band and on a 200-diagonal unsymmetric band:

* ``operator_from_coo`` picks the JAX package's format at every
  ``max_diags``, with the same products and the same CG or BiCGSTAB
  iterations, stop codes and residual histories;
* the wrappers' plain versions (what they run on CPU tensors) against the
  JAX Pallas SpMV and SpMM kernels in interpret mode;
* ``HaloDiaOperator`` against the JAX one on 1, 2 and 4 shards, and bit
  for bit against the unsharded plain product;
* ``dia_transpose`` against ``formats.dia_rmatvec`` and the dense
  transpose with repeated offsets and offsets past the matrix.

Tolerances: 1e-12 relative (max norm) in float64 where only the summation
order differs; histories to 1e-9 (and 1e-12 of ||r_0||) and x to 1e-10,
as ``tests/test_torch_cg.py`` holds CG.  The CUDA kernels themselves run only
on the card (``chip_smoke.py`` phase 22, ``tests/test_torch_dia_card.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.solvers import bicgstab as jbicgstab
from pykrylov_tpu.solvers import cg as jcg
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo
from pykrylov_tpu.sparse.kernels import (dia_matmat_packed, ensure_dia_padded,
                                         pack_dia)
from pykrylov_tpu.sparse.kernels import dia_transpose as jax_dia_transpose

import chip_smoke
import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.solvers import bicgstab, cg
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo

from test_torch_dia import pallas, rel
from test_torch_dia_plan import OFFSET_SETS

DEV = "cpu"  # the port's entry points default to the card

jmul = jax.jit(lambda op, v: op * v)


def band(m, offsets, symmetric, seed):
    """COO triples of a diagonally dominant band on ``offsets`` (with 0),
    every in-range slot nonzero; mirrored when ``symmetric``."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for off in offsets:
        i = np.arange(max(0, -off), min(m, m - off))
        d[i, i + off] = rng.uniform(-1.0, 1.0, len(i))
    if symmetric:
        d = np.triu(d, 1)
        d = d + d.T
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(axis=1) + 1.0
    rows, cols = np.nonzero(d)
    return d[rows, cols], rows, cols, (m, m)


MATRICES = {
    "bspline6": lambda: chip_smoke.bspline_coo(6),
    "bspline7": lambda: chip_smoke.bspline_coo(7),
    "bspline8": lambda: chip_smoke.bspline_coo(8),
    "band65": lambda: band(300, range(-32, 33), True, 65),
    "band200": lambda: band(400, range(-100, 100), False, 200),
}


@pytest.mark.parametrize("name,max_diags,fmt", [
    ("bspline6", 128, "dia"), ("bspline7", 128, "dia"),
    ("bspline8", 128, "dia"), ("bspline8", 64, "ell"),
    ("band65", 128, "dia"), ("band65", 64, "ell"),
    ("band200", 128, "ell"), ("band200", 256, "dia")])
def test_operator_from_coo_matches_jax(name, max_diags, fmt):
    vals, rows, cols, shape = MATRICES[name]()
    symmetric = name != "band200"
    A = operator_from_coo(vals, rows, cols, shape, symmetric=symmetric,
                          max_diags=max_diags, device=DEV)
    jA = jax_operator_from_coo(vals, rows, cols, shape, symmetric=symmetric,
                               max_diags=max_diags)
    assert A.fmt == fmt == type(jA.container).__name__.lower()
    if fmt == "dia":
        assert len(A.container.offsets) == len(jA.container.offsets) > 64
    rng = np.random.default_rng(len(vals))
    x = rng.standard_normal(shape[0])
    assert rel(A * torch.from_numpy(x), jA * jnp.asarray(x)) <= 1e-12
    assert rel(A.T * torch.from_numpy(x), jA.T * jnp.asarray(x)) <= 1e-12
    b = np.array(jA * jnp.asarray(rng.standard_normal(shape[0])))
    solver, jsolver = (cg, jcg) if symmetric else (bicgstab, jbicgstab)
    t = solver(A, torch.from_numpy(b), rtol=1e-10, store_history=True)
    j = jsolver(jA, jnp.asarray(b), rtol=1e-10, store_history=True)
    assert int(t.istop) == int(j.istop) == 0 and bool(t.converged)
    assert int(t.n_iter) == int(j.n_iter)
    assert int(t.n_matvec) == int(j.n_matvec)
    # histories at the scale of ||r_0||: BiCGSTAB's last residuals, near
    # 1e-10 of it, carry the sums' rounding
    jh = np.asarray(j.history())
    np.testing.assert_allclose(t.history(), jh, rtol=1e-9, atol=1e-12 * jh[0])
    assert rel(t.x, j.x) <= 1e-10


def test_wide_route_on_the_card_policy():
    # the JAX package's route, answered for a CUDA device: 125 diagonals
    # at 65,536 rows or more take the kernels when max_diags admits them
    from pykrylov_tpu_torch.sparse.linop import KERNEL_MIN_ROWS, auto_format
    n = chip_smoke.BS_ROUTE_N
    assert n ** 3 >= KERNEL_MIN_ROWS
    coo = F.coo_from_arrays(*chip_smoke.bspline_coo(8), device=None)
    ndiag, density = F.bandwidth_profile(coo)
    assert ndiag == 125 and density >= 0.25
    shape = (n ** 3, n ** 3)
    assert auto_format(ndiag, density, shape, "cuda", 128) == "cuda-dia"
    assert auto_format(ndiag, density, shape, "cpu", 128) == "dia"
    assert auto_format(ndiag, density, shape, "cuda") == "ell"


def _container(name):
    """A host DIA container of the JAX package and the port's copy."""
    vals, rows, cols, shape = MATRICES[name]()
    if name == "band65":      # a 216-row band: every offset within a block
        vals, rows, cols, shape = band(216, range(-32, 33), True, 7)
    jdia = JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape,
                                              device=False), device=False)
    return jdia, convert.from_numpy(jdia, device=DEV)


@pytest.mark.parametrize("name", ["band65", "bspline6"])
def test_wide_plain_matches_pallas(name):
    # at n = 6 the widest offset (2 * 36 + 2 * 6 + 2 = 86) fits a 128-row
    # block, the Pallas kernels' halo
    jdia, dia = _container(name)
    m = dia.shape[0]
    assert len(dia.offsets) in (65, 125)
    rng = np.random.default_rng(m)
    x = rng.standard_normal(m)
    y = K.dia_matvec(dia.data, dia.offsets, torch.from_numpy(x))
    assert rel(y, pallas(jdia, x, 128)) <= 1e-12
    assert rel(y, JF.dia_matvec(jdia, jnp.asarray(x))) <= 1e-12
    X = rng.standard_normal((m, 2))
    dia_p, _ = ensure_dia_padded(jdia, block=128)
    d3, offs = pack_dia(dia_p, 128)
    Xp = np.zeros((dia_p.shape[0], 2))
    Xp[:m] = X
    ref = np.asarray(dia_matmat_packed(d3, offs, jnp.asarray(Xp), block=128,
                                       interpret=True))[:m]
    Y = K.dia_matmat(dia.data, dia.offsets, torch.from_numpy(X))
    assert rel(Y, ref) <= 1e-12
    for k in range(2):          # a column is the plain SpMV, bit for bit
        assert torch.equal(Y[:, k], K.dia_matvec_plain(
            dia.data, dia.offsets, torch.from_numpy(X[:, k])))


def _halo_dia(name):
    if name == "band65":
        vals, rows, cols, shape = band(256, range(-32, 33), True, 3)
    else:                     # halo width 222 fits 250 rows a shard at P=4
        vals, rows, cols, shape = chip_smoke.bspline_coo(10)
    jd = JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape,
                                            device=False), device=False)
    td = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                          device=None), device=DEV)
    return jd, td


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name", ["band65", "bspline10"])
def test_halo_wide_matches_jax(name, P):
    jd, td = _halo_dia(name)
    m = td.shape[0]
    jm, tm = jpar.make_mesh(P), par.make_mesh(P, device=DEV)
    jo = jpar.HaloDiaOperator(jd, jm, kernel=False)
    to = par.HaloDiaOperator(td, tm)
    assert (to.pad, to.halo_width, to.offsets) == (
        jo.pad, jo.halo_width, jo.offsets)
    assert len(to.offsets) in (65, 125)
    rng = np.random.default_rng(P)
    for shape in [(), (3,)]:
        x = rng.standard_normal((m + to.pad,) + shape)
        x[m:] = 0.0
        yt = to * par.shard_vector(x, tm)
        yj = np.asarray(jmul(jo, jpar.shard_vector(jnp.asarray(x), jm)))
        assert rel(yt, yj) <= 1e-12
        # each shard's product is the unsharded plain product's rows
        xt = torch.from_numpy(x[:m])
        ref = (K.dia_matvec_plain(td.data, td.offsets, xt) if not shape
               else K.dia_matmat_plain(td.data, td.offsets, xt))
        assert torch.equal(yt[:m], ref)
    if P == 2:
        xs = rng.standard_normal(m + to.pad)
        xs[m:] = 0.0
        b = to * par.shard_vector(xs, tm)
        t = cg(to, b, rtol=1e-10)
        j = jcg(jo, jpar.shard_vector(jnp.asarray(b.numpy()), jm),
                rtol=1e-10)
        assert int(t.n_iter) == int(j.n_iter) and int(t.istop) == 0
        assert rel(t.x, j.x) <= 1e-10


TRANSPOSE_CASES = {       # (m, offsets)
    "unsorted with duplicates": (12, OFFSET_SETS["unsorted with duplicates"]),
    "repeated diagonal": (6, (0, 1, 1)),
    "past the matrix": (6, (-9, 0, 2, 6, -6, 11)),
    "wide, repeated": (40, tuple(range(-39, 40)) + (5, -7, 5)),
}


@pytest.mark.parametrize("name", sorted(TRANSPOSE_CASES))
def test_dia_transpose_repeated_and_past_offsets(name):
    m, offsets = TRANSPOSE_CASES[name]
    rng = np.random.default_rng(m + len(offsets))
    data = torch.from_numpy(rng.standard_normal((len(offsets), m)))
    for k, off in enumerate(offsets):     # zero outside the matrix
        i = torch.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    a = F.DIA(data, offsets, (m, m))
    t = K.dia_transpose(a)
    # one output diagonal an input one; the JAX package's sorted offsets
    assert t.offsets == tuple(sorted(-o for o in offsets))
    assert t.data.shape == (len(offsets), m)
    dense = F.to_dense(a)
    torch.testing.assert_close(F.to_dense(t), dense.T, rtol=1e-15, atol=0)
    x = torch.from_numpy(rng.standard_normal(m))
    ref = dense.T @ x
    for y in (F.dia_matvec(t, x), F.dia_rmatvec(a, x),
              K.cuda_dia_operator(a, symmetric=False).T * x):
        assert rel(y, ref.numpy()) <= 1e-12
    assert rel(F.dia_matvec(t, x), F.dia_rmatvec(a, x).numpy()) <= 1e-12


def test_dia_transpose_wide_unsymmetric_matches_jax():
    # the B-spline Laplacian plus a first derivative along x: 125 distinct
    # diagonals, unsymmetric values; the JAX package's transpose agrees
    # exactly where offsets are distinct
    a = chip_smoke.bspline_dia(6, torch.float64, DEV, drift=6.0)
    dense = F.to_dense(a)
    assert len(a.offsets) == 125 and not torch.equal(dense, dense.T)
    t = K.dia_transpose(a)
    jt = jax_dia_transpose(JF.DIA(jnp.asarray(a.data.numpy()), a.offsets,
                                  a.shape))
    assert t.offsets == jt.offsets
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jt.data))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(216))
    op = K.cuda_dia_operator(a, symmetric=False)
    assert rel(op.T * x, (dense.T @ x).numpy()) <= 1e-12
    assert rel(op.T * x, F.dia_rmatvec(a, x).numpy()) <= 1e-12
    assert rel(op * x, (dense @ x).numpy()) <= 1e-12
