"""The port's host builders, containers, sparse operators, I/O and gallery
against the JAX package's.

The builders run the same NumPy algorithms on the same triples, so their
containers must agree exactly; the float64 products differ only in
summation order and are compared to 1e-12 relative."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.gallery as jgal
import pykrylov_tpu.io as jio
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse import jacobi_preconditioner as \
    jax_jacobi_preconditioner
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo

import pykrylov_tpu_torch.gallery as tgal
import pykrylov_tpu_torch.io as tio
from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import (jacobi_preconditioner,
                                       operator_from_coo, sparse_operator)

DEV = "cpu"  # the port's entry points default to the card


def random_coo(rng, m, n, density=0.05):
    """Random triples, duplicates included."""
    nnz = int(m * n * density)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    return rng.standard_normal(nnz), rows, cols, (m, n)


def assert_same_container(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for name in type(port)._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if name in ("shape", "offsets"):
            assert tuple(a) == tuple(b), name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("kind", ["coo", "csr", "ell", "transpose"])
def test_builders_match(kind, rng):
    vals, rows, cols, shape = random_coo(rng, 40, 30)
    t = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    j = JF.coo_from_arrays(vals, rows, cols, shape, device=False)
    if kind == "csr":
        t, j = F.csr_from_coo(t, device=None), JF.csr_from_coo(j,
                                                               device=False)
    elif kind == "ell":
        t = F.ell_from_coo(t, pad_to=4, device=None)
        j = JF.ell_from_coo(j, pad_to=4, device=False)
    elif kind == "transpose":
        t, j = F.transpose_coo(t), JF.transpose_coo(j, device=False)
    assert_same_container(t, j)


def test_dia_builder_matches_and_accumulates_duplicates(rng):
    m = 50
    i = rng.integers(0, m - 3, 400)
    off = rng.choice([0, 1, 3], 400)
    vals = rng.standard_normal(400)
    t = F.dia_from_coo(F.coo_from_arrays(vals, i, i + off, (m, m),
                                         device=None), device=None)
    j = JF.dia_from_coo(JF.coo_from_arrays(vals, i, i + off, (m, m),
                                           device=False), device=False)
    assert t.offsets == j.offsets
    # duplicates are summed in a different order (float64 bincount)
    np.testing.assert_allclose(t.data, np.asarray(j.data), rtol=1e-13,
                               atol=1e-15)
    vals, rows, cols, shape = jgal.poisson3d_coo(6)
    assert_same_container(
        F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                         device=None), device=None),
        JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape,
                                           device=False), device=False))
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    assert F.bandwidth_profile(coo) == JF.bandwidth_profile(coo)


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "dia"])
def test_container_products_match(fmt, rng):
    vals, rows, cols, shape = random_coo(rng, 40, 30)
    if fmt == "dia":
        vals, rows, cols, shape = jgal.poisson2d_coo(7)
    jc = JF.coo_from_arrays(vals, rows, cols, shape)
    build = {"coo": lambda c: c, "csr": JF.csr_from_coo,
             "ell": JF.ell_from_coo, "dia": JF.dia_from_coo}[fmt]
    jc = build(jc)
    tc = convert.from_numpy(jc, device=DEV)
    x = rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0])
    mv = {"coo": (F.coo_matvec, JF.coo_matvec, F.coo_rmatvec,
                  JF.coo_rmatvec),
          "csr": (F.csr_matvec, JF.csr_matvec, F.csr_rmatvec,
                  JF.csr_rmatvec),
          "ell": (F.ell_matvec, JF.ell_matvec, None, None),
          "dia": (F.dia_matvec, JF.dia_matvec, F.dia_rmatvec,
                  JF.dia_rmatvec)}[fmt]
    np.testing.assert_allclose(mv[0](tc, torch.from_numpy(x)).numpy(),
                               np.asarray(mv[1](jc, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    if mv[2] is not None:
        np.testing.assert_allclose(mv[2](tc, torch.from_numpy(y)).numpy(),
                                   np.asarray(mv[3](jc, jnp.asarray(y))),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(F.to_dense(tc).numpy(),
                                  np.asarray(JF.to_dense(jc)))


@pytest.mark.parametrize("fmt", ["dia", "cuda-dia", "ell", "csr", "coo"])
def test_operator_from_coo_matches(fmt, rng):
    # unsymmetric banded matrix: every format, forward and transpose
    m = 60
    i = np.arange(m)
    rows = np.concatenate([i, i[:-2], i[5:]])
    cols = np.concatenate([i, i[:-2] + 2, i[5:] - 5])
    vals = rng.standard_normal(len(rows))
    t = operator_from_coo(vals, rows, cols, (m, m), fmt=fmt, device=DEV)
    j = jax_operator_from_coo(vals, rows, cols, (m, m),
                              fmt="dia" if fmt == "cuda-dia" else fmt)
    assert t.fmt == fmt and t.shape == j.shape and t.dtype == torch.float64
    x = rng.standard_normal(m)
    for tt, jj in ((t, j), (t.T, j.T)):
        np.testing.assert_allclose((tt * torch.from_numpy(x)).numpy(),
                                   np.asarray(jj * jnp.asarray(x)),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown format"):
        operator_from_coo(vals, rows, cols, (m, m), fmt="dense", device=DEV)


def test_sparse_operator_sources_and_jacobi(rng):
    A = rng.standard_normal((12, 12))
    A[np.abs(A) < 0.8] = 0.0
    x = torch.from_numpy(rng.standard_normal(12))
    for src in (A, torch.from_numpy(A)):
        np.testing.assert_allclose((sparse_operator(src, device=DEV)
                                    * x).numpy(),
                                   A @ x.numpy(), rtol=1e-12, atol=1e-12)
    op = sparse_operator("1138bus", symmetric=True, device=DEV)
    assert op.shape == (1138, 1138) and op.fmt == "ell"
    t = jacobi_preconditioner("1138bus", device=DEV)
    j = jax_jacobi_preconditioner("1138bus")
    np.testing.assert_array_equal(t.diag.numpy(), np.asarray(j.diag))


def test_io_and_gallery_match(tmp_path):
    for name in ("1138bus", "jpwh_991", "GD97_b"):
        for a, b in zip(tio.load_bundled(name), jio.load_bundled(name)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = os.path.join(tmp_path, "m.mtx")
    vals = np.array([4.0, -1.0, 2.5])
    jio.write_matrix_market(path, vals, np.array([0, 1, 2]),
                            np.array([0, 0, 1]), (3, 3),
                            symmetry="symmetric")
    for a, b in zip(tio.read_matrix_market(path)[:4],
                    jio.read_matrix_market(path)[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for fn in ("poisson1d_coo", "poisson2d_coo", "poisson3d_coo"):
        for a, b in zip(getattr(tgal, fn)(5), getattr(jgal, fn)(5)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tgal.poisson_eigenvalue_bounds(7, 3) == \
        jgal.poisson_eigenvalue_bounds(7, 3)


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_port_writer_round_trips_through_both_readers(tmp_path, rng,
                                                      symmetry):
    # the port's writer, read back by the port's reader (native where its
    # library builds) and by the JAX package's
    vals, rows, cols, shape = random_coo(rng, 40, 40, density=0.1)
    if symmetry == "symmetric":
        low = rows >= cols
        vals, rows, cols = vals[low], rows[low], cols[low]
    path = os.path.join(tmp_path, "w.mtx")
    tio.write_matrix_market(path, vals, rows, cols, shape,
                            symmetry=symmetry)
    port = tio.read_matrix_market(path)
    ref = jio.read_matrix_market(path)
    for a, b in zip(port[:3], ref[:3]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port[3] == ref[3] == shape
    n_stored = len(vals)
    assert port[4].nnz_stored == ref[4].nnz_stored == n_stored
    np.testing.assert_array_equal(port[0][:n_stored], vals)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_matrix_free_poisson_matches(dim, rng):
    n = {1: 30, 2: 6, 3: 4}[dim]
    t = getattr(tgal, "poisson%dd_operator" % dim)(n, dtype=torch.float64,
                                                   device=DEV)
    j = getattr(jgal, "poisson%dd_operator" % dim)(n, dtype=np.float64)
    x = rng.standard_normal(t.shape[0])
    np.testing.assert_allclose((t * torch.from_numpy(x)).numpy(),
                               np.asarray(j * jnp.asarray(x)), rtol=1e-14)
