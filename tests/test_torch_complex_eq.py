"""The port's real-equivalent complex solves against the JAX package's
(the cases of tests/test_complex_eq.py).

The packing and the real-equivalent matrices are NumPy in both packages
and must be equal array for array; the solves run the same real solvers
on the same f64 real systems, so counts agree exactly and the complex
solutions to 1e-8 relative (``XTOL``).  A large enough COO source goes
through ``sparse_operator``'s auto policy, as on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
from pykrylov_tpu.solvers import (bicgstab as j_bicgstab, cg as j_cg,
                                  cg_batched as j_cg_batched,
                                  lsmr as j_lsmr, lsqr as j_lsqr,
                                  minres as j_minres)

from pykrylov_tpu_torch.ops import (MatrixOperator, complex_solve,
                                    pack_complex, real_equivalent_coo,
                                    real_equivalent_dense,
                                    real_equivalent_operator,
                                    unpack_complex)
from pykrylov_tpu_torch.solvers import (bicgstab, cg, cg_batched, lsmr,
                                        lsqr, minres)
from pykrylov_tpu_torch.sparse.formats import (bandwidth_profile,
                                               coo_from_arrays)
from pykrylov_tpu_torch.sparse.linop import auto_format

DEV = "cpu"  # the port's entry points default to the card
XTOL = 1e-8


def _hermitian_pd(n=60, seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n))
                     + 1j * rng.standard_normal((n, n)))[0]
    lam = np.logspace(0, np.log10(cond), n)
    a = (Q * lam) @ Q.conj().T
    return (a + a.conj().T) / 2


def _general_complex(n=50, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return a + 3 * n ** 0.5 * np.eye(n)


def rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / np.abs(ref).max()


def test_pack_unpack_match_jax_and_keep_tensors():
    rng = np.random.default_rng(2)
    z = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    Z = rng.standard_normal((10, 4)) + 1j * rng.standard_normal((10, 4))
    for v in (z, Z, z.real):
        np.testing.assert_array_equal(pack_complex(v),
                                      jops.pack_complex(v))
        t = pack_complex(torch.from_numpy(v))
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), jops.pack_complex(v))
    x = pack_complex(z)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(z),
                               rtol=1e-14)
    np.testing.assert_array_equal(unpack_complex(x), jops.unpack_complex(x))
    t = unpack_complex(torch.from_numpy(x))
    assert t.dtype == torch.complex128
    np.testing.assert_array_equal(t.numpy(), z)
    with pytest.raises(ValueError):
        unpack_complex(np.zeros(7))
    with pytest.raises(ValueError):
        unpack_complex(torch.zeros(7))


def test_unpack_dtype_pairing():
    for dt in (np.float64, np.float32, np.float16):
        assert unpack_complex(np.zeros(8, dt)).dtype == \
            jops.unpack_complex(np.zeros(8, dt)).dtype
    assert unpack_complex(torch.zeros(8)).dtype == torch.complex64
    assert unpack_complex(torch.zeros(8, dtype=torch.bfloat16)).dtype == \
        torch.complex64


def test_real_equivalent_arrays_match_jax():
    a = _general_complex(17)
    np.testing.assert_array_equal(real_equivalent_dense(a),
                                  jops.real_equivalent_dense(a))
    rows, cols = np.array([0, 1, 2]), np.array([1, 2, 0])
    for vals in (np.array([1.0 + 0j, 2.0, 3.0]),
                 np.array([1.0, 2.0j, 3.0 + 4.0j])):
        for port, ref in zip(real_equivalent_coo(vals, rows, cols, (3, 3)),
                             jops.real_equivalent_coo(vals, rows, cols,
                                                      (3, 3))):
            np.testing.assert_array_equal(port, ref)
    v2, *_ = real_equivalent_coo(np.array([1.0 + 0j, 2.0, 3.0]), rows,
                                 cols, (3, 3))
    assert len(v2) == 6                     # a real matrix packs to 2x nnz


def test_hermitian_cg_matches_jax():
    a = _hermitian_pd(60)
    rng = np.random.default_rng(4)
    zstar = rng.standard_normal(60) + 1j * rng.standard_normal(60)
    b = a @ zstar
    op = real_equivalent_operator(a, hermitian=True, device=DEV)
    jop = jops.real_equivalent_operator(a, hermitian=True)
    assert op.symmetric and op.shape == (120, 120)
    assert (op.m_complex, op.n_complex) == (60, 60)
    res = complex_solve(cg, op, b, rtol=1e-10)
    jres = jops.complex_solve(j_cg, jop, b, rtol=1e-10)
    assert isinstance(res.x, torch.Tensor)
    assert res.x.dtype == torch.complex128
    assert int(res.n_iter) == int(jres.n_iter)
    assert rel(res.x.numpy(), jres.x) <= XTOL
    np.testing.assert_allclose(float(res.resid_norm),
                               np.linalg.norm(b - a @ res.x.numpy()),
                               rtol=1e-6, atol=1e-12)
    # the same solve with b as a tensor
    again = complex_solve(cg, op, torch.from_numpy(b), rtol=1e-10)
    assert torch.equal(again.x, res.x)


def test_hermitian_indefinite_minres():
    a = _hermitian_pd(40, seed=5) - 3.0 * np.eye(40)
    rng = np.random.default_rng(6)
    b = a @ (rng.standard_normal(40) + 1j * rng.standard_normal(40))
    op = real_equivalent_operator(a, hermitian=True, device=DEV)
    res = complex_solve(minres, op, b, rtol=1e-12, etol=0.0)
    jres = jops.complex_solve(
        j_minres, jops.real_equivalent_operator(a, hermitian=True), b,
        rtol=1e-12, etol=0.0)
    # each eigenvalue doubled: the Lanczos vectors lose orthogonality well
    # before the 40 steps of exact arithmetic, and the two packages' counts
    # part by one; both reach the residual
    assert bool(res.converged) and bool(jres.converged)
    for x in (res.x.numpy(), np.asarray(jres.x)):
        assert np.linalg.norm(b - a @ x) <= 1e-8 * np.linalg.norm(b)


def test_general_complex_bicgstab_and_x0():
    a = _general_complex(50)
    rng = np.random.default_rng(7)
    zstar = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    b = a @ zstar
    x0 = zstar + 0.1 * (rng.standard_normal(50)
                        + 1j * rng.standard_normal(50))
    res = complex_solve(bicgstab, a, b, x0=x0, rtol=1e-10, device=DEV)
    jres = jops.complex_solve(j_bicgstab, a, b, x0=x0, rtol=1e-10)
    assert bool(res.converged)
    assert int(res.n_iter) == int(jres.n_iter)
    assert rel(res.x.numpy(), jres.x) <= XTOL
    np.testing.assert_allclose(res.x.numpy(), zstar, rtol=1e-5)


@pytest.mark.parametrize("name", ["lsqr", "lsmr"])
def test_complex_least_squares(name):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((80, 30)) + 1j * rng.standard_normal((80, 30))
    b = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    zstar = np.linalg.lstsq(a, b, rcond=None)[0]
    op = real_equivalent_operator(a, device=DEV)
    assert op.shape == (160, 60)
    solver, jsolver = {"lsqr": (lsqr, j_lsqr), "lsmr": (lsmr, j_lsmr)}[name]
    res = complex_solve(solver, op, b, atol=1e-12, btol=1e-12)
    jres = jops.complex_solve(jsolver, jops.real_equivalent_operator(a), b,
                              atol=1e-12, btol=1e-12)
    assert int(res.n_iter) == int(jres.n_iter)
    np.testing.assert_allclose(res.x.numpy(), zstar, rtol=1e-6, atol=1e-9)


def test_complex_batched_block():
    a = _hermitian_pd(40, seed=9)
    rng = np.random.default_rng(10)
    Z = rng.standard_normal((40, 3)) + 1j * rng.standard_normal((40, 3))
    B = a @ Z
    op = real_equivalent_operator(a, hermitian=True, device=DEV)
    res = complex_solve(cg_batched, op, B, rtol=1e-10)
    jres = jops.complex_solve(
        j_cg_batched, jops.real_equivalent_operator(a, hermitian=True), B,
        rtol=1e-10)
    assert res.x.shape == (40, 3) and res.x.dtype == torch.complex128
    assert bool(res.converged.all())
    # the batched CG's columns within 10% of the JAX package's, the bound
    # tests/test_torch_batched.py holds cg_batched to
    for k, jk in zip(res.info["n_iter_columns"].tolist(),
                     np.asarray(jres.info["n_iter_columns"]).tolist()):
        assert abs(k - jk) <= 0.1 * jk
    np.testing.assert_allclose(res.x.numpy(), Z, rtol=1e-5)


def _shifted_poisson_hermitian(n, shift=1.0, skew=0.4):
    """3-D Poisson on an n^3 grid plus ``shift`` I plus i times a real
    skew-symmetric first difference along x: Hermitian positive definite
    (the skew part's eigenvalues lie within ``2 skew`` of 0)."""
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    vals, rows, cols, shape = poisson3d_coo(n)
    vals = vals + shift * (rows == cols)
    m = shape[0]
    i = np.arange(m)
    nbr = (i % n) < n - 1                    # x + 1 inside the grid
    r, c = i[nbr], i[nbr] + 1
    allv = np.concatenate([vals.astype(complex), 1j * skew * np.ones(len(r)),
                           -1j * skew * np.ones(len(r))])
    return (allv, np.concatenate([rows, r, c]),
            np.concatenate([cols, c, r]), shape)


def test_coo_source_goes_through_the_auto_policy():
    # a Hermitian COO system's real equivalent is symmetric, banded with
    # the off-diagonal blocks' offsets, and the policy picks DIA for it
    # (the kernel on the card); CG on it solves the complex system
    vals, rows, cols, shape = _shifted_poisson_hermitian(6)
    op = real_equivalent_operator((vals, rows, cols, shape),
                                  hermitian=True, device=DEV)
    assert op.fmt == "dia" and op.symmetric
    # 7 Poisson diagonals and 4 of the off-diagonal blocks: at 160^3 on a
    # card the policy gives the DIA kernel
    ndiag, density = bandwidth_profile(coo_from_arrays(
        *real_equivalent_coo(vals, rows, cols, shape), device=None))
    assert ndiag == 11 and density >= 0.5
    assert auto_format(ndiag, density, (2 * 160 ** 3,) * 2,
                       "cuda") == "cuda-dia"
    jop = jops.real_equivalent_operator((vals, rows, cols, shape),
                                        hermitian=True)
    a = np.zeros(shape, complex)
    np.add.at(a, (rows, cols), vals)
    np.testing.assert_allclose(a, a.conj().T)
    rng = np.random.default_rng(11)
    zstar = rng.standard_normal(shape[0]) + 1j * rng.standard_normal(
        shape[0])
    b = a @ zstar
    res = complex_solve(cg, op, b, rtol=1e-10)
    jres = jops.complex_solve(j_cg, jop, b, rtol=1e-10)
    assert int(res.n_iter) == int(jres.n_iter)
    assert rel(res.x.numpy(), jres.x) <= XTOL
    assert np.linalg.norm(b - a @ res.x.numpy()) <= 1e-9 * np.linalg.norm(b)
    dense = real_equivalent_operator((vals, rows, cols, shape),
                                     hermitian=True, fmt="dense",
                                     device=DEV)
    assert isinstance(dense, MatrixOperator)
