"""An f32 ``CholeskyOperator`` applied to f64 vectors promotes, as the JAX
package's triangular solves do, and preconditions f64 solves.

The matrix is ``L L^T`` with a small-integer L, so both packages' f32
factorizations are exact (L itself) and the f64 products agree to 1e-12
relative (``RTOL``) whatever the LAPACK behind them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
import pykrylov_tpu.solvers as jsol
from pykrylov_tpu_torch.ops import (BlockDiagonalPreconditioner,
                                    CholeskyOperator, MatrixOperator)
from pykrylov_tpu_torch.solvers import cg, cg_batched, cg_pipelined

DEV = "cpu"  # the port's entry points default to the card
N = 12
RTOL = 1e-12


def exact_spd(rng, n=N):
    """An f32 SPD matrix whose f32 Cholesky factor is exact."""
    L = np.tril(rng.integers(-3, 4, size=(n, n)), -1) \
        + np.diag(rng.integers(1, 5, size=n))
    return (L @ L.T).astype(np.float32)


def both(rng):
    A = exact_spd(rng)
    return (A, CholeskyOperator(torch.from_numpy(A), device=DEV),
            jops.CholeskyOperator(jnp.asarray(A)))


def test_factor_is_exact(rng):
    A, t, j = both(rng)
    L = t.factor.numpy().astype(np.float64)
    np.testing.assert_array_equal(L @ L.T, A.astype(np.float64))


@pytest.mark.parametrize("shape", [(N,), (N, 3)])
def test_f32_factor_promotes_f64_operand(shape, rng):
    A, t, j = both(rng)
    x = rng.standard_normal(shape)
    yt = t * torch.from_numpy(x)
    yj = np.asarray(j * jnp.asarray(x))
    assert yt.dtype == torch.float64 and yj.dtype == np.float64
    np.testing.assert_allclose(yt.numpy(), yj, rtol=RTOL, atol=0)
    # an f32 operand stays f32
    assert (t * torch.from_numpy(x.astype(np.float32))).dtype \
        == torch.float32


def _system(rng):
    A, t, j = both(rng)
    b = rng.standard_normal(N)
    return A.astype(np.float64), b, t, j


@pytest.mark.parametrize("name", ["cg", "cg_pipelined"])
def test_single_solves_with_f32_cholesky_m(name, rng):
    A, b, t, j = _system(rng)
    fn = {"cg": (cg, jsol.cg), "cg_pipelined": (cg_pipelined,
                                                jsol.cg_pipelined)}[name]
    rt = fn[0](torch.from_numpy(A), torch.from_numpy(b), M=t)
    rj = fn[1](jnp.asarray(A), jnp.asarray(b), M=j)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.n_iter) == int(rj.n_iter)
    assert int(rt.n_matvec) == int(rj.n_matvec)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10)


def test_batched_cg_with_f32_cholesky_m(rng):
    A, _, t, j = _system(rng)
    B = rng.standard_normal((N, 3))
    rt = cg_batched(torch.from_numpy(A), torch.from_numpy(B), M=t)
    rj = jsol.cg_batched(jnp.asarray(A), jnp.asarray(B), M=j)
    assert bool(rt.converged.all()) and bool(np.all(rj.converged))
    assert int(rt.n_iter) == int(rj.n_iter)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10)


def test_block_diagonal_preconditioner_of_f32_cholesky(rng):
    A1, A2 = exact_spd(rng), exact_spd(rng)
    A = np.zeros((2 * N, 2 * N))
    A[:N, :N], A[N:, N:] = A1, A2
    b = rng.standard_normal(2 * N)
    Mt = BlockDiagonalPreconditioner(
        [CholeskyOperator(torch.from_numpy(a), device=DEV)
         for a in (A1, A2)])
    Mj = jops.BlockDiagonalPreconditioner(
        [jops.CholeskyOperator(jnp.asarray(a)) for a in (A1, A2)])
    rt = cg(MatrixOperator(torch.from_numpy(A), device=DEV),
            torch.from_numpy(b), M=Mt)
    rj = jsol.cg(jnp.asarray(A), jnp.asarray(b), M=Mj)
    assert bool(rt.converged) and int(rt.n_iter) == int(rj.n_iter)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10)
