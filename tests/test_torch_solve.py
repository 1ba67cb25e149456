"""The slice end to end: ``solve(operator_from_coo(...), b)`` in the port
against the JAX package, the automatic format policy, and the branches
that are not ported yet.

At ``poisson3d_coo(16)`` both packages pick DIA on the CPU and run CG in
float64 with the same stored matrix; only summation order differs, so the
iteration counts must be equal and the solutions agree to 1e-10
relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu
from pykrylov_tpu.gallery import poisson3d_coo
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse.linop import auto_format

DEV = "cpu"  # the port's entry points default to the card


def test_slice_matches_jax():
    vals, rows, cols, shape = poisson3d_coo(16)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          device=DEV)
    jA = jax_operator_from_coo(vals, rows, cols, shape, symmetric=True)
    assert A.fmt == "dia"
    assert type(jA.container).__name__ == "DIA"
    x_true = np.random.default_rng(0).standard_normal(shape[0])
    b = (A * torch.from_numpy(x_true)).numpy()
    res = pt.solve(A, torch.from_numpy(b))
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b))
    assert isinstance(res, pt.SolveResult)
    assert bool(res.converged) and int(res.istop) == 0
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10, atol=1e-12)
    assert "infinite_descent" in res.info  # solve() checks curvature
    explicit = pt.solve(A, torch.from_numpy(b), method="cg")
    assert int(explicit.n_iter) == int(res.n_iter)
    assert "infinite_descent" not in explicit.info


@pytest.mark.parametrize("args,expected", [
    ((7, 1.0, (70000, 70000), "cuda"), "cuda-dia"),
    ((7, 1.0, (70000, 70000), "cpu"), "dia"),
    ((7, 1.0, (65535, 65535), "cuda"), "dia"),
    ((7, 1.0, (70000, 69999), "cuda"), "dia"),
    ((64, 0.25, (1 << 16, 1 << 16), "cuda"), "cuda-dia"),
    ((65, 1.0, (70000, 70000), "cuda"), "ell"),
    ((7, 0.2, (70000, 70000), "cuda"), "ell"),
])
def test_auto_format_policy(args, expected):
    # the JAX package's thresholds: <= 64 diagonals, >= 0.25 fill, and the
    # kernel from 65,536 rows on the accelerator
    assert auto_format(*args) == expected


@pytest.mark.parametrize("ndiag", [K.MAX_DIAGS + 1, 100, 4096])
def test_auto_format_never_exceeds_the_kernel(ndiag):
    # the policy's diagonal limit is the kernel's: a matrix the kernel
    # would refuse never gets fmt="cuda-dia"
    assert auto_format(ndiag, 1.0, (1 << 20, 1 << 20), "cuda") != "cuda-dia"
    assert auto_format(K.MAX_DIAGS, 1.0, (1 << 20, 1 << 20),
                       "cuda") == "cuda-dia"


def test_no_unported_knobs():
    # options of the JAX package that the port does not implement are not
    # accepted silently
    spd = MatrixOperator(torch.eye(3, dtype=torch.float64) * 2,
                         symmetric=True, device=DEV)
    with pytest.raises(TypeError, match="leg_rtol"):
        cg(spd, torch.ones(3, dtype=torch.float64), leg_rtol=1e-2)
    vals, rows, cols, shape = poisson3d_coo(4)
    with pytest.raises(TypeError, match="max_diags"):
        operator_from_coo(vals, rows, cols, shape, max_diags=100,
                          device=DEV)


def test_auto_on_cpu_keeps_plain_dia_for_large_stencils():
    vals, rows, cols, shape = poisson3d_coo(41)  # 68,921 rows
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          device=DEV)
    assert A.fmt == "dia" and A.device.type == "cpu"


def _indefinite():
    return DiagonalOperator(torch.tensor([2.0, -1.0, 3.0],
                                         dtype=torch.float64), device=DEV)


@pytest.mark.parametrize("case,item", [
    ("block_rhs", 14), ("verified", 15), ("minres", 11), ("symmlq", 11),
    ("bicgstab", 10), ("tfqmr", 10), ("lsqr", 12), ("craigmr", 12),
    ("cg_pipelined", 16), ("rectangular", 12), ("unsymmetric", 10),
    ("indefinite_fallback", 11), ("replace_every", 15),
])
def test_not_ported_branches_name_their_roadmap_item(case, item):
    spd = MatrixOperator(torch.eye(3, dtype=torch.float64) * 2,
                         symmetric=True, device=DEV)
    b = torch.ones(3, dtype=torch.float64)
    calls = {
        # an (n, K) block on a square unsymmetric operator: its batched
        # solver (bicgstab_batched) is not ported; CG blocks are
        "block_rhs": lambda: pt.solve(
            MatrixOperator(torch.eye(3, dtype=torch.float64), device=DEV),
            torch.ones(3, 2, dtype=torch.float64)),
        "verified": lambda: pt.solve(spd, b, verified=True),
        "rectangular": lambda: pt.solve(
            MatrixOperator(torch.ones(4, 3, dtype=torch.float64),
                           device=DEV), b),
        "unsymmetric": lambda: pt.solve(
            MatrixOperator(torch.eye(3, dtype=torch.float64),
                           device=DEV), b),
        "indefinite_fallback": lambda: pt.solve(_indefinite(), b),
        "replace_every": lambda: cg(spd, b, replace_every=50),
    }
    call = calls.get(case, lambda: pt.solve(spd, b, method=case))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item %d$" % item):
        call()


@pytest.mark.parametrize("fmt", ["bell", "bell-rcm"])
def test_bell_formats_raise(fmt):
    # the BELL formats are ported: they build a BELL operator on request
    # (and no longer raise) whatever the device, and its product is A x
    vals, rows, cols, shape = poisson3d_coo(4)
    A = operator_from_coo(vals, rows, cols, shape, fmt=fmt, device=DEV)
    assert A.fmt == "bell"
    assert (A.solve_permutation is not None) == (fmt == "bell-rcm")
    x = np.random.default_rng(1).standard_normal(shape[1])
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose((A * torch.from_numpy(x)).numpy(), dense @ x,
                               rtol=1e-12, atol=1e-12)


def test_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        pt.solve(MatrixOperator(torch.eye(2, dtype=torch.float64),
                                device=DEV),
                 torch.ones(2, dtype=torch.float64), method="gmres")
