"""The port's differentiable solves against ``jax.grad`` of the JAX
package's (the cases of tests/test_diff.py), and ``dL/db`` through the
kernel-backed operators.

The same f64 inputs go through both packages.  Both backward passes are
one adjoint solve (and, for an operator gradient, one product's VJP), so
the gradients agree to 1e-8 (``GTOL``, relative to the largest entry: the
solves stop at rtol 1e-10 or 1e-12).  The JAX package takes the
operator's VJP whenever it has params, which fails on its Pallas
operators even for ``dL/db`` (ROADMAP.md queue 3); the port takes it only
when an operator tensor requires a gradient, so ``dL/db`` through a
``cuda-dia`` or ``bell`` operator (their plain products on the CPU) is
held to ``A^{-T} w`` from a dense solve.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pykrylov_tpu.ops import DiagonalOperator as JDiag
from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.solvers import diff as jdiff
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.kernels import pallas_dia_operator

from pykrylov_tpu_torch.gallery import convdiff2d_coo, poisson3d_coo
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import (bicgstab_solve, cg_solve,
                                        lsqr_solve, make_differentiable)
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse import operator_from_coo

from test_torch_batched import _sparse_spd
from test_torch_lls_card import _sparse_rect

DEV = "cpu"  # the port's entry points default to the card
GTOL = 1e-8


def close(port, ref, tol=GTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max()


def leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def test_grad_wrt_rhs_spd(rng):
    n = 20
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    w = rng.standard_normal(n)
    b = rng.standard_normal(n)
    bt = leaf(b)
    (torch.from_numpy(w) @ cg_solve(MatrixOperator(A, symmetric=True,
                                                   device=DEV), bt)).backward()
    jop = JMatrix(jnp.asarray(A), symmetric=True)
    g = jax.grad(lambda b: jnp.dot(jnp.asarray(w), jdiff.cg_solve(jop, b)))(
        jnp.asarray(b))
    close(bt.grad.numpy(), g)
    close(bt.grad.numpy(), np.linalg.solve(A, w), 1e-7)


def test_grad_wrt_operator_params(rng):
    # d/d(diag) of w' diag(d)^{-1} b = -w*b/d^2 elementwise
    n = 15
    d = 1.0 + rng.random(n)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)
    dt = leaf(d)
    (torch.from_numpy(w) @ cg_solve(DiagonalOperator(dt, device=DEV),
                                    torch.from_numpy(b))).backward()
    g = jax.grad(lambda dv: jnp.dot(jnp.asarray(w), jdiff.cg_solve(
        JDiag(dv), jnp.asarray(b))))(jnp.asarray(d))
    close(dt.grad.numpy(), g)
    close(dt.grad.numpy(), -w * b / d ** 2)


def test_grad_wrt_dense_matrix(rng):
    # dL/dA = -lambda x' for L = w' A^{-1} b, lambda = A^{-T} w
    n = 12
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)
    At = leaf(A)
    (torch.from_numpy(w) @ bicgstab_solve(
        MatrixOperator(At, device=DEV), torch.from_numpy(b), rtol=1e-12,
        matvec_max=400)).backward()
    g = jax.grad(lambda Am: jnp.dot(jnp.asarray(w), jdiff.bicgstab_solve(
        JMatrix(Am), jnp.asarray(b), rtol=1e-12, matvec_max=400)))(
        jnp.asarray(A))
    close(At.grad.numpy(), g)
    x = np.linalg.solve(A, b)
    lam = np.linalg.solve(A.T, w)
    close(At.grad.numpy(), -np.outer(lam, x), 1e-6)


def test_grad_matches_finite_differences(rng):
    n = 10
    d0 = 1.0 + rng.random(n)
    b = torch.from_numpy(rng.standard_normal(n))

    def loss(dvec):
        x = cg_solve(DiagonalOperator(dvec, device=DEV), b)
        return (x ** 2).sum()

    dt = leaf(d0)
    loss(dt).backward()
    g = dt.grad.numpy()
    jg = jax.grad(lambda dv: jnp.sum(jdiff.cg_solve(
        JDiag(dv), jnp.asarray(b.numpy())) ** 2))(jnp.asarray(d0))
    close(g, jg)
    eps = 1e-6
    for i in range(0, n, 3):
        dp = d0.copy()
        dp[i] += eps
        dm = d0.copy()
        dm[i] -= eps
        fd = (float(loss(torch.from_numpy(dp)))
              - float(loss(torch.from_numpy(dm)))) / (2 * eps)
        assert g[i] == pytest.approx(fd, rel=1e-4)


def test_grad_repeats_eagerly(rng):
    # the JAX package's jit case: here the same eager call twice gives the
    # same gradient, and jax.grad's through jit
    n = 14
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    op = MatrixOperator(A, symmetric=True, device=DEV)
    grads = []
    for _ in range(2):
        bt = leaf(b)
        (cg_solve(op, bt) ** 2).sum().backward()
        grads.append(bt.grad)
    assert torch.equal(grads[0], grads[1])
    jop = JMatrix(jnp.asarray(A), symmetric=True)
    f = jax.jit(lambda b: jnp.sum(jdiff.cg_solve(jop, b) ** 2))
    close(grads[0].numpy(), jax.grad(f)(jnp.asarray(b)))


def test_lsqr_grad_consistent_system(rng):
    # overdetermined but consistent: dL/db = A (A'A)^{-1} w
    m, n = 30, 12
    A = rng.standard_normal((m, n))
    w = rng.standard_normal(n)
    b = A @ rng.standard_normal(n)
    bt = leaf(b)
    (torch.from_numpy(w) @ lsqr_solve(MatrixOperator(A, device=DEV),
                                      bt)).backward()
    jop = JMatrix(jnp.asarray(A))
    g = jax.grad(lambda b: jnp.dot(jnp.asarray(w), jdiff.lsqr_solve(jop, b)))(
        jnp.asarray(b))
    close(bt.grad.numpy(), g)
    close(bt.grad.numpy(), A @ np.linalg.solve(A.T @ A, w), 1e-6)


def test_derived_operators_collect_their_tensors(rng):
    # a sum, a scaled operator and a transpose read their children's
    # tensors: the gradient reaches each leaf once (A + A reads M twice)
    n = 10
    Q = rng.standard_normal((n, n))
    a = Q @ Q.T + n * np.eye(n)
    d = 1.0 + rng.random(n)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)
    Mt, dt = leaf(a), leaf(d)
    M = MatrixOperator(Mt, symmetric=True, device=DEV)
    D = DiagonalOperator(dt, device=DEV)
    op = (M + M) * 0.5 + D.T
    assert len(op.params) == 3
    (torch.from_numpy(w) @ cg_solve(op, torch.from_numpy(b))).backward()
    full = a + np.diag(d)
    x = np.linalg.solve(full, b)
    lam = np.linalg.solve(full, w)
    close(Mt.grad.numpy(), -np.outer(lam, x), 1e-7)
    close(dt.grad.numpy(), -lam * x, 1e-7)


def test_make_differentiable_with_its_options(rng):
    # default options reach both passes; the wrapper ignores per-call ones
    n = 16
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = leaf(rng.standard_normal(n))
    solve = make_differentiable(cg, symmetric=True, rtol=1e-12)
    x = solve(MatrixOperator(A, symmetric=True, device=DEV), b, rtol=1.0)
    close(x.detach().numpy(), np.linalg.solve(A, b.detach().numpy()))
    x.sum().backward()
    close(b.grad.numpy(), np.linalg.solve(A, np.ones(n)))


def _kernel_case(case):
    """(port operator, JAX Pallas operator in interpret mode or None, dense
    matrix, solve function, JAX solve function, options)."""
    if case == "cuda-dia-cg":
        t = poisson3d_coo(8)
        A = operator_from_coo(*t, symmetric=True, fmt="cuda-dia",
                              device=DEV)
        jA = pallas_dia_operator(JF.dia_from_coo(JF.coo_from_arrays(*t)),
                                 symmetric=True, interpret=True)
        return A, jA, t, cg_solve, jdiff.cg_solve, {}
    if case == "cuda-dia-bicgstab":
        t = convdiff2d_coo(16, wx=17.0, wy=8.5)
        A = operator_from_coo(*t, fmt="cuda-dia", device=DEV)
        return A, None, t, bicgstab_solve, None, {}
    if case == "bell-cg":
        _, t = _sparse_spd(n=600, seed=14)
        A = operator_from_coo(*t, symmetric=True, fmt="bell", device=DEV)
        jA = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                              symmetric=True, interpret=True)
        return A, jA, t, cg_solve, jdiff.cg_solve, {}
    t = _sparse_rect(m=900, n=400, seed=15)
    A = operator_from_coo(*t, fmt="bell", device=DEV)
    return A, None, t, lsqr_solve, None, {}


@pytest.mark.parametrize("case", ["cuda-dia-cg", "cuda-dia-bicgstab",
                                  "bell-cg", "bell-lsqr"])
def test_grad_wrt_rhs_through_kernel_operators(case):
    # the queue 3 deviation: dL/db through the kernel-backed operators,
    # the forward and the adjoint solve through their products (on A,
    # dia_transpose(A), cards["bwd"]); the JAX package's grad raises there
    A, jA, t, fn, jfn, opts = _kernel_case(case)
    assert A.params == ()
    m, n = t[3]
    a = np.zeros((m, n))
    np.add.at(a, (t[1], t[2]), t[0])
    rng = np.random.default_rng(16)
    w = rng.standard_normal(n)
    b = leaf(a @ rng.standard_normal(n))
    x = fn(A, b, **opts)
    (torch.from_numpy(w) @ x).backward()
    if case == "bell-lsqr":
        expect = a @ np.linalg.solve(a.T @ a, w)
    else:
        expect = np.linalg.solve(a.T, w)
    close(b.grad.numpy(), expect, 1e-7)
    if jA is not None:
        pad = jA.shape[0] - m

        def loss(bb):
            xx = jfn(jA, jnp.concatenate([bb, jnp.zeros(pad)]))
            return jnp.dot(jnp.asarray(w), xx[:n])

        with pytest.raises((ValueError, NotImplementedError)):
            jax.grad(loss)(jnp.asarray(b.detach().numpy()))
