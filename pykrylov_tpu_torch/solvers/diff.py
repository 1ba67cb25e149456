"""Implicitly differentiable solves (adjoint systems under autograd).

Counterpart of ``pykrylov_tpu/solvers/diff.py``.  Since ``x* = A^{-1} b``
satisfies ``A x* - b = 0``, gradients flow through a converged solve by
the implicit function theorem instead of through the iteration:

    dL/db      = A^{-T} g              (one adjoint solve)
    dL/d(A_p)  = - the vector-Jacobian product of (p -> A(p) x*) at
                 lambda = A^{-T} g

so the backward pass is one more linear solve and one product's VJP,
whatever the number of iterations the forward solve took.

Each solve is a :class:`torch.autograd.Function` whose inputs are ``b``
and the operator's ``params`` (the tensors its products read; a derived
operator collects its children's).  The forward runs the solver without
autograd; the backward solves the adjoint system on ``A`` (symmetric) or
``A.T`` with the same options, and pulls ``-lambda`` back through ``A @
x*`` with :func:`torch.autograd.grad` only when some operator tensor
requires a gradient.  The JAX package takes that VJP whenever the operator
has params, which fails on its Pallas operators even for ``dL/db`` alone
(ROADMAP.md queue 3); here a ``cuda-dia`` or ``bell`` operator, whose
stored values are not differentiable leaves, gives ``dL/db`` through its
kernels in both solves.

``cg_solve``, ``bicgstab_solve`` and ``lsqr_solve`` are ready-made
wrappers returning ``x``.
"""

from __future__ import annotations

import torch

from .common import as_operator
from ..utils.types import to_tensor

__all__ = ["make_differentiable", "cg_solve", "bicgstab_solve",
           "lsqr_solve"]


def _unique(params):
    """``params`` without repeats (``A + A`` reads one tensor twice; an
    input given twice would receive its gradient twice)."""
    return tuple({id(p): p for p in params}.values())


class _ImplicitSolve(torch.autograd.Function):
    """``x = solve(A, b)`` with the adjoint-system backward."""

    @staticmethod
    def forward(ctx, spec, b, *params):
        A, solve_fn, adjoint_fn, symmetric, opts = spec
        x = solve_fn(A, b, **opts).x
        ctx.spec = spec
        ctx.b_dtype = b.dtype
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g):
        A, solve_fn, adjoint_fn, symmetric, opts = ctx.spec
        x, *params = ctx.saved_tensors
        AT = A if symmetric else A.T
        with torch.no_grad():
            lam = adjoint_fn(AT, g, **opts).x
        grads = [None] * len(params)
        want = [i for i, p in enumerate(params)
                if ctx.needs_input_grad[2 + i]]
        if want:
            with torch.enable_grad():
                y = A._mv(x.detach())
                pulled = torch.autograd.grad(
                    y, [params[i] for i in want], grad_outputs=-lam.to(
                        y.dtype), allow_unused=True)
            for i, gp in zip(want, pulled):
                grads[i] = gp
        db = lam.to(ctx.b_dtype) if ctx.needs_input_grad[1] else None
        return (None, db, *grads)


def make_differentiable(solve_fn, adjoint_solve_fn=None, symmetric=False,
                        **default_opts):
    """Wrap a functional solver into ``f(A, b) -> x`` differentiable in
    ``b`` and in the operator's tensors.

    Parameters
    ----------
    solve_fn : e.g. :func:`~pykrylov_tpu_torch.solvers.cg`; called as
        ``solve_fn(A, b, **opts)`` and returning a SolveResult.
    adjoint_solve_fn : solver for the adjoint system ``A^T lam = g``;
        defaults to ``solve_fn``.  With ``symmetric=True`` the forward
        operator is reused (no transpose).
    default_opts : solver options of both passes (rtol, atol, maxiter,
        ...).
    """
    adjoint_solve_fn = adjoint_solve_fn or solve_fn

    def wrapper(A, b, **_ignored):
        A = as_operator(A)
        if not isinstance(b, torch.Tensor):
            b = to_tensor(b, device=A.device)
        spec = (A, solve_fn, adjoint_solve_fn, symmetric, default_opts)
        return _ImplicitSolve.apply(spec, b, *_unique(A.params))

    return wrapper


def cg_solve(A, b, **opts):
    """Differentiable CG solve (SPD A): returns x."""
    from .cg import cg
    opts.setdefault("rtol", 1e-10)
    return make_differentiable(cg, symmetric=True, **opts)(A, b)


def bicgstab_solve(A, b, **opts):
    """Differentiable Bi-CGSTAB solve (general square A): returns x."""
    from .bicgstab import bicgstab
    opts.setdefault("rtol", 1e-10)
    return make_differentiable(bicgstab, symmetric=False, **opts)(A, b)


def lsqr_solve(A, b, **opts):
    """Differentiable least-squares solve: returns x.

    For full-column-rank A, ``x* = (A^T A)^{-1} A^T b``; the backward
    solves the adjoint ``A^T lam = g`` with LSQR on ``A^T`` (its minimum
    norm solution ``A (A^T A)^{-1} g``).  Gradients with respect to A's
    tensors use the residual form of the implicit function theorem, exact
    only for a consistent system; for an inconsistent one, differentiate a
    damped formulation.
    """
    from .lsqr import lsqr
    opts.setdefault("atol", 1e-12)
    opts.setdefault("btol", 1e-12)
    return make_differentiable(lsqr, symmetric=False, **opts)(A, b)
