"""Chebyshev polynomial preconditioning and Lanczos spectral bounds.

Counterpart of ``pykrylov_tpu/ops/chebyshev.py``.  A fixed-degree
Chebyshev polynomial ``p(A) ~ A^{-1}`` on an interval ``[lmin, lmax]``
enclosing the spectrum of an SPD ``A`` is itself SPD, so it serves as a
CG/MINRES preconditioner that needs only products with A: one application
costs ``degree - 1`` of them (through the operator's SpMV kernel, or its
SpMM kernel on a block) and no factorization.  The preconditioned spectrum
``p(A) A`` clusters at 1 with radius ``~2 rho^degree``, ``rho =
(sqrt(kappa)-1)/(sqrt(kappa)+1)``, so CG's outer iterations, and the dots
and host reads each of them pays, drop by about the degree.

Spectral bounds come from :func:`lanczos_bounds`: k Lanczos steps with
their scalars kept on the device (no host read until the k x k
tridiagonal's eigenvalues; on a mesh of ranks each scalar is one
``all_reduce``), widened by safety factors for the Ritz
values' underestimate of the extremes.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LinearOperator, _apply_any
from ..utils import ranks
from ..utils.types import to_tensor

__all__ = ["lanczos_bounds", "ChebyshevOperator",
           "chebyshev_preconditioner"]


def _lanczos_tridiag(A, v0, k):
    """k-step Lanczos: (alphas, betas) of the tridiagonal projection T_k,
    as (k,) tensors on the device (no reorthogonalization: the extremal
    Ritz values are what is needed, and they converge first)."""
    v = v0 / ranks.norm(v0)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(k):
        w = A._mv(v) - beta * v_prev
        alpha = ranks.vdot_real(v, w).to(v.dtype)
        w = w - alpha * v
        beta = ranks.norm(w)
        v_next = torch.where(beta > 0, w / torch.where(beta == 0, 1, beta),
                             w)
        v_prev, v = v, v_next
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)


def lanczos_bounds(A, *, k=16, seed=0, safety=0.05, v0=None):
    """Estimate the spectral bounds ``(lmin, lmax)`` of a symmetric
    operator by k-step Lanczos.

    k products with A; the k x k tridiagonal eigenproblem runs on the
    operator's device (``torch.linalg.eigvalsh``).  Ritz values approach
    the spectrum from inside, so the interval is widened by ``safety`` on
    both ends (``lmax * (1 + safety)``, ``lmin * (1 - safety)``; for an SPD
    operator lmin stays positive).  An extreme converges at a rate set by
    its gap relative to the whole spread, so ``lmin`` of a wide spectrum
    stays above the true minimum; the semi-iteration polynomial keeps ``p >
    0`` on ``(0, lmin + lmax)``, so that only damps the lowest modes less.

    ``v0`` defaults to ``np.random.default_rng(seed).standard_normal(n)``
    in the operator's dtype, the JAX package's start vector.  Returns two
    0-d tensors on the operator's device.
    """
    n = A.shape[1]
    if A.dtype.is_complex:
        raise ValueError("lanczos_bounds: complex operators are not "
                         "supported on this path; use the "
                         "real-equivalent formulation (ops/complex_eq)")
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
    v0 = to_tensor(v0, device=A.device).to(A.dtype)
    mesh = getattr(A, "mesh", None)
    if mesh is not None and mesh.ranked:
        # this rank's rows of the same start vector
        from ..parallel.sharded import shard_vector
        v0 = shard_vector(v0, mesh)
    k = int(min(k, n))
    alphas, betas = _lanczos_tridiag(A, v0, k)
    # an exact breakdown (beta_j == 0: the Krylov space exhausted in j < k
    # steps) leaves zero rows, which would add spurious 0 Ritz values: a
    # row is valid iff every earlier beta was nonzero; padded diagonal
    # entries become alphas[0] (a Rayleigh quotient, inside the spectrum)
    # and the off-diagonals coupling into padded rows are zeroed
    row_ok = torch.cat([
        torch.ones(1, dtype=torch.bool, device=alphas.device),
        torch.cumprod((betas[:-1] > 0).to(torch.int32), 0).bool()])
    alphas = torch.where(row_ok, alphas, alphas[0])
    off = torch.where(row_ok[1:], betas[:-1], 0)
    T = torch.diag(alphas) + torch.diag(off, 1) + torch.diag(off, -1)
    ritz = torch.linalg.eigvalsh(T)
    lmin, lmax = ritz[0], ritz[-1]
    lmin = torch.where(lmin > 0, lmin * (1.0 - safety),
                       lmin * (1.0 + safety))
    lmax = torch.where(lmax > 0, lmax * (1.0 + safety),
                       lmax * (1.0 - safety))
    return lmin, lmax


def _cheb_rule(A, lmin, lmax, degree):
    """``x -> p(A) x`` by the Chebyshev semi-iteration for ``A y = x`` from
    ``y_0 = 0`` (Saad, Iterative Methods, alg. 12.1), for a vector or a
    block (through A's block rule): a fixed polynomial of A, ``degree -
    1`` products with A.  The scalars are host floats."""
    theta = (lmax + lmin) / 2
    delta = (lmax - lmin) / 2
    sigma1 = theta / delta

    def mv(x):
        rho = 1.0 / sigma1
        d = x / theta
        y = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            r = x - _apply_any(A, A._mv, y)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            y = y + d
            rho = rho_new
        return y
    return mv


class ChebyshevOperator(LinearOperator):
    """``p(A) ~ A^{-1}``: the fixed-degree Chebyshev polynomial of a
    symmetric operator on the interval ``[lmin, lmax]``.

    Symmetric (SPD for an SPD ``A`` with ``0 < lmin``) and block-aware:
    on an (n, K) block the recurrence runs on the whole block through
    A's native block rule (the SpMM kernel of a kernel operator), so a
    batched solver streams A once a product for all K columns.  ``degree``
    is the polynomial's degree: one application performs ``degree - 1``
    products with A (degree 1 is the scaling ``x / theta``).  ``lmin`` and
    ``lmax`` (floats or 0-d tensors) are read to the host once, here.
    """

    def __init__(self, A, lmin, lmax, degree=8):
        degree = int(degree)
        if degree < 1:
            raise ValueError("ChebyshevOperator: degree must be >= 1")
        if A.shape[0] != A.shape[1]:
            raise ValueError("ChebyshevOperator needs a square operator")
        if not A.symmetric:
            raise ValueError("ChebyshevOperator needs a symmetric "
                             "operator (p(A) of an unsymmetric A is "
                             "neither A^{-1}-like nor symmetric)")
        self.degree = degree
        self.lmin, self.lmax = float(lmin), float(lmax)
        mv = _cheb_rule(A, self.lmin, self.lmax, degree)
        super().__init__(
            A.shape[1], A.shape[0], matvec=mv, matmat=mv, symmetric=True,
            hermitian=not A.dtype.is_complex, dtype=A.dtype,
            device=A.device, name="chebyshev(%d)" % degree,
            params=A.params)

    def solve(self, x):
        """Preconditioner-protocol alias (``BlockPreconditioner.solve``
        convention, reference ``linop/blkop.py:259-276``)."""
        return self * x


def chebyshev_preconditioner(A, *, degree=8, bounds=None, k_lanczos=16,
                             seed=0, safety=0.05):
    """A Chebyshev preconditioner for a symmetric-definite operator,
    estimating the spectral bounds by Lanczos unless ``bounds=(lmin,
    lmax)`` gives them (floats or 0-d tensors).  Usable as ``M=`` in
    cg/minres/symmlq and their batched twins.

    The bounds reach the host in one read and are checked: ``lmin <= 0``
    or ``lmin >= lmax`` raises, since the polynomial then has roots inside
    the interval and ``p(A)`` is not SPD.
    """
    if bounds is None:
        bounds = lanczos_bounds(A, k=k_lanczos, seed=seed, safety=safety)
    lo, hi = (v if isinstance(v, torch.Tensor) else torch.tensor(float(v))
              for v in bounds)
    lmin, lmax = torch.stack([lo.to(hi.device, torch.float64),
                              hi.to(torch.float64)]).tolist()
    if lmin <= 0 or lmin >= lmax:
        raise ValueError(
            "chebyshev_preconditioner: spectral interval [%g, %g] is "
            "not positive (the operator looks indefinite or "
            "semidefinite on the probed subspace); p(A) would not be "
            "SPD. Provide bounds= for a shifted/regularized interval "
            "or use an indefinite-capable method (MINRES)."
            % (lmin, lmax))
    return ChebyshevOperator(A, lmin, lmax, degree=degree)
