"""Conjugate Gradient Squared (CGS) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/cgs.py`` (``cgs.py:40-140``), after
the reference CGS (PyKrylov's ``pykrylov/cgs/cgs.py:8-123``, Sonneveld
'89): two matvecs with A, three dots and seven axpys per iteration, no
adjoint products.  The vectors stay on the device of ``b``; the
iteration's three scalars (the shadow product ``r0'v``, ``||r||`` and the
next ``rho = r0'r``) reach the host in one synchronisation at its end,
which decides the stop and the breakdown guard.  The step itself is taken
on the device before that, as the JAX package's fused loop takes it, and a
non-finite residual drops it.

Preserved semantics (SURVEY §2.3):
  * stopping threshold ``max(abstol, reltol * ||r0||)`` (``cgs.py:65``);
  * ``matvec_max`` cap (default 2n);
  * the preconditioner is applied to ``p`` and to ``u + q``
    (``cgs.py:78-91``);
  * unconjugated dots (the reference's ``np.dot``);
  * quirk kept for matvec-count parity: the matvec forming ``r0 = b - A
    x0`` for a supplied guess is not counted (``cgs.py:59-60``, unlike
    Bi-CGSTAB);
  * a breakdown (a vanishing or non-finite ``sigma``, ``rho = 0`` or a
    non-finite residual) stops with ``istop 3`` and the last finite
    iterate, where the reference spins NaNs to the matvec cap.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, dotu, finite,
                     history_from, norm, promote_rhs, real_dtype,
                     require_square, rows)
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["cgs", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho or sigma vanished / residual not finite",
}


def cgs(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
        matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by the CGS method.

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.cg`; no products
    with the adjoint of ``A`` are required (``cgs.py:18-19``).
    ``verify_final=True`` records the true residual norm as
    ``info["true_resid_norm"]`` (one uncounted matvec).

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cgs")
    dev = b.device
    if matvec_max is None:
        matvec_max = 2 * rows(b)
    matvec_max = int(matvec_max)
    maxiter = max(1, matvec_max // 2)

    if x0 is None:
        x = torch.zeros_like(b)
        r0 = b
    else:
        x = to_tensor(x0, device=dev).to(b.dtype)
        r0 = b - apply_op(A, x)          # not counted (cgs.py:59-60)

    rho = dotu(r0, r0).item()
    resid0 = math.sqrt(abs(rho))         # |sqrt(rho)| (cgs.py:63)
    thresh = max(atol, rtol * resid0)
    hist = [resid0]
    resid = resid0
    broken = not math.isfinite(resid0)
    done = resid0 <= thresh or broken
    r = u = p = r0
    k = nmv = 0
    while not done:
        y = apply_op(M, p) if M is not None else p
        v = apply_op(A, y)
        sigma_t = dotu(r0, v)
        alpha_t = rho / sigma_t
        q = torch.addcmul(u, alpha_t, v, value=-1)
        uq = u + q
        z = apply_op(M, uq) if M is not None else uq
        x2 = torch.addcmul(x, alpha_t, z)
        r = torch.addcmul(r, alpha_t, apply_op(A, z), value=-1)
        nmv += 2
        k += 1
        sigma, resid2, rho_next = torch.stack(
            [sigma_t, norm(r).to(sigma_t.dtype),
             dotu(r0, r)]).tolist()
        resid2 = abs(resid2)
        broken = (sigma == 0 or not finite(sigma)
                  or not math.isfinite(resid2) or rho_next == 0)
        if math.isfinite(resid2):
            x, resid = x2, resid2
        hist.append(resid)
        done = resid2 <= thresh or nmv >= matvec_max or broken
        if not done:
            beta = rho_next / rho
            u = torch.add(r, q, alpha=beta)
            p = torch.add(u, torch.add(q, p, alpha=beta), alpha=beta)
        rho = rho_next

    converged = resid <= thresh
    istop = 0 if converged else (3 if broken else 1)
    rdt = real_dtype(b.dtype)
    res = SolveResult(
        x=x, converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(nmv, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(resid, dtype=rdt, device=dev),
        resid_norm0=torch.tensor(resid0, dtype=rdt, device=dev),
        resid_history=history_from(store_history, maxiter, hist, rdt, dev),
        info={})
    if verify_final:
        res = attach_true_residual(A, b, res)
    return res
