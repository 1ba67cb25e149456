"""Bi-CGSTAB as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/bicgstab.py`` (``bicgstab.py:43-177``),
after the reference Bi-CGSTAB (PyKrylov's
``pykrylov/bicgstab/bicgstab.py:9-151``, Van der Vorst '92 in Kelley's
preconditioned form): 2 matvecs, 6 dots and 6 axpys per iteration.  The
reference can exit mid-iteration when the intermediate residual ``s`` is
already small (``bicgstab.py:107-114``: ``x += alpha*q`` and stop), and so
does this loop: the iteration's first half ends in one host
synchronisation (the shadow product ``r0'v`` and ``||s||``), which decides
whether the second half and its matvec run at all, and the second half
ends in another.  Two synchronisations per full iteration; the scalars
between them stay on the device as 0-d tensors.

Preserved semantics (SURVEY §2.3):
  * stopping threshold ``max(abstol, reltol * ||r0||)``;
  * ``matvec_max`` cap (default 2n), checked after each matvec;
  * an initial guess costs one extra counted matvec (``bicgstab.py:61-63``;
    unlike CGS and TFQMR, Bi-CGSTAB counts it);
  * ``rho_next = -omega * (r0' t)`` update rule (``bicgstab.py:127``);
  * unconjugated dots (the reference's ``np.dot``);
  * a breakdown (a vanishing or non-finite shadow product, ``rho = 0`` or a
    non-finite residual) stops with ``istop 3`` and the last finite iterate,
    where the reference spins NaNs to the matvec cap.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, dotu, fdiv,
                     finite, history_from, norm, promote_rhs, real_dtype,
                     require_square, rows)
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["bicgstab", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho, r0'v or t't vanished / residual not finite",
}


def bicgstab(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
             matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by Bi-CGSTAB.

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.cg`; ``M`` is
    applied as a right preconditioner on the search directions, as in the
    reference (``bicgstab.py:96-100,118-121``).  ``verify_final=True``
    records the true residual norm as ``info["true_resid_norm"]`` (one
    uncounted matvec).

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "bicgstab")
    dev = b.device
    if matvec_max is None:
        matvec_max = 2 * rows(b)
    matvec_max = int(matvec_max)

    if x0 is None:
        x = torch.zeros_like(b)
        r0 = b
        nmv = 0
    else:
        x = to_tensor(x0, device=dev).to(b.dtype)
        r0 = b - apply_op(A, x)
        nmv = 1

    rho_next = dotu(r0, r0).item()
    resid0 = abs(rho_next ** 0.5)
    thresh = max(atol, rtol * resid0)
    hist = [resid0]
    resid = resid0
    broken = not math.isfinite(resid0)
    done = resid0 <= thresh or nmv >= matvec_max or broken
    r, p, v = r0, torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = 1.0
    k = 0
    while not done:
        k += 1
        beta = fdiv(rho_next, rho) * fdiv(alpha, omega)
        rho = rho_next
        p = torch.add(r, torch.add(p, v, alpha=-omega), alpha=beta)
        q = apply_op(M, p) if M is not None else p
        v = apply_op(A, q)
        nmv += 1
        denom_t = dotu(r0, v)
        alpha_t = rho / denom_t
        svec = torch.addcmul(r, alpha_t, v, value=-1)
        denom, alpha, resid_s = torch.stack(
            [denom_t, alpha_t, norm(svec).to(
                denom_t.dtype)]).tolist()
        resid_s = abs(resid_s)
        if (denom == 0 or not finite(denom) or rho == 0
                or not math.isfinite(resid_s)):
            broken = True
            break
        if resid_s <= thresh or nmv >= matvec_max:
            # bicgstab.py:107-114: accept the half-step and stop
            if resid_s <= thresh:
                x = torch.add(x, q, alpha=alpha)
            resid = resid_s
            hist.append(resid)
            break
        z = apply_op(M, svec) if M is not None else svec
        t = apply_op(A, z)
        nmv += 1
        tt_t = dotu(t, t)
        omega_t = dotu(t, svec) / tt_t
        r = torch.addcmul(svec, omega_t, t, value=-1)
        tt, omega, r0t, resid_r = torch.stack(
            [tt_t, omega_t, dotu(r0, t),
             norm(r).to(tt_t.dtype)]).tolist()
        resid_r = abs(resid_r)
        rho_next = -omega * r0t
        broken = tt == 0 or not math.isfinite(resid_r)
        if math.isfinite(resid_r):
            x = torch.add(x, z, alpha=omega).add_(q, alpha=alpha)
            resid = resid_r
        hist.append(resid)
        done = resid <= thresh or nmv >= matvec_max or broken

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
        resid_history=history_from(store_history, matvec_max, hist, rdt,
                                   dev),
        info={})
    if verify_final:
        res = attach_true_residual(A, b, res)
    return res

