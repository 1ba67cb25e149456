"""Transpose-Free QMR (TFQMR) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/tfqmr.py`` (``tfqmr.py:43-217``),
after the reference TFQMR (PyKrylov's ``pykrylov/tfqmr/tfqmr.py:7-159``,
Freund '93 in Kelley's form).  Each iteration takes two quasi-minimisation
half-steps; each updates the quasi-residual ``residNorm *= theta * c`` and
tests ``residNorm * sqrt(m+1) < threshold`` (``tfqmr.py:95-123``), and the
direction refresh follows the second.  Two matvecs with A per full
iteration and three preconditioner applies.

The vectors stay on the device of ``b``.  Each half-step ends in one host
synchronisation (``||w||``, with the shadow product ``r0'v`` on the first
and the next ``rho = r0'w`` on the second), which decides whether the next
matvec runs at all: two a full iteration.  The rotation scalars ``theta``,
``c`` and ``eta`` run on Python floats.

Preserved semantics (SURVEY §2.3):
  * quasi-residual update and the ``sqrt(m+1)`` safety factor in the
    convergence test (strict ``<`` as in the reference);
  * ``matvec_max`` cap (default 2n);
  * unconjugated dots (the reference's ``np.dot``);
  * quirk kept for matvec-count parity: the matvec forming ``r0 = b - A
    x0`` for a supplied guess is not counted (``tfqmr.py:59-60``);
  * a breakdown (a vanishing or non-finite ``sigma``, ``rho = 0`` or a
    non-finite quasi-residual) stops with ``istop 3`` and the last finite
    iterate.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, dotu, fdiv,
                     finite, history_from, norm, promote_rhs, real_dtype,
                     require_square, rows)
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["tfqmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "quasi-residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho or sigma vanished / residual not finite",
}


def _rotate(w2, nw, d, z, x, alpha, theta, eta, resid):
    """The rest of a quasi-minimisation half-step (``tfqmr.py:93-104,
    108-123``) once ``w2 = w - alpha u`` and its norm ``nw`` are known:
    the rotation on the host, then ``d`` and ``x`` on the device."""
    scale = 0.0 if theta == 0 else fdiv(theta * theta, alpha) * eta
    d2 = torch.add(z, d, alpha=scale)
    theta2 = fdiv(nw, resid)
    c = 1.0 / math.sqrt(1.0 + theta2 * theta2)
    resid2 = resid * theta2 * c
    eta2 = (c * c) * alpha
    x2 = torch.add(x, d2, alpha=eta2) if math.isfinite(resid2) else x
    return w2, d2, x2, theta2, eta2, resid2


def tfqmr(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
          matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by the transpose-free QMR method.

    ``resid_norm`` in the result is Freund's quasi-residual norm, as in
    the reference (``tfqmr.py:95-98``): it bounds the true residual by
    ``||r|| <= residNorm * sqrt(m+1)``.  ``verify_final=True`` records the
    true residual norm as ``info["true_resid_norm"]`` (one uncounted
    matvec).

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "tfqmr")
    dev = b.device
    if matvec_max is None:
        matvec_max = 2 * rows(b)
    matvec_max = int(matvec_max)
    maxiter = max(1, matvec_max // 2 + 1)

    if x0 is None:
        x = torch.zeros_like(b)
        r0 = b
    else:
        x = to_tensor(x0, device=dev).to(b.dtype)
        r0 = b - apply_op(A, x)          # not counted (tfqmr.py:59-60)

    rho = dotu(r0, r0).item()
    resid0 = math.sqrt(abs(rho))
    thresh = max(atol, rtol * resid0)
    hist = [resid0]
    resid = resid0
    broken = not math.isfinite(resid0)
    done = not resid0 > thresh or broken
    # pre-loop: z = M y; u = A z, one counted matvec (tfqmr.py:78-86)
    w = y = r0
    z = apply_op(M, y) if M is not None else y
    u = v = apply_op(A, z) if not done else torch.zeros_like(b)
    nmv = 0 if done else 1
    d = torch.zeros_like(b)
    theta, eta, m = 0.0, 0.0, 0.0
    k = 0
    while not done:
        k += 1
        sigma_t = dotu(r0, v)
        alpha_t = rho / sigma_t
        w1 = torch.addcmul(w, alpha_t, u, value=-1)
        sigma, alpha, nw = torch.stack(
            [sigma_t, alpha_t,
             norm(w1).to(sigma_t.dtype)]).tolist()
        if (sigma == 0 or not finite(sigma) or rho == 0
                or not math.isfinite(resid)):
            broken = True
            break
        # first half-step
        w, d, x1, theta, eta, r1 = _rotate(w1, abs(nw), d, z, x, alpha,
                                           theta, eta, resid)
        m = 2.0 * k - 1.0
        if (r1 * math.sqrt(m + 1) < thresh or nmv >= matvec_max
                or not math.isfinite(r1)):
            if math.isfinite(r1):
                x, resid = x1, r1
            else:
                broken = True
            hist.append(resid)
            break
        # second half-step
        m += 1.0
        y = torch.addcmul(y, alpha_t, v, value=-1)
        z = apply_op(M, y) if M is not None else y
        u = apply_op(A, z)
        nmv += 1
        w2 = torch.addcmul(w, alpha_t, u, value=-1)
        nw, rho_next = torch.stack(
            [norm(w2).to(sigma_t.dtype),
             dotu(r0, w2)]).tolist()
        w, d, x2, theta, eta, r2 = _rotate(w2, abs(nw), d, z, x1, alpha,
                                           theta, eta, r1)
        if (r2 * math.sqrt(m + 1) < thresh or nmv >= matvec_max
                or not math.isfinite(r2)):
            if math.isfinite(r2):
                x, resid = x2, r2
            else:
                broken = True
            hist.append(resid)
            break
        x, resid = x2, r2
        hist.append(resid)
        # direction refresh (tfqmr.py:128-151)
        beta = rho_next / rho
        v_part = torch.add(u, v, alpha=beta).mul_(beta)
        y = torch.add(w, y, alpha=beta)
        z = apply_op(M, y) if M is not None else y
        u = apply_op(A, z)
        nmv += 1
        v = v_part + u
        rho = rho_next
        done = nmv >= matvec_max

    converged = resid * math.sqrt(m + 1) < thresh
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
        info={"quasi_residual": torch.tensor(resid, dtype=rdt, device=dev)})
    if verify_final:
        res = attach_true_residual(A, b, res)
    return res
