"""Pipelined (communication-hiding) conjugate gradients as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/pipelined.py`` (``_cg_pipelined``
and ``cg_pipelined``), after Ghysels & Vanroose's pipelined CG (PAPERS.md:
arXiv:1801.04728, arXiv:1706.05988, arXiv:2105.06176).  Classic CG has two
dependent reductions an iteration (``r'u`` and ``p'Ap``); the pipelined
recurrence computes both dots from the same vectors, so they are one
reduction, and the iteration's preconditioner apply and matvec (``m = M w;
n = A m``) do not depend on it.

State recurrences (preconditioned pipelined CG):

    gamma = r'u,  delta = w'u            (the one reduction)
    m = M w ; n = A m                    (independent of it)
    beta = gamma/gamma_old ; alpha = gamma / (delta - beta*gamma/alpha_old)
    z <- n + beta z ; q <- m + beta q ; s <- w + beta s ; p <- u + beta p
    x <- x + alpha p ; r <- r - alpha s ; u <- u - alpha q ; w <- w - alpha z

The JAX package decides whether to stop before it computes ``m`` and
``n``.  Here each iteration first enqueues both dots and then ``M w`` and
``A m``, and only then reads ``gamma`` and ``delta`` on the host, in one
``tolist()``, so the device runs the product while the host waits on the
read.  The iteration that stops on the test drops the product it enqueued:
``n_matvec`` keeps the JAX package's count, and a solve that stops on its
test has launched one operator product (and one preconditioner apply) more
than ``n_matvec`` says.  ``alpha`` and ``beta`` are host floats (f64),
as in the port's other single-rhs solvers.

``replace_every=k`` restores every coupled recurrence to its true value
every k iterations (Cools & Vanroose, arXiv:1706.05988): 4 operator and 2
preconditioner applies, counted as 4 matvecs.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, default_maxiter, history_from,
                     promote_rhs, real_dtype, require_square, rows,
                     threshold_of, vdot_real)
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["cg_pipelined", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
}


def cg_pipelined(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                 maxiter=None, matvec_max=None, replace_every=0,
                 store_history=False):
    """Solve SPD ``A x = b`` by pipelined (communication-hiding) CG.

    Same contract as :func:`~.cg.cg`: the stopping rule runs on the
    preconditioned residual norm ``sqrt(|r'u|)``.  ``replace_every=k``
    restores all coupled recurrences to their true values every k
    iterations (4 extra operator applications each time); the JAX
    package recommends ~50 in float64 and ~10 in float32 for
    ill-conditioned systems.

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cg_pipelined")
    if maxiter is None:
        maxiter = default_maxiter(rows(b), 1, matvec_max)
    maxiter, replace_every = int(maxiter), int(replace_every)
    dtype, dev = b.dtype, b.device

    def precon(v):
        return apply_op(M, v) if M is not None else v

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        nmv = 0
    else:
        x = to_tensor(x0, device=dev).to(dtype)
        r = b - apply_op(A, x)
        nmv = 1
    u = precon(r)
    w = apply_op(A, u)
    nmv += 1
    resid0 = torch.sqrt(torch.abs(vdot_real(r, u))).to(real_dtype(dtype))
    thresh = threshold_of(resid0, rtol, atol)
    resid, thresh_h = torch.stack([resid0, thresh]).tolist()
    hist = [resid]

    z = q = s = p = torch.zeros_like(b)
    gamma_old = alpha_old = 1.0
    k = 0
    done = resid <= thresh_h
    while not done and k < maxiter:
        dots = torch.stack([vdot_real(r, u), vdot_real(w, u)])
        # the product goes to the device before the host waits on the dots
        m = precon(w)
        nv = apply_op(A, m)
        gamma, delta = dots.tolist()
        resid = math.sqrt(abs(gamma))
        hist[k:] = [resid]
        if resid <= thresh_h:
            done = True             # the enqueued product is dropped
            break
        if k == 0:
            beta, alpha = 0.0, gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / alpha_old)
        z = torch.add(nv, z, alpha=beta)
        q = torch.add(m, q, alpha=beta)
        s = torch.add(w, s, alpha=beta)
        p = torch.add(u, p, alpha=beta)
        x = torch.add(x, p, alpha=alpha)
        r = torch.add(r, s, alpha=-alpha)
        u = torch.add(u, q, alpha=-alpha)
        w = torch.add(w, z, alpha=-alpha)
        k += 1
        nmv += 1
        if replace_every and k % replace_every == 0:
            # full replacement: restoring only r, u, w leaves s, q, z
            # inconsistent and makes the drift worse
            r = b - apply_op(A, x)
            u = precon(r)
            w = apply_op(A, u)
            s = apply_op(A, p)
            q = precon(s)
            z = apply_op(A, q)
            nmv += 4
        gamma_old, alpha_old = gamma, alpha

    rdt = resid0.dtype
    converged = resid <= thresh_h
    return SolveResult(
        x=x, converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(0 if converged else 1, dtype=torch.int32,
                           device=dev),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(nmv, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(resid, dtype=rdt, device=dev),
        resid_norm0=resid0,
        resid_history=history_from(store_history, maxiter, hist, rdt, dev),
        info={})
