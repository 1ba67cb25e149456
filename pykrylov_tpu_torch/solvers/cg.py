"""Preconditioned conjugate gradients as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/cg.py`` (``_cg`` at ``cg.py:45-248``
and the ``cg`` wrapper), after the reference CG
(PyKrylov's ``pykrylov/cg/cg.py:9-165``).  The JAX package fuses the
iteration into one ``lax.while_loop``; PyTorch runs eagerly, so this is a
Python loop as in PyKrylov: one matvec, two dots and three axpys per
iteration, all on the device of ``b``, and one host synchronisation per
iteration, on the stop test.

Preserved semantics (SURVEY §2.3):
  * preconditioned residual norm ``residNorm = sqrt(r'·M r)`` drives the
    stopping rule ``max(abstol, reltol · residNorm0)`` (``cg.py:99-102``);
  * ``matvec_max`` cap (default 2n) on operator applications;
  * optional curvature check: if ``p'Ap <= 0`` the method aborts, flags the
    operator indefinite and returns the direction of (near-)infinite
    descent for trust-region callers (``cg.py:119-124``);
  * optional residual, iterate and residual-vector histories
    (``cg.py:66-67,101,133-143,155``) in NaN-filled device buffers.

With ``replace_every`` the loop is the JAX package's verified ff-CG
(:func:`_cg_verified`): x and r ride double-f32 (hi, lo) carries
(:mod:`..utils.ff`), the true residual is recomputed, and the direction
restarted from it, whenever the recurrence claims its leg target or every
``replace_every`` iterations, and the loop stops only on a true residual.
"""

from __future__ import annotations

import torch

from .common import (apply_op, as_operator, attach_true_residual,
                     default_maxiter, history_init, history_push, host_read,
                     norm, promote_rhs, require_square, rows, threshold_of,
                     vdot_real, vdots_norms)
from .ffmv import resolve_ff_matvec
from .result import SolveResult
from ..utils.ff import ff_add_ff, two_prod, two_sum
from ..utils.observe import span
from ..utils.types import to_tensor

__all__ = ["cg", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}


def _precondition(M, r):
    """``M r`` inside a ``product`` span, or ``r`` without a
    preconditioner."""
    if M is None:
        return r
    with span("product"):
        return apply_op(M, r)


def cg(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8, maxiter=None,
       matvec_max=None, check_curvature=False, store_history=False,
       store_iterates=False, store_resids=False, replace_every=None,
       leg_rtol=1e-2, verify_final=False):
    """Solve SPD ``A x = b`` by preconditioned conjugate gradients.

    Parameters
    ----------
    A : LinearOperator or dense tensor — symmetric positive definite.
    b : right-hand side vector; the solve runs on its device.
    x0 : optional initial guess (costs one extra matvec, ``cg.py:85-88``).
    M : optional preconditioner operator approximating A^{-1}.
    rtol, atol : stopping rule ``resid <= max(atol, rtol * resid0)`` on the
        preconditioned residual norm sqrt(r'Mr).
    maxiter : iteration cap; default derived from ``matvec_max`` (2n).
    check_curvature : abort on nonpositive curvature and report the
        direction of infinite descent in ``result.info``.
    store_history : keep the residual-norm history (and the per-iteration
        curvature ``p'Ap`` as ``info["curvatures"]``).
    store_iterates : keep every iterate in a (maxiter+1, n) buffer,
        ``result.info["iterates"]`` (NaN rows beyond ``n_iter``).
    store_resids : likewise for the preconditioned residual vectors
        ``y = M r`` (``result.info["resids"]``; reference cg.py:97,143).
    replace_every : van der Vorst-Ye residual replacement with this
        period (verified stopping): the true residual ``b - A x`` is
        recomputed every ``replace_every`` iterations and whenever the
        recurrence claims its leg target, and the direction restarts from
        it.  The stopping rule then runs on the plain 2-norm of the true
        residual (M only accelerates).  Each replacement costs one
        compensated matvec where the operator's storage has one
        (:func:`~.ffmv.resolve_ff_matvec`; the iterations' products are
        compensated too), else two plain applies, counted in
        ``n_matvec``; ``info["n_replacements"]`` counts them and
        ``info["x_lo"]`` is the solution's double-f32 low part.
    leg_rtol : the recurrence's reduction target between replacements: a
        leg claims at ``max(leg_rtol * leg_start_resid, threshold)``.
    verify_final : record the true residual norm as
        ``info["true_resid_norm"]`` (one uncounted matvec).

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cg")
    if maxiter is None:
        maxiter = default_maxiter(rows(b), 1, matvec_max)
    maxiter = int(maxiter)
    if replace_every:
        res = _cg_verified(A, b, x0, M, rtol, atol, maxiter,
                           check_curvature, store_history, store_iterates,
                           store_resids, int(replace_every), float(leg_rtol),
                           resolve_ff_matvec(A))
        return attach_true_residual(A, b, res) if verify_final else res
    dtype, dev, n = b.dtype, b.device, b.shape[0]

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        extra_matvec = 0
    else:
        x = to_tensor(x0, device=dev).to(dtype)
        r = b - apply_op(A, x)
        extra_matvec = 1

    y = apply_op(M, r) if M is not None else r
    ry = vdot_real(r, y)
    resid0 = torch.sqrt(ry)
    rdtype = resid0.dtype
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_push(history_init(store_history, maxiter, rdtype, dev),
                        0, resid0)
    curv = history_init(store_history, maxiter, rdtype, dev)
    iters = history_push(history_init(store_iterates, maxiter, dtype, dev,
                                      n), 0, x)
    resids = history_push(history_init(store_resids, maxiter, dtype, dev,
                                       n), 0, y)

    p = y
    k = 0
    definite = True
    inf_desc = torch.zeros_like(b)
    resid = resid0
    resid_h, thresh_h = host_read(torch.stack([resid0, thresh]))
    while resid_h > thresh_h and k < maxiter:
        with span("cg.iter"):
            with span("product"):
                Ap = apply_op(A, p)
            with span("dots"):
                pAp = vdot_real(p, Ap)
            # The step is taken before the curvature test so that both
            # scalars reach the host in one synchronisation; an aborted
            # step is dropped.
            with span("update"):
                alpha = (ry / pAp).to(dtype)
                x2 = torch.addcmul(x, alpha, p)
                r2 = torch.addcmul(r, alpha, Ap, value=-1)
            y2 = _precondition(M, r2)
            with span("dots"):
                ry2 = vdot_real(r2, y2)
                resid2 = torch.sqrt(ry2)
            with span("direction"):
                p2 = torch.addcmul(y2, (ry2 / ry).to(dtype), p)
            if check_curvature:
                pAp_h, resid2_h = host_read(torch.stack([pAp, resid2]))
                if pAp_h <= 0:
                    # Record the direction of nonpositive curvature and
                    # abort; history rows repeat the current values (the
                    # reference appends nothing on abort).
                    k += 1
                    definite = False
                    inf_desc = p
                    history_push(hist, k, resid)
                    history_push(curv, k, pAp)
                    history_push(iters, k, x)
                    history_push(resids, k, y)
                    break
            else:
                resid2_h = host_read(resid2)
            x, r, y, p, ry = x2, r2, y2, p2, ry2
            resid, resid_h = resid2, resid2_h
            k += 1
            history_push(hist, k, resid)
            history_push(curv, k, pAp)
            history_push(iters, k, x)
            history_push(resids, k, y)

    converged = resid_h <= thresh_h
    istop = 0 if converged else (1 if definite else 2)
    info = {"definite": torch.tensor(definite, device=dev)}
    if check_curvature:
        info["infinite_descent"] = inf_desc
    if store_iterates:
        info["iterates"] = iters
    if store_resids:
        info["resids"] = resids
    if store_history:
        info["curvatures"] = curv
    res = SolveResult(
        x=x, converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(k + extra_matvec, dtype=torch.int32,
                              device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist, info=info)
    if verify_final:
        res = attach_true_residual(A, b, res)
    return res


def _cg_verified(A, b, x0, M, rtol, atol, maxiter, check_curvature,
                 store_history, store_iterates, store_resids, replace_every,
                 leg_rtol, ff_mv):
    """ff-CG, the JAX package's ``replace_every`` branch of ``_cg``.

    Each leg targets a ``leg_rtol`` reduction of its own verified starting
    residual; when the recurrence claims it, or every ``replace_every``
    iterations as a drift bound, the true residual is recomputed from the
    (hi, lo) iterate (compensated where the storage allows, through an
    error-free ``two_sum`` either way) and p restarts from it (replacing r
    but keeping p was measured to diverge in the JAX package).  With a
    compensated product the iterations' ``A p`` are compensated too.  The
    host reads each iteration's candidate residual norm (and ``p'Ap`` for
    the curvature check) in one synchronisation, and the replacement's
    norm in a second one only when it runs, so a replacement the host
    knows is not due is never evaluated."""
    dtype, dev, n = b.dtype, b.device, b.shape[0]
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        extra_matvec = 0
    else:
        x = to_tensor(x0, device=dev).to(dtype)
        r = b - apply_op(A, x)
        extra_matvec = 1
    zero = torch.zeros_like(b)
    xl = rl = zero
    y = apply_op(M, r) if M is not None else r
    (ry,), (resid0,) = vdots_norms([(r, y)], [r])
    rdtype = resid0.dtype
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_push(history_init(store_history, maxiter, rdtype, dev),
                        0, resid0)
    curv = history_init(store_history, maxiter, rdtype, dev)
    iters = history_push(history_init(store_iterates, maxiter, dtype, dev,
                                      n), 0, x)
    resids = history_push(history_init(store_resids, maxiter, dtype, dev,
                                       n), 0, y)

    p = y
    k = nrep = 0
    definite = True
    inf_desc = zero
    resid = resid0
    resid_h, thresh_h = host_read(torch.stack([resid0, thresh]))
    leg_r0 = resid_h
    while resid_h > thresh_h and k < maxiter:
        with span("cg.iter"):
            with span("product"):
                if ff_mv is not None:
                    Ap, Apl = ff_mv(p, zero)
                else:
                    Ap, Apl = apply_op(A, p), None
            with span("dots"):
                pAp = vdot_real(p, Ap)
                if Apl is not None:
                    pAp = pAp + vdot_real(p, Apl)
            with span("update"):
                alpha = (ry / pAp).to(dtype)
                ps, pe = two_prod(alpha, p)
                x2, xl2 = ff_add_ff(x, xl, ps, pe)
                qs, qe = two_prod(-alpha, Ap)
                if Apl is not None:
                    qe = qe - alpha * Apl
                r2, rl2 = ff_add_ff(r, rl, qs, qe)
            y2 = _precondition(M, r2)
            with span("dots"):
                (ry2,), (resid2,) = vdots_norms([(r2, y2)], [r2])
            if check_curvature:
                pAp_h, resid2_h = host_read(torch.stack([pAp, resid2]))
                if pAp_h <= 0:
                    k += 1
                    definite = False
                    inf_desc = p
                    history_push(hist, k, resid)
                    history_push(curv, k, pAp)
                    history_push(iters, k, x)
                    history_push(resids, k, y)
                    break
            else:
                resid2_h = host_read(resid2)
            if resid2_h <= max(leg_rtol * leg_r0, thresh_h) \
                    or (k + 1) % replace_every == 0:
                with span("product"):
                    if ff_mv is not None:
                        sh, sl = ff_mv(x2, xl2)
                    else:
                        sh = apply_op(A, x2)
                        sl = apply_op(A, xl2)
                with span("update"):
                    d, de = two_sum(b, -sh)
                    r2, rl2 = two_sum(d, de - sl)
                y2 = _precondition(M, r2)
                with span("dots"):
                    (ry2,), (resid2,) = vdots_norms([(r2, y2)], [r2])
                resid2_h = leg_r0 = host_read(resid2)
                nrep += 1
                p2 = y2
            else:
                with span("direction"):
                    p2 = y2 + (ry2 / ry).to(dtype) * p
            x, xl, r, rl, y, p, ry = x2, xl2, r2, rl2, y2, p2, ry2
            resid, resid_h = resid2, resid2_h
            k += 1
            history_push(hist, k, resid)
            history_push(curv, k, pAp)
            history_push(iters, k, x)
            history_push(resids, k, y)

    converged = resid_h <= thresh_h
    istop = 0 if converged else (1 if definite else 2)
    info = {"definite": torch.tensor(definite, device=dev),
            "n_replacements": torch.tensor(nrep, dtype=torch.int32,
                                           device=dev),
            "x_lo": xl}
    if check_curvature:
        info["infinite_descent"] = inf_desc
    if store_iterates:
        info["iterates"] = iters
    if store_resids:
        info["resids"] = resids
    if store_history:
        info["curvatures"] = curv
    # a compensated replacement is one (ff) product, a plain one two applies
    n_matvec = k + extra_matvec + nrep * (1 if ff_mv is not None else 2)
    return SolveResult(
        x=x, converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(n_matvec, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist, info=info)
