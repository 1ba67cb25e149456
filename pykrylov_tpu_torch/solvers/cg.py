"""Preconditioned conjugate gradients as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/cg.py`` (its unverified path,
``_cg`` at ``cg.py:45-248``), after the reference CG
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
"""

from __future__ import annotations

import torch

from .common import (apply_op, as_operator, attach_true_residual,
                     default_maxiter, history_init, history_push,
                     promote_rhs, require_square, threshold_of, vdot_real)
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["cg", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}


def cg(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8, maxiter=None,
       matvec_max=None, check_curvature=False, store_history=False,
       store_iterates=False, store_resids=False, replace_every=None,
       verify_final=False):
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
    replace_every : residual replacement (verified arithmetic); not
        ported yet, so a nonzero value raises.
    verify_final : record the true residual norm as
        ``info["true_resid_norm"]`` (one uncounted matvec).

    Returns :class:`SolveResult`.
    """
    if replace_every:
        raise NotImplementedError(
            "cg(replace_every=...) is the verified-arithmetic path, not "
            "ported yet: ROADMAP.md queue 1 item 15")
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cg")
    if maxiter is None:
        maxiter = default_maxiter(b.shape[0], 1, matvec_max)
    maxiter = int(maxiter)
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
    resid_h, thresh_h = torch.stack([resid0, thresh]).tolist()
    while resid_h > thresh_h and k < maxiter:
        Ap = apply_op(A, p)
        pAp = vdot_real(p, Ap)
        # The step is taken before the curvature test so that both scalars
        # reach the host in one synchronisation; an aborted step is dropped.
        alpha = (ry / pAp).to(dtype)
        x2 = torch.addcmul(x, alpha, p)
        r2 = torch.addcmul(r, alpha, Ap, value=-1)
        y2 = apply_op(M, r2) if M is not None else r2
        ry2 = vdot_real(r2, y2)
        p2 = torch.addcmul(y2, (ry2 / ry).to(dtype), p)
        resid2 = torch.sqrt(ry2)
        if check_curvature:
            pAp_h, resid2_h = torch.stack([pAp, resid2]).tolist()
            if pAp_h <= 0:
                # Record the direction of nonpositive curvature and abort;
                # history rows repeat the current values (the reference
                # appends nothing on abort).
                k += 1
                definite = False
                inf_desc = p
                history_push(hist, k, resid)
                history_push(curv, k, pAp)
                history_push(iters, k, x)
                history_push(resids, k, y)
                break
        else:
            resid2_h = resid2.item()
        x, r, y, p, ry, resid, resid_h = x2, r2, y2, p2, ry2, resid2, resid2_h
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
