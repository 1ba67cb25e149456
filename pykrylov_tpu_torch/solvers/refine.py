"""Verified iterative refinement around the square and least-squares
solvers.

Counterpart of ``pykrylov_tpu/solvers/refine.py``.  ``refined_solve`` wraps
any square-system solver (cg, minres, symmlq, bicgstab, cgs, tfqmr) in an
outer refinement loop:

  1. run the inner solver on the residual system ``A d = r`` to a modest
     leg tolerance (``leg_rtol``, well inside f32's reliable range),
  2. accumulate ``x += d`` on a double-f32 (hi, lo) carry
     (:mod:`..utils.ff`),
  3. recompute the true residual ``b - A x`` from the carry, with the
     compensated product where the operator's storage has one
     (:func:`~.ffmv.resolve_ff_matvec`), else two plain applies (one
     (n, 2K) block product for a block), combined by an error-free
     ``two_sum``,
  4. stop only on that verified residual.

``refined_lls`` does the same for least squares (LSQR or LSMR legs,
stopping on the true optimality residual ``||A'(b - A x)||``), and
``refined_solve_batched`` for an (n, K) block with one batched leg solver
a leg and per-column stop codes.  The reference needs none of this: it
runs f64 throughout, where unverified recurrences drift invisibly at its
tolerances.  In f32 an unverified stop means little on an ill-conditioned
system (MINRES on 1138bus at rtol 1e-8 reports an estimate 21x below its
true residual).

The drivers are host loops in the JAX package as well; here each leg is
one call of the port's eager solver and each verification one host read.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from .common import (apply_op, apply_op_T, as_operator, col_norms, norm,
                     promote_rhs, real_dtype, require_square, rows)
from .ffmv import resolve_ff_matmat, resolve_ff_matvec
from .result import SolveResult
from ..utils.ff import ff_add, ff_add_ff, two_sum

__all__ = ["refined_solve", "refined_solve_batched", "refined_lls",
           "ISTOP_MSG"]

ISTOP_MSG = {
    0: "verified residual small enough (relative/absolute tolerance "
       "reached)",
    1: "leg budget exhausted before verified convergence",
    2: "inner solver failed (breakdown or indefiniteness); see "
       "info['inner_istop']",
    3: "stagnation: verified residual stopped improving (precision "
       "floor reached)",
}

# consecutive no-progress legs (each tightening the leg tolerance 10x)
# after which the precision floor is declared (istop 3)
_MAX_TIGHTENS = 4


def _true_residual(A, b, xh, xl, ff):
    """``b - A (xh + xl)`` rounded to the working dtype: the compensated
    product ``ff`` where given, else two plain applies, combined through an
    error-free ``two_sum``."""
    if ff is not None:
        sh, sl = ff(xh, xl)
    else:
        sh, sl = apply_op(A, xh), apply_op(A, xl)
    d, de = two_sum(b, -sh)
    return d + (de - sl)


def _true_residual_block(A, B, Xh, Xl, ff_mm):
    """The block form of :func:`_true_residual`: without a compensated
    product, one (n, 2K) block product of ``[Xh, Xl]`` (one SpMM launch on
    the card) instead of two."""
    from .batched import _ff_product
    Sh, Sl = _ff_product(A, ff_mm, Xh, Xl)
    d, de = two_sum(B, -Sh)
    return d + (de - Sl)


def _accumulate(xh, xl, d, dl=None):
    if dl is None:
        return ff_add(xh, xl, d)
    return ff_add_ff(xh, xl, d, dl)


def _solver_params(solver):
    try:
        return inspect.signature(solver).parameters
    except (TypeError, ValueError):     # builtins, partials without one
        return {}


def _accepts_kwarg(solver, name):
    return name in _solver_params(solver)


def _leg_cap_kwarg(solver):
    """The solver's own iteration-cap keyword, for ``leg_maxiter``."""
    for name in ("itnlim", "maxiter", "matvec_max"):
        if name in _solver_params(solver):
            return name
    return None


def _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter):
    """The legs' keywords: ``verify_final`` stripped (the outer loop is the
    certificate), M forwarded, the leg cap mapped onto the solver's own
    keyword, and ``atol=0.0`` where the solver takes one (its absolute
    default would stop small-norm legs at once and report a reachable
    target as a precision floor)."""
    kwargs = dict(solver_kwargs)
    kwargs.pop("verify_final", None)
    if M is not None:
        kwargs["M"] = M
    if leg_maxiter is not None:
        cap = _leg_cap_kwarg(solver)
        if cap is not None:
            kwargs.setdefault(cap, int(leg_maxiter))
    if _accepts_kwarg(solver, "atol"):
        kwargs.setdefault("atol", 0.0)
    return kwargs


def _emitter(show, logger):
    def emit(line):
        if show:
            print(line)
        if logger is not None:
            logger.info(line)
    return emit if (show or logger is not None) else None


def _int_tensor(values, device):
    return torch.tensor(values or [0], dtype=torch.int32, device=device)


def refined_solve(solver, A, b, *, rtol=1.0e-6, atol=0.0, x0=None, M=None,
                  leg_rtol=1.0e-2, max_legs=40, stall_factor=0.9,
                  leg_maxiter=None, leg_replace_every="auto",
                  show=False, logger=None, **solver_kwargs):
    """Solve ``A x = b`` to a verified tolerance by iterative refinement
    with ``solver`` as the inner correction solver.

    Parameters
    ----------
    solver : one of the square-system solvers (``cg``, ``minres``,
        ``symmlq``, ``bicgstab``, ``cgs``, ``tfqmr``) or any callable
        ``solver(A, rhs, rtol=..., M=..., **kw) -> SolveResult``.
    A, b : operator and right-hand side.
    rtol, atol : the outer stop on the verified true residual,
        ``||b - A x|| <= max(atol, rtol * ||b - A x0||)`` in the plain
        2-norm (M only accelerates the legs).
    x0 : optional initial iterate, verified before the first leg.
    M : preconditioner forwarded to every leg.
    leg_rtol : the first legs' inner ``rtol``.  A leg that fails to shrink
        the verified residual below ``stall_factor`` times the previous one
        tightens it 10x (a worsening leg is reverted first); five
        consecutive no-progress legs declare the precision floor (istop 3).
    max_legs : outer iteration cap.
    stall_factor : the least per-leg reduction that counts as progress.
    leg_maxiter : optional per-leg iteration cap (the solver's ``itnlim``,
        ``maxiter`` or ``matvec_max``).
    leg_replace_every : ``"auto"`` gives MINRES legs ff-MINRES
        (``replace_every=50``), whose double-f32 recurrence stays
        drift-free through long legs; other solvers' legs run plain (ff-CG
        legs restart at each in-loop verification, which the outer loop
        makes redundant).  An integer gives every solver that takes
        ``replace_every`` that period; None turns it off.
    show, logger : a live row per leg, printed (``show``) or sent to a
        ``logging.Logger`` at INFO level.
    **solver_kwargs : forwarded to every leg (``verify_final`` stripped;
        ``atol=0.0`` added where the solver takes one).

    Returns
    -------
    :class:`SolveResult`: ``x`` is the double-f32 high part
    (``info["x_lo"]`` the low part), ``resid_norm`` the verified true
    residual norm, ``resid_history`` the per-leg verified norms,
    ``n_matvec`` the legs' matvecs plus one compensated (or two plain)
    products a verification; ``info`` holds ``n_legs``, ``inner_istop``,
    ``inner_n_iter``, ``inner_n_matvec``, ``inner_converged`` and
    ``true_resid_norm``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "refined_solve")
    ff = resolve_ff_matvec(A)
    verify_cost = 1 if ff is not None else 2

    n_matvec = 0
    xl = torch.zeros_like(b)
    if x0 is None:
        xh = torch.zeros_like(b)
        r = b
    else:
        xh = torch.as_tensor(x0, device=b.device).to(b.dtype)
        r = _true_residual(A, b, xh, xl, ff)
        n_matvec += verify_cost
    resid = norm(r)
    resid_h = resid0_h = resid.item()
    resid0 = resid
    thresh = max(float(atol), float(rtol) * resid0_h)

    leg_resids = [resid_h]
    inner_istops, inner_iters, inner_conv, inner_nmv = [], [], [], []
    istop = 1
    n_iter = 0
    kwargs = _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter)
    if leg_replace_every is not None \
            and _accepts_kwarg(solver, "replace_every"):
        if leg_replace_every == "auto":
            leg_replace_every = \
                50 if getattr(solver, "__name__", "") == "minres" else None
        if leg_replace_every is not None:
            kwargs.setdefault("replace_every", int(leg_replace_every))

    emit = _emitter(show, logger)
    if emit:
        emit("%4s  %10s  %6s  %6s  %12s  %9s"
             % ("leg", "leg rtol", "iters", "istop", "verified resid",
                "ratio"))
        emit("%4d  %10s  %6s  %6s  %12.5e  %9s"
             % (0, "-", "-", "-", resid_h, "-"))

    inner_rtol = float(leg_rtol)
    tightens = 0
    for _ in range(int(max_legs)):
        if resid_h <= thresh:
            istop = 0
            break
        res = solver(A, r, rtol=inner_rtol, **kwargs)
        leg_nmv, leg_it, leg_istop = (int(res.n_matvec), int(res.n_iter),
                                      int(res.istop))
        n_matvec += leg_nmv
        n_iter += leg_it
        inner_istops.append(leg_istop)
        inner_iters.append(leg_it)
        inner_nmv.append(leg_nmv)
        inner_conv.append(bool(res.converged))
        xh2, xl2 = _accumulate(xh, xl, res.x, (res.info or {}).get("x_lo"))
        r2 = _true_residual(A, b, xh2, xl2, ff)
        n_matvec += verify_cost
        new_resid = norm(r2)
        new_h = new_resid.item()
        leg_resids.append(new_h)
        if emit:
            emit("%4d  %10.1e  %6d  %6d  %12.5e  %9.3e"
                 % (len(inner_istops), inner_rtol, leg_it, leg_istop, new_h,
                    new_h / max(resid_h, 1e-300)))
        bad = not math.isfinite(new_h)
        if bad or new_h >= resid_h:
            # a worsening (or non-finite) correction: revert to the last
            # verified iterate and retry tighter
            if bad and not inner_conv[-1]:
                istop = 2       # an inner breakdown produced garbage
                break
            tightens += 1
            inner_rtol *= 0.1
        elif new_h > stall_factor * resid_h:
            # progress, but too slow: keep it and tighten the legs
            xh, xl, r, resid, resid_h = xh2, xl2, r2, new_resid, new_h
            tightens += 1
            inner_rtol *= 0.1
        else:
            xh, xl, r, resid, resid_h = xh2, xl2, r2, new_resid, new_h
            tightens = 0
        if tightens > _MAX_TIGHTENS:
            istop = 3
            break
    if resid_h <= thresh:
        istop = 0

    dev = b.device
    info = {
        "x_lo": xl,
        "n_legs": len(inner_istops),
        "inner_istop": _int_tensor(inner_istops, dev),
        "inner_n_iter": _int_tensor(inner_iters, dev),
        "inner_n_matvec": _int_tensor(inner_nmv, dev),
        "inner_converged": torch.tensor(inner_conv or [False], device=dev),
        "true_resid_norm": resid,
    }
    return SolveResult(
        x=xh, converged=torch.tensor(istop == 0, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(n_iter, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(n_matvec, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0,
        resid_history=torch.tensor(leg_resids, dtype=resid.dtype,
                                   device=dev),
        info=info)


def refined_lls(solver, A, b, *, atol=1.0e-5, btol=1.0e-6, x0=None,
                leg_tol=1.0e-3, max_legs=20, stall_factor=0.9,
                leg_maxiter=None, show=False, logger=None,
                **solver_kwargs):
    """Solve ``min ||A x - b||`` to a verified optimality tolerance by
    iterative refinement with ``solver`` (``lsqr`` or ``lsmr``) as the
    inner correction solver.

    Because the outer iterate keeps ``r = b - A x`` exact (double-f32 x,
    compensated residual), Björck's augmented-system refinement reduces to
    plain corrections: each leg solves ``min ||A d - r||`` and is
    accumulated on the (hi, lo) carry.  The stop runs on the true
    Euclidean optimality residual ``||A' (b - A x)||``, not the legs'
    recursive estimates.

    Parameters
    ----------
    solver : ``lsqr`` or ``lsmr``, or any callable ``solver(A, rhs,
        atol=..., btol=...) -> SolveResult`` that stops as LSQR does.
    atol : converged when ``||A' rt|| <= atol * ||A|| * ||rt||`` (LSQR's
        test2 on the verified residual; ``||A||`` is the largest of the
        legs' finite estimates and the verified lower bounds
        ``||A'rt||/||rt||``).  ``A' rt`` is one plain transpose product, so
        in f32 keep ``atol >= ~1e-6``.
    btol : converged when ``||rt|| <= btol * ||b||``.
    x0 : optional initial iterate, verified before the first leg.
    leg_tol : the first legs' ``atol``/``btol``; adapts as
        :func:`refined_solve`'s ``leg_rtol`` does, on the optimality norm.
    max_legs, stall_factor, leg_maxiter, show, logger : as in
        :func:`refined_solve`.
    **solver_kwargs : forwarded to every leg (``verify_final`` stripped).
        ``damp``, ``M`` and ``N`` raise ``ValueError``: a damped or
        preconditioned leg solves another correction equation than the
        outer verified metric.

    Returns
    -------
    :class:`SolveResult`: ``resid_norm`` is the verified ``||b - A x||``;
    ``info`` holds ``true_normar`` (the verified optimality norm),
    ``normar_history``, ``anorm`` (the estimate in the stop test) and
    :func:`refined_solve`'s ``x_lo``, ``n_legs`` and ``inner_*``.
    """
    damp = solver_kwargs.pop("damp", None)
    rejected = [name for name, val
                in (("damp", damp), ("M", solver_kwargs.pop("M", None)),
                    ("N", solver_kwargs.pop("N", None)))
                if val is not None and not (name == "damp" and not val)]
    if rejected:
        raise ValueError(
            "refined_lls does not support %r legs (the correction "
            "equation differs from the outer verified metric); "
            "refine the augmented operator instead, or use "
            "verify_final=True on a direct solve" % rejected[0])
    solver_kwargs.pop("verify_final", None)
    A = as_operator(A)
    b = promote_rhs(b, A, None)
    m, n = A.shape
    if b.ndim != 1 or rows(b) != m:
        raise ValueError("refined_lls: rhs has shape %s, expected (%d,)"
                         % (tuple(b.shape), m))
    ff = resolve_ff_matvec(A)
    # one forward product (two applies without a compensated one) and one
    # transpose product
    verify_cost = (1 if ff is not None else 2) + 1

    def verify(xh, xl):
        rt = _true_residual(A, b, xh, xl, ff)
        return rt, torch.stack([norm(rt), norm(apply_op_T(A, rt))])

    bnorm = norm(b).item()
    n_matvec = 0
    xl = torch.zeros(n, dtype=b.dtype, device=b.device)
    if x0 is None:
        xh = torch.zeros_like(xl)
        r = b
        norms = torch.stack([norm(b),
                             norm(apply_op_T(A, b))])
        n_matvec += 1       # b - A*0 is known; only A'b is computed
    else:
        xh = torch.as_tensor(x0, device=b.device).to(b.dtype)
        r, norms = verify(xh, xl)
        n_matvec += verify_cost
    resid, normar = norms.tolist()
    resid0 = resid

    normar_hist = [normar]
    leg_resids = [resid]
    inner_istops, inner_iters, inner_conv = [], [], []
    istop = 1
    n_iter = 0
    anorm = 0.0

    def absorb_anorm(est):
        nonlocal anorm
        est = float(est)
        if math.isfinite(est) and est > anorm:
            anorm = est

    def stopped():
        if resid <= float(btol) * bnorm or normar == 0.0:
            return True
        return anorm > 0 and normar <= (float(atol) * anorm
                                        * max(resid, 1e-300))

    if resid > 0:
        absorb_anorm(normar / resid)
    kwargs = dict(solver_kwargs)
    if leg_maxiter is not None:
        cap = _leg_cap_kwarg(solver)
        if cap is not None:
            kwargs.setdefault(cap, int(leg_maxiter))
    if _accepts_kwarg(solver, "etol"):
        # legs are optimality-driven: the energy-norm direct-error stop
        # would end them on an unrelated criterion
        kwargs.setdefault("etol", 0.0)

    emit = _emitter(show, logger)
    if emit:
        emit("%4s  %10s  %6s  %6s  %12s  %12s"
             % ("leg", "leg tol", "iters", "istop", "||r||", "||A'r||"))
        emit("%4d  %10s  %6s  %6s  %12.5e  %12.5e"
             % (0, "-", "-", "-", resid, normar))

    tighten_mult = 1.0
    tightens = 0
    for _ in range(int(max_legs)):
        if stopped():
            istop = 0
            break
        # a leg stopping at its own test2 <= tol leaves the verified
        # optimality residual near tol*||A||*||rt||, so once ||A|| is known
        # the legs aim 4x inside atol
        base = float(leg_tol)
        if anorm > 0 and float(atol) > 0:
            base = min(base, 0.25 * float(atol))
        inner_tol = base * tighten_mult
        res = solver(A, r, atol=inner_tol, btol=inner_tol, **kwargs)
        leg_nmv, leg_it, leg_istop = (int(res.n_matvec), int(res.n_iter),
                                      int(res.istop))
        n_matvec += leg_nmv
        n_iter += leg_it
        inner_istops.append(leg_istop)
        inner_iters.append(leg_it)
        inner_conv.append(bool(res.converged))
        leg_anorm = res.info.get("Anorm", res.info.get("normA"))
        if leg_anorm is not None:
            # a diverged leg's estimate must not loosen the threshold
            absorb_anorm(leg_anorm)
        xh2, xl2 = _accumulate(xh, xl, res.x)
        r2, norms = verify(xh2, xl2)
        n_matvec += verify_cost
        new_resid, new_normar = norms.tolist()
        leg_resids.append(new_resid)
        normar_hist.append(new_normar)
        if emit:
            emit("%4d  %10.1e  %6d  %6d  %12.5e  %12.5e"
                 % (len(inner_istops), inner_tol, leg_it, leg_istop,
                    new_resid, new_normar))
        if math.isfinite(new_normar) and new_resid > 0:
            absorb_anorm(new_normar / new_resid)
        bad = not math.isfinite(new_normar)
        if bad or new_normar >= normar:
            if bad and not inner_conv[-1]:
                istop = 2
                break
            tightens += 1
            tighten_mult *= 0.1
        elif new_normar > stall_factor * normar:
            xh, xl, r, resid, normar = xh2, xl2, r2, new_resid, new_normar
            tightens += 1
            tighten_mult *= 0.1
        else:
            xh, xl, r, resid, normar = xh2, xl2, r2, new_resid, new_normar
            tightens = 0
        if tightens > _MAX_TIGHTENS:
            istop = 3
            break
    if stopped():
        istop = 0

    dev = b.device
    rdtype = real_dtype(b.dtype)

    def scalar(v):
        return torch.tensor(v, dtype=rdtype, device=dev)

    info = {
        "x_lo": xl,
        "n_legs": len(inner_istops),
        "inner_istop": _int_tensor(inner_istops, dev),
        "inner_n_iter": _int_tensor(inner_iters, dev),
        "inner_converged": torch.tensor(inner_conv or [False], device=dev),
        "true_resid_norm": scalar(resid),
        "true_normar": scalar(normar),
        "normar_history": torch.tensor(normar_hist, dtype=rdtype,
                                       device=dev),
        "anorm": scalar(anorm),
    }
    return SolveResult(
        x=xh, converged=torch.tensor(istop == 0, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(n_iter, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(n_matvec, dtype=torch.int32, device=dev),
        resid_norm=scalar(resid), resid_norm0=scalar(resid0),
        resid_history=torch.tensor(leg_resids, dtype=rdtype, device=dev),
        info=info)


def refined_solve_batched(solver, A, B, *, rtol=1.0e-6, atol=0.0,
                          x0=None, M=None, leg_rtol=1.0e-2, max_legs=40,
                          stall_factor=0.9, leg_maxiter=None,
                          **solver_kwargs):
    """Block counterpart of :func:`refined_solve`: verified iterative
    refinement where every leg is one multi-RHS solve.

    ``solver`` is a batched square-system solver (``bicgstab_batched``,
    ``cgs_batched``, ``tfqmr_batched``, ``cg_batched``,
    ``minres_batched``) with the ``solver(A, B, rtol=..., **kw)`` block
    contract; this is the verified path for general (unsymmetric) blocks.
    Each column has its own verified threshold ``max(atol, rtol *
    ||b_k||)`` (``||b_k - A x0_k||`` with ``x0``), its own progress and
    stall accounting and its own istop (0 converged, 1 legs exhausted, 2
    inner breakdown, 3 precision floor); converged and frozen columns ride
    zero leg right-hand sides.  The leg tolerance is shared (a batched
    solver takes one ``rtol``) and tightens 10x whenever any active column
    fails its ``stall_factor`` reduction.

    Each verification is one compensated block product, or one (n, 2K)
    product of ``[X_hi, X_lo]`` (counted as two in ``n_matvec``, one SpMM
    launch on the card), and one host read.

    Returns :class:`SolveResult` with per-column fields; ``x`` (n, K) is the
    double-f32 high part (``info["x_lo"]`` the low part), ``resid_norm``
    the per-column verified residuals, ``resid_history`` the (legs+1, K)
    per-leg verified norms.
    """
    from .batched import _block_rhs, _check_x0
    A, B, M = _block_rhs("refined_solve_batched", A, B, M)
    n, K = B.shape
    dev = B.device
    ff_mm = resolve_ff_matmat(A)
    verify_cost = 1 if ff_mm is not None else 2

    def verify(Xh, Xl):
        R = _true_residual_block(A, B, Xh, Xl, ff_mm)
        return R, col_norms(R)

    n_matvec = 0
    Xl = torch.zeros_like(B)
    if x0 is None:
        Xh = torch.zeros_like(B)
        R = B
        Rnorm = col_norms(B)
    else:
        # the initial iterate is the outer accumulator, verified before the
        # first leg (not every leg's inner guess)
        X0 = torch.as_tensor(x0, device=dev)
        if X0.ndim == 1:
            X0 = X0[:, None].expand(n, K)
        Xh = _check_x0(X0, B, "refined_solve_batched").to(B.dtype).clone()
        R, Rnorm = verify(Xh, Xl)
        n_matvec = verify_cost
    resid = Rnorm.cpu().numpy().astype(np.float64)
    resid0 = resid.copy()
    thresh = np.maximum(float(atol), float(rtol) * resid0)

    active = resid > thresh
    istop = np.where(active, 1, 0).astype(np.int32)
    tightens = np.zeros(K, np.int32)
    leg_resids = [resid.copy()]
    inner_istops, inner_conv = [], []
    n_iter = 0
    kwargs = _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter)

    inner_rtol = float(leg_rtol)
    for _ in range(int(max_legs)):
        if not active.any():
            break
        on = torch.from_numpy(active).to(dev)
        Ract = torch.where(on[None, :], R, 0)
        res = solver(A, Ract, rtol=inner_rtol, **kwargs)
        n_matvec += int(res.n_matvec)
        n_iter += int(res.n_iter)
        inner_istops.append(res.istop.cpu().numpy().astype(np.int32))
        leg_conv = res.converged.cpu().numpy()
        inner_conv.append(leg_conv)
        Xh2, Xl2 = _accumulate(Xh, Xl, res.x, (res.info or {}).get("x_lo"))
        R2, new_norm = verify(Xh2, Xl2)
        n_matvec += verify_cost
        nr = new_norm.cpu().numpy().astype(np.float64)
        leg_resids.append(np.where(active, nr, resid))
        finite = np.isfinite(nr)
        improved = active & finite & (nr < resid)
        good = improved & (nr <= stall_factor * resid)
        keep = torch.from_numpy(improved).to(dev)[None, :]
        Xh = torch.where(keep, Xh2, Xh)
        Xl = torch.where(keep, Xl2, Xl)
        R = torch.where(keep, R2, R)
        resid = np.where(improved, nr, resid)
        # an inner breakdown that produced garbage: freeze with istop 2
        broke = active & ~finite & ~leg_conv
        istop[broke] = 2
        active &= ~broke
        # convergence first: a slow leg that crosses the threshold is
        # converged, not a floor
        done_cols = active & (resid <= thresh)
        istop[done_cols] = 0
        active &= ~done_cols
        # per-column stall accounting; the shared leg tolerance adapts
        not_good = active & ~good
        tightens = np.where(good, 0, np.where(active, tightens + 1,
                                              tightens))
        floor = active & (tightens > _MAX_TIGHTENS)
        istop[floor] = 3
        active &= ~floor
        if not_good.any():
            inner_rtol *= 0.1
    istop[resid <= thresh] = 0

    rdtype = B.real.dtype if B.is_complex() else B.dtype
    info = {
        "x_lo": Xl,
        "n_legs": len(inner_istops),
        "inner_istop": torch.from_numpy(
            np.stack(inner_istops) if inner_istops
            else np.zeros((1, K), np.int32)).to(dev),
        "inner_converged": torch.from_numpy(
            np.stack(inner_conv) if inner_conv
            else np.zeros((1, K), bool)).to(dev),
        "true_resid_norm": torch.tensor(resid, dtype=rdtype, device=dev),
    }
    return SolveResult(
        x=Xh, converged=torch.from_numpy(istop == 0).to(dev),
        istop=torch.from_numpy(istop).to(dev),
        n_iter=torch.tensor(n_iter, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(n_matvec, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(resid, dtype=rdtype, device=dev),
        resid_norm0=torch.tensor(resid0, dtype=rdtype, device=dev),
        resid_history=torch.tensor(np.stack(leg_resids), dtype=rdtype,
                                   device=dev),
        info=info)
