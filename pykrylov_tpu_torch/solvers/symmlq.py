"""SYMMLQ (Paige & Saunders) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/symmlq.py`` (``_symmlq`` at
``symmlq.py:58`` and ``symmlq`` at ``:250``), after the reference SYMMLQ
(PyKrylov's ``pykrylov/symmlq/symmlq.py:17-400``).  Symmetric, possibly
indefinite systems ``(A - shift I) x = b``; one matvec, two dots and four
axpys per iteration (``symmlq.py:24-25``); the preconditioner must be SPD.
As in :mod:`.minres`, the vectors stay on the device of ``b``, each
iteration's two dots reach the host in one synchronisation, and the plane
rotation, norm estimates and stop tests run on Python floats.

Preserved semantics (SURVEY §2.3):
  * istop table -1..8 (``symmlq.py:99-109``) with the reference's test
    ordering (``symmlq.py:273-277``), tested at the top of each iteration
    from the previous step's quantities;
  * local reorthogonalization of the second Lanczos vector against the
    first (``symmlq.py:181-186``);
  * LQ-vs-CG exit: moves to the CG point when ``cgnorm < lqnorm``
    (``symmlq.py:356-365``), then adds the accumulated step along ``b``
    (``symmlq.py:367-374``);
  * the true final residual is recomputed with one extra counted matvec
    (``symmlq.py:376-381``);
  * ``matvec_max`` default 2n+2 (``symmlq.py:87``).

Reference bug not replicated (SURVEY §7): ``symmlq.py:162`` calls the
nonexistent ``self.matvec(v)``; the first Lanczos step here uses the
operator itself.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, fdiv,
                     history_from, history_init, history_push, norm,
                     promote_rhs, real_dtype, require_square, rows, vdot_real)
from .result import SolveResult
from ..utils.utils import check_symmetric

__all__ = ["symmlq", "ISTOP_MSG"]

ISTOP_MSG = {
    -1: "beta2 = 0. If M = I, b and x are eigenvectors",
    0: "beta1 = 0. The exact solution is x = 0",
    1: "requested accuracy achieved, as determined by rtol",
    2: "reasonable accuracy achieved, given eps",
    3: "x has converged to an eigenvector",
    4: "acond has exceeded 0.1/eps",
    5: "the iteration limit was reached",
    6: "the operator does not define a symmetric matrix",
    7: "the preconditioner does not define a symmetric matrix",
    8: "the preconditioner does not define a pos-def preconditioner",
}

_CONVERGED_CODES = (1, 2)


def _symmlq(A, b, M, shift, rtol, matvec_max, store_history,
            store_iterates):
    dtype, dev, n = b.dtype, b.device, b.shape[0]
    rdtype = real_dtype(dtype)
    eps = float(torch.finfo(rdtype).eps)
    itnlim = max(1, matvec_max - 2)

    # ---- first Lanczos vector (symmlq.py:128-146) -------------------------
    r1 = b
    y = apply_op(M, r1) if M is not None else r1
    beta1_sq = vdot_real(r1, y).item()
    zero_b = beta1_sq == 0
    dead = beta1_sq < 0 or zero_b
    beta1 = math.sqrt(max(beta1_sq, 0.0))
    istop = 8 if beta1_sq < 0 else 0
    x = torch.zeros_like(b)
    w = torch.zeros_like(b)
    alfa = beta = 0.0
    r2 = y
    if not dead:
        # ---- second Lanczos vector, locally reorthogonalized against the
        # first (symmlq.py:158-199; the first step counts one matvec) -------
        v = y / beta1
        y = apply_op(A, v)
        if shift:
            y = y - shift * v
        alfa = vdot_real(v, y).item()
        y = torch.add(y, r1, alpha=-alfa / beta1)
        z, ss = torch.stack([vdot_real(v, y), vdot_real(v, v)]).tolist()
        y = torch.add(y, v, alpha=-z / ss)
        r2 = y
        y = apply_op(M, r2) if M is not None else r2
        beta_sq = vdot_real(r2, y).item()
        if beta_sq < 0:
            istop = 8
            dead = True
        beta = math.sqrt(max(beta_sq, 0.0))
        if istop == 0 and beta <= eps:
            istop = -1

    hist = [beta1]
    iters = history_push(history_init(store_iterates, itnlim, dtype, dev, n),
                         0, x)
    oldb, gbar, dbar = beta1, alfa, beta
    rhs1, rhs2, snprod, bstep = beta1, 0.0, 1.0, 0.0
    tnorm, ynorm2 = alfa ** 2 + beta ** 2, 0.0
    gmax = gmin = abs(alfa) + eps
    cgnorm = lqnorm = beta1
    diag = eps if alfa == 0 else alfa
    acond = anorm = 0.0
    itn = 0
    nmv = 0 if dead else 1
    done = dead
    while not done and nmv < matvec_max:
        itn += 1
        # ---- estimate norms and test (top of loop, symmlq.py:237-277) ----
        anorm = math.sqrt(tnorm)
        ynorm = math.sqrt(ynorm2)
        epsx = anorm * ynorm * eps
        epsr = anorm * ynorm * rtol
        diag = anorm * eps if gbar == 0 else gbar
        lqnorm = math.sqrt(rhs1 ** 2 + rhs2 ** 2)
        cgnorm = fdiv(snprod * beta1 * beta, abs(diag))
        acond = (gmax / gmin if lqnorm < cgnorm
                 else fdiv(gmax, min(gmin, abs(diag))))
        if istop == 0:
            if nmv >= matvec_max:
                istop = 5
            if acond >= 0.1 / eps:
                istop = 4
            if epsx >= beta1:
                istop = 3
            if cgnorm <= epsx:
                istop = 2
            if cgnorm <= epsr:
                istop = 1
        hist.append(cgnorm)
        if istop != 0:
            break

        # ---- Lanczos step (symmlq.py:286-302) ----------------------------
        v = y / beta
        y = apply_op(A, v)
        nmv += 1
        if shift:
            y = y - shift * v
        y = torch.add(y, r1, alpha=-beta / oldb)
        alfa_t = vdot_real(v, y)
        y = torch.addcmul(y, (alfa_t / beta).to(dtype), r2, value=-1)
        r1, r2 = r2, y
        y = apply_op(M, r2) if M is not None else r2
        oldb = beta
        alfa, beta_sq = torch.stack([alfa_t, vdot_real(r2, y)]).tolist()
        if beta_sq < 0:
            istop = 6
            break
        beta = math.sqrt(beta_sq)
        tnorm = tnorm + alfa ** 2 + oldb ** 2 + beta ** 2
        # ---- plane rotation for Q (symmlq.py:307-315) --------------------
        gamma = math.hypot(gbar, oldb)
        cs = gbar / gamma
        sn = oldb / gamma
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        # ---- update x along the LQ directions (symmlq.py:319-325) --------
        z = rhs1 / gamma
        x = torch.add(x, w, alpha=z * cs).add_(v, alpha=z * sn)
        w = torch.mul(w, sn).add_(v, alpha=-cs)
        # ---- step along b and norms (symmlq.py:331-338) ------------------
        bstep = snprod * cs * z + bstep
        snprod = snprod * sn
        gmax = max(gmax, gamma)
        gmin = min(gmin, gamma)
        ynorm2 = z ** 2 + ynorm2
        rhs1 = rhs2 - delta * z
        rhs2 = -epsln * z
        if itn <= itnlim:
            history_push(iters, itn, x)
    # Budget exhausted through the loop guard: the reference leaves istop 0
    # there (its in-loop nMatvec >= matvec_max test is unreachable); report
    # the iteration limit.
    if istop == 0 and not zero_b:
        istop = 5

    if dead:
        x = torch.zeros_like(b)
        rnorm = 0.0 if zero_b else norm(b).item()
        xnorm = 0.0
    else:
        # ---- move to the CG point if better (symmlq.py:356-365) ----------
        if cgnorm < lqnorm:
            zbar = rhs1 / diag
            bstep = snprod * zbar + bstep
            x = torch.add(x, w, alpha=zbar)
        # ---- add the step along b (symmlq.py:367-374) --------------------
        yb = apply_op(M, b) if M is not None else b
        x = torch.add(x, yb, alpha=bstep / beta1)
        # ---- true final residual, one counted matvec (symmlq.py:376-381)
        ax = apply_op(A, x)
        if shift:
            ax = ax - shift * x
        nmv += 1
        rnorm, xnorm = torch.stack([norm(b - ax),
                                    norm(x)]).tolist()

    info = {key: torch.tensor(val, dtype=rdtype, device=dev)
            for key, val in (("Anorm", anorm), ("Acond", acond),
                             ("xnorm", xnorm), ("cgnorm", cgnorm),
                             ("lqnorm", lqnorm))}
    if store_iterates:
        info["iterates"] = iters
    return SolveResult(
        x=x, converged=torch.tensor(zero_b or istop in _CONVERGED_CODES,
                                    device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(nmv, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(rnorm, dtype=rdtype, device=dev),
        resid_norm0=torch.tensor(beta1, dtype=rdtype, device=dev),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info=info)


def symmlq(A, b, *, M=None, shift=0.0, rtol=1.0e-9, matvec_max=None,
           check=False, store_history=False, store_iterates=False,
           verify_final=False):
    """Solve symmetric (possibly indefinite) ``(A - shift I) x = b`` by
    SYMMLQ.

    Parameters
    ----------
    A : symmetric LinearOperator or dense tensor.
    b : right-hand side; the solve runs on its device.
    M : optional symmetric positive-definite preconditioner.
    shift : solves the shifted system (``symmlq.py:91-92``).
    rtol : relative stopping tolerance (reference default 1e-9).
    matvec_max : matvec cap, default 2n+2 (``symmlq.py:87``).
    check : randomized symmetry checks of A and M; a failure gives istop 6
        or 7 without running the iteration (``symmlq.py:138-146,163-171``).
    store_history : keep the CG-point residual-norm estimates.
    store_iterates : keep the LQ iterates in an (itnlim+1, n) buffer,
        ``info["iterates"]`` (NaN rows beyond ``n_iter``).
    verify_final : record the true residual norm as
        ``info["true_resid_norm"]`` (one uncounted matvec).

    Returns :class:`SolveResult`; ``resid_norm`` is the true final residual
    recomputed with an extra matvec, as in the reference.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "symmlq")
    if matvec_max is None:
        matvec_max = 2 * rows(b) + 2
    if check:
        fail = None
        if not check_symmetric(A):
            fail = 6
        elif M is not None and not check_symmetric(M):
            fail = 7
        if fail is not None:
            rdtype = real_dtype(b.dtype)
            zero = torch.zeros((), dtype=rdtype, device=b.device)
            return SolveResult(
                x=torch.zeros_like(b),
                converged=torch.tensor(False, device=b.device),
                istop=torch.tensor(fail, dtype=torch.int32, device=b.device),
                n_iter=torch.tensor(0, dtype=torch.int32, device=b.device),
                n_matvec=torch.tensor(0, dtype=torch.int32,
                                      device=b.device),
                resid_norm=zero, resid_norm0=zero, info={})
    res = _symmlq(A, b, M, float(shift), float(rtol), int(matvec_max),
                  bool(store_history), bool(store_iterates))
    if verify_final:
        res = attach_true_residual(A, b, res, float(shift))
    return res
