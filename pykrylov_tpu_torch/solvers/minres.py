"""MINRES (Paige & Saunders) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/minres.py`` (its unverified path,
``_minres`` at ``minres.py:61-417``, and the ``minres`` wrapper), after the
reference MINRES (PyKrylov's ``pykrylov/minres/minres.py:23-410``, itself a
translation of the Stanford SOL MATLAB code).  Symmetric, possibly
indefinite or singular systems ``(A - shift I) x = b``, also usable for
``min ||Ax - b||``.  One matvec and one preconditioner apply per iteration;
Lanczos tridiagonalization with a Givens-QR update of the solution.

The JAX package fuses the iteration into one ``lax.while_loop`` whose every
branch is a ``jnp.where``.  Here the vectors stay on the device of ``b``
and the iteration's two dots (``alfa = v'y`` and ``beta^2 = r2'M r2``)
reach the host in one synchronisation; the Givens rotation, the norm
estimates and the stop tests then run on Python floats, and the vector
updates take them as scalars.  In float64 those are the JAX package's
float64 scalars; in float32 the host carries them in float64 where the JAX
package rounds them to float32 (a deviation the float32 golden holds to
the same iteration count within one).

Preserved semantics (SURVEY §2.3):
  * the full 12-code ``istop`` table (-1..10, ``minres.py:87-98``) with the
    reference's test ordering (``minres.py:348-361``): later assignments
    overwrite earlier ones, and only while ``istop == 0``;
  * ``shift`` solves ``(A - shift I) x = b`` (``minres.py:239-240``);
  * the norm estimates ``Anorm``, ``Acond``, ``Arnorm``, ``ynorm``
    (``minres.py:321-344``) in ``result.info``;
  * the energy-norm truncated direct-error window stop ``etol``/``window``
    (``minres.py:303-310``), NaN in ``dir_errors_window`` until the window
    fills;
  * optional randomized symmetry checks of ``A`` and ``M``
    (``minres.py:186-197``) through :func:`~..utils.check_symmetric`;
  * ``converged`` iff ``istop in {1, 2, 3, 4, 10}`` (``minres.py:395``).
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, fdiv,
                     history_from, history_init, history_push, promote_rhs,
                     real_dtype, require_square, table_init, table_push,
                     table_tensor, vdot_real)
from .result import SolveResult
from ..utils.utils import check_symmetric

__all__ = ["minres", "ISTOP_MSG"]

ISTOP_MSG = {
    -1: "beta2 = 0. If M = I, b and x are eigenvectors",
    0: "beta1 = 0. The exact solution is x = 0",
    1: "a solution to Ax = b was found, given rtol",
    2: "a least-squares solution was found, given rtol",
    3: "reasonable accuracy achieved, given eps",
    4: "acond has exceeded 0.1/eps",
    5: "the iteration limit was reached",    # unused: kept for table parity
    6: "iteration limit reached or indefinite preconditioner",
    7: "A does not define a symmetric operator",
    8: "M does not define a symmetric operator",
    9: "M does not define a positive-definite preconditioner",
    10: "the truncated direct error is small enough, given etol",
}

_CONVERGED_CODES = (1, 2, 3, 4, 10)


def _tests(istop, itn, itnlim, test1, test2, epsx, beta1, acond, eps, rtol):
    """The stop code after one iteration: the reference's assignments in
    their order, each later one overwriting the earlier (``minres.py:
    348-361``), applied only while no code is set."""
    if istop != 0:
        return istop
    code = 0
    if 1 + test2 <= 1:
        code = 2
    if 1 + test1 <= 1:
        code = 1
    if itn >= itnlim:
        code = 6
    if acond >= 0.1 / eps:
        code = 4
    if epsx >= beta1:
        code = 3
    if test2 <= rtol:
        code = 2
    if test1 <= rtol:
        code = 1
    return code


def _minres(A, b, M, shift, rtol, etol, itnlim, window, store_history,
            store_iterates, store_table=False):
    dtype, dev, n = b.dtype, b.device, b.shape[0]
    rdtype = real_dtype(dtype)
    eps = float(torch.finfo(rdtype).eps)

    x = torch.zeros_like(b)
    r1 = r2 = b
    y = apply_op(M, b) if M is not None else b
    beta1_sq = vdot_real(b, y).item()
    zero_b = beta1_sq == 0
    istop = 9 if beta1_sq < 0 else 0
    beta1 = math.sqrt(max(beta1_sq, 0.0))

    hist = [beta1]
    derrs = [math.nan]
    iters = history_push(history_init(store_iterates, itnlim, dtype, dev, n),
                         0, x)
    # show-table columns: x[0], test1, test2, Anorm, Acond, gbar, ynorm
    tab = table_init(store_table, itnlim, rdtype, dev)
    w = w2 = torch.zeros_like(b)
    oldb, beta, dbar, epsln = 0.0, beta1, 0.0, 0.0
    phibar, rhs1, rhs2 = beta1, beta1, 0.0
    tnorm2 = ynorm2 = 0.0
    cs, sn = -1.0, 0.0
    gmax = gmin = x_nrg2 = 0.0
    d_err = [0.0] * window
    anorm = acond = ynorm = arnorm = 0.0
    rnorm = beta1
    itn = 0
    done = istop != 0 or zero_b
    while not done and itn < itnlim:
        itn += 1
        # ---- Lanczos step (minres.py:236-255) ---------------------------
        v = y / beta
        y = apply_op(A, v)
        if shift:
            y = y - shift * v
        if itn >= 2:
            y = torch.add(y, r1, alpha=-beta / oldb)
        alfa_t = vdot_real(v, y)
        y = torch.addcmul(y, (alfa_t / beta).to(dtype), r2, value=-1)
        r1, r2 = r2, y
        y = apply_op(M, r2) if M is not None else r2
        oldb = beta
        alfa, beta_sq = torch.stack([alfa_t, vdot_real(r2, y)]).tolist()
        if beta_sq < 0:             # istop 6 (minres.py:251-255)
            istop = 6
            break
        beta = math.sqrt(beta_sq)
        tnorm2 = tnorm2 + alfa ** 2 + oldb ** 2 + beta ** 2
        if itn == 1:
            if beta / beta1 <= 10 * eps:
                istop = -1
            gmax = gmin = abs(alfa)

        # ---- previous rotation, then the new one (minres.py:266-289) ----
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        root = math.hypot(gbar, dbar)
        arnorm = phibar * root
        gamma = max(math.hypot(gbar, beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        # ---- solution update (minres.py:293-297) ------------------------
        w1, w2 = w2, w
        w = torch.add(v, w1, alpha=-oldeps).add_(w2, alpha=-delta).div_(gamma)
        x = torch.add(x, w, alpha=phi)

        # ---- truncated direct-error window (minres.py:303-310) ----------
        x_nrg2 += phi * phi
        d_err[itn % window] = phi
        trnc = math.sqrt(sum(e * e for e in d_err))
        # estimates are emitted once the window is full; earlier slots NaN
        derrs.append(fdiv(trnc, math.sqrt(x_nrg2)) if itn > window
                     else math.nan)
        history_push(iters, itn, x)
        if istop == 0 and itn > window and trnc < etol * math.sqrt(x_nrg2):
            istop = 10

        gmax = max(gmax, gamma)
        gmin = min(gmin, gamma)
        z = rhs1 / gamma
        ynorm2 = z * z + ynorm2
        rhs1 = rhs2 - delta * z
        rhs2 = -epsln * z

        # ---- norm estimates and stopping tests (minres.py:321-361) ------
        anorm = math.sqrt(tnorm2)
        ynorm = math.sqrt(ynorm2)
        rnorm = phibar
        test1 = fdiv(rnorm, anorm * ynorm)
        test2 = fdiv(root, anorm)
        acond = fdiv(gmax, gmin)
        istop = _tests(istop, itn, itnlim, test1, test2, anorm * ynorm * eps,
                       beta1, acond, eps, rtol)
        hist.append(rnorm)
        table_push(tab, itn, x[0].real, test1, test2, anorm, acond, gbar,
                   ynorm)
        done = istop != 0

    info = {key: torch.tensor(val, dtype=rdtype, device=dev)
            for key, val in (("Anorm", anorm), ("Acond", acond),
                             ("Arnorm", arnorm), ("ynorm", ynorm))}
    if store_iterates:
        info["iterates"] = iters
    if store_history:
        info["dir_errors_window"] = history_from(True, itnlim, derrs, rdtype,
                                                 dev)
    if tab is not None:
        info["show_table"] = table_tensor(tab)
    converged = zero_b or istop in _CONVERGED_CODES
    return SolveResult(
        x=torch.zeros_like(b) if zero_b else x,
        converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(itn, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(0.0 if zero_b else rnorm, dtype=rdtype,
                                device=dev),
        resid_norm0=torch.tensor(beta1, dtype=rdtype, device=dev),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info=info)


def _check_failed(code, b, store_history, store_iterates):
    """The result of a failed symmetry check: no iteration ran; the
    documented info keys are present (empty buffers), as in the JAX
    package."""
    dev, n = b.device, b.shape[0]
    rdtype = real_dtype(b.dtype)
    zero = torch.zeros((), dtype=rdtype, device=dev)
    info = {"Anorm": zero, "Acond": zero, "Arnorm": zero, "ynorm": zero}
    if store_iterates:
        info["iterates"] = torch.full((1, n), math.nan, dtype=b.dtype,
                                      device=dev)
    if store_history:
        info["dir_errors_window"] = torch.full((1,), math.nan, dtype=rdtype,
                                               device=dev)
    return SolveResult(
        x=torch.zeros_like(b), converged=torch.tensor(False, device=dev),
        istop=torch.tensor(code, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(0, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(0, dtype=torch.int32, device=dev),
        resid_norm=zero, resid_norm0=zero, info=info)


def minres(A, b, *, M=None, shift=0.0, rtol=1.0e-12, etol=1.0e-6,
           window=5, itnlim=None, check=False, store_history=False,
           store_iterates=False, show=False, verify_final=False,
           replace_every=None):
    """Solve symmetric (possibly indefinite or singular)
    ``(A - shift I) x = b``, or ``min ||Ax - b||``, by MINRES.

    Parameters
    ----------
    A : symmetric LinearOperator or dense tensor.
    b : right-hand side; the solve runs on its device.
    M : optional SPD preconditioner operator (the reference's ``precon``).
    shift : solves the shifted system (``minres.py:53``).
    rtol : relative stopping tolerance (reference default 1e-12).
    etol, window : truncated direct-error stopping rule in the energy norm.
    itnlim : iteration cap, default 5n (``minres.py:124``).
    check : randomized symmetry checks of A and M before the solve
        (``minres.py:186-197``); a failure gives istop 7 or 8 without
        running the iteration.
    store_history : keep the residual-norm estimates, and the reference's
        ``dir_errors_window`` telemetry as ``info["dir_errors_window"]``
        (NaN until the window fills).
    store_iterates : keep every iterate in an (itnlim+1, n) buffer,
        ``info["iterates"]`` (NaN rows beyond ``n_iter``).
    show : print the reference's iteration table after the solve
        (``minres.py:375-393``), rendered from the rows recorded as the
        loop ran (:mod:`~.show`); implies ``store_history``.
    verify_final : record the true residual norm ``||b - (A - shift I) x||``
        as ``info["true_resid_norm"]`` (one uncounted matvec).
    replace_every : verified arithmetic; not ported yet, so a nonzero value
        raises.

    Returns :class:`SolveResult`; ``info`` carries Anorm, Acond, Arnorm and
    ynorm.
    """
    if replace_every:
        raise NotImplementedError(
            "minres(replace_every=...) is the verified-arithmetic path, not "
            "ported yet: ROADMAP.md queue 1 item 15")
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "minres")
    if itnlim is None:
        itnlim = 5 * b.shape[0]
    if check:
        if not check_symmetric(A):
            return _check_failed(7, b, store_history, store_iterates)
        if M is not None and not check_symmetric(M):
            return _check_failed(8, b, store_history, store_iterates)
    res = _minres(A, b, M, float(shift), float(rtol), float(etol),
                  int(itnlim), int(window), bool(store_history) or bool(show),
                  bool(store_iterates), bool(show))
    if show:
        from .show import print_minres
        print_minres(res, n=b.shape[0], itnlim=int(itnlim), rtol=float(rtol),
                     eps=float(torch.finfo(real_dtype(b.dtype)).eps))
    if verify_final:
        res = attach_true_residual(A, b, res, float(shift))
    return res
