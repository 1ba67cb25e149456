"""LSQR (Paige & Saunders) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/lsqr.py``, after the reference LSQR
(PyKrylov's ``pykrylov/lls/lsqr.py:26-454``).  Solves ``Ax = b``,
``min ||Ax - b||`` or the damped problem ``min ||Ax-b||^2 + damp^2 ||x||^2``
for rectangular A by Golub-Kahan bidiagonalization and QR by plane
rotations; one forward and one transpose matvec per iteration
(``nMatvec = 2 itn``, ``lsqr.py:445``), plus the transpose matvec of the
start, which the reference does not count either.

The vectors stay on the device of ``b``.  Each iteration reads the host
once: the step's ``beta`` and ``alpha`` and ``||w||^2`` in one
``tolist()`` (:func:`~.lls_common.gk_read`).  The rotations, the norm
estimates and the stop tests then run on Python floats, and the vector
updates take them as scalars.  In float64 those are the JAX package's
float64 scalars; in float32 the host carries them in float64 where the JAX
package rounds them to float32.

Preserved semantics (SURVEY §2.3):
  * istop codes 0-8 with the reference's test ordering and
    machine-precision guards (``lsqr.py:361-392``): later assignments
    overwrite earlier ones;
  * ``damp`` folded in by an extra rotation (``lsqr.py:277-281``);
  * M / N inner preconditioners (M on the m-side, N on the n-side) with
    weighted norms, which make LSQR solve SQD systems
    (``lsqr.py:188-210, 457-472``);
  * the energy-norm direct-error window stop ``etol`` → istop 8
    (``lsqr.py:309-317``);
  * the ``wantvar`` estimate of diag((A'A + damp^2 I)^{-1})
    (``lsqr.py:154-157,304``);
  * the norm estimates r1norm/r2norm/Anorm/Acond/Arnorm/xnorm in ``info``.
"""

from __future__ import annotations

import math

import torch

from .common import (as_operator, attach_true_lls_residual, fdiv,
                     history_from, promote_rhs, real_dtype, table_init,
                     table_push, table_tensor, vdot_real)
from ..utils.ranks import leader
from .lls_common import gk_init, gk_read, gk_step
from .result import SolveResult

__all__ = ["lsqr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "x is an approximate solution to Ax = b, given atol, btol",
    2: "x approximately solves the least-squares problem, given atol",
    3: "the estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(Abar) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)


def _sign(x):
    """``jnp.sign`` on a host float: -1, 0 or 1."""
    return float((x > 0) - (x < 0))


def stop_code(istop, itn, itnlim, test1, test2, test3, t1, rtol, atol,
              ctol):
    """The LSQR/LSMR stop code after one iteration: the reference's
    assignments in their order, each later one overwriting the earlier
    (``lsqr.py:361-392``, ``lsmr.py:437-448``); ``istop`` is the direct-
    error window's code (8 or 0)."""
    if itn >= itnlim:
        istop = 7
    if 1 + test3 <= 1:
        istop = 6
    if 1 + test2 <= 1:
        istop = 5
    if 1 + t1 <= 1:
        istop = 4
    if test3 <= ctol:
        istop = 3
    if test2 <= atol:
        istop = 2
    if test1 <= rtol:
        istop = 1
    return istop


def _lsqr(A, b, M, N, damp, atol, btol, conlim, etol, itnlim, window,
          wantvar, store_history, store_table):
    dtype, dev = b.dtype, b.device
    rdtype = real_dtype(dtype)
    dampsq = damp * damp
    ctol = 1.0 / conlim if conlim > 0 else 0.0

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N)
    bnorm = beta
    arnorm = alpha * beta
    x_is_zero = arnorm == 0

    hist = [beta]
    ne_hist = [arnorm]
    # show-table columns: x(1), r1norm, r2norm, test1, test2, Anorm, Acond
    # (row 0 replicates the reference's pre-loop line, lsqr.py:224-232)
    tab = table_push(table_init(store_table, itnlim, rdtype, dev), 0, 0.0,
                     beta, beta, 1.0, 1.0 if x_is_zero else alpha / beta,
                     0.0, 0.0)

    x = torch.zeros_like(v, dtype=dtype)
    w = v
    var = torch.zeros_like(v, dtype=dtype) if wantvar else None
    rhobar, phibar = alpha, beta
    cs2, sn2, z = -1.0, 0.0, 0.0
    xxnorm = ddnorm = res2 = anorm = acond = xnorm = x_nrg2 = 0.0
    rnorm = r1norm = r2norm = beta
    d_err = [0.0] * window
    istop = itn = 0
    done = x_is_zero
    while not done and itn < itnlim:
        itn += 1
        # ---- bidiagonalization step and the one read (lsqr.py:252-272) --
        alpha_old = alpha
        (u, Mu, v, Nv), alpha, beta, (wsq,) = gk_read(
            gk_step(A, M, N, v, Mu, Nv, alpha), (v, Nv, alpha),
            vdot_real(w, w))
        anorm = math.sqrt(anorm ** 2 + alpha_old ** 2 + beta ** 2 + dampsq)

        # ---- rotation eliminating damp (lsqr.py:277-281) ----------------
        rhobar1 = math.hypot(rhobar, damp)
        cs1 = fdiv(rhobar, rhobar1)
        sn1 = fdiv(damp, rhobar1)
        psi = sn1 * phibar
        phibar = cs1 * phibar

        # ---- rotation eliminating beta (lsqr.py:286-293) ----------------
        rho = math.hypot(rhobar1, beta)
        cs = fdiv(rhobar1, rho)
        sn = fdiv(beta, rho)
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # ---- update x and w (lsqr.py:297-303) ---------------------------
        if wantvar:
            dk = w / rho
            var.addcmul_(dk, dk)
        x.add_(w, alpha=fdiv(phi, rho))
        w = torch.add(v, w, alpha=fdiv(-theta, rho))
        ddnorm = ddnorm + fdiv(wsq, rho * rho)

        # ---- direct-error window (lsqr.py:309-317) ----------------------
        x_nrg2 = x_nrg2 + phi * phi
        d_err[itn % window] = phi
        trnc = math.sqrt(sum(e * e for e in d_err))
        istop = 8 if itn > window and trnc < etol * math.sqrt(x_nrg2) else 0

        # ---- right rotation → xnorm estimate (lsqr.py:323-332) ----------
        delta = sn2 * rho
        gambar = -cs2 * rho
        rhs = phi - delta * z
        zbar = fdiv(rhs, gambar)
        xnorm = math.sqrt(xxnorm + zbar ** 2)
        gamma = math.hypot(gambar, theta)
        cs2 = fdiv(gambar, gamma)
        sn2 = fdiv(theta, gamma)
        z = fdiv(rhs, gamma)
        xxnorm = xxnorm + z * z

        # ---- norms and tests (lsqr.py:338-392) --------------------------
        acond = anorm * math.sqrt(ddnorm)
        res1 = phibar ** 2
        res2 = res2 + psi ** 2
        rnorm = math.sqrt(res1 + res2)
        arnorm = alpha * abs(tau)
        r1sq = rnorm ** 2 - dampsq * xxnorm
        r1norm = _sign(r1sq) * math.sqrt(abs(r1sq))
        r2norm = rnorm

        test1 = rnorm / bnorm
        test2 = (math.inf if anorm == 0 or rnorm == 0
                 else arnorm / (anorm * rnorm))
        test3 = math.inf if acond == 0 else 1.0 / acond
        t1 = test1 / (1 + anorm * xnorm / bnorm)
        rtol = btol + atol * anorm * xnorm / bnorm
        istop = stop_code(istop, itn, itnlim, test1, test2, test3, t1, rtol,
                          atol, ctol)
        hist.append(r2norm)
        ne_hist.append(arnorm)
        table_push(tab, itn, x, r1norm, r2norm, test1, test2, anorm,
                   acond)
        done = istop > 0

    optimal = istop in _OPTIMAL_CODES

    def scalar(val):
        return torch.tensor(val, dtype=rdtype, device=dev)

    info = {"r1norm": scalar(r1norm), "r2norm": scalar(r2norm),
            "Anorm": scalar(anorm), "Acond": scalar(acond),
            "Arnorm": scalar(arnorm), "xnorm": scalar(xnorm),
            "bnorm": scalar(bnorm),
            "optimal": torch.tensor(optimal, device=dev)}
    if store_history:
        info["normal_eqns_resids"] = history_from(True, itnlim, ne_hist,
                                                  rdtype, dev)
    if tab is not None:
        info["show_table"] = table_tensor(tab)
    if wantvar:
        info["var"] = var
    return SolveResult(
        x=x, converged=torch.tensor(optimal, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(2 * itn, dtype=torch.int32, device=dev),
        resid_norm=scalar(r2norm), resid_norm0=scalar(bnorm),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info=info)


def lsqr(A, b, *, damp=0.0, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
         conlim=1.0e8, etol=1.0e-6, window=5, itnlim=None, wantvar=False,
         store_history=False, show=False, verify_final=False):
    """Solve ``min ||Ax - b||`` (or the damped / SQD variant) by LSQR.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense tensor; its transpose
        product must be available.
    b : length-m right-hand side; the solve runs on its device.
    damp : Tikhonov damping; solves ``min ||Ax-b||^2 + damp^2 ||x||^2``.
    M, N : optional inner preconditioners applying the *inverse* weights on
        the m-side and n-side respectively; with both given LSQR solves the
        SQD system ``[M A; A' -N] [r; x] = [b; 0]`` (``lsqr.py:457-472``).
    atol, btol, conlim : Paige-Saunders stopping tolerances.
    etol, window : truncated direct-error stop in the energy norm.
    itnlim : iteration cap, default 3n (``lsqr.py:156``).
    wantvar : also estimate diag((A'A + damp^2 I)^{-1}) in ``info['var']``.
    store_history : keep the r2norm estimates, and the normal-equations
        residual estimates as ``info["normal_eqns_resids"]``
        (``lsqr.py:80,304``).
    show : print the reference's banner and iteration table
        (``lsqr.py:168-174,406-434``), rendered after the solve from the
        recorded rows (:mod:`~.show`), as the JAX package prints it.
    verify_final : append ``info["true_resid_norm"]`` (= ||b - A x||) and
        ``info["true_normar"]`` (= ||A'(b - Ax) - damp^2 x||, the
        optimality residual ``Arnorm`` estimates); two uncounted
        diagnostic matvecs, Euclidean metric (M/N not folded in).

    Returns :class:`SolveResult`; ``converged`` is the reference's
    ``optimal`` flag (istop in {0,1,2,4,5,8}), ``n_matvec = 2 n_iter``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    if show and leader(b):
        from .show import lsqr_preamble
        lsqr_preamble(A.nargout, A.nargin, float(damp), wantvar,
                      float(atol), float(btol), float(conlim), int(itnlim))
    res = _lsqr(A, b, M, N, float(damp), float(atol), float(btol),
                float(conlim), float(etol), int(itnlim), int(window),
                bool(wantvar), bool(store_history), bool(show))
    if show and leader(b):
        from .show import print_lsqr
        ctol = 1.0 / float(conlim) if conlim > 0 else 0.0
        print_lsqr(res, itnlim=int(itnlim), atol=float(atol),
                   rtol=float(btol), ctol=ctol)
    if verify_final:
        res = attach_true_lls_residual(A, b, res, float(damp))
    return res
