"""CRAIG (generalized, Arioli & Orban) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/craig.py``, after the reference
CRAIG (PyKrylov's ``pykrylov/lls/craig.py:30-520``).  Solves consistent
``Ax = b`` or the regularized problem ``min ||b - Ax||^2_D + ||x||^2_N``,
equivalently the symmetric quasi-definite (SQD) system

    [ M   A ] [ r ]   [ b ]
    [ A' -N ] [ x ] = [ 0 ],     M := inv(D),

by Golub-Kahan bidiagonalization with rotations of types I and II.  One
forward and one transpose matvec per iteration (``nMatvec = 2 itn``),
plus the uncounted transpose matvec of the start.  Each iteration reads
the host once, for the step's ``beta`` and ``alpha``
(:func:`~.lls_common.gk_read`); the rotations run on Python floats.

Preserved semantics (SURVEY §2.3):
  * both the primal iterate ``x`` and the dual iterate ``r``
    (``craig.py:248-262,347-365``); ``r`` is returned in ``info['r']``;
  * the energy norms ``rNrgNorm2``/``xNrgNorm2`` and the dual-based
    truncated direct-error stop on ``tau`` → istop 8
    (``craig.py:370-379``);
  * only istop codes 1/4/7/8 are live (``craig.py:448-457``): the
    reference's LSQR-style tests 2/3/5/6 are commented out there;
  * the convergence test ``sqrt(rnorm)/bnorm <= btol``
    (``craig.py:438-441``).
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, apply_op_T, as_operator, history_from,
                     history_init, history_push, norm, promote_rhs, real_dtype)
from ..utils.ranks import leader
from .lls_common import gk_init, gk_read, gk_step
from .result import SolveResult

__all__ = ["craig", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "Ax - b is small enough, given atol, btol",
    2: "the least-squares solution is good enough, given atol",
    3: "the estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(Abar) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)


def _craig(A, b, M, N, btol, etol, itnlim, window, store_history,
           store_iterates):
    dtype, dev = b.dtype, b.device
    rdtype = real_dtype(dtype)
    m, n = A.nargout, A.nargin

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N)
    x_is_zero = beta == 0
    bnorm = beta

    # ---- first-iteration initialization (craig.py:247-268) ---------------
    rho = math.hypot(alpha, 1.0)
    d = u / rho
    tau = beta / rho
    r = tau * d
    rnorm = tau * tau
    c = alpha / rho
    s = 1.0 / rho
    zeta = s * beta
    eta = c * zeta
    xi = s * zeta
    w = c * v
    wbar = s * v
    x = zeta * w
    xnorm = eta * eta
    r1norm = xi * xi

    hist = [math.sqrt(rnorm)]
    # primal and dual iterate histories (the reference's iterates_p and
    # iterates_d, craig.py:100-101,248-262,347-365)
    ip = history_push(history_init(store_iterates, itnlim, dtype, dev, n),
                      0, x)
    idu = history_push(history_init(store_iterates, itnlim, dtype, dev, m),
                       0, r)
    arnorm = r_nrg2 = x_nrg2 = 0.0
    d_err = [0.0] * window
    istop = itn = 0
    done = x_is_zero
    while not done and itn < itnlim:
        itn += 1
        alpha_old = alpha
        (u, Mu, v, Nv), alpha, beta, _ = gk_read(
            gk_step(A, M, N, v, Mu, Nv, alpha), (v, Nv, alpha))
        # residual of CRAIG's "other" normal equations (craig.py:310-314)
        arnorm = abs(alpha_old * beta * s * zeta)

        # ---- rotations of types I and II (craig.py:333-345) --------------
        beta_hat = c * beta
        gamma = s * beta
        delta = math.hypot(gamma, 1.0)
        s2 = gamma / delta
        alpha_hat = math.hypot(alpha, delta)
        c = alpha / alpha_hat
        s = delta / alpha_hat

        # ---- dual update (craig.py:347-350) -------------------------------
        d = torch.sub(u, d, alpha=beta_hat).div_(alpha_hat)
        tau = -beta_hat * tau / alpha_hat
        r.add_(d, alpha=tau)

        # ---- primal update (craig.py:354-365) -----------------------------
        zeta = -beta_hat * zeta / alpha_hat
        eta = c * zeta
        xi = s * zeta
        wbar_s = wbar * s2
        w = torch.add(c * v, wbar_s, alpha=s)
        wbar = torch.add(s * v, wbar_s, alpha=-c)
        x.add_(w, alpha=zeta)

        # ---- energy norms and the dual direct-error stop (craig.py:370-379)
        r_nrg2 = r_nrg2 + tau * tau
        x_nrg2 = x_nrg2 + zeta * zeta
        d_err[itn % window] = tau
        trnc = math.sqrt(sum(e * e for e in d_err))
        istop = 8 if itn > window and trnc < etol * math.sqrt(r_nrg2) else 0

        rnorm = rnorm + tau * tau
        xnorm = xnorm + eta * eta
        r1norm = r1norm + xi * xi

        # ---- live tests (craig.py:438-457) --------------------------------
        test1 = math.sqrt(rnorm) / bnorm
        if itn >= itnlim:
            istop = 7
        if 1 + test1 <= 1:
            istop = 4
        if test1 <= btol:
            istop = 1
        hist.append(math.sqrt(rnorm))
        history_push(ip, itn, x)
        history_push(idu, itn, r)
        done = istop > 0

    optimal = istop in _OPTIMAL_CODES

    def scalar(val):
        return torch.tensor(val, dtype=rdtype, device=dev)

    info = {"r": torch.zeros_like(b) if x_is_zero else r,
            "r1norm": scalar(math.sqrt(r1norm)),
            "r2norm": scalar(math.sqrt(rnorm)),
            "Arnorm": scalar(arnorm), "xnorm": scalar(xnorm),
            "rNrgNorm2": scalar(r_nrg2), "xNrgNorm2": scalar(x_nrg2),
            "optimal": torch.tensor(optimal, device=dev)}
    if store_iterates:
        info["iterates_p"] = ip
        info["iterates_d"] = idu
    return SolveResult(
        x=torch.zeros_like(v) if x_is_zero else x,
        converged=torch.tensor(optimal, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(2 * itn, dtype=torch.int32, device=dev),
        resid_norm=scalar(math.sqrt(rnorm)), resid_norm0=scalar(bnorm),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info=info)


def craig(A, b, *, M=None, N=None, atol=1.0e-9, btol=1.0e-9, etol=1.0e-6,
          window=5, itnlim=None, store_history=False,
          store_iterates=False, show=False, verify_final=False):
    """Solve consistent ``Ax = b`` or the SQD system
    ``[M A; A' -N][r; x] = [b; 0]`` by the generalized CRAIG method.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense tensor.
    b : length-m right-hand side; the solve runs on its device.
    M, N : optional inner preconditioners applying inv(D) and inv(C)
        (``craig.py:115-117``).
    atol, btol : stopping tolerances (only btol is live, as in the
        reference; ``craig.py:438-457``).
    etol, window : truncated direct-error stop on the dual iterate.
    itnlim : iteration cap, default 3n (``craig.py:177``).
    store_iterates : keep every primal and dual iterate,
        ``info["iterates_p"]`` (itnlim+1, n) and ``info["iterates_d"]``
        (itnlim+1, m), NaN rows beyond ``n_iter``.
    show : print the reference's banner and final block
        (``craig.py:193-200,483-492``).
    verify_final : append the SQD block-equation certificates, both
        expressible with the inverse-weight applies:
        ``info["true_dual_resid"]`` = ||M(b - Ax) - r|| (first block) and
        ``info["true_primal_resid"]`` = ||N(A'r) - x|| (second block); two
        uncounted diagnostic matvecs.

    Returns :class:`SolveResult`; the dual iterate ``r`` (the SQD system's
    first block) is in ``info['r']``, and ``n_matvec = 2 n_iter``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    if show and leader(b):
        from .show import craig_preamble
        craig_preamble(A.nargout, A.nargin, float(atol), float(btol),
                       itnlim)
    res = _craig(A, b, M, N, float(btol), float(etol), int(itnlim),
                 int(window), bool(store_history), bool(store_iterates))
    if show and leader(b):
        from .show import print_craig_final
        print_craig_final(res)
    if verify_final:
        r = res.info["r"]
        d1 = b - apply_op(A, res.x)
        d1 = (apply_op(M, d1) if M is not None else d1) - r
        d2 = apply_op_T(A, r)
        d2 = (apply_op(N, d2) if N is not None else d2) - res.x
        res.info["true_dual_resid"] = norm(d1)
        res.info["true_primal_resid"] = norm(d2)
    return res
