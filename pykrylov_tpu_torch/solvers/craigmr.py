"""CRAIG-MR (least-norm minimum-residual) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/craigmr.py``, after the reference
CRAIG-MR (PyKrylov's ``pykrylov/lls/craigmr.py:13-250``): a
minimum-residual variant of CRAIG for least-norm problems, on the same
Golub-Kahan bidiagonalization with rotations of types I, II and III
(``craigmr.py:161-185``).  Its iterate lives in the *dual* space: ``x``
has dimension m (``craigmr.py:112``).  One forward and one transpose
matvec per iteration (``nMatvec = 2 itn``), plus the uncounted transpose
matvec of the start.  Each iteration reads the host once, for the step's
``beta`` and ``alpha`` (:func:`~.lls_common.gk_read`).

Preserved semantics (SURVEY §2.3):
  * only istop codes 7 (iteration limit) and 8 (truncated direct error)
    are live (``craigmr.py:202-212``);
  * the reference's ``init_data`` multi-solve reset (``craigmr.py:36-49``)
    is moot: the solver is a function.

Reference bug not replicated (SURVEY §7): the stray debug
``print itn, xNrgNorm2`` in the hot loop (``craigmr.py:190``).
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, apply_op_T, as_operator, history_from, norm,
                     promote_rhs, real_dtype)
from ..utils.ranks import leader
from .lls_common import gk_init, gk_read, gk_step
from .result import SolveResult

__all__ = ["craigmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}


def _craigmr(A, b, M, N, etol, itnlim, window, store_history):
    dtype, dev = b.dtype, b.device
    rdtype = real_dtype(dtype)

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N)
    x_is_zero = alpha * beta == 0
    beta1 = beta

    # ---- first-iteration initialization (craigmr.py:104-120) --------------
    alpha_hat = math.hypot(alpha, 1.0)
    c = alpha / alpha_hat
    s = 1.0 / alpha_hat
    zeta_hat = beta
    alpha_tilde = alpha_hat
    theta = zeta = x_nrg2 = 0.0
    d = u / alpha_hat
    dbar = torch.zeros_like(b)
    x = torch.zeros_like(b)

    hist = [beta]
    d_err = [0.0] * window
    istop = itn = 0
    done = x_is_zero
    while not done and itn < itnlim:
        itn += 1
        (u, Mu, v, Nv), alpha, beta, _ = gk_read(
            gk_step(A, M, N, v, Mu, Nv, alpha), (v, Nv, alpha))

        # ---- rotations I / II / III (craigmr.py:161-185) -----------------
        beta_hat = c * beta
        gamma = s * beta
        delta = math.hypot(gamma, 1.0)
        alpha_hat = math.hypot(alpha, delta)
        c = alpha / alpha_hat
        s = delta / alpha_hat
        rho = math.hypot(alpha_tilde, beta_hat)
        c_hat = alpha_tilde / rho
        s_hat = beta_hat / rho

        dbar = torch.sub(d, dbar, alpha=theta).div_(rho)
        theta = s_hat * alpha_hat
        alpha_tilde = -c_hat * alpha_hat

        zeta = c_hat * zeta_hat
        zeta_hat = s_hat * zeta_hat
        x_nrg2 = x_nrg2 + zeta * zeta
        d = torch.sub(u, d, alpha=beta_hat).div_(alpha_hat)
        x.add_(dbar, alpha=zeta)

        # ---- stopping (craigmr.py:202-212) -------------------------------
        d_err[itn % window] = zeta
        trnc = math.sqrt(sum(e * e for e in d_err))
        istop = 8 if itn > window and trnc < etol * math.sqrt(x_nrg2) else 0
        if itn >= itnlim:
            istop = 7
        hist.append(abs(zeta))
        done = istop > 0

    converged = x_is_zero or istop == 8

    def scalar(val):
        return torch.tensor(val, dtype=rdtype, device=dev)

    return SolveResult(
        x=x, converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(2 * itn, dtype=torch.int32, device=dev),
        resid_norm=scalar(abs(zeta)), resid_norm0=scalar(beta1),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info={"xNrgNorm2": scalar(x_nrg2),
              "trncDirErr": scalar(math.sqrt(sum(e * e for e in d_err))),
              "optimal": torch.tensor(converged, device=dev)})


def craigmr(A, b, *, M=None, N=None, etol=1.0e-6, window=5, itnlim=None,
            store_history=False, show=False, verify_final=False):
    """Solve the least-norm minimum-residual problem by CRAIG-MR.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense tensor.
    b : length-m right-hand side; the solve runs on its device.
    M, N : optional inner preconditioners (as in :func:`~.craig.craig`).
    etol, window : truncated direct-error stopping rule, the only live
        convergence test, as in the reference (``craigmr.py:202-212``).
    itnlim : iteration cap, default min(m, n) (``craigmr.py:73-75``).
    show : print the reference's final block (``craigmr.py:214-228``).
    verify_final : append ``info["true_dual_resid"]`` =
        ||M(b - A N(A'y)) - y||, the dual normal-equation certificate
        (with identity weights the iterate solves ``(AA' + I) y = b``);
        two uncounted diagnostic matvecs.

    Returns :class:`SolveResult`; the iterate is dual-space (length m,
    ``craigmr.py:112``), and ``resid_history`` stores |zeta| per
    iteration.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    res = _craigmr(A, b, M, N, float(etol), int(itnlim), int(window),
                   bool(store_history))
    if show and leader(b):
        # the reference's final block (craigmr.py:214-228; its per-iteration
        # table and most summary lines are commented out upstream)
        print(" ")
        print("CRAIG-MR finished")
        print(ISTOP_MSG.get(int(res.istop), ""))
        print(" ")
        print("xNrgNorm2 = %7.1e   trnDirErr = %7.1e"
              % (float(res.info["xNrgNorm2"]),
                 float(res.info["trncDirErr"])))
        print(" ")
    if verify_final:
        xn = apply_op_T(A, res.x)
        xn = apply_op(N, xn) if N is not None else xn
        d = b - apply_op(A, xn)
        d = (apply_op(M, d) if M is not None else d) - res.x
        res.info["true_dual_resid"] = norm(d)
    return res
