"""LSMR (Fong & Saunders) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/lsmr.py``, after the reference LSMR
(PyKrylov's ``pykrylov/lls/lsmr.py:28-492``, arxiv.org/abs/1006.0758).
Solves ``Ax = b``, ``min ||Ax - b||`` or the damped problem for
rectangular A; the Golub-Kahan bidiagonalization of LSQR, but minimizing
``||A' r||``, which makes the normal-equations residuals monotone.  One
forward and one transpose matvec per iteration, plus the uncounted
transpose matvec of the start.

The vectors stay on the device of ``b``.  Each iteration reads the host
once (:func:`~.lls_common.gk_read`): the step's ``beta`` and ``alpha`` and
the Gram matrix of ``x``, ``h`` and ``hbar``, which are the rows of one
(3, n) tensor.  The rotations run on Python floats; ``||x||``, which the
tests of this iteration need after the update of x, follows from the Gram
matrix and the update's coefficients, so it needs no second read.

Preserved semantics (SURVEY §2.3):
  * the double-QR recurrence (rotations Q, Qbar, Qtilde,
    ``lsmr.py:336-400``) built on the stable ``symOrtho`` Givens
    (``lsmr.py:500-519``);
  * the recursive ``||r||`` estimate (``lsmr.py:375-400``);
  * ``condA`` from max/min rhobar (``lsmr.py:407-411``);
  * istop codes 0-8, in LSQR's test order (``lsmr.py:437-448``);
  * M / N inner preconditioners, and ``damp`` in the Qhat rotation.

Contract difference (intentional, SURVEY §7): the reference returns a bare
tuple here while every other solver sets attributes (``lsmr.py:492``);
this returns :class:`SolveResult` with the tuple's fields in ``info``
(the compat class returns the tuple).
"""

from __future__ import annotations

import math

import torch

from .common import (as_operator, attach_true_lls_residual, fdiv,
                     history_from, promote_rhs, real_dtype, table_init,
                     table_push, table_tensor)
from ..utils import ranks
from ..utils.ranks import leader
from .lls_common import gk_init, gk_read, gk_step, sym_ortho
from .lsqr import stop_code
from .result import SolveResult

__all__ = ["lsmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "x is an approximate solution to Ax = b, given atol, btol",
    2: "x approximately solves the least-squares problem, given atol",
    3: "cond(A) seems to be greater than conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(A) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)

# Column blocks of the Gram product of x, h and hbar: a (3, n) by (n, 3)
# GEMM gives cuBLAS one output tile, so one thread block streams all 3n
# entries; as a batch of up to GRAM_BLOCKS products over blocks of at
# least GRAM_MIN_COLUMNS columns, summed, the rows stream in parallel
# (1024 blocks: about eight thread blocks for each of the H100's 132 SMs).
GRAM_BLOCKS = 1024
GRAM_MIN_COLUMNS = 1024


def _gram_rows(n, dtype, device):
    """A zeroed (3, n) buffer for x, h and hbar, padded with zero columns
    to whole blocks, and its (blocks, 3, columns) view; the padding is
    never written, so the blocks' Gram products sum to the rows'."""
    nb = max(1, min(GRAM_BLOCKS, n // GRAM_MIN_COLUMNS))
    cols = -(-n // nb)
    buf = torch.zeros((3, nb * cols), dtype=dtype, device=device)
    return buf, buf.view(3, nb, cols).transpose(0, 1)


def _lsmr(A, b, M, N, damp, atol, btol, conlim, etol, itnlim, window,
          store_history, store_table):
    dtype, dev = b.dtype, b.device
    rdtype = real_dtype(dtype)
    n = A.nargin
    ctol = 1.0 / conlim if conlim > 0 else 0.0

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N)
    normb = beta
    normar = alpha * beta
    x_is_zero = normar == 0

    hist = [beta]
    # show-table columns: x(1), normr, normar, test1, test2, normA, condA
    # (row 0 replicates the reference's pre-loop line, lsmr.py:285-293)
    tab = table_push(table_init(store_table, itnlim, rdtype, dev), 0, 0.0,
                     beta, normar, 1.0, 1.0 if x_is_zero else alpha / beta,
                     0.0, 0.0)

    # x, h and hbar as the rows of one tensor, whose Gram matrix gives the
    # new ||x|| in the iteration's one read
    # on a mesh of ranks the rows are this rank's and the Gram matrix is
    # all-reduced (one all_reduce of the 3x3 partials)
    on_ranks = ranks.sharded(v)
    n = v.shape[0]
    xhh, blocks = _gram_rows(n, dtype, dev)
    x, h, hbar = xhh[0, :n], xhh[1, :n], xhh[2, :n]
    if on_ranks:
        x, h, hbar = ranks.shard(x), ranks.shard(h), ranks.shard(hbar)
    h.copy_(v)
    zetabar, alphabar = alpha * beta, alpha
    rho = rhobar = cbar = 1.0
    sbar = 0.0
    betadd, betad = beta, 0.0
    rhodold, tautildeold, thetatilde, zeta, d = 1.0, 0.0, 0.0, 0.0, 0.0
    normA2 = alpha * alpha
    maxrbar = 0.0
    minrbar = math.inf          # the reference's 1e100 overflows float32
    normr, normA, condA, normx = beta, alpha, 1.0, 0.0
    x_nrg2 = 0.0
    d_err = [0.0] * window
    istop = itn = 0
    done = x_is_zero
    while not done and itn < itnlim:
        itn += 1
        gram = torch.bmm(blocks.conj(), blocks.transpose(1, 2)).sum(0)
        if on_ranks:
            gram = ranks.all_reduce(gram)
        (u, Mu, v, Nv), alpha, beta, g = gk_read(
            gk_step(A, M, N, v, Mu, Nv, alpha), (v, Nv, alpha), gram.real)

        # ---- rotations (lsmr.py:336-365) --------------------------------
        chat, shat, alphahat = sym_ortho(alphabar, damp)
        rhoold = rho
        c, s, rho = sym_ortho(alphahat, beta)
        thetanew = s * alpha
        alphabar = c * alpha

        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho
        rhotemp = cbar * rho
        cbar, sbar, rhobar = sym_ortho(cbar * rho, thetanew)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # ---- update h, hbar, x (lsmr.py:367-371) ------------------------
        ahb = fdiv(thetabar * rho, rhoold * rhobarold)
        cx = fdiv(zeta, rho * rhobar)
        hbar.mul_(-ahb).add_(h)
        x.add_(hbar, alpha=cx)
        h.mul_(-fdiv(thetanew, rho)).add_(v)
        # ||x + cx (h - ahb hbar)||^2 from the Gram matrix of the old rows
        xx, xh, xhb, _, hh, hhb, _, _, hbhb = g
        x_hb = xh - ahb * xhb
        hb_hb = hh - 2 * ahb * hhb + ahb * ahb * hbhb
        normx = math.sqrt(max(xx + 2 * cx * x_hb + cx * cx * hb_hb, 0.0))

        # ---- direct-error window (lsmr.py:376-384) ----------------------
        x_nrg2 = x_nrg2 + zeta * zeta
        d_err[itn % window] = zeta
        trnc = math.sqrt(sum(e * e for e in d_err))
        istop = 8 if itn > window and trnc < etol * math.sqrt(x_nrg2) else 0

        # ---- ||r|| estimate (lsmr.py:386-404) ---------------------------
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd = -s * betaacute
        thetatildeold = thetatilde
        ctildeold, stildeold, rhotildeold = sym_ortho(rhodold, thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat
        tautildeold = fdiv(zetaold - thetatildeold * tautildeold,
                           rhotildeold)
        taud = fdiv(zeta - thetatilde * tautildeold, rhodold)
        d = d + betacheck * betacheck
        normr = math.sqrt(d + (betad - taud) ** 2 + betadd * betadd)

        # ---- ||A|| and cond(A) estimates (lsmr.py:406-412) --------------
        normA2 = normA2 + beta * beta
        normA = math.sqrt(normA2)
        normA2 = normA2 + alpha * alpha
        maxrbar = max(maxrbar, rhobarold)
        if itn > 1:
            minrbar = min(minrbar, rhobarold)
        condA = fdiv(max(maxrbar, rhotemp), min(minrbar, rhotemp))

        # ---- convergence tests (lsmr.py:416-448) ------------------------
        normar = abs(zetabar)
        test1 = normr / normb
        test2 = fdiv(normar, normA * normr)
        test3 = fdiv(1.0, condA)
        t1 = test1 / (1 + normA * normx / normb)
        rtol = btol + atol * normA * normx / normb
        istop = stop_code(istop, itn, itnlim, test1, test2, test3, t1, rtol,
                          atol, ctol)
        hist.append(normr)
        table_push(tab, itn, x, normr, normar, test1, test2, normA,
                   condA)
        done = istop > 0

    optimal = istop in _OPTIMAL_CODES

    def scalar(val):
        return torch.tensor(val, dtype=rdtype, device=dev)

    info = {"normr": scalar(normr), "normar": scalar(normar),
            "normA": scalar(normA), "condA": scalar(condA),
            "normx": scalar(normx), "x_nrg2": scalar(x_nrg2),
            "optimal": torch.tensor(optimal, device=dev)}
    if tab is not None:
        info["show_table"] = table_tensor(tab)
    return SolveResult(
        x=x.clone(), converged=torch.tensor(optimal, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(2 * itn, dtype=torch.int32, device=dev),
        resid_norm=scalar(normr), resid_norm0=scalar(normb),
        resid_history=history_from(store_history, itnlim, hist, rdtype, dev),
        info=info)


def lsmr(A, b, *, damp=0.0, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
         conlim=1.0e8, etol=1.0e-6, window=5, itnlim=None,
         store_history=False, show=False, verify_final=False):
    """Solve ``min ||Ax - b||`` (or the damped variant) by LSMR.

    Parameters mirror :func:`~.lsqr.lsqr`; LSMR minimizes ``||A'r||``, so
    its normal-equations residual decreases monotonically, which makes an
    early stop on a least-squares problem safer.  ``itnlim`` defaults to
    min(m, n) (``lsmr.py:191-193``).

    ``verify_final=True`` appends ``info["true_resid_norm"]`` and
    ``info["true_normar"]``, the verified counterparts of normr and normar
    (see :func:`~.lsqr.lsqr`); two uncounted diagnostic matvecs.

    Returns :class:`SolveResult` with the reference tuple's fields (normr,
    normar, normA, condA, normx) in ``info``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    if show and leader(b):
        from .show import lsmr_preamble
        lsmr_preamble(A.nargout, A.nargin, float(damp), float(atol),
                      float(btol), float(conlim), int(itnlim))
    res = _lsmr(A, b, M, N, float(damp), float(atol), float(btol),
                float(conlim), float(etol), int(itnlim), int(window),
                bool(store_history), bool(show))
    if show and leader(b):
        from .show import print_lsmr
        ctol = 1.0 / float(conlim) if conlim > 0 else 0.0
        print_lsmr(res, n=A.nargin, itnlim=int(itnlim), atol=float(atol),
                   rtol=float(btol), ctol=ctol)
    if verify_final:
        res = attach_true_lls_residual(A, b, res, float(damp))
    return res
