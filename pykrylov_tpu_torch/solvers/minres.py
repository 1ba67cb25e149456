"""MINRES (Paige & Saunders) as an eager loop.

Counterpart of ``pykrylov_tpu/solvers/minres.py`` (``_minres`` at
``minres.py:61-417``, its verified branches included, and the ``minres``
wrapper), after the
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

With ``replace_every`` the loop is the JAX package's verified ff-MINRES
(:func:`_minres_verified`): the Lanczos vectors v, y, r1, r2, the
directions w, w2 and x ride double-f32 (hi, lo) pairs in the working dtype
(:mod:`..utils.ff`), alfa and beta^2 come from compensated dots, and istop
1 fires only on a recomputed true residual.  The JAX package carries the
Givens chain's scalars as (hi, lo) pairs too (alfa, beta, oldb, cs, sn,
dbar, epsln, phibar, and delta, gbar, gamma, phi, c1 = beta/oldb within
an iteration); here each is one host float64, which holds a float32
pair's ``hi + lo`` without loss (in float64 it keeps 53 of a double-double
pair's bits, the plain solver's precision).  The vector updates take them
split back into (hi, lo) pairs of the working dtype, sent to the device
once an iteration; only ``c2 = alfa/beta`` is formed on the device, from
the compensated alfa, before the host reads it.
"""

from __future__ import annotations

import math

import torch

from .common import (apply_op, as_operator, attach_true_residual, fdiv,
                     history_from, history_init, history_push, norm,
                     promote_rhs, real_dtype, require_square, rows, table_init,
                     table_push, table_tensor, vdot_real)
from .ffmv import resolve_ff_matvec
from .result import SolveResult
from ..utils.ff import ff_add_ff, ff_div, ff_vdot, two_prod, two_sum
from ..utils.ranks import leader
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


class _Chain:
    """MINRES's scalar recurrence on host floats, shared by the plain and
    the verified loops: the Lanczos scalars' bookkeeping, the previous and
    the new Givens rotation (``minres.py:256-289``), the direct-error window
    and the norm estimates (``minres.py:303-344``), and the telemetry the
    result carries."""

    def __init__(self, beta1, window, eps):
        self.beta1, self.eps = beta1, eps
        self.oldb, self.beta, self.dbar, self.epsln = 0.0, beta1, 0.0, 0.0
        self.phibar, self.rhs1, self.rhs2 = beta1, beta1, 0.0
        self.tnorm2 = self.ynorm2 = 0.0
        self.cs, self.sn = -1.0, 0.0
        self.gmax = self.gmin = self.x_nrg2 = 0.0
        self.d_err = [0.0] * window
        self.anorm = self.acond = self.ynorm = self.arnorm = 0.0
        self.gbar = self.root = 0.0
        self.hist = [beta1]
        self.derrs = [math.nan]

    def rotate(self, itn, alfa, beta_sq):
        """Take the step's alfa and beta^2 (``beta_sq >= 0``); return
        whether beta2 vanished at the first step (istop -1) and the
        rotation's (oldeps, delta, gamma, phi) for the w and x updates."""
        self.oldb = self.beta
        beta = self.beta = math.sqrt(beta_sq)
        self.tnorm2 = self.tnorm2 + alfa ** 2 + self.oldb ** 2 + beta ** 2
        near_const = False
        if itn == 1:
            near_const = beta / self.beta1 <= 10 * self.eps
            self.gmax = self.gmin = abs(alfa)
        oldeps = self.epsln
        cs, sn, dbar = self.cs, self.sn, self.dbar
        delta = cs * dbar + sn * alfa
        self.gbar = sn * dbar - cs * alfa
        self.epsln = sn * beta
        self.dbar = -cs * beta
        self.root = math.hypot(self.gbar, self.dbar)
        self.arnorm = self.phibar * self.root
        gamma = max(math.hypot(self.gbar, beta), self.eps)
        self.cs = self.gbar / gamma
        self.sn = beta / gamma
        phi = self.cs * self.phibar
        self.phibar = self.sn * self.phibar
        return near_const, oldeps, delta, gamma, phi

    def norms(self, itn, delta, gamma, phi):
        """After the x update: the direct-error window (estimates emitted
        once it is full; earlier slots NaN) and the norm estimates.
        Returns (trnc, sqrt(x_nrg2), test1, test2)."""
        window = len(self.d_err)
        self.x_nrg2 += phi * phi
        self.d_err[itn % window] = phi
        trnc = math.sqrt(sum(e * e for e in self.d_err))
        xnrg = math.sqrt(self.x_nrg2)
        self.derrs.append(fdiv(trnc, xnrg) if itn > window else math.nan)
        self.gmax = max(self.gmax, gamma)
        self.gmin = min(self.gmin, gamma)
        z = self.rhs1 / gamma
        self.ynorm2 = z * z + self.ynorm2
        self.rhs1 = self.rhs2 - delta * z
        self.rhs2 = -self.epsln * z
        self.anorm = math.sqrt(self.tnorm2)
        self.ynorm = math.sqrt(self.ynorm2)
        self.acond = fdiv(self.gmax, self.gmin)
        self.hist.append(self.phibar)
        return (trnc, xnrg, fdiv(self.phibar, self.anorm * self.ynorm),
                fdiv(self.root, self.anorm))

    def info(self, rdtype, dev, itnlim, iters, store_history, tab):
        info = {key: torch.tensor(val, dtype=rdtype, device=dev)
                for key, val in (("Anorm", self.anorm), ("Acond", self.acond),
                                 ("Arnorm", self.arnorm),
                                 ("ynorm", self.ynorm))}
        if iters is not None:
            info["iterates"] = iters
        if store_history:
            info["dir_errors_window"] = history_from(True, itnlim,
                                                     self.derrs, rdtype, dev)
        if tab is not None:
            info["show_table"] = table_tensor(tab)
        return info


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

    chain = _Chain(beta1, window, eps)
    iters = history_push(history_init(store_iterates, itnlim, dtype, dev, n),
                         0, x)
    # show-table columns: x[0], test1, test2, Anorm, Acond, gbar, ynorm
    tab = table_init(store_table, itnlim, rdtype, dev)
    w = w2 = torch.zeros_like(b)
    itn = 0
    done = istop != 0 or zero_b
    while not done and itn < itnlim:
        itn += 1
        # ---- Lanczos step (minres.py:236-255) ---------------------------
        beta = chain.beta
        v = y / beta
        y = apply_op(A, v)
        if shift:
            y = y - shift * v
        if itn >= 2:
            y = torch.add(y, r1, alpha=-beta / chain.oldb)
        alfa_t = vdot_real(v, y)
        y = torch.addcmul(y, (alfa_t / beta).to(dtype), r2, value=-1)
        r1, r2 = r2, y
        y = apply_op(M, r2) if M is not None else r2
        alfa, beta_sq = torch.stack([alfa_t, vdot_real(r2, y)]).tolist()
        if beta_sq < 0:             # istop 6 (minres.py:251-255)
            istop = 6
            break
        near_const, oldeps, delta, gamma, phi = chain.rotate(itn, alfa,
                                                             beta_sq)
        if near_const:
            istop = -1

        # ---- solution update (minres.py:293-297) ------------------------
        w1, w2 = w2, w
        w = torch.add(v, w1, alpha=-oldeps).add_(w2, alpha=-delta).div_(gamma)
        x = torch.add(x, w, alpha=phi)
        history_push(iters, itn, x)

        # ---- window, norm estimates, stopping tests (minres.py:303-361) -
        trnc, xnrg, test1, test2 = chain.norms(itn, delta, gamma, phi)
        if istop == 0 and itn > window and trnc < etol * xnrg:
            istop = 10
        istop = _tests(istop, itn, itnlim, test1, test2,
                       chain.anorm * chain.ynorm * eps, beta1, chain.acond,
                       eps, rtol)
        table_push(tab, itn, x, test1, test2, chain.anorm,
                   chain.acond, chain.gbar, chain.ynorm)
        done = istop != 0

    converged = zero_b or istop in _CONVERGED_CODES
    return SolveResult(
        x=torch.zeros_like(b) if zero_b else x,
        converged=torch.tensor(converged, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(itn, dtype=torch.int32, device=dev),
        resid_norm=torch.tensor(0.0 if zero_b else chain.phibar,
                                dtype=rdtype, device=dev),
        resid_norm0=torch.tensor(beta1, dtype=rdtype, device=dev),
        resid_history=history_from(store_history, itnlim, chain.hist, rdtype,
                                   dev),
        info=chain.info(rdtype, dev, itnlim, iters, store_history, tab))


def _pairs(values, dtype, device):
    """Host floats as (hi, lo) pairs of 0-d tensors of ``dtype`` on
    ``device`` (one transfer): hi is the value rounded to ``dtype``, lo the
    rounded remainder (zero in float64)."""
    v = torch.tensor(values, dtype=torch.float64)
    hi = v.to(dtype)
    both = torch.stack([hi, (v - hi.double()).to(dtype)]).to(device)
    return [(both[0, i], both[1, i]) for i in range(len(values))]


def _minres_verified(A, b, M, shift, rtol, etol, itnlim, window,
                     store_history, store_iterates, store_table, atol,
                     replace_every, ff_mv):
    """ff-MINRES, the JAX package's ``replace_every`` branches of
    ``_minres`` (``minres.py:61-418``).

    Each iteration reads the host once, for the compensated alfa and
    beta^2, and once more only when it verifies: when phibar claims the
    threshold ``max(atol, rtol ||b||)`` (at most every 5 iterations) or
    every ``replace_every`` iterations, the true residual ``||b - (A -
    shift I)(x + xl)||`` is recomputed (compensated where the storage has
    a product, else two plain applies) and istop 1 fires on it alone.
    Nothing is restarted; only istop 1, 4 (Acond) and 6 (itnlim or an
    indefinite preconditioner) stop the loop."""
    dtype, dev, n = b.dtype, b.device, b.shape[0]
    rdtype = real_dtype(dtype)
    eps = float(torch.finfo(rdtype).eps)
    zero = torch.zeros_like(b)

    x = xl = zero
    r1 = r2 = b
    r1l = r2l = zero
    y = apply_op(M, b) if M is not None else b
    yl = zero
    beta1_sq = vdot_real(b, y)
    beta1_sq, bnorm = torch.stack([beta1_sq,
                                   norm(b).to(beta1_sq.dtype)]).tolist()
    zero_b = beta1_sq == 0
    istop = 9 if beta1_sq < 0 else 0
    beta1 = math.sqrt(max(beta1_sq, 0.0))
    vthresh = max(atol, rtol * bnorm)
    (shift_t, _), = _pairs([shift], dtype, dev)

    chain = _Chain(beta1, window, eps)
    iters = history_push(history_init(store_iterates, itnlim, dtype, dev, n),
                         0, x)
    tab = table_init(store_table, itnlim, rdtype, dev)
    w = w2 = wl = w2l = zero
    rnt = bnorm
    nrep = lastv = itn = 0
    (beta_p,) = _pairs([beta1], dtype, dev)
    c1_p = None
    done = istop != 0 or zero_b
    while not done and itn < itnlim:
        itn += 1
        # ---- double-f32 Lanczos step ------------------------------------
        v, vl = ff_div(y, yl, *beta_p)
        if ff_mv is not None:
            y, ylo = ff_mv(v, vl)
        else:
            y, ylo = apply_op(A, v), apply_op(A, vl)
        ph0, pe0 = two_prod(-shift_t, v)
        y, ylo = ff_add_ff(y, ylo, ph0, pe0 - shift_t * vl)
        if itn >= 2:
            c1, c1l = c1_p
            t1h, t1l = two_prod(-c1, r1)
            y, ylo = ff_add_ff(y, ylo, t1h, t1l - c1 * r1l - c1l * r1)
        alfa_p = ff_vdot(v, vl, y, ylo)
        c2, c2l = ff_div(*alfa_p, *beta_p)
        t2h, t2l = two_prod(-c2, r2)
        y, ylo = ff_add_ff(y, ylo, t2h, t2l - c2 * r2l - c2l * r2)
        r1, r1l = r2, r2l
        r2, r2l = y, ylo
        if M is not None:
            y, yl = apply_op(M, r2), apply_op(M, r2l)
        else:
            y, yl = r2, r2l
        ah, al, bh, bl = torch.stack(
            [*alfa_p, *ff_vdot(r2, r2l, y, yl)]).tolist()
        if bh + bl < 0:             # istop 6 (minres.py:251-255)
            istop = 6
            break
        near_const, oldeps, delta, gamma, phi = chain.rotate(itn, ah + al,
                                                             bh + bl)
        if near_const:
            istop = -1

        # ---- double-f32 w recurrence and x update -----------------------
        ((oe, oel), (dl, dll), (ga, gal), (ph, phl), beta_p,
         c1_p) = _pairs([oldeps, delta, gamma, phi, chain.beta,
                         fdiv(chain.beta, chain.oldb)], dtype, dev)
        w1, w1l, w2, w2l = w2, w2l, w, wl
        t1h, t1l = two_prod(-oe, w1)
        t1l = t1l - oe * w1l - oel * w1
        t2h, t2l = two_prod(-dl, w2)
        t2l = t2l - dl * w2l - dll * w2
        sh, sl = two_sum(v, t1h)
        sh, e2 = two_sum(sh, t2h)
        w, wl = ff_div(sh, sl + e2 + t1l + t2l + vl, ga, gal)
        uh, ue = two_prod(ph, w)
        x, xl = ff_add_ff(x, xl, uh, ue + ph * wl + phl * w)
        history_push(iters, itn, x)
        _, _, test1, test2 = chain.norms(itn, delta, gamma, phi)

        # ---- verified stopping ------------------------------------------
        if istop == 0:
            if chain.acond >= 0.1 / eps:
                istop = 4
            elif itn >= itnlim:
                istop = 6
        if (chain.phibar <= vthresh and itn - lastv >= 5) \
                or itn % replace_every == 0:
            if ff_mv is not None:
                sh2, sl2 = ff_mv(x, xl)
            else:
                sh2, sl2 = apply_op(A, x), apply_op(A, xl)
            ph2, pe2 = two_prod(shift_t, x)
            d, de = two_sum(b, -sh2)
            d2, de2 = two_sum(d, ph2)
            rt = d2 + (de + de2 + pe2 + shift_t * xl - sl2)
            rnt = norm(rt).item()
            nrep += 1
            lastv = itn
            if istop == 0 and rnt <= vthresh:
                istop = 1
        table_push(tab, itn, x, test1, test2, chain.anorm,
                   chain.acond, chain.gbar, chain.ynorm)
        done = istop != 0

    info = chain.info(rdtype, dev, itnlim, iters, store_history, tab)
    info["n_replacements"] = torch.tensor(nrep, dtype=torch.int32,
                                          device=dev)
    info["x_lo"] = xl
    # each Lanczos step and each verification is one compensated product,
    # or two plain applies (hi and lo) without one
    mult = 1 if ff_mv is not None else 2
    return SolveResult(
        x=torch.zeros_like(b) if zero_b else x,
        converged=torch.tensor(zero_b or istop == 1, device=dev),
        istop=torch.tensor(istop, dtype=torch.int32, device=dev),
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor((itn + nrep) * mult, dtype=torch.int32,
                              device=dev),
        resid_norm=torch.tensor(0.0 if zero_b else rnt, dtype=rdtype,
                                device=dev),
        resid_norm0=torch.tensor(bnorm, dtype=rdtype, device=dev),
        resid_history=history_from(store_history, itnlim, chain.hist, rdtype,
                                   dev),
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
           replace_every=None, atol=0.0):
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
    replace_every : verified stopping (ff-MINRES, the counterpart of
        ff-CG's knob): the solution, the w directions and the whole
        Lanczos recurrence ride double-f32 (hi, lo) pairs, and the true
        residual ``||b - (A - shift I) x||`` is recomputed (compensated
        where the operator's storage allows) every ``replace_every``
        iterations and whenever phibar claims convergence.  istop 1 then
        certifies a true residual ``<= max(atol, rtol * ||b||)`` in the
        plain 2-norm; the recurrence's tests only decide when to verify,
        and nothing restarts.  Verification matvecs count in
        ``n_matvec``; ``info["n_replacements"]`` counts them and
        ``info["x_lo"]`` is the solution's low part.
    atol : absolute floor of the verified stopping rule (used only with
        ``replace_every``).

    Returns :class:`SolveResult`; ``info`` carries Anorm, Acond, Arnorm and
    ynorm.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "minres")
    if itnlim is None:
        itnlim = 5 * rows(b)
    if check:
        if not check_symmetric(A):
            return _check_failed(7, b, store_history, store_iterates)
        if M is not None and not check_symmetric(M):
            return _check_failed(8, b, store_history, store_iterates)
    if replace_every:
        res = _minres_verified(A, b, M, float(shift), float(rtol),
                               float(etol), int(itnlim), int(window),
                               bool(store_history) or bool(show),
                               bool(store_iterates), bool(show), float(atol),
                               int(replace_every), resolve_ff_matvec(A))
    else:
        res = _minres(A, b, M, float(shift), float(rtol), float(etol),
                      int(itnlim), int(window),
                      bool(store_history) or bool(show),
                      bool(store_iterates), bool(show))
    if show and leader(b):
        from .show import print_minres
        print_minres(res, n=rows(b), itnlim=int(itnlim), rtol=float(rtol),
                     eps=float(torch.finfo(real_dtype(b.dtype)).eps))
    if verify_final:
        res = attach_true_residual(A, b, res, float(shift))
    return res
