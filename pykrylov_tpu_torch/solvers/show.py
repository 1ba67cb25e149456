"""Renderers for the reference's ``show`` iteration tables.

Counterpart of ``pykrylov_tpu/solvers/show.py``.  The reference prints its
log from its Python loop (``minres/minres.py:375-393``,
``lls/lsqr.py:406-434``).  The solvers here record the table's rows as
they iterate (:func:`~.common.table_init`) and these functions render them
after the solve, with the reference's formats and print-gating line for
line, so the text equals the JAX package's for the same solve.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["print_minres", "print_lsqr", "lsqr_preamble",
           "print_lsmr", "lsmr_preamble", "craig_preamble",
           "print_craig_final", "ISTOP_MSG_MINRES", "ISTOP_MSG_LSQR"]


def _host(t):
    """A tensor (on any device) as a NumPy array; None stays None."""
    if t is None:
        return None
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def print_minres(res, n, itnlim, rtol, eps, out=print):
    """Reference MINRES table and final status block
    (``minres/minres.py:364-393``)."""
    from .minres import ISTOP_MSG
    tab = _host(res.info.get("show_table"))
    hist = _host(res.resid_history)
    out("  ")
    out("   Itn     x[0]     Compatible    LS       norm(A)  cond(A)"
        " gbar/|A|")
    if tab is None:
        out(" " + ISTOP_MSG.get(int(res.istop), ""))
        return
    nit = int(res.n_iter)
    istop = int(res.istop)
    for itn in range(1, nit + 1):
        x0, test1, test2, anorm, acond, gbar, ynorm = tab[itn]
        qrnorm = hist[itn] if hist is not None else np.nan
        epsx = anorm * ynorm * eps
        epsr = anorm * ynorm * rtol
        prnt = (n <= 40 or itn <= 10 or itn >= itnlim - 10
                or itn % 10 == 0 or qrnorm <= 10 * epsx
                or qrnorm <= 10 * epsr or acond <= 1e-2 / eps
                or (itn == nit and istop != 0))
        if prnt:
            str1 = "%6g %12.5e %10.3e" % (itn, x0, test1)
            str2 = " %10.3e" % test2
            str3 = " %8.1e %8.1e %8.1e" % (anorm, acond,
                                           gbar / anorm if anorm else 0.0)
            out(str1 + str2 + str3)
        if itn % 10 == 0:
            out(" ")
    last = " "
    anorm = float(res.info.get("Anorm", 0.0))
    acond = float(res.info.get("Acond", 0.0))
    arnorm = float(res.info.get("Arnorm", 0.0))
    ynorm = float(res.info.get("ynorm", 0.0))
    out(last + " istop   =  %3g               itn   =%5g" %
        (istop, nit))
    out(last + " Anorm   =  %12.4e      Acond =  %12.4e" % (anorm, acond))
    out(last + " rnorm   =  %12.4e      ynorm =  %12.4e" %
        (float(res.resid_norm), ynorm))
    out(last + " Arnorm  =  %12.4e" % arnorm)
    out(last + ISTOP_MSG.get(istop, ""))


def lsqr_preamble(m, n, damp, wantvar, atol, btol, conlim, itnlim,
                  out=print):
    """Reference LSQR banner (``lls/lsqr.py:168-174``)."""
    out(" ")
    out("LSQR            Least-squares solution of  Ax = b")
    out("The matrix A has %8d rows and %8d cols" % (m, n))
    out("damp = %20.14e     wantvar = %-5s" % (damp, repr(bool(wantvar))))
    out("atol = %8.2e                 conlim = %8.2e" % (atol, conlim))
    out("btol = %8.2e                 itnlim = %8g" % (btol, itnlim))


def print_lsqr(res, itnlim, atol, rtol, ctol, out=print):
    """Reference LSQR iteration table and final block
    (``lls/lsqr.py:224-434``)."""
    from .lsqr import ISTOP_MSG
    tab = _host(res.info.get("show_table"))
    out(" ")
    out("   Itn      x(1)       r1norm     r2norm  Compatible   LS"
        "      Norm A   Cond A")
    nit = int(res.n_iter)
    istop = int(res.istop)
    if tab is not None:
        for itn in range(0, nit + 1):
            x0, r1norm, r2norm, test1, test2, anorm, acond = tab[itn]
            test3 = 1.0 / acond if acond else np.inf
            prnt = (itn == 0 or itn <= 10 or itn >= itnlim - 10
                    or itn % 10 == 0 or test3 <= 2 * ctol
                    or test2 <= 10 * atol or test1 <= 10 * rtol
                    or (itn == nit and istop != 0))
            if prnt:
                str1 = "%6g %12.5e" % (itn, x0)
                str2 = " %10.3e %10.3e" % (r1norm, r2norm)
                str3 = "  %8.1e %8.1e" % (test1, test2)
                str4 = " %8.1e %8.1e" % (anorm, acond)
                out(str1 + str2 + str3 + str4)
    info = res.info
    out(" ")
    out("LSQR finished")
    out(ISTOP_MSG.get(istop, ""))
    out(" ")
    str1 = "istop =%8g   r1norm =%8.1e" % (istop, float(info["r1norm"]))
    str2 = "Anorm =%8.1e   Arnorm =%8.1e" % (float(info["Anorm"]),
                                             float(info["Arnorm"]))
    str3 = "itn   =%8g   r2norm =%8.1e" % (nit, float(info["r2norm"]))
    str4 = "Acond =%8.1e   xnorm  =%8.1e" % (float(info["Acond"]),
                                             float(info["xnorm"]))
    str5 = "                  bnorm  =%8.1e" % float(info.get("bnorm", 0.0))
    out(str1 + "   " + str2)
    out(str3 + "   " + str4)
    out(str5)
    out(" ")


def lsmr_preamble(m, n, damp, atol, btol, conlim, itnlim, out=print):
    """Reference LSMR banner (``lls/lsmr.py:196-206``)."""
    out(" ")
    out("LSMR            Least-squares solution of  Ax = b")
    out("The matrix A has %8g rows  and %8g cols" % (m, n))
    out("damp = %20.14e" % damp)
    out("atol = %8.2e                 conlim = %8.2e" % (atol, conlim))
    out("btol = %8.2e               itnlim = %8g" % (btol, itnlim))


def print_lsmr(res, n, itnlim, atol, rtol, ctol, out=print):
    """Reference LSMR iteration table and final block
    (``lls/lsmr.py:184-185,285-293,445-490``)."""
    from .lsmr import ISTOP_MSG
    hdg = ("   itn      x(1)       norm r    norm Ar"
           "  compatible   LS      norm A   cond A")
    tab = _host(res.info.get("show_table"))
    nit = int(res.n_iter)
    istop = int(res.istop)
    out(" ")
    out(hdg)
    if tab is not None:
        pcount, pfreq = 0, 20
        x0, normr, normar, test1, test2, normA, condA = tab[0]
        out("%6g %12.5e %10.3e %10.3e  %8.1e %8.1e"
            % (0, x0, normr, normar, test1, test2))
        for itn in range(1, nit + 1):
            x0, normr, normar, test1, test2, normA, condA = tab[itn]
            test3 = 1.0 / condA if condA else np.inf
            prnt = (n <= 40 or itn <= 10 or itn >= itnlim - 10
                    or itn % 10 == 0 or test3 <= 1.1 * ctol
                    or test2 <= 1.1 * atol or test1 <= 1.1 * rtol
                    or (itn == nit and istop != 0))
            if prnt:
                if pcount >= pfreq:
                    pcount = 0
                    out(" ")
                    out(hdg)
                pcount += 1
                out("%6g %12.5e %10.3e %10.3e  %8.1e %8.1e %8.1e %8.1e"
                    % (itn, x0, normr, normar, test1, test2, normA,
                       condA))
    info = res.info
    out(" ")
    out("LSMR finished")
    out(ISTOP_MSG.get(istop, ""))
    out("istop =%8g    normr =%8.1e    normA =%8.1e    normAr =%8.1e"
        % (istop, float(info["normr"]), float(info["normA"]),
           float(info["normar"])))
    out("itn   =%8g    condA =%8.1e    normx =%8.1e"
        % (nit, float(info["condA"]), float(info["normx"])))
    out("Estimated energy norm of x: %7.1e"
        % float(np.sqrt(max(float(info.get("x_nrg2", 0.0)), 0.0))))


def craig_preamble(m, n, atol, btol, itnlim, out=print):
    """Reference CRAIG banner (``lls/craig.py:193-200``; the reference's
    iteration table is commented out upstream, craig.py:275-283)."""
    out(" ")
    out("CRAIG           Least-squares solution of  Ax = b")
    out("The matrix A has %8d rows and %8d cols" % (m, n))
    out("atol = %8.2e                 itnlim = %8s" % (atol, itnlim))
    out("btol = %8.2e" % btol)


def print_craig_final(res, out=print):
    """Reference CRAIG final block (``lls/craig.py:483-492``)."""
    from .craig import ISTOP_MSG
    out(" ")
    out("CRAIG finished")
    out(ISTOP_MSG.get(int(res.istop), ""))
    out(" ")
    out("istop =%8g   r1norm =%8.1e" % (int(res.istop),
                                        float(res.info["r1norm"])))
    out("itn   =%8g   r2norm =%8.1e" % (int(res.n_iter),
                                        float(res.info["r2norm"])))
    out(" ")


# the MINRES and LSQR message tables under the JAX package's module-level
# names; read lazily, since the solvers' modules import this one
def _msgs():
    from .lsqr import ISTOP_MSG as LM
    from .minres import ISTOP_MSG as MM
    return MM, LM


class _LazyMsg(dict):
    """A read-only view of one solver's ``ISTOP_MSG``: ``get``, ``[]``,
    ``in``, ``len`` and iteration go through the solver's table."""

    def __init__(self, idx):
        super().__init__()
        self._idx = idx

    def _table(self):
        return _msgs()[self._idx]

    def get(self, k, default=""):
        return self._table().get(k, default)

    def __getitem__(self, k):
        return self._table()[k]

    def __contains__(self, k):
        return k in self._table()

    def __iter__(self):
        return iter(self._table())

    def __len__(self):
        return len(self._table())

    def items(self):
        return self._table().items()

    def keys(self):
        return self._table().keys()

    def values(self):
        return self._table().values()


ISTOP_MSG_MINRES = _LazyMsg(0)
ISTOP_MSG_LSQR = _LazyMsg(1)
