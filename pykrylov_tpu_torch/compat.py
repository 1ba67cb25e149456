"""Reference-style class API over the functional solvers.

Counterpart of ``pykrylov_tpu/compat.py``.  The reference exposes one class
per method, each subclassing ``KrylovMethod`` with a mutable result state
(``generic/generic.py:11-98``): after ``solve(rhs, **kwargs)`` the
instance carries ``converged``, ``nMatvec``, ``nIter``,
``bestSolution``/``x``, ``residNorm``, ``residNorm0`` and
``residHistory``.  This module reproduces that surface over the functional
solvers of :mod:`pykrylov_tpu_torch.solvers`, so code written against
PyKrylov ports by changing only the import; each ``solve`` runs the same
solver a direct call would.

Keyword mapping (reference → functional):
  * ctor ``abstol``/``reltol``/``precon``/``logger``
    (``generic/generic.py:74-77``) → ``atol``/``rtol``/``M`` per solve;
  * ``solve(rhs, guess=..., matvec_max=...)`` → ``x0``/``matvec_max``;
  * per-solver extras (``shift``, ``check``, ``itnlim``, ``rtol``, ``etol``,
    ``window``, ``damp``, ``M``, ``N``, ``atol``, ``btol``, ``conlim``,
    ``wantvar``) pass straight through.

The LSMR class returns the reference's tuple
``(x, istop, itn, normr, normar, normA, condA, normx)``
(``lls/lsmr.py:492``) *and* sets attributes, resolving the reference's
inconsistency in the caller's favor.
"""

from __future__ import annotations

import logging

# the solver functions, bound here once: a solver's module and its
# function share a name in the solvers package
from .solvers.cg import cg as _cg
from .solvers.minres import minres as _minres
from .solvers.symmlq import symmlq as _symmlq
from .solvers.bicgstab import bicgstab as _bicgstab
from .solvers.cgs import cgs as _cgs
from .solvers.tfqmr import tfqmr as _tfqmr
from .solvers.lsqr import lsqr as _lsqr
from .solvers.lsmr import lsmr as _lsmr
from .solvers.craig import craig as _craig
from .solvers.craigmr import craigmr as _craigmr

__all__ = [
    "KrylovMethod", "CG", "Minres", "Symmlq", "BiCGSTAB", "CGS", "TFQMR",
    "LSQRFramework", "LSMRFramework", "CRAIGFramework", "CRAIGMRFramework",
]

null_log = logging.getLogger("krylov")
null_log.setLevel(logging.INFO)
null_log.addHandler(logging.NullHandler())


class KrylovMethod:
    """Stateful wrapper base (parity: ``generic/generic.py:11-98``)."""

    name = "Generic Krylov Method (must be subclassed)"
    acronym = "Generic"

    def __init__(self, op, **kwargs):
        self.op = op
        self.abstol = kwargs.get("abstol", 1.0e-8)
        self.reltol = kwargs.get("reltol", 1.0e-6)
        self.precon = kwargs.get("precon", None)
        self.logger = kwargs.get("logger", null_log)
        self.prefix = self.acronym + ": "

        self.residNorm = None
        self.residNorm0 = None
        self.residHistory = []
        self.resids = []       # vector histories (reference cg.py:39-40)
        self.iterates = []
        self.nMatvec = 0
        self.nIter = 0
        self.converged = False
        self.bestSolution = None
        self.x = None
        self.istop = 0
        self.result = None

    def _write(self, msg):
        self.logger.info(msg)

    def _store(self, res):
        """Map a SolveResult onto reference-style attributes."""
        self.result = res
        self.x = self.bestSolution = res.x
        self.converged = bool(res.converged)
        self.istop = int(res.istop)
        self.nMatvec = int(res.n_matvec)
        self.nIter = self.itn = int(res.n_iter)
        self.residNorm = float(res.resid_norm)
        self.residNorm0 = float(res.resid_norm0)
        self.residHistory = res.history()
        self._write("%s converged=%s istop=%d nMatvec=%d residNorm=%8.2e"
                    % (self.prefix, self.converged, self.istop,
                       self.nMatvec, self.residNorm))
        return res

    def solve(self, rhs, **kwargs):
        raise NotImplementedError("This method must be subclassed")


class CG(KrylovMethod):
    """Conjugate gradients (parity: ``cg/cg.py:9-165``)."""

    name = "Conjugate Gradient"
    acronym = "CG"

    def _log_iterations(self, res, had_guess):
        """The reference's per-iteration logger lines (``cg/cg.py:106-111,
        158``): a Matvec/Resid/Curv header, then one row per iteration,
        from the history buffers; skipped when only the module's null
        logger is attached."""
        if self.logger is null_log:
            return
        hdr = "%6s  %7s  %8s" % ("Matvec", "Resid", "Curv")
        self.logger.info(hdr)
        self.logger.info("-" * len(hdr))
        hist = res.resid_history.tolist()
        curv = res.info["curvatures"].tolist()
        nmv = 1 if had_guess else 0
        self.logger.info("%6d  %7.1e" % (nmv, hist[0]))
        for itn in range(1, int(res.n_iter) + 1):
            self.logger.info("%6d  %7.1e  %8.1e"
                             % (nmv + itn, hist[itn], curv[itn]))

    def solve(self, rhs, guess=None, matvec_max=None, check_curvature=False,
              store_resids=False, store_iterates=False, replace_every=None,
              verify_final=False, **kwargs):
        res = _cg(
            self.op, rhs, x0=guess, M=self.precon, rtol=self.reltol,
            atol=self.abstol, matvec_max=matvec_max,
            check_curvature=check_curvature, store_history=True,
            store_iterates=store_iterates, store_resids=store_resids,
            replace_every=replace_every, verify_final=verify_final)
        self._log_iterations(res, guess is not None)
        res = self._store(res)
        self.definite = bool(res.info.get("definite", True))
        if check_curvature and not self.definite:
            self.infiniteDescent = res.info["infinite_descent"]
        if store_iterates:
            buf = res.info["iterates"]
            self.iterates = [buf[i] for i in range(int(res.n_iter) + 1)]
        if store_resids:
            buf = res.info["resids"]
            self.resids = [buf[i] for i in range(int(res.n_iter) + 1)]
        return res


class BiCGSTAB(KrylovMethod):
    """Bi-CGSTAB (parity: ``bicgstab/bicgstab.py:9-151``)."""

    name = "Bi-Conjugate Gradient Stabilized"
    acronym = "Bi-CGSTAB"

    def solve(self, rhs, guess=None, matvec_max=None, verify_final=False,
              **kwargs):
        return self._store(_bicgstab(
            self.op, rhs, x0=guess, M=self.precon, rtol=self.reltol,
            atol=self.abstol, matvec_max=matvec_max, store_history=True,
            verify_final=verify_final))


class CGS(KrylovMethod):
    """Conjugate gradient squared (parity: ``cgs/cgs.py:8-123``)."""

    name = "Conjugate Gradient Squared"
    acronym = "CGS"

    def solve(self, rhs, guess=None, matvec_max=None, verify_final=False,
              **kwargs):
        return self._store(_cgs(
            self.op, rhs, x0=guess, M=self.precon, rtol=self.reltol,
            atol=self.abstol, matvec_max=matvec_max, store_history=True,
            verify_final=verify_final))


class TFQMR(KrylovMethod):
    """Transpose-free QMR (parity: ``tfqmr/tfqmr.py:7-159``)."""

    name = "Transpose-Free Quasi-Minimum Residual"
    acronym = "TFQMR"

    def solve(self, rhs, guess=None, matvec_max=None, verify_final=False,
              **kwargs):
        return self._store(_tfqmr(
            self.op, rhs, x0=guess, M=self.precon, rtol=self.reltol,
            atol=self.abstol, matvec_max=matvec_max, store_history=True,
            verify_final=verify_final))


class Minres(KrylovMethod):
    """MINRES (parity: ``minres/minres.py:23-410``)."""

    name = "Minimum Residual"
    acronym = "MINRES"

    def solve(self, b, precon=None, shift=0.0, check=False, itnlim=None,
              rtol=1.0e-12, etol=1.0e-6, window=5, show=False,
              verify_final=False, **kwargs):
        res = self._store(_minres(
            self.op, b, M=precon or self.precon, shift=shift, rtol=rtol,
            etol=etol, window=window, itnlim=itnlim, check=check,
            store_history=True, show=show, verify_final=verify_final))
        self.rnorm = self.residNorm
        self.Anorm = float(res.info["Anorm"])
        self.Acond = float(res.info["Acond"])
        self.Arnorm = float(res.info["Arnorm"])
        self.ynorm = float(res.info["ynorm"])
        return res


class Symmlq(KrylovMethod):
    """SYMMLQ (parity: ``symmlq/symmlq.py:17-400``)."""

    name = "Symmetric LQ"
    acronym = "SYMMLQ"

    def solve(self, rhs, matvec_max=None, rtol=1.0e-9, shift=None,
              check=False, verify_final=False, **kwargs):
        res = self._store(_symmlq(
            self.op, rhs, M=self.precon,
            shift=shift if shift is not None else 0.0, rtol=rtol,
            matvec_max=matvec_max, check=check, store_history=True,
            verify_final=verify_final))
        self.xNorm = self.solutionNorm = (
            float(res.info["xnorm"]) if "xnorm" in res.info else 0.0)
        self.anorm = float(res.info["Anorm"]) if "Anorm" in res.info else 0.0
        self.acond = float(res.info["Acond"]) if "Acond" in res.info else 0.0
        return res


class _LLSFramework(KrylovMethod):
    def __init__(self, A, **kwargs):
        super().__init__(A, **kwargs)
        self.A = A
        self.var = None
        self.optimal = False


class LSQRFramework(_LLSFramework):
    """LSQR (parity: ``lls/lsqr.py:26-454``)."""

    name = "Least-Squares QR"
    acronym = "LSQR"

    def solve(self, rhs, itnlim=0, damp=0.0, M=None, N=None, atol=1.0e-9,
              btol=1.0e-9, conlim=1.0e8, etol=1.0e-6, window=5,
              wantvar=False, show=False, verify_final=False, **kwargs):
        res = self._store(_lsqr(
            self.A, rhs, damp=damp, M=M, N=N, atol=atol, btol=btol,
            conlim=conlim, etol=etol, window=window, itnlim=itnlim or None,
            wantvar=wantvar, store_history=True, show=show,
            verify_final=verify_final))
        self.r1norm = float(res.info["r1norm"])
        self.r2norm = float(res.info["r2norm"])
        self.Anorm = float(res.info["Anorm"])
        self.Acond = float(res.info["Acond"])
        self.Arnorm = float(res.info["Arnorm"])
        self.xnorm = float(res.info["xnorm"])
        self.optimal = bool(res.info["optimal"])
        self.var = res.info.get("var")
        return res


class LSMRFramework(_LLSFramework):
    """LSMR (parity: ``lls/lsmr.py:28-492``).

    ``solve`` returns the reference's tuple
    ``(x, istop, itn, normr, normar, normA, condA, normx)`` and also sets
    attributes (the one contract difference the package unifies, SURVEY
    §7).
    """

    name = "Least-Squares MR"
    acronym = "LSMR"

    def solve(self, b, damp=0.0, atol=1e-9, btol=1e-9, conlim=1e8,
              M=None, N=None, itnlim=None, etol=1.0e-6, window=5,
              show=False, verify_final=False, **kwargs):
        res = self._store(_lsmr(
            self.A, b, damp=damp, M=M, N=N, atol=atol, btol=btol,
            conlim=conlim, etol=etol, window=window, itnlim=itnlim,
            store_history=True, show=show, verify_final=verify_final))
        self.normr = float(res.info["normr"])
        self.normar = float(res.info["normar"])
        self.normA = float(res.info["normA"])
        self.condA = float(res.info["condA"])
        self.normx = float(res.info["normx"])
        self.optimal = bool(res.info["optimal"])
        return (res.x, int(res.istop), int(res.n_iter), self.normr,
                self.normar, self.normA, self.condA, self.normx)


class CRAIGFramework(_LLSFramework):
    """Generalized CRAIG (parity: ``lls/craig.py:30-520``)."""

    name = "CRAIG's Method for Least Squares"
    acronym = "CRAIG"

    def solve(self, rhs, itnlim=0, damp=0.0, M=None, N=None, atol=1.0e-9,
              btol=1.0e-9, etol=1.0e-6, window=5, verify_final=False,
              **kwargs):
        res = self._store(_craig(
            self.A, rhs, M=M, N=N, atol=atol, btol=btol, etol=etol,
            window=window, itnlim=itnlim or None, store_history=True,
            verify_final=verify_final))
        self.r = res.info["r"]
        self.r1norm = float(res.info["r1norm"])
        self.r2norm = float(res.info["r2norm"])
        self.Arnorm = float(res.info["Arnorm"])
        self.xnorm = float(res.info["xnorm"])
        self.optimal = bool(res.info["optimal"])
        return res


class CRAIGMRFramework(_LLSFramework):
    """CRAIG-MR (parity: ``lls/craigmr.py:13-250``)."""

    name = "Least-Norm Minimum Residual"
    acronym = "CRAIG-MR"

    def init_data(self):
        """Multi-solve reset (parity: ``craigmr.py:36-49``), a no-op for the
        solver since each ``solve`` is a function call; kept for API
        parity."""
        self.x = self.bestSolution = None
        self.istop = self.itn = self.nIter = self.nMatvec = 0
        self.converged = self.optimal = False
        self.residHistory = []

    def solve(self, b, M=None, N=None, itnlim=None, etol=1.0e-6, window=5,
              verify_final=False, **kwargs):
        res = self._store(_craigmr(
            self.A, b, M=M, N=N, etol=etol, window=window, itnlim=itnlim,
            store_history=True, verify_final=verify_final))
        self.optimal = bool(res.info["optimal"])
        return res
