"""Top-level ``solve`` front door with automatic method selection.

Counterpart of ``pykrylov_tpu/solve.py``.  The method follows the
operator's shape and declared symmetry.  For a 1-D right-hand side:

  * square + symmetric/hermitian → CG with the curvature check, falling
    back to MINRES when CG meets nonpositive curvature (``istop 2``);
  * square, general              → BiCGSTAB, falling back to TFQMR with the
    same options when its recurrence breaks down (``istop 3``);
  * rectangular                  → LSMR (monotone ``||A'r||``, safe
    early stops).

Both fallbacks dispatch on the first solver's stop code, read on the host;
the JAX package's traced variants (a ``lax.cond`` under ``jit``) have no
counterpart in an eager loop.

For an (n, K) block of right-hand sides (``_solve_block``, after the JAX
package's ``solve.py:204-288``) each method goes to its batched twin,
which applies the operator (and A^T) to all K columns at once through its
native block product; without ``method=``, a rectangular operator goes to
``lsqr_batched``, a square symmetric or hermitian one to ``cg_batched``
and any other square one to ``bicgstab_batched``.  A block has no
fallback: the batched solvers report per-column stop codes.

``verified=True`` (after the JAX package's ``solve.py:140-182`` and
``:216-263``) stops only on recomputed true residuals: for a 1-D ``b``,
``method=`` lsqr or lsmr (and a rectangular operator, with LSMR) goes to
:func:`~.solvers.refine.refined_lls`, any other method to
:func:`~.solvers.refine.refined_solve` with its solver, a symmetric
operator to refined CG with the curvature check (rerouted to refined
MINRES legs when a leg meets nonpositive curvature) and any other to
refined BiCGSTAB.  For a block, a symmetric operator goes to ff
``cg_batched`` (``replace_every=50``), ``method="minres"`` to ff
``minres_batched`` and an unsymmetric one, or ``method=`` bicgstab, cgs or
tfqmr, to :func:`~.solvers.refine.refined_solve_batched` with the twin.

An operator that carries ``solve_permutation`` (an RCM-reordered BELL
operator, ``A = P^T A' P``) is solved in the permuted space: ``A' x' = P b``
through its inner operator, with no gathers per product, and ``x`` is
un-permuted once; for a block only the rows are permuted.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from .ops.base import DiagonalOperator, LinearOperator
from .solvers.batched import (bicgstab_batched, cg_batched,
                              cg_pipelined_batched, cgs_batched,
                              craig_batched, craigmr_batched, lsmr_batched,
                              lsqr_batched, minres_batched, symmlq_batched,
                              tfqmr_batched)
from .solvers.bicgstab import bicgstab
from .solvers.cg import cg
from .solvers.cgs import cgs
from .solvers.common import apply_op, as_operator, host_read, promote_rhs
from .solvers.craig import craig
from .solvers.craigmr import craigmr
from .solvers.lsmr import lsmr
from .solvers.lsqr import lsqr
from .solvers.minres import minres
from .solvers.pipelined import cg_pipelined
from .solvers.refine import (refined_lls, refined_solve,
                             refined_solve_batched)
from .solvers.symmlq import symmlq
from .solvers.tfqmr import tfqmr
from .utils.observe import solving
from .utils.types import to_tensor

__all__ = ["solve"]

# method -> its solver
_SOLVERS = {"cg": cg, "cg_pipelined": cg_pipelined, "minres": minres,
            "symmlq": symmlq, "bicgstab": bicgstab, "cgs": cgs,
            "tfqmr": tfqmr, "lsqr": lsqr, "lsmr": lsmr, "craig": craig,
            "craigmr": craigmr}
# method -> its batched twin (JAX solve.py:204-210)
_BATCHED = {"cg": cg_batched, "cg_pipelined": cg_pipelined_batched,
            "bicgstab": bicgstab_batched,
            "cgs": cgs_batched, "tfqmr": tfqmr_batched,
            "minres": minres_batched, "symmlq": symmlq_batched,
            "lsqr": lsqr_batched, "lsmr": lsmr_batched,
            "craig": craig_batched, "craigmr": craigmr_batched}


def _permute_precon(M, p, ip):
    """A preconditioner in the permuted solve space, ``M' = P M P^T``: a
    diagonal one permutes its diagonal; any other is wrapped with two
    gathers per apply."""
    M = as_operator(M)
    if isinstance(M, DiagonalOperator):
        return DiagonalOperator(M.diag[p], device=M.device)

    def mv(v):
        return apply_op(M, v[ip])[p]

    return LinearOperator(M.shape[1], M.shape[0], matvec=mv,
                          matvec_transp=mv if M.symmetric else None,
                          symmetric=M.symmetric, hermitian=M.hermitian,
                          dtype=M.dtype, device=M.device)


def _solve_permuted(A, b, method, verified, opts):
    p, ip, inner = A.solve_permutation
    b = b if isinstance(b, torch.Tensor) else to_tensor(b, device=A.device)
    popts = dict(opts)
    if popts.get("x0") is not None:
        x0 = popts["x0"]
        x0 = x0 if isinstance(x0, torch.Tensor) else to_tensor(
            x0, device=A.device)
        popts["x0"] = x0[p]
    if popts.get("M") is not None:
        popts["M"] = _permute_precon(popts["M"], p, ip)
    res = solve(inner, b[p], method=method, verified=verified, **popts)
    info = res.info
    if "x_lo" in info:
        # the verified solution's low part un-permuted with its high part
        # (the JAX package leaves it in the permuted space)
        info = dict(info, x_lo=info["x_lo"][ip])
    return dataclasses.replace(res, x=res.x[ip], info=info)


def _check_method(method):
    if method not in _SOLVERS:
        raise ValueError("unknown method %r (have %s)"
                         % (method, ", ".join(_SOLVERS)))


def _verified_replace_every(opts):
    """The options of an in-loop verified block solve: ``replace_every``
    50 unless given, and never 0 or None."""
    opts = dict(opts)
    opts.setdefault("replace_every", 50)
    if not opts["replace_every"]:
        raise ValueError(
            "verified=True requires replace_every >= 1 (0/None "
            "would silently run the unverified batched solver)")
    return opts


def _solve_block_verified(A, B, method, opts):
    """The verified block routes (JAX ``solve.py:216-263``)."""
    square = A.shape[0] == A.shape[1]
    sym = A.symmetric or A.hermitian
    if method in (None, "cg") and sym and square:
        # per-column double-f32 carries and stops on recomputed true
        # residuals; the curvature check keeps an indefinite operator from
        # grinding to maxiter (istop 2 per column)
        copts = _verified_replace_every(opts)
        copts.setdefault("check_curvature", True)
        return cg_batched(A, B, **copts)
    if (method in ("bicgstab", "cgs", "tfqmr")
            or (method is None and not sym)) and square:
        leg = _BATCHED[method or "bicgstab"]
        return refined_solve_batched(leg, A, B, **opts)
    if method == "minres" and sym and square:
        mopts = _verified_replace_every(opts)
        mopts.setdefault("rtol", 1e-6)
        return minres_batched(A, B, **mopts)
    raise ValueError(
        "verified=True for (n, K) right-hand-side blocks is "
        "supported for square systems: symmetric via the batched "
        "CG path (method=None or 'cg') or the ff-MINRES path "
        "(method='minres', indefinite-capable), general via "
        "block iterative refinement (method=None/'bicgstab'/"
        "'cgs'/'tfqmr'); solve rectangular blocks column by "
        "column for verified stops")


def _solve_block(A, B, method, verified, opts):
    """Multi-RHS dispatch: each method's batched twin; by shape without
    ``method=``."""
    if verified:
        if method is not None:
            _check_method(method)
        return _solve_block_verified(A, B, method, opts)
    if method is not None:
        _check_method(method)
        return _BATCHED[method](A, B, **opts)
    m, n = A.shape
    if m != n:
        return lsqr_batched(A, B, **opts)
    if A.symmetric or A.hermitian:
        return cg_batched(A, B, **opts)
    return bicgstab_batched(A, B, **opts)


def solve(A, b, method=None, verified=False, **opts):
    """Solve ``A x = b`` for a 1-D ``b``, or ``A X = B`` for an (n, K)
    block ``B``; returns a :class:`~pykrylov_tpu_torch.solvers.SolveResult`
    (per-column fields for a block).  ``opts`` pass through to the chosen
    solver; ``method=`` picks one explicitly (``"cg"``, ``"minres"``,
    ``"symmlq"``, ``"bicgstab"``, ``"cgs"``, ``"tfqmr"``, ``"lsqr"``,
    ``"lsmr"``, ``"craig"`` or ``"craigmr"``).  A rectangular operator goes
    to LSMR, ``min ||Ax - b||``.  The call runs inside the front door's
    ``solve`` span (:func:`~.utils.observe.solving`), with ``method``
    ("auto" when not given) and the right-hand sides ``K`` as its
    attributes."""
    shape = b.shape if isinstance(b, torch.Tensor) else np.shape(b)
    with solving(method=method or "auto",
                 K=int(shape[1]) if len(shape) == 2 else 1):
        return _dispatch(A, b, method, verified, opts)


def _dispatch(A, b, method, verified, opts):
    A = as_operator(A)
    if getattr(A, "solve_permutation", None) is not None:
        return _solve_permuted(A, b, method, verified, opts)
    if (b.ndim if isinstance(b, torch.Tensor) else np.ndim(b)) == 2:
        return _solve_block(A, b, method, verified, opts)
    if method is not None:
        _check_method(method)
        fn = _SOLVERS[method]
        if not verified:
            return fn(A, b, **opts)
        if method in ("lsqr", "lsmr"):
            return refined_lls(fn, A, b, **opts)
        if method in ("craig", "craigmr"):
            raise ValueError(
                "verified=True is unsupported for the SQD solvers; "
                "use verify_final=True for the post-solve "
                "certificate")
        return refined_solve(fn, A, b, **opts)

    m, n = A.shape
    if m != n:
        return refined_lls(lsmr, A, b, **opts) if verified \
            else lsmr(A, b, **opts)
    if verified:
        return _solve_verified(A, b, opts)
    if A.symmetric or A.hermitian:
        res = cg(A, b, check_curvature=True, **opts)
        if host_read(res.istop) == 2:   # indefinite: MINRES handles it
            return _minres_fallback(A, b, res, opts)
        return res
    res = bicgstab(A, b, **opts)
    if host_read(res.istop) == 3:       # breakdown: another recurrence
        # BiCGSTAB and TFQMR share their whole keyword surface, so every
        # option (x0, M, rtol, atol, matvec_max, store_history,
        # verify_final) carries over
        return tfqmr(A, b, **opts)
    return res


def _solve_verified(A, b, opts):
    """The verified route of a square operator without ``method=``:
    refined CG legs with the curvature check for a symmetric one, rerouted
    to refined MINRES legs when a leg meets nonpositive curvature (the
    unverified route's safety net), refined BiCGSTAB for any other."""
    if not (A.symmetric or A.hermitian):
        return refined_solve(bicgstab, A, b, **opts)
    res = refined_solve(cg, A, b, **dict({"check_curvature": True}, **opts))
    if not host_read(res.converged) and host_read(
            (res.info["inner_istop"] == 2).any()):
        ok = (set(inspect.signature(minres).parameters)
              | set(inspect.signature(refined_solve).parameters))
        return refined_solve(minres, A, b,
                             **{k: v for k, v in opts.items() if k in ok})
    return res


# the square-solver options MINRES takes as they are
_MINRES_OPTS = ("M", "rtol", "etol", "window", "store_history")


def _minres_fallback(A, b, cg_res, opts):
    """Re-solve an indefinite system with MINRES, keeping the square-solver
    options CG accepted (JAX ``solve.py:383-412``).

    MINRES has no ``x0`` or ``atol`` (reference ``minres.py:115-130``), so
    ``x0`` is honoured by solving the residual system ``A d = b - A x0``
    and returning ``x0 + d`` (one more counted matvec), and ``atol`` is
    folded into MINRES's relative tolerance through the initial residual
    norm that the CG attempt measured.  ``maxiter``, or else
    ``matvec_max``, becomes MINRES's ``itnlim``.
    """
    mopts = {k: v for k, v in opts.items() if k in _MINRES_OPTS}
    if "maxiter" in opts:
        mopts["itnlim"] = opts["maxiter"]
    elif "matvec_max" in opts:
        mopts["itnlim"] = opts["matvec_max"]
    atol = opts.get("atol")
    if atol is not None:
        resid0 = float(host_read(cg_res.resid_norm0))
        if resid0 > 0:
            mopts["rtol"] = max(float(mopts.get("rtol", 1e-12)),
                                float(atol) / resid0)
    x0 = opts.get("x0")
    if x0 is None:
        return minres(A, b, **mopts)
    M = opts.get("M")
    b = promote_rhs(b, A, as_operator(M) if M is not None else None)
    x0 = to_tensor(x0, device=b.device).to(b.dtype)
    res = minres(A, b - apply_op(A, x0), **mopts)
    return dataclasses.replace(res, x=res.x + x0.to(res.x.dtype),
                               n_matvec=res.n_matvec + 1)
