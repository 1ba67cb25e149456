"""Top-level ``solve`` front door with automatic method selection.

Counterpart of ``pykrylov_tpu/solve.py``.  The method follows the
operator's shape and declared symmetry.  For a 1-D right-hand side:

  * square + symmetric/hermitian → CG with the curvature check;
  * square, general              → BiCGSTAB (not ported yet);
  * rectangular                  → LSMR (not ported yet).

For an (n, K) block of right-hand sides (``_solve_block``), a square
symmetric or hermitian operator, or ``method="cg"``, goes to
:func:`~pykrylov_tpu_torch.solvers.cg_batched`, which applies the operator
to all K columns at once through its native block product; the other
batched solvers (square general → ``bicgstab_batched``, rectangular →
``lsqr_batched``, each ``method=``'s own) are not ported yet.

Each branch whose solver is not ported yet raises ``NotImplementedError``
naming its ROADMAP.md item, as do the CG→MINRES fallback on an indefinite
operator and ``verified=True``.

An operator that carries ``solve_permutation`` (an RCM-reordered BELL
operator, ``A = P^T A' P``) is solved in the permuted space: ``A' x' = P b``
through its inner operator, with no gathers per product, and ``x`` is
un-permuted once; for a block only the rows are permuted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.base import DiagonalOperator, LinearOperator
from .solvers.batched import cg_batched
from .solvers.cg import cg
from .solvers.common import apply_op, as_operator
from .utils.types import to_tensor

__all__ = ["solve"]

_METHODS = ("cg", "cg_pipelined", "minres", "symmlq", "bicgstab", "cgs",
            "tfqmr", "lsqr", "lsmr", "craig", "craigmr")

# method -> ROADMAP.md queue 1 item that ports it
_ITEM = {"cg_pipelined": 16, "minres": 11, "symmlq": 11, "bicgstab": 10,
         "cgs": 10, "tfqmr": 10, "lsqr": 12, "lsmr": 12, "craig": 12,
         "craigmr": 12}


def _not_ported(what, item):
    return NotImplementedError("%s is not ported yet: ROADMAP.md queue 1 "
                               "item %d" % (what, item))


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
    return dataclasses.replace(res, x=res.x[ip])


def _check_method(method):
    if method not in _METHODS:
        raise ValueError("unknown method %r (have %s)"
                         % (method, ", ".join(_METHODS)))


def _solve_block(A, B, method, verified, opts):
    """Multi-RHS dispatch: ``cg_batched`` for CG; every other batched
    solver and the verified block paths raise naming their item."""
    if verified:
        raise _not_ported("solve(verified=True) with an (n, K) block", 15)
    if method is not None:
        _check_method(method)
        if method != "cg":
            raise _not_ported("method=%r with an (n, K) block (%s_batched)"
                              % (method, method), 14)
        return cg_batched(A, B, **opts)
    m, n = A.shape
    if m != n:
        raise _not_ported("solve() on a rectangular operator with an "
                          "(n, K) block (lsqr_batched)", 14)
    if A.symmetric or A.hermitian:
        return cg_batched(A, B, **opts)
    raise _not_ported("solve() on a square unsymmetric operator with an "
                      "(n, K) block (bicgstab_batched)", 14)


def solve(A, b, method=None, verified=False, **opts):
    """Solve ``A x = b`` for a 1-D ``b``, or ``A X = B`` for an (n, K)
    block ``B``; returns a :class:`~pykrylov_tpu_torch.solvers.SolveResult`
    (per-column fields for a block).  ``opts`` pass through to the chosen
    solver; ``method="cg"`` picks CG explicitly."""
    A = as_operator(A)
    if getattr(A, "solve_permutation", None) is not None:
        return _solve_permuted(A, b, method, verified, opts)
    if (b.ndim if isinstance(b, torch.Tensor) else np.ndim(b)) == 2:
        return _solve_block(A, b, method, verified, opts)
    if verified:
        raise _not_ported("solve(verified=True)", 15)
    if method is not None:
        _check_method(method)
        if method != "cg":
            raise _not_ported("method=%r" % method, _ITEM[method])
        return cg(A, b, **opts)

    m, n = A.shape
    if m != n:
        raise _not_ported("solve() on a rectangular operator (LSMR)", 12)
    if A.symmetric or A.hermitian:
        res = cg(A, b, check_curvature=True, **opts)
        if int(res.istop) == 2:
            raise _not_ported("the CG→MINRES fallback of solve() on an "
                              "indefinite operator (CG stopped on "
                              "nonpositive curvature)", 11)
        return res
    raise _not_ported("solve() on a square unsymmetric operator "
                      "(BiCGSTAB with its TFQMR fallback)", 10)
