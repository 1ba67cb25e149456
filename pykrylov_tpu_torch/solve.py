"""Top-level ``solve`` front door with automatic method selection.

Counterpart of ``pykrylov_tpu/solve.py`` for a 1-D right-hand side.  The
method follows the operator's shape and declared symmetry:

  * square + symmetric/hermitian → CG with the curvature check;
  * square, general              → BiCGSTAB (not ported yet);
  * rectangular                  → LSMR (not ported yet).

Each branch whose solver is not ported yet raises ``NotImplementedError``
naming its ROADMAP.md item, as do the CG→MINRES fallback on an indefinite
operator, ``(n, K)`` right-hand-side blocks and ``verified=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from .solvers.cg import cg
from .solvers.common import as_operator

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


def solve(A, b, method=None, verified=False, **opts):
    """Solve ``A x = b`` for a 1-D ``b``; returns a
    :class:`~pykrylov_tpu_torch.solvers.SolveResult`.  ``opts`` pass
    through to the chosen solver; ``method="cg"`` picks CG explicitly."""
    A = as_operator(A)
    if (b.ndim if isinstance(b, torch.Tensor) else np.ndim(b)) == 2:
        raise _not_ported("solve() with an (n, K) block of right-hand "
                          "sides (the batched solver family)", 14)
    if verified:
        raise _not_ported("solve(verified=True)", 15)
    if method is not None:
        if method not in _METHODS:
            raise ValueError("unknown method %r (have %s)"
                             % (method, ", ".join(_METHODS)))
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
