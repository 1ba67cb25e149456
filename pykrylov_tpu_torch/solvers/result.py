"""Unified solver result contract.

Counterpart of ``pykrylov_tpu/solvers/result.py``: every solver returns a
:class:`SolveResult` whose fields mirror the reference result state
(``generic/generic.py:79-87``), here as tensors on the solve's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SolveResult"]


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Result of a Krylov solve.

    Fields that are scalars for one right-hand side are (K,) tensors, one
    entry per column, for a block solve (``cg_batched``).

    Attributes
    ----------
    x : solution estimate (the reference's ``bestSolution``).
    converged : bool scalar — stopping test satisfied before iteration cap.
    istop : int32 scalar — solver-specific stop code; each solver module
        exports an ``ISTOP_MSG`` table mapping codes to messages.
    n_iter : int32 scalar — iterations performed.
    n_matvec : int32 scalar — operator applications, the reference's
        ``nMatvec``.
    resid_norm : final residual norm (preconditioned norm where the
        reference uses one, e.g. CG's sqrt(r'My)).
    resid_norm0 : initial residual norm.
    resid_history : optional (maxiter+1,) tensor of residual norms, NaN
        beyond ``n_iter`` (the reference's ``residHistory`` list).
    info : dict of solver-specific extras (direction of infinite descent,
        curvature history, ...).
    """

    x: torch.Tensor
    converged: torch.Tensor
    istop: torch.Tensor
    n_iter: torch.Tensor
    n_matvec: torch.Tensor
    resid_norm: torch.Tensor
    resid_norm0: torch.Tensor
    resid_history: Optional[torch.Tensor] = None
    info: dict = dataclasses.field(default_factory=dict)

    def history(self):
        """Residual history trimmed to the iterations performed."""
        if self.resid_history is None:
            return []
        return self.resid_history[: int(self.n_iter) + 1].tolist()

    def __repr__(self):
        if self.converged.ndim:     # a block solve: one entry per column
            return ("SolveResult(converged=%s, istop=%s, n_iter=%d, "
                    "n_matvec=%d, resid=[%s])") % (
                self.converged.tolist(), self.istop.tolist(),
                int(self.n_iter), int(self.n_matvec),
                ", ".join("%.3e" % r for r in self.resid_norm.tolist()))
        return ("SolveResult(converged=%s, istop=%d, n_iter=%d, "
                "n_matvec=%d, resid=%.3e)") % (
            bool(self.converged), int(self.istop), int(self.n_iter),
            int(self.n_matvec), float(self.resid_norm))
