"""Krylov solvers — plain functions on tensors returning ``SolveResult``.

CG is ported; the other solvers of ``pykrylov_tpu.solvers`` follow in the
order of ROADMAP.md queue 1.
"""

from .result import SolveResult
from .cg import cg

__all__ = ["SolveResult", "cg"]
