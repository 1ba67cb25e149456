"""Krylov solvers — plain functions on tensors returning ``SolveResult``.

CG and its block-batched twin ``cg_batched`` (with ``solve_columns``, one
solve per column) are ported; the other solvers of
``pykrylov_tpu.solvers`` follow in the order of ROADMAP.md queue 1.
"""

from .result import SolveResult
from .cg import cg
from .batched import ISTOP_MSG, cg_batched, solve_columns

__all__ = ["SolveResult", "cg", "cg_batched", "solve_columns", "ISTOP_MSG"]
