"""Krylov solvers — plain functions on tensors returning ``SolveResult``.

CG, MINRES and SYMMLQ for symmetric indefinite systems, BiCGSTAB, CGS and
TFQMR for square unsymmetric ones, and LSQR, LSMR, CRAIG and CRAIG-MR for
rectangular and regularized ones are ported, each with its block-batched
twin for an (n, K) block of right-hand sides (``cg_batched`` ...
``craigmr_batched``; ``solve_columns`` runs one solve per column), and the
verified variants: CG's and MINRES's ``replace_every`` (single and
batched) and the refinement drivers ``refined_solve``, ``refined_lls`` and
``refined_solve_batched``; pipelined CG (``cg_pipelined``, and its twin
``cg_pipelined_batched``), and the differentiable solves
(``make_differentiable``, ``cg_solve``, ``bicgstab_solve``,
``lsqr_solve``).  Each solver's module keeps its ``ISTOP_MSG`` table;
``ISTOP_MSGS`` gathers them by solver name, the batched twins' and the
refinement drivers' included.

The submodules are imported before the function names are bound, so each
name below is the solver, not the module of the same name.
"""

from .result import SolveResult
from . import (cg as _m_cg, minres as _m_minres, symmlq as _m_symmlq,
               bicgstab as _m_bicgstab, cgs as _m_cgs, tfqmr as _m_tfqmr,
               lsqr as _m_lsqr, lsmr as _m_lsmr, craig as _m_craig,
               craigmr as _m_craigmr, pipelined as _m_pipelined,
               diff as _m_diff, refine as _m_refine)  # noqa: F401
from .cg import cg
from .minres import minres
from .symmlq import symmlq
from .bicgstab import bicgstab
from .cgs import cgs
from .tfqmr import tfqmr
from .lsqr import lsqr
from .lsmr import lsmr
from .craig import craig
from .craigmr import craigmr
from .pipelined import cg_pipelined
from .diff import make_differentiable, cg_solve, bicgstab_solve, lsqr_solve
from .refine import refined_solve, refined_solve_batched, refined_lls
from .batched import (ISTOP_MSG, ISTOP_MSG_TF, cg_batched,
                      cg_pipelined_batched, bicgstab_batched,
                      cgs_batched, tfqmr_batched, minres_batched,
                      symmlq_batched, lsqr_batched, lsmr_batched,
                      craig_batched, craigmr_batched, solve_columns)

ISTOP_MSGS = {"cg": _m_cg.ISTOP_MSG, "cg_batched": ISTOP_MSG,
              "cg_pipelined": _m_pipelined.ISTOP_MSG,
              "cg_pipelined_batched": _m_pipelined.ISTOP_MSG,
              "minres": _m_minres.ISTOP_MSG, "symmlq": _m_symmlq.ISTOP_MSG,
              "bicgstab": _m_bicgstab.ISTOP_MSG, "cgs": _m_cgs.ISTOP_MSG,
              "tfqmr": _m_tfqmr.ISTOP_MSG, "lsqr": _m_lsqr.ISTOP_MSG,
              "lsmr": _m_lsmr.ISTOP_MSG, "craig": _m_craig.ISTOP_MSG,
              "craigmr": _m_craigmr.ISTOP_MSG,
              "bicgstab_batched": ISTOP_MSG_TF, "cgs_batched": ISTOP_MSG_TF,
              "tfqmr_batched": ISTOP_MSG_TF,
              "minres_batched": _m_minres.ISTOP_MSG,
              "symmlq_batched": _m_symmlq.ISTOP_MSG,
              "lsqr_batched": _m_lsqr.ISTOP_MSG,
              "lsmr_batched": _m_lsmr.ISTOP_MSG,
              "craig_batched": _m_craig.ISTOP_MSG,
              "craigmr_batched": _m_craigmr.ISTOP_MSG,
              "refined_solve": _m_refine.ISTOP_MSG,
              "refined_lls": _m_refine.ISTOP_MSG,
              "refined_solve_batched": _m_refine.ISTOP_MSG}

__all__ = ["SolveResult", "cg", "minres", "symmlq", "bicgstab", "cgs",
           "tfqmr", "lsqr", "lsmr", "craig", "craigmr", "cg_pipelined",
           "make_differentiable", "cg_solve", "bicgstab_solve",
           "lsqr_solve", "cg_batched", "cg_pipelined_batched",
           "bicgstab_batched", "cgs_batched", "tfqmr_batched",
           "minres_batched", "symmlq_batched", "lsqr_batched",
           "lsmr_batched", "craig_batched", "craigmr_batched",
           "solve_columns", "refined_solve", "refined_solve_batched",
           "refined_lls", "ISTOP_MSG", "ISTOP_MSG_TF", "ISTOP_MSGS"]
