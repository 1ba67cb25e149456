"""Conjugate-gradient algorithm (import-path parity with the reference
package's ``pykrylov.cg``); counterpart of ``pykrylov_tpu/cg.py``."""

from .compat import CG
from .solvers.cg import cg as solve_cg
from .solvers.cg import ISTOP_MSG

__all__ = ["CG", "solve_cg", "ISTOP_MSG"]
