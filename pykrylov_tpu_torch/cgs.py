"""CGS (import-path parity with the reference package's
``pykrylov.cgs``); counterpart of ``pykrylov_tpu/cgs.py``."""

from .compat import CGS
from .solvers.cgs import cgs as solve_cgs
from .solvers.cgs import ISTOP_MSG

__all__ = ["CGS", "solve_cgs", "ISTOP_MSG"]
