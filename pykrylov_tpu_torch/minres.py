"""MINRES (import-path parity with the reference package's
``pykrylov.minres``); counterpart of ``pykrylov_tpu/minres.py``."""

from .compat import Minres
from .solvers.minres import minres as solve_minres
from .solvers.minres import ISTOP_MSG

__all__ = ["Minres", "solve_minres", "ISTOP_MSG"]
