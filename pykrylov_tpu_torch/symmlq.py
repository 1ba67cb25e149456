"""SYMMLQ (import-path parity with the reference package's
``pykrylov.symmlq``); counterpart of ``pykrylov_tpu/symmlq.py``."""

from .compat import Symmlq
from .solvers.symmlq import symmlq as solve_symmlq
from .solvers.symmlq import ISTOP_MSG

__all__ = ["Symmlq", "solve_symmlq", "ISTOP_MSG"]
