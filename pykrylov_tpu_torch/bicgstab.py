"""Bi-CGSTAB (import-path parity with the reference package's
``pykrylov.bicgstab``); counterpart of ``pykrylov_tpu/bicgstab.py``."""

from .compat import BiCGSTAB
from .solvers.bicgstab import bicgstab as solve_bicgstab
from .solvers.bicgstab import ISTOP_MSG

__all__ = ["BiCGSTAB", "solve_bicgstab", "ISTOP_MSG"]
