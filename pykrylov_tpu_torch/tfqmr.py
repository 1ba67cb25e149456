"""TFQMR (import-path parity with the reference package's
``pykrylov.tfqmr``); counterpart of ``pykrylov_tpu/tfqmr.py``."""

from .compat import TFQMR
from .solvers.tfqmr import tfqmr as solve_tfqmr
from .solvers.tfqmr import ISTOP_MSG

__all__ = ["TFQMR", "solve_tfqmr", "ISTOP_MSG"]
