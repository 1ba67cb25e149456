"""Least-squares family (import-path parity with the reference package's
``pykrylov.lls``); counterpart of ``pykrylov_tpu/lls.py``."""

from .compat import (LSQRFramework, LSMRFramework, CRAIGFramework,
                     CRAIGMRFramework)
from .solvers.lsqr import lsqr
from .solvers.lsmr import lsmr
from .solvers.craig import craig
from .solvers.craigmr import craigmr
from .solvers.lls_common import sym_ortho as symOrtho

__all__ = ["LSQRFramework", "LSMRFramework", "CRAIGFramework",
           "CRAIGMRFramework", "lsqr", "lsmr", "craig", "craigmr",
           "symOrtho"]
