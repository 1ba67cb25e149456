"""Generic solver template (import-path parity with the reference
package's ``pykrylov.generic``); counterpart of
``pykrylov_tpu/generic.py``."""

from .compat import KrylovMethod, null_log
from .solvers.result import SolveResult

__all__ = ["KrylovMethod", "null_log", "SolveResult"]
