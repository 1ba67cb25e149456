"""Linear-operator layer (import-path parity with the reference package's
``pykrylov.linop``); counterpart of ``pykrylov_tpu/linop.py``."""

from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = list(_ops_all)
