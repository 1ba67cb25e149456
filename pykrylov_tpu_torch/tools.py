"""Numerics helpers under the reference's name ``pykrylov.tools``
(``tools/`` of the reference package); the port keeps them in
:mod:`pykrylov_tpu_torch.utils` and re-exports them here, so reference-style
imports (``from pykrylov.tools import check_symmetric``) port by renaming
only the package.  Counterpart of ``pykrylov_tpu/tools.py``.
"""

from .utils.types import (allowed_types, integer_types, real_types,
                          complex_types)
from .utils.utils import (machine_epsilon, roots_quadratic, check_symmetric,
                          check_positive_definite)

__all__ = [
    "allowed_types", "integer_types", "real_types", "complex_types",
    "machine_epsilon", "roots_quadratic", "check_symmetric",
    "check_positive_definite",
]
