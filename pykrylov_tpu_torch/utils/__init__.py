"""Dtype tables and conversions, and numerics utilities."""

from .types import (allowed_types, integer_types, real_types, complex_types,
                    is_complex_dtype, is_real_dtype, result_type, as_dtype,
                    to_tensor)
from .utils import (machine_epsilon, roots_quadratic, check_symmetric,
                    check_positive_definite)

__all__ = [
    "allowed_types", "integer_types", "real_types", "complex_types",
    "is_complex_dtype", "is_real_dtype", "result_type", "as_dtype",
    "to_tensor", "machine_epsilon", "roots_quadratic", "check_symmetric",
    "check_positive_definite",
]
