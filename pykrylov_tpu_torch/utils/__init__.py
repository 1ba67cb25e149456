"""Dtype tables and conversions."""

from .types import (allowed_types, integer_types, real_types, complex_types,
                    is_complex_dtype, is_real_dtype, result_type, as_dtype,
                    to_tensor)

__all__ = [
    "allowed_types", "integer_types", "real_types", "complex_types",
    "is_complex_dtype", "is_real_dtype", "result_type", "as_dtype",
    "to_tensor",
]
