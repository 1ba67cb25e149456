"""Dtype tables and conversions, numerics utilities, observability and
checkpointing."""

from .types import (allowed_types, integer_types, real_types, complex_types,
                    is_complex_dtype, is_real_dtype, result_type, as_dtype,
                    to_tensor)
from .utils import (machine_epsilon, roots_quadratic, check_symmetric,
                    check_positive_definite)
from .observe import (trace, profiled, annotate, assert_replicated,
                      solve_stats)
from .checkpoint import save_result, load_result, checkpointed_solve

__all__ = [
    "allowed_types", "integer_types", "real_types", "complex_types",
    "is_complex_dtype", "is_real_dtype", "result_type", "as_dtype",
    "to_tensor", "machine_epsilon", "roots_quadratic", "check_symmetric",
    "check_positive_definite",
    "trace", "profiled", "annotate", "assert_replicated", "solve_stats",
    "save_result", "load_result", "checkpointed_solve",
]
