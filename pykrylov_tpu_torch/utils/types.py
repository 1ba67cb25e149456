"""Numeric type tables for operators and solvers, in torch dtypes.

Counterpart of ``pykrylov_tpu/utils/types.py``.  ``bfloat16`` is listed as
a real type because the DIA kernel stores diagonals in it; it is a storage
type only: every product with a bf16 operator runs in float32
(``torch.promote_types(bfloat16, float32)``).

Promotion follows torch, which for the float and complex types agrees with
JAX's with x64 enabled (float32 + float64 -> float64, complex64 + float64
-> complex128).  Python scalars count as their 64-bit types, as in the
reference's ``np.result_type(op.dtype, type(alpha))``.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["integer_types", "real_types", "complex_types", "allowed_types",
           "is_complex_dtype", "is_real_dtype", "result_type", "as_dtype",
           "to_tensor"]

# Integer dtypes accepted for promotion into operators.
integer_types = [torch.int8, torch.int16, torch.int32, torch.int64]

# Real floating dtypes, smallest to largest (bfloat16: storage only).
real_types = [torch.bfloat16, torch.float16, torch.float32, torch.float64]

# Complex dtypes.
complex_types = [torch.complex64, torch.complex128]

# All dtypes allowed as an operator/vector dtype.
allowed_types = integer_types + real_types + complex_types


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a NumPy dtype or type, or a Python
    scalar type (``float`` -> float64, ``complex`` -> complex128)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bool:
        return torch.bool
    if dtype is int:
        return torch.int64
    if dtype is float:
        return torch.float64
    if dtype is complex:
        return torch.complex128
    nd = np.dtype(dtype)
    if nd.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=nd)).dtype


def is_complex_dtype(dtype) -> bool:
    """True if ``dtype`` is a complex floating dtype."""
    return as_dtype(dtype).is_complex


def is_real_dtype(dtype) -> bool:
    """True if ``dtype`` is a real floating dtype (incl. bfloat16)."""
    return as_dtype(dtype) in real_types


def result_type(*args) -> torch.dtype:
    """Promote dtypes, tensors and Python scalars to one torch dtype."""
    out = None
    for a in args:
        if isinstance(a, torch.Tensor):
            d = a.dtype
        elif isinstance(a, np.ndarray):
            d = as_dtype(a.dtype)
        elif isinstance(a, numbers.Number) and not isinstance(a, np.generic):
            d = as_dtype(type(a))
        elif isinstance(a, np.generic):
            d = as_dtype(a.dtype)
        else:
            d = as_dtype(a)
        out = d if out is None else torch.promote_types(out, d)
    if out is None:
        raise ValueError("result_type needs at least one argument")
    return out


def to_tensor(a, device="cuda", dtype=None) -> torch.Tensor:
    """A tensor from a tensor, a NumPy array (including ml_dtypes'
    bfloat16, carried bit for bit) or a sequence, on ``device``
    (``None``: a tensor stays where it is, an array on the CPU)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.ascontiguousarray(a)
        if not arr.flags.writeable:  # e.g. a view of a JAX array
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
    if device is not None or dtype is not None:
        t = t.to(device=device, dtype=None if dtype is None
                 else as_dtype(dtype))
    return t
