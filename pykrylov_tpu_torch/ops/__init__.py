"""Operator layer: linear operators over torch tensors."""

from .base import (
    ShapeError,
    BaseLinearOperator,
    LinearOperator,
    IdentityOperator,
    DiagonalOperator,
    ZeroOperator,
    MatrixOperator,
    aslinearoperator,
)

__all__ = [
    "ShapeError", "BaseLinearOperator", "LinearOperator", "IdentityOperator",
    "DiagonalOperator", "ZeroOperator", "MatrixOperator", "aslinearoperator",
]
