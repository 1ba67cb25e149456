"""Operator layer: linear operators over torch tensors."""

from .base import (
    ShapeError,
    BaseLinearOperator,
    LinearOperator,
    IdentityOperator,
    DiagonalOperator,
    ZeroOperator,
    MatrixOperator,
    CoordLinearOperator,
    PysparseLinearOperator,
    ReducedLinearOperator,
    SymmetricallyReducedLinearOperator,
    linop_from_ndarray,
    aslinearoperator,
    sqrt,
)
from .blkop import (
    BlockLinearOperator,
    BlockDiagonalLinearOperator,
    BlockHorizontalLinearOperator,
    BlockVerticalLinearOperator,
    BlockPreconditioner,
    BlockDiagonalPreconditioner,
)
from .lbfgs import (
    LBFGSData,
    lbfgs_init,
    lbfgs_store,
    lbfgs_restart,
    inverse_lbfgs_matvec,
    forward_lbfgs_matvec,
    compact_lbfgs_matvec,
    InverseLBFGSOperator,
    LBFGSOperator,
    CompactLBFGSOperator,
    StructuredLBFGSOperator,
)
from .cholesky import CholeskyOperator, HostFactorizationOperator
from .chebyshev import (
    lanczos_bounds,
    ChebyshevOperator,
    chebyshev_preconditioner,
)
from .complex_eq import (
    pack_complex,
    unpack_complex,
    real_equivalent_dense,
    real_equivalent_coo,
    real_equivalent_operator,
    complex_solve,
)

__all__ = [
    "ShapeError", "BaseLinearOperator", "LinearOperator", "IdentityOperator",
    "DiagonalOperator", "ZeroOperator", "MatrixOperator",
    "CoordLinearOperator", "PysparseLinearOperator", "ReducedLinearOperator",
    "SymmetricallyReducedLinearOperator", "linop_from_ndarray",
    "aslinearoperator", "sqrt",
    "BlockLinearOperator", "BlockDiagonalLinearOperator",
    "BlockHorizontalLinearOperator", "BlockVerticalLinearOperator",
    "BlockPreconditioner", "BlockDiagonalPreconditioner",
    "LBFGSData", "lbfgs_init", "lbfgs_store", "lbfgs_restart",
    "inverse_lbfgs_matvec", "forward_lbfgs_matvec", "compact_lbfgs_matvec",
    "InverseLBFGSOperator", "LBFGSOperator", "CompactLBFGSOperator",
    "StructuredLBFGSOperator",
    "CholeskyOperator", "HostFactorizationOperator",
    "lanczos_bounds", "ChebyshevOperator", "chebyshev_preconditioner",
    "pack_complex", "unpack_complex", "real_equivalent_dense",
    "real_equivalent_coo", "real_equivalent_operator", "complex_solve",
]
