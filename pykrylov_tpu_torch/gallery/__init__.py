"""Problem gallery."""

from .poisson import (
    poisson1d_matvec, poisson2d_matvec, poisson3d_matvec,
    Poisson1dMatvec, Poisson2dMatvec,
    poisson1d_operator, poisson2d_operator, poisson3d_operator,
    poisson1d_coo, poisson2d_coo, poisson3d_coo,
    poisson_eigenvalue_bounds,
)
from .general import tiled_general_coo
from .convdiff import (convdiff2d_matvec, convdiff2d_coo,
                       convdiff2d_operator)

__all__ = [
    "poisson1d_matvec", "poisson2d_matvec", "poisson3d_matvec",
    "Poisson1dMatvec", "Poisson2dMatvec",
    "poisson1d_operator", "poisson2d_operator", "poisson3d_operator",
    "poisson1d_coo", "poisson2d_coo", "poisson3d_coo",
    "poisson_eigenvalue_bounds", "tiled_general_coo",
    "convdiff2d_matvec", "convdiff2d_coo", "convdiff2d_operator",
]
