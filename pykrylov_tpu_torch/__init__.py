"""pykrylov_tpu_torch — the Krylov solver framework on PyTorch and CUDA.

A port of ``pykrylov_tpu`` (JAX, XLA and Pallas on a TPU) to PyTorch on an
NVIDIA H100, module by module with the same paths and public names.  Plain
tensor code is PyTorch; each Pallas kernel becomes a CUDA kernel written
for Hopper, compiled from ``csrc/`` at first use.  This package imports
torch and NumPy, never JAX.

Ported so far: the operator layer with native block products (with the
block, Chebyshev, L-BFGS, Cholesky, COO, reduced and complex
real-equivalent operators), CG and pipelined CG, MINRES,
SYMMLQ, BiCGSTAB, CGS, TFQMR, LSQR, LSMR, CRAIG and CRAIG-MR with the
reference's ``show`` tables and each with its block-batched twin, the reference-style
class API (``compat``) and its import paths (``cg``, ``minres``, ...,
``lls``, ``linop``, ``generic``, ``tools``), the numerics utilities, the
sparse containers with their plain products, the CUDA DIA and BELL SpMV
and SpMM kernels, automatic format choice, MatrixMarket reading, the
bundled matrices, the Poisson, tiled and convection-diffusion galleries,
and ``solve``: CG for symmetric positive definite systems, falling back to
MINRES on an indefinite operator; BiCGSTAB, falling back to TFQMR on a
breakdown, for unsymmetric ones; and LSMR for rectangular ones.  An (n, K)
block of right-hand sides goes to ``cg_batched``, ``bicgstab_batched`` or
``lsqr_batched`` by the same shapes, or to ``method=``'s batched twin.
The differentiable solves (``solvers.cg_solve``, ``bicgstab_solve``,
``lsqr_solve``) carry gradients through a solve by one adjoint solve.
``parallel`` shards a system's rows over a mesh of shard slots (several
may share one card): halo-exchange DIA operators and gather-scheduled
general sparsity through the kernels, one launch a shard, stencils and
tall operators; ``utils`` checkpoints long solves and traces them with
``torch.profiler``; ``io`` also writes MatrixMarket files and reads them
partitioned over shards.  ``native`` is the host pipeline in C++
(MatrixMarket parsing, the ELL and DIA fills, the BELL packer's planners),
compiled by ``g++`` at first use; ``examples`` holds the reference's
scripts and the demos, each run as ``python -m
pykrylov_tpu_torch.examples.<name>``.
"""

from .version import __version__

from . import utils
from . import ops
from . import solvers
from . import sparse
from . import io
from . import gallery
from . import convert
from . import compat
from . import parallel
# the import-path modules named like solvers load before the solver
# functions are bound below, so the package's ``cg`` is the function (a
# later import of ``pykrylov_tpu_torch.cg`` finds the module loaded and
# leaves the name alone)
from . import (cg, minres, symmlq, bicgstab, cgs, tfqmr, lls, linop, generic,
               tools)  # noqa: F401
from .ops import (
    ShapeError, BaseLinearOperator, LinearOperator, IdentityOperator,
    DiagonalOperator, ZeroOperator, MatrixOperator, CoordLinearOperator,
    PysparseLinearOperator, ReducedLinearOperator,
    SymmetricallyReducedLinearOperator, linop_from_ndarray, aslinearoperator,
    sqrt, BlockLinearOperator, BlockDiagonalLinearOperator,
    BlockPreconditioner, BlockDiagonalPreconditioner,
    InverseLBFGSOperator, LBFGSOperator, CompactLBFGSOperator,
    StructuredLBFGSOperator, CholeskyOperator, HostFactorizationOperator,
    lanczos_bounds, ChebyshevOperator, chebyshev_preconditioner,
    pack_complex, unpack_complex, real_equivalent_dense,
    real_equivalent_coo, real_equivalent_operator, complex_solve,
)
from .solvers import (SolveResult, ISTOP_MSGS, cg, minres, symmlq, bicgstab,
                      cgs, tfqmr, lsqr, lsmr, craig, craigmr)
from .utils import (machine_epsilon, roots_quadratic, check_symmetric,
                    check_positive_definite)
from .solve import solve

__all__ = ["__version__", "solve", "ShapeError", "BaseLinearOperator",
           "LinearOperator", "IdentityOperator", "DiagonalOperator",
           "ZeroOperator", "MatrixOperator", "CoordLinearOperator",
           "PysparseLinearOperator", "ReducedLinearOperator",
           "SymmetricallyReducedLinearOperator", "linop_from_ndarray",
           "aslinearoperator", "sqrt", "BlockLinearOperator",
           "BlockDiagonalLinearOperator", "BlockPreconditioner",
           "BlockDiagonalPreconditioner", "InverseLBFGSOperator",
           "LBFGSOperator", "CompactLBFGSOperator", "StructuredLBFGSOperator",
           "CholeskyOperator", "HostFactorizationOperator", "lanczos_bounds",
           "ChebyshevOperator", "chebyshev_preconditioner", "pack_complex",
           "unpack_complex", "real_equivalent_dense", "real_equivalent_coo",
           "real_equivalent_operator", "complex_solve", "SolveResult",
           "ISTOP_MSGS", "cg", "minres", "symmlq", "bicgstab", "cgs",
           "tfqmr", "lsqr", "lsmr", "craig", "craigmr", "machine_epsilon",
           "roots_quadratic", "check_symmetric", "check_positive_definite",
           "utils", "ops", "solvers", "sparse", "io", "gallery", "convert",
           "compat", "parallel"]
