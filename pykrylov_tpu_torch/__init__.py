"""pykrylov_tpu_torch — the Krylov solver framework on PyTorch and CUDA.

A port of ``pykrylov_tpu`` (JAX, XLA and Pallas on a TPU) to PyTorch on an
NVIDIA H100, module by module with the same paths and public names.  Plain
tensor code is PyTorch; each Pallas kernel becomes a CUDA kernel written
for Hopper, compiled from ``csrc/`` at first use.  This package imports
torch and NumPy, never JAX.

Ported so far: the operator layer with native block products, CG and
block-batched CG, MINRES, SYMMLQ, BiCGSTAB, CGS and TFQMR, the numerics
utilities, the sparse containers with their plain products, the CUDA DIA
and BELL SpMV and SpMM kernels, automatic format choice, MatrixMarket
reading, the bundled matrices, the Poisson, tiled and convection-diffusion
galleries, and ``solve`` for square systems: CG for symmetric positive
definite ones (one right-hand side or an (n, K) block of them), falling
back to MINRES on an indefinite operator, and BiCGSTAB, falling back to
TFQMR on a breakdown, for unsymmetric ones.
"""

from .version import __version__

from . import utils
from . import ops
from . import solvers
from . import sparse
from . import io
from . import gallery
from . import convert
from .ops import LinearOperator
from .solvers import (SolveResult, ISTOP_MSGS, cg, minres, symmlq, bicgstab,
                      cgs, tfqmr)
from .utils import (machine_epsilon, roots_quadratic, check_symmetric,
                    check_positive_definite)
from .solve import solve

__all__ = ["__version__", "solve", "LinearOperator", "SolveResult",
           "ISTOP_MSGS", "cg", "minres", "symmlq", "bicgstab", "cgs",
           "tfqmr", "machine_epsilon", "roots_quadratic", "check_symmetric",
           "check_positive_definite", "utils", "ops", "solvers", "sparse",
           "io", "gallery", "convert"]
