"""Sparse containers, the CUDA DIA and SELL kernels, the BELL container
with its card form, and sparse-backed operators."""

from .formats import (COO, CSR, ELL, DIA,
                      coo_from_arrays, csr_from_coo, ell_from_coo,
                      dia_from_coo, transpose_coo, bandwidth_profile,
                      coo_matvec, csr_matvec, ell_matvec, dia_matvec,
                      to_dense)
from .kernels import cuda_dia_operator, dia_transpose
from .sell import (SELL, sell_from_levels, sell_matvec, sell_matvec_plain,
                   sell_matmat, sell_matmat_plain)
from .bell import (BELL, BellOperator, SpanError, bell_from_coo,
                   bell_operator, bell_matvec_plain, reorder_rcm)
from .linop import (SparseOperator, sparse_operator, operator_from_coo,
                    jacobi_preconditioner, diag_of_coo,
                    cuda_dia_sparse_operator)

__all__ = [
    "COO", "CSR", "ELL", "DIA",
    "coo_from_arrays", "csr_from_coo", "ell_from_coo", "dia_from_coo",
    "transpose_coo", "bandwidth_profile",
    "coo_matvec", "csr_matvec", "ell_matvec", "dia_matvec", "to_dense",
    "cuda_dia_operator", "dia_transpose",
    "SELL", "sell_from_levels", "sell_matvec", "sell_matvec_plain",
    "sell_matmat", "sell_matmat_plain",
    "BELL", "BellOperator", "SpanError", "bell_from_coo", "bell_operator",
    "bell_matvec_plain", "reorder_rcm",
    "SparseOperator", "sparse_operator", "operator_from_coo",
    "jacobi_preconditioner", "diag_of_coo", "cuda_dia_sparse_operator",
]
