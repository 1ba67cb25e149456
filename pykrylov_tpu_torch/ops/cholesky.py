"""Cholesky-based inverse operators.

Counterpart of ``pykrylov_tpu/ops/cholesky.py``, after the reference's
CHOLMOD wrapper (``linop/cholesky.py:15-43``), which exposes the inverse
of an SPD matrix as an operator through a sparse Cholesky factorization:

  * :class:`CholeskyOperator`: a dense Cholesky factor on the matrix's
    device (``torch.linalg.cholesky``), each product two triangular solves
    (``torch.cholesky_solve``), for the moderate n where the reference
    used CHOLMOD;
  * :class:`HostFactorizationOperator`: any host-side factorization
    (scipy ``splu``/``factorized``, CHOLMOD, ...) as an operator, each
    product a direct host call on a host copy of the vector.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LinearOperator
from ..utils.types import as_dtype, to_tensor

__all__ = ["CholeskyOperator", "HostFactorizationOperator"]


class CholeskyOperator(LinearOperator):
    """``A^{-1}`` for an SPD (Hermitian positive definite) A through a
    dense Cholesky factor.

    ``A`` may be a dense tensor or array, a :class:`MatrixOperator`, or any
    operator (densified with ``to_array``).  The factorization happens once
    at construction; a product is two triangular solves, on a vector or an
    (n, K) block.
    """

    def __init__(self, A, device="cuda", **kwargs):
        if isinstance(A, LinearOperator):
            A = A.to_array()
        A = to_tensor(A, device=device if not isinstance(A, torch.Tensor)
                      else A.device)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError("CholeskyOperator requires a square matrix")
        c = torch.linalg.cholesky(A)
        # the factor in each promoted dtype a product has asked for: an f32
        # factor solves an f64 vector in f64 on its exactly widened copy,
        # as the JAX package's promoting triangular solves do
        factors = {c.dtype: c}

        def mm(X):
            ct = torch.promote_types(c.dtype, X.dtype)
            if ct not in factors:
                factors[ct] = c.to(ct)
            return torch.cholesky_solve(X.to(ct), factors[ct])

        super().__init__(A.shape[0], A.shape[0],
                         matvec=lambda x: mm(x[:, None])[:, 0], matmat=mm,
                         symmetric=True, hermitian=True, dtype=A.dtype,
                         device=A.device, params=(c,), **kwargs)
        self.factor = c

    cholesky_matvec = LinearOperator.matvec


class HostFactorizationOperator(LinearOperator):
    """A host-side ``solve(rhs) -> x`` callable as an operator.

    For factorizations with no device counterpart here (sparse Cholesky or
    LU): the factorization lives on the host, and each product copies the
    vector to the host, calls ``host_solve`` on it and copies the result
    back to the vector's device.

    Parameters
    ----------
    n : problem dimension.
    host_solve : callable taking and returning 1-D NumPy arrays of length n.
    symmetric / hermitian : structure flags of the implied inverse.
    """

    def __init__(self, n, host_solve, symmetric=True, hermitian=True,
                 dtype=np.float64, device="cuda", **kwargs):
        dtype = as_dtype(dtype)

        def mv(x):
            y = np.asarray(host_solve(x.detach().cpu().numpy())).ravel()
            return to_tensor(y, device=x.device, dtype=dtype)

        super().__init__(n, n, matvec=mv, symmetric=symmetric,
                         hermitian=hermitian, dtype=dtype, device=device,
                         **kwargs)

    @classmethod
    def from_scipy_spd(cls, A_scipy, device="cuda"):
        """Factorize a scipy.sparse SPD matrix on the host (scipy's
        ``factorized``: LU, or UMFPACK where installed)."""
        from scipy.sparse.linalg import factorized
        solve = factorized(A_scipy.tocsc())
        return cls(A_scipy.shape[0], solve, dtype=A_scipy.dtype,
                   device=device)
