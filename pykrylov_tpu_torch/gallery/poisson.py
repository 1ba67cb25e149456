"""Poisson model problems (matrix-free and sparse forms).

Counterpart of ``pykrylov_tpu/gallery/poisson.py``, after the reference
gallery (PyKrylov's ``pykrylov/gallery/gallery.py:3-29``): the 1-D
tridiagonal (2,-1) stencil, the 2-D 5-point and the 3-D 7-point stencils
as slice expressions on tensors, and their COO triples, built in NumPy in
the same order as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator

__all__ = ["poisson1d_matvec", "poisson2d_matvec", "poisson3d_matvec",
           "Poisson1dMatvec", "Poisson2dMatvec",
           "poisson1d_operator", "poisson2d_operator", "poisson3d_operator",
           "poisson1d_coo", "poisson2d_coo", "poisson3d_coo",
           "poisson_eigenvalue_bounds"]


# ---------------------------------------------------------------------------
# Matrix-free matvecs
# ---------------------------------------------------------------------------


def poisson1d_matvec(x):
    """y = T x with T = tridiag(-1, 2, -1) (``gallery.py:3-8``)."""
    y = 2.0 * x
    y[:-1] -= x[1:]
    y[1:] -= x[:-1]
    return y


def poisson2d_matvec(x):
    """5-point stencil on an n x n grid, x flattened C-order
    (``gallery.py:10-29``); diagonal 4, off-diagonals -1."""
    n = int(round(np.sqrt(x.shape[0])))
    u = x.reshape(n, n)
    y = 4.0 * u
    y[:, :-1] -= u[:, 1:]
    y[:, 1:] -= u[:, :-1]
    y[:-1, :] -= u[1:, :]
    y[1:, :] -= u[:-1, :]
    return y.reshape(-1)


def poisson3d_matvec(x):
    """7-point stencil on an n x n x n grid (diagonal 6)."""
    n = int(round(x.shape[0] ** (1.0 / 3.0)))
    u = x.reshape(n, n, n)
    y = 6.0 * u
    y[:, :, :-1] -= u[:, :, 1:]
    y[:, :, 1:] -= u[:, :, :-1]
    y[:, :-1, :] -= u[:, 1:, :]
    y[:, 1:, :] -= u[:, :-1, :]
    y[:-1, :, :] -= u[1:, :, :]
    y[1:, :, :] -= u[:-1, :, :]
    return y.reshape(-1)


# Reference-style aliases (``gallery.py:3,10``).
Poisson1dMatvec = poisson1d_matvec
Poisson2dMatvec = poisson2d_matvec


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


def _op(n, mv, dtype, device):
    return LinearOperator(n, n, matvec=mv, symmetric=True, hermitian=True,
                          dtype=dtype, device=device)


def poisson1d_operator(n, dtype=torch.float32, device="cuda"):
    return _op(n, poisson1d_matvec, dtype, device)


def poisson2d_operator(n, dtype=torch.float32, device="cuda"):
    return _op(n * n, poisson2d_matvec, dtype, device)


def poisson3d_operator(n, dtype=torch.float32, device="cuda"):
    return _op(n * n * n, poisson3d_matvec, dtype, device)


# ---------------------------------------------------------------------------
# Sparse constructors (host-side NumPy)
# ---------------------------------------------------------------------------


def poisson1d_coo(n, dtype=np.float64):
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    return vals.astype(dtype), rows, cols, (n, n)


def _stencil_coo(n, dim, dtype):
    """Diagonal 2*dim, then for each axis the (forward, backward) couplings
    of -1 — the JAX package's triple order."""
    idx = np.arange(n ** dim).reshape((n,) * dim)
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n ** dim, 2.0 * dim, dtype=dtype)]
    for axis in reversed(range(dim)):
        lo = [slice(None)] * dim
        hi = [slice(None)] * dim
        lo[axis], hi[axis] = slice(None, -1), slice(1, None)
        r, c = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [r, c]
        cols += [c, r]
        vals += [np.full(2 * r.size, -1.0, dtype=dtype)]
    return (np.concatenate(vals), np.concatenate(rows),
            np.concatenate(cols), (n ** dim, n ** dim))


def poisson2d_coo(n, dtype=np.float64):
    return _stencil_coo(n, 2, dtype)


def poisson3d_coo(n, dtype=np.float64):
    return _stencil_coo(n, 3, dtype)


def poisson3d_dia_rows(n, lo, hi, dtype=np.float64):
    """Rows ``[lo, hi)`` of the 3-D Poisson matrix (``n**3`` rows) in DIA
    storage: ``(data, offsets)`` with ``data[d, r - lo] = A[r, r +
    offsets[d]]`` (zero where the neighbour is off the grid) and the
    offsets ``(-n^2, -n, -1, 0, 1, n, n^2)``; rows past ``n**3`` are zero.
    Equal, column for column, to ``dia_from_coo`` of
    :func:`poisson3d_coo` (one rank's rows of a mesh of ranks, built
    without the whole matrix)."""
    N = n ** 3
    r = np.arange(lo, hi, dtype=np.int64)
    x, y, z = r % n, (r // n) % n, r // (n * n)
    live = r < N
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    ok = (z > 0, y > 0, x > 0, np.ones_like(live), x < n - 1, y < n - 1,
          z < n - 1)
    data = np.zeros((7, hi - lo), dtype=dtype)
    for d, o in enumerate(ok):
        data[d] = np.where(o & live, -1.0, 0.0)
    data[3] = np.where(live, 6.0, 0.0)
    return data, offsets


def poisson_eigenvalue_bounds(n, dim=1):
    """Analytic extreme eigenvalues of the d-D Poisson matrix on an n-grid.

    Used for condition-number-aware test tolerances, mirroring
    ``cg/tests/test_diagdom.py:33-36,69-72``.
    """
    h = np.pi / (2.0 * (n + 1))
    lmin = dim * 4.0 * np.sin(h) ** 2
    lmax = dim * 4.0 * np.cos(h) ** 2
    return lmin, lmax
