"""Convection-diffusion gallery: the nonsymmetric stencil problem.

Counterpart of ``pykrylov_tpu/gallery/convdiff.py``: the 2-D
convection-diffusion operator ``-Δu + (wx, wy)·∇u`` on the unit square
(Dirichlet), central differences for the diffusion and first-order
upwinding for the convection, as a matrix-free matvec on tensors and as
COO triples for the sparse operators, built in NumPy in the same order as
the JAX package's.

Upwinding keeps the matrix an M-matrix (row-wise diagonally dominant) for
every Péclet number, so the transpose-free solvers converge without
preconditioning; the skew part grows with ``w``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator

__all__ = ["convdiff2d_matvec", "convdiff2d_coo", "convdiff2d_operator"]


def _coeffs(n, wx, wy):
    """Stencil coefficients on the n x n interior grid with h = 1/(n+1):
    (center, west, east, south, north) scaled by h^2."""
    h = 1.0 / (n + 1)
    # diffusion: 4, -1, -1, -1, -1; upwind convection adds |w|h terms
    cw = -1.0 - max(wx, 0.0) * h
    ce = -1.0 + min(wx, 0.0) * h
    cs = -1.0 - max(wy, 0.0) * h
    cn = -1.0 + min(wy, 0.0) * h
    cc = 4.0 + (abs(wx) + abs(wy)) * h
    return cc, cw, ce, cs, cn


def convdiff2d_matvec(x, wx=20.0, wy=10.0):
    """Matrix-free ``y = A x`` for the n² unknowns of the 2-D
    convection-diffusion stencil (x flattened row-major)."""
    n = int(round(np.sqrt(x.shape[0])))
    cc, cw, ce, cs, cn = _coeffs(n, wx, wy)
    u = x.reshape(n, n)
    y = cc * u
    y[:, 1:] += cw * u[:, :-1]
    y[:, :-1] += ce * u[:, 1:]
    y[1:, :] += cs * u[:-1, :]
    y[:-1, :] += cn * u[1:, :]
    return y.reshape(-1)


def convdiff2d_coo(n, wx=20.0, wy=10.0, dtype=np.float64):
    """COO triples ``(vals, rows, cols, shape)`` of the n² x n² matrix."""
    cc, cw, ce, cs, cn = _coeffs(n, wx, wy)
    idx = np.arange(n * n).reshape(n, n)
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n * n, cc, dtype)]

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype))

    add(idx[:, 1:], idx[:, :-1], cw)
    add(idx[:, :-1], idx[:, 1:], ce)
    add(idx[1:, :], idx[:-1, :], cs)
    add(idx[:-1, :], idx[1:, :], cn)
    return (np.concatenate(vals), np.concatenate(rows),
            np.concatenate(cols), (n * n, n * n))


def convdiff2d_operator(n, wx=20.0, wy=10.0, dtype=torch.float32,
                        device="cuda"):
    """Matrix-free LinearOperator on n² unknowns on ``device``; its exact
    transpose is the same stencil with the convection reversed (the upwind
    coefficients swap west with east and south with north)."""
    wx, wy = float(wx), float(wy)
    return LinearOperator(
        n * n, n * n, matvec=lambda x: convdiff2d_matvec(x, wx, wy),
        matvec_transp=lambda x: convdiff2d_matvec(x, -wx, -wy),
        symmetric=False, hermitian=False, dtype=dtype, device=device)
