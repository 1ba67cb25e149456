"""Complex linear systems through the real-equivalent formulation.

Counterpart of ``pykrylov_tpu/ops/complex_eq.py``.  A complex system ``A z
= b`` is solved as the real system

    [ Re A   -Im A ] [ Re z ]   [ Re b ]
    [ Im A    Re A ] [ Im z ] = [ Im b ]

with the isometric packing ``pack_complex(z) = [Re z; Im z]``.  The
port's sparse kernels are real-only, so this is how a complex system
reaches them: :func:`real_equivalent_operator` builds the real matrix
through :func:`~..sparse.sparse_operator`, whose ``fmt="auto"`` sends it
to the DIA or SELL kernel on the card.  What the solvers rely on carries
over exactly:

* ``||pack(z)||_2 = ||z||_2`` and ``<pack u, pack v> = Re <u, v>``:
  residual norms and stopping tests are the complex ones;
* A Hermitian => the real equivalent is symmetric; Hermitian positive
  definite => SPD, so CG and MINRES apply; its spectrum is A's with each
  eigenvalue doubled, so CG's iteration counts match the complex
  recurrence's;
* least squares: ``min ||A z - b||`` over complex z is exactly the
  real-equivalent least-squares problem.

Explicitly zero Re or Im blocks are dropped at packing time (a real-valued
matrix costs 2x its nonzeros, not 4x).  The host-side functions take and
give NumPy arrays as the JAX package's; :func:`pack_complex` and
:func:`unpack_complex` also take tensors and keep them on their device,
and :func:`complex_solve` returns a complex tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base import BaseLinearOperator, MatrixOperator
from ..utils.types import to_tensor

__all__ = ["pack_complex", "unpack_complex", "real_equivalent_dense",
           "real_equivalent_coo", "real_equivalent_operator",
           "complex_solve"]


def _real_dtype(dtype):
    return np.zeros((), np.dtype(dtype)).real.dtype


def pack_complex(z):
    """(m,) or (m, K) complex -> (2m,) or (2m, K) real ``[Re; Im]``.

    Isometric: ``||pack(z)|| = ||z||`` and ``pack(u) . pack(v) = Re(u^H
    v)``.  Real inputs pack with a zero imaginary half.  A tensor gives a
    tensor on its device, anything else a NumPy array.
    """
    if isinstance(z, torch.Tensor):
        if z.dtype.is_complex:
            return torch.cat([z.real, z.imag], 0)
        return torch.cat([z, torch.zeros_like(z)], 0)
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=0).astype(
        _real_dtype(z.dtype))


def unpack_complex(x):
    """(2m,) or (2m, K) real -> complex (m,) or (m, K), the inverse of
    :func:`pack_complex`.  Sub-double floats (f32, and the bf16/f16 blocks
    of low-precision solves) pair with complex64, f64 with complex128.  A
    tensor gives a tensor on its device."""
    m2 = x.shape[0]
    if m2 % 2:
        raise ValueError("unpack_complex: leading dimension %d is odd"
                         % m2)
    m = m2 // 2
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float64:
            x = x.float()
        return torch.complex(x[:m], x[m:])
    x = np.asarray(x)
    ct = np.complex128 if x.dtype == np.float64 else np.complex64
    return (x[:m] + 1j * x[m:]).astype(ct)


def real_equivalent_dense(a):
    """Complex (m, n) dense -> real (2m, 2n) ``[[Re, -Im], [Im, Re]]``."""
    a = np.asarray(a)
    re, im = a.real, a.imag
    return np.block([[re, -im], [im, re]]).astype(_real_dtype(a.dtype))


def real_equivalent_coo(vals, rows, cols, shape, drop_zeros=True):
    """Complex COO triples -> real-equivalent COO triples of shape
    (2m, 2n).

    Entry ``(r, c, v)`` contributes up to four real entries: ``(r, c, Re
    v)``, ``(r, c+n, -Im v)``, ``(r+m, c, Im v)``, ``(r+m, c+n, Re v)``.
    With ``drop_zeros`` (default) exact-zero Re/Im parts emit nothing.
    Triples must store the full pattern (both triangles of a Hermitian
    matrix).
    """
    m, n = shape
    vals = np.asarray(vals)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    re, im = vals.real, vals.imag
    rt = _real_dtype(vals.dtype)
    out_v, out_r, out_c = [], [], []
    for blk_v, dr, dc in ((re, 0, 0), (re, m, n), (-im, 0, n), (im, m, 0)):
        if drop_zeros:
            keep = blk_v != 0
            if not keep.any():
                continue
            out_v.append(blk_v[keep].astype(rt))
            out_r.append(rows[keep] + dr)
            out_c.append(cols[keep] + dc)
        else:
            out_v.append(blk_v.astype(rt))
            out_r.append(rows + dr)
            out_c.append(cols + dc)
    if not out_v:           # all-zero matrix: one explicit zero entry
        out_v, out_r, out_c = [np.zeros(1, rt)], [np.zeros(1, np.int64)], \
            [np.zeros(1, np.int64)]
    return (np.concatenate(out_v), np.concatenate(out_r),
            np.concatenate(out_c), (2 * m, 2 * n))


def real_equivalent_operator(source, hermitian=False, fmt="auto",
                             dtype=None, device="cuda"):
    """A real (2m, 2n) operator equivalent to a complex matrix.

    ``source``: a complex dense array or COO triples ``(vals, rows, cols,
    shape)`` (full pattern).  ``hermitian=True`` marks the real equivalent
    symmetric (valid iff A is Hermitian, not merely complex-symmetric).
    ``dtype`` is the real compute dtype.

    A dense source gives a :class:`MatrixOperator` over the (2m, 2n) real
    array (the sparse formats are pathological on dense patterns); COO
    triples go through :func:`~..sparse.sparse_operator`, where ``fmt``
    passes through (``"auto"``: the DIA or SELL kernel on the card for a
    large matrix; ``"dense"`` densifies small triples).  The operator
    carries ``m_complex``/``n_complex`` with the complex shape.
    """
    from ..sparse.linop import sparse_operator

    dense_src = not (isinstance(source, tuple) and len(source) == 4)
    if dense_src:
        a = np.asarray(source)
        if a.ndim != 2:
            raise ValueError("real_equivalent_operator: expected a 2-D "
                             "matrix or COO triples, got shape %s"
                             % (a.shape,))
        shape = a.shape
    else:
        vals, rows, cols, shape = source

    if fmt == "dense" or (dense_src and fmt == "auto"):
        if not dense_src:
            a = np.zeros(shape, dtype=np.asarray(vals).dtype)
            np.add.at(a, (np.asarray(rows), np.asarray(cols)),
                      np.asarray(vals))
        ar = real_equivalent_dense(a)
        if dtype is not None:
            ar = to_tensor(ar, device=device, dtype=dtype)
        op = MatrixOperator(ar, symmetric=bool(hermitian), device=device)
    else:
        if dense_src:
            rows, cols = np.nonzero(a)
            vals = a[rows, cols]
        vals4 = real_equivalent_coo(vals, rows, cols, shape)
        op = sparse_operator(vals4, symmetric=bool(hermitian), fmt=fmt,
                             dtype=dtype, device=device)
    op.m_complex, op.n_complex = shape
    return op


def complex_solve(solver, A, b, *, x0=None, device="cuda", **kwargs):
    """Solve a complex system or least-squares problem with a real solver
    on the real-equivalent formulation.

    Parameters
    ----------
    solver : any solver of :mod:`pykrylov_tpu_torch.solvers` (``cg``,
        ``minres``, ``bicgstab``, ``lsqr``, ..., or a batched twin).
    A : the complex matrix (dense, or COO triples), built with
        :func:`real_equivalent_operator` on ``device``, or an operator
        already built by it (``hermitian=True`` there for CG/MINRES).
    b : complex right-hand side, (m,) or (m, K) for the batched solvers.
    x0 : optional complex initial guess (packed here).
    kwargs : passed to the solver.  Preconditioners (``M``, ``N``) must
        already be real-equivalent operators.

    Returns the solver's :class:`SolveResult` with ``x`` the unpacked
    complex solution, a tensor on the operator's device.  The norm fields
    are the complex residual norms (the packing is an isometry);
    ``n_matvec`` counts real-equivalent products, each the work of one
    complex product.
    """
    if isinstance(A, BaseLinearOperator):
        op = A
    else:
        # Hermitian is the caller's statement, not sniffed: the general
        # (unsymmetric) real equivalent by default
        op = real_equivalent_operator(A, device=device)
    bp = to_tensor(pack_complex(b), device=op.device)
    if x0 is not None:
        kwargs["x0"] = to_tensor(pack_complex(x0), device=op.device)
    res = solver(op, bp, **kwargs)
    return dataclasses.replace(res, x=unpack_complex(res.x))
