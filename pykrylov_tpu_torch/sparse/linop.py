"""Operators backed by sparse containers, with automatic format choice.

Counterpart of ``pykrylov_tpu/sparse/linop.py``.  The solver-facing object
is a :class:`~pykrylov_tpu_torch.ops.LinearOperator` whose products run
over a :mod:`.formats` container on the container's device.

Format policy (the JAX package's, with its thresholds, so both packages
pick the same format): matrices whose nonzeros lie on at most 64 distinct
diagonals with at least 0.25 fill use DIA, other sparsity ELL.  On a CUDA
device, square DIA-eligible matrices of at least 65,536 rows get the CUDA
DIA kernel (``fmt="cuda-dia"``), as the JAX package gives them the Pallas
kernel on a TPU.  The BELL kernel for general sparsity is not ported yet,
so general sparsity stays on ELL on every device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.base import DiagonalOperator, LinearOperator
from . import formats as F
from . import kernels as K

__all__ = ["SparseOperator", "sparse_operator", "operator_from_coo",
           "jacobi_preconditioner", "diag_of_coo", "auto_format",
           "cuda_dia_sparse_operator"]

_BELL_TODO = ("the BELL kernel and its packer are not ported yet: "
              "ROADMAP.md queue 1 item 7 and queue 2 row 4")


def _kernel_dia_matvec(a, x):
    return K.dia_matvec(a.data, a.offsets, x)


# compute format -> product over one container
_PRODUCTS = {"coo": F.coo_matvec, "csr": F.csr_matvec, "ell": F.ell_matvec,
             "dia": F.dia_matvec, "cuda-dia": _kernel_dia_matvec}
_FORMAT_OF = {F.COO: "coo", F.CSR: "csr", F.ELL: "ell", F.DIA: "dia"}


class SparseOperator(LinearOperator):
    """LinearOperator over a sparse container.

    ``fwd`` holds A and ``bwd`` A^T (None for a symmetric matrix, whose
    transpose is A).  ``fmt`` names the compute format: the container's
    own (``"coo"``, ``"csr"``, ``"ell"``, ``"dia"``: plain torch) by
    default, or ``"cuda-dia"`` for a DIA container whose products go
    through :func:`.kernels.dia_matvec`.
    """

    def __init__(self, fwd, bwd=None, symmetric=False, fmt=None, **kwargs):
        if fmt is None:
            fmt = _FORMAT_OF[type(fwd)]
        if fmt == "cuda-dia" and not isinstance(fwd, F.DIA):
            raise TypeError("fmt='cuda-dia' needs a DIA container")
        product = _PRODUCTS[fmt]
        m, n = fwd.shape
        transposed = fwd if symmetric else bwd
        is_complex = fwd.data.dtype.is_complex
        super().__init__(
            n, m, matvec=lambda x: product(fwd, x),
            matvec_transp=(lambda x: product(transposed, x))
            if transposed is not None else None,
            symmetric=symmetric, hermitian=symmetric and not is_complex,
            dtype=fwd.data.dtype, device=fwd.data.device, **kwargs)
        self.container = fwd
        self.fmt = fmt

    def to_array(self):
        return F.to_dense(self.container)


# compute format -> container built from a sorted host COO on a device
_BUILDERS = {
    "dia": lambda c, device: F.dia_from_coo(c, device=device),
    "ell": lambda c, device: F.ell_from_coo(c, pad_to=4, assume_sorted=True,
                                            device=device),
    "csr": lambda c, device: F.csr_from_coo(c, assume_sorted=True,
                                            device=device),
    "coo": lambda c, device: F.coo_from_arrays(c.data, c.row, c.col,
                                               c.shape, sort=False,
                                               device=device),
}


# The auto policy's thresholds (the JAX package's).  The diagonal limit is
# the kernel's own, so "auto" never hands the kernel a matrix it refuses.
DIA_MAX_DIAGS = K.MAX_DIAGS
DIA_MIN_DENSITY = 0.25
KERNEL_MIN_ROWS = 1 << 16


def auto_format(ndiag, density, shape, device_type):
    """The ``fmt="auto"`` choice: ``"cuda-dia"``, ``"dia"`` or ``"ell"``."""
    if ndiag > DIA_MAX_DIAGS or density < DIA_MIN_DENSITY:
        return "ell"
    if (shape[0] == shape[1] and shape[0] >= KERNEL_MIN_ROWS
            and device_type == "cuda"):
        return "cuda-dia"
    return "dia"


def operator_from_coo(vals, rows, cols, shape, symmetric=False,
                      fmt="auto", dtype=None, device="cpu"):
    """Build a SparseOperator on ``device`` from COO triples, choosing a
    compute format.

    ``fmt`` is one of ``auto | dia | cuda-dia | ell | csr | coo``
    (``bell``/``bell-rcm`` raise until the BELL kernel is ported).
    ``auto`` picks by :func:`auto_format`.  The containers are built on
    the host in NumPy and moved to ``device`` once.
    """
    if fmt in ("bell", "bell-rcm"):
        raise NotImplementedError("fmt=%r: %s" % (fmt, _BELL_TODO))
    coo = F.coo_from_arrays(vals, rows, cols, shape, dtype=dtype,
                            device=None)
    if fmt == "auto":
        ndiag, density = F.bandwidth_profile(coo)
        fmt = auto_format(ndiag, density, coo.shape,
                          torch.device(device).type)
    if fmt == "cuda-dia":
        return cuda_dia_sparse_operator(coo, symmetric=symmetric,
                                        device=device)
    if fmt not in _BUILDERS:
        raise ValueError("unknown format %r" % fmt)
    build = _BUILDERS[fmt]
    fwd = build(coo, device)
    bwd = None if symmetric else build(F.transpose_coo(coo), device)
    return SparseOperator(fwd, bwd, symmetric=symmetric)


def sparse_operator(source, symmetric=False, fmt="auto", dtype=None,
                    device="cpu"):
    """Convenience front door: source may be COO triples tuple, a container,
    a dense array or tensor, or a bundled-matrix name (str)."""
    if isinstance(source, str):
        from ..io.datasets import load_bundled
        vals, rows, cols, shape = load_bundled(source,
                                               dtype=dtype or np.float64)
        return operator_from_coo(vals, rows, cols, shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype,
                                 device=device)
    # Containers first: COO is itself a length-4 NamedTuple.
    if isinstance(source, (F.COO, F.CSR, F.ELL, F.DIA)):
        return SparseOperator(source, None, symmetric=symmetric)
    if isinstance(source, tuple) and len(source) == 4:
        vals, rows, cols, shape = source
        return operator_from_coo(vals, rows, cols, shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype,
                                 device=device)
    if isinstance(source, (np.ndarray, torch.Tensor)):
        a = (source.cpu().numpy() if isinstance(source, torch.Tensor)
             else np.asarray(source))
        rows, cols = np.nonzero(a)
        return operator_from_coo(a[rows, cols], rows, cols, a.shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype,
                                 device=device)
    raise TypeError("cannot build a sparse operator from %r" % type(source))


def diag_of_coo(vals, rows, cols, n):
    """Extract the main diagonal from COO triples (host-side)."""
    vals, rows, cols = np.asarray(vals), np.asarray(rows), np.asarray(cols)
    d = np.zeros(n, dtype=vals.dtype)
    mask = rows == cols
    np.add.at(d, rows[mask], vals[mask])
    return d


def jacobi_preconditioner(source, floor=0.0, device="cpu"):
    """Diagonal (Jacobi) preconditioner M = diag(1/|d_i|) on ``device``.

    Mirrors the reference benchmark's ``DiagonalPrec`` (max(|diag|, 1),
    ``examples/bmark.py:14-23``) when ``floor=1``.
    """
    if isinstance(source, str):
        if os.path.exists(source):  # a .mtx file path
            from ..io.matrix_market import read_matrix_market
            vals, rows, cols, shape, _ = read_matrix_market(source)
        else:
            from ..io.datasets import load_bundled
            vals, rows, cols, shape = load_bundled(source)
        d = diag_of_coo(vals, rows, cols, shape[0])
    elif isinstance(source, tuple) and len(source) == 4:
        vals, rows, cols, shape = source
        d = diag_of_coo(vals, rows, cols, shape[0])
    elif isinstance(source, SparseOperator):
        d = np.diag(source.to_array().cpu().numpy())
    else:
        d = np.diag(source.cpu().numpy() if isinstance(source, torch.Tensor)
                    else np.asarray(source))
    d = np.abs(d)
    if floor:
        d = np.maximum(d, floor)
    # Structurally zero diagonal entries (saddle-point/constraint rows)
    # would make 1/d infinite and poison the first preconditioner apply;
    # act as the identity on those rows instead.
    d = np.where(d == 0, 1.0, d)
    return DiagonalOperator(1.0 / d, device=device)


def cuda_dia_sparse_operator(coo, symmetric=False, device="cuda"):
    """DIA operator on ``device`` whose matvec is the CUDA kernel
    (:func:`.kernels.cuda_dia_operator`), built from a host COO container.
    Counterpart of ``pallas_dia_sparse_operator``; the kernel takes the
    unpadded container, so there is nothing to pad or trim."""
    return K.cuda_dia_operator(F.dia_from_coo(coo, device=device),
                               symmetric=symmetric)
