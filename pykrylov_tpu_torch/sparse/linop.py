"""Operators backed by sparse containers, with automatic format choice.

Counterpart of ``pykrylov_tpu/sparse/linop.py``.  The solver-facing object
is a :class:`~pykrylov_tpu_torch.ops.LinearOperator` whose products run
over a :mod:`.formats` container on the container's device.

Format policy (the JAX package's, with its thresholds and options, so both
packages pick the same format): matrices whose nonzeros lie on at most
``max_diags`` (default 64) distinct diagonals with at least
``dia_density_threshold`` (default 0.25) fill use DIA, other sparsity ELL.
On a CUDA device, square DIA-eligible matrices of at least 65,536 rows get
the CUDA DIA kernels (``fmt="cuda-dia"``, up to their 4096 diagonals), and
general matrices of at least 4,096 rows the CUDA BELL kernel when their
packing qualifies (:func:`_try_bell`), as the JAX package gives them its
Pallas kernels on a TPU.  Entry points build on the card unless
``device`` names another.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.base import DiagonalOperator, LinearOperator
from . import bell as B
from . import formats as F
from . import kernels as K

__all__ = ["SparseOperator", "sparse_operator", "operator_from_coo",
           "jacobi_preconditioner", "diag_of_coo", "auto_format",
           "cuda_dia_sparse_operator"]

def _kernel_dia_matvec(a, x):
    return K.dia_matvec(a.data, a.offsets, x)


def _kernel_dia_matmat(a, X):
    return K.dia_matmat(a.data, a.offsets, X)


# compute format -> product over one container
_PRODUCTS = {"coo": F.coo_matvec, "csr": F.csr_matvec, "ell": F.ell_matvec,
             "dia": F.dia_matvec, "cuda-dia": _kernel_dia_matvec}
# compute format -> native block product over one container; the plain
# formats apply an (n, K) block column by column, as the JAX package vmaps
# them
_BLOCK_PRODUCTS = {"cuda-dia": _kernel_dia_matmat}
_FORMAT_OF = {F.COO: "coo", F.CSR: "csr", F.ELL: "ell", F.DIA: "dia"}


class SparseOperator(LinearOperator):
    """LinearOperator over a sparse container.

    ``fwd`` holds A and ``bwd`` A^T (None for a symmetric matrix, whose
    transpose is A); ``container`` and ``container_transp`` are the
    containers of A's and A^T's products.  ``fmt`` names the compute format: the container's
    own (``"coo"``, ``"csr"``, ``"ell"``, ``"dia"``: plain torch) by
    default, or ``"cuda-dia"`` for a DIA container whose products go
    through :func:`.kernels.dia_matvec` and, on (n, K) blocks,
    :func:`.kernels.dia_matmat`.
    """

    def __init__(self, fwd, bwd=None, symmetric=False, fmt=None, **kwargs):
        if fmt is None:
            fmt = _FORMAT_OF[type(fwd)]
        if fmt == "cuda-dia" and not isinstance(fwd, F.DIA):
            raise TypeError("fmt='cuda-dia' needs a DIA container")
        product = _PRODUCTS[fmt]
        block = _BLOCK_PRODUCTS.get(fmt)
        m, n = fwd.shape
        transposed = fwd if symmetric else bwd
        is_complex = fwd.data.dtype.is_complex
        super().__init__(
            n, m, matvec=lambda x: product(fwd, x),
            matvec_transp=(lambda x: product(transposed, x))
            if transposed is not None else None,
            symmetric=symmetric, hermitian=symmetric and not is_complex,
            dtype=fwd.data.dtype, device=fwd.data.device,
            matmat=(lambda X: block(fwd, X)) if block else None,
            matmat_transp=(lambda X: block(transposed, X))
            if block and transposed is not None else None, **kwargs)
        self.container = fwd
        self.container_transp = transposed
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


# The auto policy's thresholds (the JAX package's defaults of
# operator_from_coo's max_diags and dia_density_threshold).  The kernels
# take up to K.MAX_DIAGS diagonals, as many as dia_from_coo builds.
DIA_MAX_DIAGS = 64
DIA_MIN_DENSITY = 0.25
KERNEL_MIN_ROWS = 1 << 16
BELL_MIN_ROWS = 1 << 12
# _try_bell's acceptance rules (the JAX package's defaults): a storage
# budget in the cost model's slot units with a staging width cap, or a
# cost-based escape against the JAX package's measured ELL cost
BELL_MAX_SLOTS_PER_NNZ = 8.0
BELL_MAX_NB = 256
BELL_MAX_PAD_BYTES = 1 << 30
BELL_MIN_SPEEDUP_VS_ELL = 4.0
ELL_NS_PER_NNZ = 24.0


def auto_format(ndiag, density, shape, device_type, max_diags=DIA_MAX_DIAGS,
                dia_density_threshold=DIA_MIN_DENSITY):
    """The ``fmt="auto"`` choice: ``"cuda-dia"``, ``"dia"`` or ``"ell"``."""
    if ndiag > max_diags or density < dia_density_threshold:
        return "ell"
    if (shape[0] == shape[1] and shape[0] >= KERNEL_MIN_ROWS
            and device_type == "cuda"):
        return "cuda-dia"
    return "dia"


def operator_from_coo(vals, rows, cols, shape, symmetric=False,
                      fmt="auto", dtype=None,
                      dia_density_threshold=DIA_MIN_DENSITY,
                      max_diags=DIA_MAX_DIAGS, device="cuda"):
    """Build an operator on ``device`` from COO triples, choosing a
    compute format.

    ``fmt`` is one of ``auto | dia | cuda-dia | bell | bell-rcm | ell |
    csr | coo``.  ``auto`` picks DIA when the nonzeros lie on at most
    ``max_diags`` distinct diagonals with at least
    ``dia_density_threshold`` fill (:func:`auto_format`), then, for a
    general matrix of at least ``BELL_MIN_ROWS`` rows on a CUDA device,
    tries the BELL kernel (:func:`_try_bell`).  DIA storage holds at most
    4096 diagonals (``dia_from_coo`` raises past that, as in the JAX
    package).  ``bell`` and ``bell-rcm``
    (RCM-reordered first) give a :class:`~.bell.BellOperator` whatever
    the packing.  The containers are built on the host (the native host
    pipeline where its library is available, else NumPy) and moved to
    ``device`` once.
    """
    coo = F.coo_from_arrays(vals, rows, cols, shape, dtype=dtype,
                            device=None)
    if fmt == "auto":
        ndiag, density = F.bandwidth_profile(coo)
        device_type = torch.device(device).type
        fmt = auto_format(ndiag, density, coo.shape, device_type,
                          max_diags, dia_density_threshold)
        if (fmt == "ell" and coo.shape[0] >= BELL_MIN_ROWS
                and device_type == "cuda"):
            op = _try_bell(coo, symmetric, device)
            if op is not None:
                return op
    if fmt in ("bell", "bell-rcm"):
        return B.bell_operator(coo, symmetric=symmetric,
                               reorder=(fmt == "bell-rcm"), device=device)
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
                    device="cuda"):
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


def jacobi_preconditioner(source, floor=0.0, device="cuda"):
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


def _try_bell(coo, symmetric, device="cuda"):
    """A BELL operator on ``device`` if the packing qualifies, else None.

    The JAX package's acceptance rules, kept as they are so both packages
    accept the same matrices with the same layout (their constants were
    measured for the TPU kernel; re-tuning them for the H100 is ROADMAP
    work): no COO remainder; a per-level feasibility cap on the step size
    (GS); and either a storage budget of ``BELL_MAX_SLOTS_PER_NNZ`` (in
    the cost model's units) with a staging width of at most
    ``BELL_MAX_NB`` bands, or the cost-based escape (predicted kernel time
    ``BELL_MIN_SPEEDUP_VS_ELL`` times below the ELL estimate, packed
    storage under ``BELL_MAX_PAD_BYTES``).  Tries a heavy-row split first, then the raw
    ordering, then RCM (square only).  Candidate packings are planned on
    the host; only the accepted one goes to ``device``.
    """
    def _ok(lv):
        if sum(b.nnz_spill for b in lv) != 0:
            return False
        for b in lv:
            GS = int(b.data.shape[1])
            ring = (b.nb * 128 * 4 + GS * 128 * b.data.dtype.itemsize
                    + int(np.prod(b.lanes.shape[1:]))
                    * b.lanes.dtype.itemsize)
            if 10 * GS * 128 * 4 + 2 * ring > (15 << 20):
                return False
        nb = max((B.SEG_BANDS if b.seg is not None else b.nb) for b in lv)
        nnz = max(1, sum(b.nnz for b in lv))
        cost_ps = sum(int(np.prod(b.data.shape)) * B._SLOT_COST_PS[b.window]
                      for b in lv)
        if (nb <= BELL_MAX_NB
                and cost_ps / (B._SLOT_COST_PS[2] * nnz)
                <= BELL_MAX_SLOTS_PER_NNZ):
            return True
        cost_adj = sum(int(np.prod(b.data.shape)) * B._slot_cost_ps(b)
                       for b in lv)
        storage_bytes = sum(
            b.data.size * b.data.dtype.itemsize
            + b.lanes.size * b.lanes.dtype.itemsize for b in lv)
        return (storage_bytes <= BELL_MAX_PAD_BYTES
                and cost_adj * 1e-12 * BELL_MIN_SPEEDUP_VS_ELL
                <= nnz * ELL_NS_PER_NNZ * 1e-9)

    def _plan(c):
        try:
            return B._pack_levels(c, B.NB_MAX, B._SPILL_BYTES, 2,
                                  device=None, window="auto")
        except B.SpanError:
            return None

    split = B._row_split_plan(coo)
    if split is not None:
        coo_k, heavy, M0 = split
        fwd = _plan(coo_k)
        if fwd is not None and _ok(fwd):
            bwd = None
            if not symmetric:
                try:
                    bwd = B._split_transpose_levels(
                        coo_k, M0, B.NB_MAX, B._SPILL_BYTES, 2, "auto",
                        device=None)
                except B.SpanError:
                    bwd = None
            if symmetric or (bwd is not None and _ok(bwd[0])
                             and _ok(bwd[1])):
                return B.bell_operator(coo, symmetric=symmetric,
                                       device=device,
                                       _prepacked=(fwd, bwd),
                                       _split=(None, heavy, M0))

    for reorder in (False, True):
        c = coo
        if reorder:
            if coo.shape[0] != coo.shape[1]:
                break
            c, _ = B.reorder_rcm(coo)
        fwd = _plan(c)
        if fwd is None or not _ok(fwd):
            continue
        bwd = None if symmetric else _plan(F.transpose_coo(c))
        if symmetric or (bwd is not None and _ok(bwd)):
            return B.bell_operator(coo, symmetric=symmetric,
                                   reorder=reorder, device=device,
                                   _prepacked=None if reorder
                                   else (fwd, bwd))
        if not reorder:
            # directions are judged independently: rows that pack well
            # get the kernel forward, and A^T (which most solvers never
            # apply) the ELL path
            return _bell_fwd_ell_bwd(coo, fwd, symmetric, device)
    return None


def _bell_fwd_ell_bwd(coo, fwd_levels, symmetric, device):
    ell_t = F.ell_from_coo(F.transpose_coo(coo), pad_to=4, device=device)
    return B.BellOperator(coo.shape,
                          B._levels_on(fwd_levels, device),
                          symmetric=symmetric, bwd_ell=ell_t)
