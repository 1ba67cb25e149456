"""Sparse-matrix containers, their host builders, and plain torch products.

Counterpart of ``pykrylov_tpu/sparse/formats.py``, with the same four
formats and the same layouts:

  * :class:`COO`   — interchange format; matvec = gather + ``index_add_``.
  * :class:`CSR`   — storage/interchange; carries precomputed ``row_ids``
    so its matvec is the COO product without a search.
  * :class:`ELL`   — padded rows (n_rows x K): K gathers and a row sum.
  * :class:`DIA`   — diagonal storage for banded/stencil matrices: a sum of
    shifted products, no indices at all.

The builders run on the host: the ELL and DIA fills of float64 values in
the native C++ pipeline (:mod:`..native`) where its library is available,
else in NumPy, with the same arrays.  ``device=None`` keeps the fields as
NumPy arrays (for intermediate containers); any other value gives tensors
on that device.  Index tensors are int64.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..native import dia_fill_native, ell_fill_native
from ..utils.types import to_tensor

__all__ = ["COO", "CSR", "ELL", "DIA",
           "coo_from_arrays", "csr_from_coo", "ell_from_coo", "dia_from_coo",
           "coo_matvec", "coo_rmatvec", "csr_matvec", "csr_rmatvec",
           "ell_matvec", "ell_matvec_ff", "dia_matvec", "dia_rmatvec",
           "to_dense",
           "transpose_coo", "bandwidth_profile"]


class COO(NamedTuple):
    """Coordinate triples."""
    data: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    shape: Tuple[int, int]


class CSR(NamedTuple):
    """Compressed sparse rows + precomputed per-nnz row ids."""
    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    shape: Tuple[int, int]


class ELL(NamedTuple):
    """Padded-row format: ``data``/``cols`` are (n_rows, K); padding slots
    have ``data == 0`` and ``cols`` pointing at column 0."""
    data: torch.Tensor
    cols: torch.Tensor
    shape: Tuple[int, int]


class DIA(NamedTuple):
    """Diagonal format: ``offsets`` a tuple of ints, ``data`` is
    (ndiag, m) where ``data[d, i]`` multiplies ``x[i + offsets[d]]`` into
    ``y[i]`` (m = shape[0]; slots whose column falls outside the matrix
    are zero)."""
    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]


# ---------------------------------------------------------------------------
# Construction (host-side NumPy; NumPy arrays or tensors out)
# ---------------------------------------------------------------------------


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _values(a, device):
    return a if device is None else to_tensor(a, device=device)


def _index(a, device):
    if device is None:
        return np.asarray(a, dtype=np.int32)
    return to_tensor(np.asarray(a, dtype=np.int64), device=device)


def coo_from_arrays(vals, rows, cols, shape, dtype=None, sort=True,
                    device="cuda") -> COO:
    """Build a COO container from triples (host-side sort by row, then
    column)."""
    vals = _host(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    rows = np.asarray(_host(rows), dtype=np.int32)
    cols = np.asarray(_host(cols), dtype=np.int32)
    if sort:
        order = np.lexsort((cols, rows))
        vals, rows, cols = vals[order], rows[order], cols[order]
    return COO(_values(vals, device), _index(rows, device),
               _index(cols, device), (int(shape[0]), int(shape[1])))


def csr_from_coo(coo: COO, assume_sorted=False, device="cuda") -> CSR:
    m, n = coo.shape
    rows, cols, data = _host(coo.row), _host(coo.col), _host(coo.data)
    if not assume_sorted:  # coo_from_arrays(sort=True) already row-sorted
        order = np.lexsort((cols, rows))
        rows, cols, data = rows[order], cols[order], data[order]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return CSR(_values(data, device), _index(cols, device),
               _index(indptr, device), _index(rows, device), (m, n))


def ell_from_coo(coo: COO, pad_to: int = 1, assume_sorted=False,
                 device="cuda") -> ELL:
    """Build padded-row ELL.  ``pad_to`` rounds K up."""
    m, n = coo.shape
    rows, cols, data = _host(coo.row), _host(coo.col), _host(coo.data)
    counts = np.bincount(rows, minlength=m)
    K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    K = max(1, -(-K // pad_to) * pad_to)
    if not assume_sorted:
        order = np.lexsort((cols, rows))
        rows, cols, data = rows[order], cols[order], data[order]
    filled = ell_fill_native(rows, cols, data, m, K)
    if filled is not None:
        ed, ec = filled
    else:
        # slot k of row r = position of the entry within its row
        starts = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(len(rows), dtype=np.int64) - starts[rows]
        ed = np.zeros((m, K), dtype=data.dtype)
        ec = np.zeros((m, K), dtype=np.int32)
        ed[rows, slots] = data
        ec[rows, slots] = cols
    return ELL(_values(ed, device), _index(ec, device), (m, n))


def _bincount_into(index, weights, size):
    """Sum ``weights`` into ``size`` bins (duplicates accumulate)."""
    if np.iscomplexobj(weights):
        return (_bincount_into(index, weights.real, size)
                + 1j * _bincount_into(index, weights.imag, size))
    return np.bincount(index, weights=weights.astype(np.float64),
                       minlength=size)


def dia_from_coo(coo: COO, max_diags: int = 4096, device="cuda") -> DIA:
    """Build diagonal storage; raises if the matrix has too many distinct
    diagonals to be a sensible DIA candidate.  Duplicate entries
    accumulate, as in the COO, ELL and dense forms."""
    m, n = coo.shape
    rows = _host(coo.row).astype(np.int64)
    cols = _host(coo.col).astype(np.int64)
    data = _host(coo.data)
    offs = np.unique(cols - rows)
    if len(offs) > max_diags:
        raise ValueError("matrix has %d distinct diagonals (> %d): use ELL"
                         % (len(offs), max_diags))
    dd = dia_fill_native(rows, cols, data, m, offs)
    if dd is None:
        # one bincount over the flat slot index k*m + row (np.add.at is
        # far slower); like the native fill, it sums in f64 in entry order
        k = np.searchsorted(offs, cols - rows)
        dd = _bincount_into(k * m + rows, data, len(offs) * m)
        dd = dd.astype(data.dtype).reshape(len(offs), m)
    return DIA(_values(dd, device), tuple(int(o) for o in offs), (m, n))


def transpose_coo(coo: COO) -> COO:
    """The transposed triples, where the input lives (NumPy stays NumPy,
    tensors stay on their device)."""
    device = (coo.data.device if isinstance(coo.data, torch.Tensor)
              else None)
    return coo_from_arrays(_host(coo.data), _host(coo.col), _host(coo.row),
                           (coo.shape[1], coo.shape[0]), device=device)


def bandwidth_profile(coo: COO):
    """(n_distinct_diagonals, density inside DIA storage): format chooser."""
    rows = _host(coo.row).astype(np.int64)
    cols = _host(coo.col).astype(np.int64)
    offs = np.unique(cols - rows)
    dia_slots = len(offs) * coo.shape[0]
    return len(offs), len(rows) / max(dia_slots, 1)


# ---------------------------------------------------------------------------
# Products (plain torch on the containers' device)
# ---------------------------------------------------------------------------


def _scatter(n, index, values):
    y = torch.zeros(n, dtype=values.dtype, device=values.device)
    return y.index_add_(0, index, values)


def coo_matvec(a: COO, x):
    return _scatter(a.shape[0], a.row, a.data * x[a.col])


def coo_rmatvec(a: COO, x):
    return _scatter(a.shape[1], a.col, a.data * x[a.row])


def csr_matvec(a: CSR, x):
    return _scatter(a.shape[0], a.row_ids, a.data * x[a.indices])


def csr_rmatvec(a: CSR, x):
    return _scatter(a.shape[1], a.indices, a.data * x[a.row_ids])


def ell_matvec(a: ELL, x):
    return (a.data * x[a.cols]).sum(dim=1)


def ell_matvec_ff(a: ELL, xh, xl):
    """Compensated (double-f32) ELL matvec: ``A (xh + xl)`` as an (hi, lo)
    pair accurate to about twice the working precision.

    An error-free TwoProd per slot and a TwoSum cascade over the K row
    slots, unrolled (K is small).  The verified solvers' true residuals use
    it: the plain product cannot evaluate residuals below ~eps·|A||x|.
    """
    from ..utils.ff import two_prod, two_sum
    data = a.data.to(xh.dtype)
    gh = xh[a.cols]
    gl = xl[a.cols]
    p, pe = two_prod(data, gh)
    pe = pe + data * gl
    m, K = p.shape
    yh = p.new_zeros(m)
    yl = p.new_zeros(m)
    for k in range(K):
        s, e = two_sum(yh, p[:, k])
        yh, yl = two_sum(s, yl + e + pe[:, k])
    return yh, yl


def dia_matvec(a: DIA, x):
    """``y[i] = sum_d data[d, i] * x[i + off_d]`` as shifted slices, for x
    of shape (n,) or an (n, K) block (``Y[i, k]``, every column at once).

    Each diagonal adds its product into the rows whose column lies inside
    the matrix, in ascending diagonal order, each product and sum rounded
    on its own: the CUDA kernels' order and rounding.
    """
    m, n = a.shape
    ct = torch.promote_types(a.data.dtype, x.dtype)
    x = x.to(ct)
    tail = tuple(x.shape[1:])            # () or (K,)
    y = torch.zeros((m,) + tail, dtype=ct, device=x.device)
    for d, off in enumerate(a.offsets):
        lo, hi = max(0, -off), min(m, n - off)
        if lo < hi:
            w = a.data[d, lo:hi].to(ct).reshape((hi - lo,) + (1,) * len(tail))
            y[lo:hi].add_(w * x[lo + off:hi + off])
    return y


def dia_rmatvec(a: DIA, x):
    """``A^T x``: the value ``data[d, i]`` at (i, i+off) adds
    ``data[d, i] * x[i]`` into ``y[i + off]``."""
    m, n = a.shape
    ct = torch.promote_types(a.data.dtype, x.dtype)
    x = x.to(ct)
    y = torch.zeros(n, dtype=ct, device=x.device)
    for d, off in enumerate(a.offsets):
        lo, hi = max(0, -off), min(m, n - off)
        if lo < hi:
            y[lo + off:hi + off].add_(a.data[d, lo:hi].to(ct) * x[lo:hi])
    return y


def to_dense(a):
    if isinstance(a, COO):
        d = torch.zeros(a.shape, dtype=a.data.dtype, device=a.data.device)
        return d.index_put_((a.row, a.col), a.data, accumulate=True)
    if isinstance(a, CSR):
        d = torch.zeros(a.shape, dtype=a.data.dtype, device=a.data.device)
        return d.index_put_((a.row_ids, a.indices), a.data, accumulate=True)
    if isinstance(a, ELL):
        m, n = a.shape
        d = torch.zeros((m, n), dtype=a.data.dtype, device=a.data.device)
        rows = torch.arange(m, device=a.cols.device)[:, None].expand(
            a.cols.shape)
        return d.index_put_((rows, a.cols), a.data, accumulate=True)
    if isinstance(a, DIA):
        m, n = a.shape
        d = torch.zeros((m, n), dtype=a.data.dtype, device=a.data.device)
        for k, off in enumerate(a.offsets):
            lo, hi = max(0, -off), min(m, n - off)
            if lo < hi:
                i = torch.arange(lo, hi, device=a.data.device)
                d[i, i + off] += a.data[k, lo:hi]
        return d
    raise TypeError(type(a))
