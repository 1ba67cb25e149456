"""SELL-C-sigma: the card form of a BELL operator, and its CUDA kernels.

A sliced ELL (Kreutzer et al., "A unified sparse matrix data format for
efficient general sparse matrix-vector multiplication on modern processors
with wide SIMD units", SIAM J. Sci. Comput. 2014) with slices of C = 32
rows, the rows sorted by length (longest first) within windows of sigma
rows.  :class:`~.bell.BellOperator` derives one from each tuple of BELL
levels it holds (:func:`sell_from_levels`): every stored nonzero of every
level and of its COO remainder, and nothing else.  The BELL container's
padding (fill 0.12 on tiled 1138bus: 167 MB against 38 MB of CSR) stays on
the host side of the design; the card streams this form instead.

Layout.  Slot row ``t`` computes output row ``row_idx[t]`` from its
``row_len[t]`` entries; slot rows ``32 s .. 32 s + 31`` form slice ``s``,
whose entries are stored column-major from ``slice_ptr[s]``: entry ``j`` of
slot row ``t`` is at ``slice_ptr[s] + 32 j + t % 32``, so the 32 lanes of
a warp read entry ``j`` of their rows as one coalesced load.  A slice is
as wide as its longest row; the shorter rows' tails are padding that
neither the kernels nor the plain versions multiply.  Every output row has
a slot row, so a row without entries is written too (with 0).

Products: :func:`sell_matvec` (``csrc/sell_spmv.cu``, which replaces the
TPU kernel ``_bell_kernel``) and :func:`sell_matmat` for an (n, K)
row-major block (``csrc/sell_spmm.cu``, which replaces ``_bell_mm_kernel``).
Each launches its kernel for CUDA tensors, runs its plain torch version
(:func:`sell_matvec_plain`, :func:`sell_matmat_plain`) for CPU tensors and
raises for anything else; there is no fallback.  Kernels and plain versions
add a row's products one by one in slot order, each product and sum
rounded on its own, and skip a column outside ``[0, len(x))``: the two agree
bit for bit, and column k of a block product equals the matvec on column k.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..utils.observe import span

__all__ = ["SELL", "SELL_LAUNCHES", "SELL_MM_LAUNCHES", "SLICE", "SIGMA",
           "sell_from_levels", "sell_bytes", "sell_matvec",
           "sell_matvec_plain", "sell_matmat", "sell_matmat_plain"]

SLICE = 32     # slot rows per slice: one warp of the SpMV kernel
# Rows are sorted by length within windows of SIGMA rows; chip_smoke.py
# times 256 and 4096 (PERF.md).
SIGMA = 4096

# Launches of the SELL SpMV and SpMM kernels in this process; each wrapper
# adds one per launch and nothing else touches them except a caller
# resetting them.
SELL_LAUNCHES = 0
SELL_MM_LAUNCHES = 0


class SELL(NamedTuple):
    """A SELL-C-sigma matrix (see the module docstring).

    ``vals``: (slots,) values, in the levels' dtype (f32, bf16 or f64).
    ``cols``: (slots,) int32 column of each slot.
    ``slice_ptr``: (nslices + 1,) int64 first slot of each slice.
    ``row_len``: (rows_out,) int32 entries of each slot row.
    ``row_idx``: (rows_out,) int32 output row of each slot row.
    ``rows_out``: rows of the product; ``n``: columns of the matrix.
    """
    vals: torch.Tensor
    cols: torch.Tensor
    slice_ptr: torch.Tensor
    row_len: torch.Tensor
    row_idx: torch.Tensor
    rows_out: int
    n: int


def _level_entries(b):
    """(row, col, value) of every slot of one BELL level that belongs to a
    block (padding included), then its COO remainder: the container's
    plain product's indexing, flattened in storage order."""
    from .bell import LANES, _slot_coords
    nsteps, GS, L = b.data.shape
    dev = b.data.device
    col, blk = _slot_coords(b)
    blk = blk.repeat_interleave(4, dim=1)            # (nsteps, GS)
    row = (((torch.arange(nsteps, device=dev)[:, None] * b.nblk + blk)
            * LANES)[:, :, None] + torch.arange(L, device=dev))
    slot = (blk < b.nblk)[:, :, None].expand(nsteps, GS, L)
    return (torch.cat([row[slot], b.sp_row.long()]),
            torch.cat([col[slot], b.sp_col.long()]),
            torch.cat([b.data[slot], b.sp_val.to(b.data.dtype)]))


def sell_from_levels(levels, rows_out, sigma=SIGMA) -> SELL:
    """The card form of ``A = sum of the levels' slot products and COO
    remainders``, first ``rows_out`` rows, on the levels' device.

    Every slot of every level is decoded to ``(row, col, value)`` as the
    container's plain product indexes it; the dummy block and every slot
    whose value is 0 (all padding, and explicit zeros of A) are dropped.
    A row keeps its entries in storage order: the levels in turn, each
    level's slots, then its remainder.  Torch ops only (sorts, cumsums,
    scatters), no loop over rows."""
    if sigma < 1 or sigma % SLICE:
        raise ValueError("sigma must be a positive multiple of %d, got %r"
                         % (SLICE, sigma))
    n = int(levels[0].shape[1])
    if max(rows_out, n) >= 2 ** 31:
        raise ValueError("the card form's int32 indices take fewer than "
                         "2**31 rows and columns")
    dtype = levels[0].data.dtype
    dev = levels[0].data.device
    parts = [_level_entries(b) for b in levels]
    rows = torch.cat([p[0] for p in parts])
    cols = torch.cat([p[1] for p in parts])
    vals = torch.cat([p[2].to(dtype) for p in parts])
    keep = (vals != 0) & (rows < rows_out)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = torch.sort(rows, stable=True).indices
    rows, cols, vals = rows[order], cols[order], vals[order]

    count = torch.bincount(rows, minlength=rows_out)
    rank = (torch.arange(rows.shape[0], device=dev)
            - (torch.cumsum(count, 0) - count)[rows])
    # slot row t computes row perm[t]: longest first within each window
    longest = int(count.max()) if rows_out else 0
    key = (torch.arange(rows_out, device=dev) // sigma) * (longest + 1) \
        + (longest - count)
    perm = torch.sort(key, stable=True).indices
    row_len = count[perm]
    slot_row = torch.empty_like(perm)
    slot_row[perm] = torch.arange(rows_out, device=dev)

    nslices = -(-rows_out // SLICE)
    width = torch.zeros(nslices * SLICE, dtype=torch.int64, device=dev)
    width[:rows_out] = row_len
    slice_ptr = torch.zeros(nslices + 1, dtype=torch.int64, device=dev)
    torch.cumsum(width.view(nslices, SLICE).amax(dim=1) * SLICE, 0,
                 out=slice_ptr[1:])
    t = slot_row[rows]
    pos = slice_ptr[t // SLICE] + SLICE * rank + t % SLICE
    total = int(slice_ptr[-1])
    card_vals = torch.zeros(total, dtype=dtype, device=dev)
    card_vals[pos] = vals
    card_cols = torch.zeros(total, dtype=torch.int32, device=dev)
    card_cols[pos] = cols.int()
    return SELL(card_vals, card_cols, slice_ptr, row_len.int(), perm.int(),
                int(rows_out), n)


def sell_bytes(card: SELL) -> int:
    """Bytes of the card form a product reads: slots (values and columns),
    slice pointers, row lengths and output rows (x and y apart)."""
    return (card.vals.numel() * (card.vals.element_size() + 4)
            + card.slice_ptr.numel() * 8 + card.rows_out * 8)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain(card: SELL, x):
    """``A x`` for x of shape (n,) or (n, K), a row's products added one by
    one in slot order.  Step j adds entry j of every slot row that has one,
    the slot rows taken longest first (one pass per entry depth, each over
    the rows still active), so the work is the entries', not the widest
    row's times the rows."""
    ct = torch.promote_types(card.vals.dtype, x.dtype)
    x = x.to(ct)
    dev = card.vals.device
    tail = tuple(x.shape[1:])
    length, order = torch.sort(card.row_len.long(), descending=True,
                               stable=True)
    first = card.slice_ptr[order // SLICE] + order % SLICE
    depth = int(length[0]) if card.rows_out else 0
    # the slot rows with more than j entries are the first active[j] of
    # ``order``
    active = (card.rows_out - torch.cumsum(
        torch.bincount(length, minlength=depth + 1), 0))[:depth].tolist()
    acc = torch.zeros((card.rows_out,) + tail, dtype=ct, device=dev)
    nx = x.shape[0]
    for j, na in enumerate(active):
        pos = first[:na] + SLICE * j
        c = card.cols[pos].long()
        inside = (c >= 0) & (c < nx)
        v = card.vals[pos].to(ct).reshape((na,) + (1,) * len(tail))
        xv = x[c.clamp(0, max(nx - 1, 0))]
        inside = inside.reshape(v.shape)
        acc[:na] = torch.where(inside, acc[:na] + v * xv, acc[:na])
    y = torch.empty_like(acc)
    y[card.row_idx[order].long()] = acc
    return y


def sell_matvec_plain(card: SELL, x):
    """Plain torch version of the SpMV kernel: ``A x`` (rows_out,)."""
    if x.ndim != 1:
        raise ValueError("sell_matvec_plain expects x (n,), got %s"
                         % (tuple(x.shape),))
    return _plain(card, x)


def sell_matmat_plain(card: SELL, X):
    """Plain torch version of the SpMM kernel: ``A X`` (rows_out, K);
    column k equals :func:`sell_matvec_plain` on column k bit for bit."""
    if X.ndim != 2:
        raise ValueError("sell_matmat_plain expects X (n, K), got %s"
                         % (tuple(X.shape),))
    return _plain(card, X)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

# (value dtype, compute dtype) -> C entry point; an f64 x or X with f32 or
# bf16 values computes in f64, as the plain versions' promotion does
_ENTRY = {
    (torch.float32, torch.float32): "sell_spmv_f32",
    (torch.bfloat16, torch.float32): "sell_spmv_bf16",
    (torch.float64, torch.float64): "sell_spmv_f64",
    (torch.float32, torch.float64): "sell_spmv_f32f64",
    (torch.bfloat16, torch.float64): "sell_spmv_bf16f64",
}
_MM_ENTRY = {key: name.replace("spmv", "spmm")
             for key, name in _ENTRY.items()}


@functools.lru_cache(maxsize=None)
def _entry(name):
    source = name[:9]                  # "sell_spmv" or "sell_spmm"
    fn = getattr(_build.load(source), name)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # the SpMM entry takes the block's column count after the rows
    kcols = [i64] if source == "sell_spmm" else []
    fn.argtypes = [p, p, p, p, p, p, i64, p, i64] + kcols + [p]
    fn.restype = ctypes.c_int
    return fn


def sell_matvec(card: SELL, x):
    """``y = A x`` (rows_out,) in the promoted dtype of the values and x:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    anything else raises."""
    if x.ndim != 1:
        raise ValueError("sell_matvec expects x (n,), got %s"
                         % (tuple(x.shape),))
    return _product(card, x, sell_matvec_plain)


def sell_matmat(card: SELL, X):
    """``Y = A X`` (rows_out, K) for an (n, K) block, streaming the card form
    once for every K up to 128: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; anything else raises."""
    if X.ndim != 2:
        raise ValueError("sell_matmat expects X (n, K), got %s"
                         % (tuple(X.shape),))
    return _product(card, X, sell_matmat_plain)


def _product(card, x, plain):
    dev = card.vals.device
    if dev.type == "cpu" and x.device.type == "cpu":
        return plain(card, x)
    if dev.type != "cuda" or x.device != dev:
        raise ValueError("sell_mat%s: the card form on %s and x on %s; the "
                         "kernel takes both on one CUDA device"
                         % ("vec" if x.ndim == 1 else "mat", dev, x.device))
    return _launch(card, x)


def _launch(card, x):
    """Launch the SpMV kernel for a 1-D x, the SpMM kernel for a block."""
    global SELL_LAUNCHES, SELL_MM_LAUNCHES
    block = x.ndim == 2
    with span("launch.sell_spmm" if block else "launch.sell_spmv"):
        ct = torch.promote_types(card.vals.dtype, x.dtype)
        name = (_MM_ENTRY if block else _ENTRY).get((card.vals.dtype, ct))
        if name is None:
            raise TypeError("the SELL kernels take f32 or bf16 values with an "
                            "f32 or f64 product and f64 values with an f64 "
                            "product, not %s values with %s x"
                            % (card.vals.dtype, x.dtype))
        x = x.to(ct).contiguous()           # the SpMM kernel reads X row-major
        arrays = (card.vals, card.cols, card.slice_ptr, card.row_len,
                  card.row_idx)
        if not all(a.is_contiguous() and a.device == x.device for a in arrays):
            raise ValueError("the SELL kernels need contiguous card arrays on "
                             "x's device")
        y = torch.empty((card.rows_out,) + tuple(x.shape[1:]), dtype=ct,
                        device=x.device)
        if y.numel() == 0:
            return y
        kcols = (int(x.shape[1]),) if block else ()
        fn = _entry(name)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*(a.data_ptr() for a in arrays), x.data_ptr(), x.shape[0],
                     y.data_ptr(), card.rows_out, *kcols, stream)
        if err != 0:
            raise RuntimeError("SELL %s kernel launch failed with CUDA "
                               "error %d" % ("SpMM" if block else "SpMV",
                                             err))
        if block:
            SELL_MM_LAUNCHES += 1
        else:
            SELL_LAUNCHES += 1
        return y
