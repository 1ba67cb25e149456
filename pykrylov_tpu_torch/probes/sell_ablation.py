"""The SELL SpMV whole and with one part removed at a time.

Counterpart of the TPU probes that take the BELL kernel apart
(``tools/probes/probe_bell_ablation.py``, ``probe_bell_ablation_w1.py``,
``probe_ablate_r3.py``) and pipeline it (``probe_skew.py``).  On the card
the same product is :func:`..sparse.sell.sell_matvec` over the SELL card
form; :func:`sell_matvec_ablated` runs ``csrc/probe_sell_ablation.cu``, one
template over the variant built from that kernel's walk, for CUDA tensors
and :func:`sell_matvec_ablated_plain` for CPU tensors; anything else
raises.  Unlike the TPU probes' variants, which returned wrong values by
design, each variant is a defined function the kernel equals bit for bit.
For slot row t of length L_t, entries j < L_t with value v_j and column
c_j, output row ``row_idx[t]`` and x of n_x entries ([.]: only columns in
[0, n_x); f: int32 to float, rounded to nearest):

====================  =====================================================
``full``              ``y[row_idx[t]] = sum_j [v_j x[c_j]]``: ``sell_matvec``
``skew``              the same; the kernel issues chunk j + 1's x gathers
                      and chunk j + 2's value and column loads before chunk
                      j's products (``probe_skew.py``)
``no-gather``         ``y[row_idx[t]] = sum_j (v_j x[t % n_x] + f(c_j >> 30))``
``no-columns``        ``y[row_idx[t]] = sum_j v_j x[t % n_x]``
``no-values``         ``y[row_idx[t]] = sum_j [x[c_j]]``
``streams-only``      ``y[row_idx[t]] = sum_j (v_j + f(c_j))``
``no-scatter``        ``y[t] = sum_j [v_j x[c_j]]``
====================  =====================================================

Each sum runs in ascending j from 0, every product and sum rounded on its
own.  A variant that removes one stream keeps reading every other one and
folds it into y (``c >> 30`` is 0 for every column below 2**30), so the
compiler cannot drop the work it keeps.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..sparse import sell as S

__all__ = ["SELL_ABLATION_LAUNCHES", "VARIANTS", "ablation_bytes",
           "sell_matvec_ablated", "sell_matvec_ablated_plain"]

# variant -> the kernel's template index
VARIANTS = {"full": 0, "skew": 1, "no-gather": 2, "no-columns": 3,
            "no-values": 4, "streams-only": 5, "no-scatter": 6}

# Launches of the kernel in this process (see probes.COUNTERS)
SELL_ABLATION_LAUNCHES = 0


def ablation_bytes(card: S.SELL, n_x, variant):
    """Bytes the variant must move at best: the streams it reads (4-byte
    values and columns of every entry), the row lengths, output rows
    (unless ``no-scatter``) and slice pointers, x once (the columns the
    rows gather, or the own-index reads) and y once."""
    _variant(variant)
    entries = int(card.row_len.sum())
    rows = card.rows_out
    streams = {"no-columns": 4, "no-values": 4}.get(variant, 8)
    index = 4 if variant == "no-scatter" else 8
    if variant == "streams-only":
        xb = 0
    elif variant in ("no-gather", "no-columns"):
        xb = min(rows, n_x) * 4
    else:
        xb = n_x * 4
    return (entries * streams + rows * index + card.slice_ptr.numel() * 8
            + xb + rows * 4)


def _variant(variant):
    if variant not in VARIANTS:
        raise ValueError("variant must be one of %s, got %r"
                         % (sorted(VARIANTS), variant))


def sell_matvec_ablated_plain(card: S.SELL, x, variant="full"):
    """Plain torch version of the variant (the module docstring's table):
    ``full`` and ``skew`` are :func:`..sparse.sell.sell_matvec_plain`; the
    others walk the slot rows as it does, entry depth by entry depth."""
    _variant(variant)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("the ablated product expects x (n,), n > 0, got %s"
                         % (tuple(x.shape),))
    if variant in ("full", "skew"):
        return S.sell_matvec_plain(card, x)
    ct = torch.promote_types(card.vals.dtype, x.dtype)
    x = x.to(ct)
    dev = card.vals.device
    length, order = torch.sort(card.row_len.long(), descending=True,
                               stable=True)
    first = card.slice_ptr[order // S.SLICE] + order % S.SLICE
    depth = int(length[0]) if card.rows_out else 0
    # the slot rows with more than j entries are the first active[j] of
    # ``order``
    active = (card.rows_out - torch.cumsum(
        torch.bincount(length, minlength=depth + 1), 0))[:depth].tolist()
    nx = x.shape[0]
    own = x[order % nx]                 # x at each slot row's own index
    acc = torch.zeros(card.rows_out, dtype=ct, device=dev)
    for j, na in enumerate(active):
        pos = first[:na] + S.SLICE * j
        c = card.cols[pos]
        if variant == "no-gather":
            v = card.vals[pos].to(ct)
            acc[:na] = acc[:na] + (v * own[:na] + (c >> 30).to(ct))
        elif variant == "no-columns":
            acc[:na] = acc[:na] + card.vals[pos].to(ct) * own[:na]
        elif variant == "streams-only":
            acc[:na] = acc[:na] + (card.vals[pos].to(ct) + c.to(ct))
        else:
            c = c.long()
            inside = (c >= 0) & (c < nx)
            xv = x[c.clamp(0, nx - 1)]
            term = xv if variant == "no-values" else \
                card.vals[pos].to(ct) * xv
            acc[:na] = torch.where(inside, acc[:na] + term, acc[:na])
    y = torch.empty_like(acc)
    rows = order if variant == "no-scatter" else card.row_idx[order].long()
    y[rows] = acc
    return y


def sell_matvec_ablated(card: S.SELL, x, variant="full"):
    """The variant's product (module docstring): the CUDA kernel for CUDA
    tensors (f32 values, f32 x), the plain version for CPU tensors;
    anything else raises."""
    _variant(variant)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("the ablated product expects x (n,), n > 0, got %s"
                         % (tuple(x.shape),))
    dev = card.vals.device
    if dev.type == "cpu" and x.device.type == "cpu":
        return sell_matvec_ablated_plain(card, x, variant)
    if dev.type != "cuda" or x.device != dev:
        raise ValueError("sell_matvec_ablated: the card form on %s and x on "
                         "%s; the kernel takes both on one CUDA device"
                         % (dev, x.device))
    return _launch(card, x, variant)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("probe_sell_ablation").probe_sell_ablation_f32
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, p, p, p, i64, p, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(card, x, variant):
    global SELL_ABLATION_LAUNCHES
    if card.vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("the ablation kernel takes f32 values and an f32 x, "
                        "not %s values with %s x"
                        % (card.vals.dtype, x.dtype))
    arrays = (card.vals, card.cols, card.slice_ptr, card.row_len,
              card.row_idx)
    if not (x.is_contiguous() and all(a.is_contiguous() for a in arrays)):
        raise ValueError("the ablation kernel needs contiguous card arrays "
                         "and x")
    y = torch.empty(card.rows_out, dtype=torch.float32, device=x.device)
    if card.rows_out == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(*(a.data_ptr() for a in arrays), x.data_ptr(),
                       x.shape[0], y.data_ptr(), card.rows_out,
                       VARIANTS[variant], stream)
    if err != 0:
        raise RuntimeError("SELL ablation kernel (%s) launch failed with CUDA "
                           "error %d" % (variant, err))
    SELL_ABLATION_LAUNCHES += 1
    return y
