"""A one-hot select on the tensor cores: ``oh @ w`` in exact transports.

Counterpart of ``tools/probes/probe_int8_mxu.py`` (``k_int8`` and
``k_bf16``), which asked whether the TPU's matrix unit can move f32 values
exactly through a one-hot product.  :func:`onehot_select` runs
``csrc/probe_onehot_mma.cu`` (``mma.sync`` on u8 or bf16 operands, the
one-hot A fragments built in registers from each row's index) for CUDA
tensors and :func:`onehot_select_plain` for CPU tensors; anything else
raises.  For ``oh`` (GS, NB) bool or uint8 and ``w`` (NB, L) f32, with
``base = argmax(oh, 1)`` (``oh`` itself wherever a row holds one 1, as
the probe's rows do) and ``E`` the one-hot of ``base``:

==========  ===============================================================
``int8``    ``w[base]``, bit for bit for every f32 pattern: four byte
            planes of w's bits, each product summed in int32
``bf16x3``  the probe's ``k_bf16``: ``r = w``; three times ``p = bf16(r)``,
            ``r = r - f32(p)``, ``t = f32(E @ p)`` (the exact product);
            the result ``(t1 + t2) + t3`` in f32
==========  ===============================================================

So the modes differ.  ``bf16x3`` gives every finite normal value back, but
-0 comes back +0, and a column of w that holds an inf or a NaN is NaN in
every row (0 * inf is NaN; an inf's second piece is inf - inf).  The
module's helpers (:func:`bf16_pieces`, :func:`tf32_pieces`,
:func:`onehot_rows`) state the pieces and the exact one-hot product that
``probes.bell_mma`` shares.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["MODES", "ONEHOT_LAUNCHES", "bf16_pieces", "onehot_rows",
           "onehot_select", "onehot_select_bytes", "onehot_select_plain",
           "tf32_pieces"]

# mode -> the kernel's template index
MODES = {"int8": 0, "bf16x3": 1}
# what a block of the kernel covers: rows of oh, columns of w, and the
# k-chunk of NB (the u8 product's depth); NB_MAX: the NB whose 32 columns
# of w a block's shared memory holds
TILE_ROWS, TILE_COLS, TILE_K, NB_MAX = 64, 32, 32, 1536

# Launches of the kernel in this process (see probes.COUNTERS)
ONEHOT_LAUNCHES = 0


def bf16_pieces(v, n=3):
    """The ``n`` bf16 pieces of f32 ``v`` (round to nearest even), as f32:
    ``p_i = bf16(r)``, ``r = r - p_i`` from ``r = v``."""
    out, r = [], v
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _tf32(v):
    """f32 ``v`` rounded to tf32 as ``cvt.rna.tf32.f32`` does: the 10
    mantissa bits kept, to nearest with ties away from zero (the
    magnitude's bits plus half of the dropped place, cut); NaN stays NaN."""
    bits = v.view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(v), v, r)


def tf32_pieces(v, n=3):
    """The ``n`` tf32 pieces of f32 ``v``, as f32 with the low 13 bits 0."""
    out, r = [], v
    for _ in range(n):
        p = _tf32(r)
        out.append(p)
        r = r - p
    return out


def onehot_rows(p, base):
    """``f32(E @ p)`` for f32 ``p`` (K, C) and the one-hot ``E`` (n, K) of
    ``base`` (n,) (a row whose index lies outside [0, K) is a zero row),
    summed exactly: ``p[base]``, except that an entry is NaN where its
    column of p holds an inf or NaN in a row that ``E`` multiplies by 0."""
    k = p.shape[0]
    inside = (base >= 0) & (base < k)
    b = base.clamp(0, max(k - 1, 0)).long()
    bad = ~torch.isfinite(p)
    sel = torch.where(inside[:, None], p[b], torch.zeros((), dtype=p.dtype,
                                                         device=p.device))
    own = bad[b] & inside[:, None]
    other = bad.sum(0)[None, :] - own.long() > 0
    return torch.where(other, torch.full((), float("nan"), dtype=p.dtype,
                                         device=p.device), sel)


def _check(oh, w, mode):
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r"
                         % (sorted(MODES), mode))
    if oh.ndim != 2 or w.ndim != 2 or oh.shape[1] != w.shape[0]:
        raise ValueError("onehot_select expects oh (GS, NB) and w (NB, L), "
                         "got %s and %s"
                         % (tuple(oh.shape), tuple(w.shape)))
    if oh.dtype not in (torch.bool, torch.uint8):
        raise TypeError("oh must be bool or uint8, not %s" % oh.dtype)
    if w.dtype != torch.float32:
        raise TypeError("w must be f32, not %s" % w.dtype)


def onehot_select_plain(oh, w, mode="int8"):
    """Plain torch version of the mode (the module docstring's table)."""
    _check(oh, w, mode)
    base = oh.to(torch.uint8).argmax(1)
    if mode == "int8":
        return w[base]
    t = [onehot_rows(p, base) for p in bf16_pieces(w)]
    return (t[0] + t[1]) + t[2]


def onehot_select_bytes(gs, nb, l):
    """Bytes the select must move at best: oh once (a byte an entry), w
    once, the output once."""
    return gs * nb + 4 * nb * l + 4 * gs * l


def onehot_select(oh, w, mode="int8"):
    """The mode's product (module docstring): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; anything else raises.
    Both take GS a multiple of 64, NB of 32 (at most 1536) and L of 32,
    the kernel's tiling, and contiguous tensors."""
    _check(oh, w, mode)
    gs, nb = oh.shape
    l = w.shape[1]
    if (gs < TILE_ROWS or gs % TILE_ROWS or nb < TILE_K or nb % TILE_K
            or nb > NB_MAX or l < TILE_COLS or l % TILE_COLS):
        raise ValueError("onehot_select tiles GS by %d, NB by %d (at most "
                         "%d) and L by %d; got (%d, %d, %d)"
                         % (TILE_ROWS, TILE_K, NB_MAX, TILE_COLS, gs, nb, l))
    if not (oh.is_contiguous() and w.is_contiguous()):
        raise ValueError("onehot_select needs contiguous oh and w")
    if oh.device.type == "cpu" and w.device.type == "cpu":
        return onehot_select_plain(oh, w, mode)
    if oh.device.type != "cuda" or w.device != oh.device:
        raise ValueError("onehot_select: oh on %s and w on %s; the kernel "
                         "takes both on one CUDA device"
                         % (oh.device, w.device))
    return _launch(oh, w, mode)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("probe_onehot_mma").probe_onehot_select
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(oh, w, mode):
    global ONEHOT_LAUNCHES
    gs, nb = oh.shape
    out = torch.empty(gs, w.shape[1], dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        # a bool tensor holds one byte 0 or 1 an entry: the kernel reads
        # its bytes as uint8
        err = _entry()(oh.data_ptr(), w.data_ptr(), out.data_ptr(), gs, nb,
                       w.shape[1], MODES[mode], stream)
    if err != 0:
        raise RuntimeError("one-hot select kernel (%s) launch failed with "
                           "CUDA error %d" % (mode, err))
    ONEHOT_LAUNCHES += 1
    return out
