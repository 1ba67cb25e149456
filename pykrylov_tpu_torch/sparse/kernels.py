"""The CUDA DIA SpMV kernel's surface: wrapper, plain version, operator.

Counterpart of ``pykrylov_tpu/sparse/kernels.py``.  The kernel itself is
``csrc/dia_spmv.cu`` (it replaces ``_dia_kernel_ring`` and ``_dia_kernel``);
``_build`` compiles it at first use.  It takes the unpadded ``(ndiag, m)``
container of :mod:`.formats`, so the TPU kernel's block padding, block
choice and packing (``choose_block``, ``ensure_dia_padded``, ``pack_dia``,
the ``_halo_rows*`` helpers) have no counterpart here.

:func:`dia_matvec` launches the kernel for CUDA tensors and runs the plain
torch version, :func:`dia_matvec_plain`, for CPU tensors; anything else
raises.  There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import formats as F
from .. import _build

__all__ = ["DIA_LAUNCHES", "MAX_DIAGS", "dia_matvec", "dia_matvec_plain",
           "dia_transpose", "cuda_dia_operator"]

# Launches of the DIA kernel in this process; the wrapper adds one per
# launch and nothing else touches it except a caller resetting it.
DIA_LAUNCHES = 0

MAX_DIAGS = 64  # size of the kernel's by-value offsets argument

# (storage dtype, compute dtype) -> C entry point
_ENTRY = {
    (torch.float32, torch.float32): "dia_spmv_f32",
    (torch.bfloat16, torch.float32): "dia_spmv_bf16",
    (torch.float64, torch.float64): "dia_spmv_f64",
}


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("dia_spmv"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _offsets_arg(offsets):
    return (ctypes.c_int64 * max(1, len(offsets)))(*offsets)


def _check(data, offsets, x):
    if data.ndim != 2 or x.ndim != 1:
        raise ValueError("dia_matvec expects data (ndiag, m) and x (n,), "
                         "got %s and %s"
                         % (tuple(data.shape), tuple(x.shape)))
    if len(offsets) != data.shape[0]:
        raise ValueError("%d offsets for %d diagonals"
                         % (len(offsets), data.shape[0]))
    if len(offsets) > MAX_DIAGS:
        raise ValueError("%d diagonals exceed the kernel's %d"
                         % (len(offsets), MAX_DIAGS))


def dia_matvec_plain(data, offsets, x):
    """Plain torch version of the kernel: shifted-slice products summed in
    ascending diagonal order (:func:`.formats.dia_matvec`)."""
    _check(data, offsets, x)
    return F.dia_matvec(F.DIA(data, tuple(offsets),
                              (data.shape[1], x.shape[0])), x)


def dia_matvec(data, offsets, x):
    """``y[i] = sum_k data[k, i] * x[i + offsets[k]]`` in the promoted
    dtype of data and x: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(data, offsets, x)
    if data.device.type == "cpu" and x.device.type == "cpu":
        return dia_matvec_plain(data, offsets, x)
    if data.device.type != "cuda" or x.device != data.device:
        raise ValueError("dia_matvec: data on %s and x on %s; the kernel "
                         "takes both on one CUDA device"
                         % (data.device, x.device))
    return _launch(data, offsets, x)


def _launch(data, offsets, x):
    global DIA_LAUNCHES
    ct = torch.promote_types(data.dtype, x.dtype)
    name = _ENTRY.get((data.dtype, ct))
    if name is None:
        raise TypeError("the DIA kernel takes f32, bf16 or f64 data with "
                        "an f32 or f64 product, not %s data with %s x"
                        % (data.dtype, x.dtype))
    x = x.to(ct)
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("the DIA kernel needs contiguous data and x")
    ndiag, m = data.shape
    y = torch.empty(m, dtype=ct, device=x.device)
    if m == 0:
        return y
    fn = _entry(name)
    offs = _offsets_arg(tuple(int(o) for o in offsets))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p), ndiag,
                 x.data_ptr(), y.data_ptr(), m, x.shape[0], stream)
    if err != 0:
        raise RuntimeError("DIA kernel launch failed with CUDA error %d"
                           % err)
    DIA_LAUNCHES += 1
    return y


def dia_transpose(a: F.DIA) -> F.DIA:
    """Host-side transpose of a square DIA container.

    Entry (i, i+off) of A is entry (j, j-off) of A^T at j = i+off, so
    diagonal ``off`` becomes diagonal ``-off`` with its data shifted by
    ``off``: ``dataT[-off][j] = data[off][j-off]``.  The work is done on a
    host copy and the result returns to the container's device.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("dia_transpose expects a square container")
    data = a.data.cpu()
    offsets_t = tuple(sorted(-o for o in a.offsets))
    out = torch.zeros((len(offsets_t), m), dtype=data.dtype)
    pos = {o: k for k, o in enumerate(offsets_t)}
    for k, off in enumerate(a.offsets):
        row = out[pos[-off]]
        if off >= 0:
            row[off:] = data[k, :m - off]
        else:
            row[:m + off] = data[k, -off:]
    return F.DIA(out.to(a.data.device), offsets_t, (m, n))


def cuda_dia_operator(dia: F.DIA, symmetric=False):
    """A :class:`~.linop.SparseOperator` (``fmt="cuda-dia"``) whose
    products are :func:`dia_matvec` over the container's tensors: the CUDA
    kernel when they lie on a CUDA device.  An unsymmetric operator keeps
    the :func:`dia_transpose` for ``A.T``.  Counterpart of
    ``pallas_dia_operator``; no padding."""
    from .linop import SparseOperator

    bwd = None if symmetric else dia_transpose(dia)
    return SparseOperator(dia, bwd, symmetric=symmetric, fmt="cuda-dia")
