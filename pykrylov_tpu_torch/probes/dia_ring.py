"""The DIA SpMV with its diagonals fed through a TMA ring in shared memory.

Counterpart of ``tools/probes/probe_dia_manual_dma.py`` (its
``_dia_kernel_mdma``, which streams a TPU block's diagonals one at a time
through a 2-slot DMA ring).  :func:`dia_matvec_ring` computes
:func:`..sparse.kernels.dia_matvec_plain` bit for bit: it launches
``csrc/probe_dia_ring.cu`` for CUDA tensors and runs the plain version for
CPU tensors; anything else raises.  It takes the unpadded container that
the other DIA kernels take (f32 data with an f32 x; no ``pack_dia``, no
``choose_block``).

The kernel's ring schedule: position ``g = j * ndiag + k`` of a block's
stream (its tile j, diagonal k) lives in slot ``g % depth`` and is that
slot's use ``g // depth``, counted over the block's whole stream
(``tests/test_torch_probes.py`` emulates it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..sparse import kernels as K

__all__ = ["DEPTHS", "DIA_RING_LAUNCHES", "TILES", "dia_matvec_ring",
           "dia_ring_bytes"]

TILES = (256, 512, 1024, 2048, 4096)   # rows a tile: 256 threads x R
DEPTHS = tuple(range(2, 9))            # slots of the ring
RING_BYTES = 192 * 1024                # shared memory the ring may take

# Launches of the kernel in this process (see probes.COUNTERS)
DIA_RING_LAUNCHES = 0


def dia_ring_bytes(ndiag, m, n):
    """Bytes the product must move at best: every diagonal once, x read
    and y written once (f32)."""
    return (ndiag * m + n + m) * 4


def dia_matvec_ring(data, offsets, x, tile=1024, depth=2):
    """``y[i] = sum_k data[k, i] * x[i + offsets[k]]`` (f32), bit for bit
    :func:`..sparse.kernels.dia_matvec_plain`: the TMA-ring kernel for
    CUDA tensors (tiles of ``tile`` rows, a ring of ``depth`` slots), the
    plain version for CPU tensors."""
    if tile not in TILES or depth not in DEPTHS or \
            depth * tile * 4 > RING_BYTES:
        raise ValueError("tile must be one of %s and depth one of %s, with "
                         "depth x tile x 4 at most %d bytes; got %r, %r"
                         % (TILES, DEPTHS, RING_BYTES, tile, depth))
    if data.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("dia_matvec_ring takes f32 data and x, not %s and %s"
                        % (data.dtype, x.dtype))
    if data.device.type == "cpu" and x.device.type == "cpu":
        return K.dia_matvec_plain(data, offsets, x)
    if data.device.type != "cuda" or x.device != data.device:
        raise ValueError("dia_matvec_ring: data on %s and x on %s; the "
                         "kernel takes both on one CUDA device"
                         % (data.device, x.device))
    return _launch(data, tuple(offsets), x, tile, depth)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("probe_dia_ring").probe_dia_ring_f32
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, i64, p, p, i64, i64, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(data, offsets, x, tile, depth):
    global DIA_RING_LAUNCHES
    if data.ndim != 2 or x.ndim != 1 or len(offsets) != data.shape[0]:
        raise ValueError("dia_matvec_ring expects data (ndiag, m), x (n,) "
                         "and ndiag offsets, got %s, %s and %d"
                         % (tuple(data.shape), tuple(x.shape), len(offsets)))
    if len(offsets) > K.MAX_DIAGS:
        raise ValueError("%d diagonals exceed the kernel's %d"
                         % (len(offsets), K.MAX_DIAGS))
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("the ring kernel needs contiguous data and x")
    ndiag, m = data.shape
    n = x.shape[0]
    if m % 4 or data.data_ptr() % 16:
        raise ValueError("the ring kernel's bulk copies need 4 | m and "
                         "16-byte aligned data (m = %d, data at %#x)"
                         % (m, data.data_ptr()))
    if max(m, n) >= 2 ** 31:
        raise ValueError("the ring kernel takes m and n below 2**31")
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    plan = K.dia_mv_plan(offsets, m, n, 4, True)
    offs = K._offsets_info(offsets)[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p),
                       ndiag, x.data_ptr(), y.data_ptr(), m, n, plan.lo,
                       plan.hi, tile, depth, stream)
    if err != 0:
        raise RuntimeError("DIA ring kernel launch failed with CUDA error %d"
                           % err)
    DIA_RING_LAUNCHES += 1
    return y
