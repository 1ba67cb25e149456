"""The CUDA DIA kernels' surface: wrappers, plain versions, operator.

Counterpart of ``pykrylov_tpu/sparse/kernels.py``.  The SpMV kernel is
``csrc/dia_spmv.cu`` (it replaces ``_dia_kernel_ring`` and ``_dia_kernel``),
the block product (SpMM) kernel ``csrc/dia_spmm.cu`` (it replaces
``_dia_mm_kernel_ring``); ``_build`` compiles them at first use.  Both take
the unpadded ``(ndiag, m)`` container of :mod:`.formats` with up to
``MAX_DIAGS`` = 4096 diagonals (``dia_from_coo``'s limit; the Pallas
kernels unroll over any number), and the SpMM the
(n, K) row-major block as the batched solvers hold it, so the TPU kernels'
block padding, block choice and packing (``choose_block``,
``ensure_dia_padded``, ``pack_dia``, the ``_halo_rows*`` helpers, the
``(K, m/128, 128)`` relayout of X) have no counterpart here.  Each
kernel's host plan is made here and handed to the kernel with the
offsets: the SpMV's rows a thread and unchecked interior
(:func:`dia_mv_plan`), the SpMM's columns a thread and column panels
(:func:`dia_mm_plan`).

:func:`dia_matvec` and :func:`dia_matmat` launch their kernel for CUDA
tensors and run the plain torch version (:func:`dia_matvec_plain`,
:func:`dia_matmat_plain`) for CPU tensors; anything else raises.  There is
no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import formats as F
from .. import _build

__all__ = ["DIA_LAUNCHES", "DIA_MM_LAUNCHES", "MAX_DIAGS", "DiaMMPlan",
           "DiaMVPlan", "dia_matvec", "dia_matvec_plain", "dia_matvec_plan",
           "dia_mv_plan", "dia_matmat", "dia_matmat_plain", "dia_matmat_plan",
           "dia_mm_plan", "dia_transpose", "cuda_dia_operator"]

# Launches of the DIA SpMV and SpMM kernels in this process; each wrapper
# adds one per launch and nothing else touches them except a caller
# resetting them.
DIA_LAUNCHES = 0
DIA_MM_LAUNCHES = 0

# Diagonals the kernels take: dia_from_coo's limit.  The offsets travel by
# value in the kernels' parameters, with a k * m table up to 64 diagonals
# and as int32 past that (csrc/dia_spmv.cu, design step 4).
MAX_DIAGS = 4096

# (storage dtype, compute dtype) -> C entry point; an f64 x or X with f32 or
# bf16 storage computes in f64, as the plain versions' promotion does
_ENTRY = {
    (torch.float32, torch.float32): "dia_spmv_f32",
    (torch.bfloat16, torch.float32): "dia_spmv_bf16",
    (torch.float64, torch.float64): "dia_spmv_f64",
    (torch.float32, torch.float64): "dia_spmv_f32f64",
    (torch.bfloat16, torch.float64): "dia_spmv_bf16f64",
}
_MM_ENTRY = {key: name.replace("spmv", "spmm")
             for key, name in _ENTRY.items()}


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("dia_spmv"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _mm_entry(name):
    fn = getattr(_build.load("dia_spmm"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _offsets_info(offsets):
    """``offsets`` (a tuple) as the kernels' int64 argument, with their
    least and greatest (0 and 0 for none): worked out once per tuple, not
    on every launch, which would walk a wide container's offsets in
    Python each time."""
    ints = [int(o) for o in offsets]
    return ((ctypes.c_int64 * max(1, len(ints)))(*ints),
            min(ints, default=0), max(ints, default=0))


def _check(data, offsets, x, xdim=1):
    if data.ndim != 2 or x.ndim != xdim:
        raise ValueError("%s expects data (ndiag, m) and %s, got %s and %s"
                         % ("dia_matvec" if xdim == 1 else "dia_matmat",
                            "x (n,)" if xdim == 1 else "X (n, K)",
                            tuple(data.shape), tuple(x.shape)))
    if len(offsets) != data.shape[0]:
        raise ValueError("%d offsets for %d diagonals"
                         % (len(offsets), data.shape[0]))
    if len(offsets) > MAX_DIAGS:
        raise ValueError("%d diagonals exceed the kernels' %d"
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


def _compute_dtype(data, x):
    """The kernels' compute dtype for ``data`` and ``x``; raises for a
    pair they do not take."""
    ct = torch.promote_types(data.dtype, x.dtype)
    if (data.dtype, ct) not in _ENTRY:
        raise TypeError("the DIA kernels take f32 or bf16 data with an f32 "
                        "or f64 product and f64 data with an f64 product, "
                        "not %s data with %s x"
                        % (data.dtype, x.dtype))
    return ct


class DiaMVPlan(NamedTuple):
    """How the SpMV kernel covers one product (:func:`dia_mv_plan`): ``r``
    consecutive rows a thread, and the interior rows ``[lo, hi)`` whose
    every term lies in range, which run without range checks (``lo ==
    hi``: none)."""
    r: int
    lo: int
    hi: int


def dia_mv_plan(offsets, m, n, itemsize, aligned):
    """The SpMV kernel's plan for ``offsets`` over an (m, n) container
    whose diagonals hold ``itemsize``-byte values, where ``aligned`` says
    that data, x and y are 16-byte aligned.

    R is 16 bytes of stored values (4 in f32, 8 in bf16, 2 in f64) when
    it divides m (else every container row after the first starts
    misaligned) and the pointers are aligned, else 1 (the scalar path).
    The interior is ``[max(0, -min off), min(m, n - max off))``, empty
    (``lo == hi``) when the offsets leave no row with every term inside
    [0, n).
    """
    rw = 16 // itemsize
    r = rw if aligned and m % rw == 0 else 1
    if not len(offsets):
        return DiaMVPlan(r, 0, m)
    _, least, greatest = _offsets_info(tuple(offsets))
    lo = min(max(0, -least), m)
    hi = max(lo, min(m, n - greatest))
    return DiaMVPlan(r, lo, hi)


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def dia_matvec_plan(data, offsets, x):
    """The plan :func:`dia_matvec` takes for these tensors on the card (y
    comes from the caching allocator, 16-byte aligned)."""
    x = x.to(_compute_dtype(data, x))
    return dia_mv_plan(offsets, data.shape[1], x.shape[0],
                       data.element_size(), _aligned(data, x))


def _launch(data, offsets, x):
    global DIA_LAUNCHES
    ct = _compute_dtype(data, x)
    x = x.to(ct)
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("the DIA kernel needs contiguous data and x")
    ndiag, m = data.shape
    y = torch.empty(m, dtype=ct, device=x.device)
    if m == 0:
        return y
    fn = _entry(_ENTRY[(data.dtype, ct)])
    offsets = tuple(offsets)
    plan = dia_mv_plan(offsets, m, x.shape[0], data.element_size(),
                       _aligned(data, x, y))
    offs = _offsets_info(offsets)[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p), ndiag,
                 plan.r, plan.lo, plan.hi, x.data_ptr(), y.data_ptr(), m,
                 x.shape[0], stream)
    if err != 0:
        raise RuntimeError("DIA kernel launch failed with CUDA error %d"
                           % err)
    DIA_LAUNCHES += 1
    return y


def dia_matmat_plain(data, offsets, X):
    """Plain torch version of the SpMM kernel: shifted-slice products on
    (m, K) blocks, summed in ascending diagonal order, each product and sum
    rounded on its own (:func:`.formats.dia_matvec`); column k equals
    :func:`dia_matvec_plain` on column k bit for bit."""
    _check(data, offsets, X, xdim=2)
    return F.dia_matvec(F.DIA(data, tuple(offsets),
                              (data.shape[1], X.shape[0])), X)


def dia_matmat(data, offsets, X):
    """``Y[i, k] = sum_d data[d, i] * X[i + offsets[d], k]`` for an (n, K)
    block, in the promoted dtype of data and X, streaming the diagonals
    once for all K columns: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(data, offsets, X, xdim=2)
    if data.device.type == "cpu" and X.device.type == "cpu":
        return dia_matmat_plain(data, offsets, X)
    if data.device.type != "cuda" or X.device != data.device:
        raise ValueError("dia_matmat: data on %s and X on %s; the kernel "
                         "takes both on one CUDA device"
                         % (data.device, X.device))
    return _launch_mm(data, offsets, X)


class DiaMMPlan(NamedTuple):
    """How the SpMM kernel covers one block product (:func:`dia_mm_plan`):
    ``v`` columns a thread, tiles of ``rows`` rows by ``kc`` columns
    (``kc`` divides K; the tiles run panel-major)."""
    v: int
    rows: int
    kc: int


MM_ROWS = 256                # T, rows a tile: kRows in csrc/dia_spmm.cu
L2_WINDOW_BYTES = 16 << 20   # X rows a panel keeps for its +-max|off| reuse


def dia_mm_plan(offsets, k, itemsize, aligned):
    """The SpMM kernel's plan for ``offsets`` and a block of ``k`` columns
    of ``itemsize``-byte values whose data pointer is 16-byte ``aligned``.

    V is 16 bytes of columns (4 in f32, 2 in f64) when it divides K and X
    is aligned, else 1 (the scalar path).  Kc is K halved while the reuse
    window 2 max|off| Kc itemsize passes L2_WINDOW_BYTES.  T is the
    kernel's MM_ROWS at every K (measured fastest at K = 8-64 against half
    and twice that: chip_dia_variants.py).
    """
    vw = 16 // itemsize
    v = vw if aligned and k % vw == 0 else 1
    _, least, greatest = _offsets_info(tuple(offsets))
    reach = max(-least, greatest, 0)
    kc = k
    while (2 * reach * kc * itemsize > L2_WINDOW_BYTES and kc % 2 == 0
           and (kc // 2) % v == 0):
        kc //= 2
    return DiaMMPlan(v, MM_ROWS, kc)


def dia_matmat_plan(data, offsets, X):
    """The plan :func:`dia_matmat` takes for these tensors on the card."""
    ct = _compute_dtype(data, X)
    item = torch.empty((), dtype=ct).element_size()
    return dia_mm_plan(offsets, X.shape[1], item,
                       X.to(ct).contiguous().data_ptr() % 16 == 0)


def _launch_mm(data, offsets, X):
    global DIA_MM_LAUNCHES
    ct = _compute_dtype(data, X)
    X = X.to(ct).contiguous()           # the kernel reads X row-major
    if not data.is_contiguous():
        raise ValueError("the DIA SpMM kernel needs contiguous data")
    ndiag, m = data.shape
    n, K = X.shape
    Y = torch.empty((m, K), dtype=ct, device=X.device)
    if m == 0 or K == 0:
        return Y
    fn = _mm_entry(_MM_ENTRY[(data.dtype, ct)])
    offsets = tuple(offsets)
    plan = dia_mm_plan(offsets, K, X.element_size(),
                       X.data_ptr() % 16 == 0)
    offs = _offsets_info(offsets)[0]
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p), ndiag,
                 plan.v, plan.kc, X.data_ptr(), Y.data_ptr(), m, n, K,
                 stream)
    if err != 0:
        raise RuntimeError("DIA SpMM kernel launch failed with CUDA error %d"
                           % err)
    DIA_MM_LAUNCHES += 1
    return Y


def dia_transpose(a: F.DIA) -> F.DIA:
    """Transpose of a square DIA container, on its device.

    Entry (i, i+off) of A is entry (j, j-off) of A^T at j = i+off, so
    diagonal ``off`` becomes diagonal ``-off`` with its data shifted by
    ``off``: ``dataT[-off][j] = data[off][j-off]``.  Each input diagonal
    gives one output diagonal, in ascending order of ``-off`` (a repeated
    offset's diagonals in container order), so the offsets are the JAX
    package's ``sorted(-off)``; a diagonal that lies wholly outside the
    matrix (|off| >= m) gives a zero one.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("dia_transpose expects a square container")
    order = sorted(range(len(a.offsets)), key=lambda k: -a.offsets[k])
    offsets_t = tuple(-a.offsets[k] for k in order)
    out = torch.zeros((len(order), m), dtype=a.data.dtype,
                      device=a.data.device)
    for row, k in zip(out, order):
        off = a.offsets[k]
        if 0 <= off < m:
            row[off:] = a.data[k, :m - off]
        elif -m < off < 0:
            row[:m + off] = a.data[k, -off:]
    return F.DIA(out, offsets_t, (m, n))


def cuda_dia_operator(dia: F.DIA, symmetric=False):
    """A :class:`~.linop.SparseOperator` (``fmt="cuda-dia"``) whose
    products are :func:`dia_matvec` and, on (n, K) blocks,
    :func:`dia_matmat` over the container's tensors: the CUDA kernels when
    they lie on a CUDA device.  An unsymmetric operator keeps the
    :func:`dia_transpose` for ``A.T`` and ``A.T @ X``.  Counterpart of
    ``pallas_dia_operator`` with its ``matmat``/``matmat_transp``; no
    padding."""
    from .linop import SparseOperator

    bwd = None if symmetric else dia_transpose(dia)
    return SparseOperator(dia, bwd, symmetric=symmetric, fmt="cuda-dia")
