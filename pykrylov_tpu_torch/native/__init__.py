"""ctypes bindings to the native host-side data pipeline (``native.cpp``).

Counterpart of ``pykrylov_tpu/native``: a small C++ library for
MatrixMarket parsing, the COO -> ELL / DIA fills and the BELL packer's
window planners, loaded with ``ctypes``.  It is compiled by ``g++`` at
first use into ``_build/`` beside the CUDA libraries (:mod:`.._build`),
named by a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is built once per checkout.  Every entry returns
``None`` where the library is unavailable or the input is outside its
interface, and its callers then take their NumPy path, whose result is
the same array for array.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .. import _build

__all__ = ["available", "mm_parse_native", "ell_fill_native",
           "dia_fill_native", "row_counts_native", "bell_plan_native",
           "bell_sort_plan_w1_native"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "native.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None        # the loaded library, or the build's error message
_FIELDS = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
_SYMMETRIES = {0: "general", 1: "symmetric", 2: "skew-symmetric",
               3: "hermitian"}


def library_path():
    """Where this version of the library is (or will be) built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        "libnative_%s.so" % h.hexdigest()[:16])


def _compile(path):
    """Compile the library to ``path``.  The compiler writes a temporary
    name that is then renamed, so a concurrent process (an xdist worker)
    never loads a half-written library."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host "
                           "pipeline of pykrylov_tpu_torch is compiled "
                           "from native/native.cpp at first use")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed with exit code %d:\n%s"
                               % (proc.returncode, proc.stderr))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    c = ctypes
    lib.mm_parse.restype = c.c_void_p
    lib.mm_parse.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_int64), c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.c_char_p, c.c_int]
    lib.mm_copy.restype = None
    lib.mm_copy.argtypes = [c.c_void_p] * 4
    lib.mm_free.restype = None
    lib.mm_free.argtypes = [c.c_void_p]
    for fill in (lib.ell_fill, lib.dia_fill):
        fill.restype = c.c_int
        fill.argtypes = ([c.c_int64] + [c.c_void_p] * 3
                         + [c.c_int64, c.c_int64] + [c.c_void_p] * 2)
    lib.row_counts.restype = None
    lib.row_counts.argtypes = [c.c_int64, c.c_void_p, c.c_int64,
                               c.c_void_p]
    lib.bell_plan.restype = c.c_int
    lib.bell_plan.argtypes = ([c.c_int64, c.c_void_p, c.c_void_p,
                               c.c_int64, c.c_double] + [c.c_void_p] * 4)
    lib.bell_sort_plan_w1.restype = c.c_int
    lib.bell_sort_plan_w1.argtypes = ([c.c_int64, c.c_void_p, c.c_void_p,
                                       c.c_int64, c.c_double]
                                      + [c.c_void_p] * 7)
    return lib


def _load():
    """The library, built and loaded once per process.  A failed build
    is remembered, so later calls raise its message at once instead of
    running ``g++`` again."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            try:
                if not os.path.exists(path):
                    _compile(path)
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, RuntimeError) as exc:
                _lib = "native build failed: %s" % exc
        if isinstance(_lib, str):
            raise RuntimeError(_lib)
        return _lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _exceeds_i32(*index_arrays, m=0):
    """True when an index would overflow the int32 C interface (a cast
    to int32 wraps silently)."""
    if m >= 2**31:
        return True
    for a in index_arrays:
        a = np.asarray(a)
        if a.size and int(a.max()) >= 2**31:
            return True
    return False


def mm_parse_native(path):
    """Parse a plain (not gzip) MatrixMarket coordinate file.

    Returns ``(vals, rows, cols, shape, field, symmetry)`` with 0-based
    int32 indices and symmetric storage not expanded, as the NumPy parser
    has them before its post-processing; ``None`` for a file the native
    parser does not handle (gzip, array format) or when the library is
    unavailable.
    """
    path = os.fspath(path)
    if path.endswith(".gz") or not available():
        return None
    lib = _load()
    nnz, m, n = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    field, symmetry = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    h = lib.mm_parse(path.encode(), ctypes.byref(nnz), ctypes.byref(m),
                     ctypes.byref(n), ctypes.byref(field),
                     ctypes.byref(symmetry), err, len(err))
    if not h:
        msg = err.value.decode()
        if "not a MatrixMarket" in msg or "supported natively" in msg:
            return None  # the NumPy parser handles or diagnoses it
        raise IOError("MatrixMarket parse failed: %s" % msg)
    try:
        k = int(nnz.value)
        fld = _FIELDS[field.value]
        raw = np.empty(2 * k if fld == "complex" else k, dtype=np.float64)
        rows = np.empty(k, dtype=np.int32)
        cols = np.empty(k, dtype=np.int32)
        lib.mm_copy(h, _ptr(raw), _ptr(rows), _ptr(cols))
    finally:
        lib.mm_free(h)
    vals = raw.view(np.complex128) if fld == "complex" else raw
    return (vals, rows, cols, (int(m.value), int(n.value)), fld,
            _SYMMETRIES[symmetry.value])


def ell_fill_native(rows, cols, vals, m, K):
    """Fill (m, K) padded-row ELL arrays from row-sorted real COO triples.

    Returns ``(ell_data, ell_cols)``, or ``None`` when the library is
    unavailable, the values are not float64 or an index reaches 2^31.
    Raises ``ValueError`` when a row holds more than K entries.
    """
    if np.asarray(vals).dtype != np.float64 or not available():
        return None
    if _exceeds_i32(rows, cols, m=m):
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    ell_data = np.zeros((m, K), dtype=np.float64)
    ell_cols = np.zeros((m, K), dtype=np.int32)
    rc = lib.ell_fill(len(vals), _ptr(rows), _ptr(cols), _ptr(vals),
                      m, K, _ptr(ell_data), _ptr(ell_cols))
    if rc != 0:
        raise ValueError("row exceeded %d ELL slots" % K)
    return ell_data, ell_cols


def dia_fill_native(rows, cols, vals, m, offsets):
    """Fill (ndiag, m) DIA data from real COO triples (``offsets``
    sorted); duplicates accumulate in float64, in the triples' order.

    Returns the array, or ``None`` when the library is unavailable, the
    values are not float64 or an index reaches 2^31.  Raises
    ``ValueError`` when an entry's diagonal is not in ``offsets``.
    """
    if np.asarray(vals).dtype != np.float64 or not available():
        return None
    if _exceeds_i32(rows, cols, m=m):
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.zeros((len(offs), m), dtype=np.float64)
    rc = lib.dia_fill(len(vals), _ptr(rows), _ptr(cols), _ptr(vals),
                      m, len(offs), _ptr(offs), _ptr(data))
    if rc != 0:
        raise ValueError("nnz on a diagonal missing from offsets")
    return data


def row_counts_native(rows, m):
    """Entries per row (``np.bincount(rows, minlength=m)``), or ``None``
    when the library is unavailable or an index reaches 2^31."""
    if not available() or _exceeds_i32(rows, m=m):
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    counts = np.empty(m, dtype=np.int64)
    lib.row_counts(len(rows), _ptr(rows), m, _ptr(counts))
    return counts


def bell_plan_native(rows, cols, nblocks, spill_cost):
    """Per-block BELL window planning (``window=2``), the plan of
    ``sparse.bell._plan_blocks_py``.

    ``rows``/``cols``: (row, col)-sorted int64 structure arrays.
    ``spill_cost``: bytes charged per spilled entry, or None to disable.
    Returns ``(e_base, e_woff, e_cap, depth_per_block)``, or ``None``
    when the library is unavailable.
    """
    if not available():
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    e_base, e_woff, e_cap = (np.zeros(nnz, dtype=np.int64)
                             for _ in range(3))
    dpb = np.zeros(nblocks, dtype=np.int64)
    sc = -1.0 if spill_cost is None else float(spill_cost)
    lib.bell_plan(nnz, _ptr(rows), _ptr(cols), int(nblocks), sc,
                  _ptr(e_base), _ptr(e_woff), _ptr(e_cap), _ptr(dpb))
    return e_base, e_woff, e_cap, dpb


def bell_sort_plan_w1_native(rows, cols, nblocks, spill_cost):
    """Single-sort ``window=1`` BELL planning: the (block, band, row,
    col) sort, the caps and the ordinals of
    ``sparse.bell._plan_bands_sorted`` in one pass.

    ``rows``/``cols``: unsorted int64 structure arrays.  Returns
    ``(order, rs, cs, e_woff, e_cap, k_ord, depth_per_block)`` with the
    per-entry arrays in sorted order, or ``None`` when the library is
    unavailable or an index reaches 2^31.
    """
    if not available():
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    order, rs, cs, e_woff, e_cap, k_ord = (np.empty(nnz, dtype=np.int64)
                                           for _ in range(6))
    dpb = np.zeros(nblocks, dtype=np.int64)
    sc = -1.0 if spill_cost is None else float(spill_cost)
    rc = lib.bell_sort_plan_w1(nnz, _ptr(rows), _ptr(cols), int(nblocks),
                               sc, _ptr(order), _ptr(rs), _ptr(cs),
                               _ptr(e_woff), _ptr(e_cap), _ptr(k_ord),
                               _ptr(dpb))
    if rc != 0:
        return None
    return order, rs, cs, e_woff, e_cap, k_ord, dpb
