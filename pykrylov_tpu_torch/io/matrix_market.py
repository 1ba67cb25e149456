"""MatrixMarket reader.

Counterpart of the reading half of ``pykrylov_tpu/io/matrix_market.py``
(its NumPy path; the native C++ parser is not ported).  Supports the
coordinate and array formats with real / integer / complex / pattern
fields and general / symmetric / skew-symmetric / hermitian qualifiers.
Returns COO triples with 0-based indices; symmetric-family storage is
expanded to the full pattern (strictly-off-diagonal entries mirrored).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

__all__ = ["MMInfo", "read_matrix_market", "mm_to_coo"]


@dataclass
class MMInfo:
    shape: tuple
    nnz_stored: int
    fmt: str          # "coordinate" | "array"
    field: str        # "real" | "integer" | "complex" | "pattern"
    symmetry: str     # general | symmetric | skew-symmetric | hermitian


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_matrix_market(path, expand_symmetric=True, dtype=None):
    """Parse a MatrixMarket file.

    Returns ``(vals, rows, cols, shape, info)`` with 0-based indices.
    When ``expand_symmetric`` (default), symmetric / skew-symmetric /
    hermitian storage is expanded to the full pattern.
    """
    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        parts = header.strip().split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise ValueError("unsupported MatrixMarket header: %s" % header)
        fmt, field, symmetry = (parts[2].lower(), parts[3].lower(),
                                parts[4].lower())

        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        size = line.split()

        if fmt == "coordinate":
            m, n, nnz = int(size[0]), int(size[1]), int(size[2])
            data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
            if data.shape[0] != nnz:
                raise ValueError("expected %d entries, found %d"
                                 % (nnz, data.shape[0]))
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz, dtype=np.float64)
            elif field == "complex":
                vals = data[:, 2] + 1j * data[:, 3]
            else:
                vals = data[:, 2].astype(np.float64)
        elif fmt == "array":
            m, n = int(size[0]), int(size[1])
            raw = np.loadtxt(f, ndmin=2)
            flat = raw[:, 0] + 1j * raw[:, 1] if field == "complex" \
                else raw.ravel()
            if symmetry == "general":
                dense = flat.reshape(n, m).T  # column-major storage
                rows, cols = np.nonzero(np.ones((m, n), bool))
                vals = dense[rows, cols]
            else:
                # packed lower triangle, column-major; skew-symmetric
                # array storage omits the (zero) diagonal
                k = -1 if symmetry == "skew-symmetric" else 0
                rows_l, cols_l = np.tril_indices(m, k=k)
                order = np.lexsort((rows_l, cols_l))
                rows, cols = rows_l[order], cols_l[order]
                vals = flat
            nnz = len(vals)
        else:
            raise ValueError("unknown MatrixMarket format %r" % fmt)

    info = MMInfo((m, n), nnz, fmt, field, symmetry)
    vals = np.asarray(vals)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if dtype is not None:
        vals = vals.astype(dtype)
    if expand_symmetric and symmetry in ("symmetric", "skew-symmetric",
                                         "hermitian"):
        off = rows != cols
        mr, mc, mv = cols[off], rows[off], vals[off]
        if symmetry == "skew-symmetric":
            mv = -mv
        elif symmetry == "hermitian":
            mv = np.conj(mv)
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])
    return vals, rows, cols, (m, n), info


def mm_to_coo(path, dtype=np.float64):
    """Convenience: load a .mtx file as expanded COO triples."""
    vals, rows, cols, shape, _ = read_matrix_market(path, dtype=dtype)
    return vals, rows, cols, shape
