"""MatrixMarket reading and writing.

Counterpart of ``pykrylov_tpu/io/matrix_market.py``.  The reader parses
a plain coordinate file with the native C++ parser (:mod:`..native`)
where its library is available, else with NumPy; both give the same
arrays.  It supports the coordinate and array formats with real /
integer / complex / pattern fields and general / symmetric /
skew-symmetric / hermitian qualifiers, and returns COO triples with
0-based indices; symmetric-family storage is expanded to the full
pattern (strictly-off-diagonal entries mirrored).  The partitioned
reader streams a coordinate file into the row blocks of a mesh of shards
without building the whole COO, with NumPy; the writer emits coordinate
files.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from ..native import mm_parse_native

__all__ = ["MMInfo", "read_matrix_market", "mm_to_coo",
           "read_matrix_market_partitioned", "write_matrix_market"]


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
    try:
        out = mm_parse_native(path)
    except OSError:
        out = None  # a malformed file: the NumPy parser diagnoses it
    if out is not None:
        vals, rows, cols, shape, field, symmetry = out
        info = MMInfo(shape, len(vals), "coordinate", field, symmetry)
        return _finish(vals, rows, cols, info, expand_symmetric, dtype)

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
    return _finish(vals, rows, cols, info, expand_symmetric, dtype)


def _finish(vals, rows, cols, info, expand_symmetric, dtype):
    """Both parsers' post-processing: int64 indices, the value dtype and
    the symmetric expansion."""
    vals = np.asarray(vals)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if dtype is not None:
        vals = vals.astype(dtype)
    if expand_symmetric and info.symmetry in ("symmetric", "skew-symmetric",
                                              "hermitian"):
        mv, mr, mc = _mirror(vals, rows, cols, info.symmetry)
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])
    return vals, rows, cols, info.shape, info


def mm_to_coo(path, dtype=np.float64):
    """Convenience: load a .mtx file as expanded COO triples."""
    vals, rows, cols, shape, _ = read_matrix_market(path, dtype=dtype)
    return vals, rows, cols, shape


def _mirror(vv, rr, cc, symmetry):
    """The mirrored strictly-off-diagonal entries of symmetric-family
    storage, as (vals, rows, cols)."""
    off = rr != cc
    mv = vv[off]
    if symmetry == "skew-symmetric":
        mv = -mv
    elif symmetry == "hermitian":
        mv = np.conj(mv)
    return mv, cc[off], rr[off]


def read_matrix_market_partitioned(path, n_parts, keep=None,
                                   chunk_entries=1 << 20,
                                   expand_symmetric=True, dtype=None):
    """Stream-parse a coordinate MatrixMarket file into row-block
    partitions without building the whole COO.

    The coordinate section is read in chunks of ``chunk_entries``; each
    chunk's entries (and their symmetric mirrors) go to the row block
    that owns them, ``row // Lrow`` with ``Lrow = pad_to_multiple(m,
    n_parts) // n_parts``: the partition of the sharded operators
    (:mod:`pykrylov_tpu_torch.parallel`), so part k is shard k's rows.

    ``keep=k`` keeps part k only and drops the rest chunk by chunk: the
    peak memory is one chunk plus that part (the ingestion of one process
    of a multi-process mesh).  ``keep=None`` returns every part.

    Returns ``(parts, shape, info)``: ``parts`` a list of ``(vals, rows,
    cols)`` NumPy triples with global row indices (just the kept part
    when ``keep`` is given), entries in file order with each chunk's
    mirrors after its entries.
    """
    from ..parallel.sharded import pad_to_multiple

    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        parts_h = header.strip().split()
        fmt, field, symmetry = (parts_h[2].lower(), parts_h[3].lower(),
                                parts_h[4].lower())
        if fmt != "coordinate":
            raise ValueError("partitioned ingestion supports the "
                             "coordinate format only (got %r)" % fmt)
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        size = line.split()
        m, n, nnz = int(size[0]), int(size[1]), int(size[2])
        info = MMInfo((m, n), nnz, fmt, field, symmetry)
        Lrow = pad_to_multiple(m, n_parts) // n_parts
        kept = range(n_parts) if keep is None else (keep,)
        buckets = [([], [], []) for _ in range(n_parts)]

        def route(vv, rr, cc):
            owner = rr // Lrow
            for k in kept:
                sel = owner == k
                if sel.any():
                    for bucket, a in zip(buckets[k], (vv, rr, cc)):
                        bucket.append(a[sel])

        remaining = nnz
        ncols_file = 4 if field == "complex" else (
            2 if field == "pattern" else 3)
        while remaining > 0:
            take = min(remaining, int(chunk_entries))
            data = np.loadtxt(f, max_rows=take, ndmin=2)
            if data.shape[0] != take:
                raise ValueError("expected %d more entries, found %d"
                                 % (take, data.shape[0]))
            if data.shape[1] != ncols_file:
                raise ValueError("bad column count %d for field %r"
                                 % (data.shape[1], field))
            rr = data[:, 0].astype(np.int64) - 1
            cc = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vv = np.ones(take, dtype=np.float64)
            elif field == "complex":
                vv = data[:, 2] + 1j * data[:, 3]
            else:
                vv = data[:, 2]
            if dtype is not None:
                vv = vv.astype(dtype)
            route(vv, rr, cc)
            if expand_symmetric and symmetry in (
                    "symmetric", "skew-symmetric", "hermitian"):
                route(*_mirror(vv, rr, cc, symmetry))
            remaining -= take

    def cat(b):
        if not b[0]:
            dt = np.float64 if dtype is None else dtype
            return (np.zeros(0, dt), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        return tuple(np.concatenate(a) for a in b)

    return [cat(buckets[k]) for k in kept], (m, n), info


def write_matrix_market(path, vals, rows, cols, shape, symmetry="general",
                        comment=None):
    """Write COO triples (NumPy arrays or tensors, 0-based) to a
    coordinate MatrixMarket file, values with 17 significant digits (the
    JAX package's text, byte for byte)."""
    vals, rows, cols = (a.detach().cpu().numpy() if hasattr(a, "detach")
                        else np.asarray(a) for a in (vals, rows, cols))
    field = "complex" if np.iscomplexobj(vals) else "real"
    with open(path, "w") as f:
        f.write("%%%%MatrixMarket matrix coordinate %s %s\n"
                % (field, symmetry))
        if comment:
            for line in str(comment).splitlines():
                f.write("%% %s\n" % line)
        f.write("%d %d %d\n" % (shape[0], shape[1], len(vals)))
        for v, r, c in zip(vals, rows, cols):
            if field == "complex":
                f.write("%d %d %.16e %.16e\n"
                        % (r + 1, c + 1, v.real, v.imag))
            else:
                f.write("%d %d %.16e\n" % (r + 1, c + 1, v))
