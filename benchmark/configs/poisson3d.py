"""The 7-point finite-difference Laplacian on an n x n x n grid.

The model problem of Saad, *Iterative Methods for Sparse Linear Systems*,
2nd ed., section 2.2: diagonal 6, -1 to each of the six neighbours,
Dirichlet boundaries.  COO triples in NumPy (a copy of the port's
``gallery.poisson3d_coo``, which the benchmark does not import): the
diagonal first, then for each axis the forward and backward couplings.
"""

import numpy as np


def coo(cfg):
    """``(vals, rows, cols, shape)`` of the configuration ``cfg`` (its
    ``n``), values in ``cfg["value_dtype"]``."""
    n, dim = int(cfg["n"]), 3
    dtype = np.dtype(cfg["value_dtype"])
    idx = np.arange(n ** dim).reshape((n,) * dim)
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n ** dim, 2.0 * dim, dtype=dtype)]
    for axis in reversed(range(dim)):
        lo = [slice(None)] * dim
        hi = [slice(None)] * dim
        lo[axis], hi[axis] = slice(None, -1), slice(1, None)
        r, c = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [r, c]
        cols += [c, r]
        vals += [np.full(2 * r.size, -1.0, dtype=dtype)]
    return (np.concatenate(vals), np.concatenate(rows),
            np.concatenate(cols), (n ** dim, n ** dim))
