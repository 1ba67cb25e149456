"""A SuiteSparse matrix tiled block-diagonally.

The tiles are copies of the matrix in ``cfg["matrix_file"]`` (an ``.npz``
beside this file with ``vals``, ``rows``, ``cols``, ``shape``), placed
``cfg["tiles"]`` times along the diagonal, independent of each other.
A copy of the port's ``gallery.tiled_general_coo`` without its coupling
entries, which the benchmark does not import; every row keeps the
original's degree and column scatter.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def coo(cfg):
    """``(vals, rows, cols, shape)`` of the configuration ``cfg``."""
    dtype = np.dtype(cfg["value_dtype"])
    tiles = int(cfg["tiles"])
    with np.load(os.path.join(HERE, cfg["matrix_file"])) as z:
        bvals = z["vals"].astype(dtype)
        brows = z["rows"].astype(np.int64)
        bcols = z["cols"].astype(np.int64)
        n, n2 = (int(v) for v in z["shape"])
    if n != n2:
        raise ValueError("tiling needs a square matrix, not %d x %d"
                         % (n, n2))
    offs = np.arange(tiles, dtype=np.int64) * n
    rows = (brows[None, :] + offs[:, None]).reshape(-1)
    cols = (bcols[None, :] + offs[:, None]).reshape(-1)
    vals = np.tile(bvals, tiles)
    return vals, rows, cols, (tiles * n, tiles * n)
