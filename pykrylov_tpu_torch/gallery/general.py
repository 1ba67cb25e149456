"""Generated general-sparsity test matrices.

Counterpart of ``pykrylov_tpu/gallery/general.py``: a bundled matrix
scaled up by block-diagonal tiling with weak random coupling between
adjacent tiles, so that per-row degrees, column scatter and the band
structure inside each tile are exactly the original's.  Host-side NumPy,
the same triples in the same order as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..io.datasets import load_bundled

__all__ = ["tiled_general_coo"]


def tiled_general_coo(base: str = "jpwh_991", tiles: int = 1024,
                      coupling: int = 4, seed: int = 0,
                      dtype=np.float32):
    """COO triples for a ``tiles``-fold block-diagonal tiling of a bundled
    matrix, with ``coupling`` random entries tying each tile to the next.

    Returns ``(vals, rows, cols, shape)`` NumPy triples of shape
    ``(tiles*n, tiles*n)`` for an n×n base: 1138bus × 1024 tiles with
    ``coupling=0`` is a 1,165,312-row symmetric positive definite system
    with 4,151,296 nonzeros.
    """
    bvals, brows, bcols, bshape = load_bundled(base)
    n = bshape[0]
    if bshape[0] != bshape[1]:
        raise ValueError("tiling needs a square base matrix")
    bvals = np.asarray(bvals, dtype=dtype)
    brows = np.asarray(brows, dtype=np.int64)
    bcols = np.asarray(bcols, dtype=np.int64)

    offs = np.arange(tiles, dtype=np.int64) * n
    rows = (brows[None, :] + offs[:, None]).reshape(-1)
    cols = (bcols[None, :] + offs[:, None]).reshape(-1)
    vals = np.tile(bvals, tiles)

    if coupling and tiles > 1:
        rng = np.random.default_rng(seed)
        nc = coupling * (tiles - 1)
        t = np.repeat(np.arange(tiles - 1, dtype=np.int64), coupling)
        # entries in the last rows of tile t pointing into the first
        # columns of tile t+1, and vice versa: the bandwidth stays ~n
        cr = t * n + rng.integers(n - 64, n, size=nc)
        cc = (t + 1) * n + rng.integers(0, 64, size=nc)
        cv = rng.standard_normal(2 * nc).astype(dtype) * float(
            np.abs(bvals).mean())
        rows = np.concatenate([rows, cr, cc])
        cols = np.concatenate([cols, cc, cr])
        vals = np.concatenate([vals, cv])

    return vals, rows, cols, (tiles * n, tiles * n)
