"""Bundled benchmark matrices.

Counterpart of ``pykrylov_tpu/io/datasets.py``: the reference's three
MatrixMarket files (1138bus, jpwh_991, GD97_b — see BASELINE.md), stored
as compressed ``.npz`` COO archives under the repository's ``data/``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["BUNDLED", "load_bundled", "data_dir"]

BUNDLED = {
    # name: (shape, symmetric, description)
    "1138bus": ((1138, 1138), True,
                "SPD power-system admittance matrix, 2596 stored nnz"),
    "jpwh_991": ((991, 991), False,
                 "nonsymmetric circuit-physics matrix, 6027 nnz"),
    "GD97_b": ((47, 47), True, "weighted graph"),
}


def data_dir():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "data")


def load_bundled(name, dtype=np.float64):
    """Load a bundled matrix as expanded COO triples.

    Returns ``(vals, rows, cols, shape)`` as NumPy arrays.
    """
    if name not in BUNDLED:
        raise KeyError("unknown bundled matrix %r (have %s)"
                       % (name, sorted(BUNDLED)))
    npz = os.path.join(data_dir(), name + ".npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return (z["vals"].astype(dtype), z["rows"], z["cols"],
                    tuple(int(v) for v in z["shape"]))
    mtx = os.path.join(data_dir(), name + ".mtx")
    if os.path.exists(mtx):
        from .matrix_market import mm_to_coo
        return mm_to_coo(mtx, dtype=dtype)
    raise FileNotFoundError("bundled matrix %r not found in %s"
                            % (name, data_dir()))
