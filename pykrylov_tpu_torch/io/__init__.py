"""I/O: MatrixMarket reading and bundled test-matrix loading."""

from .matrix_market import MMInfo, read_matrix_market, mm_to_coo
from .datasets import load_bundled, BUNDLED

__all__ = ["MMInfo", "read_matrix_market", "mm_to_coo", "load_bundled",
           "BUNDLED"]
