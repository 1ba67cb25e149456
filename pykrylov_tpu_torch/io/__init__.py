"""I/O: MatrixMarket reading (whole or partitioned over shards) and
writing, and bundled test-matrix loading."""

from .matrix_market import (MMInfo, read_matrix_market, mm_to_coo,
                            read_matrix_market_partitioned,
                            write_matrix_market)
from .datasets import load_bundled, BUNDLED

__all__ = ["MMInfo", "read_matrix_market", "mm_to_coo",
           "read_matrix_market_partitioned", "write_matrix_market",
           "load_bundled", "BUNDLED"]
