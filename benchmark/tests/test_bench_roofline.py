"""Roofline bytes counted from the configurations' matrices."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT
from benchmark import harness, roofline

H100 = "NVIDIA H100 80GB HBM3"


def cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config, k, mb, ms", [
    ("poisson3d-n240", 1, 496.3, 0.1481),
    ("poisson3d-n240", 8, 1270.4, 0.3792),
    ("bus1138-x1024", 8, 107.8, 0.0322),
])
def test_worked_bytes(config, k, mb, ms):
    c = cfg(config)
    assert round(roofline.product_bytes(c, k) / 1e6, 1) == mb
    assert round(roofline.bound_ms(c, k, H100), 4) == ms


@pytest.mark.parametrize("n, k", [(2, 1), (2, 3), (3, 1)])
def test_small_grid_by_hand(n, k):
    # a 2^3 grid: 8 rows, 8 diagonal entries and 6 * 4 neighbour pairs
    # counted both ways, 4 bytes each; x and y 8 entries, 4 bytes, k wide
    rows = n ** 3
    nnz = {2: 8 + 24, 3: 27 + 108}[n]
    c = {"rows": rows, "nnz": nnz, "bytes_per_nnz": 4}
    assert roofline.product_bytes(c, k) == nnz * 4 + 2 * rows * 4 * k
    assert roofline.product_bytes(c, k) == {(2, 1): 192, (2, 3): 320,
                                            (3, 1): 756}[(n, k)]


def test_unknown_card_has_no_bound():
    assert roofline.bound_ms(cfg("poisson3d-n240"), 1, "cpu") is None


@pytest.mark.parametrize("config, over", [
    ("poisson3d-n240", {"n": 7, "rows": 343, "nnz": 343 + 6 * 49 * 6}),
    ("bus1138-x1024", {}),
])
def test_counts_match_generator(config, over):
    """The sizes the bytes are counted from are the generator's: at full
    size for the bus matrix, at a small n for the stencil (whose full
    size the formula n^3 + 6 n^2 (n - 1) gives below)."""
    c = dict(cfg(config), **over)
    vals, rows, cols, shape = harness.coo_of(c)
    assert shape == (c["rows"], c["rows"])
    assert len(vals) == c["nnz"] == len(rows) == len(cols)
    assert vals.dtype == np.dtype(c["value_dtype"])


def test_full_poisson_counts():
    c = cfg("poisson3d-n240")
    n = c["n"]
    assert c["rows"] == n ** 3
    assert c["nnz"] == n ** 3 + 6 * n * n * (n - 1)
