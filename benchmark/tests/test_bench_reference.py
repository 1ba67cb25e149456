"""The plain reference against a dense product, and the control against
the comparison."""

import numpy as np
import pytest
import torch

from benchmark import harness, reference
from smallcells import small


def dense(coo):
    vals, rows, cols, shape = coo
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    return a


@pytest.mark.parametrize("name", ["poisson3d-n240.cg",
                                  "bus1138-x1024.cg-k8"])
@pytest.mark.parametrize("k", [1, 3])
def test_product_matches_dense(name, k):
    _, cfg = small(name)
    coo = harness.coo_of(cfg)
    x = np.random.default_rng(0).standard_normal((cfg["rows"], k))
    y = reference.Coo(coo, "cpu").matmul(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), dense(coo) @ x, rtol=1e-12,
                               atol=1e-12)
    y1 = reference.Coo(coo, "cpu").matmul(torch.from_numpy(x[:, 0]))
    np.testing.assert_allclose(y1.numpy(), dense(coo) @ x[:, 0],
                               rtol=1e-12, atol=1e-12)


def test_plain_cg_solves():
    _, cfg = small("poisson3d-n240.cg")
    A = reference.Coo(harness.coo_of(cfg), "cpu")
    b = A.matmul(torch.ones(cfg["rows"], dtype=torch.float64))
    x = reference.plain_cg(A, b, 1e-10, 500, torch.float64)
    assert max(reference.rel_residuals(A, b, x)) < 1e-9
    B = torch.stack([b, 2 * b, torch.zeros_like(b)], 1)
    B[:, 2] = A.matmul(torch.arange(cfg["rows"], dtype=torch.float64))
    X = reference.plain_cg(A, B, 1e-10, 500, torch.float64)
    assert max(reference.rel_residuals(A, B, X)) < 1e-9


@pytest.mark.parametrize("name", ["poisson3d-n240.cg",
                                  "bus1138-x1024.cg-k8",
                                  "poisson3d-n240.cg-k8"])
def test_control_is_not_correct(name):
    """The reference in bfloat16 in the port's place, at a small size:
    the comparison rejects it (the chip run does so at the cell's own
    size, ``control.py``)."""
    from benchmark import control
    cell, cfg = small(name)
    lines = control.readings(name, [11], [12, 2 ** 31 + 5], 0.2,
                             device="cpu", cell=cell, cfg=cfg,
                             emit=lambda s: None)
    assert [r["correct"] for r in lines] == [True, False, False]
    for r in lines[1:]:
        assert (r["checks"]["product_err"]["value"]
                > r["checks"]["product_err"]["limit"])
