"""The least-squares solvers on the card: LSQR and CRAIG over a rectangular
``BellOperator`` (the SELL kernels in both directions) and over an
unsymmetric ``cuda-dia`` operator (the DIA kernel on A and on its
transpose), against the same solves on the CPU, where the same operators
run the kernels' plain versions.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_lls_card.py

Tolerances: the kernels equal their plain versions bit for bit, but the
vector reductions sum in another order on the card, so the iteration
counts agree within 1 and x within 1e-8 relative (f64).  Launches: one per
counted matvec (``n_matvec = 2 n_iter``) plus the transpose product of the
start, which the solvers do not count, as the reference does not.
"""

import numpy as np
import pytest
import torch

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery import convdiff2d_coo
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse import sell as S


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL and DIA kernels have no "
                    "CPU mode)")
    return "cuda"


def _sparse_rect(m=3000, n=1200, seed=28):
    """m x n: three entries a row at random plus a diagonal of 4 on the
    first n rows, so its singular values stay away from 0."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, m, 3 * m), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, 3 * m), np.arange(n)])
    vals = np.concatenate([rng.standard_normal(3 * m), np.full(n, 4.0)])
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    first = np.r_[True, key[1:] != key[:-1]]
    return (np.add.reduceat(vals, np.flatnonzero(first)), rows[first],
            cols[first], (m, n))


def _bell(dev):
    A = B.bell_operator(_sparse_rect(), device=dev)
    assert set(A.cards) == {"fwd", "bwd"}
    return A


def _dia(dev):
    A = operator_from_coo(*convdiff2d_coo(64, wx=65.0, wy=32.5),
                          fmt="cuda-dia", device=dev)
    assert A.fmt == "cuda-dia" and not A.symmetric
    return A


OPERATORS = {"bell": (_bell, S, "SELL_LAUNCHES"),
             "cuda-dia": (_dia, K, "DIA_LAUNCHES")}
SOLVES = {"lsqr": (pt.lsqr, {"damp": 0.1, "atol": 1e-10, "btol": 1e-10,
                            "etol": 0.0}),
          "craig": (pt.craig, {"btol": 1e-10, "etol": 1e-12})}


@pytest.mark.cuda
@pytest.mark.parametrize("solver", sorted(SOLVES))
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_card_solve_matches_cpu(card, op, solver):
    build, module, counter = OPERATORS[op]
    fn, opts = SOLVES[solver]
    A, Ac = build(card), build("cpu")
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    ref = fn(Ac, torch.from_numpy(b), **opts)
    setattr(module, counter, 0)
    res = fn(A, torch.from_numpy(b).to(card), **opts)
    torch.cuda.synchronize()
    launches = getattr(module, counter)
    assert int(res.istop) == int(ref.istop) and bool(res.converged)
    assert abs(int(res.n_iter) - int(ref.n_iter)) <= 1
    assert launches == int(res.n_matvec) + 1 == 2 * int(res.n_iter) + 1
    x, xr = res.x.cpu().numpy(), ref.x.numpy()
    assert np.abs(x - xr).max() <= 1e-8 * np.abs(xr).max()


@pytest.mark.cuda
def test_transpose_products_equal_plain(card):
    # A^T through each kernel bit for bit against its plain version: the
    # SELL transpose card form of a rectangular matrix and the DIA
    # transpose container
    A = _bell(card)
    g = torch.Generator(device=card).manual_seed(6)
    for key, width in (("fwd", A.shape[1]), ("bwd", A.shape[0])):
        x = torch.randn(width, device=card, generator=g, dtype=torch.float64)
        assert torch.equal(S.sell_matvec(A.cards[key], x),
                           S.sell_matvec_plain(A.cards[key], x))
    D = _dia(card)
    x = torch.randn(D.shape[0], device=card, generator=g,
                    dtype=torch.float64)
    t = K.dia_transpose(D.container)
    assert torch.equal(D.T * x, K.dia_matvec_plain(t.data, t.offsets, x))
