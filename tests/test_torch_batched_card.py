"""The batched solvers' products on the card: both SpMM kernels on A^T, and
each batched solver through the kernels against the same solve through
the kernels' plain versions.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_batched_card.py

Tolerances: none.  Each SpMM kernel equals its plain version bit for bit
(f32, f64 and the f32f64 entry, f32 storage with an f64 block), on a
rectangular matrix's forward and transpose SELL card forms and on
``dia_transpose`` of an unsymmetric DIA container; so a batched solve
whose block products go through the kernels must give the bits of the
same solve whose block products are the plain versions on the same
containers, and its launches must be the solver's block products.
"""

import numpy as np
import pytest
import torch

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.gallery import convdiff2d_coo, poisson3d_coo
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_lls_card import _sparse_rect

ENTRIES = {"f32": (np.float32, torch.float32),
           "f64": (np.float64, torch.float64),
           "f32f64": (np.float32, torch.float64)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL and DIA kernels have no "
                    "CPU mode)")
    return "cuda"


def _rect_bell(dev, dtype=np.float32):
    vals, rows, cols, shape = _sparse_rect()
    A = B.bell_operator((vals.astype(dtype), rows, cols, shape), device=dev)
    assert set(A.cards) == {"fwd", "bwd"} and not A.split_rows
    return A


def _convdiff(dev, dtype=np.float32, n=64):
    A = operator_from_coo(*convdiff2d_coo(n, wx=n + 1.0, wy=(n + 1) / 2.0,
                                          dtype=dtype),
                          fmt="cuda-dia", device=dev)
    assert A.fmt == "cuda-dia" and not A.symmetric
    return A


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 3, 8, 64])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_sell_spmm_on_both_card_forms_of_a_rectangular_matrix(card, entry,
                                                              ncols):
    store, block = ENTRIES[entry]
    A = _rect_bell(card, store)
    g = torch.Generator(device=card).manual_seed(ncols)
    for key, width in (("fwd", A.shape[1]), ("bwd", A.shape[0])):
        X = torch.randn((width, ncols), device=card, generator=g,
                        dtype=block)
        Y = S.sell_matmat(A.cards[key], X)
        assert Y.dtype == block
        assert torch.equal(Y, S.sell_matmat_plain(A.cards[key], X)), key
    # the operator's transpose block rule is the bwd card form's kernel
    X = torch.randn((A.shape[0], ncols), device=card, generator=g,
                    dtype=block)
    assert torch.equal(A.T @ X, S.sell_matmat_plain(A.cards["bwd"], X))


@pytest.mark.cuda
@pytest.mark.parametrize("ncols", [1, 3, 8, 64])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_dia_spmm_on_the_transpose_container(card, entry, ncols):
    store, block = ENTRIES[entry]
    A = _convdiff(card, store)
    t = K.dia_transpose(A.container)
    g = torch.Generator(device=card).manual_seed(ncols)
    X = torch.randn((A.shape[0], ncols), device=card, generator=g,
                    dtype=block)
    Y = K.dia_matmat(t.data, t.offsets, X)
    assert torch.equal(Y, K.dia_matmat_plain(t.data, t.offsets, X))
    assert torch.equal(A.T @ X, Y)


def _plain(A):
    """An operator with ``A``'s shape whose block rules are the plain
    versions of ``A``'s kernels on the same containers and card forms."""
    if isinstance(A, B.BellOperator):
        fwd, bwd = A.cards["fwd"], A.cards.get("bwd", A.cards["fwd"])
        mm = lambda X: S.sell_matmat_plain(fwd, X)            # noqa: E731
        rmm = lambda X: S.sell_matmat_plain(bwd, X)           # noqa: E731
    else:
        c = A.container
        t = c if A.symmetric else K.dia_transpose(c)
        mm = lambda X: K.dia_matmat_plain(c.data, c.offsets, X)  # noqa
        rmm = lambda X: K.dia_matmat_plain(t.data, t.offsets, X)  # noqa

    def no_vector(x):
        raise AssertionError("a 1-D product in a batched solve")

    return pt.LinearOperator(A.shape[1], A.shape[0], matvec=no_vector,
                             matvec_transp=lambda x: no_vector(x),
                             symmetric=A.symmetric, dtype=A.dtype,
                             device=A.device, matmat=mm, matmat_transp=rmm)


def _helmholtz(dev, n=24):
    """Poisson n^3 shifted between its two lowest eigenvalues: one
    negative eigenvalue (MINRES's and SYMMLQ's case), f32 storage."""
    vals, rows, cols, shape = poisson3d_coo(n, dtype=np.float32)
    h = np.pi / (2 * (n + 1))
    sigma = 0.5 * (12 * np.sin(h) ** 2 + 8 * np.sin(h) ** 2
                   + 4 * np.sin(2 * h) ** 2)
    vals = np.where(rows == cols, vals - np.float32(sigma), vals)
    return operator_from_coo(vals.astype(np.float32), rows, cols, shape,
                             symmetric=True, fmt="cuda-dia", device=dev)


# solver -> (operator builder, options, kernel module, SpMM counter, block
# products as a function of the block iterations)
SOLVES = {
    "bicgstab": (_convdiff, {"rtol": 1e-8}, K, "DIA_MM_LAUNCHES",
                 lambda k: 2 * k),
    "cgs": (_convdiff, {"rtol": 1e-8}, K, "DIA_MM_LAUNCHES",
            lambda k: 2 * k),
    "tfqmr": (_convdiff, {"rtol": 1e-8}, K, "DIA_MM_LAUNCHES",
              lambda k: 2 * k + 1),
    "minres": (_helmholtz, {"rtol": 1e-8}, K, "DIA_MM_LAUNCHES",
               lambda k: k),
    "symmlq": (_helmholtz, {"rtol": 1e-8}, K, "DIA_MM_LAUNCHES",
               lambda k: k + 2),
    "lsqr": (_rect_bell, {"atol": 1e-8, "btol": 1e-8, "etol": 0.0}, S,
             "SELL_MM_LAUNCHES", lambda k: 2 * k + 1),
    "lsmr": (_rect_bell, {"atol": 1e-8, "btol": 1e-8, "etol": 0.0}, S,
             "SELL_MM_LAUNCHES", lambda k: 2 * k + 1),
    "craig": (_convdiff, {"btol": 1e-8, "etol": 1e-10}, K,
              "DIA_MM_LAUNCHES", lambda k: 2 * k + 1),
    "craigmr": (_convdiff, {"etol": 1e-10}, K, "DIA_MM_LAUNCHES",
                lambda k: 2 * k + 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_batched_solve_through_the_kernels_equals_the_plain_run(card, name):
    build, opts, module, counter, products = SOLVES[name]
    A = build(card)
    rng = np.random.default_rng(8)
    Bm = torch.from_numpy(rng.standard_normal((A.shape[0], 4))).to(card)
    Bm[:, 1] = 0.0                  # a column that stops at once
    solver = getattr(PS, name + "_batched")
    setattr(module, counter, 0)
    K.DIA_LAUNCHES = S.SELL_LAUNCHES = 0
    res = solver(A, Bm, **opts)
    torch.cuda.synchronize()
    launches = getattr(module, counter)
    assert (K.DIA_LAUNCHES, S.SELL_LAUNCHES) == (0, 0)
    assert launches == products(int(res.n_iter)) > 0
    plain = solver(_plain(A), Bm, **opts)
    assert torch.equal(res.x, plain.x)
    assert torch.equal(res.istop, plain.istop)
    assert res.x.dtype == torch.float64 and torch.isfinite(res.x).all()
    assert bool(res.converged[1]) and not res.x[:, 1].any()
