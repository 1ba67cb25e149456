"""The port's block products (SpMM) against the JAX package.

``kernels.dia_matmat`` runs its plain torch version on CPU tensors, and
``bell.bell_matmat_plain`` is the BELL container's own block product; they
are held against the Pallas SpMM kernels in interpret mode
(``dia_matmat_packed``, ``bell_matmat_pallas``, as ``tests/test_spmm.py``
runs them) on the same stored matrices, carried across with
``convert.from_numpy``, and against the dense product.  A BELL operator's
block rule runs over its card form (``sell.sell_matmat``, plain on CPU
tensors; ``tests/test_torch_sell.py``).  The CUDA kernels themselves run
only on the card (``chip_smoke.py``, ``tests/test_torch_spmm_card.py``).

Tolerances: 1e-12 relative (max norm) in float64, where only the summation
order differs.  Column k of a plain block product equals the plain matvec
on column k bit for bit (the kernels' contract, checked exactly on the
card), and an operator's block rule equals its column-by-column products
within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.ops.base import DiagonalOperator as JDiagonalOperator
from pykrylov_tpu.ops.base import linop_from_ndarray
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse import linop as JL
from pykrylov_tpu.sparse.kernels import (dia_matmat_packed, ensure_dia_padded,
                                         pack_dia)

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.ops.base import (DiagonalOperator, LinearOperator,
                                         MatrixOperator)
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import linop as TL
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_bell_pack import triples, wide_window
from test_torch_bell_product import _square_with_heavy_rows

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def dense(t):
    a = np.zeros(t[3])
    np.add.at(a, (t[1], t[2]), np.asarray(t[0], np.float64))
    return a


# --------------------------------------------------------------------------
# DIA
# --------------------------------------------------------------------------

OFFSETS = (-128, -3, 0, 2, 130)


def banded_dia(m, offsets, seed):
    """(dense matrix, JAX DIA container) with random values on
    ``offsets``, zero outside the matrix."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for off in offsets:
        i = np.arange(max(0, -off), min(m, m - off))
        d[i, i + off] = rng.standard_normal(len(i))
    rr, cc = np.nonzero(d)
    jdia = JF.dia_from_coo(JF.coo_from_arrays(d[rr, cc], rr, cc, (m, m),
                                              device=False), device=False)
    return d, jdia


@pytest.mark.parametrize("ncols", [1, 3])
def test_dia_matmat_matches_pallas_and_dense(ncols):
    m = 1024
    d, jdia = banded_dia(m, OFFSETS, 7)
    dia = convert.from_numpy(jdia, device=DEV)
    X = np.random.default_rng(ncols).standard_normal((m, ncols))
    dia_p, _ = ensure_dia_padded(JF.DIA(jnp.asarray(jdia.data), jdia.offsets,
                                        jdia.shape), 512)
    d3, offs = pack_dia(dia_p, 512)
    Xp = np.zeros((dia_p.shape[0], ncols))
    Xp[:m] = X
    ref = np.asarray(dia_matmat_packed(d3, offs, jnp.asarray(Xp), block=512,
                                       interpret=True))[:m]
    Y = K.dia_matmat(dia.data, dia.offsets, torch.from_numpy(X))
    assert Y.shape == (m, ncols) and Y.dtype == torch.float64
    assert rel(Y.numpy(), ref) <= 1e-12
    assert rel(Y.numpy(), d @ X) <= 1e-12
    # column k is the plain matvec on column k, bit for bit
    for k in range(ncols):
        col = K.dia_matvec_plain(dia.data, dia.offsets,
                                 torch.from_numpy(X[:, k]))
        assert torch.equal(Y[:, k], col)


def test_dia_matmat_bf16_storage_and_rectangular_x():
    # bf16 diagonals with an f32 block compute in f32; X longer than m
    # (n > m) and shorter (a term past X's end is skipped, as in the SpMV)
    m = 600
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((3, m))).to(torch.bfloat16)
    offsets = (-5, 0, 7)
    for n in (m, m + 40, m - 30):
        X = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
        Y = K.dia_matmat(data, offsets, X)
        assert Y.dtype == torch.float32 and Y.shape == (m, 4)
        for k in range(4):
            assert torch.equal(Y[:, k],
                               K.dia_matvec_plain(data, offsets, X[:, k]))


def test_dia_matmat_wrapper_takes_plain_only_on_the_cpu():
    m = 256
    data = torch.from_numpy(np.random.default_rng(1).standard_normal((3, m)))
    X = torch.ones((m, 2), dtype=torch.float64)
    before = K.DIA_MM_LAUNCHES
    assert torch.equal(K.dia_matmat(data, (-1, 0, 1), X),
                       K.dia_matmat_plain(data, (-1, 0, 1), X))
    assert K.DIA_MM_LAUNCHES == before   # no kernel ran
    with pytest.raises(ValueError, match="CUDA"):
        K.dia_matmat(data.to("meta"), (-1, 0, 1), X)
    with pytest.raises(ValueError, match=r"X \(n, K\)"):
        K.dia_matmat(data, (-1, 0, 1), X[:, 0])


@pytest.mark.parametrize("symmetric", [False, True])
def test_cuda_dia_operator_block_products(symmetric):
    # A @ X and A.T @ X through the operator's block rule equal its
    # column-by-column products (the JAX test_spmm.py:188-209 contract)
    m = 640
    rng = np.random.default_rng(8)
    offsets = (-2, 0, 5) if not symmetric else (-5, 0, 5)
    data = rng.standard_normal((3, m))
    if symmetric:
        data[0, 5:] = data[2, :m - 5]
    for k, off in enumerate(offsets):
        i = np.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    op = K.cuda_dia_operator(F.DIA(torch.from_numpy(data), offsets, (m, m)),
                             symmetric=symmetric)
    assert op._mm is not None and op._rmm is not None
    X = torch.from_numpy(rng.standard_normal((m, 4)))
    for o in (op, op.T):
        Y = o @ X
        cols = torch.stack([o @ X[:, k] for k in range(4)], dim=1)
        assert torch.equal(Y, cols)
    a = F.to_dense(op.container).numpy()
    assert rel((op.T @ X).numpy(), a.T @ X.numpy()) <= 1e-12


def test_plain_sparse_formats_keep_the_column_loop():
    # the plain formats carry no block rule (the JAX package vmaps them);
    # fmt="cuda-dia" carries the kernel's
    t = triples(300, 300, 1500, 9, bandwidth=3)
    for fmt, has in (("dia", False), ("csr", False), ("ell", False),
                     ("cuda-dia", True)):
        op = TL.operator_from_coo(*t, fmt=fmt, device=DEV)
        assert (op._mm is not None) == has, fmt
        X = torch.from_numpy(np.random.default_rng(2).standard_normal((300,
                                                                       3)))
        assert rel((op @ X).numpy(), dense(t) @ X.numpy()) <= 1e-12


# --------------------------------------------------------------------------
# BELL
# --------------------------------------------------------------------------

_CONTAINERS = {
    # name: (triples, bell_from_coo options)
    "w1": (lambda: triples(600, 600, 4000, 1, bandwidth=90),
           dict(window=1, spill_cost=None)),
    "w2": (lambda: triples(600, 600, 4000, 1, bandwidth=90),
           dict(window=2, spill_cost=None)),
    "w2-rect": (lambda: triples(700, 300, 2500, 3),
                dict(window=2, spill_cost=None)),
    "int8": (lambda: triples(600, 600, 4000, 2, bandwidth=90),
             dict(window=1, spill_cost=None, idx_fmt="int8")),
    "remainder": (lambda: triples(256, 256, 1200, 41, bandwidth=60),
                  dict(window=1, spill_cost=12.0)),
    "segmented": (lambda: wide_window(m=1024, n=60000, far_frac=0.05),
                  dict(window=1, spill_cost=None, segment=True)),
    "segmented-int8": (lambda: wide_window(m=1024, n=60000, far_frac=0.05),
                       dict(window=1, spill_cost=None, segment=True,
                            idx_fmt="int8")),
}


def pallas_mm(ref, X):
    """The JAX SpMM kernel's ``A X`` (interpret mode) on a host container,
    COO remainder included."""
    Xp = np.zeros((ref.padded_shape[1], X.shape[1]), X.dtype)
    Xp[:X.shape[0]] = X
    Y = JB.bell_matmat_pallas(JB.bell_to_device(ref), jnp.asarray(Xp),
                              interpret=True)
    return np.asarray(Y)[:ref.shape[0]]


@pytest.mark.parametrize("name", sorted(_CONTAINERS))
def test_bell_matmat_matches_pallas(name):
    make, kw = _CONTAINERS[name]
    t = make()
    m, n = t[3]
    ref = JB.bell_from_coo(JF.coo_from_arrays(*t, device=False),
                           device=False, **kw)
    if name.startswith("segmented"):
        assert ref.seg is not None
    if name == "remainder":
        assert ref.nnz_spill > 0
    b = convert.from_numpy(ref, device=DEV)
    X = np.random.default_rng(5).standard_normal((n, 3))
    Y = TB.bell_levels_matmat((b,), torch.from_numpy(X), m)
    assert Y.shape == (m, 3) and Y.dtype == torch.float64
    assert rel(Y.numpy(), pallas_mm(ref, X)) <= 1e-12
    assert rel(Y.numpy(), dense(t) @ X) <= 1e-12
    # the slot product's column k is the plain matvec on column k
    slots = TB.bell_matmat_plain(b, torch.from_numpy(X), m)
    for k in range(3):
        col = TB.bell_matvec_plain(b, torch.from_numpy(X[:, k]), m)
        assert torch.equal(slots[:, k], col)


def test_bell_matmat_accumulates_levels_and_checks_shapes():
    t = triples(1000, 1000, 8000, 1, bandwidth=90)
    lv = JB._pack_levels(JF.coo_from_arrays(*t, device=False), 16, 12.0, 2,
                         device=False, window=2)
    levels = tuple(convert.from_numpy(b, device=DEV) for b in lv)
    assert len(levels) == 2
    X = torch.from_numpy(np.random.default_rng(2).standard_normal((1000,
                                                                   4)))
    Y = TB.bell_levels_matmat(levels, X, 1000)
    assert rel(Y.numpy(), dense(t) @ X.numpy()) <= 1e-12
    out = torch.ones((1000, 4), dtype=torch.float64)
    TB.bell_matmat_plain(levels[0], X, 1000, out=out)
    assert torch.equal(out, TB.bell_matmat_plain(levels[0], X, 1000) + 1.0)
    # the card form of the two levels: its wrapper runs the plain version
    # on the CPU (no kernel) and refuses another device
    card = S.sell_from_levels(levels, 1000)
    before = S.SELL_MM_LAUNCHES
    assert torch.equal(S.sell_matmat(card, X), S.sell_matmat_plain(card, X))
    assert rel(S.sell_matmat(card, X).numpy(), Y.numpy()) <= 1e-12
    assert S.SELL_MM_LAUNCHES == before   # no kernel ran
    with pytest.raises(ValueError, match=r"X \(n, K\)"):
        TB.bell_matmat_plain(levels[0], X[:, 0], 1000)
    with pytest.raises(ValueError, match="out has shape"):
        TB.bell_matmat_plain(levels[0], X, 1000, out=torch.zeros(1000, 3))
    with pytest.raises(ValueError, match="CUDA"):
        S.sell_matmat(S.SELL(*(a.to("meta") for a in card[:5]), *card[5:]),
                      X)


def _jax_bwd_ell(t):
    """The auto policy's BELL-forward, ELL-transpose operator in both
    packages over the same forward packing."""
    jcoo = JF.coo_from_arrays(*t, device=False)
    ref = JB.bell_from_coo(jcoo, spill_cost=None, device=False, window=1)
    jop = JL._bell_fwd_ell_bwd(jcoo, (ref,), False)
    top = TL._bell_fwd_ell_bwd(
        F.coo_from_arrays(*t, device=None),
        (convert.from_numpy(ref, device=DEV),), False, DEV)
    return jop, top


_OPERATORS = {
    "split": (_square_with_heavy_rows, dict(split_rows="auto")),
    "permuted": (lambda: triples(900, 900, 5000, 4), dict(reorder=True)),
    "two-level": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
                  dict(window=2)),
    "bwd-ell": (lambda: triples(500, 500, 3000, 6, bandwidth=40), None),
}


@pytest.mark.parametrize("name", sorted(_OPERATORS))
def test_bell_operator_block_products_match_jax(name):
    make, kw = _OPERATORS[name]
    t = make()
    m, n = t[3]
    if kw is None:
        jop, top = _jax_bwd_ell(t)
        assert top._args["bwd_ell"] is not None and top._rmm is None
    else:
        jop = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                               interpret=True, **kw)
        top = TB.bell_operator(t, device=DEV, **kw)
        assert top._rmm is not None
    assert top._mm is not None
    if name == "split":
        assert top.split_rows == 12
    if name == "permuted":
        assert top.solve_permutation is not None
    rng = np.random.default_rng(7)
    X, Yt = rng.standard_normal((n, 3)), rng.standard_normal((m, 3))
    a = dense(t)
    fwd = (top @ torch.from_numpy(X)).numpy()
    bwd = (top.T @ torch.from_numpy(Yt)).numpy()
    assert rel(fwd, np.asarray(jop @ jnp.asarray(X))) <= 1e-12
    assert rel(bwd, np.asarray(jop.T @ jnp.asarray(Yt))) <= 1e-12
    assert rel(fwd, a @ X) <= 1e-12 and rel(bwd, a.T @ Yt) <= 1e-12
    # the block rule agrees with the operator's own column products, and
    # the plain twin computes the same block product
    cols = np.stack([(top @ torch.from_numpy(X[:, k])).numpy()
                     for k in range(3)], axis=1)
    assert rel(fwd, cols) <= 1e-12
    plain = top.plain()
    assert rel((plain @ torch.from_numpy(X)).numpy(), fwd) <= 1e-12
    if top.solve_permutation is not None:
        _, _, inner = top.solve_permutation
        assert inner._mm is not None


# --------------------------------------------------------------------------
# algebra
# --------------------------------------------------------------------------

def test_block_rules_propagate_through_algebra():
    # as tests/test_spmm.py:161-186, in f64 against both the dense oracle
    # and the JAX package
    rng = np.random.default_rng(9)
    n = 96
    a = rng.standard_normal((n, n))
    dd = np.arange(1, n + 1, dtype=np.float64)
    A = MatrixOperator(a, device=DEV)
    D = DiagonalOperator(dd, device=DEV)
    JA = linop_from_ndarray(jnp.asarray(a))
    JD = JDiagonalOperator(jnp.asarray(dd))
    X = rng.standard_normal((n, 3))
    cases = [((2.0 * A + D) @ A.T, (2.0 * JA + JD) * JA.T,
              (2.0 * a + np.diag(dd)) @ a.T),
             (A ** 2, JA ** 2, a @ a),
             ((A - D) / 3.0, (JA - JD) / 3.0, (a - np.diag(dd)) / 3.0),
             (-A, -JA, -a)]
    for op, jop, d in cases:
        assert op._mm is not None and op._rmm is not None
        Y = (op @ torch.from_numpy(X)).numpy()
        assert rel(Y, d @ X) <= 1e-12
        assert rel(Y, np.asarray(jop * jnp.asarray(X))) <= 1e-12
        assert rel((op.T @ torch.from_numpy(X)).numpy(), d.T @ X) <= 1e-12


def test_block_rule_is_used_and_matmat_kwarg():
    # a 2-D operand goes through the native rule when there is one (one
    # call for the block), else column by column; a symmetric operator's
    # transpose rule defaults to matmat
    calls = []

    def mm(X):
        calls.append(X.shape)
        return 2.0 * X

    n = 17
    op = LinearOperator(n, n, matvec=lambda x: 2.0 * x, matmat=mm,
                        symmetric=True, dtype=torch.float64, device=DEV)
    assert op._rmm is op._mm
    X = torch.ones((n, 3), dtype=torch.float64)
    assert torch.equal(op @ X, 2.0 * X) and calls == [(n, 3)]
    assert op.nMatvec == 1      # one shape-checked application per block
    assert torch.equal(op.T @ X, 2.0 * X) and len(calls) == 2
    D = DiagonalOperator(np.arange(1.0, n + 1), device=DEV)
    assert torch.equal(D @ X, D.diag[:, None] * X)
    bare = LinearOperator(n, n, matvec=lambda x: 3.0 * x,
                          dtype=torch.float64, device=DEV)
    assert bare._mm is None and torch.equal(bare @ X, 3.0 * X)
    assert torch.equal((bare * 2.0) @ X, 6.0 * X)
