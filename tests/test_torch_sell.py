"""The SELL-C-sigma card form against the BELL containers it is derived from.

The JAX package packs; ``convert`` carries its container into the port,
where :func:`sell_from_levels` derives the card form.  The card form's
plain products (the CPU route of ``sell_matvec``/``sell_matmat``) are held
against the container's own plain products and against the JAX package's
Pallas kernels in interpret mode, on every container variant the packer
emits: window 1 and 2, packed and byte indices, segmented (mixed) bands,
two levels, a COO remainder, the row split, RCM, bf16 storage, f32 and
f64 values.

Tolerances, relative to max|y|: 1e-12 in f64 and 1e-6 in f32 and bf16
storage (f32 sums).  Only the summation order differs: the card form adds
a row's products one by one, the container sums 4-row groups and adds them
with ``index_add_``.  Exact: every column of a block product equals the
matvec on that column, bit for bit (the kernels' contract, which the card
checks in ``tests/test_torch_spmm_card.py``)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_bell_pack import triples, wide_window
from test_torch_bell_product import _far_cluster, _square_with_heavy_rows

DEV = "cpu"  # the port's entry points default to the card
TOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def _two_levels(dtype):
    t = triples(1000, 1000, 8000, 1, bandwidth=90)
    lv = JB._pack_levels(JF.coo_from_arrays(t[0].astype(dtype), *t[1:],
                                            device=False),
                         16, 12.0, 2, device=False, window=2)
    assert len(lv) == 2
    return lv


def _remainder_levels(dtype):
    t = _far_cluster()
    lv = JB._pack_levels(JF.coo_from_arrays(t[0].astype(dtype), *t[1:],
                                            device=False),
                         16, 12.0, 2, device=False, window=1)
    assert lv[-1].nnz_spill > 0
    return lv


def _packed(make, **kw):
    def levels(dtype):
        t = make()
        coo = JF.coo_from_arrays(t[0].astype(dtype), *t[1:], device=False)
        return (JB.bell_from_coo(coo, device=False, **kw),)
    return levels


_CONTAINERS = {
    "w1": _packed(lambda: triples(600, 600, 4000, 1, bandwidth=90),
                  window=1, spill_cost=None),
    "w2": _packed(lambda: triples(600, 600, 4000, 1, bandwidth=90),
                  window=2, spill_cost=None),
    "w2-rect": _packed(lambda: triples(700, 300, 2500, 3), window=2,
                       spill_cost=None),
    "w1-int8": _packed(lambda: triples(600, 600, 4000, 2, bandwidth=90),
                       window=1, spill_cost=None, idx_fmt="int8"),
    "segmented-mixed": _packed(lambda: wide_window(far_frac=0.08, heavy=10),
                               window=1, spill_cost=None, segment=True),
    "segmented-int8": _packed(lambda: wide_window(m=1024, n=60000,
                                                  far_frac=0.05),
                              window=1, spill_cost=None, segment=True,
                              idx_fmt="int8"),
    "spill-remainder": _packed(lambda: triples(256, 256, 1200, 41,
                                               bandwidth=60),
                               window=1, spill_cost=12.0),
    "two-level": _two_levels,
    "levels-remainder": _remainder_levels,
}


def _levels(name, dtype):
    """(JAX host levels, the port's levels on the CPU, rows, columns)."""
    ref = _CONTAINERS[name](dtype)
    m, n = ref[0].shape
    return ref, tuple(convert.from_numpy(b, device=DEV) for b in ref), m, n


def _pallas(ref, X):
    """The JAX kernels' product over host levels, remainders included, for
    x (n,) or X (n, K), each level's x padded to its own width."""
    fn = JB.bell_matmat_pallas if X.ndim == 2 else JB.bell_matvec_pallas
    y = 0.0
    for b in ref:
        Xp = np.zeros((b.padded_shape[1],) + X.shape[1:], X.dtype)
        Xp[:X.shape[0]] = X
        y = y + np.asarray(fn(JB.bell_to_device(b), jnp.asarray(Xp),
                              interpret=True), np.float64)[:b.shape[0]]
    return y


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(_CONTAINERS))
def test_card_form_matches_container_and_pallas(name, dtype):
    ref, levels, m, n = _levels(name, dtype)
    card = S.sell_from_levels(levels, m)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(dtype)
    X = rng.standard_normal((n, 3)).astype(dtype)
    y = S.sell_matvec_plain(card, torch.from_numpy(x))
    Y = S.sell_matmat_plain(card, torch.from_numpy(X))
    assert y.shape == (m,) and Y.shape == (m, 3)
    assert y.dtype == Y.dtype == torch.from_numpy(x).dtype
    tol = TOL[dtype]
    assert rel(y, TB.bell_levels_matvec(levels, torch.from_numpy(x),
                                        m)) <= tol
    assert rel(Y, TB.bell_levels_matmat(levels, torch.from_numpy(X),
                                        m)) <= tol
    assert rel(y, _pallas(ref, x)) <= tol
    assert rel(Y, _pallas(ref, X)) <= tol
    # every column of the block product is the matvec on it, bit for bit
    for k in range(3):
        assert torch.equal(Y[:, k], S.sell_matvec_plain(
            card, torch.from_numpy(X[:, k].copy())))


@pytest.mark.parametrize("name", sorted(_CONTAINERS))
def test_card_form_holds_the_nonzeros_and_every_row(name):
    _, levels, m, _ = _levels(name, np.float64)
    card = S.sell_from_levels(levels, m)
    nonzeros = sum(int((b.data != 0).sum()) + int((b.sp_val != 0).sum())
                   for b in levels)
    assert int(card.row_len.sum()) == nonzeros
    assert int((card.vals != 0).sum()) == nonzeros
    # every output row has exactly one slot row
    assert torch.equal(torch.sort(card.row_idx.long()).values,
                       torch.arange(m))
    # slices of 32 slot rows, each as wide as its longest row
    nslices = card.slice_ptr.shape[0] - 1
    assert nslices == -(-m // S.SLICE)
    width = torch.zeros(nslices * S.SLICE, dtype=torch.int64)
    width[:m] = card.row_len
    assert torch.equal(torch.diff(card.slice_ptr),
                       S.SLICE * width.view(nslices, S.SLICE).amax(1))
    assert card.vals.shape == card.cols.shape == (int(card.slice_ptr[-1]),)
    assert card.cols.dtype == card.row_len.dtype == card.row_idx.dtype \
        == torch.int32 and card.slice_ptr.dtype == torch.int64
    assert S.sell_bytes(card) == card.vals.numel() * 12 + \
        card.slice_ptr.numel() * 8 + 8 * m


@pytest.mark.parametrize("sigma", [32, 256, 4096])
def test_sigma_sorts_rows_within_windows(sigma):
    # rows are sorted longest first within each window of sigma rows, so
    # a larger window stores fewer padding slots; the product is the same
    _, levels, m, n = _levels("segmented-mixed", np.float64)
    card = S.sell_from_levels(levels, m, sigma=sigma)
    ridx = card.row_idx.long()
    length = card.row_len.long()
    for w0 in range(0, m, sigma):
        assert torch.equal(torch.sort(ridx[w0:w0 + sigma]).values,
                           torch.arange(w0, min(m, w0 + sigma)))
        assert bool((length[w0:w0 + sigma].diff() <= 0).all())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    ref = TB.bell_levels_matvec(levels, x, m)
    assert rel(S.sell_matvec_plain(card, x), ref) <= 1e-12
    if sigma > 32:
        assert card.vals.numel() <= S.sell_from_levels(
            levels, m, sigma=sigma // 8).vals.numel()
    with pytest.raises(ValueError, match="multiple of 32"):
        S.sell_from_levels(levels, m, sigma=100)


@pytest.mark.parametrize("window", [1, 2])
def test_bf16_storage(window):
    # bf16 values, f32 x, f32 sums: the card form keeps the bf16 values
    t = triples(400, 400, 2500, 31, bandwidth=80)
    t16 = (np.asarray(t[0], dtype=ml_dtypes.bfloat16),) + t[1:]
    ref = JB.bell_from_coo(JF.coo_from_arrays(*t16, device=False),
                           spill_cost=None, window=window, device=False)
    b = convert.from_numpy(ref, device=DEV)
    card = S.sell_from_levels((b,), 400)
    assert card.vals.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    x = rng.standard_normal(400).astype(np.float32)
    X = rng.standard_normal((400, 4)).astype(np.float32)
    y = S.sell_matvec_plain(card, torch.from_numpy(x))
    Y = S.sell_matmat_plain(card, torch.from_numpy(X))
    assert y.dtype == Y.dtype == torch.float32
    exact = np.zeros((400, 400))
    np.add.at(exact, (t[1], t[2]), np.asarray(t16[0], np.float64))
    assert rel(y, exact @ x.astype(np.float64)) <= 1e-6
    assert rel(y, _pallas((ref,), x)) <= 1e-6
    for k in range(4):
        assert torch.equal(Y[:, k], S.sell_matvec_plain(
            card, torch.from_numpy(X[:, k].copy())))


def test_rows_without_entries_and_columns_outside_x():
    # an empty row gives 0; a column beyond x's end is skipped, so a
    # shorter x equals the product with x padded by zeros
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    rows = np.array([0, 0, 2, 5])
    cols = np.array([1, 7, 0, 3])
    b = TB.bell_from_coo(TB.F.coo_from_arrays(vals, rows, cols, (6, 8),
                                              device=None),
                         spill_cost=None, device=DEV)
    card = S.sell_from_levels((b,), 6)
    x = torch.arange(1.0, 9.0, dtype=torch.float64)
    assert S.sell_matvec_plain(card, x).tolist() == [18.0, 0.0, 3.0, 0.0,
                                                     0.0, 16.0]
    short = S.sell_matvec_plain(card, x[:5])
    assert short.tolist() == [2.0, 0.0, 3.0, 0.0, 0.0, 16.0]
    X = torch.stack([x, -x], dim=1)
    assert torch.equal(S.sell_matmat_plain(card, X)[:, 1],
                       -S.sell_matvec_plain(card, x))


def test_non_finite_x_follows_the_matrix():
    # the card form drops padding, so a NaN in x reaches only the rows
    # whose stored entries read it (the container's product also spreads
    # it through the padding slots that read it)
    t = triples(300, 300, 1500, 9, bandwidth=40)
    b = TB.bell_from_coo(TB.F.coo_from_arrays(*t, device=None),
                         spill_cost=None, device=DEV)
    card = S.sell_from_levels((b,), 300)
    x = np.random.default_rng(4).standard_normal(300)
    x[17] = np.nan
    y = S.sell_matvec_plain(card, torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isnan(y), np.isin(np.arange(300),
                                               t[1][t[2] == 17]))


_OPERATORS = {
    "split": (_square_with_heavy_rows, dict(split_rows="auto")),
    "permuted": (lambda: triples(900, 900, 5000, 4), dict(reorder=True)),
    "two-level": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
                  dict(window=2)),
}


@pytest.mark.parametrize("name", sorted(_OPERATORS))
def test_operator_products_go_through_the_card_form(name, monkeypatch):
    make, kw = _OPERATORS[name]
    t = make()
    m, n = t[3]
    calls = []
    for fn in ("sell_matvec", "sell_matmat"):
        real = getattr(TB, fn)
        monkeypatch.setattr(TB, fn, lambda c, v, real=real, fn=fn: (
            calls.append(fn), real(c, v))[1])
    A = TB.bell_operator(t, device=DEV, **kw)
    assert A.card is not None and A.card.rows_out == A.level_rows
    assert A.card_bytes == S.sell_bytes(A.card) < A.stream_bytes
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(n))
    X = torch.from_numpy(rng.standard_normal((n, 3)))
    yt = torch.from_numpy(rng.standard_normal(m))
    plain = A.plain()
    assert plain.card is None
    for got, want in ((A * x, plain * x), (A @ X, plain @ X),
                      (A.T * yt, plain.T * yt)):
        assert rel(got, want) <= 1e-12
    # the split's transpose is two products (L^T, Av^T): 5 in all
    fwd = ["sell_matvec", "sell_matmat"]
    assert calls == fwd + ["sell_matvec"] * (2 if A.split_rows else 1)
    if A.split_rows == 0 and A.solve_permutation is None:
        assert torch.equal(A * x, S.sell_matvec_plain(A.card, x))
    if A.solve_permutation is not None:
        inner = A.solve_permutation[2]
        assert inner.card is A.card


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    t = triples(300, 300, 1500, 9, bandwidth=40)
    b = TB.bell_from_coo(TB.F.coo_from_arrays(*t, device=None),
                         spill_cost=None, device=DEV)
    card = S.sell_from_levels((b,), 300)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300))
    X = torch.stack([x, 2 * x], dim=1)
    before = (S.SELL_LAUNCHES, S.SELL_MM_LAUNCHES)
    assert torch.equal(S.sell_matvec(card, x), S.sell_matvec_plain(card, x))
    assert torch.equal(S.sell_matmat(card, X), S.sell_matmat_plain(card, X))
    assert (S.SELL_LAUNCHES, S.SELL_MM_LAUNCHES) == before   # no kernel ran
    # a card form on another device is refused, not run on the CPU
    meta = S.SELL(*(a.to("meta") for a in card[:5]), *card[5:])
    with pytest.raises(ValueError, match="CUDA"):
        S.sell_matvec(meta, x)
    with pytest.raises(ValueError, match="CUDA"):
        S.sell_matmat(meta, X)
    with pytest.raises(ValueError, match=r"x \(n,\)"):
        S.sell_matvec(card, X)
    with pytest.raises(ValueError, match=r"X \(n, K\)"):
        S.sell_matmat(card, x)
