"""The port's BELL products against the JAX package's Pallas kernel.

The JAX package packs; ``convert`` carries its container into the port,
so both multiply by the same stored matrix.  The JAX product runs its
Pallas kernel in interpret mode, as ``tests/test_bell.py`` runs it; the
port's runs the container's plain torch product, and its operators run the
card form derived from the containers (``sell.py``; its plain version, the
wrappers' choice for CPU tensors).  Only summation order differs: f64
products agree to 1e-12 relative.  The operator tests cover the forward and
transpose products of window-1, two-level window-2, row-split,
RCM-permuted and COO-remainder containers."""

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

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dense(t):
    a = np.zeros(t[3])
    np.add.at(a, (t[1], t[2]), np.asarray(t[0], np.float64))
    return a


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def pallas(ref, x):
    """The JAX kernel's ``y = A x`` (interpret mode) on a host container."""
    xp = np.zeros(ref.padded_shape[1], x.dtype)
    xp[:len(x)] = x
    y = JB.bell_matvec_pallas(JB.bell_to_device(ref), jnp.asarray(xp),
                              interpret=True)
    return np.asarray(y)[:ref.shape[0]]


def port(ref, x):
    """The port's product over the converted container (CPU: the plain
    version), x unpadded."""
    b = convert.from_numpy(ref, device=DEV)
    return TB.bell_levels_matvec((b,), torch.from_numpy(x),
                                 ref.shape[0]).numpy()


_CONTAINERS = {
    # name: (triples, bell_from_coo options)
    "w1": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
           dict(window=1, spill_cost=None)),
    "w2": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
           dict(window=2, spill_cost=None)),
    "w2-rect": (lambda: triples(700, 300, 2500, 3),
                dict(window=2, spill_cost=None)),
    "segmented-mixed": (lambda: wide_window(far_frac=0.08, heavy=10),
                        dict(window=1, spill_cost=None, segment=True)),
    "segmented-int8": (lambda: wide_window(far_frac=0.05, heavy=6),
                       dict(window=1, spill_cost=None, segment=True,
                            idx_fmt="int8")),
    "spill-remainder": (lambda: triples(256, 256, 1200, 41, bandwidth=60),
                        dict(window=1, spill_cost=12.0)),
}


@pytest.mark.parametrize("name", sorted(_CONTAINERS))
def test_plain_matches_pallas(name):
    make, kw = _CONTAINERS[name]
    t = make()
    ref = JB.bell_from_coo(JF.coo_from_arrays(*t, device=False),
                           device=False, **kw)
    if name.startswith("segmented"):
        assert ref.seg is not None
    if name == "segmented-mixed":
        assert ref.seg_mixed > 0
    if name == "spill-remainder":
        assert ref.nnz_spill > 0
    x = np.random.default_rng(5).standard_normal(t[3][1])
    y = port(ref, x)
    assert rel(y, pallas(ref, x)) <= 1e-12
    assert rel(y, dense(t) @ x) <= 1e-12


def test_bf16_storage():
    # bf16 values, f32 x, f32 sums: against the f64 product of the rounded
    # values
    t = triples(400, 400, 2500, 31, bandwidth=80)
    v16 = np.asarray(t[0], dtype=ml_dtypes.bfloat16)
    t16 = (v16,) + t[1:]
    for window in (1, 2):
        ref = JB.bell_from_coo(JF.coo_from_arrays(*t16, device=False),
                               spill_cost=None, window=window, device=False)
        b = convert.from_numpy(ref, device=DEV)
        assert b.data.dtype == torch.bfloat16
        x = np.random.default_rng(3).standard_normal(400).astype(np.float32)
        y = TB.bell_matvec_plain(b, torch.from_numpy(x), 400)
        assert y.dtype == torch.float32
        exact = dense(t16) @ x.astype(np.float64)
        assert rel(y.numpy(), exact) <= 1e-6


def test_levels_accumulate_into_out():
    # a later level adds into the earlier one's y
    t = triples(1000, 1000, 8000, 1, bandwidth=90)
    c = JF.coo_from_arrays(*t, device=False)
    lv = JB._pack_levels(c, 16, 12.0, 2, device=False, window=2)
    x = np.random.default_rng(2).standard_normal(1000)
    levels = tuple(convert.from_numpy(b, device=DEV) for b in lv)
    y = TB.bell_levels_matvec(levels, torch.from_numpy(x), 1000).numpy()
    assert rel(y, dense(t) @ x) <= 1e-12
    out = torch.ones(1000, dtype=torch.float64)
    TB.bell_matvec_plain(levels[0], torch.from_numpy(x), 1000, out=out)
    first = TB.bell_matvec_plain(levels[0], torch.from_numpy(x), 1000)
    np.testing.assert_array_equal(out.numpy(), first.numpy() + 1.0)


def _square_with_heavy_rows(seed=3, m=4096, heavy=12):
    rng = np.random.default_rng(seed)
    deg = rng.integers(2, 6, m)
    deg[rng.integers(0, m, heavy)] = 300
    rows = np.repeat(np.arange(m), deg)
    cols = np.where(rng.random(rows.shape) < 0.2,
                    rng.integers(0, m, rows.shape),
                    np.clip(rows + rng.integers(-100, 101, rows.shape),
                            0, m - 1))
    vals = rng.standard_normal(rows.shape)
    key = rows.astype(np.int64) * m + cols
    _, first = np.unique(key, return_index=True)
    return vals[first], rows[first], cols[first], (m, m)


def _far_cluster():
    # ``tests/test_bell.py``'s multi-level case: a capped level 1 spills
    # clustered far entries; in a 16-band budget they stay its COO
    # remainder
    rng = np.random.default_rng(51)
    m, n = 256, 6400
    rows = np.repeat(np.arange(m), 4)
    cols = np.clip(rows + rng.integers(-6, 7, size=len(rows)), 0, m - 1)
    vals = rng.standard_normal(len(rows))
    rows = np.r_[rows, np.arange(10)]
    cols = np.r_[cols, 40 * 128 + np.arange(10)]
    vals = np.r_[vals, np.ones(10)]
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return vals[first], rows[first], cols[first], (m, n)


_OPERATORS = {
    "w1": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
           dict(window=1)),
    "w2-two-level": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
                     dict(window=2)),
    "split": (_square_with_heavy_rows, dict(split_rows="auto")),
    "permuted": (lambda: triples(900, 900, 5000, 4), dict(reorder=True)),
    "remainder": (_far_cluster, dict(nb_max=16, levels=2, window=1)),
}


@pytest.mark.parametrize("name", sorted(_OPERATORS))
def test_operator_matches_jax(name):
    make, kw = _OPERATORS[name]
    t = make()
    m, n = t[3]
    jop = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                           interpret=True, **kw)
    top = TB.bell_operator(t, device=DEV, **kw)
    assert top.fmt == "bell" and top.device.type == "cpu"
    assert top.split_rows == getattr(jop, "split_rows", 0)
    assert (top.solve_permutation is None) == \
        (getattr(jop, "solve_permutation", None) is None)
    assert len(top.levels) == len(jop._params[0])
    if name == "split":
        assert top.split_rows == 12
    if name == "w2-two-level":
        assert len(top.levels) == 2
    if name == "remainder":
        assert top.remainder > 0
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    a = dense(t)
    fwd = (top * torch.from_numpy(x)).numpy()
    bwd = (top.T * torch.from_numpy(y)).numpy()
    assert rel(fwd, np.asarray(jop * jnp.asarray(x))) <= 1e-12
    assert rel(bwd, np.asarray(jop.T * jnp.asarray(y))) <= 1e-12
    assert rel(fwd, a @ x) <= 1e-12 and rel(bwd, a.T @ y) <= 1e-12
    # the operator's plain twin, over the containers' own products, computes
    # the same products up to summation order (the card form adds a row's
    # products one by one, the container 4-row group sums): 1e-12 in f64
    plain = top.plain()
    assert rel((plain * torch.from_numpy(x)).numpy(), fwd) <= 1e-12


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    # the card form's wrapper runs its plain version for CPU tensors and
    # refuses any other device; the container's plain product checks rows
    t = triples(300, 300, 1500, 9, bandwidth=40)
    b = TB.bell_from_coo(TB.F.coo_from_arrays(*t, device=None),
                         spill_cost=None, device=DEV)
    card = S.sell_from_levels((b,), 300)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300))
    before = S.SELL_LAUNCHES
    np.testing.assert_array_equal(S.sell_matvec(card, x).numpy(),
                                  S.sell_matvec_plain(card, x).numpy())
    assert S.SELL_LAUNCHES == before   # no kernel ran
    # a card form on another device is refused, not run on the CPU
    meta = S.SELL(*(a.to("meta") for a in card[:5]), *card[5:])
    with pytest.raises(ValueError, match="CUDA"):
        S.sell_matvec(meta, x)
    with pytest.raises(ValueError, match="rows_out"):
        TB.bell_matvec_plain(b, x, 10 ** 6)
