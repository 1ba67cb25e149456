"""The port's BELL packer against the JAX package's, array for array.

Both packages plan in NumPy on the host, so the same COO triples must give
the same container: every array and every scalar equal, and the same
``SpanError`` where the window budget is exceeded.  The inputs follow
``tests/test_bell.py``: the packer knob space (window x spill x segment x
idx_fmt), segmented mixed packings, multi-level packings and row-split
plans."""

import itertools

import ml_dtypes
import numpy as np
import pytest

from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import formats as TF

def triples(m, n, nnz, seed, bandwidth=None, heavy_row=False):
    """Deduplicated random triples (``tests/test_bell.py``'s generator),
    optionally with one row of 150 entries."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=nnz)
    if bandwidth is None:
        cols = rng.integers(0, n, size=nnz)
    else:
        cols = np.clip(rows + rng.integers(-bandwidth, bandwidth + 1,
                                           size=nnz), 0, n - 1)
    vals = rng.standard_normal(nnz)
    if heavy_row:
        rows = np.concatenate([rows, np.full(150, rng.integers(0, m))])
        cols = np.concatenate([cols, rng.integers(0, n, 150)])
        vals = np.concatenate([vals, rng.standard_normal(150)])
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    return vals[first], rows[first], cols[first], (m, n)


def wide_window(m=2048, n=90000, far_frac=0.05, heavy=0, hot=None, seed=11):
    """Banded rows with a scattered tail (``tests/test_bell.py``'s
    ``_wide_window_coo``): spans beyond 256 bands, so the packer
    segments."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(3, 12, m)
    if heavy:
        deg[rng.integers(0, m, heavy)] = 300
    rows = np.repeat(np.arange(m), deg)
    if hot:
        hb = rng.integers(0, n // 128, hot)
        fc = hb[rng.integers(0, hot, rows.shape)] * 128 \
            + rng.integers(0, 128, rows.shape)
    else:
        fc = rng.integers(0, n, rows.shape)
    far = rng.random(rows.shape) < far_frac
    cols = np.where(far, fc, (rows * (n // m)
                              + rng.integers(-300, 301, rows.shape)) % n)
    vals = rng.standard_normal(rows.shape)
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    return vals[first], rows[first], cols[first], (m, n)


def coos(t):
    """The same triples as a JAX and a port host COO."""
    return (JF.coo_from_arrays(*t, device=False),
            TF.coo_from_arrays(*t, device=None))


def assert_same_bell(port, ref, msg=""):
    """Every field of the JAX container equals the port's."""
    for name in JB.BELL._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if b is None or a is None:
            assert a is None and b is None, (name, msg)
        elif isinstance(b, (tuple, int, str)):
            assert a == b, (name, a, b, msg)
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype, msg)
            np.testing.assert_array_equal(a, b, err_msg="%s %s" % (name, msg))
    assert port.grp_ptr is not None and port.grp_idx is not None


def pack_both(t, **kw):
    jc, tc = coos(t)
    try:
        ref = JB.bell_from_coo(jc, device=False, **kw)
    except JB.SpanError:
        with pytest.raises(TB.SpanError):
            TB.bell_from_coo(tc, device=None, **kw)
        return None, None
    return TB.bell_from_coo(tc, device=None, **kw), ref


_KNOBS = list(itertools.product((1, 2), (None, 12.0), (True, False),
                                ("packed", "int8")))


@pytest.mark.parametrize("seed", range(6))
def test_packer_matches_jax_over_the_knob_space(seed):
    rng = np.random.default_rng(1000 + seed)
    m = int(rng.integers(100, 1200))
    n = int(rng.integers(100, 40000))
    nnz = int(rng.integers(50, 4000))
    bw = None if rng.random() < 0.5 else int(rng.integers(30, 500))
    t = triples(m, n, nnz, seed + 7, bandwidth=bw,
                heavy_row=rng.random() < 0.3)
    packed = 0
    for w, sc, seg, fmt in _KNOBS:
        port, ref = pack_both(t, window=w, spill_cost=sc, segment=seg,
                              idx_fmt=fmt)
        if ref is None:
            continue
        packed += 1
        knobs = str((w, sc, seg, fmt))
        assert_same_bell(port, ref, knobs)
        if packed <= 2:   # the dense decoders are slow Python loops
            np.testing.assert_array_equal(TB.bell_to_dense(port),
                                          JB.bell_to_dense(ref),
                                          err_msg=knobs)
        assert TB.bell_fill(port) == JB.bell_fill(ref)
        assert TB.bell_stream_bytes(port) == JB.bell_stream_bytes(ref)
    assert packed


@pytest.mark.parametrize("far_frac,heavy,hot", [
    (0.002, 0, None),     # nearly all segments narrow
    (0.08, 10, None),     # mixed: a uniform tail forces wide sentinels
    (0.06, 0, 24),        # clustered tail (hot bands)
])
def test_segmented_packings_match_jax(far_frac, heavy, hot):
    t = wide_window(far_frac=far_frac, heavy=heavy, hot=hot)
    port, ref = pack_both(t, spill_cost=None, window=1, segment=True)
    assert ref.seg is not None and ref.nb > 256
    if heavy:
        assert ref.seg_mixed > 0
    assert_same_bell(port, ref)


@pytest.mark.parametrize("window", [1, 2, "auto"])
def test_levels_and_window_choice_match_jax(window):
    # depth-capped level 1 + uncapped level 2; "auto" plans both window
    # modes and keeps the cost model's pick
    t = wide_window(far_frac=0.08, heavy=8)
    jc, tc = coos(t)
    ref = JB._pack_levels(jc, 1024, 12.0, 2, device=False, window=window)
    port = TB._pack_levels(tc, 1024, 12.0, 2, device=None, window=window)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert_same_bell(p, r)


def test_spilled_levels_match_jax():
    # a small window budget leaves a COO remainder on the last level
    t = triples(1000, 1000, 8000, 1, bandwidth=None)
    jc, tc = coos(t)
    ref = JB._pack_levels(jc, 16, 12.0, 2, device=False, window=2)
    port = TB._pack_levels(tc, 16, 12.0, 2, device=None, window=2)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert_same_bell(p, r)


def test_row_split_plans_match_jax():
    rng = np.random.default_rng(3)
    m = n = 4096
    deg = rng.integers(2, 6, m)
    deg[rng.integers(0, m, 12)] = 300
    rows = np.repeat(np.arange(m), deg)
    cols = np.where(rng.random(rows.shape) < 0.2,
                    rng.integers(0, n, rows.shape),
                    np.clip(rows + rng.integers(-100, 101, rows.shape),
                            0, n - 1))
    vals = rng.standard_normal(rows.shape)
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    jc, tc = coos((vals[first], rows[first], cols[first], (m, n)))
    jsplit, tsplit = JB._row_split_plan(jc), TB._row_split_plan(tc)
    assert tsplit[2] == jsplit[2]
    np.testing.assert_array_equal(tsplit[1], jsplit[1])
    for f in ("data", "row", "col"):
        np.testing.assert_array_equal(getattr(tsplit[0], f),
                                      np.asarray(getattr(jsplit[0], f)))
    fwd_t = TB._pack_levels(tsplit[0], TB.NB_MAX, 12.0, 2, device=None,
                            window="auto")
    fwd_j = JB._pack_levels(jsplit[0], JB.NB_MAX, 12.0, 2, device=False,
                            window="auto")
    for p, r in zip(fwd_t, fwd_j):
        assert_same_bell(p, r)
    lt, la = TB._split_transpose_levels(tsplit[0], tsplit[2], TB.NB_MAX,
                                        12.0, 2, "auto", device=None)
    jl, ja = JB._split_transpose_levels(jsplit[0], jsplit[2], JB.NB_MAX,
                                        12.0, 2, "auto", "packed", True)
    for p, r in zip(lt + la, jl + ja):
        assert_same_bell(p, _host_bell(r))


def _host_bell(b):
    """A JAX container whose arrays may be device arrays, as NumPy."""
    return b._replace(**{f: None if getattr(b, f) is None
                         else np.asarray(getattr(b, f))
                         for f in ("data", "lanes", "bands", "blocks",
                                   "band_lo", "sp_row", "sp_col", "sp_val",
                                   "seg")})


def test_vectorized_planner_matches_loop_oracle():
    # the port's lockstep DP reproduces its per-block loop bit for bit
    for seed, (m, nnz, cw) in enumerate([(2048, 12000, 2048),
                                         (512, 40000, 512),
                                         (1024, 3000, 4096),
                                         (128, 50, 128), (256, 1, 999)]):
        rng = np.random.default_rng(seed)
        rows = np.sort(rng.integers(0, m, size=nnz).astype(np.int64))
        cols = np.clip((rows * cw // m) + rng.integers(-300, 301, nnz),
                       0, cw - 1)
        order = np.lexsort((cols, rows))
        rs, cs = rows[order], cols[order].astype(np.int64)
        bs = cs // 128
        nblocks = -(-m // 128)
        bounds = np.searchsorted(rs // 128, np.arange(nblocks + 1))
        for sc in (12.0, None, 640.0 / 7, 640.0 / 64, 1e9, 0.51):
            vec = TB._plan_blocks_py(rs, cs, bs, bounds, nblocks, sc)
            ref = TB._plan_blocks_loop(rs, cs, bs, bounds, nblocks, sc)
            jref = JB._plan_blocks_py(rs, cs, bs, bounds, nblocks, sc)
            for a, b, c in zip(vec, ref, jref):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def test_storage_knobs_and_rcm_match_jax():
    t = wide_window(far_frac=0.05, heavy=6)
    port, ref = pack_both(t, spill_cost=None, window=1, segment=True)
    assert_same_bell(TB.bell_with_idx_fmt(port, "int8"),
                     JB.bell_with_idx_fmt(ref, "int8"))
    assert_same_bell(TB.bell_with_idx_fmt(TB.bell_with_idx_fmt(
        port, "int8"), "packed"), ref)
    bf = ml_dtypes.bfloat16
    assert_same_bell(TB.bell_with_values_dtype(port, bf),
                     JB.bell_with_values_dtype(ref, bf))
    sq = triples(900, 900, 5000, 4)
    jc, tc = coos(sq)
    (jp, jperm), (tp, tperm) = JB.reorder_rcm(jc), TB.reorder_rcm(tc)
    np.testing.assert_array_equal(tperm, jperm)
    for f in ("data", "row", "col"):
        np.testing.assert_array_equal(getattr(tp, f),
                                      np.asarray(getattr(jp, f)))


def test_converted_container_carries_the_reference_arrays():
    # convert gives the port the JAX package's own container (plus the
    # kernel's group map), and the port's group map lists every non-dummy
    # 4-row group once, under its block, in ascending position
    t = wide_window(far_frac=0.08, heavy=10)
    port, ref = pack_both(t, spill_cost=12.0, window=1, segment=True)
    conv = convert.from_numpy(ref, device=None)
    assert_same_bell(conv, ref)
    np.testing.assert_array_equal(conv.grp_ptr, port.grp_ptr)
    np.testing.assert_array_equal(conv.grp_idx, port.grp_idx)
    nsteps, gq = port.blocks.shape[0], port.blocks.shape[2]
    g = np.arange(gq)
    stored = g // 2 + (g % 2) * (gq - gq // 2)   # natural -> stored order
    for st in range(nsteps):
        for blk in range(port.nblk):
            p = st * port.nblk + blk
            groups = port.grp_idx[port.grp_ptr[p]:port.grp_ptr[p + 1]]
            assert (np.diff(groups) > 0).all()
            np.testing.assert_array_equal(
                np.flatnonzero(port.blocks[st, 0, stored] == blk), groups)
    assert port.grp_ptr[-1] == int((port.blocks < port.nblk).sum())
