"""The tensor-core probes' plain versions on the CPU, against the JAX side.

``pykrylov_tpu_torch.probes.onehot_mma`` and ``.bell_mma`` port the last
two TPU kernels of ``tools/probes/``.  Their CUDA kernels run only on the
card (``tests/test_torch_probes_mma_card.py``, ``chip_smoke.py`` phase 23);
here the wrappers run their plain versions, which are held against:

* ``onehot_select``: the probe's own ``k_int8`` and ``k_bf16``
  (``probe_int8_mxu.py``, imported by its path; it needs no TPU) in a
  ``pallas_call`` in interpret mode.  ``int8`` bit for bit on normals, -0,
  subnormals, infinities and NaN payloads; ``bf16x3`` bit for bit on
  normals, -0, infinities and NaN (a column holding an inf or a NaN is NaN
  in every row on both sides, any payload); subnormals under ``bf16x3``
  apart, each side's result asserted.
* ``bell_step_mma``: the body of ``probe_ablate_r3b.py``'s ``make_kernel``
  (the probe asserts a TPU and packs a 1M-row matrix at import) copied into
  an interpret-mode ``pallas_call`` without its DMAs, the x windows passed
  as an (nsteps, nb, 128) input, with the JAX package's ``_dot_onehot``
  and a copy of the probe's ``hi_dot``; on window-1 containers of
  ``tiled_general_coo(tiles=2-4)``, packed by the JAX package and carried
  across by ``convert`` (equal, array for array, to the port's packing).
  With integer data in [-8, 8] every sum is exact and every one of the
  probe's nine configurations is bit for bit the Pallas body; with
  standard-normal data and x each is within 1e-6 of its row's sum of
  |terms|.  The card's controls (``"load"``, ``"add"``) equal the Pallas
  body of the configuration they stand in for on integer data, and
  ``load``/``tile``/``add`` is ``bell_matvec_plain``.
"""

import functools
import importlib.util
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.bell import _dot_onehot

import chip_smoke
from pykrylov_tpu_torch import convert, probes
from pykrylov_tpu_torch.gallery import tiled_general_coo
from pykrylov_tpu_torch.probes import bell_mma as BM
from pykrylov_tpu_torch.probes import onehot_mma as OM
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F

REPO = pathlib.Path(__file__).resolve().parents[1]
DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# onehot_select
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_mxu", REPO / "tools" / "probes" / "probe_int8_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_probe(probe, kernel, oh, w):
    """The probe's kernel in interpret mode on numpy oh and w."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((oh.shape[0], w.shape[1]),
                                               jnp.float32),
        interpret=True)(jnp.asarray(oh), jnp.asarray(w)))


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def patterns(gs, nb, specials, seed):
    """chip_smoke's one-hot (gs, nb) oh and (nb, 128) w, as numpy, with the
    patterns of the kinds ``specials`` placed in rows the one-hot picks
    (every row where gs >= nb)."""
    oh, w = chip_smoke.probe_select_inputs(gs, nb, 128, seed, specials,
                                           device=DEV)
    return oh.numpy(), w.numpy()


@pytest.mark.parametrize("gs,nb", [(128, 64), (1024, 256)])
def test_int8_is_the_probe_bit_for_bit(int8_probe, gs, nb):
    oh, w = patterns(gs, nb, chip_smoke.SELECT_SPECIALS, gs)
    ref = run_probe(int8_probe, int8_probe.k_int8, oh, w)
    port = OM.onehot_select(torch.from_numpy(oh), torch.from_numpy(w),
                            "int8")
    np.testing.assert_array_equal(bits(port), bits(ref))
    # w[argmax], every pattern included
    np.testing.assert_array_equal(bits(port), bits(w[oh.argmax(1)]))


@pytest.mark.parametrize("gs,nb", [(128, 64), (1024, 256)])
def test_bf16x3_is_the_probe_bit_for_bit(int8_probe, gs, nb):
    oh, w = patterns(gs, nb, ["-0", "inf", "nan"], gs + 1)
    ref = run_probe(int8_probe, int8_probe.k_bf16, oh, w)
    port = OM.onehot_select(torch.from_numpy(oh), torch.from_numpy(w),
                            "bf16x3").numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(port), nan)
    np.testing.assert_array_equal(bits(port)[~nan], bits(ref)[~nan])
    # the NaN columns: every column of w holding an inf or a NaN
    bad = ~np.isfinite(w).all(0)
    assert bad.sum() == 6
    np.testing.assert_array_equal(nan, np.broadcast_to(bad, nan.shape))
    # every finite column is w[argmax], -0 as +0
    sel = w[oh.argmax(1)]
    np.testing.assert_array_equal(port[:, ~bad], sel[:, ~bad] + 0.0)
    assert (bits(port[:, ~bad]) != 0x80000000).all()


def test_bf16x3_subnormals(int8_probe):
    oh, w = patterns(128, 64, ["subnormal"], 5)
    port = OM.onehot_select(torch.from_numpy(oh), torch.from_numpy(w),
                            "bf16x3").numpy()
    ref = run_probe(int8_probe, int8_probe.k_bf16, oh, w)
    sel = w[oh.argmax(1)]
    sub = (bits(sel) & 0x7F800000) == 0
    sub &= (bits(sel) & 0x7FFFFF) != 0
    assert sub.any()
    np.testing.assert_array_equal(bits(port)[~sub], bits(ref)[~sub])
    # the port: the three bf16 pieces of each subnormal summed.  bf16's
    # subnormals are the multiples of 2**-133, so 2**-149 goes to 0,
    # 0x12345 (bits) to 0x10000 and -0x7FFFFF to -2**-126, a normal
    pieces = OM.bf16_pieces(torch.from_numpy(sel[sub]))
    np.testing.assert_array_equal(port[sub],
                                  ((pieces[0] + pieces[1]) + pieces[2]))
    got = dict(zip(bits(sel[sub]).tolist(), bits(port[sub]).tolist()))
    assert got == {0x00000001: 0, 0x00012345: 0x00010000,
                   0x807FFFFF: 0x80800000}
    # XLA's CPU flushes them to 0 (where it did not, it would agree)
    assert ((ref[sub] == 0) | (ref[sub] == port[sub])).all()


def test_onehot_rows_is_the_dense_product():
    rng = np.random.default_rng(2)
    p = rng.standard_normal((16, 8)).astype(np.float32)
    p[3, 2], p[5, 4], p[5, 6] = np.inf, np.nan, -np.inf
    base = np.array([3, 5, 0, -1, 15, 16, 5])
    e = (base[:, None] == np.arange(16)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        dense = (e[:, :, None] * p.astype(np.float64)[None]).sum(1)
    got = OM.onehot_rows(torch.from_numpy(p), torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), dense.astype(np.float32))


def test_tf32_pieces():
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    pieces = BM.tf32_pieces(v)
    for p in pieces:
        assert (p.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.equal((pieces[0] + pieces[1]) + pieces[2], v)
    # nearest, ties away from zero
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                         1 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert OM._tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                       1 + 2 * 2.0 ** -10]


@pytest.mark.parametrize("mode", sorted(OM.MODES))
def test_onehot_select_on_uint8_and_no_launch(mode):
    probes.reset_counts()
    oh, w = patterns(64, 32, [], 9)
    a = OM.onehot_select(torch.from_numpy(oh), torch.from_numpy(w), mode)
    b = OM.onehot_select(torch.from_numpy(oh.astype(np.uint8)),
                         torch.from_numpy(w), mode)
    assert torch.equal(a, b)
    assert torch.equal(a, torch.from_numpy(w[oh.argmax(1)]))
    assert probes.counts()["probe_onehot_mma"] == 0


@pytest.mark.parametrize("oh,w,mode,err,match", [
    (torch.zeros(64, 32, dtype=torch.bool), torch.zeros(32, 128), "int4",
     ValueError, "mode"),
    (torch.zeros(64, 32, dtype=torch.bool), torch.zeros(32, 128).double(),
     "int8", TypeError, "f32"),
    (torch.zeros(64, 32), torch.zeros(32, 128), "int8", TypeError, "bool"),
    (torch.zeros(64, 32, dtype=torch.bool), torch.zeros(31, 128), "int8",
     ValueError, "expects"),
    (torch.zeros(80, 32, dtype=torch.bool), torch.zeros(32, 128), "int8",
     ValueError, "tiles"),
    (torch.zeros(64, 48, dtype=torch.bool), torch.zeros(48, 128), "bf16x3",
     ValueError, "tiles"),
    (torch.zeros(64, 32, dtype=torch.bool), torch.zeros(32, 80), "int8",
     ValueError, "tiles"),
    (torch.zeros(64, 1568, dtype=torch.bool), torch.zeros(1568, 32), "int8",
     ValueError, "tiles"),
    (torch.zeros(64, 32, dtype=torch.bool), torch.zeros(128, 32).t(),
     "int8", ValueError, "contiguous"),
])
def test_onehot_select_refuses(oh, w, mode, err, match):
    with pytest.raises(err, match=match):
        OM.onehot_select(oh, w, mode)


# --------------------------------------------------------------------------
# bell_step_mma
# --------------------------------------------------------------------------

def hi_dot(oh, v, transposed=False):
    # probe_ablate_r3b.py:42-46
    dims = ((((0,) if transposed else (1,)), (0,)), ((), ()))
    return jax.lax.dot_general(oh.astype(v.dtype), v, dims,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=v.dtype)


def make_body(nb, nblk, GS, *, stage="bf16", fold="tile", scatter="bf16",
              nseg=1):
    """probe_ablate_r3b.py:49-160 without the DMAs: the step's values,
    lanes and x window come in as blocks."""
    LANES = 128

    def kernel(data_ref, lanes_ref, bands_ref, blocks_ref, win_ref, y_ref):
        GQ = GS // 4
        w = win_ref[0]
        dat = data_ref[0]
        p = lanes_ref[0]
        base = bands_ref[0]

        if nseg == 1:
            iot = jax.lax.broadcasted_iota(jnp.int32, (nb, GS), 0)
            oh = iot == base
            if stage == "bf16":
                xsel = _dot_onehot(oh, w, 3, transposed=True)
            else:
                xsel = hi_dot(oh, w, transposed=True)
        else:
            gseg = GS // nseg
            nbs = max(8, nb // nseg)
            parts = []
            for s in range(nseg):
                iot = jax.lax.broadcasted_iota(jnp.int32, (nbs, gseg), 0)
                ohs = iot == base[:, s * gseg:(s + 1) * gseg]
                ws = w[:nbs]
                parts.append(hi_dot(ohs, ws, transposed=True)
                             if stage == "f32" else
                             _dot_onehot(ohs, ws, 3, transposed=True))
            xsel = jnp.concatenate(parts, axis=0)

        idx = jnp.concatenate(
            [(p >> (8 * j)) & 255 for j in range(4)], axis=0)
        vals_ = jnp.take_along_axis(xsel, idx, axis=1)
        prod = dat.astype(vals_.dtype) * vals_

        if fold == "tile":
            s8 = prod.reshape(GS // 8, 8, LANES)
            ps = jnp.concatenate([s8[:, :4, :].sum(axis=1),
                                  s8[:, 4:, :].sum(axis=1)], axis=0)
        else:
            h = prod[:GS // 2] + prod[GS // 2:]
            ps = h[:GS // 4] + h[GS // 4:]

        ohY = (jax.lax.broadcasted_iota(jnp.int32, (nblk, GQ), 0)
               == blocks_ref[0])
        if scatter == "bf16":
            y_ref[:] = _dot_onehot(ohY, ps, 3)
        else:
            y_ref[:] = hi_dot(ohY, ps)
    return kernel


@functools.lru_cache(maxsize=None)
def pallas_call(nsteps, GS, nb, nblk, stage, fold, scatter, nseg):
    """The copied body in an interpret-mode ``pallas_call``, jitted: one
    compile for every container of these shapes."""
    L = 128
    return jax.jit(pl.pallas_call(
        make_body(nb, nblk, GS, stage=stage, fold=fold, scatter=scatter,
                  nseg=nseg),
        grid=(nsteps,),
        in_specs=[pl.BlockSpec((1, GS, L), lambda s: (s, 0, 0)),
                  pl.BlockSpec((1, GS // 4, L), lambda s: (s, 0, 0)),
                  pl.BlockSpec((1, 1, GS), lambda s: (s, 0, 0)),
                  pl.BlockSpec((1, 1, GS // 4), lambda s: (s, 0, 0)),
                  pl.BlockSpec((1, nb, L), lambda s: (s, 0, 0))],
        out_specs=pl.BlockSpec((nblk, L), lambda s: (s, 0)),
        out_shape=jax.ShapeDtypeStruct((nsteps * nblk, L), jnp.float32),
        interpret=True))


def pallas_step(jb, x, stage, fold, scatter, nseg):
    """The copied body over a JAX container and numpy x (f32, padded to
    the container's width as the probe's x2): (nsteps * nblk * 128,)."""
    nsteps, GS, L = jb.data.shape
    nb = jb.nb
    xp = np.zeros(jb.padded_shape[1], np.float32)
    xp[:len(x)] = x
    band_lo = np.asarray(jb.band_lo)
    win = np.stack([xp.reshape(-1, L)[lo:lo + nb] for lo in band_lo])
    call = pallas_call(nsteps, GS, nb, jb.nblk, stage, fold, scatter, nseg)
    return np.asarray(call(jb.data, jb.lanes, jb.bands, jb.blocks,
                           jnp.asarray(win))).reshape(-1)


def tiled_coo(tiles, data, seed):
    """``tiled_general_coo(tiles)``'s pattern with integer values in [-8,
    8] (``"int"``), or standard normal ones (``"normal"``)."""
    vals, rows, cols, shape = tiled_general_coo(tiles=tiles)
    rng = np.random.default_rng(seed)
    if data == "int":
        vals = (rng.integers(1, 9, len(vals))
                * rng.choice([-1, 1], len(vals))).astype(np.float32)
    else:
        vals = rng.standard_normal(len(vals)).astype(np.float32)
    return vals, rows, cols, shape


def make_x(n, data, seed):
    rng = np.random.default_rng(seed)
    if data == "int":
        return rng.integers(-8, 9, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def carried(tiles, data, values):
    """(JAX container, port container) of the window-1 packing, the port's
    carried across by ``convert``, both with ``values`` storage."""
    vals, rows, cols, shape = tiled_coo(tiles, data, tiles)
    jb = JB.bell_from_coo(JF.coo_from_arrays(vals, rows, cols, shape),
                          spill_cost=None, device=False, window=1)
    if values == "bf16":
        jb = JB.bell_with_values_dtype(jb, ml_dtypes.bfloat16)
    return jb, convert.from_numpy(jb, device=DEV)


@pytest.mark.parametrize("tiles", [2, 3, 4])
def test_jax_packing_is_the_ports(tiles):
    vals, rows, cols, shape = tiled_coo(tiles, "normal", tiles)
    jb, pb = carried(tiles, "normal", "f32")
    own = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                            device=None),
                          spill_cost=None, device=DEV, window=1)
    for name in ("data", "lanes", "bands", "blocks", "band_lo", "grp_ptr",
                 "grp_idx"):
        assert torch.equal(getattr(own, name), getattr(pb, name)), name
    assert (own.nb, own.nblk, own.window, own.idx_fmt, own.seg) == \
        (pb.nb, pb.nblk, 1, "packed", None)


def sum_abs(b, x, fold):
    """Each output row's sum of |terms| under the fold's pairing."""
    return BM.bell_step_mma_plain(b._replace(data=b.data.abs()), x.abs(),
                                  "load", fold, "add")


def test_group_and_block_sums(small):
    b, x = small
    for fold in BM.FOLDS:
        ps = BM.bell_group_sums(b, x, "f32", fold, 4)
        assert ps.shape == (1, b.data.shape[1] // 4, 128)
        for scatter in BM.SCATTERS:
            assert torch.equal(BM.bell_block_sums(b, ps, scatter),
                               BM.bell_step_mma_plain(b, x, "f32", fold,
                                                      scatter, 4))
    with pytest.raises(ValueError, match="scatter"):
        BM.bell_block_sums(b, ps, "dma")


@pytest.mark.parametrize("tiles", [2, 4])
@pytest.mark.parametrize("data", ["int", "normal"])
@pytest.mark.parametrize("config", BM.PROBE_CONFIGS, ids=lambda c: c[0])
def test_probe_configs_are_the_pallas_body(config, data, tiles):
    label, values, stage, fold, scatter, nseg = config
    jb, pb = carried(tiles, data, values)
    x = make_x(pb.shape[1], data, tiles + 1)
    ref = pallas_step(jb, x, stage, fold, scatter, nseg)
    xt = torch.from_numpy(x)
    port = BM.bell_step_mma(pb, xt, stage, fold, scatter, nseg).numpy()
    assert port.shape == ref.shape == (pb.padded_shape[0],)
    if data == "int":
        np.testing.assert_array_equal(port, ref)
    else:
        tol = 1e-6 * sum_abs(pb, xt, fold).numpy()
        assert (np.abs(port - ref) <= tol).all(), label


@pytest.mark.parametrize("control", BM.CONTROLS, ids=lambda c: c[0])
def test_controls_on_integer_data(control):
    # staging and scatter are exact on integer data, so a control equals
    # the Pallas body of the mma configuration it stands in for
    label, values, stage, fold, scatter, nseg = control
    jb, pb = carried(3, "int", values)
    x = make_x(pb.shape[1], "int", 7)
    ref = pallas_step(jb, x, "bf16", fold, "bf16", nseg)
    port = BM.bell_step_mma(pb, torch.from_numpy(x), stage, fold, scatter,
                            nseg)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("tiles", [2, 16])
def test_load_tile_add_is_the_slot_product(tiles, values):
    _, pb = carried(tiles, "normal", values)
    x = torch.from_numpy(make_x(pb.shape[1], "normal", 3))
    y = BM.bell_step_mma(pb, x, "load", "tile", "add")
    assert torch.equal(y, B.bell_matvec_plain(pb, x))
    # a short x: the columns past it read 0
    y = BM.bell_step_mma(pb, x[:-300].contiguous(), "load", "tile", "add")
    assert torch.equal(y, B.bell_matvec_plain(pb, x[:-300]))


def test_every_combination_on_integer_data():
    # every staging and scatter is exact here: each fold's combinations
    # all give one y, and nseg=4 the y of the rows its segments select
    _, pb = carried(16, "int", "f32")   # two steps, the second clamped
    assert pb.data.shape[0] == 2
    x = torch.from_numpy(make_x(pb.shape[1], "int", 5))
    for fold in BM.FOLDS:
        for nseg in BM.NSEGS:
            ys = {(st, sc): BM.bell_step_mma(pb, x, st, fold, sc, nseg)
                  for st in BM.STAGES for sc in BM.SCATTERS}
            first = next(iter(ys.values()))
            for key, y in ys.items():
                assert torch.equal(y, first), (fold, nseg, key)


def test_seg4_selects_the_first_bands():
    _, pb = carried(16, "int", "f32")
    kb = BM.contraction_bands(pb, 4)
    assert kb == max(8, pb.nb // 4) < pb.nb
    x = torch.from_numpy(make_x(pb.shape[1], "int", 6))
    # nseg=4 is the full product of the container with the rows whose band
    # is kb or more emptied
    bands = pb.bands.reshape(pb.data.shape[0], -1)
    cut = pb._replace(data=torch.where((bands < kb)[:, :, None], pb.data,
                                       torch.zeros((), dtype=pb.data.dtype)))
    for fold in BM.FOLDS:
        assert torch.equal(BM.bell_step_mma(pb, x, "load", fold, "add", 4),
                           BM.bell_step_mma(cut, x, "load", fold, "add"))


def test_bell_step_mma_launches_nothing_on_the_cpu():
    probes.reset_counts()
    _, pb = carried(2, "normal", "f32")
    x = torch.from_numpy(make_x(pb.shape[1], "normal", 1))
    for stage in BM.STAGES:
        BM.bell_step_mma(pb, x, stage, "halves", "f32", 4)
    assert probes.counts() == dict.fromkeys(
        ["probe_stream", "probe_dia_ring", "probe_sell_ablation",
         "probe_onehot_mma", "probe_bell_mma"], 0)


@pytest.fixture(scope="module")
def small():
    _, pb = carried(2, "normal", "f32")
    x = torch.from_numpy(make_x(pb.shape[1], "normal", 1))
    return pb, x


@pytest.mark.parametrize("change,kw,err,match", [
    (lambda b, x: (b._replace(window=2), x), {}, ValueError, "window-1"),
    (lambda b, x: (b._replace(seg=torch.zeros(1, 2, dtype=torch.int32)), x),
     {}, ValueError, "segments"),
    (lambda b, x: (B.bell_with_idx_fmt(b, "int8"), x), {}, ValueError,
     "packed"),
    (lambda b, x: (b._replace(data=b.data.double()), x), {}, TypeError,
     "f32 or bf16"),
    (lambda b, x: (b, x.double()), {}, TypeError, "f32 x"),
    (lambda b, x: (b._replace(bands=b.bands.long()), x), {}, TypeError,
     "int32"),
    (lambda b, x: (b, torch.stack([x, x], 1)[:, 0]), {}, ValueError,
     "contiguous"),
    (lambda b, x: (b._replace(lanes=b.lanes.transpose(1, 2)), x), {},
     ValueError, "contiguous"),
    (lambda b, x: (b, x), {"stage": "int8"}, ValueError, "stage"),
    (lambda b, x: (b, x), {"fold": "tree"}, ValueError, "fold"),
    (lambda b, x: (b, x), {"scatter": "dma"}, ValueError, "scatter"),
    (lambda b, x: (b, x), {"nseg": 2}, ValueError, "nseg"),
])
def test_bell_step_mma_refuses(small, change, kw, err, match):
    b, x = change(*small)
    probes.reset_counts()
    with pytest.raises(err, match=match):
        BM.bell_step_mma(b, x, **kw)
    assert probes.counts()["probe_bell_mma"] == 0


def test_bytes_and_flops_at_a_small_size(small):
    b, x = small
    nsteps, gs, _ = b.data.shape
    fixed = (nsteps * gs * 128 * 5 + 4 * nsteps * gs + 4 * nsteps * gs // 4
             + 4 * (b.grp_ptr.numel() + b.grp_idx.numel()) + 4 * nsteps
             + 4 * nsteps * b.nblk * 128)
    assert BM.bell_mma_bytes(b, x.shape[0]) == (
        fixed + 4 * min(x.shape[0], b.nb * 128))
    # nseg 4 reads only the contraction's bands of each window
    kb = BM.contraction_bands(b, 4)
    assert BM.bell_mma_bytes(b, x.shape[0], 4) == (
        fixed + 4 * min(x.shape[0], kb * 128))
    assert BM.bell_mma_flops(b, "load", "add") == {}
    # the scatter: each group sum into its block's m-tile of TILE_BLOCKS
    # output blocks, the kernel's kTileBlocks
    src = (REPO / "pykrylov_tpu_torch" / "csrc" / "probe_bell_mma.cu"
           ).read_text()
    assert "constexpr int kTileBlocks = %d;" % BM.TILE_BLOCKS in src
    assert BM.bell_mma_flops(b, "bf16", "f32", 4) == {
        "bf16": 6 * nsteps * gs * kb * 128,
        "tf32": 6 * nsteps * BM.TILE_BLOCKS * gs // 4 * 128}
