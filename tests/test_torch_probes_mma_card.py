"""The tensor-core probe kernels against their plain versions on an NVIDIA
GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_probes_mma_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``; the select
inputs and the mma scatters' bound are ``chip_smoke.py``'s.)

* ``onehot_select`` in both modes at the probe's (1024, 256, 128) and a
  small shape, bit for bit its plain version on normals, -0, subnormals,
  infinities and NaN payloads (``bf16x3``: NaN where the plain version is
  NaN, any payload);
* ``bell_step_mma``, every combination with the ``"add"`` scatter, f32 and
  bf16 values, nseg 1 and 4: bit for bit its plain version (every staging
  is exact on a finite window and the adds follow the plain order), and
  ``load``/``tile``/``add`` within 1e-6 (relative) of the container's
  ``bell_matvec_plain``, whose ``index_add_`` has no fixed order here; with
  an mma scatter within 2**-20 of each row's sum of |group sums| (the
  tensor cores sum a block's groups in their own order), the largest
  error printed; on integer data every combination bit for bit;
* each wrapper raises on what its kernel does not take and on a non-zero
  launch status, and launches (its counter moves) for CUDA tensors.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from pykrylov_tpu_torch import probes
from pykrylov_tpu_torch.gallery import tiled_general_coo
from pykrylov_tpu_torch.probes import bell_mma as BM
from pykrylov_tpu_torch.probes import onehot_mma as OM
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F

CONTAINER_BOUND = 1e-6   # against bell_matvec_plain, relative (f32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the probe kernels have no CPU "
                    "mode)")
    return "cuda"


def bits(t):
    return t.view(torch.int32)


# --------------------------------------------------------------------------
# onehot_select
# --------------------------------------------------------------------------

def patterns(gs, nb, specials, seed):
    """chip_smoke's one-hot (gs, nb) bool oh and standard-normal (nb, 128)
    f32 w, on the CPU, with the patterns of the kinds ``specials`` placed
    in columns of their own."""
    return cs.probe_select_inputs(gs, nb, 128, seed, specials, device="cpu")


def select_once(oh, w, mode):
    before = OM.ONEHOT_LAUNCHES
    y = OM.onehot_select(oh, w, mode)
    torch.cuda.synchronize()
    assert OM.ONEHOT_LAUNCHES == before + 1
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("gs,nb", [(64, 32), (1024, 256), (512, 96),
                                   (128, 1536)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_int8_every_pattern(card, gs, nb, dtype):
    oh, w = patterns(gs, nb, cs.SELECT_SPECIALS, gs + nb)
    oh = oh.to(dtype)
    y = select_once(oh.to(card), w.to(card), "int8")
    ref = OM.onehot_select_plain(oh, w, "int8")
    assert torch.equal(bits(y.cpu()), bits(ref))
    assert torch.equal(bits(ref), bits(w[oh.to(torch.uint8).argmax(1)]))


@pytest.mark.cuda
@pytest.mark.parametrize("gs,nb", [(64, 32), (1024, 256), (512, 96)])
@pytest.mark.parametrize("specials", ["normal", "-0, inf, NaN",
                                      "subnormal"])
def test_bf16x3_patterns(card, gs, nb, specials):
    chosen = {"normal": (), "-0, inf, NaN": ("-0", "inf", "nan"),
              "subnormal": ("subnormal",)}[specials]
    oh, w = patterns(gs, nb, chosen, gs + nb + 1)
    y = select_once(oh.to(card), w.to(card), "bf16x3").cpu()
    ref = OM.onehot_select_plain(oh, w, "bf16x3")
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(y), nan)
    assert torch.equal(bits(y)[~nan], bits(ref)[~nan])
    if specials == "-0, inf, NaN":
        assert nan.any(0).sum() == 6


@pytest.mark.cuda
def test_onehot_rows_past_the_first_one(card):
    # rows with no 1 select column 0; rows with several their first; a
    # uint8 row its first largest byte
    oh = torch.zeros(64, 32, dtype=torch.uint8)
    oh[1, [4, 9]] = 1
    oh[2, [3, 8]] = torch.tensor([1, 5], dtype=torch.uint8)
    oh[3, 31] = 255
    w = torch.randn(32, 128)
    for mode in OM.MODES:
        y = select_once(oh.to(card), w.to(card), mode).cpu()
        assert torch.equal(y, OM.onehot_select_plain(oh, w, mode))
    assert torch.equal(y[:4], w[[0, 4, 8, 31]])


@pytest.mark.cuda
def test_onehot_select_refuses(card, monkeypatch):
    oh, w = patterns(64, 32, (), 0)
    oh, w = oh.to(card), w.to(card)
    with pytest.raises(ValueError, match="CUDA device"):
        OM.onehot_select(oh, w.cpu())
    with pytest.raises(ValueError, match="tiles"):
        OM.onehot_select(oh[:48], w)
    with pytest.raises(ValueError, match="tiles"):
        OM.onehot_select(oh.new_zeros(64, 1568), w.new_zeros(1568, 128))
    monkeypatch.setattr(OM, "_entry", lambda: lambda *args: 9)
    before = OM.ONEHOT_LAUNCHES
    for mode in OM.MODES:
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            OM.onehot_select(oh, w, mode)
    assert OM.ONEHOT_LAUNCHES == before


# --------------------------------------------------------------------------
# bell_step_mma
# --------------------------------------------------------------------------

def container(tiles, data, values, device):
    """The window-1 packing of ``tiled_general_coo(tiles)``'s pattern with
    standard-normal (``"normal"``) or integer values in [-8, 8]."""
    vals, rows, cols, shape = tiled_general_coo(tiles=tiles)
    rng = np.random.default_rng(tiles)
    if data == "int":
        vals = (rng.integers(1, 9, len(vals))
                * rng.choice([-1, 1], len(vals))).astype(np.float32)
    else:
        vals = rng.standard_normal(len(vals)).astype(np.float32)
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                          device=None),
                        spill_cost=None, device=device, window=1)
    return B.bell_with_values_dtype(b, torch.bfloat16 if values == "bf16"
                                    else torch.float32)


def make_x(n, data, seed, device):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, n) if data == "int"
         else rng.standard_normal(n)).astype(np.float32)
    return torch.from_numpy(x).to(device)


# 2 tiles: one step of 16 blocks; 64: 8 steps of 88 blocks (six
# 16-block tiles a step, the last short), the last window clamped
TILES = (2, 64)


@pytest.fixture(scope="module")
def forms():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the probe kernels have no CPU "
                    "mode)")
    return {(t, d, v): container(t, d, v, "cuda") for t in TILES
            for d in ("normal", "int") for v in ("f32", "bf16")}


def step_once(b, x, *args):
    before = BM.BELL_MMA_LAUNCHES
    y = BM.bell_step_mma(b, x, *args)
    torch.cuda.synchronize()
    assert BM.BELL_MMA_LAUNCHES == before + 1
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("stage", sorted(BM.STAGES))
@pytest.mark.parametrize("fold", sorted(BM.FOLDS))
@pytest.mark.parametrize("nseg", BM.NSEGS)
def test_add_scatter_bit_for_bit(card, forms, tiles, values, stage, fold,
                                 nseg):
    b = forms[tiles, "normal", values]
    x = make_x(b.shape[1], "normal", tiles, card)
    y = step_once(b, x, stage, fold, "add", nseg)
    assert torch.equal(y, BM.bell_step_mma_plain(b, x, stage, fold, "add",
                                                 nseg))
    if (stage, fold, nseg) == ("load", "tile", 1):
        # the container's own product: its index_add_ sums a block's
        # groups in no fixed order on the card
        ref = B.bell_matvec_plain(b, x)
        assert (y - ref).abs().max() <= CONTAINER_BOUND * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("stage", sorted(BM.STAGES))
@pytest.mark.parametrize("fold", sorted(BM.FOLDS))
@pytest.mark.parametrize("scatter", ["bf16", "f32"])
@pytest.mark.parametrize("nseg", BM.NSEGS)
def test_mma_scatter_within_bound(card, forms, tiles, values, stage, fold,
                                  scatter, nseg):
    b = forms[tiles, "normal", values]
    x = make_x(b.shape[1], "normal", tiles, card)
    y = step_once(b, x, stage, fold, scatter, nseg)
    ps = BM.bell_group_sums(b, x, stage, fold, nseg)
    ref = BM.bell_block_sums(b, ps, scatter)
    scale = BM.bell_block_sums(b, ps.abs())
    err = (y - ref).abs()
    worst = (err / scale.clamp(min=1e-30)).max().item()
    print("%s/%s/%s nseg %d, %s values, %d tiles: max |card - plain| "
          "%.3e, %.3e of the row's sum of |group sums|"
          % (stage, fold, scatter, nseg, values, tiles, err.max().item(),
             worst))
    assert (err <= cs.MMA_SCATTER_BOUND * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("stage", sorted(BM.STAGES))
@pytest.mark.parametrize("fold", sorted(BM.FOLDS))
@pytest.mark.parametrize("scatter", sorted(BM.SCATTERS))
@pytest.mark.parametrize("nseg", BM.NSEGS)
def test_integer_data_bit_for_bit(card, forms, values, stage, fold, scatter,
                                  nseg):
    b = forms[64, "int", values]
    x = make_x(b.shape[1], "int", 5, card)
    y = step_once(b, x, stage, fold, scatter, nseg)
    assert torch.equal(y, BM.bell_step_mma_plain(b, x, stage, fold,
                                                 scatter, nseg))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(BM.STAGES))
@pytest.mark.parametrize("cut", [1000, 997])
@pytest.mark.parametrize("aligned", [True, False])
def test_short_x_reads_zero_past_it(card, forms, stage, cut, aligned):
    # x ending inside a window's 16-byte load (997), and x starting off a
    # 16-byte boundary (the window's scalar loads)
    b = forms[64, "normal", "f32"]
    x = make_x(b.shape[1] - cut + 1, "normal", 9, card)
    x = x[:-1] if aligned else x[1:]
    y = step_once(b, x, stage, "tile", "add", 1)
    assert torch.equal(y, BM.bell_step_mma_plain(b, x, stage, "tile", "add",
                                                 1))


@pytest.mark.cuda
def test_bell_step_mma_refuses(card, forms, monkeypatch):
    b = forms[2, "normal", "f32"]
    x = make_x(b.shape[1], "normal", 0, card)
    with pytest.raises(ValueError, match="CUDA device"):
        BM.bell_step_mma(b, x.cpu())
    with pytest.raises(ValueError, match="window-1"):
        BM.bell_step_mma(b._replace(window=2), x)
    with pytest.raises(TypeError, match="f32 x"):
        BM.bell_step_mma(b, x.double())
    # a window past the shared memory of a block
    with pytest.raises(ValueError, match="shared memory"):
        BM.bell_step_mma(b._replace(nb=B.NB_MAX), x)
    with pytest.raises(ValueError, match="shared memory"):
        BM.bell_step_mma(b._replace(nb=400), x, "load", "tile", "add")
    monkeypatch.setattr(BM, "_entry", lambda: lambda *args: 9)
    before = BM.BELL_MMA_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        BM.bell_step_mma(b, x)
    assert BM.BELL_MMA_LAUNCHES == before


@pytest.mark.cuda
def test_counters(card, forms):
    probes.reset_counts()
    assert set(probes.counts().values()) == {0}
    b = forms[2, "normal", "f32"]
    BM.bell_step_mma(b, make_x(b.shape[1], "normal", 0, card))
    oh, w = patterns(64, 32, (), 1)
    OM.onehot_select(oh.to(card), w.to(card))
    torch.cuda.synchronize()
    counts = probes.counts()
    assert counts["probe_bell_mma"] == 1 and counts["probe_onehot_mma"] == 1
    assert sum(counts.values()) == 2
