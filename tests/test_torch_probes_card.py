"""The probe kernels against their plain versions on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_probes_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)

* ``stream_fold`` in both modes, every unroll, ring chunk and depth that
  fits, one and two streams, lengths that the chunk does not divide and
  grids of 1, 3 and the card's: bit for bit the plain fold (the streams
  hold integers 0-7, so every order of summation is exact);
* ``dia_matvec_ring`` at 1, 7, 64, 65 and 125 diagonals, offsets past the
  matrix, ragged last tiles, every tile and depths 2-8 (depth 2 with odd
  diagonal counts, whose ring positions cross tiles on alternating
  slots): bit for bit ``kernels.dia_matvec_plain``, with NaN and inf in
  every slot whose column lies outside the matrix;
* ``sell_matvec_ablated``, every variant on several card forms: bit for
  bit its plain version, and ``full`` bit for bit ``sell_matvec``;
* each wrapper raises on what its kernel does not take and on a non-zero
  launch status, and launches (its counter moves) for CUDA tensors.
"""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch import probes
from pykrylov_tpu_torch.gallery import tiled_general_coo
from pykrylov_tpu_torch.probes import dia_ring as DR
from pykrylov_tpu_torch.probes import sell_ablation as SA
from pykrylov_tpu_torch.probes import stream_floor as SF
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse import sell as S


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the probe kernels have no CPU "
                    "mode)")
    return "cuda"


# --------------------------------------------------------------------------
# stream_fold
# --------------------------------------------------------------------------

RINGS = [(c, d) for c in (4096, 16384, 32768) for d in (2, 4, 8)]


def fold_once(streams, **kw):
    before = SF.STREAM_LAUNCHES
    out = SF.stream_fold(streams, **kw)
    torch.cuda.synchronize()
    assert SF.STREAM_LAUNCHES == before + 1
    ref = SF.stream_fold_plain(streams)
    assert out.shape == ref.shape == (8, 128)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("nstreams", [1, 2])
@pytest.mark.parametrize("unroll", SF.UNROLLS)
@pytest.mark.parametrize("rows", [1, 37, 1000, 4099])
def test_direct_fold(card, nstreams, unroll, rows):
    streams = SF.probe_streams(nstreams, nstreams * rows * 4096, seed=rows,
                               device=card)
    fold_once(streams, mode="direct", unroll=unroll)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 5000])
def test_direct_fold_grids(card, blocks):
    streams = SF.probe_streams(2, 2 * 777 * 4096, seed=blocks, device=card)
    fold_once(streams, mode="direct", unroll=4, blocks=blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("nstreams", [1, 2])
@pytest.mark.parametrize("chunk,depth", RINGS)
@pytest.mark.parametrize("rows", [1, 37, 1003])
def test_ring_fold(card, nstreams, chunk, depth, rows):
    if not SF.ring_fits(nstreams, chunk, depth):
        with pytest.raises(ValueError, match="ring"):
            SF.stream_fold(SF.probe_streams(nstreams, nstreams * 4096,
                                            device=card),
                           mode="ring", chunk=chunk, depth=depth)
        return
    # 37 and 1003 rows of 4 KB: the last chunk is short for every chunk
    # above 4 KB
    streams = SF.probe_streams(nstreams, nstreams * rows * 4096, seed=rows,
                               device=card)
    fold_once(streams, mode="ring", chunk=chunk, depth=depth)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 5000])
def test_ring_fold_grids(card, blocks):
    streams = SF.probe_streams(1, 999 * 4096, seed=blocks, device=card)
    fold_once(streams, mode="ring", chunk=16384, depth=3, blocks=blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SF.MODES)
def test_fold_at_the_probe_size(card, mode):
    # 512 MB in two streams of 256 MB: 2**17 terms a bin, every partial
    # sum below 2**24
    streams = SF.probe_streams(2, 512 << 20, seed=7, device=card)
    fold_once(streams, mode=mode)


@pytest.mark.cuda
def test_fold_refuses(card, monkeypatch):
    a = torch.zeros(4096 + 4, device=card)
    with pytest.raises(ValueError, match="aligned"):
        SF.stream_fold([a[1:4097]])
    with pytest.raises(ValueError, match="one length"):
        SF.stream_fold([a[:2048], a[:1024]])
    with pytest.raises(ValueError, match="multiple"):
        SF.stream_fold([a[:1000]])
    with pytest.raises(ValueError, match="unroll"):
        SF.stream_fold([a[:1024]], unroll=3)
    with pytest.raises(ValueError, match="CUDA device"):
        SF.stream_fold([a[:1024], a[:1024].cpu()])
    monkeypatch.setattr(SF, "_entry", lambda name: lambda *args: 9)
    before = SF.STREAM_LAUNCHES
    for mode in SF.MODES:
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            SF.stream_fold([a[:1024]], mode=mode)
    assert SF.STREAM_LAUNCHES == before


# --------------------------------------------------------------------------
# dia_matvec_ring
# --------------------------------------------------------------------------

def poison(data, offsets, n):
    """NaN and inf in every slot whose column lies outside [0, n)."""
    i = torch.arange(data.shape[1], device=data.device)
    for k, off in enumerate(offsets):
        out = torch.nonzero((i + off < 0) | (i + off >= n)).flatten()
        data[k, out[0::2]] = float("nan")
        data[k, out[1::2]] = float("inf")
    return data


def ring_once(data, offsets, x, tile, depth):
    before = DR.DIA_RING_LAUNCHES
    y = DR.dia_matvec_ring(data, offsets, x, tile=tile, depth=depth)
    torch.cuda.synchronize()
    assert DR.DIA_RING_LAUNCHES == before + 1
    ref = K.dia_matvec_plain(data, offsets, x)
    assert torch.isfinite(ref).all()
    assert torch.equal(y, ref)


BSPLINE = tuple(a * 576 + b * 24 + c for a in range(-2, 3)
                for b in range(-2, 3) for c in range(-2, 3))
RING_CASES = {
    "1 diagonal": (20000, 20000, (0,)),
    "7 diagonals, ragged": (20012, 20012, (-400, -20, -1, 0, 1, 20, 400)),
    "7 unsorted, repeated": (9996, 9996, (5, -3, 0, 5, -3, 144, -144)),
    "past m": (20016, 20016, (-30000, -3, 0, 2, 25000)),
    "every offset past m": (1000, 1000, (-1200, 1001, 5000)),
    "64 diagonals": (40000, 40000, tuple(range(-40, 24))),
    "65 diagonals": (40000, 40000, tuple(range(-40, 25))),
    "125 B-spline diagonals": (13824, 13824, BSPLINE),
    "rectangular, wide": (20016, 21000, (-700, -1, 0, 2, 990)),
    "rectangular, tall": (20016, 15000, (-700, -1, 0, 2, 990)),
    "one row group": (4, 4, (-1, 0, 1)),
    "no diagonals": (64, 64, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("tile,depth", [(256, 2), (1024, 2), (1024, 3),
                                        (2048, 4), (4096, 8)])
def test_ring_cases(card, name, tile, depth):
    m, n, offsets = RING_CASES[name]
    rng = np.random.default_rng(m + n + len(offsets))
    data = torch.from_numpy(rng.standard_normal((len(offsets), m))).to(
        card, torch.float32)
    x = torch.from_numpy(rng.standard_normal(n)).to(card, torch.float32)
    ring_once(poison(data, offsets, n), offsets, x, tile, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("n", [24, 34])
def test_ring_on_poisson(card, depth, n):
    # 7 diagonals; n = 34 (39,304 rows: 4 | m, as the bulk copies need)
    # leaves a ragged last tile at every tile size
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    coo = poisson3d_coo(n, dtype=np.float32)
    dia = F.dia_from_coo(F.coo_from_arrays(*coo, device=None), device=card)
    x = torch.randn(dia.shape[1], device=card)
    for tile in DR.TILES:
        ring_once(dia.data, dia.offsets, x, tile, depth)


@pytest.mark.cuda
def test_ring_refuses(card, monkeypatch):
    data = torch.zeros(3 * 1024 + 1, device=card)
    x = torch.zeros(1024, device=card)
    with pytest.raises(ValueError, match="aligned"):
        DR.dia_matvec_ring(data[1:].view(3, 1024), (-1, 0, 1), x)
    with pytest.raises(ValueError, match="4 \\| m"):
        DR.dia_matvec_ring(data[:3 * 1022].view(3, 1022), (-1, 0, 1),
                           x[:1022])
    with pytest.raises(ValueError, match="depth"):
        DR.dia_matvec_ring(data[:3072].view(3, 1024), (-1, 0, 1), x,
                           tile=4096, depth=16)
    with pytest.raises(TypeError, match="f32"):
        DR.dia_matvec_ring(data[:3072].view(3, 1024).double(), (-1, 0, 1),
                           x.double())
    monkeypatch.setattr(DR, "_entry", lambda: lambda *args: 9)
    before = DR.DIA_RING_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        DR.dia_matvec_ring(data[:3072].view(3, 1024), (-1, 0, 1), x)
    assert DR.DIA_RING_LAUNCHES == before


# --------------------------------------------------------------------------
# sell_matvec_ablated
# --------------------------------------------------------------------------

def card_forms(device):
    """SELL card forms: tiled 1138bus (window 1) and a rectangular random
    matrix with empty rows and rows longer than two chunks."""
    t = tiled_general_coo("1138bus", tiles=4, coupling=0)
    bus = operator_from_coo(*t, symmetric=True, fmt="bell", device=device)
    rng = np.random.default_rng(3)
    m, n = 3000, 1700
    rows = np.concatenate([rng.integers(0, m // 2, 9000),
                           np.repeat(rng.integers(0, m // 2, 5), 40)])
    cols = rng.integers(0, n, len(rows))
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    rect = operator_from_coo(vals, rows, cols, (m, n), fmt="bell",
                             device=device)
    return {"tiled 1138bus": bus.card, "rectangular": rect.card}


@pytest.fixture(scope="module")
def forms():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the probe kernels have no CPU "
                    "mode)")
    return card_forms("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["tiled 1138bus", "rectangular"])
@pytest.mark.parametrize("variant", sorted(SA.VARIANTS))
def test_ablation_variants(card, forms, form, variant):
    c = forms[form]
    x = torch.randn(c.n, device=card, generator=torch.Generator(
        device=card).manual_seed(11))
    before = SA.SELL_ABLATION_LAUNCHES
    y = SA.sell_matvec_ablated(c, x, variant)
    torch.cuda.synchronize()
    assert SA.SELL_ABLATION_LAUNCHES == before + 1
    assert torch.equal(y, SA.sell_matvec_ablated_plain(c, x, variant))
    if variant in ("full", "skew"):
        assert torch.equal(y, S.sell_matvec(c, x))


@pytest.mark.cuda
def test_ablation_refuses(card, forms, monkeypatch):
    c = forms["tiled 1138bus"]
    x = torch.randn(c.n, device=card)
    with pytest.raises(ValueError, match="variant"):
        SA.sell_matvec_ablated(c, x, "no-dma")
    with pytest.raises(TypeError, match="f32"):
        SA.sell_matvec_ablated(c, x.double())
    with pytest.raises(ValueError, match="CUDA device"):
        SA.sell_matvec_ablated(c, x.cpu())
    monkeypatch.setattr(SA, "_entry", lambda: lambda *args: 9)
    before = SA.SELL_ABLATION_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        SA.sell_matvec_ablated(c, x)
    assert SA.SELL_ABLATION_LAUNCHES == before


@pytest.mark.cuda
def test_counters(card):
    probes.reset_counts()
    assert probes.counts() == {"probe_stream": 0, "probe_dia_ring": 0,
                               "probe_sell_ablation": 0,
                               "probe_onehot_mma": 0, "probe_bell_mma": 0}
    SF.stream_fold(SF.probe_streams(1, 4096, device=card))
    assert probes.counts()["probe_stream"] == 1
