"""The probe kernels' plain versions on the CPU, against the JAX side.

``pykrylov_tpu_torch.probes`` ports the kernels of ``tools/probes/``.
Their CUDA kernels run only on the card (``tests/test_torch_probes_card.py``,
``chip_smoke.py`` phase 23); here the wrappers run their plain versions,
which the kernels equal bit for bit, and those are held against:

* ``stream_fold``: the kernel body of ``probe_stream_floor.py:49-54``
  copied into a ``pallas_call`` in interpret mode with the probe's
  BlockSpecs (the probe module itself asserts a TPU backend at import).
  With one block the two are equal; with several the port's fold is the
  sum of the Pallas call on each block alone (the TPU kernel returns the
  last block's fold, the port sums every block's).  Integer data: exact.
* ``dia_matvec_ring``: the JAX package's ``_dia_matvec_call(...,
  interpret=True)``, which the probe checks itself against, on small
  Poisson and the 125-diagonal B-spline Laplacian at n=16 (f32, 1e-6
  relative: the Pallas kernel sums a padded container in its own order);
  and an emulation of the kernel's ring schedule (a producer, eight
  consumer warps and the copy engine interleaved at random, mbarriers with
  phases and byte counts) bit for bit against ``dia_matvec_plain``, at odd
  and even diagonal counts, ragged last tiles and depths 2 and 4.  With
  slots counted per tile instead of over the block's stream, the
  emulation fails as the TPU probe's first run did.
* ``sell_matvec_ablated``: ``full`` and ``skew`` against the JAX
  ``bell_matvec_pallas(..., interpret=True)`` through ``convert`` (f64,
  1e-12 relative: the SELL form sums in another order than the BELL
  container), every other variant against a NumPy statement of its
  definition from the COO triples (f64, 1e-12).
"""

import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.kernels import (_dia_matvec_call, ensure_dia_padded,
                                         pack_dia)

import chip_smoke
from pykrylov_tpu_torch import convert, probes
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.probes import dia_ring as DR
from pykrylov_tpu_torch.probes import sell_ablation as SA
from pykrylov_tpu_torch.probes import stream_floor as SF
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_bell_pack import triples

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # small tensors: torch's intra-op threads would only contend with the
    # other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


# --------------------------------------------------------------------------
# stream_fold
# --------------------------------------------------------------------------

def pallas_fold(arrs, rows):
    """probe_stream_floor.py's ``blockspec_stream`` kernel in interpret
    mode on (nsteps, rows, 128) f32 arrays, without the TPU memory
    spaces: the fold of the last grid step's blocks."""
    nsteps = arrs[0].shape[0]

    def kernel(*refs):
        out = refs[-1]
        acc = jnp.zeros((8, 128), jnp.float32)
        for r in refs[:-1]:
            acc = acc + r[0].reshape(rows // 8, 8, 128).sum(axis=0)
        out[:] = acc

    return np.asarray(pl.pallas_call(
        kernel,
        grid=(nsteps,),
        in_specs=[pl.BlockSpec((1, rows, 128), lambda s: (s, 0, 0))
                  for _ in arrs],
        out_specs=pl.BlockSpec((8, 128), lambda s: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(a) for a in arrs]))


def integer_streams(nstreams, nsteps, rows, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 8, (nsteps, rows, 128)).astype(np.float32)
            for _ in range(nstreams)]


@pytest.mark.parametrize("nstreams", [1, 2])
@pytest.mark.parametrize("rows", [8, 40, 128])
def test_fold_of_one_block_is_the_pallas_kernel(nstreams, rows):
    arrs = integer_streams(nstreams, 1, rows, rows + nstreams)
    port = SF.stream_fold([torch.from_numpy(a).view(-1) for a in arrs])
    np.testing.assert_array_equal(port.numpy(), pallas_fold(arrs, rows))


@pytest.mark.parametrize("nstreams", [1, 2])
@pytest.mark.parametrize("rows", [8, 40, 128])
def test_fold_of_blocks_sums_the_pallas_kernel_per_block(nstreams, rows):
    nsteps = 5
    arrs = integer_streams(nstreams, nsteps, rows, 7 * rows + nstreams)
    port = SF.stream_fold([torch.from_numpy(a).view(-1) for a in arrs],
                          mode="ring")
    per_block = sum(pallas_fold([a[s:s + 1] for a in arrs], rows)
                    for s in range(nsteps))
    np.testing.assert_array_equal(port.numpy(), per_block)
    # the TPU kernel itself keeps only the last block's fold
    np.testing.assert_array_equal(
        pallas_fold(arrs, rows), pallas_fold([a[-1:] for a in arrs], rows))


def test_fold_on_the_cpu_launches_nothing():
    probes.reset_counts()
    streams = SF.probe_streams(2, 8 * 4096, seed=3, device=DEV)
    for mode in SF.MODES:
        out = SF.stream_fold(streams, mode=mode)
        ref = sum(a.view(-1, 1024).sum(0) for a in streams).view(8, 128)
        assert torch.equal(out, ref)
    assert probes.counts() == {"probe_stream": 0, "probe_dia_ring": 0,
                               "probe_sell_ablation": 0,
                               "probe_onehot_mma": 0, "probe_bell_mma": 0}


def test_probe_streams():
    a, b = SF.probe_streams(2, 64 * 4096, seed=1, device=DEV)
    assert a.dtype == torch.float32 and a.shape == (32 * 1024,)
    assert set(torch.unique(torch.cat([a, b])).tolist()) == set(range(8))
    assert not torch.equal(a, b)
    assert torch.equal(a, SF.probe_streams(2, 64 * 4096, seed=1,
                                           device=DEV)[0])
    with pytest.raises(ValueError, match="rows"):
        SF.probe_streams(2, 4096, device=DEV)
    assert SF.stream_bytes([a, b]) == 64 * 4096


@pytest.mark.parametrize("streams,match", [
    ([], "1 or 2"),
    ([torch.zeros(1024)] * 3, "1 or 2"),
    ([torch.zeros(1000)], "multiple"),
    ([torch.zeros(1024, dtype=torch.float64)], "f32"),
    ([torch.zeros(2048)[::2]], "contiguous"),
])
def test_fold_refuses(streams, match):
    with pytest.raises(ValueError, match=match):
        SF.stream_fold(streams)


def test_fold_refuses_a_mode():
    with pytest.raises(ValueError, match="mode"):
        SF.stream_fold([torch.zeros(1024)], mode="blockspec")


@pytest.mark.parametrize("nstreams,chunk,depth,fits", [
    (1, 4096, 2, True), (1, 32768, 4, True), (1, 32768, 8, False),
    (2, 16384, 4, True), (2, 16384, 8, False), (2, 32768, 2, True),
    (1, 2048, 4, False), (1, 6144, 4, False), (1, 4096, 1, False),
    (1, 4096, 9, False),
])
def test_ring_fits(nstreams, chunk, depth, fits):
    assert SF.ring_fits(nstreams, chunk, depth) == fits


# --------------------------------------------------------------------------
# dia_matvec_ring
# --------------------------------------------------------------------------

def jax_ring_reference(coo, block):
    """``_dia_matvec_call(..., interpret=True)`` on the padded, packed JAX
    container of ``coo`` (f32), and the unpadded one."""
    jdia = JF.dia_from_coo(JF.coo_from_arrays(*coo))
    dia_p, _ = ensure_dia_padded(jdia, block)
    d3, offsets = pack_dia(dia_p, block)

    def call(x):
        xp = np.zeros(dia_p.shape[0], np.float32)
        xp[:len(x)] = x
        return np.asarray(_dia_matvec_call(d3, jnp.asarray(xp), offsets,
                                           block, True))[:jdia.shape[0]]
    return jdia, call


@pytest.mark.parametrize("name,coo,block", [
    ("poisson n=12", lambda: poisson3d_coo(12, dtype=np.float32), 1024),
    ("poisson n=9", lambda: poisson3d_coo(9, dtype=np.float32), 256),
    ("B-spline n=16", lambda: chip_smoke.bspline_coo(16, dtype=np.float32),
     1024),
])
def test_ring_matches_the_jax_kernel(name, coo, block):
    jdia, jax_call = jax_ring_reference(coo(), block)
    dia = convert.from_numpy(jdia, device=DEV)
    x = np.random.default_rng(5).standard_normal(dia.shape[1]).astype(
        np.float32)
    for tile in (256, 1024):
        for depth in (2, 4):
            y = DR.dia_matvec_ring(dia.data, dia.offsets,
                                   torch.from_numpy(x), tile, depth)
            assert torch.equal(y, K.dia_matvec_plain(
                dia.data, dia.offsets, torch.from_numpy(x)))
    assert rel(y.numpy(), jax_call(x)) <= 1e-6


def ring_blocks(m, tile, blocks):
    """The tiles of block b of ``blocks`` (csrc/probe_dia_ring.cu): b,
    b + blocks, ... below the ``ceil(m / tile)`` tiles of m rows."""
    tiles = -(-m // tile)
    return [list(range(b, tiles, blocks)) for b in range(blocks)]


def ring_positions(tiles, ndiag, depth):
    """(tile, diagonal, slot, use) of each position of a block's stream
    over ``tiles`` (its tiles in turn), as the kernel counts them: the
    consumers wait for use u of a slot with parity u & 1; the producer
    refills a slot once its use u - 1 is released."""
    out = []
    for j, t in enumerate(tiles):
        for k in range(ndiag):
            g = j * ndiag + k
            out.append((t, k, g % depth, g // depth))
    return out


class Deadlock(AssertionError):
    pass


class Barrier:
    """An mbarrier: ``arrivals`` a phase, a byte count, the phases
    completed.  ``passed(p)`` is try_wait.parity(p): the phase of parity p
    has completed (the one after it has not)."""

    def __init__(self, arrivals):
        self.arrivals = arrivals
        self.pending = arrivals
        self.tx = 0
        self.completed = 0

    def arrive(self, tx=0):
        assert self.pending > 0, "arrival past the phase's count"
        self.pending -= 1
        self.tx += tx
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.arrivals

    def passed(self, parity):
        return self.completed % 2 != parity


def emulate_ring(data, offsets, x, tile, depth, blocks, seed,
                 consumer_slot=None):
    """The kernel's schedule (csrc/probe_dia_ring.cu) run on the host: per
    block, lane 0 of the producer warp, eight consumer warps and the copy
    engine, advanced one step at a time in a seeded random order.  A copy
    lands (its bytes written into the slot and counted on the full
    barrier) at a random later step.  ``consumer_slot(g, k)``, where given,
    replaces the consumers' slot of position g (diagonal k)."""
    warps, lanes = 8, 32
    ndiag, m = data.shape
    n = x.shape[0]
    y = torch.full((m,), float("nan"))
    rng = random.Random(seed)
    for tiles in ring_blocks(m, tile, blocks):
        positions = ring_positions(tiles, ndiag, depth)
        ring = torch.full((depth, tile), float("nan"))
        full = [Barrier(1) for _ in range(depth)]
        empty = [Barrier(warps) for _ in range(depth)]
        flight = []                                # copies not yet landed

        def producer():
            for g, (t, k, slot, use) in enumerate(positions):
                while use > 0 and not empty[slot].passed((use - 1) & 1):
                    yield False
                i0 = t * tile
                rows = min(tile, m - i0)
                full[slot].arrive(tx=4 * rows)
                flight.append((slot, data[k, i0:i0 + rows].clone()))
                yield True

        def consumer(w):
            mine = [th + 256 * r for th in range(w * lanes, (w + 1) * lanes)
                    for r in range(tile // 256)]
            g = 0
            for t in tiles:
                i0 = t * tile
                rows = min(tile, m - i0)
                rr = torch.tensor([r for r in mine if r < rows],
                                  dtype=torch.long)
                acc = torch.zeros(len(rr))
                for k in range(ndiag):
                    slot = (g % depth if consumer_slot is None
                            else consumer_slot(g, k))
                    while not full[slot].passed((g // depth) & 1):
                        yield False
                    col = i0 + rr + offsets[k]
                    live = (col >= 0) & (col < n)
                    prod = ring[slot, rr] * x[col.clamp(0, max(n - 1, 0))]
                    acc = torch.where(live, acc + prod, acc)
                    empty[slot].arrive()
                    g += 1
                    yield True
                y[i0 + rr] = acc

        def engine():
            while True:
                if not flight:
                    yield False
                    continue
                slot, values = flight.pop(rng.randrange(len(flight))
                                          if rng.random() < 0.3 else 0)
                ring[slot, :len(values)] = values
                full[slot].land(4 * len(values))
                yield True

        roles = [producer()] + [consumer(w) for w in range(warps)]
        copies = engine()
        idle = 0
        while roles:
            pick = rng.randrange(len(roles) + 1)
            if pick == len(roles):
                moved = next(copies)
            else:
                try:
                    moved = next(roles[pick])
                except StopIteration:
                    roles.pop(pick)
                    moved = True
            idle = 0 if moved else idle + 1
            if idle > 200 * (len(roles) + 1):
                raise Deadlock("no role moved in %d steps" % idle)
    return y


def banded(m, n, offsets, seed):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m))
                            .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return data, x


@pytest.mark.parametrize("ndiag", [1, 3, 7, 8])
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("m,blocks", [(1300, 1), (1300, 2), (2820, 3)])
def test_ring_schedule_is_the_plain_product(ndiag, depth, m, blocks):
    # tiles of 256 rows: 1300 and 2820 leave a ragged last tile
    offsets = tuple(range(-(ndiag // 2) * 37, (ndiag - ndiag // 2) * 37, 37))
    data, x = banded(m, m, offsets, m + ndiag + depth)
    for seed in range(2):
        y = emulate_ring(data, offsets, x, 256, depth, blocks, seed)
        assert torch.equal(y, K.dia_matvec_plain(data, offsets, x))


def test_ring_schedule_at_two_tile_sizes():
    offsets = (-600, -1, 0, 1, 33, 600, 2000)
    data, x = banded(2600, 2400, offsets, 9)
    for tile in (512, 1024):
        y = emulate_ring(data, offsets, x, tile, 2, 2, tile)
        assert torch.equal(y, K.dia_matvec_plain(data, offsets, x))


def test_slots_counted_per_tile_fail():
    # the TPU probe's first fault: the consumers count ring positions per
    # tile, the producer over the block's stream; with 7 diagonals and
    # depth 2 they part at the first tile's edge
    offsets = (-300, -20, -1, 0, 1, 20, 300)
    data, x = banded(1300, 1300, offsets, 1)
    ref = K.dia_matvec_plain(data, offsets, x)

    def faulty(seed):
        try:
            y = emulate_ring(data, offsets, x, 256, 2, 1, seed,
                             consumer_slot=lambda g, k: k % 2)
        except Deadlock:
            return True
        return not torch.equal(y, ref)
    assert all(faulty(seed) for seed in range(3))


def test_ring_positions():
    pos = ring_positions([0, 3], 3, 2)
    assert pos == [(0, 0, 0, 0), (0, 1, 1, 0), (0, 2, 0, 1),
                   (3, 0, 1, 1), (3, 1, 0, 2), (3, 2, 1, 2)]
    assert ring_blocks(1300, 256, 2) == [[0, 2, 4], [1, 3, 5]]
    assert ring_blocks(1024, 256, 3) == [[0, 3], [1], [2]]
    assert DR.dia_ring_bytes(7, 100, 90) == (700 + 190) * 4


def test_ring_refuses_on_the_cpu():
    data, x = banded(1024, 1024, (0,), 0)
    with pytest.raises(ValueError, match="tile"):
        DR.dia_matvec_ring(data, (0,), x, tile=1000)
    with pytest.raises(ValueError, match="depth"):
        DR.dia_matvec_ring(data, (0,), x, tile=4096, depth=9)
    with pytest.raises(TypeError, match="f32"):
        DR.dia_matvec_ring(data.double(), (0,), x.double())
    probes.reset_counts()
    assert torch.equal(DR.dia_matvec_ring(data, (0,), x), data[0] * x)
    assert probes.counts()["probe_dia_ring"] == 0


# --------------------------------------------------------------------------
# sell_matvec_ablated
# --------------------------------------------------------------------------

CONTAINERS = {
    "w1": (lambda: triples(1000, 1000, 8000, 1, bandwidth=90),
           dict(window=1, spill_cost=None)),
    "w2-rect": (lambda: triples(700, 300, 2500, 3),
                dict(window=2, spill_cost=None)),
}


@functools.lru_cache(maxsize=None)
def container(name):
    make, kw = CONTAINERS[name]
    t = make()
    ref = JB.bell_from_coo(JF.coo_from_arrays(*t, device=False),
                           device=False, **kw)
    b = convert.from_numpy(ref, device=DEV)
    return t, ref, S.sell_from_levels((b,), ref.shape[0])


def pallas(ref, x):
    """The JAX kernel's ``y = A x`` (interpret mode) on a host container."""
    xp = np.zeros(ref.padded_shape[1], x.dtype)
    xp[:len(x)] = x
    y = JB.bell_matvec_pallas(JB.bell_to_device(ref), jnp.asarray(xp),
                              interpret=True)
    return np.asarray(y)[:ref.shape[0]]


@pytest.mark.parametrize("variant", ["full", "skew"])
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_full_and_skew_match_the_pallas_kernel(name, variant):
    t, ref, card = container(name)
    x = np.random.default_rng(5).standard_normal(t[3][1])
    y = SA.sell_matvec_ablated(card, torch.from_numpy(x), variant)
    assert rel(y.numpy(), pallas(ref, x)) <= 1e-12
    assert torch.equal(y, S.sell_matvec_plain(card, torch.from_numpy(x)))


def numpy_variant(t, card, x, variant):
    """The variant's definition from the COO triples in f64 (any order
    within a row); the slot row of output row r is where
    ``card.row_idx`` holds r."""
    vals, rows, cols, (m, n) = t
    vals = np.asarray(vals, np.float64)
    slot = np.empty(m, np.int64)
    slot[card.row_idx.numpy()] = np.arange(m)
    own = x[slot[rows] % n]
    term = {"no-gather": vals * own + (cols >> 30),
            "no-columns": vals * own,
            "no-values": x[cols],
            "streams-only": vals + cols,
            "no-scatter": vals * x[cols]}[variant]
    y = np.zeros(m)
    np.add.at(y, rows, term)
    if variant == "no-scatter":
        y = y[card.row_idx.numpy()]
    return y


@pytest.mark.parametrize("variant", ["no-gather", "no-columns", "no-values",
                                     "streams-only", "no-scatter"])
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_variants_match_their_definition(name, variant):
    t, _, card = container(name)
    x = np.random.default_rng(6).standard_normal(t[3][1])
    y = SA.sell_matvec_ablated(card, torch.from_numpy(x), variant)
    assert y.shape == (t[3][0],)
    assert rel(y.numpy(), numpy_variant(t, card, x, variant)) <= 1e-12


def test_variants_in_f32_keep_their_streams():
    # f32 values and x, as on the card: each variant is its own function
    t, _, card = container("w1")
    card32 = card._replace(vals=card.vals.float())
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        t[3][1]).astype(np.float32))
    ys = {v: SA.sell_matvec_ablated(card32, x, v) for v in SA.VARIANTS}
    assert all(y.dtype == torch.float32 for y in ys.values())
    assert torch.equal(ys["full"], ys["skew"])
    assert torch.equal(ys["full"], S.sell_matvec(card32, x))
    assert torch.equal(ys["full"][card32.row_idx.long()], ys["no-scatter"])
    assert torch.equal(ys["no-gather"], ys["no-columns"])  # columns < 2**30
    for a in SA.VARIANTS:
        for b in SA.VARIANTS:
            if a < b and {a, b} not in ({"full", "skew"},
                                        {"no-gather", "no-columns"}):
                assert not torch.equal(ys[a], ys[b]), (a, b)


def test_ablation_bytes():
    t, _, card = container("w1")
    nnz, m, n = len(t[0]), t[3][0], t[3][1]
    nsp = card.slice_ptr.numel()
    index, y = 8 * m + 8 * nsp, 4 * m
    assert int(card.row_len.sum()) == nnz
    expect = {"full": 8 * nnz + index + 4 * n + y,
              "skew": 8 * nnz + index + 4 * n + y,
              "no-gather": 8 * nnz + index + 4 * min(m, n) + y,
              "no-columns": 4 * nnz + index + 4 * min(m, n) + y,
              "no-values": 4 * nnz + index + 4 * n + y,
              "streams-only": 8 * nnz + index + y,
              "no-scatter": 8 * nnz + index - 4 * m + 4 * n + y}
    for variant, nbytes in expect.items():
        assert SA.ablation_bytes(card, n, variant) == nbytes, variant


def test_ablation_refuses_on_the_cpu():
    _, _, card = container("w1")
    with pytest.raises(ValueError, match="variant"):
        SA.sell_matvec_ablated(card, torch.zeros(card.n), "no-dma")
    with pytest.raises(ValueError, match="x"):
        SA.sell_matvec_ablated(card, torch.zeros(card.n, 2))
    probes.reset_counts()
    SA.sell_matvec_ablated(card, torch.zeros(card.n, dtype=torch.float64))
    assert probes.counts()["probe_sell_ablation"] == 0
