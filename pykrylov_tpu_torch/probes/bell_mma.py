"""One BELL product with its non-matrix work on the tensor cores, or not.

Counterpart of ``tools/probes/probe_ablate_r3b.py``, whose variants moved
the BELL kernel's staging of the x window and its scatter of group sums
onto the TPU's matrix unit (one-hot products) and changed its fold.
:func:`bell_step_mma` runs ``csrc/probe_bell_mma.cu`` (``mma.sync`` on bf16
or tf32 pieces, the one-hot A fragments built in registers from the bands
and blocks) for CUDA tensors and :func:`bell_step_mma_plain` for CPU
tensors; anything else raises.  It takes a window-1 container with packed
indices and no segments (``bell_from_coo(window=1)``, the probe's), with
f32 or bf16 values, and x (n_x,) f32.  Every combination is a defined
function.  For slot row q of step st (GS rows of 128 lanes, GQ = GS/4
groups of 4 rows, ``idx`` the packed byte index):

**Staging.**  The step's window is the ``kb`` bands
``W[k] = x[128 (band_lo[st] + k) : ... + 128]`` (columns at or past n_x
read 0), ``kb = nb``; with ``nseg=4``, ``kb = max(8, nb // 4)`` (at most nb)
and a row whose band is ``kb`` or more selects 0 (the probe's segments all
take the window's first ``max(8, nb // 4)`` bands).  Row q stages
``xs[q] = W[bands[st, q]]``:

============  ==============================================================
``"bf16"``    ``_dot_onehot(..., 3)``: the one-hot product in 3 bf16 pieces
``"f32"``     ``hi_dot`` HIGHEST, here the one-hot product in 3 tf32 pieces
              (``cvt.rna``: nearest, ties away from zero)
``"load"``    the window row read straight (the card's control)
============  ==============================================================

Each piece's product is exact (:func:`.onehot_mma.onehot_rows`) and the
result is ``(t1 + t2) + t3``, so for a finite window every staging gives
the window's values; a non-finite value in the window turns its column of
the staged rows to NaN (0 * inf).

**Product.**  ``prod[q, l] = f32(data[st, q, l]) * xs[q, idx[q, l]]``.

**Fold** into group sums ``ps[p]``, p in storage order (natural groups
``[0, 2, 4, ... | 1, 3, 5, ...]``):

============  ==============================================================
``"tile"``    ``((r0 + r1) + r2) + r3`` over the rows 4g .. 4g + 3 of p's
              natural group g
``"halves"``  ``(prod[p] + prod[p + GS/2]) + (prod[p + GS/4] +
              prod[p + 3 GS/4])``: the probe's pairing, wrong against the
              map (a timing variant there), a defined function here
============  ==============================================================

**Scatter.**  ``y[128 (st nblk + blocks[st, p]) + l]`` gets ``ps[p, l]``;
a group of the dummy block ``nblk`` is dropped:

============  ==============================================================
``"bf16"``    the one-hot product ``ohY @ ps`` in 3 bf16 pieces: piece i's
              sum over a block's groups, ``t_i``, exact in f64 then f32
              (the tensor cores sum in f32 in their own order: within a few
              roundings of the block's sum of |pieces|), ``(t1 + t2) + t3``
``"f32"``     the same in 3 tf32 pieces (the probe's ``hi_dot``)
``"add"``     ``0 + ps[p1] + ps[p2] + ...`` in ascending natural group
              order (the card's control)
============  ==============================================================

Every product and add is rounded on its own.  ``load``/``tile``/``add`` is
the container's slot product, :func:`..sparse.bell.bell_matvec_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..sparse.bell import BELL, LANES, _natural_blocks
from .onehot_mma import bf16_pieces, onehot_rows, tf32_pieces

__all__ = ["BELL_MMA_LAUNCHES", "CONTROLS", "FOLDS", "NSEGS",
           "PROBE_CONFIGS", "SCATTERS", "STAGES", "TILE_BLOCKS",
           "bell_block_sums", "bell_group_sums", "bell_mma_bytes",
           "bell_mma_flops", "bell_step_mma", "bell_step_mma_plain",
           "contraction_bands"]

STAGES = {"bf16": 0, "f32": 1, "load": 2}
SCATTERS = {"bf16": 0, "f32": 1, "add": 2}
FOLDS = {"tile": 0, "halves": 1}
NSEGS = (1, 4)
# probe_ablate_r3b.py:210-221: (label, values, stage, fold, scatter, nseg)
PROBE_CONFIGS = (
    ("baseline bf16/tile/bf16", "f32", "bf16", "tile", "bf16", 1),
    ("stage=f32 HIGHEST", "f32", "f32", "tile", "bf16", 1),
    ("fold=halves", "f32", "bf16", "halves", "bf16", 1),
    ("scatter=f32 HIGHEST", "f32", "bf16", "tile", "f32", 1),
    ("f32 stage+scatter", "f32", "f32", "tile", "f32", 1),
    ("f32 stage+scatter, halves fold", "f32", "f32", "halves", "f32", 1),
    ("ALL + bf16 values", "bf16", "f32", "halves", "f32", 1),
    ("ALL + bf16 + seg4", "bf16", "f32", "halves", "f32", 4),
    ("f32 s+s halves seg4 (f32 vals)", "f32", "f32", "halves", "f32", 4),
)
# the card's controls: the staging, the scatter or both without the
# tensor cores
CONTROLS = (
    ("control load/tile/add", "f32", "load", "tile", "add", 1),
    ("control load/halves/add", "f32", "load", "halves", "add", 1),
    ("control bf16/tile/add", "f32", "bf16", "tile", "add", 1),
    ("control load/tile/bf16", "f32", "load", "tile", "bf16", 1),
)

# output blocks a block of the kernel takes: one m-tile of its mma scatter
# (kTileBlocks in csrc/probe_bell_mma.cu)
TILE_BLOCKS = 16

# Launches of the kernel in this process (see probes.COUNTERS)
BELL_MMA_LAUNCHES = 0


def contraction_bands(b: BELL, nseg):
    """The window bands a step's staging contracts over: ``nb``, or
    ``max(8, nb // 4)`` (at most nb) with ``nseg=4``."""
    return b.nb if nseg == 1 else min(b.nb, max(8, b.nb // nseg))


def _check(b, x, stage, fold, scatter, nseg):
    for name, value, known in (("stage", stage, STAGES),
                               ("fold", fold, FOLDS),
                               ("scatter", scatter, SCATTERS)):
        if value not in known:
            raise ValueError("%s must be one of %s, got %r"
                             % (name, sorted(known), value))
    if nseg not in NSEGS:
        raise ValueError("nseg must be 1 or 4, got %r" % (nseg,))
    if not isinstance(b, BELL):
        raise TypeError("bell_step_mma takes a BELL container, not %s"
                        % type(b).__name__)
    if b.window != 1 or b.idx_fmt != "packed" or b.seg is not None:
        raise ValueError("bell_step_mma takes a window-1 container with "
                         "packed indices and no segments (bell_from_coo("
                         "window=1)); got window %d, idx_fmt %r, %s"
                         % (b.window, b.idx_fmt,
                            "segments" if b.seg is not None
                            else "no segments"))
    if b.data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("bell_step_mma takes f32 or bf16 values, not %s"
                        % b.data.dtype)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("bell_step_mma expects x (n,), n > 0, got %s"
                         % (tuple(x.shape),))
    if x.dtype != torch.float32:
        raise TypeError("bell_step_mma takes an f32 x, not %s" % x.dtype)


def _window(b, x, kb):
    """(nsteps, kb, 128) windows of x, zero at columns past n_x."""
    k = torch.arange(kb, device=x.device)
    cols = ((b.band_lo.long()[:, None] + k) * LANES)[:, :, None] + \
        torch.arange(LANES, device=x.device)
    inside = cols < x.shape[0]
    return torch.where(inside, x[cols.clamp(max=x.shape[0] - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _stage(w, base, stage):
    """(nsteps, GS, 128) staged rows: row q of step st is ``w[st,
    base[st, q]]`` (0 where base is -1), by the stage's transport."""
    if stage == "load":
        inside = base >= 0
        rows = torch.gather(w, 1, base.clamp(min=0)[:, :, None].expand(
            -1, -1, LANES))
        return torch.where(inside[:, :, None], rows,
                           torch.zeros((), dtype=w.dtype, device=w.device))
    pieces = (bf16_pieces if stage == "bf16" else tf32_pieces)(w)
    t = [torch.stack([onehot_rows(p[s], base[s]) for s in range(w.shape[0])])
         for p in pieces]
    return (t[0] + t[1]) + t[2]


def _unpacked(b):
    """(nsteps, GS, 128) int64 byte indices of the packed lanes."""
    p = b.lanes.long() & 0xFFFFFFFF
    return torch.cat([(p >> (8 * j)) & 255 for j in range(4)], dim=1)


def _fold(prod, fold):
    """(nsteps, GQ, 128) group sums in storage order."""
    nsteps, gs, _ = prod.shape
    gq = gs // 4
    if fold == "halves":
        return (prod[:, :gq] + prod[:, 2 * gq:3 * gq]) + \
            (prod[:, gq:2 * gq] + prod[:, 3 * gq:])
    r = prod.reshape(nsteps, gq, 4, LANES)
    nat = ((r[:, :, 0] + r[:, :, 1]) + r[:, :, 2]) + r[:, :, 3]
    return torch.cat([nat[:, 0::2], nat[:, 1::2]], dim=1)


def _scatter(b, ps, scatter):
    """(nsteps * nblk * 128,) block sums of the group sums ``ps``."""
    nsteps, gq, _ = ps.shape
    dev = ps.device
    nat = torch.empty_like(ps)
    nat[:, 0::2] = ps[:, :gq - gq // 2]
    nat[:, 1::2] = ps[:, gq - gq // 2:]
    key = (torch.arange(nsteps, device=dev)[:, None] * (b.nblk + 1)
           + _natural_blocks(b.blocks).long()).reshape(-1)
    # the groups of each (step, block) pair in ascending natural order
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    counts = torch.bincount(key, minlength=nsteps * (b.nblk + 1))
    rank = torch.arange(len(ks), device=dev) - (torch.cumsum(counts, 0)
                                                - counts)[ks]
    depth = int(counts.max()) if len(ks) else 0
    if scatter == "add":
        terms = [nat.reshape(-1, LANES)[order]]
        dtype = torch.float32
    else:
        pieces = (bf16_pieces if scatter == "bf16" else tf32_pieces)(nat)
        terms = [p.reshape(-1, LANES)[order].double() for p in pieces]
        dtype = torch.float64
    sums = []
    for v in terms:
        acc = torch.zeros(nsteps * (b.nblk + 1), LANES, dtype=dtype,
                          device=dev)
        for j in range(depth):   # one group of each pair at a time
            at = rank == j
            acc[ks[at]] = acc[ks[at]] + v[at]
        sums.append(acc.float())
    y = sums[0] if scatter == "add" else (sums[0] + sums[1]) + sums[2]
    return y.reshape(nsteps, b.nblk + 1, LANES)[:, :b.nblk].reshape(-1)


def bell_group_sums(b: BELL, x, stage="bf16", fold="tile", nseg=1):
    """The group sums ``ps`` (nsteps, GS/4, 128) f32 in storage order that
    the combination scatters (the module docstring's staging, product and
    fold), in plain torch."""
    _check(b, x, stage, fold, "add", nseg)
    nsteps, gs, _ = b.data.shape
    kb = contraction_bands(b, nseg)
    bands = b.bands.reshape(nsteps, gs).long()
    base = torch.where(bands < kb, bands, torch.full_like(bands, -1))
    xs = _stage(_window(b, x, kb), base, stage)
    prod = b.data.float() * torch.gather(xs, 2, _unpacked(b))
    return _fold(prod, fold)


def bell_block_sums(b: BELL, ps, scatter="add"):
    """The scatter of group sums ``ps`` (nsteps, GS/4, 128) into the
    container's ``(nsteps * nblk * 128,)`` rows, in plain torch: the module
    docstring's ``scatter``.  ``bell_block_sums(b, ps.abs())`` is each
    row's sum of |group sums|, the scale of the mma scatters' rounding."""
    if scatter not in SCATTERS:
        raise ValueError("scatter must be one of %s, got %r"
                         % (sorted(SCATTERS), scatter))
    return _scatter(b, ps, scatter)


def bell_step_mma_plain(b: BELL, x, stage="bf16", fold="tile",
                        scatter="bf16", nseg=1):
    """Plain torch version of the combination (the module docstring):
    ``(nsteps * nblk * 128,)`` f32, the container's padded rows."""
    _check(b, x, stage, fold, scatter, nseg)
    return _scatter(b, bell_group_sums(b, x, stage, fold, nseg), scatter)


def bell_mma_bytes(b: BELL, n_x, nseg=1):
    """Bytes the product must move at best: the values, packed indices,
    bands and blocks of every slot row and group, the group map, each
    step's x window (its :func:`contraction_bands` inside n_x) and y, each
    once."""
    nsteps, gs, _ = b.data.shape
    slots = nsteps * gs * LANES
    windows = int(torch.clamp(
        n_x - b.band_lo.long().cpu() * LANES, 0,
        contraction_bands(b, nseg) * LANES).sum())
    return (slots * b.data.element_size() + slots + 4 * b.bands.numel()
            + 4 * b.blocks.numel() + 4 * (b.grp_ptr.numel()
                                          + b.grp_idx.numel())
            + 4 * nsteps + 4 * windows + 4 * nsteps * b.nblk * LANES)


def bell_mma_flops(b: BELL, stage, scatter, nseg=1):
    """{operand type: operations} on the tensor cores, as the kernel does
    them: the staging's 3 pieces of ``2 GS kb 128`` a step (bf16 or tf32)
    and the scatter's 3 pieces of ``2 TILE_BLOCKS GQ 128`` a step (each
    group sum contracted into the one m-tile of output blocks that holds
    its block, not into all nblk as the TPU's dense product)."""
    nsteps, gs, _ = b.data.shape
    ops = {}
    kind = {"bf16": "bf16", "f32": "tf32"}
    if stage in kind:
        ops[kind[stage]] = 3 * 2 * nsteps * gs * contraction_bands(
            b, nseg) * LANES
    if scatter in kind:
        ops[kind[scatter]] = ops.get(kind[scatter], 0) + \
            3 * 2 * nsteps * TILE_BLOCKS * (gs // 4) * LANES
    return ops


def bell_step_mma(b: BELL, x, stage="bf16", fold="tile", scatter="bf16",
                  nseg=1):
    """The combination's product (module docstring): the CUDA kernel for a
    container and x on one CUDA device, the plain version for CPU
    tensors; anything else raises."""
    _check(b, x, stage, fold, scatter, nseg)
    arrays = {"data": b.data, "lanes": b.lanes, "bands": b.bands,
              "blocks": b.blocks, "band_lo": b.band_lo,
              "grp_ptr": b.grp_ptr, "grp_idx": b.grp_idx, "x": x}
    for name, a in arrays.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError("bell_step_mma: the container's %s is not a "
                            "tensor" % name)
        if name not in ("data", "x") and a.dtype != torch.int32:
            raise TypeError("bell_step_mma: the container's %s must be "
                            "int32, not %s" % (name, a.dtype))
        if not a.is_contiguous():
            raise ValueError("bell_step_mma needs contiguous tensors; %s is "
                             "not" % name)
    dev = b.data.device
    if dev.type == "cpu" and all(a.device.type == "cpu"
                                 for a in arrays.values()):
        return bell_step_mma_plain(b, x, stage, fold, scatter, nseg)
    if dev.type != "cuda" or any(a.device != dev for a in arrays.values()):
        raise ValueError("bell_step_mma: the container on %s and x on %s; "
                         "the kernel takes every tensor on one CUDA device"
                         % (dev, x.device))
    return _launch(b, x, stage, fold, scatter, nseg)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("probe_bell_mma")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.probe_bell_step_mma.argtypes = [p, i64, p, p, p, p, p, p, p, i64, p,
                                        i64, i64, i64, i64, i64, i64, i64,
                                        p]
    lib.probe_bell_step_mma.restype = ctypes.c_int
    lib.probe_bell_mma_smem.argtypes = [i64, i64]
    lib.probe_bell_mma_smem.restype = i64
    lib.probe_bell_mma_smem_max.argtypes = []
    lib.probe_bell_mma_smem_max.restype = i64
    return lib


def _entry():
    return _lib().probe_bell_step_mma


def _launch(b, x, stage, fold, scatter, nseg):
    global BELL_MMA_LAUNCHES
    nsteps, gs, _ = b.data.shape
    kb = contraction_bands(b, nseg)
    lib = _lib()
    need = lib.probe_bell_mma_smem(kb, STAGES[stage])
    if need > lib.probe_bell_mma_smem_max():
        raise ValueError("bell_step_mma: a window of %d bands with %r "
                         "staging takes %d bytes of shared memory, past the "
                         "%d a block has" % (kb, stage, need,
                                             lib.probe_bell_mma_smem_max()))
    y = torch.empty(nsteps * b.nblk * LANES, dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(b.data.data_ptr(), b.data.dtype == torch.bfloat16,
                       b.lanes.data_ptr(), b.bands.data_ptr(),
                       b.blocks.data_ptr(), b.band_lo.data_ptr(),
                       b.grp_ptr.data_ptr(), b.grp_idx.data_ptr(),
                       x.data_ptr(), x.shape[0], y.data_ptr(), nsteps, gs,
                       kb, b.nblk, FOLDS[fold], STAGES[stage],
                       SCATTERS[scatter], stream)
    if err != 0:
        raise RuntimeError("BELL mma kernel (%s/%s/%s, nseg %d) launch "
                           "failed with CUDA error %d"
                           % (stage, fold, scatter, nseg, err))
    BELL_MMA_LAUNCHES += 1
    return y
