"""BELL (band-sliced ELL): the general-sparsity container and its kernel.

Counterpart of ``pykrylov_tpu/sparse/bell.py``.  The container, its host
packer and the packer's planning rules are the JAX package's, array for
array: both packages build the same BELL from the same matrix.  Those
rules (block depths aligned to 4-row groups, the step size cap, the
cost model that picks a window mode) were measured for the TPU kernel,
and the comments inside the packer say so; they are kept here for parity
and are a later piece of work to re-tune for the H100.

Layout, as the JAX package defines it:

  * Matrix rows map to LANES, 128 per block; ``nblk`` consecutive blocks
    form a step.  Each step stores ``GS`` sublane rows of 128 slots
    (``data``: (nsteps, GS, 128)), block by block, each block's depth a
    multiple of 4 rows.
  * Slot (st, q, r) multiplies ``x[128*(band_lo[st] + base(st, q)) +
    idx(st, q, r)]``: ``idx`` is a window-local byte index (packed 4 per
    int32, or one uint8 per slot), ``base`` the sublane row's band
    (``bands``, plus ``seg[st, q // 256]`` for a narrow segment of a
    segmented packing).
  * The 4-row group ``g = q // 4`` adds into block ``blocks[st, 0,
    g//2 + (g%2)*GS/8]`` of its step (the ``[even | odd]`` order); a
    value of ``nblk`` marks a dummy group.
  * Entries deeper than a window's byte-optimal capped depth go to a COO
    remainder (``sp_row/sp_col/sp_val``), added outside the kernel.

The card does not stream this container.  Its padding (fill 0.12 on tiled
1138bus: about 167 MB against 38 MB of CSR) would cost more bytes than the
library's whole CSR product, so :class:`BellOperator` derives a padding-free
SELL-C-sigma form from its levels at construction (:mod:`.sell`) and runs
every product over it, through ``csrc/sell_spmv.cu`` and
``csrc/sell_spmm.cu`` on the card.  The container's own products
(:func:`bell_matvec_plain`, :func:`bell_matmat_plain`,
:func:`bell_levels_matvec`) stay as its meaning in plain torch: the JAX
parity tests and :meth:`BellOperator.plain` use them.  The packer also
emits a CSR map from each (step, block) pair to its 4-row groups in
ascending position (``grp_ptr``, ``grp_idx``), which the JAX container
does not have.  The TPU kernels' one-hot staging modes (``stage=``,
``passes=``), their call-time VMEM guard, the band-major layout of X
(``_to_band_major``) and the K chunking of wide blocks (``_mm_kmax``,
``lax.map``) have no counterpart.

The planners run in the native C++ pipeline (:mod:`..native`) where its
library is available, else in NumPy, with the same plan array for array;
``device=None`` keeps a container's arrays in NumPy, any other device
gives tensors there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import formats as F
from ..native import available as native_available
from ..native import bell_plan_native, bell_sort_plan_w1_native
from .sell import sell_bytes, sell_from_levels, sell_matmat, sell_matvec
from ..ops.base import LinearOperator
from ..utils.types import as_dtype, to_tensor

__all__ = ["BELL", "SpanError", "BellOperator",
           "bell_from_coo", "bell_to_device", "bell_fill",
           "bell_stream_bytes", "bell_map_bytes", "bell_with_values_dtype",
           "bell_with_idx_fmt", "bell_to_dense", "bell_matvec_plain",
           "bell_levels_matvec", "bell_matmat_plain", "bell_levels_matmat",
           "bell_operator", "reorder_rcm", "LANES"]

LANES = 128     # matrix rows per block (lane dimension)
NB_MAX = 1024   # window budget in 128-column bands
GS_TARGET = 1024  # sublane rows per grid step the packer aims for
SEG_ROWS = 256   # sublane rows per staging segment (segmented mode)
SEG_BANDS = 256  # x bands staged per segment (segmented mode)


class SpanError(ValueError):
    """A grid step's rows reference a wider column range than the window
    budget allows.  Reorder (RCM) or use the ELL path."""


class BELL(NamedTuple):
    """Packed band-sliced ELL (see the module docstring).

    ``data``:  (nsteps, GS, 128) values (zero-padded).
    ``lanes``: window-local indices in [0, 256).  ``idx_fmt="packed"``:
               (nsteps, GS//4, 128) int32, 4 per word — byte j of word m
               is the index of sublane row ``j*GS//4 + m``;
               ``idx_fmt="int8"``: (nsteps, GS, 128) uint8.
    ``bands``: (nsteps, 1, GS) int32 window-relative base band of each
               sublane row, or (nsteps, nseg, SEG_ROWS) segment-relative
               in a segmented packing.
    ``blocks``: (nsteps, 1, GS//4) int32 block of each 4-row group, in
               [even groups | odd groups] order; ``nblk`` marks a dummy.
    ``band_lo``: (nsteps,) int32 first band of each step's x window.
    ``sp_row/sp_col/sp_val``: COO remainder.
    ``shape``: logical (m, n); ``padded_shape``: the padded operand
               sizes; ``nb``: window bands; ``nblk``: blocks per step;
               ``nnz``: true nonzeros (incl. ``nnz_spill`` in the
               remainder).
    ``seg``:   None (monolithic) or (nsteps, nseg) int32 per-segment
               window starts (``-8``: a wide segment, bands stay
               window-relative).
    ``grp_ptr``/``grp_idx``: the kernel's map, (nsteps*nblk + 1,) and
               (groups,) int32: the 4-row groups of pair ``st*nblk + b``
               are ``grp_idx[grp_ptr[p]:grp_ptr[p+1]]``, ascending.
    """
    data: object
    lanes: object
    bands: object
    blocks: object
    band_lo: object
    sp_row: object
    sp_col: object
    sp_val: object
    shape: Tuple[int, int]
    padded_shape: Tuple[int, int]
    nb: int
    nblk: int
    nnz: int
    nnz_spill: int
    window: int = 2
    idx_fmt: str = "packed"
    seg: object = None
    seg_mixed: int = 0        # count of segments with the wide sentinel
    seg_bands: int = SEG_BANDS  # narrow-segment window width (bands)
    grp_ptr: object = None
    grp_idx: object = None


_SLOT_BYTES = 5       # 4 B value + 1 B packed index per stored slot
_SPILL_BYTES = 12.0   # 4 B value + 4 B row + 4 B col in the COO remainder


def _host(a):
    """A NumPy view of an array or tensor (bf16 tensors as float32)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _itemsize(a):
    if isinstance(a, torch.Tensor):
        return a.element_size()
    return np.dtype(a.dtype).itemsize


def _capped_depth(c, spill_cost):
    """Optimal capped depth for one window with per-lane counts ``c``:
    minimize ``5*128*d + spill_cost*Σ_r max(c_r - d, 0)`` over d ≥ 0.
    Returns (cost, d)."""
    cmax = int(c.max(initial=0))
    if cmax == 0:
        return 0.0, 0
    if spill_cost is None:
        return float(_SLOT_BYTES * LANES * cmax), cmax
    d = np.arange(cmax + 1)
    overflow = np.maximum(c[:, None] - d[None, :], 0).sum(axis=0)
    cost = _SLOT_BYTES * LANES * d + spill_cost * overflow
    j = int(np.argmin(cost))
    return float(cost[j]), j


def _plan_block_windows(C, bu, spill_cost):
    """DP: cover the present bands ``bu`` (ascending) of one block with
    windows of 1–2 *consecutive* bands, minimizing total stream bytes
    ``Σ_w [5·128·d_w + spill·overflow_w]`` where each window's depth d_w
    is itself byte-optimally capped (rows deeper than d_w spill to the
    COO remainder).  ``C`` is (128, len(bu)) per-row-per-band counts.
    Returns (window start band, capped depth, width) lists."""
    nbp = len(bu)
    INF = float("inf")
    dp = np.full(nbp + 1, INF)
    choice = np.zeros(nbp + 1, dtype=np.int8)
    dcap = np.zeros(nbp + 1, dtype=np.int64)
    dp[0] = 0.0
    for j in range(1, nbp + 1):
        c1, d1 = _capped_depth(C[:, j - 1], spill_cost)
        dp[j] = dp[j - 1] + c1
        choice[j], dcap[j] = 1, d1
        if j >= 2 and bu[j - 1] == bu[j - 2] + 1:
            c2, d2 = _capped_depth(C[:, j - 1] + C[:, j - 2], spill_cost)
            if dp[j - 2] + c2 < dp[j]:
                dp[j] = dp[j - 2] + c2
                choice[j], dcap[j] = 2, d2
    starts, depths, width = [], [], []
    j = nbp
    while j > 0:
        w = int(choice[j])
        starts.append(int(bu[j - w]))
        depths.append(int(dcap[j]))
        width.append(w)
        j -= w
    starts.reverse(); depths.reverse(); width.reverse()
    return starts, depths, width


def _plan_blocks_loop(rs, cs, bs, bounds, nblocks, spill_cost):
    """Per-block-Python-loop window planning — kept as the readable
    reference oracle for :func:`_plan_blocks_py`."""
    e_base = np.zeros(len(rs), dtype=np.int64)   # window base band
    e_woff = np.zeros(len(rs), dtype=np.int64)   # window row offset in blk
    e_cap = np.zeros(len(rs), dtype=np.int64)    # window capped depth
    depth_per_block = np.zeros(nblocks, dtype=np.int64)
    for bi in range(nblocks):
        lo, hi = bounds[bi], bounds[bi + 1]
        if lo == hi:
            continue
        bloc = bs[lo:hi]
        bu, bmap = np.unique(bloc, return_inverse=True)
        C = np.zeros((LANES, len(bu)), dtype=np.int64)
        np.add.at(C, (rs[lo:hi] % LANES, bmap), 1)
        starts, depths, width = _plan_block_windows(C, bu, spill_cost)
        # map band -> window index
        wof = np.cumsum([0] + depths[:-1])
        band2w = {}
        for wi, (s, w) in enumerate(zip(starts, width)):
            for bb in range(s, s + w):
                band2w[bb] = wi
        wsel = np.array([band2w[b] for b in bloc], dtype=np.int64)
        darr = np.array(depths, dtype=np.int64)
        e_base[lo:hi] = np.array(starts, dtype=np.int64)[wsel]
        e_woff[lo:hi] = wof[wsel]
        e_cap[lo:hi] = darr[wsel]
        depth_per_block[bi] = int(np.sum(depths))
    return e_base, e_woff, e_cap, depth_per_block


def _cap_and_cost(C, spill_cost):
    """Vectorized byte-optimal capped depth per window.  ``C`` is
    (nkeys, LANES) per-lane counts; returns (cap, cost) arrays.

    Evaluates the SAME float expression as :func:`_capped_depth`
    (``cost(d) = 5*128*d + spill*overflow(d)`` with integer overflow)
    and takes the same first-argmin, so results are bit-identical even
    where the convex cost plateaus and the minimizer is decided by
    floating-point residue (e.g. ``spill_cost = 640/t`` for integer t).
    ``overflow(d)`` comes from per-key count histograms via suffix sums
    — O(LANES + maxdepth) per key, chunked to bound the (keys, depth)
    scratch matrix."""
    nkeys = C.shape[0]
    if spill_cost is None:
        cap = C.max(axis=1)
        return cap, _SLOT_BYTES * LANES * cap.astype(np.float64)
    cap = np.zeros(nkeys, dtype=np.int64)
    cost = np.zeros(nkeys, dtype=np.float64)
    step = max(1, (1 << 22) // max(2, int(C.max(initial=0)) + 2))
    for lo in range(0, nkeys, step):
        Cc = C[lo:lo + step]
        D = int(Cc.max(initial=0))
        ch = Cc.shape[0]
        if D == 0:
            continue
        hist = np.zeros((ch, D + 1), dtype=np.int64)
        np.add.at(hist, (np.repeat(np.arange(ch), LANES), Cc.ravel()), 1)
        deeper = LANES - np.cumsum(hist, axis=1)      # #{c > d}, d=0..D
        overflow = np.zeros((ch, D + 1), dtype=np.int64)
        overflow[:, :-1] = deeper[:, :-1][:, ::-1].cumsum(axis=1)[:, ::-1]
        costs = (_SLOT_BYTES * LANES * np.arange(D + 1, dtype=np.int64)
                 + spill_cost * overflow)
        j = np.argmin(costs, axis=1)
        cap[lo:lo + step] = j
        cost[lo:lo + step] = costs[np.arange(ch), j]
    return cap, cost


def _plan_blocks_py(rs, cs, bs, bounds, nblocks, spill_cost):
    """Pure-NumPy per-block window planning (the same plan as
    :func:`_plan_blocks_loop`, which it is tested against).

    Vectorized across blocks: the 1-or-2-consecutive-band window DP
    runs as a lockstep sweep over band POSITIONS (all blocks advance
    their own DP simultaneously), so the Python-level work is
    O(max bands per block) iterations instead of O(nblocks)."""
    n = len(rs)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(nblocks, np.int64))
    blks = rs // LANES
    # (block, band) keys in sorted order; kid maps entries -> keys
    key = blks * (np.int64(bs.max()) + 2) + bs
    ukey, kid = np.unique(key, return_inverse=True)
    nkeys = len(ukey)
    C = np.zeros((nkeys, LANES), dtype=np.int64)
    np.add.at(C, (kid, rs % LANES), 1)
    ublk = ukey // (np.int64(bs.max()) + 2)
    uband = ukey % (np.int64(bs.max()) + 2)

    cap1, cost1 = _cap_and_cost(C, spill_cost)
    # pair windows join key k-1 and k when same block, consecutive bands
    pair_ok = np.zeros(nkeys, dtype=bool)
    if nkeys > 1:
        pair_ok[1:] = (ublk[1:] == ublk[:-1]) & (uband[1:] == uband[:-1] + 1)
    cap2 = np.zeros(nkeys, dtype=np.int64)
    cost2 = np.full(nkeys, np.inf)
    if pair_ok.any():
        pk = np.flatnonzero(pair_ok)
        cap2[pk], cost2[pk] = _cap_and_cost(C[pk] + C[pk - 1], spill_cost)

    # per-block key ranges
    bfirst = np.flatnonzero(np.r_[True, np.diff(ublk) != 0])
    bcnt = np.diff(np.r_[bfirst, nkeys])       # keys per present block
    nb = len(bfirst)
    J = int(bcnt.max())

    # lockstep DP over band positions: dp[:, j] = best bytes covering
    # the block's first j bands; choice 1 = single-band window ending
    # at j, 2 = pair window covering bands j-1..j
    INF = np.inf
    dp = np.full((nb, J + 1), INF)
    choice = np.zeros((nb, J + 1), dtype=np.int8)
    dp[:, 0] = 0.0
    pos = np.arange(nb)
    for j in range(1, J + 1):
        act = bcnt >= j
        gk = (bfirst + (j - 1)) % nkeys   # mod only guards inactive rows
        v1 = np.where(act, dp[:, j - 1] + cost1[gk], INF)
        if j >= 2:
            ok2 = act & pair_ok[gk]
            v2 = np.where(ok2, dp[:, j - 2] + cost2[gk], INF)
        else:
            v2 = np.full(nb, INF)
        take2 = v2 < v1                         # strict: ties keep singles
        dp[:, j] = np.where(take2, v2, v1)
        choice[:, j] = np.where(act, np.where(take2, 2, 1), 0)

    # lockstep backtrack: every block walks its choice row from its top
    # position down, stamping one window per sweep iteration
    wstart = np.zeros(nkeys, dtype=bool)        # key starts a window
    wwidth = np.zeros(nkeys, dtype=np.int8)
    ptr = bcnt.copy()
    while True:
        act = ptr > 0
        if not act.any():
            break
        w = choice[pos[act], ptr[act]].astype(np.int64)
        sk = bfirst[act] + ptr[act] - w
        wstart[sk] = True
        wwidth[sk] = w.astype(np.int8)
        ptr[act] -= w
    # window cap: singles read cap1 at the start key, pairs read cap2 at
    # the SECOND key of the pair
    sidx = np.flatnonzero(wstart)
    capw = np.where(wwidth[sidx] == 2, cap2[np.minimum(sidx + 1, nkeys - 1)],
                    cap1[sidx])
    # per-key window start: widths are <= 2, so a non-start key's window
    # starts at the previous key
    ws_of_key = np.arange(nkeys)
    ws_of_key[~wstart] -= 1
    # window row offsets: cumulative depth of earlier windows in the block
    csum = np.cumsum(capw) - capw
    sblk = ublk[sidx]
    sblk_first = np.flatnonzero(np.r_[True, np.diff(sblk) != 0])
    scnt = np.diff(np.r_[sblk_first, len(sidx)])
    woff_w = csum - np.repeat(csum[sblk_first], scnt)
    # scatter window attrs back to keys, then to entries
    win_of_key = np.zeros(nkeys, dtype=np.int64)
    win_of_key[sidx] = np.arange(len(sidx))
    win = win_of_key[ws_of_key]
    cap_of_key = capw[win]
    woff_of_key = woff_w[win]
    base_of_key = uband[ws_of_key]
    depth_per_block = np.zeros(nblocks, dtype=np.int64)
    np.add.at(depth_per_block, sblk, capw)
    return (base_of_key[kid], woff_of_key[kid], cap_of_key[kid],
            depth_per_block)


def _plan_bands_sorted(rows, bs, blk, nblocks, spill_cost):
    """Vectorized single-band window planning (``window=1``) over
    entries PRE-SORTED by (block, band, row, col): each present
    (block, band) pair is its own window with a byte-optimally capped
    depth.  Same contract as the pair-DP planners (per-entry base band
    / window row offset / capped depth + per-block depth) plus the
    (row, window) group starts for the ordinal pass — all from
    run-boundary flags on the sorted arrays (no np.unique, no per-block
    Python loop)."""
    n = len(rows)
    newb = np.empty(n, dtype=bool)
    newb[0] = True
    np.not_equal(blk[1:], blk[:-1], out=newb[1:])
    neww = np.empty(n, dtype=bool)
    neww[0] = True
    np.not_equal(bs[1:], bs[:-1], out=neww[1:])
    neww |= newb                      # (block, band) window boundaries
    kid = np.cumsum(neww) - 1         # window id per entry, 0..nkeys-1
    nkeys = int(kid[-1]) + 1 if n else 0
    C = np.zeros((nkeys, LANES), dtype=np.int64)
    np.add.at(C, (kid, rows % LANES), 1)
    if spill_cost is None:
        cap = C.max(axis=1)
    else:
        # marginal analysis of cost(d) = 5·128·d + spill·overflow(d):
        # raising d by one pays 5·128 bytes and saves
        # spill·#{lanes with count ≥ d}; the optimum is the largest d
        # still worth paying for — the t-th largest per-lane count with
        # t = ceil(5·128 / spill).
        t = int(np.ceil(_SLOT_BYTES * LANES / spill_cost))
        if t > LANES:
            cap = np.zeros(nkeys, dtype=np.int64)
        elif t < 1:
            cap = C.max(axis=1)
        else:
            cap = np.partition(C, LANES - t, axis=1)[:, LANES - t]
    wfirst = np.flatnonzero(neww)     # first entry of each window
    blk_of_key = blk[wfirst]
    csum = np.cumsum(cap) - cap
    kfirst = np.flatnonzero(np.r_[True, np.diff(blk_of_key) != 0])
    kcnt = np.diff(np.r_[kfirst, nkeys])
    woff_key = csum - np.repeat(csum[kfirst], kcnt)
    depth_per_block = np.zeros(nblocks, dtype=np.int64)
    np.add.at(depth_per_block, blk_of_key, cap)
    # (row, window) ordinal-group starts: row changes OR window changes
    newg = neww.copy()
    newg[1:] |= rows[1:] != rows[:-1]
    gfirst = np.flatnonzero(newg)
    return (bs, woff_key[kid], cap[kid], depth_per_block, gfirst)


def bell_from_coo(coo: F.COO, nblk=None, nb_max: int = NB_MAX,
                  min_cols: int = 0, spill_cost: float = _SPILL_BYTES,
                  device="cuda", window: int = 2,
                  idx_fmt: str = "packed", segment: bool = False) -> BELL:
    """Pack COO triples into BELL v2 (host-side).

    ``spill_cost`` is the per-entry byte cost charged for routing an
    entry to the COO remainder instead of a kernel slot; the packer
    minimizes total streamed bytes under it.  ``None`` disables
    spilling (every entry gets a slot, as v1 did).

    ``device=None`` keeps the container arrays in NumPy (candidate
    packings that may be discarded stay on the host); any other value
    gives tensors on that device.

    ``window=2`` (v2 layout) plans one-or-two-band windows with the
    per-block DP; ``window=1`` (v3) plans single-band windows with
    8-aligned block depths, enabling the kernel's grouped scatter
    (8x smaller scatter matmul) and halving the staging matmul — at
    a ~1.2-1.5x slot (stream) cost.  Faster whenever the kernel is
    MXU-bound rather than HBM-bound (scattered sparsity); the banded /
    high-fill regime keeps v2.

    ``segment=True`` enables SEGMENTED staging for wide windows
    (``window=1`` packings whose span exceeds ``SEG_BANDS``): each
    step's 4-row scatter groups are sorted by base band and split into
    ``SEG_ROWS``-row segments, each staging only a ``SEG_BANDS``-band
    slice of the step's x window — the one-hot staging matmuls (whose
    (nb, GS) operands made wide-window packings run ~3x their per-slot
    cost model in round 4) then cost the same as an nb=256 packing
    regardless of the true window width.  Falls back to monolithic
    staging when some sorted segment still spans more than
    ``SEG_BANDS`` bands (the container's ``seg`` field stays None).
    The 4-row group order is free to permute: the grouped scatter map
    is arbitrary per group and the depth fold is group-local.

    Raises :class:`SpanError` when some step's column span exceeds
    ``nb_max`` bands.
    """
    if idx_fmt not in ("packed", "int8"):
        raise ValueError("idx_fmt must be 'packed' or 'int8', got %r"
                         % (idx_fmt,))
    m, n = coo.shape
    rows = np.asarray(coo.row).astype(np.int64)
    cols = np.asarray(coo.col).astype(np.int64)
    vals = np.asarray(coo.data)
    store_dtype = vals.dtype
    if store_dtype.name == "bfloat16":
        # bf16 STORAGE (2 B/slot value stream; the kernel computes in
        # f32 — exact in the stored matrix): NumPy ufuncs like add.at
        # don't cover ml_dtypes, so pack through f32 (bf16->f32 is
        # exact) and round the emitted arrays back
        vals = vals.astype(np.float32)
    nnz = len(vals)
    if nnz == 0:
        # synthetic zero entry so the shapes below are non-degenerate;
        # it must never be spill-analyzed (a spurious remainder entry
        # would report nnz_spill=1 > nnz=0 and corrupt fill stats)
        rows = np.zeros(1, dtype=np.int64)
        cols = np.zeros(1, dtype=np.int64)
        vals = np.zeros(1, dtype=vals.dtype)
        spill_cost = None

    nblocks = max(1, -(-m // LANES))
    ncb = max(1, -(-n // LANES), -(-min_cols // LANES))
    blk = rows // LANES
    band = cols // LANES

    # --- per-block window plan (DP over present bands) ---------------
    if window == 1:
        # Single-sort pipeline: order by (block, band, row, col) so
        # (block, band) windows AND (row, window) ordinal groups are
        # both contiguous runs — no np.unique, no second lexsort, no
        # ordinal scatter-back.  The native planner fuses the sort, the
        # caps and the ordinals in one C++ pass.
        plan = bell_sort_plan_w1_native(rows, cols, nblocks, spill_cost)
        if plan is not None:
            order, rs, cs, e_woff, e_cap, k, depth_per_block = plan
            e_base = bs = cs // LANES
            vs = vals[order]
        else:
            order = np.lexsort((cols, rows, band, rows // LANES))
            rs, cs, bs, vs = (rows[order], cols[order], band[order],
                              vals[order])
            e_base, e_woff, e_cap, depth_per_block, gfirst = \
                _plan_bands_sorted(rs, bs, rs // LANES, nblocks, spill_cost)
            # (row, window) groups are contiguous; the planner returned
            # their start offsets
            gsizes = np.diff(np.r_[gfirst, len(rs)])
            k = np.arange(len(rs)) - np.repeat(gfirst, gsizes)
        blks = bs_blk = rs // LANES
        bounds = np.searchsorted(bs_blk, np.arange(nblocks + 1))
        # 4-align block depths so scatter groups never straddle blocks
        # (the kernel folds 4-row halves of each (8,128) tile; 8-align
        # wasted +24% slots on jpwh-class scatter, 4-align +7.5%)
        depth_per_block = -(-depth_per_block // 4) * 4
    else:
        order = np.lexsort((cols, rows))
        rs, cs, bs, vs = rows[order], cols[order], band[order], vals[order]
        blks = bs_blk = rs // LANES
        bounds = np.searchsorted(bs_blk, np.arange(nblocks + 1))
        plan = bell_plan_native(rs, cs, nblocks, spill_cost)
        if plan is None:
            plan = _plan_blocks_py(rs, cs, bs, bounds, nblocks, spill_cost)
        e_base, e_woff, e_cap, depth_per_block = plan
        depth_per_block = np.maximum(depth_per_block, 1)
        # 4-align so the grouped scatter applies to band-pair windows
        # too (window caps stay exact; only block TOTALS pad)
        depth_per_block = -(-depth_per_block // 4) * 4

    # --- per-entry depth ordinal within (row, window) -----------------
    # Entries whose ordinal reaches the window's capped depth spill to
    # the COO remainder.  The window-1 planners gave them above.
    if window != 1:
        # entries are (row, col)-sorted; within a row, same-window
        # entries are consecutive in this order only per band pair —
        # order by (row, window) explicitly
        wkey = blks * (2 * ncb + 2) + e_base  # unique per (blk, window)
        okey = np.lexsort((cs, wkey, rs))
        r2, w2 = rs[okey], wkey[okey]
        gfirst = np.flatnonzero(np.r_[True, (np.diff(r2) != 0) |
                                      (np.diff(w2) != 0)])
        gsizes = np.diff(np.r_[gfirst, len(r2)])
        k2 = np.arange(len(r2)) - np.repeat(gfirst, gsizes)
        k = np.empty(len(rs), dtype=np.int64)
        k[okey] = k2
    keep = k < e_cap

    # per-block window-base extent (kept entries only — the remainder
    # never touches the kernel's x window), for sizing each step's span
    blk_lo = np.full(nblocks, np.iinfo(np.int64).max, dtype=np.int64)
    blk_hi = np.full(nblocks, -1, dtype=np.int64)
    np.minimum.at(blk_lo, blks[keep], e_base[keep])
    np.maximum.at(blk_hi, blks[keep], e_base[keep])

    def _step_span(nb_per_step):
        ns = -(-nblocks // nb_per_step)
        lo = np.full(ns * nb_per_step, np.iinfo(np.int64).max, np.int64)
        hi = np.full(ns * nb_per_step, -1, np.int64)
        lo[:nblocks], hi[:nblocks] = blk_lo, blk_hi
        slo = lo.reshape(ns, nb_per_step).min(1)
        shi = hi.reshape(ns, nb_per_step).max(1)
        ok = shi >= 0
        return int((shi[ok] - slo[ok]).max()) + 2 if ok.any() else 2

    # --- steps of nblk blocks, padded to uniform GS -------------------
    if nblk is None:
        avg_d = max(1.0, float(depth_per_block.mean()))
        # w1's cheaper per-slot path tolerates (and measured-prefers)
        # larger steps: GS 1440-2144 beat 1088 by ~10% on the 1M-row
        # chain (probe_bell_chain), so target ~1.5x more rows per step
        gs_target = GS_TARGET * 3 // 2 if window == 1 else GS_TARGET
        cap = 96 if window == 1 else 64
        nblk = int(max(1, min(cap, round(gs_target / avg_d))))
        nblk = max(8, -(-int(nblk) // 8) * 8)
        # fewer blocks per step ⇒ narrower per-step column span; shrink
        # until the x window fits the budget (the final check still
        # raises if even 8 blocks/step cannot fit).  When the WHOLE
        # column space fits one window (full-width matrices like the
        # 131k power-law class: exactly nb_max bands), shrinking buys
        # nothing — the conservative +2 margin here otherwise forces
        # nblk=8 and fragments the grid into tiny steps (r5).
        if -(-n // LANES) > nb_max:
            while nblk > 8 and _step_span(nblk) > nb_max:
                nblk = max(8, nblk // 2)
    nblk = max(8, -(-int(nblk) // 8) * 8)
    # more blocks per step than exist just inflates the scatter matmul
    nblk = min(nblk, max(8, -(-nblocks // 8) * 8))

    def _gs_for(nblk_c):
        ns = -(-nblocks // nblk_c)
        d = np.zeros(ns * nblk_c, dtype=np.int64)
        d[:nblocks] = depth_per_block
        return max(32, -(-int(d.reshape(ns, nblk_c).sum(1).max())
                         // 32) * 32)

    # scoped-VMEM feasibility cap: the kernel's stack transients scale
    # with GS (~10 slots of (GS, 128) f32) next to >= 2 ring slots —
    # a packing the acceptance guard (linop._try_bell) would reject
    # must not be generated when a smaller nblk avoids it
    nbE = min(nb_max, max(8, -(-n // LANES)))
    while nblk > 8:
        GS_e = _gs_for(nblk)
        ring_e = (nbE * LANES * 4 + GS_e * LANES * 4
                  + (GS_e // 4) * LANES * 4)
        if 10 * GS_e * LANES * 4 + 2 * ring_e <= (15 << 20):
            break
        nblk = max(8, nblk - 8)
    nsteps = -(-nblocks // nblk)
    nblocks_p = nsteps * nblk

    dpb = np.zeros(nblocks_p, dtype=np.int64)
    dpb[:nblocks] = depth_per_block
    step_of_block = np.arange(nblocks_p) // nblk
    rows_per_step = np.zeros(nsteps, dtype=np.int64)
    np.add.at(rows_per_step, step_of_block, dpb)
    # lanes/4 stays 8-aligned; >= 32 even when the byte-optimal plan
    # spills every entry (the kernel then just emits zeros and the COO
    # remainder carries the matrix)
    GS = max(32, -(-int(rows_per_step.max()) // 32) * 32)

    # sublane-row offset of each block within its step
    roff = np.cumsum(dpb) - dpb
    step_row0 = np.zeros(nsteps, dtype=np.int64)
    step_row0[1:] = np.cumsum(rows_per_step)[:-1]
    row_in_step_of_block = roff - step_row0[step_of_block]

    # --- kept-entry placement ------------------------------------------
    rs_k, cs_k, vs_k = rs[keep], cs[keep], vs[keep]
    blks_k, base_k = blks[keep], e_base[keep]
    e_step = blks_k // nblk
    e_q = (row_in_step_of_block[blks_k] + e_woff[keep]
           + k[keep])                                 # sublane row in step
    e_lane = rs_k % LANES
    e_idx = cs_k - base_k * LANES                     # in [0, 128*window)
    if len(e_idx):
        assert e_idx.min() >= 0 and e_idx.max() < LANES * window

    # --- window span per step ----------------------------------------
    band_lo_raw = np.full(nsteps, 2**31 - 1, dtype=np.int64)
    band_hi = np.zeros(nsteps, dtype=np.int64)
    np.minimum.at(band_lo_raw, e_step, base_k)
    np.maximum.at(band_hi, e_step, base_k)
    band_lo_raw = np.minimum(band_lo_raw, band_hi)
    # 8-align the window starts: Mosaic dynamic HBM slices of operands
    # wider than one lane tile (the SpMM kernel's (nbands, K*128) x
    # block) must be provably 8-divisible in the sliced dimension
    band_lo_raw = (band_lo_raw // 8) * 8
    span = int((band_hi - band_lo_raw).max()) + window if nnz else window
    # budget check on the TRUE span; nb itself rounds up to the 8-aligned
    # DMA shape (a non-multiple-of-8 nb_max must not reject fitting spans)
    if span > nb_max:
        raise SpanError(
            "step column span of %d bands exceeds the %d-band window "
            "budget; RCM-reorder the matrix or use the ELL path"
            % (span, nb_max))
    nb = max(8, -(-span // 8) * 8)
    ncb = max(ncb, nb)
    # the right-edge clamp must PRESERVE the 8-alignment the SpMM
    # kernel's oct-unit window start depends on: pad the x bands so the
    # clamp target (ncb - nb) is itself a multiple of 8 (<= 7 extra
    # zero bands; a non-aligned clamp silently shifted the SpMM window
    # left and returned wrong products on right-edge steps)
    ncb = nb + -(-(ncb - nb) // 8) * 8
    band_lo = np.minimum(band_lo_raw, ncb - nb).astype(np.int32)
    assert not band_lo.size or not (band_lo % 8).any()

    # --- segmented staging (wide single-band windows) ------------------
    # Sort each step's 4-row scatter groups by base band, split rows
    # into SEG_ROWS segments, give each its own SEG_BANDS sub-window:
    # the staging one-hots then cost O(SEG_BANDS · GS) per step instead
    # of O(nb · GS).  Group order is free (the scatter map is per-group
    # and the fold is group-local); kept-entry placement just rides the
    # permuted sublane-row positions.
    seg = None
    seg_mixed = 0
    seg_bands = SEG_BANDS
    base_rel = base_k - band_lo[e_step].astype(np.int64)
    gperm = None
    if segment and window == 1 and nb > SEG_BANDS and len(e_q):
        gsg = GS // 4
        gmin = np.full((nsteps, gsg), np.iinfo(np.int64).max)
        np.minimum.at(gmin, (e_step, e_q // 4), base_rel)
        order = np.argsort(gmin, axis=1, kind="stable")  # new pos -> old g
        inv = np.argsort(order, axis=1, kind="stable")   # old g -> new pos
        e_q2 = inv[e_step, e_q // 4] * 4 + (e_q % 4)
        nseg = -(-GS // SEG_ROWS)
        eseg = e_q2 // SEG_ROWS
        big = np.iinfo(np.int64).max
        smin = np.full((nsteps, nseg), big)
        smax = np.full((nsteps, nseg), -1)
        np.minimum.at(smin, (e_step, eseg), base_rel)
        np.maximum.at(smax, (e_step, eseg), base_rel)
        smin0 = np.where(smin == big, 0, smin)
        # Candidate narrow widths: pick the one minimizing the measured
        # two-term staging model (3.2 ps per staged (band, row) pair —
        # probe_ablate_r5); segments whose sorted span exceeds even the
        # widest candidate stage against the FULL window in-kernel
        # (sentinel -8, bands stay window-relative).  Monolithic staging
        # (nsteps · nb · GS) stays when it models cheaper.
        best = (nsteps * nb * GS, None)   # (staged band·rows, plan)
        for W in (256, 384, 512):
            if W >= nb:
                break
            sloW = np.minimum(smin0 // 8 * 8, nb - W)
            narW = smax - sloW <= W - window
            nwide = int((~narW).sum())
            cost = ((narW.size - nwide) * W + nwide * nb) * SEG_ROWS
            if cost < best[0]:
                best = (cost, (W, sloW, narW, nwide))
        if best[1] is not None:
            seg_bands, slo, narrow, seg_mixed = best[1]
            e_nar = narrow[e_step, eseg]
            base_rel = np.where(e_nar, base_rel - slo[e_step, eseg],
                                base_rel)
            e_q = e_q2
            seg = np.where(narrow, slo, -8).astype(np.int32)
            gperm = order

    # --- emit arrays ---------------------------------------------------
    data = np.zeros((nsteps, GS, LANES), dtype=vals.dtype)
    # idx fits a byte by construction (window-local < 128*window); the
    # u8 scratch is upcast once at packing time
    idx8 = np.zeros((nsteps, GS, LANES), dtype=np.uint8)
    bands = np.zeros((nsteps, 1, GS), dtype=np.int32)

    # add.at: duplicate COO entries accumulate (matches to_dense).
    # Every non-dummy sublane row (window, k) has k < d_w ≤ max_r count,
    # so some row with count > k witnesses it (that row's k-th entry is
    # kept): bands/blocks are fully covered by the per-entry writes
    # (all entries at a row agree on base and block).
    np.add.at(data, (e_step, e_q, e_lane), vs_k)
    idx8[e_step, e_q, e_lane] = e_idx
    bands[e_step, 0, e_q] = base_rel.astype(np.int32)

    # grouped scatter map (both window modes): one block id per
    # 4-sublane-row group (depths are 4-aligned so groups never straddle
    # blocks).  The kernel reduces each (8,128) tile's two 4-row halves
    # separately and concatenates [even halves | odd halves], so the map
    # is stored in that split order.
    gsg = GS // 4
    blocksN = np.full((nsteps, gsg), nblk, dtype=np.int32)
    ngrp = dpb // 4
    tot = int(ngrp.sum())
    if tot:
        gstep = np.repeat(step_of_block, ngrp)
        gpos0 = np.repeat(row_in_step_of_block // 4, ngrp)
        within = np.arange(tot) - np.repeat(np.cumsum(ngrp) - ngrp,
                                            ngrp)
        blocksN[gstep, gpos0 + within] = np.repeat(
            np.arange(nblocks_p) % nblk, ngrp).astype(np.int32)
    if gperm is not None:
        # new group position p holds old group gperm[st, p]
        blocksN = np.take_along_axis(blocksN, gperm, axis=1)
    blocks = np.concatenate([blocksN[:, 0::2], blocksN[:, 1::2]],
                            axis=1)[:, None, :]

    if seg is not None:
        # segmented layout stores bands (nsteps, nseg, SEG_ROWS), tail
        # zero-padded: each kernel segment reads its bands at lane
        # offset 0 (a lane-offset slice of a (1, GS) row cannot be
        # sublane-broadcast by Mosaic)
        nseg = seg.shape[1]
        bpad = np.zeros((nsteps, nseg * SEG_ROWS), dtype=np.int32)
        bpad[:, :GS] = bands[:, 0, :]
        bands = bpad.reshape(nsteps, nseg, SEG_ROWS)

    if idx_fmt == "int8":
        lanes_packed = idx8  # stored directly (uint8, zero-extended load)
    else:
        lanes_packed = _pack_idx(idx8)

    # COO remainder (the spilled tail)
    sp = ~keep
    nnz_spill = int(sp.sum())
    sp_row = rs[sp].astype(np.int32)
    sp_col = cs[sp].astype(np.int32)
    sp_val = vs[sp]
    if store_dtype.name == "bfloat16":
        data = data.astype(store_dtype)
        sp_val = sp_val.astype(store_dtype)

    grp_ptr, grp_idx = _group_map(blocks, nblk)
    b = BELL(data, lanes_packed, bands, blocks, band_lo, sp_row, sp_col,
             sp_val, (m, n), (nsteps * nblk * LANES, ncb * LANES),
             int(nb), int(nblk), nnz, nnz_spill, int(window), str(idx_fmt),
             seg=seg, seg_mixed=int(seg_mixed), seg_bands=int(seg_bands),
             grp_ptr=grp_ptr, grp_idx=grp_idx)
    return b if device is None else bell_to_device(b, device)


def _group_map(blocks, nblk):
    """The kernel's map from (step, block) pairs to their 4-row groups:
    ``(grp_ptr, grp_idx)`` int32, groups in ascending position."""
    bl = _host(blocks)[:, 0, :]
    nsteps, gq = bl.shape
    nat = np.empty_like(bl)             # natural group order
    nat[:, 0::2] = bl[:, :gq - gq // 2]
    nat[:, 1::2] = bl[:, gq - gq // 2:]
    st, g = np.nonzero(nat < nblk)      # row-major: ascending g per step
    key = st.astype(np.int64) * nblk + nat[st, g]
    order = np.argsort(key, kind="stable")
    grp_ptr = np.zeros(nsteps * nblk + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=nsteps * nblk), out=grp_ptr[1:])
    return grp_ptr.astype(np.int32), g[order].astype(np.int32)


def bell_to_device(b: BELL, device="cuda") -> BELL:
    """A BELL whose arrays are tensors on ``device``.  The remainder's
    indices become int64."""

    def t(a):
        return None if a is None else to_tensor(a, device=device)

    return b._replace(
        data=t(b.data), lanes=t(b.lanes), bands=t(b.bands),
        blocks=t(b.blocks), band_lo=t(b.band_lo),
        sp_row=t(b.sp_row).long(), sp_col=t(b.sp_col).long(),
        sp_val=t(b.sp_val), seg=t(b.seg), grp_ptr=t(b.grp_ptr),
        grp_idx=t(b.grp_idx))


def bell_fill(b: BELL) -> float:
    """Fraction of stored value slots holding true (kernel-path)
    nonzeros; the COO remainder holds the other ``nnz_spill``."""
    return (b.nnz - b.nnz_spill) / max(1, int(np.prod(b.data.shape)))


def bell_stream_bytes(b: BELL) -> int:
    """Bytes of the matrix a product streams: value + index slots plus the
    COO remainder triples (the JAX package's accounting; x, y and the
    kernel's map are counted apart)."""
    itm = _itemsize(b.data)
    slots = int(np.prod(b.data.shape))
    return slots * (itm + 1) + b.nnz_spill * (itm + 8)


def bell_map_bytes(b: BELL) -> int:
    """Bytes of the kernel's group map and of the per-row bands it reads
    besides the slots."""
    n = int(np.prod(b.bands.shape))
    if b.grp_ptr is not None:
        n += int(np.prod(b.grp_ptr.shape)) + int(np.prod(b.grp_idx.shape))
    return 4 * n


def _pack_idx(idx8):
    """Pack (nsteps, GS, LANES) byte indices 4-per-int32: byte j of
    word m is sublane row ``j*GS/4 + m``."""
    nsteps, GS, L = idx8.shape
    i4 = idx8.reshape(nsteps, 4, GS // 4, L).astype(np.uint32)
    return (i4[:, 0] | (i4[:, 1] << 8) | (i4[:, 2] << 16)
            | (i4[:, 3] << 24)).view(np.int32)


def _unpack_idx(b: BELL):
    """(nsteps, GS, LANES) int window-local indices (host-side)."""
    if b.idx_fmt == "int8":
        return _host(b.lanes).astype(np.int64)
    p = _host(b.lanes).astype(np.int64) & 0xFFFFFFFF
    parts = [(p >> (8 * j)) & 255 for j in range(4)]
    return np.concatenate(parts, axis=1)


def bell_with_values_dtype(b: BELL, dtype) -> BELL:
    """Round a BELL container's stored values to ``dtype`` without
    re-planning (bf16 storage: 3 B per slot; products compute at the
    promoted dtype, exact in the stored matrix)."""
    if isinstance(b.data, torch.Tensor):
        dtype = as_dtype(dtype)
        if b.data.dtype == dtype:
            return b
        return b._replace(data=b.data.to(dtype), sp_val=b.sp_val.to(dtype))
    dtype = np.dtype(dtype)
    if b.data.dtype == dtype:
        return b
    return b._replace(data=b.data.astype(dtype),
                      sp_val=b.sp_val.astype(dtype))


def bell_with_idx_fmt(b: BELL, idx_fmt: str) -> BELL:
    """Repack a BELL container's index storage without re-planning."""
    if idx_fmt == b.idx_fmt:
        return b
    idx = _unpack_idx(b).astype(np.uint8)
    if idx_fmt == "int8":
        lanes = idx
    elif idx_fmt == "packed":
        lanes = _pack_idx(idx)
    else:
        raise ValueError("idx_fmt must be 'packed' or 'int8'")
    if isinstance(b.data, torch.Tensor):
        lanes = to_tensor(lanes, device=b.data.device)
    return b._replace(lanes=lanes, idx_fmt=str(idx_fmt))


def bell_to_dense(b: BELL):
    """Host-side oracle reconstruction (NumPy; tests only)."""
    mp, npad = b.padded_shape
    data = _host(b.data)
    out = np.zeros((mp, npad), dtype=data.dtype)
    idx = _unpack_idx(b)
    nst = data.shape[0]
    # (nsteps, 1, GS) monolithic or (nsteps, nseg, SEG_ROWS) segmented
    bands = _host(b.bands).reshape(nst, -1)[:, :data.shape[1]]
    blocks = _host(b.blocks)[:, 0, :]
    band_lo = _host(b.band_lo)
    seg = None if b.seg is None else _host(b.seg)
    nsteps, GS, L = data.shape
    for st in range(nsteps):
        for q in range(GS):
            g4 = q // 4       # storage order: [even halves | odd halves]
            blko = blocks[st, g4 // 2 + (g4 % 2) * (GS // 8)]
            if blko >= b.nblk:
                continue
            blkrow = (st * b.nblk + blko) * LANES
            base = bands[st, q]
            if seg is not None:
                s = seg[st, q // SEG_ROWS]
                if s >= 0:        # narrow segment: segment-relative
                    base = base + s
            col0 = (band_lo[st] + base) * LANES
            for r in range(L):
                v = data[st, q, r]
                if v != 0:
                    out[blkrow + r, col0 + idx[st, q, r]] += v
    np.add.at(out, (_host(b.sp_row), _host(b.sp_col)), _host(b.sp_val))
    return out[:b.shape[0], :b.shape[1]]


def reorder_rcm(coo: F.COO):
    """Reverse Cuthill–McKee permutation (host-side, via scipy) minimizing
    bandwidth so BELL windows stay small.

    Returns ``(permuted_coo, perm)`` with ``A' = A[perm][:, perm]`` (square
    matrices only) as a host COO; un/re-permuting vectors is the caller's
    job.
    """
    m, n = coo.shape
    if m != n:
        raise ValueError("RCM reordering needs a square matrix")
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    rows = _host(coo.row)
    cols = _host(coo.col)
    a = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, n))
    perm = np.asarray(reverse_cuthill_mckee(a.tocsr(),
                                            symmetric_mode=False))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m)
    return F.coo_from_arrays(_host(coo.data), inv[rows], inv[cols],
                             (m, n), device=None), perm


# ---------------------------------------------------------------------------
# The container's product, in plain torch
# ---------------------------------------------------------------------------

def _check_mv(b, x, rows_out, out):
    """Shape checks of a product over one container; ``x`` is (n,) or, for
    the block product, (n, K).  Returns the number of output rows."""
    block = x.ndim == 2
    if len(b.data.shape) != 3 or x.ndim not in (1, 2):
        raise ValueError("bell_matvec_plain expects data (nsteps, GS, 128) "
                         "and x (n,) or (n, K), got %s and %s"
                         % (tuple(b.data.shape), tuple(x.shape)))
    rows = b.padded_shape[0] if rows_out is None else int(rows_out)
    if not 0 < rows <= b.padded_shape[0]:
        raise ValueError("rows_out %d outside (0, %d]"
                         % (rows, b.padded_shape[0]))
    want = (rows, x.shape[1]) if block else (rows,)
    if out is not None and tuple(out.shape) != want:
        raise ValueError("out has shape %s, expected %s"
                         % (tuple(out.shape), want))
    return rows


def _natural_blocks(blocks):
    """(nsteps, GS/4) block of each 4-row group in natural order."""
    bl = blocks[:, 0, :]
    gq = bl.shape[1]
    nat = torch.empty_like(bl)
    nat[:, 0::2] = bl[:, :gq - gq // 2]
    nat[:, 1::2] = bl[:, gq - gq // 2:]
    return nat


def _slot_coords(b: BELL):
    """What each slot of a container multiplies: the (nsteps, GS, 128)
    int64 column of x of every slot, and the (nsteps, GS/4) block of every
    4-row group in natural order (``nblk``: the dummy block)."""
    nsteps, GS, _ = b.data.shape
    if b.idx_fmt == "int8":
        idx = b.lanes.long()
    else:
        p = b.lanes.long() & 0xFFFFFFFF
        idx = torch.cat([(p >> (8 * j)) & 255 for j in range(4)], dim=1)
    base = b.bands.reshape(nsteps, -1)[:, :GS].long()
    if b.seg is not None:
        s = b.seg.long().repeat_interleave(SEG_ROWS, dim=1)[:, :GS]
        base = base + torch.where(s >= 0, s, torch.zeros_like(s))
    col = ((b.band_lo.long()[:, None] + base) * LANES)[:, :, None] + idx
    return col, _natural_blocks(b.blocks).long()


def _plain_product(b: BELL, x, rows_out, out):
    """The plain product over one container for x of shape (n,) or (n,
    K): gather, product, fold each 4-row group, ``index_add_`` the group
    sums into ``nsteps*(nblk+1)`` block rows, drop the dummy row; a block
    carries its K columns as a trailing axis.  Every slot is multiplied,
    padding included."""
    rows = _check_mv(b, x, rows_out, out)
    nsteps, GS, L = b.data.shape
    tail = tuple(x.shape[1:])            # () or (K,)
    ct = torch.promote_types(b.data.dtype, x.dtype)
    x = x.to(ct)
    dev = b.data.device
    col, blk = _slot_coords(b)
    inside = (col >= 0) & (col < x.shape[0])
    inside = inside.reshape(inside.shape + (1,) * len(tail))
    xv = torch.where(inside, x[col.clamp(0, max(x.shape[0] - 1, 0))],
                     torch.zeros((), dtype=ct, device=dev))
    vals = b.data.to(ct).reshape(b.data.shape + (1,) * len(tail))
    gsum = (vals * xv).reshape((nsteps, GS // 4, 4, L) + tail).sum(dim=2)
    target = torch.arange(nsteps, device=dev)[:, None] * (b.nblk + 1) + blk
    ys = torch.zeros((nsteps * (b.nblk + 1), L) + tail, dtype=ct,
                     device=dev)
    ys.index_add_(0, target.reshape(-1), gsum.reshape((-1, L) + tail))
    y = ys.reshape((nsteps, b.nblk + 1, L) + tail)[:, :b.nblk].reshape(
        (-1,) + tail)[:rows]
    return y if out is None else out.add_(y)


def bell_matvec_plain(b: BELL, x, rows_out=None, out=None):
    """One level's slot product ``y = A_slots x`` in plain torch: gather,
    product, fold each 4-row group, ``index_add_`` the group sums into
    ``nsteps*(nblk+1)`` block rows, drop the dummy row.  The COO remainder
    is not included (see :func:`bell_levels_matvec`).  Returns the first
    ``rows_out`` rows, or adds them into ``out`` and returns it."""
    if x.ndim != 1:
        raise ValueError("bell_matvec_plain expects x (n,), got %s"
                         % (tuple(x.shape),))
    return _plain_product(b, x, rows_out, out)


def bell_matmat_plain(b: BELL, X, rows_out=None, out=None):
    """One level's slot block product in plain torch:
    :func:`bell_matvec_plain`'s gather and ``index_add_`` on a trailing
    axis of K columns.  Returns the first ``rows_out`` rows of ``A_slots
    X`` (rows_out, K), or adds them into ``out`` and returns it."""
    if X.ndim != 2:
        raise ValueError("bell_matmat_plain expects X (n, K), got %s"
                         % (tuple(X.shape),))
    return _plain_product(b, X, rows_out, out)


def bell_levels_matvec(levels, x, rows_out):
    """``A x`` over a packing's levels, the container's own product in
    plain torch: each level's slot product (the second and later ones added
    into the first's ``y``) and its COO remainder, in the promoted dtype of
    the values and x.  An (n, K) block goes through
    :func:`bell_matmat_plain`, its remainder added for every column with
    one ``index_add_`` on (rows, K)."""
    ct = torch.promote_types(levels[0].data.dtype, x.dtype)
    x = x.to(ct)
    product = bell_matmat_plain if x.ndim == 2 else bell_matvec_plain
    tail = (1,) * (x.ndim - 1)
    y = None
    for c in levels:
        y = product(c, x, rows_out, out=y)
        if c.nnz_spill:
            y.index_add_(0, c.sp_row, c.sp_val.to(ct).reshape((-1,) + tail)
                         * x[c.sp_col])
    return y


def bell_levels_matmat(levels, X, rows_out):
    """``A X`` for an (n, K) block over a packing's levels (the container's
    own product in plain torch; see :func:`bell_levels_matvec`)."""
    if X.ndim != 2:
        raise ValueError("bell_levels_matmat expects X (n, K), got %s"
                         % (tuple(X.shape),))
    return bell_levels_matvec(levels, X, rows_out)


# ---------------------------------------------------------------------------
# Choosing a packing: the JAX package's cost model, levels and row split
# ---------------------------------------------------------------------------


def _strip_spill(b: BELL) -> BELL:
    empty_i = np.zeros(0, dtype=np.int32)
    empty_v = np.zeros(0, dtype=np.asarray(b.sp_val).dtype)
    return b._replace(sp_row=empty_i, sp_col=empty_i, sp_val=empty_v,
                      nnz=b.nnz - b.nnz_spill, nnz_spill=0)


# The JAX package's per-slot kernel cost model, measured on its TPU (ps per
# slot; see pykrylov_tpu/sparse/bell.py).  It decides the window mode and
# the level split, so it stays as it is: both packages then pick the same
# layout.  Re-fitting it to the H100 kernel is ROADMAP work.
_SLOT_COST_PS = {1: 12.5, 2: 16.1}
_SLOT_BASE_PS = {1: 10.0, 2: 13.5}
_STAGE_PS_PER_BR = 3.2
_SEG_OVERHEAD_PS = 0.35e6


def _staged_band_rows(b: BELL) -> int:
    """Total (band, sublane-row) pairs the TPU kernel's staging covers
    across all steps — the second term of the cost model."""
    nsteps, GS, _ = (int(s) for s in b.data.shape)
    if b.seg is not None:
        nseg_tot = int(np.prod(b.seg.shape))
        narrow = nseg_tot - b.seg_mixed
        return (narrow * b.seg_bands + b.seg_mixed * b.nb) * SEG_ROWS
    return nsteps * b.nb * GS


def _slot_cost_ps(b: BELL) -> float:
    """Predicted cost per stored slot (ps, the JAX package's two-term
    model)."""
    slots = max(1, int(np.prod(b.data.shape)))
    if b.window == 2:
        return _SLOT_COST_PS[2] * max(1.0, b.nb / 256.0)
    seg_oh = 0.0
    if b.seg is not None and b.seg_mixed:
        seg_oh = _SEG_OVERHEAD_PS * int(np.prod(b.seg.shape)) / slots
    return _SLOT_BASE_PS[1] + seg_oh \
        + _STAGE_PS_PER_BR * _staged_band_rows(b) / slots


def _levels_on(lv, device):
    """The levels with each NumPy level moved to ``device`` (``None``: kept
    in NumPy); levels that hold tensors, and ``lv=None``, pass as they
    are."""
    if lv is None or device is None:
        return lv
    return tuple(b if isinstance(b.data, torch.Tensor)
                 else bell_to_device(b, device) for b in lv)


def _pack_window_auto(coo, nb_max, spill_cost, levels, device="cuda"):
    """Pack with both window modes (host-side) and keep the one the cost
    model predicts faster.  The window-2 pair-DP packing is planned only
    when window 1 fails, when the native planner is available, or below
    100,000 nonzeros: the JAX package's rule, kept so that both packages
    pick the same packing wherever they run."""
    try:
        lv1 = _pack_levels(coo, nb_max, spill_cost, levels, device=None,
                           window=1)
    except SpanError:
        lv1 = None
    lv2 = None
    if lv1 is None or native_available() or coo.data.shape[0] < 100_000:
        try:
            lv2 = _pack_levels(coo, nb_max, spill_cost, levels,
                               device=None, window=2)
        except SpanError:
            lv2 = None
    if lv1 is None and lv2 is None:
        raise SpanError("neither window mode fits the band budget; "
                        "RCM-reorder or use the ELL path")

    def cost(lv):
        if lv is None:
            return float("inf")
        # a remainder entry is priced far above a slot, so packings that
        # spill lose to clean ones of any window mode
        return (sum(int(np.prod(b.data.shape)) * _slot_cost_ps(b)
                    for b in lv)
                + sum(b.nnz_spill for b in lv) * 16000.0)

    win = lv1 if cost(lv1) <= cost(lv2) else lv2
    return _levels_on(win, device)


def _pack_levels(coo, nb_max, spill_cost, levels, device="cuda", window=2):
    """Pack a COO matrix into up to ``levels`` BELL levels: all but the
    last are depth-capped and their overflow feeds the next level's
    packing; the last level is uncapped.  The multi-level split is kept
    only when it stores clearly fewer slots than the single uncapped
    packing.  Levels after the first keep a COO remainder only if their
    own packing overflows the window budget (SpanError).  Indices are
    packed and wide windows segmented, as the JAX package's defaults.
    ``window="auto"`` dispatches to :func:`_pack_window_auto`."""
    if window == "auto":
        return _pack_window_auto(coo, nb_max, spill_cost, levels, device)
    b1 = bell_from_coo(coo, nb_max=nb_max, device=None, window=window,
                       segment=True,
                       spill_cost=spill_cost if levels > 1 else None)
    if levels <= 1 or b1.nnz_spill == 0:
        return _levels_on((b1,), device)
    out = [_strip_spill(b1)]
    cur = b1
    for li in range(1, levels):
        last = li == levels - 1
        nxt_coo = F.coo_from_arrays(np.asarray(cur.sp_val),
                                    np.asarray(cur.sp_row),
                                    np.asarray(cur.sp_col), coo.shape,
                                    device=None)
        try:
            b = bell_from_coo(nxt_coo, nb_max=nb_max, device=None,
                              window=window, segment=True,
                              spill_cost=None if last else spill_cost)
        except SpanError:
            # the overflow is too scattered to window: keep it as the
            # previous level's remainder instead of a new level
            out[-1] = cur
            break
        if b.nnz_spill and not last:
            out.append(_strip_spill(b))
            cur = b
        else:
            out.append(b)
            break
    multi_slots = sum(int(np.prod(b.data.shape)) for b in out)
    if sum(b.nnz_spill for b in out) == 0:
        # keep multi only on a clear (>10%) stream win over the uncapped
        # single-level packing; that packing may itself exceed the window
        # budget, which must not discard the multi-level result
        try:
            b1u = bell_from_coo(coo, nb_max=nb_max, spill_cost=None,
                                device=None, window=window, segment=True)
        except SpanError:
            b1u = None
        if b1u is not None and \
                int(np.prod(b1u.data.shape)) <= 1.1 * multi_slots:
            return _levels_on((b1u,), device)
    return _levels_on(tuple(out), device)


ROW_SPLIT_DEG = 64   # rows at least this dense get a private block


def _row_split_plan(coo, thresh=ROW_SPLIT_DEG):
    """Detect pathologically heavy rows and split each into a private
    128-lane virtual block appended past the row space.

    A deg-d row keeps all d entries in one lane, so its windows cap at
    depth ~d/bands and the block stores 128 lanes per depth row.
    Splitting gives row h a virtual block whose 128 lanes hold its
    column-sorted entries in contiguous chunks; the product sums the
    block's 128 lane outputs back into y[h].

    Returns ``(split_coo, heavy_rows, M0)`` with the virtual blocks at
    rows ``M0 + i*128 .. +127`` (``M0`` = row space padded to a block
    boundary), or None when no row qualifies.  With ``B = [[L], [Av]]``
    and ``S`` the lane-summing selector, ``A = L + S Av`` and
    ``A^T x = L^T x + Av^T (S^T x)``, where ``S^T x`` replicates
    ``x[heavy]`` over each virtual block's lanes.
    """
    m, n = coo.shape
    rows = _host(coo.row).astype(np.int64)
    cols = _host(coo.col).astype(np.int64)
    vals = _host(coo.data)
    deg = np.bincount(rows, minlength=m)
    heavy = np.flatnonzero(deg >= thresh)
    if len(heavy) == 0 or deg[heavy].sum() < max(256, 0.005 * len(rows)):
        return None
    M0 = -(-m // LANES) * LANES
    hidx = np.full(m, -1, np.int64)
    hidx[heavy] = np.arange(len(heavy))
    is_h = hidx[rows] >= 0
    hr, hc, hv = rows[is_h], cols[is_h], vals[is_h]
    order = np.lexsort((hc, hr))
    hr, hc, hv = hr[order], hc[order], hv[order]
    starts = np.flatnonzero(np.r_[True, hr[1:] != hr[:-1]])
    sizes = np.diff(np.r_[starts, len(hr)])
    posin = np.arange(len(hr)) - np.repeat(starts, sizes)
    lane = posin * LANES // np.repeat(sizes, sizes)
    vrow = M0 + hidx[hr] * LANES + lane
    rows2 = np.concatenate([rows[~is_h], vrow])
    cols2 = np.concatenate([cols[~is_h], hc])
    vals2 = np.concatenate([vals[~is_h], hv])
    shape2 = (int(M0 + len(heavy) * LANES), n)
    return (F.coo_from_arrays(vals2, rows2, cols2, shape2, device=None),
            heavy.astype(np.int32), int(M0))


def _split_transpose_levels(coo_k, M0, nb_max, sc, levels, window,
                            device="cuda"):
    """Pack ``(L^T, Av^T)`` from the row-split matrix ``coo_k`` (light
    entries at rows < M0, virtual entries at rows >= M0)."""
    rows = _host(coo_k.row)
    cols = _host(coo_k.col)
    vals = _host(coo_k.data)
    n = coo_k.shape[1]
    light = rows < M0
    cooLT = F.coo_from_arrays(vals[light], cols[light], rows[light],
                              (n, M0), device=None)
    cooAT = F.coo_from_arrays(vals[~light], cols[~light],
                              rows[~light] - M0,
                              (n, coo_k.shape[0] - M0), device=None)
    lvL = _pack_levels(cooLT, nb_max, sc, levels, device=device,
                       window=window)
    lvA = _pack_levels(cooAT, nb_max, sc, levels, device=device,
                       window=window)
    return (lvL, lvA)


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class BellOperator(LinearOperator):
    """LinearOperator over BELL levels whose products run over the card
    form each tuple of levels derives at construction
    (:func:`~.sell.sell_from_levels`): :func:`~.sell.sell_matvec` and, on
    (n, K) blocks, :func:`~.sell.sell_matmat`, which launch the CUDA
    kernels on CUDA tensors and run their plain versions on CPU tensors.
    :meth:`plain` gives the same operator over the containers' own plain
    products instead (:func:`bell_levels_matvec`).

    ``fwd``/``bwd`` are the levels of A and A^T (``bwd`` None: symmetric,
    or no transpose).  ``split=(heavy, M0)``: a row-split packing, whose
    ``bwd`` is the pair ``(levels of L^T, levels of Av^T)``.
    ``perm=(p, ip)``: the levels hold ``A' = A[p][:, p]`` and the
    operator applies ``A = P^T A' P`` by two gathers per product;
    ``solve_permutation = (p, ip, inner)`` lets ``solve()`` work in the
    permuted space instead (``inner`` shares this operator's card forms).
    ``bwd_ell``: an ELL container of A^T for the transpose product, which
    applies a block column by column.  Every other product has its block
    twin, as the JAX package's ``_bell_mm_factory``,
    ``_bell_mm_perm_factory`` and the split rules
    ``_bell_split_mm_factory``/``_bell_split_rmm_factory`` give it.

    ``card`` is the forward product's card form (None for :meth:`plain`)
    and ``card_bytes`` the bytes a matvec reads from it, beside the
    containers' ``stream_bytes``; ``cards`` maps each product the operator
    runs (``"fwd"``, and ``"bwd"`` for the transpose, or ``"bwd_l"`` and
    ``"bwd_a"`` for a row split's) to its card form.
    """

    fmt = "bell"

    def __init__(self, shape, fwd, bwd=None, symmetric=False, perm=None,
                 split=None, bwd_ell=None, plain=False, _cards=None):
        self._args = dict(shape=shape, fwd=fwd, bwd=bwd,
                          symmetric=symmetric, perm=perm, split=split,
                          bwd_ell=bwd_ell)
        m, n = shape
        H = 0 if split is None else int(split[0].shape[0])
        # rows of the levels' product: the split's virtual rows included
        level_rows = split[1] + H * LANES if split is not None else m
        # (levels, rows of their product) of each product the operator runs
        products = {"fwd": (fwd, level_rows)}
        if bwd is not None and bwd_ell is None and not symmetric:
            if split is not None:
                products.update(bwd_l=(bwd[0], n), bwd_a=(bwd[1], n))
            else:
                products["bwd"] = (bwd, n)
        if plain:
            cards = None
        elif _cards is not None:
            cards = _cards
        else:
            cards = {key: sell_from_levels(lv, rows)
                     for key, (lv, rows) in products.items()}

        def rules(key):
            """(1-D rule, block rule) of one product."""
            if plain:
                lv, rows = products[key]
                return (lambda x: bell_levels_matvec(lv, x, rows),
                        lambda X: bell_levels_matmat(lv, X, rows))
            card = cards[key]
            return (lambda x: sell_matvec(card, x),
                    lambda X: sell_matmat(card, X))

        bwd_rules = None
        if split is not None:
            heavy, M0 = split

            def fold(inner):
                # each heavy row's 128 virtual lanes sum back into its row
                def rule(x):
                    y = inner(x)
                    hv = y[M0:].reshape((H, LANES) + tuple(y.shape[1:]))
                    return y[:m].index_add_(0, heavy, hv.sum(dim=1))
                return rule

            def spread(inner_l, inner_a):
                # A^T x = L^T x + Av^T (x[heavy] over its block's lanes)
                return lambda x: inner_l(x) + inner_a(
                    x[heavy].repeat_interleave(LANES, dim=0))

            fwd_rules = tuple(fold(r) for r in rules("fwd"))
            if "bwd_l" in products:
                bwd_rules = tuple(spread(rl, ra) for rl, ra in zip(
                    rules("bwd_l"), rules("bwd_a")))
        else:
            fwd_rules = rules("fwd")
            if "bwd" in products:
                bwd_rules = rules("bwd")
        if bwd_ell is not None:
            bwd_rules = (lambda x: F.ell_matvec(bwd_ell, x), None)
        self.solve_permutation = None
        if perm is not None:
            p, ip = perm
            self.solve_permutation = (p, ip, BellOperator(
                shape, fwd, bwd, symmetric, plain=plain, _cards=cards))

            def permuted(inner):
                return None if inner is None else (lambda x: inner(x[p])[ip])

            fwd_rules = tuple(map(permuted, fwd_rules))
            if bwd_rules is not None:
                bwd_rules = tuple(map(permuted, bwd_rules))
        if symmetric:
            bwd_rules = fwd_rules
        mv, mm = fwd_rules
        rmv, rmm = bwd_rules if bwd_rules is not None else (None, None)
        dtype = fwd[0].data.dtype
        super().__init__(n, m, matvec=mv, matvec_transp=rmv,
                         symmetric=symmetric,
                         hermitian=symmetric and not dtype.is_complex,
                         dtype=dtype, device=fwd[0].data.device,
                         matmat=mm, matmat_transp=rmm)
        nnz_tot = sum(b.nnz for b in fwd)
        self.levels = fwd
        self.cards = cards
        self.card = None if cards is None else cards["fwd"]
        self.card_bytes = None if cards is None else sell_bytes(self.card)
        self.fill = bell_fill(fwd[0])
        self.spill_frac = (nnz_tot - fwd[0].nnz + fwd[0].nnz_spill) / max(
            1, nnz_tot)
        self.stream_bytes = sum(bell_stream_bytes(b) for b in fwd)
        self.bytes_per_nnz = self.stream_bytes / max(1, nnz_tot)
        self.remainder = sum(b.nnz_spill for b in fwd)
        self.nb_max_level = max(b.nb for b in fwd)
        self.split_rows = H
        self.level_rows = level_rows

    def plain(self):
        """The same operator over the same containers with every product
        through the containers' own plain products
        (:func:`bell_levels_matvec`, on any device)."""
        return BellOperator(plain=True, **self._args)


def _host_coo(source):
    if isinstance(source, F.COO):
        return F.coo_from_arrays(_host(source.data), _host(source.row),
                                 _host(source.col), source.shape,
                                 sort=False, device=None)
    if isinstance(source, tuple) and len(source) == 4:
        vals, rows, cols, shp = source
        return F.coo_from_arrays(vals, rows, cols, shp, device=None)
    a = _host(source)
    rr, cc = np.nonzero(a)
    return F.coo_from_arrays(a[rr, cc], rr, cc, a.shape, device=None)


def _build_split_operator(split, m, n, symmetric, with_transpose, nb_max,
                          levels, window, prepacked, device):
    """The row-split operator (see :func:`_row_split_plan`): forward = one
    product over ``B = [[L], [Av]]`` + lane fold; transpose = two
    products (``L^T``, ``Av^T``)."""
    coo_k, heavy, M0 = split
    if prepacked is not None:
        fwd, bwd = prepacked
        fwd = _levels_on(fwd, device)
        bwd = None if bwd is None else tuple(
            _levels_on(p, device) for p in bwd)
    else:
        fwd = _pack_levels(coo_k, nb_max, _SPILL_BYTES, levels,
                           device=device, window=window)
        if symmetric or not with_transpose:
            bwd = None
        else:
            bwd = _split_transpose_levels(coo_k, M0, nb_max, _SPILL_BYTES,
                                          levels, window, device)
    heavy = torch.as_tensor(np.asarray(heavy, dtype=np.int64),
                            device=device)
    return BellOperator((m, n), fwd, bwd, symmetric, split=(heavy, M0))


def bell_operator(source, symmetric=False, nb_max: int = NB_MAX,
                  reorder=False, levels: int = 2, with_transpose=True,
                  window="auto", split_rows="auto", device="cuda",
                  _prepacked=None, _split=None):
    """Wrap a matrix as a :class:`BellOperator` on ``device`` (the
    counterpart of the JAX package's ``bell_operator``, with its defaults
    for the options the port does not expose: the remainder's cost, packed
    indices, segmented staging).

    ``source``: COO container, ``(vals, rows, cols, shape)`` triples or a
    dense array.  The operator acts on the logical (m, n) shapes.
    ``levels=2`` packs a depth-capped level plus an uncapped level for
    its overflow.  ``reorder=True`` packs the RCM-permuted matrix (square
    only) and wraps the permutation into the products.  ``window="auto"``
    plans both window modes and keeps the cost model's pick; 1 or 2
    forces one.  ``with_transpose=False`` skips packing A^T.
    ``split_rows="auto"`` gives heavy rows private blocks.
    """
    coo = _host_coo(source)
    m, n = coo.shape
    perm = None
    if reorder:
        coo, perm = reorder_rcm(coo)
    split = _split
    if split is None and split_rows and perm is None \
            and _prepacked is None:
        split = _row_split_plan(coo)
    if split is not None:
        return _build_split_operator(
            split, m, n, symmetric, with_transpose, nb_max, levels, window,
            _prepacked, device)
    if _prepacked is not None:
        fwd, bwd = _prepacked
        fwd = _levels_on(fwd, device)
        bwd = _levels_on(bwd, device)
    else:
        skip_bwd = symmetric or not with_transpose
        if levels <= 1 and window != "auto":
            fwd = (bell_from_coo(coo, nb_max=nb_max, window=window,
                                 spill_cost=None, segment=True,
                                 device=device),)
            bwd = None if skip_bwd else (bell_from_coo(
                F.transpose_coo(coo), nb_max=nb_max, window=window,
                spill_cost=None, segment=True, device=device),)
        else:
            # one level keeps no remainder: its packing is uncapped
            sc = _SPILL_BYTES if levels > 1 else None
            fwd = _pack_levels(coo, nb_max, sc, levels, device=device,
                               window=window)
            bwd = None if skip_bwd else _pack_levels(
                F.transpose_coo(coo), nb_max, sc, levels, device=device,
                window=window)
    if perm is not None:
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(m)
        perm = (torch.as_tensor(perm.astype(np.int64), device=device),
                torch.as_tensor(iperm.astype(np.int64), device=device))
    return BellOperator((m, n), fwd, bwd, symmetric, perm=perm)
