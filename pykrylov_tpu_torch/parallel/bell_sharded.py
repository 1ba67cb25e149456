"""Row-sharded general sparsity with the SELL kernels as the local
product.

Counterpart of ``pykrylov_tpu/parallel/bell_sharded.py``.  The schedule
is :mod:`.gather`'s: each shard reads its private address space ``[own x
block | round-1 rows | ...]``.  Its local block, with the columns
remapped into that space, is packed as a window-1 BELL container by the
port's packer, the JAX package's per-device container array for array
(:func:`_pack_local_blocks` stacks them as the JAX package's
``shard_map`` needs).  The card does not stream BELL: each shard's
container gives one SELL card form (:func:`~..sparse.sell.
sell_from_levels`) on its slot, and every product is one
:func:`~..sparse.sell.sell_matvec` (or :func:`~..sparse.sell.sell_matmat`
for an (n, K) block) launch per shard.  ``with_transpose=True`` packs
each shard's transposed local block too and runs the reversed exchange:
each shard's private partials are summed into their owners' rows in
shard order.  On a mesh of ranks each rank packs its own block only, from
its own rows (:class:`~.gather.RankGather`'s schedule), and launches one
SELL kernel a product on its card, forward and transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..sparse import formats as F
from ..sparse.bell import (LANES, _pack_idx, _unpack_idx, bell_from_coo,
                           bell_to_device)
from ..sparse.sell import sell_from_levels, sell_matmat, sell_matvec
from .gather import comm_attrs, ell_ff, plan_gather, shard_rows
from .mesh import ROW_AXIS
from .sharded import assemble

__all__ = ["GatherBellOperator"]


def _local_bells(data, cols_local, d, L, width, nblk, transpose=False):
    """Each shard's (L, width) remapped ELL block as a window-1 BELL
    container over its private address space (NumPy arrays), or its
    transposed (width, L) block with ``transpose=True``."""
    bells = []
    for i in range(d):
        blk = slice(i * L, (i + 1) * L)
        db, cb = data[blk], cols_local[blk]
        live = db != 0
        rr = np.nonzero(live)[0]
        vv = db[live]
        cc = cb[live]
        if transpose:
            coo = F.coo_from_arrays(vv, cc, rr, (width, L), device=None)
            min_cols = L
        else:
            coo = F.coo_from_arrays(vv, rr, cc, (L, width), device=None)
            min_cols = width
        bells.append(bell_from_coo(coo, nblk=nblk, min_cols=min_cols,
                                   spill_cost=None, device=None, window=1))
    return bells


def _pad_blocks_w1(bl, gs_old, gs_new, nblk, nsteps_new):
    """Pad a window-1 scatter map to a larger (nsteps, GS): the stored
    [even halves | odd halves] order depends on GS, so padding goes
    through the natural group order (``sparse/bell.py:2096`` of the JAX
    package)."""
    bl = np.asarray(bl)[:, 0, :]
    g_old, g_new = gs_old // 4, gs_new // 4
    nat = np.empty((bl.shape[0], g_old), bl.dtype)
    nat[:, 0::2] = bl[:, :g_old - g_old // 2]
    nat[:, 1::2] = bl[:, g_old - g_old // 2:]
    natp = np.full((nsteps_new, g_new), nblk, bl.dtype)
    natp[:bl.shape[0], :g_old] = nat
    return np.concatenate([natp[:, 0::2], natp[:, 1::2]],
                          axis=1)[:, None, :]


def _common_dims(bells):
    """(nsteps, GS, nb, nblk, ncb) the JAX package pads every shard's
    container to."""
    nblk = bells[0].nblk
    assert all(b.nblk == nblk for b in bells)
    nsteps = max(b.data.shape[0] for b in bells)
    GS = max(b.data.shape[1] for b in bells)
    nb = max(b.nb for b in bells)
    # stored bands are relative to band_lo, so band_lo is not re-clamped
    # to the common nb; the x pad grows instead
    ncb = max(max(b.padded_shape[1] // LANES for b in bells),
              max(int(np.asarray(b.band_lo).max(initial=0))
                  for b in bells) + nb)
    return nsteps, GS, nb, nblk, ncb


def _pack_local_blocks(data, cols_local, d, L, width, nblk,
                       transpose=False):
    """The JAX package's stacked per-device containers: every shard's
    BELL (:func:`_local_bells`) padded to common shapes and stacked on a
    leading shard axis.  Returns ``((dat, lan, bnd, blo, bl), (nb, nblk,
    ncb, rows_pad))``, array for array the JAX ``_pack_local_blocks``."""
    bells = _local_bells(data, cols_local, d, L, width, nblk, transpose)
    nsteps, GS, nb, nblk, ncb = _common_dims(bells)

    def pad3(a, shp, fill=0):
        out = np.full(shp, fill, dtype=a.dtype)
        out[:a.shape[0], :a.shape[1], :a.shape[2]] = a
        return out

    dat = np.stack([pad3(np.asarray(b.data), (nsteps, GS, LANES))
                    for b in bells])
    # byte j of a packed word is sublane row j*GS/4 + m: padding to a
    # larger GS goes through the unpacked indices
    lan = np.stack([_pack_idx(pad3(_unpack_idx(b), (nsteps, GS, LANES))
                              .astype(np.uint8)) for b in bells])
    bnd = np.stack([pad3(np.asarray(b.bands), (nsteps, 1, GS))
                    for b in bells])
    blo = np.stack([_pad_blocks_w1(b.blocks, b.data.shape[1], GS, nblk,
                                   nsteps) for b in bells])
    bl = np.stack([np.pad(np.asarray(b.band_lo),
                          (0, nsteps - b.band_lo.shape[0]))
                   for b in bells]).astype(np.int32)
    rows_pad = nsteps * nblk * LANES
    return (dat, lan, bnd, blo, bl), (nb, nblk, ncb, rows_pad)


def _cards(bells, mesh, rows_out):
    """Each shard's SELL card form, built on its slot (``bells`` holds the
    shards of :meth:`~.mesh.Mesh.shards`; the others are None)."""
    cards = [None] * mesh.size
    for b, k in zip(bells, mesh.shards()):
        cards[k] = sell_from_levels((bell_to_device(b, mesh.slots[k]),),
                                    rows_out)
    return cards


class GatherBellOperator(LinearOperator):
    """Row-sharded general-sparsity operator: the partition-time gather
    schedule and one SELL kernel launch per shard a product.

    Parameters match :class:`~.gather.GatherEllOperator` (ELL or COO
    container, 1-D mesh; rectangular containers shard rows and columns
    over the same axis).  ``nblk`` is the packer's step size (common to
    every shard).  ``with_transpose=True`` also packs each shard's
    transposed local block, so ``op.T @ x`` runs the reversed exchange;
    ``symmetric=True`` (square only) reuses the forward product.
    ``verified_shadow=True`` keeps each shard's remapped ELL arrays beside
    its card form and registers the compensated product over them
    (:mod:`..solvers.ffmv`), for the verified solvers' certificates.
    ``interpret`` (the JAX package's Pallas switch) is accepted and has
    no effect.

    ``cards`` (and ``cards_t`` for the transpose) are the shards' card
    forms; ``slots_per_device`` counts the stacked BELL slots a device of
    the JAX package streams, for comparison.
    """

    def __init__(self, ell, mesh, axis=ROW_AXIS, symmetric=False,
                 nblk=64, interpret=None, with_transpose=False,
                 verified_shadow=False, **kwargs):
        if symmetric and ell.shape[0] != ell.shape[1]:
            raise ValueError("symmetric requires a square operator")
        d = mesh.shape[axis] if not mesh.ranked else mesh.size
        (dp, cols_local, sendidx, lens, round_lens, mp, np_, Lrow, Lx,
         width, sched, m, n) = plan_gather(ell, mesh, d)
        # the shards this process packs: every one, or this rank's rows
        nloc = 1 if mesh.ranked else d

        bells = _local_bells(dp, cols_local, nloc, Lrow, width, nblk)
        nsteps, GS = _common_dims(bells)[:2]
        if mesh.ranked:
            dims = mesh.comm.all_gather(torch.tensor([nsteps, GS]))
            nsteps, GS = (int(v) for v in dims.max(0).values)
        cards = _cards(bells, mesh, Lrow)

        def mv(x):
            return assemble(mesh, lambda k: sell_matvec(
                cards[k], sched.private(k, x)))

        def mm(X):
            return assemble(mesh, lambda k: sell_matmat(
                cards[k], sched.private(k, X)))

        cards_t = None
        if symmetric:
            rmv, rmm = mv, mm
        elif with_transpose:
            cards_t = _cards(_local_bells(dp, cols_local, nloc, Lrow, width,
                                          nblk, transpose=True),
                             mesh, width)
            rmv = sched.transposed(
                lambda k, xk: sell_matvec(cards_t[k], xk), np_)
            rmm = sched.transposed(
                lambda k, Xk: sell_matmat(cards_t[k], Xk), np_)
        else:
            rmv = rmm = None

        shadow = None
        if verified_shadow:
            # the card form has no compensated product: keep the remapped
            # ELL arrays the packer consumed as a shadow for the verified
            # residuals (about 12 B a slot beside the card's 8 B a nonzero)
            shadow = (shard_rows(dp, mesh, Lrow),
                      shard_rows(cols_local.astype(np.int64), mesh, Lrow))
            from ..solvers.ffmv import register_ff_matvec
            register_ff_matvec(mv, ell_ff(sched, *shadow, width))

        is_complex = np.issubdtype(dp.dtype, np.complexfloating)
        super().__init__(np_, mp, matvec=mv, matvec_transp=rmv,
                         matmat=mm, matmat_transp=rmm,
                         symmetric=symmetric,
                         hermitian=symmetric and not is_complex,
                         dtype=dp.dtype, device=mesh.home,
                         params=tuple(c.vals for c in cards if c is not None),
                         **kwargs)
        self.pad = mp - m
        self.pad_n = np_ - n
        self.mesh = mesh
        self.cards = cards
        self.cards_t = cards_t
        self.schedule = (cols_local, sendidx, lens)
        self._container = (cards, sendidx, cards_t, shadow)
        comm_attrs(self, d, sendidx, lens, Lx, round_lens)
        self.slots_per_device = int(nsteps * GS * LANES)

    @property
    def container(self):
        """(card forms, send lists, transposed card forms or None, the
        verified shadow or None)."""
        return self._container
