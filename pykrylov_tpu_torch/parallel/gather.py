"""Partition-time gather schedule for row-sharded general sparsity.

Counterpart of ``pykrylov_tpu/parallel/gather.py``.  Rather than reading
the whole x, each shard reads only the x entries its rows reference: at
partition time, on the host, :func:`build_gather_schedule` lists what
each shard needs from each other shard (one round per mesh shift, the
JAX package's ``ppermute`` rounds, after the MPI ``Alltoallv`` neighbour
exchange of the reference's era) and remaps the column indices into each
shard's private address space ``[own x block | round-1 rows | round-2
rows | ...]``, so the local product is a plain ELL gather over it.

On a mesh of slots a shard's private x is one gather from the home
tensor (its own block and the rows the schedule sends it, in the
schedule's order) copied to its slot.  The transpose runs the schedule
backwards: each shard's private partials go back to the rows that own
them, summed into y in shard order.

On a mesh of ranks each rank holds only its own rows and knows only their
columns, so the schedule comes from one exchange when the operator is
built (:class:`RankGather`): an ``all_gather`` of every rank's request
counts (which also gives each round's padded width, so each rank's
private address space is the slot mesh's), then an ``all_to_all`` of
the request lists, so each rank learns what it sends.  A product is one
``all_to_all`` of the requested rows; the transpose sends each rank's
private partials back the same way and adds them in rank order.

Zero-padding slots of the ELL container (data == 0) map to local index
0: they multiply by zero and must not request remote rows.  The traffic
of the schedule is ``comm_entries_per_matvec`` (padded to each round's
longest list) against ``allgather_entries_per_matvec``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..sparse import formats as F
from ..utils import ranks
from ..utils.types import to_tensor
from .mesh import ROW_AXIS
from .sharded import assemble, host, pad_to_multiple

__all__ = ["GatherEllOperator", "build_gather_schedule",
           "gather_ell_from_mtx"]


def gather_ell_from_mtx(path, mesh, symmetric=False, axis=ROW_AXIS,
                        dtype=None, chunk_entries=1 << 20, **kwargs):
    """A :class:`GatherEllOperator` from a MatrixMarket file, through the
    partitioned streaming reader: the coordinate section is parsed in
    bounded chunks and routed to the operator's own row blocks, so the
    whole COO is never one parse product.  The parts are assembled into
    the (mp, K) ELL arrays the schedule consumes; the operator equals the
    one built from :func:`~..io.read_matrix_market` (the ELL conversion
    sorts the entries).  ``symmetric=None`` takes the file's symmetry."""
    from ..io.matrix_market import read_matrix_market_partitioned
    d = mesh.shape[axis] if not mesh.ranked else mesh.size
    # on a mesh of ranks each rank parses the file and keeps its own part
    parts, shape, info = read_matrix_market_partitioned(
        path, d, keep=mesh.rank, chunk_entries=chunk_entries, dtype=dtype)
    vals = np.concatenate([p[0] for p in parts])
    rows = np.concatenate([p[1] for p in parts])
    cols = np.concatenate([p[2] for p in parts])
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    if symmetric is None:
        symmetric = info.symmetry in ("symmetric", "hermitian")
    return GatherEllOperator(coo, mesh, axis=axis, symmetric=symmetric,
                             **kwargs)


def build_gather_schedule(cols, data, d, L, Lrow=None):
    """Host-side schedule: per (shard, shift) request lists and the
    remapping (the JAX package's, array for array).

    ``cols``/``data`` are (mp, K) NumPy ELL arrays (mp = d Lrow); ``L``
    is the x-side block size (the x entries each shard owns; ``Lrow``,
    the default, for a square operator).  Returns ``(cols_local,
    sendidx, lens)``:

      * ``cols_local`` (mp, K) int32: column indices in each shard's
        private address space;
      * ``sendidx``: for shifts k = 1..d-1, a (d, Lk) int32 array whose
        row j lists the local x indices shard j sends in round k (to
        shard ``(j - k) % d``), zero-padded to the round's longest list;
      * ``lens``: the true per-shard request counts of each round.
    """
    cols = np.asarray(cols)
    data = np.asarray(data)
    if Lrow is None:
        Lrow = L
    mp, K = cols.shape
    assert mp == d * Lrow
    owner = cols // L
    dev = (np.arange(mp) // Lrow)[:, None]
    live = data != 0
    shift = (owner - dev) % d   # owner's shift from the row's shard

    cols_local = np.zeros((mp, K), dtype=np.int32)
    local_mask = live & (shift == 0)   # dead padding slots stay 0
    cols_local[local_mask] = (cols[local_mask] % L).astype(np.int32)

    sendidx, lens = [], []
    offset = L  # running base of the per-round buffers
    for k in range(1, d):
        reqs = []
        for i in range(d):
            rows = slice(i * Lrow, (i + 1) * Lrow)
            mask = live[rows] & (shift[rows] == k)
            reqs.append(np.unique(cols[rows][mask]) % L)
        Lk = max((len(r) for r in reqs), default=0)
        lens.append(tuple(len(r) for r in reqs))
        if Lk == 0:
            sendidx.append(np.zeros((d, 0), dtype=np.int32))
            continue
        # receiver i's request list, padded; shard j sends what its
        # round-k receiver (j - k) % d asked for
        req_pad = np.zeros((d, Lk), dtype=np.int32)
        for i in range(d):
            req_pad[i, :len(reqs[i])] = reqs[i]
        send = np.zeros((d, Lk), dtype=np.int32)
        for j in range(d):
            send[j] = req_pad[(j - k) % d]
        sendidx.append(send)
        for i in range(d):
            rows = slice(i * Lrow, (i + 1) * Lrow)
            mask = live[rows] & (shift[rows] == k)
            pos = np.searchsorted(reqs[i], cols[rows][mask] % L)
            block = cols_local[rows]
            block[mask] = (offset + pos).astype(np.int32)
            cols_local[rows] = block
        offset += Lk
    return cols_local, tuple(sendidx), tuple(lens)


def private_rows(sendidx, d, L):
    """For each shard, the global x rows of its private address space:
    its own block, then what each round's sender ships it (round k from
    shard ``(i + k) % d``), in the schedule's order."""
    out = []
    for i in range(d):
        parts = [i * L + np.arange(L, dtype=np.int64)]
        for k, send in enumerate(sendidx, start=1):
            if send.shape[1]:
                j = (i + k) % d
                parts.append(j * L + send[j].astype(np.int64))
        out.append(np.concatenate(parts))
    return out


class ScheduledGather:
    """A schedule on a mesh: each shard's private rows (on the home slot,
    which gathers them) and the products that move x through them."""

    def __init__(self, mesh, sendidx, d, Lx, Lrow):
        self.mesh = mesh
        self.Lx, self.Lrow = Lx, Lrow
        self.rows = [to_tensor(r, device=mesh.home)
                     for r in private_rows(sendidx, d, Lx)]

    def private(self, k, x):
        """Shard k's private x (the rows the exchange gives it), on its
        slot."""
        return x[self.rows[k]].to(self.mesh.slots[k])

    def own(self, k, x):
        """Shard k's block of a row-side vector, on its slot."""
        return x[k * self.Lrow:(k + 1) * self.Lrow].to(self.mesh.slots[k])

    def scatter(self, partials, n_out, like):
        """The reversed exchange: every shard's private partials added
        into the rows that own them, shard by shard in order."""
        home = self.mesh.home
        y = torch.zeros((n_out,) + tuple(like.shape[1:]), dtype=like.dtype,
                        device=home)
        for k, p in enumerate(partials):
            y.index_add_(0, self.rows[k], p.to(home))
        return y

    def transposed(self, local_t, n_out):
        """``A^T x`` from ``local_t(k, x_k) -> private partials``."""
        def rule(x):
            parts = []
            for k in range(self.mesh.size):
                with self.mesh.on(k):
                    parts.append(local_t(k, self.own(k, x)))
            return self.scatter(parts, n_out, parts[0])
        return rule


class RankGather:
    """The gather schedule on a mesh of ranks, built from this rank's
    rows alone.

    ``data``/``cols`` are this rank's (Lrow, K) ELL arrays with global
    column indices, ``Lx`` the x-side block size.  At construction: one
    ``all_gather`` of the request counts (``counts[i, j]``: entries rank
    i reads from rank j), one ``all_to_all`` of the request lists.  Then
    ``cols_local`` remaps the columns into the private address space
    ``[own x block | round-1 rows | ...]`` with the slot mesh's padded
    round widths, and a product's private x is one ``all_to_all`` of the
    requested rows.  ``lens`` are the true counts of each round, as
    :func:`build_gather_schedule` gives them; ``round_widths`` the padded
    ones.
    """

    def __init__(self, mesh, data, cols, Lx):
        comm = self.comm = mesh.comm
        self.mesh = mesh
        d, r = mesh.size, mesh.rank
        self.Lx = Lx
        cols = np.asarray(cols, dtype=np.int64)
        live = np.asarray(data) != 0
        owner = cols // Lx
        reqs = [np.unique(cols[live & (owner == j)]) % Lx if j != r
                else np.zeros(0, np.int64) for j in range(d)]
        mine = np.array([len(q) for q in reqs], dtype=np.int64)
        counts = comm.all_gather(torch.from_numpy(mine)).numpy()
        self.counts = counts
        rounds = [[int(counts[i, (i + k) % d]) for i in range(d)]
                  for k in range(1, d)]
        self.lens = tuple(tuple(c) for c in rounds)
        self.round_widths = tuple(max(c, default=0) for c in rounds)
        offs = np.concatenate([[Lx], Lx + np.cumsum(self.round_widths,
                                                    dtype=np.int64)])
        self.width = int(offs[-1])
        cl = np.zeros(cols.shape, dtype=np.int32)
        own = live & (owner == r)
        cl[own] = (cols[own] % Lx).astype(np.int32)
        pidx = np.full(self.width, Lx + int(mine.sum()), dtype=np.int64)
        pidx[:Lx] = np.arange(Lx)
        base = Lx
        for j in range(d):
            if j == r:
                continue
            k = (j - r) % d
            mask = live & (owner == j)
            pos = np.searchsorted(reqs[j], cols[mask] % Lx)
            cl[mask] = (offs[k - 1] + pos).astype(np.int32)
            pidx[offs[k - 1]:offs[k - 1] + mine[j]] = base + np.arange(
                mine[j])
            base += int(mine[j])
        self.cols_local = cl
        self.recv_counts = [int(c) for c in mine]          # from each rank
        self.send_counts = [int(c) for c in counts[:, r]]  # to each rank
        req = np.concatenate([reqs[j] for j in range(d)]).astype(np.int64)
        sent = comm.all_to_all(torch.from_numpy(req), self.recv_counts,
                               self.send_counts)
        self.send_idx = sent.to(mesh.home)
        self.send_splits = np.cumsum([0] + self.send_counts)
        self.pidx = torch.from_numpy(pidx).to(mesh.home)
        self.private_offsets = offs

    def private(self, k, x):
        """This rank's private x: its own rows and the rows the schedule
        sends it (one ``all_to_all``), zeros in the rounds' padding."""
        x = ranks.plain(x)
        got = self.comm.all_to_all(x[self.send_idx], self.send_counts,
                                   self.recv_counts)
        src = torch.cat([x, got, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return src[self.pidx]

    def own(self, k, x):
        return ranks.plain(x)

    def transposed(self, local_t, n_out):
        """``A^T x``: this rank's private partials go back to the ranks
        that own their rows (one ``all_to_all``), added in rank order."""
        d, r = self.mesh.size, self.mesh.rank
        offs = self.private_offsets

        def rule(x):
            with self.mesh.on(r):
                p = local_t(r, self.own(r, x))
                back = [p[offs[(j - r) % d - 1]:
                          offs[(j - r) % d - 1] + self.recv_counts[j]]
                        for j in range(d) if j != r]
                send = torch.cat(back) if back else p[:0]
                got = self.comm.all_to_all(send, self.recv_counts,
                                           self.send_counts)
                y = p.new_zeros((self.Lx,) + tuple(p.shape[1:]))
                for i in range(d):
                    if i == r:
                        y.index_add_(0, torch.arange(self.Lx,
                                                     device=y.device),
                                     p[:self.Lx])
                    else:
                        a, b = self.send_splits[i], self.send_splits[i + 1]
                        y.index_add_(0, self.send_idx[a:b], got[a:b])
                return ranks.shard(y)
        return rule


def ell_ff(sched, data, cols, width):
    """The compensated product over per-shard remapped ELL arrays: each
    shard's (hi, lo) private x through :func:`~..sparse.formats.
    ell_matvec_ff`."""
    def ff(xh, xl):
        def local(k):
            c = F.ELL(data[k], cols[k], (data[k].shape[0], width))
            return torch.stack(F.ell_matvec_ff(
                c, sched.private(k, xh), sched.private(k, xl)), dim=1)
        y = assemble(sched.mesh, local)
        return y[:, 0].contiguous(), y[:, 1].contiguous()
    return ff


def pad_ell(ell):
    """``(data, cols, m, n)`` of an ELL container or a COO (converted) as
    host arrays, cols int64."""
    if isinstance(ell, F.COO):
        ell = F.ell_from_coo(ell, device=None)
    m, n = ell.shape
    return host(ell.data), host(ell.cols).astype(np.int64), m, n


def rank_ell(ell, mesh):
    """This rank's rows of an ELL or COO container as ``(data, cols, m,
    n, mp, np_, Lrow, Lx)``: (Lrow, K) host arrays with global column
    indices (int64), zero rows past m.  A COO may hold this rank's
    entries only (the partitioned reader's ``keep=rank`` part); its
    shape is the whole matrix's."""
    d, r = mesh.size, mesh.rank
    m, n = ell.shape
    mp, np_ = pad_to_multiple(m, d), pad_to_multiple(n, d)
    Lrow, Lx = mp // d, np_ // d
    lo = r * Lrow
    if isinstance(ell, F.COO):
        rr = host(ell.row).astype(np.int64)
        keep = (rr >= lo) & (rr < lo + Lrow)
        loc = F.coo_from_arrays(host(ell.data)[keep], rr[keep] - lo,
                                host(ell.col).astype(np.int64)[keep],
                                (Lrow, n), device=None)
        e = F.ell_from_coo(loc, device=None)
        return (host(e.data), host(e.cols).astype(np.int64), m, n, mp, np_,
                Lrow, Lx)
    data, cols = host(ell.data), host(ell.cols).astype(np.int64)
    dp = np.zeros((Lrow, data.shape[1]), dtype=data.dtype)
    cp = np.zeros((Lrow, data.shape[1]), dtype=np.int64)
    hi = min(lo + Lrow, m)
    if lo < hi:
        dp[:hi - lo], cp[:hi - lo] = data[lo:hi], cols[lo:hi]
    return dp, cp, m, n, mp, np_, Lrow, Lx


def sharded_ell(data, cols, d, m, n):
    """Padded (mp, K) ELL arrays, their schedule and its sizes."""
    mp = pad_to_multiple(m, d)
    np_ = pad_to_multiple(n, d)
    K = data.shape[1]
    dp = np.zeros((mp, K), dtype=data.dtype)
    cp = np.zeros((mp, K), dtype=np.int64)
    dp[:m] = data
    cp[:m] = cols
    Lrow, Lx = mp // d, np_ // d
    cols_local, sendidx, lens = build_gather_schedule(cp, dp, d, Lx, Lrow)
    return dp, cols_local, sendidx, lens, mp, np_, Lrow, Lx


def plan_gather(ell, mesh, d):
    """The operator's shards and schedule: ``(dp, cols_local, sendidx,
    lens, round_lens, mp, np_, Lrow, Lx, width, sched, m, n)``.  On a
    mesh of slots ``dp``/``cols_local`` are every shard's rows and
    ``sched`` a :class:`ScheduledGather`; on a mesh of ranks this rank's
    rows, ``sched`` a :class:`RankGather` and ``sendidx`` None."""
    if mesh.ranked:
        dp, cp, m, n, mp, np_, Lrow, Lx = rank_ell(ell, mesh)
        sched = RankGather(mesh, dp, cp, Lx)
        return (dp, sched.cols_local, None, sched.lens, sched.round_widths,
                mp, np_, Lrow, Lx, sched.width, sched, m, n)
    data, cols, m, n = pad_ell(ell)
    dp, cols_local, sendidx, lens, mp, np_, Lrow, Lx = sharded_ell(
        data, cols, d, m, n)
    width = Lx + sum(s.shape[1] for s in sendidx)
    sched = ScheduledGather(mesh, sendidx, d, Lx, Lrow)
    return (dp, cols_local, sendidx, lens, None, mp, np_, Lrow, Lx, width,
            sched, m, n)


def shard_rows(a, mesh, Lrow):
    """Each shard's (Lrow, ...) block of ``a`` as a tensor on its slot:
    every shard's on a mesh of slots (``a`` all rows), this rank's on a
    mesh of ranks (``a`` its rows), None for the others."""
    out = [None] * mesh.size
    for k in mesh.shards():
        blk = a if mesh.ranked else a[k * Lrow:(k + 1) * Lrow]
        out[k] = to_tensor(np.ascontiguousarray(blk), device=mesh.slots[k])
    return out


def comm_attrs(op, d, sendidx, lens, Lx, round_lens=None):
    """The schedule's traffic attributes, as the JAX operators set them
    (``round_lens``: the rounds' padded widths, default from
    ``sendidx``)."""
    if round_lens is None:
        round_lens = tuple(s.shape[1] for s in sendidx)
    op.comm_entries_per_matvec = int(sum(d * Lk for Lk in round_lens))
    op.comm_entries_true = int(sum(sum(t) for t in lens))
    op.allgather_entries_per_matvec = int(d * (d - 1) * Lx)


class GatherEllOperator(LinearOperator):
    """Row-sharded general-sparsity operator with a partition-time gather
    schedule.

    Parameters
    ----------
    ell : ELL container, or a COO container (converted); NumPy arrays or
        tensors, read on the host.  Rectangular containers are supported:
        the row space (length ``m + self.pad``) and the column space
        (length ``n + self.pad_n``) are blocked over the same mesh axis.
    mesh : 1-D :class:`~.mesh.Mesh`; rows are blocked over ``axis``.
    symmetric : structural and value symmetry (``op.T`` reuses the
        forward product; square only).  Otherwise the transpose runs the
        reversed schedule, so sharded LSQR and LSMR work on general
        systems.
    """

    def __init__(self, ell, mesh, axis=ROW_AXIS, symmetric=False, **kwargs):
        if symmetric and ell.shape[0] != ell.shape[1]:
            raise ValueError("symmetric requires a square operator")
        d = mesh.shape[axis] if not mesh.ranked else mesh.size
        plan = plan_gather(ell, mesh, d)
        (dp, cols_local, sendidx, lens, round_lens, mp, np_, Lrow, Lx,
         width, sched, m, n) = plan
        dat = shard_rows(dp, mesh, Lrow)
        cl = shard_rows(cols_local.astype(np.int64), mesh, Lrow)

        def mv(x):
            return assemble(mesh, lambda k: F.ell_matvec(
                F.ELL(dat[k], cl[k], (Lrow, width)), sched.private(k, x)))

        def local_t(k, xk):
            prods = dat[k] * xk[:, None].to(torch.promote_types(
                dat[k].dtype, xk.dtype))
            y = prods.new_zeros(width)
            return y.index_add_(0, cl[k].reshape(-1), prods.reshape(-1))

        rmv = mv if symmetric else sched.transposed(local_t, np_)
        from ..solvers.ffmv import register_ff_matvec
        register_ff_matvec(mv, ell_ff(sched, dat, cl, width))

        is_complex = np.issubdtype(dp.dtype, np.complexfloating)
        super().__init__(np_, mp, matvec=mv, matvec_transp=rmv,
                         symmetric=symmetric,
                         hermitian=symmetric and not is_complex,
                         dtype=dp.dtype, device=mesh.home,
                         params=tuple(t for t in dat if t is not None),
                         **kwargs)
        self.pad = mp - m
        self.pad_n = np_ - n
        self.mesh = mesh
        self.schedule = (cols_local, sendidx, lens)
        self._container = (dat, cl, sendidx)
        comm_attrs(self, d, sendidx, lens, Lx, round_lens)

    @property
    def container(self):
        """(per-shard data, per-shard remapped columns, send lists)."""
        return self._container
