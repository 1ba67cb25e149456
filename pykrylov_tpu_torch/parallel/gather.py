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
    d = mesh.shape[axis]
    parts, shape, info = read_matrix_market_partitioned(
        path, d, chunk_entries=chunk_entries, dtype=dtype)
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


def comm_attrs(op, d, sendidx, lens, Lx):
    """The schedule's traffic attributes, as the JAX operators set them."""
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
        data, cols, m, n = pad_ell(ell)
        if symmetric and m != n:
            raise ValueError("symmetric requires a square operator")
        d = mesh.shape[axis]
        dp, cols_local, sendidx, lens, mp, np_, Lrow, Lx = sharded_ell(
            data, cols, d, m, n)
        width = Lx + sum(s.shape[1] for s in sendidx)
        sched = ScheduledGather(mesh, sendidx, d, Lx, Lrow)
        dat = [to_tensor(dp[k * Lrow:(k + 1) * Lrow], device=s)
               for k, s in enumerate(mesh.slots)]
        cl = [to_tensor(cols_local[k * Lrow:(k + 1) * Lrow].astype(np.int64),
                        device=s) for k, s in enumerate(mesh.slots)]

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
                         params=tuple(dat), **kwargs)
        self.pad = mp - m
        self.pad_n = np_ - n
        self.mesh = mesh
        self.schedule = (cols_local, sendidx, lens)
        self._container = (dat, cl, sendidx)
        comm_attrs(self, d, sendidx, lens, Lx)

    @property
    def container(self):
        """(per-shard data, per-shard remapped columns, send lists)."""
        return self._container
