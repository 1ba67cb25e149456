"""The exchange layer of a mesh of ranks: everything that crosses ranks.

A mesh of ranks (:func:`~.mesh.make_mesh` under a world of
``torch.distributed``) holds one shard per rank.  Its operators and the
solvers' reductions move data between ranks only through a :class:`Comm`:

  * neighbour rows (halos, faces): :meth:`Comm.sendrecv`, one
    ``batch_isend_irecv`` of every send and receive;
  * a scheduled gather: :meth:`Comm.all_to_all`, ``all_to_all_single``
    with the schedule's split sizes;
  * :meth:`Comm.all_reduce` (sums), :meth:`Comm.all_gather` (rank
    order), :meth:`Comm.broadcast` (one rank's tensor to all) and
    :meth:`Comm.barrier`.

The transport is decided once, when the mesh is built, and named in
``device_mesh_info(mesh)["transport"]``: ``"nccl"`` moves CUDA tensors
with NCCL; ``"host"`` runs gloo on host tensors, staging a CUDA tensor
through a pinned host buffer and back (gloo moves no CUDA tensor in
point-to-point or all-to-all exchanges).  Nothing switches transport at
run time.

Each call adds to :attr:`Comm.calls` and, on the host's clock, to
:attr:`Comm.seconds` (an NCCL call returns before the card has moved the
data, so there it times the enqueue).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["Comm", "TRANSPORTS"]

TRANSPORTS = ("nccl", "host")


class Comm:
    """The collectives of one mesh of ranks.

    ``group`` is the process group (None: the default one), ``device``
    this rank's device, ``transport`` ``"nccl"`` or ``"host"``.
    """

    def __init__(self, group, device, transport):
        if transport not in TRANSPORTS:
            raise ValueError("transport must be one of %s; got %r"
                             % (TRANSPORTS, transport))
        self.group = group
        self.device = torch.device(device)
        self.transport = transport
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
                      "barrier": 0, "sendrecv": 0, "all_to_all": 0}
        self.seconds = 0.0

    def reset_counts(self):
        for k in self.calls:
            self.calls[k] = 0
        self.seconds = 0.0

    # -- staging -------------------------------------------------------------
    def _wire(self, t):
        """``t`` as the transport moves it (contiguous): on this rank's
        card for NCCL, on the host for gloo, through a pinned host buffer
        for a CUDA tensor."""
        t = t.contiguous()
        if self.transport == "host" and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        if self.transport == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def _empty(self, shape, dtype, like_cuda):
        if self.transport == "host":
            return torch.empty(shape, dtype=dtype, pin_memory=like_cuda)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, t, device):
        return t.to(device) if t.device != device else t

    def _timed(self, name):
        self.calls[name] += 1
        return time.perf_counter()

    # -- collectives ---------------------------------------------------------
    def _in_place(self, name, t, op):
        """``op`` run in place on a copy of ``t`` as the transport moves
        it (a complex tensor as its real view); the result on ``t``'s
        device."""
        t0 = self._timed(name)
        dev = t.device
        cplx = t.is_complex()
        src = torch.view_as_real(t) if cplx else t
        buf = self._wire(src)
        if buf is src:                       # NCCL or a host tensor: a copy
            buf = src.clone()
        op(buf)
        out = self._back(buf, dev)
        self.seconds += time.perf_counter() - t0
        return torch.view_as_complex(out) if cplx else out

    def all_reduce(self, t):
        """The sum of ``t`` over the ranks, a new tensor on ``t``'s
        device, the same bits on every rank."""
        return self._in_place("all_reduce", t, lambda buf: dist.all_reduce(
            buf, group=self.group))

    def all_gather(self, t):
        """``t`` of every rank stacked in rank order: ``(R,) + t.shape``
        on ``t``'s device."""
        t0 = self._timed("all_gather")
        dev = t.device
        buf = self._wire(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = self._back(torch.stack(parts), dev)
        self.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, t, src=0):
        """Rank ``src``'s ``t`` on every rank: a new tensor of ``t``'s
        shape and dtype on ``t``'s device, the same bits on every rank."""
        return self._in_place("broadcast", t, lambda buf: dist.broadcast(
            buf, src, group=self.group))

    def barrier(self):
        """Return when every rank has called it (NCCL: on this rank's
        card)."""
        t0 = self._timed("barrier")
        if self.transport == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)
        self.seconds += time.perf_counter() - t0

    def sendrecv(self, sends, recvs, like):
        """Point-to-point rows: ``sends`` a list of ``(peer, tensor)``,
        ``recvs`` a list of ``(peer, shape)``; one ``batch_isend_irecv``
        of all of them.  Returns the received tensors, in ``recvs``'
        order, with ``like``'s dtype on its device (every message of a
        call has that dtype).  A pair of ranks exchanges at most one
        message each way a call."""
        if not sends and not recvs:
            return []
        t0 = self._timed("sendrecv")
        bufs = [self._wire(t) for _, t in sends]
        outs = [self._empty(tuple(shape), like.dtype, like.is_cuda)
                for _, shape in recvs]
        ops = ([dist.P2POp(dist.isend, b, peer, group=self.group)
                for (peer, _), b in zip(sends, bufs)]
               + [dist.P2POp(dist.irecv, o, peer, group=self.group)
                  for (peer, _), o in zip(recvs, outs)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        got = [self._back(o, like.device) for o in outs]
        self.seconds += time.perf_counter() - t0
        return got

    def all_to_all(self, send, send_counts, recv_counts):
        """``all_to_all_single`` along dim 0: ``send``'s rows in blocks of
        ``send_counts`` (one a rank, in rank order) go to the ranks; the
        result holds ``recv_counts`` rows from each rank in rank order."""
        t0 = self._timed("all_to_all")
        dev = send.device
        buf = self._wire(send)
        out = self._empty((int(sum(recv_counts)),) + tuple(send.shape[1:]),
                          send.dtype, send.is_cuda)
        dist.all_to_all_single(out, buf, [int(c) for c in recv_counts],
                               [int(c) for c in send_counts],
                               group=self.group)
        out = self._back(out, dev)
        self.seconds += time.perf_counter() - t0
        return out
