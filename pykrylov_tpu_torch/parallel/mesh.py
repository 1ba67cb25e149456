"""Meshes of shard slots in one process, and meshes of ranks.

Counterpart of ``pykrylov_tpu/parallel/mesh.py``.  The JAX package runs a
single controller: one process holds a ``jax.sharding.Mesh`` of devices
and the solvers stay unchanged, XLA placing the collectives; after
``jax.distributed.initialize`` the same ``make_mesh`` spans every
process's devices.  Here a :class:`Mesh` is one of two kinds:

  * **a mesh of shard slots** (no world of ``torch.distributed`` up): one
    process holds every shard; slot k is the device that keeps shard k's
    storage and runs its products.  Slots may repeat, so P shards can
    share one card (as the JAX package's tests run 8 virtual devices on
    one CPU).  A sharded vector is one tensor on the mesh's first slot
    (its home), so the solvers' dots and updates are plain torch calls on
    whole tensors;
  * **a mesh of ranks** (after :func:`initialize_multihost`, or any
    ``init_process_group``): one shard per rank, shard k on rank k's
    device, ``cuda:(local_rank mod device_count())`` or the host.  A
    sharded vector holds only this rank's rows, as a
    :class:`~..utils.ranks.RankShard`; every operator builds and keeps
    only its own shard and runs one product a call on its own card; the
    exchanges go through the mesh's :class:`~.comm.Comm` (NCCL on CUDA,
    gloo on the host; ``transport="host"`` stages CUDA tensors through
    pinned host buffers for a gloo world), and the solvers' reductions
    all-reduce (:mod:`..utils.ranks`), so every rank runs the same solve
    in lockstep.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "rank_mesh", "default_mesh",
           "device_mesh_info", "initialize_multihost", "ROW_AXIS"]

ROW_AXIS = "rows"

# environment of a multi-process launch (torchrun and its kin)
_MULTIHOST_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

def _slot(device):
    """A device with its index: ``cuda`` and ``cuda:0`` name one slot."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered grid of shard slots.

    ``devices`` is an object array of ``torch.device`` of the mesh's shape
    (slots may repeat); ``axis_names`` names its axes and ``shape`` maps
    each name to its extent, as a JAX mesh's do.  ``slots`` is the flat
    tuple in shard order (row-major) and ``home`` the first slot, where
    sharded vectors live.

    A mesh of ranks has a ``comm`` (:class:`~.comm.Comm`): ``rank`` is
    this process's shard, ``home`` its device, ``group`` and ``backend``
    the world's; on a mesh of slots ``comm`` and ``rank`` are None.
    """

    def __init__(self, devices, axis_names, comm=None):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = _slot(np.asarray(devices, dtype=object)[idx])
        if devs.ndim != len(axis_names):
            raise ValueError("%d axis names for a %d-D mesh"
                             % (len(axis_names), devs.ndim))
        if devs.size == 0:
            raise ValueError("a mesh needs at least one slot")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devs.shape))
        self.slots = tuple(devs.ravel())
        self.comm = comm
        self.rank = None if comm is None else comm.rank
        self.home = self.slots[0 if comm is None else comm.rank]

    @property
    def ranked(self):
        """True for a mesh of ranks (one shard per process)."""
        return self.comm is not None

    @property
    def group(self):
        return None if self.comm is None else self.comm.group

    @property
    def backend(self):
        return None if self.comm is None else self.comm.backend

    @property
    def transport(self):
        """How shards exchange rows: ``"slots"`` (copies in one process),
        ``"nccl"`` or ``"host"`` (gloo on host buffers)."""
        return "slots" if self.comm is None else self.comm.transport

    def shards(self):
        """The shards this process computes: every one on a mesh of
        slots, its own on a mesh of ranks."""
        return range(self.size) if self.comm is None else (self.rank,)

    @property
    def size(self):
        return len(self.slots)

    @property
    def platform(self):
        return "gpu" if self.home.type == "cuda" else self.home.type

    def on(self, k):
        """Context of shard k's launches: its slot's card is current."""
        slot = self.slots[k]
        if slot.type == "cuda":
            return torch.cuda.device(slot)
        return contextlib.nullcontext()

    def __repr__(self):
        kind = "" if self.comm is None else ", rank %d of %d, %s" % (
            self.rank, self.size, self.transport)
        return "Mesh(%s, %s%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            sorted({str(s) for s in self.slots}), kind)


def _world_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank_mesh(shape, axis_names, device="cuda", transport=None):
    """The mesh of ranks of the running world, of ``shape`` (its product
    the world size), shard k on rank k.

    ``device``: ``"cuda"`` puts shard k on ``cuda:(local_rank mod
    device_count())``; ``"cpu"`` on the host.  The transport follows the
    backend: NCCL moves CUDA tensors (``"nccl"``), gloo host tensors
    (``"host"``).  A ``"cuda"`` mesh on a gloo world needs
    ``transport="host"`` explicitly (CUDA tensors staged through pinned
    host buffers); any other mismatch raises.
    """
    import torch.distributed as dist
    from ..utils import ranks
    from .comm import Comm
    R = dist.get_world_size()
    if int(np.prod(shape)) != R:
        raise ValueError("a mesh of ranks of shape %s needs %d ranks; the "
                         "world has %d" % (tuple(shape), int(np.prod(shape)),
                                           R))
    backend = dist.get_backend()
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on %r needs a CUDA device" % (device,))
        cards = torch.cuda.device_count()
        # this rank's card from its index on the host (LOCAL_RANK where a
        # launcher sets it); the others' as on one host
        me = dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK", me))
        devs = [torch.device("cuda", (local if k == me else k) % cards)
                for k in range(R)]
        if backend == "nccl":
            want = "nccl"
        elif transport == "host":
            want = "host"
        else:
            raise RuntimeError(
                "a 'cuda' mesh on a %r world: that backend moves no CUDA "
                "tensors; start the world with NCCL, or pass "
                "transport='host' to stage them through host buffers"
                % backend)
    elif d.type == "cpu":
        if backend != "gloo":
            raise RuntimeError("a 'cpu' mesh needs a gloo world; the "
                               "world's backend is %r" % backend)
        devs = [d] * R
        want = "host"
    else:
        raise ValueError("a mesh of ranks on %r is not supported"
                         % (device,))
    if transport not in (None, want):
        raise ValueError("transport %r on a %r world with %r shards; "
                         "this mesh moves rows by %r"
                         % (transport, backend, d.type, want))
    home = devs[dist.get_rank()]
    if home.type == "cuda":
        torch.cuda.set_device(home)
    comm = ranks._WORLD
    if (comm is None or comm.transport != want or comm.device != home
            or comm.size != R):
        comm = Comm(None, home, want)
        ranks.bind(comm)
    return Mesh(np.asarray(devs, dtype=object).reshape(shape), axis_names,
                comm=comm)


def _slots(n, device):
    """``n`` slots on ``device``: shard k on ``cuda:(k mod cards)`` for a
    bare ``"cuda"``, every shard on a device that names its index, on the
    CPU for ``"cpu"``."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on %r needs a CUDA device; pass "
                               "device='cpu' for a mesh on the host"
                               % (device,))
        if d.index is None:
            cards = torch.cuda.device_count()
            return [torch.device("cuda", k % cards) for k in range(n)]
    return [d] * n


def _default_count(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def make_mesh(n_devices=None, axis_name=ROW_AXIS, device="cuda",
              transport=None) -> Mesh:
    """1-D mesh of ``n_devices`` shard slots (default: one per card, or
    one CPU slot).  Shard k sits on ``cuda:(k mod device_count())``, so
    with one card every slot is ``cuda:0``; on ``"cpu"`` every slot is the
    host.

    Under a world of ``torch.distributed`` (:func:`initialize_multihost`)
    it is the mesh of ranks instead, one shard per rank
    (:func:`rank_mesh`; ``n_devices`` must be None or the world size,
    ``transport`` is as there)."""
    if _world_up():
        import torch.distributed as dist
        R = dist.get_world_size()
        if n_devices not in (None, R):
            raise ValueError("under a world of %d ranks the mesh has one "
                             "shard a rank; got n_devices=%d"
                             % (R, n_devices))
        return rank_mesh((R,), (axis_name,), device, transport)
    if transport not in (None, "slots"):
        raise ValueError("transport %r needs a world of ranks "
                         "(initialize_multihost)" % (transport,))
    if n_devices is None:
        n_devices = _default_count(device)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one slot, got %d"
                         % n_devices)
    return Mesh(_slots(int(n_devices), device), (axis_name,))


def default_mesh(device="cuda") -> Mesh:
    return make_mesh(device=device)


def device_mesh_info(mesh: Mesh) -> dict:
    """Host-side summary used by benchmarks and logs: the JAX dict's keys
    (``platform`` is ``"gpu"`` or ``"cpu"``), the process's index and the
    process count (0 and 1 on a mesh of slots), and the transport
    (:attr:`Mesh.transport`)."""
    return {
        "axis_names": tuple(mesh.axis_names),
        "shape": dict(mesh.shape),
        "n_devices": mesh.size,
        "platform": mesh.platform,
        "process_index": 0 if mesh.rank is None else mesh.rank,
        "process_count": 1 if mesh.comm is None else mesh.size,
        "transport": mesh.transport,
    }


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device="cuda", timeout=120.0,
                         **kwargs):
    """Multi-process bootstrap: ``torch.distributed.init_process_group``
    and the device summary after it.

    Explicit arguments start it (``coordinator_address`` as
    ``host:port``, ``num_processes`` the world size, ``process_id`` the
    rank; other keywords, ``store=`` and ``backend=`` among them, go to
    ``init_process_group``), and so does a launch whose environment sets
    ``MASTER_ADDR``, ``WORLD_SIZE`` or ``RANK`` (the ``env://``
    rendezvous).  A plain single-process launch is a no-op, so scripts
    may call it unconditionally; a second call is a no-op too.  The
    backend is NCCL on a card, gloo on the host.  An NCCL rank binds its
    card, ``cuda:(local_rank mod device_count())`` (``LOCAL_RANK`` where
    a launcher sets it, else the rank), before the world starts, and
    hands it to ``init_process_group`` as ``device_id``: its communicator
    is built on that card at once, and no CUDA context of it lands on
    another card.  ``timeout`` (seconds)
    bounds every collective, so a lost rank fails the others instead of
    hanging them.  After it, :func:`make_mesh` builds the mesh of ranks.
    Returns the mesh summary (:func:`device_mesh_info`'s keys) of the
    world: one device a rank, ``process_index`` the rank and
    ``process_count`` the world size; without a world, this process's
    slots.
    """
    import torch.distributed as dist
    explicit = (coordinator_address is not None
                or num_processes is not None or bool(kwargs))
    detected = any(os.environ.get(k) for k in _MULTIHOST_ENV)
    started = dist.is_available() and dist.is_initialized()
    if (explicit or detected) and not started:
        kwargs.setdefault("backend", "nccl"
                          if torch.device(device).type == "cuda"
                          else "gloo")
        if coordinator_address is not None:
            kwargs.setdefault("init_method", "tcp://%s" % coordinator_address)
        if num_processes is not None:
            kwargs.setdefault("world_size", int(num_processes))
        if process_id is not None:
            kwargs.setdefault("rank", int(process_id))
        if kwargs["backend"] == "nccl" and torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", kwargs.get(
                "rank", os.environ.get("RANK", 0))))
            card = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(card)
            kwargs.setdefault("device_id", card)
        kwargs.setdefault("timeout", datetime.timedelta(seconds=timeout))
        dist.init_process_group(**kwargs)
        started = True
    if not started:
        return device_mesh_info(Mesh(_slots(_default_count(device), device),
                                     (ROW_AXIS,)))
    R = dist.get_world_size()
    backend = dist.get_backend()
    return {"axis_names": (ROW_AXIS,), "shape": {ROW_AXIS: R},
            "n_devices": R,
            "platform": "gpu" if torch.device(device).type == "cuda"
            else "cpu",
            "process_index": dist.get_rank(), "process_count": R,
            "transport": "nccl" if backend == "nccl" else "host"}
