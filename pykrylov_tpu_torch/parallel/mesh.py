"""Meshes of shard slots.

Counterpart of ``pykrylov_tpu/parallel/mesh.py``.  The JAX package runs a
single controller: one process holds a ``jax.sharding.Mesh`` of devices
and the solvers stay unchanged, XLA placing the collectives.  Here one
process holds a :class:`Mesh` of shard slots: slot k is the device that
keeps shard k's storage and runs its products.  Slots may repeat, so P
shards can share one card (as the JAX package's tests run 8 virtual
devices on one CPU): the exchanges and the per-shard kernel launches then
run on that card at full width.  A sharded vector is one tensor on the
mesh's first slot (its home), so the solvers' dots and updates are plain
torch calls on whole tensors.

A mesh that spans processes (one rank per card, NCCL collectives) is not
ported: :func:`initialize_multihost` starts ``torch.distributed`` for
such a launch, and :func:`make_mesh` then raises.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "default_mesh", "device_mesh_info",
           "initialize_multihost", "ROW_AXIS"]

ROW_AXIS = "rows"

# environment of a multi-process launch (torchrun and its kin)
_MULTIHOST_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

# the ROADMAP item that ports meshes across processes
MULTIPROCESS_ITEM = "ROADMAP queue 1 item 22 (a multi-process NCCL mesh)"


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
    """

    def __init__(self, devices, axis_names):
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
        self.home = self.slots[0]

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
        return "Mesh(%s, %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            sorted({str(s) for s in self.slots}))


def _multiprocess():
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


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


def make_mesh(n_devices=None, axis_name=ROW_AXIS, device="cuda") -> Mesh:
    """1-D mesh of ``n_devices`` shard slots (default: one per card, or
    one CPU slot).  Shard k sits on ``cuda:(k mod device_count())``, so
    with one card every slot is ``cuda:0``; on ``"cpu"`` every slot is the
    host."""
    if _multiprocess():
        raise NotImplementedError(
            "make_mesh builds a mesh of one process; a mesh across the "
            "ranks of torch.distributed is %s" % MULTIPROCESS_ITEM)
    if n_devices is None:
        n_devices = _default_count(device)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one slot, got %d"
                         % n_devices)
    return Mesh(_slots(int(n_devices), device), (axis_name,))


def default_mesh(device="cuda") -> Mesh:
    return make_mesh(device=device)


def device_mesh_info(mesh: Mesh) -> dict:
    """Host-side summary used by benchmarks and logs (the JAX dict's
    keys; ``platform`` is ``"gpu"`` or ``"cpu"``)."""
    return {
        "axis_names": tuple(mesh.axis_names),
        "shape": dict(mesh.shape),
        "n_devices": mesh.size,
        "platform": mesh.platform,
    }


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device="cuda", **kwargs):
    """Multi-process bootstrap: ``torch.distributed.init_process_group``
    and the device summary after it.

    Explicit arguments start it (``coordinator_address`` as
    ``host:port``, ``num_processes`` the world size, ``process_id`` the
    rank; other keywords go to ``init_process_group``), and so does a
    launch whose environment sets ``MASTER_ADDR``, ``WORLD_SIZE`` or
    ``RANK`` (the ``env://`` rendezvous).  A plain single-process launch
    is a no-op, so scripts may call it unconditionally; a second call is
    a no-op too.  The backend is NCCL on a card, gloo on the host.
    Returns the mesh summary of this process's slots with
    ``process_index`` (rank) and ``process_count`` (world size).
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
        dist.init_process_group(**kwargs)
        started = True
    n = _default_count(device)
    info = device_mesh_info(Mesh(_slots(n, device), (ROW_AXIS,)))
    info["process_index"] = dist.get_rank() if started else 0
    info["process_count"] = dist.get_world_size() if started else 1
    return info
