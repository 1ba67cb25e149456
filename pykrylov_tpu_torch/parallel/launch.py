"""Spawn a world of ranks on one host and collect what each rank returns.

:func:`spawn_ranks` starts R processes with the ``spawn`` method (never
``fork``: the parent may hold a CUDA context), joins them into one world
of ``torch.distributed`` through a ``FileStore`` in a temporary directory
(no ports), runs ``fn(*args)`` on every rank and returns the results in
rank order.  A lost rank never hangs the parent: the world's collectives
time out after ``timeout`` seconds, the parent waits at most ``deadline``
seconds in all, a rank that raises sends its traceback, and on any failure
the parent kills the surviving ranks and raises :class:`RankFailure`.
A gloo rank runs torch's intra-op threads on an equal share of the
host's cores: R ranks whose operators run on the host would otherwise
run R threads a core (four CPU ranks on an 8-core host then took minutes
for a CG that takes seconds with the share).  NCCL ranks keep torch's
default, every core, which ran a four-card halo CG 0.05-0.15 ms an
iteration faster than a quarter of them (NVIDIA H100 80GB HBM3,
``chip_smoke.py --nccl``, 21e).  An NCCL rank binds its card before the
world starts (:func:`~.mesh.initialize_multihost`).
``fn`` must be importable by name (a module-level function), and so must
its module in a fresh interpreter.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

__all__ = ["spawn_ranks", "RankFailure"]


class RankFailure(RuntimeError):
    """A spawned rank raised, died or outlived the deadline."""


def host_threads(n_ranks):
    """Intra-op threads a rank of ``n_ranks`` on this host takes: an
    equal share of the cores this process may run on, at least one."""
    return max(1, len(os.sched_getaffinity(0)) // n_ranks)


def _rank_main(q, fn, rank, n_ranks, store_path, backend, timeout, args):
    import torch
    import torch.distributed as dist
    try:
        if backend == "gloo":
            torch.set_num_threads(host_threads(n_ranks))
        from .mesh import initialize_multihost
        initialize_multihost(num_processes=n_ranks, process_id=rank,
                             store=dist.FileStore(store_path, n_ranks),
                             backend=backend, timeout=timeout)
        q.put((rank, True, fn(*args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks, *args, backend="gloo", timeout=60.0,
                deadline=300.0):
    """``[fn(*args) on rank r for r in range(n_ranks)]``, each rank a
    spawned process in a world of ``n_ranks`` with ``backend``.

    ``timeout`` bounds each collective (seconds), ``deadline`` the whole
    run; a failure of any rank kills the others and raises
    :class:`RankFailure` with the first failing rank's traceback.
    """
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(q, fn, r, n_ranks,
                                   os.path.join(tmp, "store"), backend,
                                   timeout, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        results, failure = {}, None
        end = time.monotonic() + deadline
        try:
            while len(results) < n_ranks and failure is None:
                left = end - time.monotonic()
                if left <= 0:
                    failure = "the world outlived its %.0f s deadline " \
                              "(ranks done: %s)" % (deadline,
                                                    sorted(results))
                    break
                try:
                    rank, ok, payload = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        failure = "rank %d died (exit code %s)" % (
                            dead[0], procs[dead[0]].exitcode)
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failure = "rank %d raised:\n%s" % (rank, payload)
        finally:
            grace = time.monotonic() + (5.0 if failure is None else 0.0)
            for p in procs:
                p.join(max(0.0, grace - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        if failure is not None:
            raise RankFailure(failure)
        return [results[r] for r in range(n_ranks)]
