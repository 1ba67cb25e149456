"""Observability: profiler traces, named spans, replication checks and a
solve summary.

Counterpart of ``pykrylov_tpu/utils/observe.py``.  The JAX package traces
with ``jax.profiler``; here a trace is a ``torch.profiler`` session over
the host and, where a card is present, its CUDA activity, written as a
Chrome trace (``chrome://tracing``, Perfetto):

  * :func:`trace` / :func:`profiled`: a trace around a block or around
    each call of a solve;
  * :func:`annotate`: a named span in such a trace (and an NVTX range on
    a card, for external profilers);
  * :func:`assert_replicated`: the check that a quantity every shard of a
    mesh holds is the same on all of them (bit for bit by default);
  * :func:`solve_stats`: a host-side summary dict of a ``SolveResult``.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import numpy as np
import torch

__all__ = ["trace", "profiled", "annotate", "assert_replicated",
           "solve_stats"]

_TRACE_SEQ = itertools.count()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir):
    """Profile a block with ``torch.profiler`` and write its Chrome trace
    into ``log_dir`` when the block ends.  The device is synchronised
    before the profiler stops, so the trace holds the kernels the block
    launched (JAX's ``block_until_ready``).  Yields the profiler, whose
    ``trace_file`` names the file and whose ``key_averages()`` summarise
    the block.

    >>> with trace("traces") as prof:
    ...     res = cg(A, b)
    """
    from torch.profiler import profile
    log_dir = str(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.trace_file = os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), next(_TRACE_SEQ)))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(prof.trace_file)


def profiled(fn, log_dir):
    """Wrap a solve callable so each call is traced into ``log_dir``
    (:func:`trace`, which synchronises the device before it closes)."""
    def wrapper(*args, **kwargs):
        with trace(log_dir):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def annotate(name):
    """A named span in a profiler trace (``record_function``), and an NVTX
    range where a card is present."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_replicated(x, atol=0.0):
    """Check that a replicated quantity is the same on every shard.

    ``x`` is a tensor (one process holds one copy: nothing to compare) or
    a sequence of per-shard tensors, which must be equal bit for bit
    (``atol=0``) or within ``atol``; divergence means a nondeterministic
    reduction or a race in a kernel.  Returns the host value (the first
    shard's)."""
    if isinstance(x, torch.Tensor) or not isinstance(x, (list, tuple)):
        return _host(x)
    if len(x) == 0:
        raise ValueError("assert_replicated: no shards")
    ref = _host(x[0])
    for k, s in enumerate(x[1:], start=1):
        got = _host(s)
        dev = s.device if isinstance(s, torch.Tensor) else "host"
        if ref.shape != got.shape:
            raise AssertionError(
                "shard shapes differ: %s vs %s (shard %d on %s)"
                % (ref.shape, got.shape, k, dev))
        if atol == 0.0:
            same = np.array_equal(ref, got)
        else:
            same = np.allclose(ref, got, atol=atol, rtol=0)
        if not same:
            raise AssertionError(
                "replicated value diverges on shard %d on %s "
                "(max abs diff %.3e)" % (
                    k, dev, float(np.max(np.abs(ref - got)))))
    return ref


def solve_stats(result, wall_time=None):
    """Host-side metrics summary of a :class:`SolveResult`."""
    stats = {
        "converged": bool(result.converged),
        "istop": int(result.istop),
        "n_iter": int(result.n_iter),
        "n_matvec": int(result.n_matvec),
        "resid_norm": float(result.resid_norm),
        "resid_norm0": float(result.resid_norm0),
    }
    if wall_time is not None:
        stats["wall_time_s"] = float(wall_time)
        stats["iter_per_s"] = stats["n_iter"] / max(wall_time, 1e-12)
    for k, v in result.info.items():
        if np.ndim(_host(v) if isinstance(v, torch.Tensor) else v) == 0:
            try:
                stats[k] = float(v)
            except (TypeError, ValueError):
                pass
    return stats
