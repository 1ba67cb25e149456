"""Observability: the port's spans and counters, profiler traces,
replication checks and a solve summary.

Counterpart of ``pykrylov_tpu/utils/observe.py``.  The JAX package traces
with ``jax.profiler``; here a trace is a ``torch.profiler`` session over
the host and, where a card is present, its CUDA activity, written as a
Chrome trace (``chrome://tracing``, Perfetto):

  * :func:`span` and :func:`count`: the port's own spans and counters
    (below), which the solvers, the launch wrappers and the operator build
    carry;
  * :func:`trace` / :func:`profiled`: a trace around a block or around
    each call of a solve, with the spans recorded inside it merged in;
  * :func:`annotate`: a named span in such a trace (and an NVTX range on
    a card, for external profilers);
  * :func:`assert_replicated`: the check that a quantity every shard of a
    mesh holds is the same on all of them (bit for bit by default);
  * :func:`solve_stats`: a host-side summary dict of a ``SolveResult``.

Spans.  ``with span(name, **attrs):`` marks a stretch of host work.  While
recording is off it returns one shared no-op object after one test of a
module flag, so the solvers' loops carry spans at no measurable cost.
While recording is on it appends ``(name, id, parent, solve, start_ns,
end_ns, attrs)`` to the recording: ids count from 1, ``parent`` is the id
of the span open around it (0 at the top), ``solve`` the id of the
front door's ``solve`` span it runs under (:func:`solving`; 0 outside
one), and ``attrs`` the keyword arguments (None when there are none).
Start and end are ``time.time_ns()``, the clock of the profiler's Chrome
trace: an event's ``ts`` there is ``(time_ns - baseTimeNanoseconds) /
1000`` microseconds, so spans merge into a trace at their place
(:func:`chrome_events`).  :func:`count` adds to a named counter whether
recording is on or not; a recording reports how each counter moved.

Recording is on:

  * inside :func:`recording` (and :func:`trace`), which returns the
    spans and the counters' changes when the block ends;
  * inside a ``solve()`` made while a ``torch.profiler`` session records
    (``record_function``'s rule), and inside every ``operator_from_coo``
    build (a handful of spans against seconds of host work): each such
    call is recorded on its own and kept, newest last, for whoever ran
    the profiler to merge afterwards (:func:`kept`; the oldest calls are
    dropped once the kept ones hold more than ``KEEP_SPANS`` spans).

The recorder is one per process: spans nest by the order they open and
close in, so it serves a process whose solves run on one thread at a
time, as the port's do.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "count", "recording", "Recording", "solving",
           "building", "kept", "chrome_events", "trace", "profiled",
           "annotate", "assert_replicated", "solve_stats"]

SOLVE = "solve"             # the front door's span, which owns a solve id
KEEP_SPANS = 1 << 17        # spans the kept calls may hold together

_clock = time.time_ns       # the profiler's Chrome trace clock
_on = False                 # recording
_sink = None                # the open recording's list of spans
_stack = [0]                # ids of the open spans, innermost last, on 0
_solve = 0                  # the open solve span's id
_ids = itertools.count(1)
_counts = {}
_kept = collections.deque()
_kept_spans = 0
_tracing = False            # inside trace(): annotate enters record_function
_in_file = set()            # ids of spans record_function wrote to the trace
_TRACE_SEQ = itertools.count()


class _Off:
    """What :func:`span` returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.id = sid = next(_ids)
        self.parent = _stack[-1]
        _stack.append(sid)
        self.start = _clock()
        return self

    def __exit__(self, typ, value, tb):
        end = _clock()
        _stack.pop()
        if _sink is not None:
            _sink.append((self.name, self.id, self.parent, _solve,
                          self.start, end, self.attrs))
        return False


class _SolveSpan(_Span):
    """The front door's span: the spans under it carry its id as their
    solve id (an inner ``solve()`` keeps the outer one's)."""
    __slots__ = ("owns",)

    def __enter__(self):
        global _solve
        _Span.__enter__(self)
        self.owns = _solve == 0
        if self.owns:
            _solve = self.id
        return self

    def __exit__(self, typ, value, tb):
        global _solve
        _Span.__exit__(self, typ, value, tb)
        if self.owns:
            _solve = 0
        return False


def span(name, **attrs):
    """A span of host work named ``name`` (the module docstring); a no-op
    while recording is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs or None)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (a recording reports the
    counters' changes over it)."""
    _counts[name] = _counts.get(name, 0) + n


class Recording:
    """Recording turned on for a block (``with Recording() as rec``, or
    :func:`recording`): ``spans``, the spans that ended in it, oldest
    end first, and, once it has ended, ``counts``, the counters that moved
    in it and by how much.  A recording opened inside another hands its
    spans to the outer one too."""

    def __init__(self):
        self.spans = []
        self.counts = {}

    def __enter__(self):
        global _on, _sink
        self._outer = (_on, _sink)
        self._before = dict(_counts)
        _on, _sink = True, self.spans
        return self

    def __exit__(self, *exc):
        global _on, _sink
        _on, _sink = self._outer
        before = self._before
        self.counts = {k: v - before.get(k, 0) for k, v in _counts.items()
                       if v != before.get(k, 0)}
        if _sink is not None:
            _sink.extend(self.spans)
        return False


def recording():
    """Turn recording on for a block; yields the :class:`Recording`."""
    return Recording()


class _Kept(Recording):
    """A call recorded on its own (under its span, if any) and kept."""

    def __init__(self, top=None):
        super().__init__()
        self._top = top

    def __enter__(self):
        super().__enter__()
        if self._top is not None:
            self._top.__enter__()
        return self

    def __exit__(self, *exc):
        global _kept_spans
        if self._top is not None:
            self._top.__exit__(*exc)
        super().__exit__(*exc)
        _kept.append(self)
        _kept_spans += len(self.spans)
        while _kept_spans > KEEP_SPANS and len(_kept) > 1:
            _kept_spans -= len(_kept.popleft().spans)
        return False


def solving(**attrs):
    """The front door's ``solve`` span, which owns the solve id of every
    span under it.  While recording is off and a ``torch.profiler``
    session records, the call is recorded on its own and kept
    (:func:`kept`)."""
    if _on:
        return _SolveSpan(SOLVE, attrs or None)
    if _autograd_profiler._is_profiler_enabled:
        return _Kept(_SolveSpan(SOLVE, attrs or None))
    return _OFF


def building():
    """An operator build, recorded on its own and kept while recording is
    off (inside a recording its spans go there)."""
    return _OFF if _on else _Kept()


def kept(clear=False):
    """The calls recorded on their own (:class:`Recording` each), oldest
    first; ``clear`` empties the store."""
    global _kept_spans
    out = list(_kept)
    if clear:
        _kept.clear()
        _kept_spans = 0
    return out


def chrome_events(spans, base_ns):
    """Chrome ``X`` events (``cat`` ``user_annotation``, as
    ``record_function`` writes them, on this process and thread) of
    ``spans`` for a trace whose ``baseTimeNanoseconds`` is ``base_ns``;
    ``args`` hold the span's id, parent, solve id and attributes."""
    pid, tid = os.getpid(), threading.get_native_id()
    out = []
    for name, sid, parent, solve, t0, t1, attrs in spans:
        args = {"span": sid, "parent": parent, "solve": solve}
        if attrs:
            args.update(attrs)
        out.append({"ph": "X", "cat": "user_annotation", "name": name,
                    "pid": pid, "tid": tid, "ts": (t0 - base_ns) / 1e3,
                    "dur": (t1 - t0) / 1e3, "args": args})
    return out


def _merge_chrome_trace(path, spans):
    """Append ``spans`` to the Chrome trace at ``path`` (plain JSON, as
    ``export_chrome_trace`` writes it) at their place on its clock; a
    file without ``baseTimeNanoseconds`` to place them by is left as it
    is."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds")
    if base is None or not spans:
        return
    data["traceEvents"].extend(chrome_events(spans, int(base)))
    with open(path, "w") as f:
        json.dump(data, f)


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir):
    """Profile a block with ``torch.profiler`` and write its Chrome trace
    into ``log_dir`` when the block ends, with the port's spans recorded
    in the block merged in.  The device is synchronised before the
    profiler stops, so the trace holds the kernels the block launched
    (JAX's ``block_until_ready``).  Yields the profiler, whose
    ``trace_file`` names the file, whose ``recording`` is the block's
    :class:`Recording` and whose ``key_averages()`` summarise the block.

    >>> with trace("traces") as prof:
    ...     res = cg(A, b)
    """
    global _tracing
    from torch.profiler import profile
    log_dir = str(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.trace_file = os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), next(_TRACE_SEQ)))
    prof.recording = rec = Recording()
    outer = _tracing
    prof.start()
    try:
        with rec:
            _tracing = True
            try:
                yield prof
            finally:
                _tracing = outer
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(prof.trace_file)
        _merge_chrome_trace(prof.trace_file,
                           [s for s in rec.spans if s[1] not in _in_file])
        _in_file.difference_update(s[1] for s in rec.spans)


def profiled(fn, log_dir):
    """Wrap a solve callable so each call is traced into ``log_dir``
    (:func:`trace`, which synchronises the device before it closes)."""
    def wrapper(*args, **kwargs):
        with trace(log_dir):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def annotate(name):
    """A :func:`span`, and an NVTX range where a card is present; inside a
    :func:`trace` also a ``record_function``, so the profiler's own
    summary (``key_averages()``) holds it."""
    with contextlib.ExitStack() as stack:
        s = stack.enter_context(span(name))
        if _tracing:
            stack.enter_context(torch.profiler.record_function(name))
            _in_file.add(s.id)
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
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
