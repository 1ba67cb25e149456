"""The port's own spans and counters in a traced run.

The port records a ``solve()`` made while a ``torch.profiler`` session
records, and every operator build, each on its own, and keeps the
recordings (``pykrylov_tpu_torch.utils.observe.kept``): spans of host work
stamped with ``time.time_ns()``, the clock of the profiler's Chrome trace,
and the counters' changes.  :func:`load` reads them once a run, after the
harness has exported and read the traced window:

* the solves whose ``solve`` span lies in the window, their spans placed
  on the trace's clock by its ``baseTimeNanoseconds``;
* those spans merged into the timeline's host events, so that the run's
  ``breakdown`` labels each idle gap by the innermost port span or CUDA
  runtime call, and into the trace file, as ``user_annotation`` events;
* each device operation paired with the runtime call that launched it
  (the ``correlation`` argument), and that call with the innermost span
  around it: device ms an iteration by solver step, and whether each
  product kernel's launch lies inside a ``launch.*`` span;

and prints one ``[trace] spans`` line.  A program without the recorder
gives None, and so do the readers of these numbers.
"""

import gzip
import json
import os
import sys

from benchmark import harness
from benchmark.timeline import DEVICE_CATS

OBSERVE = "pykrylov_tpu_torch.utils.observe"
ITER = ".iter"          # suffix of a solver iteration's span
READ = "read"
LAUNCH = "launch."
# the product kernels, by a part of their names
PRODUCT_KERNELS = ("dia_spmv", "dia_spmm", "sell_spmv", "sell_spmm")


class Span:
    """One port span on the trace's clock (seconds)."""

    __slots__ = ("name", "id", "parent", "start", "end")

    def __init__(self, name, sid, parent, start, end):
        self.name, self.id, self.parent = name, sid, parent
        self.start, self.end = start, end


class Spans:
    """What :func:`load` found.  ``build_stages``: the last build's
    seconds by span, ``build_fill_s`` its ``build.fill`` (None without a
    build); ``spans``: the window's
    solves' spans, oldest start first; ``solves``, ``host_syncs``: the
    solves and host reads recorded in the window; ``issue_idle_s``,
    ``read_idle_s``: the window's idle seconds in gaps whose midpoint lies
    in an iteration span outside its reads, and in a read span;
    ``step_device_s``: device seconds by solver step; ``products``,
    ``products_in_launch``: the product kernels in the window and those
    whose launch lies inside a ``launch.*`` span; ``clock_us``: bounds on
    the device clock less the host's, in us, from the pairs (a span and
    a device gap compare well when both are small)."""

    def __init__(self):
        self.build_fill_s = None
        self.build_stages = {}
        self.spans = []
        self.solves = self.host_syncs = 0
        self.issue_idle_s = self.read_idle_s = 0.0
        self.step_device_s = {}
        self.products = self.products_in_launch = 0
        self.clock_us = [-float("inf"), float("inf")]

    def named(self, test):
        return [s for s in self.spans if test(s.name)]

    def host_iter_s(self):
        """Host seconds in the iteration spans, their reads taken out."""
        iters = {s.id for s in self.spans if s.name.endswith(ITER)}
        if not iters:
            return None
        inside = sum(s.end - s.start for s in self.spans
                     if s.id in iters)
        reads = sum(s.end - s.start for s in self.spans
                    if s.name == READ and s.parent in iters)
        return inside - reads


def observe():
    """The port's recorder, or None for a program without one."""
    mod = sys.modules.get(OBSERVE)
    return mod if mod is not None and hasattr(mod, "kept") else None


def load(run):
    """The run's :class:`Spans`, worked out once and kept on ``run``;
    None for a run without a trace or a program without the recorder."""
    if run.traced is None:
        return None
    if "spans" not in run.traced:
        obs = observe()
        run.traced["spans"] = None if obs is None else _load(run, obs)
    return run.traced["spans"]


def _load(run, obs):
    out = Spans()
    kept = obs.kept()
    builds = [rec for rec in kept
              if any(s[0] == "build.fill" for s in rec.spans)]
    if builds:
        for s in builds[-1].spans:
            out.build_stages[s[0]] = out.build_stages.get(s[0], 0.0) \
                + (s[5] - s[4]) * 1e-9
        out.build_fill_s = out.build_stages["build.fill"]
        harness.log("[trace] spans: the build %s" % ", ".join(
            "%s %.4f s" % kv for kv in out.build_stages.items()))
    path = os.path.join(harness.ROOT, run.traced.get("trace_file", ""))
    if not os.path.isfile(path):
        return out
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds") if isinstance(data, dict) \
        else None
    tl = run.traced["timeline"]
    if base is None or tl.window_s <= 0:
        harness.log("[trace] spans: the trace has %s; nothing merged"
                    % ("no baseTimeNanoseconds" if base is None
                       else "no window"))
        return out
    base = int(base)
    # the traced solves: those whose solve span overlaps the window (the
    # markers that bound it are device times, the spans host times)
    recs = []
    for rec in kept:
        top = [s for s in rec.spans if s[0] == obs.SOLVE and s[2] == 0]
        if top and (top[0][4] - base) * 1e-9 < tl.end \
                and (top[0][5] - base) * 1e-9 > tl.start:
            recs.append(rec)
    raw = [s for rec in recs for s in rec.spans]
    out.solves = len(recs)
    out.host_syncs = sum(rec.counts.get("host_syncs", 0) for rec in recs)
    out.spans = sorted((Span(s[0], s[1], s[2], (s[4] - base) * 1e-9,
                             (s[5] - base) * 1e-9) for s in raw),
                       key=lambda s: (s.start, -s.end))
    # the merge: the timeline's host events and the trace file
    tl.host = sorted(tl.host + [(s.start, s.end, s.name)
                                for s in out.spans])
    data["traceEvents"].extend(obs.chrome_events(raw, base))
    with gzip.open(path, "wt") as f:
        json.dump(data, f)
    _idle(out, tl)
    _steps(out, data["traceEvents"], tl, run.traced.get("iterations"))
    return out


def _innermost(spans, times):
    """For each time of the sorted ``times``, the innermost of the nested
    ``spans`` (sorted by start, then longest first) open then, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _idle(out, tl):
    """Idle seconds by where their gap's midpoint lies: in a read span, or
    in an iteration span outside its reads."""
    gaps = tl.gaps()
    mids = [0.5 * (a + b) for a, b in gaps]
    order = sorted(range(len(gaps)), key=lambda j: mids[j])
    inner = _innermost(out.spans, [mids[j] for j in order])
    by_id = {s.id: s for s in out.spans}
    for j, s in zip(order, inner):
        secs = gaps[j][1] - gaps[j][0]
        while s is not None:
            if s.name == READ:
                out.read_idle_s += secs
                break
            if s.name.endswith(ITER):
                out.issue_idle_s += secs
                break
            s = by_id.get(s.parent)


def _step(s, by_id):
    """The solver step of span ``s``: ``read`` in a read, else the span
    right under an iteration span (the iteration's own name for work
    between its steps); None elsewhere."""
    while s is not None:
        parent = by_id.get(s.parent)
        if s.name == READ or s.name.endswith(ITER):
            return s.name
        if parent is not None and parent.name.endswith(ITER):
            return s.name
        s = parent
    return None


def _steps(out, events, tl, iterations):
    """Pair each device operation of the window with its launching runtime
    call, and the call with its innermost span."""
    calls = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in e.get("args", {}):
            a = float(e["ts"]) * 1e-6
            calls[e["args"]["correlation"]] = (
                a, a + float(e.get("dur", 0)) * 1e-6)
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        corr = e.get("args", {}).get("correlation")
        if b <= tl.start or a >= tl.end or corr not in calls:
            continue
        call = calls[corr]
        # the device clock against the host's: a kernel starts after its
        # launch call does, a copy to pageable memory ends before its call
        # returns
        if e["cat"] == "kernel":
            out.clock_us[1] = min(out.clock_us[1], 1e6 * (a - call[0]))
        elif "DtoH" in e.get("name", "") and "Pageable" in e["name"]:
            out.clock_us[0] = max(out.clock_us[0], 1e6 * (b - call[1]))
        ops.append((call[0], min(b, tl.end) - max(a, tl.start),
                    e.get("name", "")))
    ops.sort()
    by_id = {s.id: s for s in out.spans}
    inner = _innermost(out.spans, [t for t, _, _ in ops])
    for (_, secs, name), s in zip(ops, inner):
        step = _step(s, by_id) or "outside iterations"
        out.step_device_s[step] = out.step_device_s.get(step, 0.0) + secs
        if any(k in name for k in PRODUCT_KERNELS):
            out.products += 1
            if s is not None and s.name.startswith(LAUNCH):
                out.products_in_launch += 1
    launches = out.named(lambda n: n.startswith(LAUNCH))
    per_iter = 1e3 / iterations if iterations else float("nan")
    steps = ", ".join("%s %.4f" % (k, v * per_iter) for k, v in sorted(
        out.step_device_s.items(), key=lambda kv: -kv[1]))
    harness.log(
        "[trace] spans: %d of %d solves merged; device ms an iteration by "
        "step: %s; product kernels launched inside launch.* spans %d of "
        "%d; wrapper host us a launch %s (%d launches); idle ms an "
        "iteration: issue %.4f, read %.4f; host syncs %d; device clock "
        "less host clock %.2f to %.2f us"
        % (len(out.spans), out.solves, steps, out.products_in_launch,
           out.products,
           "%.2f" % (1e6 * sum(s.end - s.start for s in launches)
                     / len(launches)) if launches else "-",
           len(launches), out.issue_idle_s * per_iter,
           out.read_idle_s * per_iter, out.host_syncs, out.clock_us[0],
           out.clock_us[1]))


def per_iteration(run, value):
    """``value`` over the traced iterations, or None."""
    its = run.traced.get("iterations") if run.traced else None
    if value is None or not its:
        return None
    return value / its
