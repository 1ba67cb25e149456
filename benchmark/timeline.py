"""One traced window, read from the profiler's Chrome trace.

The harness launches a marker kernel (``torch.cuda._sleep``, whose
kernel is ``spin_kernel``), synchronises, runs the traced solves, and
launches a second marker; the window runs from the first marker's end to
the last one's start.  Device operations (kernels, copies, sets) are
clipped to the window; busy time is the length of their union, and each
idle gap is labelled by what the host was doing in its middle: the
innermost host event running then (an operator, or a CUDA runtime call),
or ``HOST_IDLE`` where none was.
"""

import gzip
import json

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
HOST_IDLE = "host: between runtime calls and operators"
TOP = 10


def load(path):
    """The events of a Chrome trace file (plain or gzipped JSON)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


class Timeline:
    """Intervals in seconds from a list of Chrome trace events."""

    def __init__(self, events):
        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                device.append((a, b, name, cat))
            elif cat in HOST_CATS:
                host.append((a, b, name))
        marks = sorted(d for d in device if MARKER in d[2])
        self.recorded, self.marks = len(device), len(marks)
        if len(marks) >= 2:
            self.start, self.end = marks[0][1], marks[-1][0]
        else:
            self.start = self.end = 0.0
        self.device = sorted((max(a, self.start), min(b, self.end), n, c)
                             for a, b, n, c in device
                             if b > self.start and a < self.end
                             and MARKER not in n)
        self.host = sorted(host)

    @property
    def window_s(self):
        return self.end - self.start

    def kernels(self):
        """(name, seconds) of every kernel in the window."""
        return [(n, b - a) for a, b, n, c in self.device if c == "kernel"]

    def busy(self):
        """The union of the device operations' intervals, merged."""
        merged = []
        for a, b, _, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self):
        return sum(b - a for a, b in self.busy())

    def gaps(self):
        """The idle intervals of the window."""
        out, t = [], self.start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def gap_labels(self, gaps):
        """The innermost host operation running in the middle of each gap
        (the latest started of those running then), else HOST_IDLE."""
        labels, active, i = [], [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(self.host) and self.host[i][0] <= mid:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            inner = [h for h in active if h[0] <= mid]
            labels.append(max(inner)[2] if inner else HOST_IDLE)
        return labels

    def breakdown(self):
        """The device operations that took most time and the idle time by
        what the host was doing, each ``TOP`` entries of [name,
        seconds]."""
        ops = {}
        for a, b, n, _ in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a)
        gaps = self.gaps()
        idle = {}
        for (a, b), label in zip(gaps, self.gap_labels(gaps)):
            idle[label] = idle.get(label, 0.0) + (b - a)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(ops), "idle_gaps": top(idle)}
