"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, the metrics and the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``, whose ``generator`` is a module of
``configs/``) and its traffic: ``k`` right-hand sides a solve (1: a
vector, more: an (n, k) block), a pool of ``pool`` right-hand sides
taken in turn, the dtype, the solves traced in a ``--trace 1`` run and
the solves kept for the comparison.  The metrics are the readers
``metrics/<name>.py`` of the names ``BENCHMARK.json`` gives the cell.

The window drives the port's front door, nothing stubbed:
``pykrylov_tpu_torch.solve(A, b)`` on the operator that
``pykrylov_tpu_torch.sparse.operator_from_coo(..., symmetric=True)``
built with automatic format, x0 = 0 and ``solve``'s own tolerance.  It
runs solves back to back, each timed from its call to its synchronised
return, from the first call to the return of the last solve started
inside ``--seconds``.
"""

import gc
import gzip
import importlib.util
import json
import math
import os
import random
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_DIR = os.path.join(HERE, "traces")
# top-level module names that no run may load: JAX, its kin, and the JAX
# package (the port's name begins with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pykrylov_tpu")
# launch counters of the port's product kernels: (module, attribute)
COUNTERS = (("pykrylov_tpu_torch.sparse.kernels", "DIA_LAUNCHES"),
            ("pykrylov_tpu_torch.sparse.kernels", "DIA_MM_LAUNCHES"),
            ("pykrylov_tpu_torch.sparse.sell", "SELL_LAUNCHES"),
            ("pykrylov_tpu_torch.sparse.sell", "SELL_MM_LAUNCHES"))
# one-element kernels launched at the start of a profiler session, before
# the traced solves: the card's first records of a session can be lost
TRACE_WARMUP = 200
# the traced window's markers: a sleep kernel of this many cycles
MARK_CYCLES = 1000


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a forbidden module)."""


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``jax.numpy`` counts as ``jax``,
    ``pykrylov_tpu_torch`` is not ``pykrylov_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def check_modules(when):
    found = forbidden_modules()
    if found:
        raise BenchError("forbidden modules loaded %s: %s"
                         % (when, ", ".join(found)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module of the benchmark's folders, loaded from its file (names
    such as ``poisson3d-n240`` are not identifiers)."""
    name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in os.path.abspath(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _here(root):
    return os.path.join(root, "benchmark")


def find_cell(name, root=ROOT):
    """(``BENCHMARK.json``'s entry, the cell's file, its configuration's
    file) of the cell ``name``, under the checkout ``root``."""
    bench = spec(root)
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise BenchError("no workload %r in BENCHMARK.json" % name)
    entry = entry[0]
    config = [c for c in bench["configs"] if c["name"] == entry["config"]]
    cell = load_json(os.path.join(_here(root), "workloads", name + ".json"))
    cfg = load_json(os.path.join(root, config[0]["file"]))
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                            entry["traffic"]):
        raise BenchError("workloads/%s.json names %s/%s, BENCHMARK.json "
                         "%s/%s" % (name, cell["config"], cell["traffic"],
                                    entry["config"], entry["traffic"]))
    return entry, cell, cfg


def metric_names(name, trace, root=ROOT):
    """The metrics a run of the cell ``name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer metrics; a metric without a
    ``workloads`` key is every cell's."""
    bench = spec(root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if name in m.get("workloads", [name])]


def reader_path(metric, root=ROOT):
    """The reader of ``metric``: ``metrics/<metric>.py``; for a metric
    split by the cells it is reported in, ``<base>.<scope>`` (such as
    ``rhs_per_s.host_paced``) without a file of its own, the base's."""
    path = os.path.join(_here(root), "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(_here(root), "metrics",
                            metric.split(".")[0] + ".py")
    return path


def reader(metric, root=ROOT):
    return load_module(reader_path(metric, root))


def coo_of(cfg, root=ROOT):
    gen = load_module(os.path.join(_here(root), "configs",
                                   cfg["generator"] + ".py"))
    return gen.coo(cfg)


class Solve:
    """What the window kept of one solve."""

    __slots__ = ("wall_s", "n_iter", "columns", "ok")

    def __init__(self, wall_s, n_iter, columns, ok):
        self.wall_s, self.n_iter = wall_s, n_iter
        self.columns, self.ok = columns, ok


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from a
    seeded generator (Algorithm R)."""

    def __init__(self, size, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


class Run:
    """Everything a metric reader may read of one run.

    ``stages`` (set-up seconds by stage), ``setup_s``, ``window_s``,
    ``solves`` (a :class:`Solve` each), ``peak_bytes``, ``failed`` (columns
    not accepted), ``traced`` (with ``--trace 1``: the traced solves'
    ``iterations``, ``launches`` by counter, ``timeline``), ``product_ms``
    (with ``--trace 1`` on a card: device ms of the operator's product at
    the cell's block width, read cold), ``cell``, ``cfg``,
    ``device_name``."""

    def __init__(self, cell, cfg):
        self.cell, self.cfg = cell, cfg
        self.device_name = None
        self.stages = {}
        self.setup_s = self.window_s = None
        self.solves = []
        self.peak_bytes = 0
        self.failed = 0
        self.traced = None
        self.product_ms = None
        self.checks = {}

    @property
    def attempted(self):
        return sum(s.columns for s in self.solves)


def _counters():
    return {"%s.%s" % (m.rsplit(".", 1)[1], a):
            getattr(sys.modules[m], a) for m, a in COUNTERS}


class Bench:
    """One cell's operator, pool and window: set up once, run once (a
    benchmark run) or on many seeds (``control.py``)."""

    def __init__(self, cell, cfg, device="cuda", trace_dir=TRACE_DIR,
                 root=ROOT):
        import torch
        self.torch = torch
        self.cell, self.cfg, self.device = cell, cfg, device
        self.trace_dir, self.root = trace_dir, root
        self.dtype = getattr(torch, cell["dtype"])
        self.on_card = torch.device(device).type == "cuda"

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    # -- set-up ------------------------------------------------------------

    def build(self, stages):
        """The configuration's triples and the port's operator."""
        import pykrylov_tpu_torch as pt
        from pykrylov_tpu_torch.sparse import operator_from_coo
        self.pt = pt
        t = time.perf_counter()
        self.coo = coo_of(self.cfg, self.root)
        stages["coo"] = time.perf_counter() - t
        t = time.perf_counter()
        vals, rows, cols, shape = self.coo
        self.A = operator_from_coo(vals, rows, cols, shape,
                                   symmetric=bool(self.cfg["symmetric"]),
                                   device=self.device)
        self.sync()
        stages["build"] = time.perf_counter() - t
        log("[setup] operator: %d x %d, %d nonzeros, format %s"
            % (shape[0], shape[1], len(vals), getattr(self.A, "fmt", "?")))

    def make_pool(self, seed, stages):
        """The pool of right-hand sides and the product check's probe.

        Every seed solves the same set, so no seed changes the work:
        ``b = A x_true`` for x_true standard normal drawn from the cell's
        ``pool_seed`` (the product in float64 from the triples, then the
        cell's dtype).  ``seed`` draws their order, a power-of-two scale
        for each (exact in floating point: CG takes the same iterations,
        but each seed's inputs differ) and the probe."""
        from . import reference
        torch = self.torch
        t = time.perf_counter()
        n, k = int(self.cfg["rows"]), int(self.cell["k"])
        shape = (n,) if k == 1 else (n, k)
        base = torch.Generator(device=self.device)
        base.manual_seed(int(self.cell["pool_seed"]))
        A64 = reference.Coo(self.coo, self.device)
        made = [A64.matmul(torch.randn(shape, generator=base,
                                       device=self.device,
                                       dtype=self.dtype))
                for _ in range(int(self.cell["pool"]))]
        del A64
        rng = random.Random(int(seed))
        order = list(range(len(made)))
        rng.shuffle(order)
        self.pool = [(made[j] * 2.0 ** rng.randint(-4, 4)).to(self.dtype)
                     for j in order]
        del made
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.probe = torch.randn(shape, generator=self.gen,
                                 device=self.device, dtype=self.dtype)
        self.sync()
        stages["pool"] = time.perf_counter() - t

    def warm_up(self, stages, trace):
        """One solve of the cell's shape (kernels loaded or built, the
        allocator's blocks cached), and with ``trace`` one more under a
        first profiler session: a process's first session, and the first
        launch of each kernel in a session, cost the host extra time that
        would otherwise fall into the traced window."""
        t = time.perf_counter()
        self.pt.solve(self.A, self.pool[0])
        self.sync()
        stages["warmup"] = time.perf_counter() - t
        if trace:
            t = time.perf_counter()
            prof = self._profiler()
            prof.start()
            self._launch_burst()
            self._mark()
            self.pt.solve(self.A, self.pool[0])
            self.sync()
            prof.stop()
            stages["profiler"] = time.perf_counter() - t

    def _profiler(self):
        """On a card, the device's activity and the CUDA runtime calls
        alone: recording every torch operator on the host as well costs
        ~10 us a launch, which nearly doubled the wall time of a host-paced
        iteration and so the idle share read from it."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if self.on_card
                else ProfilerActivity.CPU]
        return profile(activities=acts)

    def _launch_burst(self):
        one = self.torch.zeros(1, device=self.device)
        for _ in range(TRACE_WARMUP):
            one.add_(1)
        self.sync()

    def _mark(self):
        """A marker kernel (the timeline's MARKER), waited for."""
        if self.on_card:
            self.torch.cuda._sleep(MARK_CYCLES)
            self.sync()

    # -- the window --------------------------------------------------------

    def window(self, run, seed, seconds, trace):
        """Solves back to back for ``seconds``; with ``trace`` the first
        ``trace_solves`` under the profiler.  Keeps a seeded sample of
        ``check_solves`` answers for the comparison."""
        pt, A, pool = self.pt, self.A, self.pool
        sample = Reservoir(int(self.cell["check_solves"]),
                           random.Random(int(seed)))
        n_traced = int(self.cell["trace_solves"]) if trace else 0
        prof = None
        if n_traced:
            prof = self._profiler()
            prof.start()
            self._launch_burst()
            self._mark()
            before = _counters()
        self.sync()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            j = i % len(pool)
            t0 = time.perf_counter()
            res = pt.solve(A, pool[j])
            self.sync()
            t1 = time.perf_counter()
            conv = res.converged.reshape(-1).tolist()
            stop = res.istop.reshape(-1).tolist()
            ok = sum(1 for c, s in zip(conv, stop) if c and s == 0)
            run.solves.append(Solve(t1 - t0, int(res.n_iter), len(conv), ok))
            sample.offer((j, res.x))
            del res
            i += 1
            if prof is not None and i == n_traced:
                self._mark()
                prof.stop()
                after = _counters()
                run.traced = {
                    "solves": n_traced,
                    "iterations": sum(s.n_iter for s in run.solves),
                    "launches": {c: after[c] - before[c] for c in after},
                    "profile": prof}
                prof = None
            if t1 >= deadline and prof is None:
                break
        run.window_s = t1 - t_start
        self.sample = sample.items

    def read_trace(self, run, name, seed):
        """Export the traced solves' timeline under ``trace_dir``, read it
        back, gzip it."""
        from .timeline import Timeline, load
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, "%s-%d.json" % (name, seed))
        prof = run.traced.pop("profile")
        prof.export_chrome_trace(path)
        del prof
        tl = Timeline(load(path))
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
        run.traced["timeline"] = tl
        run.traced["trace_file"] = os.path.relpath(path + ".gz", ROOT)
        products = sum(1 for n, _ in tl.kernels()
                       if "spmv" in n.lower() or "spmm" in n.lower())
        log("[trace] %s: %d device operations recorded, %d markers, %d "
            "in the window, %d product kernels for %d launches counted, "
            "window %.4f s"
            % (run.traced["trace_file"], tl.recorded, tl.marks,
               len(tl.device), products,
               sum(run.traced["launches"].values()), tl.window_s))
        # the profiler's own cost: the traced wall an iteration against
        # that of the window's untraced solves
        rest = run.solves[run.traced["solves"]:]
        iters = sum(s.n_iter for s in rest)
        if iters and run.traced["iterations"]:
            log("[trace] wall ms an iteration: traced %.4f, untraced %.4f "
                "(%d solves)"
                % (1e3 * tl.window_s / run.traced["iterations"],
                   1e3 * sum(s.wall_s for s in rest) / iters, len(rest)))

    def time_product(self, run):
        """Device ms of the operator's product at the cell's block width,
        the L2 flushed before each call (on a card only)."""
        from . import roofline
        if not self.on_card:
            return
        torch, A = self.torch, self.A
        k = int(self.cell["k"])
        shape = self.probe.shape
        inputs = [torch.randn(shape, generator=self.gen, device=self.device,
                              dtype=self.dtype) for _ in range(2)]
        fn = (lambda x: A.matvec(x)) if k == 1 else (lambda x: A @ x)
        run.product_ms = roofline.product_ms(fn, inputs, torch)
        del inputs

    # -- the comparison ----------------------------------------------------

    def program_product(self):
        """The port's product of the probe: ``A.matvec(v)``, or ``A @ V``
        (the block rule ``cg_batched`` calls) for a block cell."""
        if self.probe.dim() == 1:
            return self.A.matvec(self.probe)
        return self.A @ self.probe

    def judge(self, run, product, answers):
        """Hold the port's product of the probe and its sampled answers to
        the reference, in float64 from the triples.  ``answers`` are
        (pool index, x).  Sets ``run.checks`` (name: [value, limit]),
        ``run.failed`` and returns whether every check holds."""
        from . import reference
        limits = self.cell["limits"]
        A64 = reference.Coo(self.coo, self.device)
        err = reference.max_rel_err(product, A64.matmul(self.probe))
        rels = []
        for j, x in answers:
            rels += reference.rel_residuals(A64, self.pool[j], x)
        del A64
        # a NaN residual reads as infinite: it fails any limit
        rels = [r if r == r else math.inf for r in rels]
        resid = max(rels, default=math.inf)
        bad = sum(1 for r in rels if not r <= limits["resid_max"])
        unconverged = sum(s.columns - s.ok for s in run.solves)
        run.failed = min(run.attempted, unconverged + bad)
        run.checks = {
            "product_err": [err, limits["product_err"]],
            "resid_max": [resid, limits["resid_max"]],
            "unconverged": [unconverged, limits["unconverged"]],
        }
        return all(v <= lim for v, lim in run.checks.values())

    def free_program(self):
        """Drop the port's operator (the reference runs after it, so it
        never sets the peak)."""
        del self.A
        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()


def json_number(v):
    """A number for strict JSON: a non-finite one as its name."""
    return v if math.isfinite(v) else repr(float(v))


def device_name(torch, device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def run_cell(name, seed, seconds, trace, t_start, device="cuda",
             cell=None, cfg=None, root=ROOT, trace_dir=TRACE_DIR):
    """One run of the cell ``name``: the result line's dict.  ``cell``
    and ``cfg`` replace the cell's files (the tests run small copies on
    the CPU); ``t_start`` is the process's first clock reading."""
    if cell is None:
        entry, cell, cfg = find_cell(name, root)
        cell = dict(cell, chips=entry["chips"])
    t = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t
    import pykrylov_tpu_torch  # noqa: F401  (import time is set-up)
    run = Run(cell, cfg)
    run.stages["python"] = t - t_start
    run.stages["import_torch"] = t_torch
    run.stages["import_port"] = time.perf_counter() - t - t_torch
    if torch.device(device).type == "cuda":
        chips = int(cell.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError("the cell needs %d CUDA device(s); torch sees "
                             "%d" % (chips, torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0))
    run.device_name = device_name(torch, device)
    bench = Bench(cell, cfg, device, trace_dir, root)
    bench.build(run.stages)
    bench.make_pool(seed, run.stages)
    bench.warm_up(run.stages, trace)
    check_modules("after set-up")
    if bench.on_card:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    for stage, secs in run.stages.items():
        log("[setup] %s %.4f s" % (stage, secs))
    log("[setup] setup_s %.4f s" % run.setup_s)

    bench.window(run, seed, seconds, trace)
    if bench.on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    check_modules("after the window")
    walls = [s.wall_s for s in run.solves]
    half = max(1, len(walls) // 2)
    log("[window] %d solves, %d columns, %.4f s; a solve %.4f to %.4f s, "
        "median %.4f, mean of the first half %.4f, of the second %.4f"
        % (len(walls), run.attempted, run.window_s, min(walls), max(walls),
           sorted(walls)[len(walls) // 2], sum(walls[:half]) / half,
           sum(walls[half:]) / max(1, len(walls) - half)))
    if run.traced is not None:
        bench.read_trace(run, name, seed)
        bench.time_product(run)
    product = bench.program_product()
    answers = bench.sample
    bench.free_program()
    correct = bench.judge(run, product, answers)
    del product, answers, bench

    metrics = {}
    for metric, unit in metric_names(name, trace, root):
        value = reader(metric, root).read(run)
        if value is not None and math.isfinite(value):
            metrics[metric] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu", "kind": run.device_name,
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.traced is not None:
        tl = run.traced["timeline"]
        dev["busy_s"] = tl.busy_s()
        dev["window_s"] = tl.window_s
        out["breakdown"] = tl.breakdown()
    check_modules("at the end")
    out["checks"] = {k: {"value": json_number(v), "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    for k, (v, lim) in run.checks.items():
        log("check %s %r limit %r" % (k, v, lim))
    return out
