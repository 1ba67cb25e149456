"""The port's spans merged into a traced window (``spans.py``) and the
readers of what they give, on a hand-made trace whose device operations
and runtime calls hold ``correlation`` pairs, and on small cells run on
the CPU."""

import gzip
import json
import os
import types

import pytest

from benchmark import harness, spans
from benchmark.timeline import Timeline, load
from pykrylov_tpu_torch.utils import observe
from smallcells import small

BASE = 10 ** 18          # the trace's baseTimeNanoseconds
NEW = ("host_ms_per_iter", "issue_idle_ms_per_iter",
       "read_idle_ms_per_iter", "host_syncs_per_iter", "launch_host_us",
       "build_fill_s")


def us(t):
    return BASE + int(t * 1000)


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def solve_record(t0, iters=2, sid=1000):
    """A kept solve of ``iters`` iterations from ``t0`` us, each 200 us:
    the iteration [10, 190], the product [12, 35] with its launch
    [20, 30], the dots [40, 60], the read [100, 180] (relative to the
    iteration's start - 10 us)."""
    out, top = [], sid
    nxt = iter(range(sid + 1, sid + 1000))
    for i in range(iters):
        a = t0 + 200 * i
        it = next(nxt)
        prod, lau, dots, rd = (next(nxt) for _ in range(4))
        out += [("launch.dia_spmv", lau, prod, top, us(a + 20), us(a + 30),
                 None),
                ("product", prod, it, top, us(a + 12), us(a + 35), None),
                ("dots", dots, it, top, us(a + 40), us(a + 60), None),
                ("read", rd, it, top, us(a + 100), us(a + 180), None),
                ("cg.iter", it, top, top, us(a + 10), us(a + 190), None)]
    out.append(("solve", top, 0, top, us(t0), us(t0 + 200 * iters),
                {"method": "auto", "K": 1}))
    rec = observe.Recording()
    rec.spans, rec.counts = out, {"host_syncs": iters + 1}
    return rec


def trace_events(iters=2):
    """Markers ending at 90 us and starting at 510 us; in iteration i (at
    100 + 200 i): the SpMV launched at 25 runs over [40, 100], a dot
    launched at 50 over [100, 120], the read's copy at [122, 126]."""
    out = [ev("kernel", "spin_kernel", 80, 10),
           ev("kernel", "spin_kernel", 510, 10)]
    for i in range(iters):
        a = 100 + 200 * i
        out += [ev("cuda_runtime", "cudaLaunchKernel", a + 25, 2, 10 + i),
                ev("kernel", "void dia_spmv_kernel<float>", a + 40, 60,
                   10 + i),
                ev("cuda_runtime", "cudaLaunchKernel", a + 50, 2, 20 + i),
                ev("kernel", "dot_kernel", a + 100, 20, 20 + i),
                ev("cuda_runtime", "cudaMemcpyAsync", a + 105, 70, 30 + i),
                ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", a + 122,
                   4, 30 + i)]
    return out


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """A run whose trace file holds ``trace_events`` and whose program
    kept a build, the window's solve and a solve after the window."""
    build = observe.Recording()
    build.spans = [("build.container", 1, 0, 0, 0, 10 ** 9, None),
                   ("build.fill", 2, 0, 0, 10 ** 9, 3 * 10 ** 9, None)]
    kept = [build, solve_record(100), solve_record(600, sid=5000)]
    fake = types.SimpleNamespace(kept=lambda: kept, SOLVE=observe.SOLVE,
                                 chrome_events=observe.chrome_events)
    monkeypatch.setattr(spans, "observe", lambda: fake)
    path = str(tmp_path / "t.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"baseTimeNanoseconds": BASE,
                   "traceEvents": trace_events()}, f)
    run = harness.Run({"k": 1}, {})
    run.traced = {"iterations": 2, "timeline": Timeline(load(path)),
                  "launches": {"kernels.DIA_LAUNCHES": 2},
                  "trace_file": os.path.relpath(path, harness.ROOT)}
    return run, path


def test_readers_on_a_traced_window(traced):
    run, path = traced
    got = {m: harness.reader(m).read(run) for m in NEW}
    # iterations [110, 290] and [310, 490], reads 80 us each
    assert got["host_ms_per_iter"] == pytest.approx(1e-3 * 200 / 2)
    # gaps [90, 140] (mid in the product), [226, 340] (after the read, in
    # the iteration) are issue idle; [220, 222], [420, 422] and [426, 510]
    # (mid 468, in the second read) are read idle
    assert got["issue_idle_ms_per_iter"] == pytest.approx(
        1e-3 * (50 + 114) / 2)
    assert got["read_idle_ms_per_iter"] == pytest.approx(
        1e-3 * (2 + 2 + 84) / 2)
    assert got["host_syncs_per_iter"] == pytest.approx(3 / 2)
    assert got["launch_host_us"] == pytest.approx(10.0)
    assert got["build_fill_s"] == pytest.approx(2.0)
    s = spans.load(run)
    assert s.solves == 1 and len(s.spans) == 11
    assert s.products == s.products_in_launch == 2
    # a kernel starts 15 us after its launch at the least, the copy ends
    # 49 us before its call returns
    assert s.clock_us == [pytest.approx(-49), pytest.approx(15)]
    assert {k: round(v * 1e6, 6) for k, v in s.step_device_s.items()} == {
        "product": 120.0, "dots": 40.0, "read": 8.0}
    # the sum of the two idle readings is at most the window's idle
    tl = run.traced["timeline"]
    idle = 1e3 * (tl.window_s - tl.busy_s()) / 2
    assert got["issue_idle_ms_per_iter"] + got["read_idle_ms_per_iter"] \
        <= idle + 1e-12
    # the breakdown names the port's spans and the calls inside them
    labels = dict(tl.breakdown()["idle_gaps"])
    assert set(labels) == {"product", "cg.iter", "cudaMemcpyAsync"}
    # the trace file holds the merged spans at their place
    merged = [e for e in load(path) if e.get("cat") == "user_annotation"]
    assert len(merged) == 11
    first = min(merged, key=lambda e: e["ts"])
    assert first["name"] == "solve" and first["ts"] == pytest.approx(100)
    assert spans.load(run) is s     # worked out once


def test_a_launch_outside_its_span_is_not_matched(traced):
    run, _ = traced
    tl_events = trace_events()
    # the second SpMV's launch moved out of its launch span (to 355 us)
    for e in tl_events:
        if e.get("args", {}).get("correlation") == 11 \
                and e["cat"] == "cuda_runtime":
            e["ts"] = 355
    path = os.path.join(harness.ROOT, run.traced["trace_file"])
    with gzip.open(path, "wt") as f:
        json.dump({"baseTimeNanoseconds": BASE, "traceEvents": tl_events},
                  f)
    s = spans.load(run)
    assert (s.products, s.products_in_launch) == (2, 1)


@pytest.mark.parametrize("lack", ["recorder", "base"])
def test_nothing_to_read(traced, monkeypatch, lack):
    """A program without the recorder gives nothing and raises nothing; a
    trace without a base time gives only the build."""
    run, path = traced
    if lack == "recorder":
        monkeypatch.setattr(spans, "observe", lambda: None)
    else:
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": trace_events()}, f)
    got = {m: harness.reader(m).read(run) for m in NEW}
    want = {m: None for m in NEW}
    if lack == "base":
        want["build_fill_s"] = pytest.approx(2.0)
    assert got == want
    assert spans.load(harness.Run({"k": 1}, {})) is None


@pytest.mark.parametrize("name", ["poisson3d-n240.cg",
                                  "bus1138-x1024.cg-k8"])
def test_small_cells(name, tmp_path):
    """On the CPU the window has no markers: the build's fill is read, the
    window's numbers are not, and nothing raises."""
    cell, cfg = small(name, trace_solves=1)
    out = harness.run_cell(name, 2 ** 31 + 21, 0.2, True, 0.0,
                           device="cpu", cell=cell, cfg=cfg,
                           trace_dir=str(tmp_path))
    metrics = {m.split(".")[0] for m in out["metrics"]}
    assert "build_fill_s" in metrics
    assert out["metrics"]["build_fill_s"]["value"] > 0
    assert not metrics & set(NEW[:5])
