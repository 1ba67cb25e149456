"""The trace reduction on a hand-made timeline."""

import gzip
import json

import pytest

from benchmark import harness, timeline
from benchmark.timeline import HOST_IDLE, Timeline


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# markers end at 100 us and start at 200 us; kernels 110-130 (a product)
# and 125-140 (overlapping: busy 110-140), a copy 150-160, a kernel
# outside the window; the host in aten::dot over 139-151 and in nothing
# from 160 to 200
EVENTS = [
    {"ph": "M", "name": "process_name"},
    ev("kernel", "spin_kernel(long)", 90, 10),
    ev("kernel", "void dia_spmv_kernel<float>(...)", 110, 20),
    ev("kernel", "vectorized_elementwise_kernel", 125, 15),
    ev("gpu_memcpy", "Memcpy DtoH", 150, 10),
    ev("kernel", "spin_kernel(long)", 200, 10),
    ev("kernel", "outside", 300, 10),
    ev("cpu_op", "aten::dot", 139, 12),
    ev("cuda_runtime", "cudaLaunchKernel", 104, 2),
]


def test_busy_gaps_and_labels():
    tl = Timeline(EVENTS)
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy_s() == pytest.approx(40e-6)
    assert tl.gaps() == [pytest.approx((100e-6, 110e-6)),
                         pytest.approx((140e-6, 150e-6)),
                         pytest.approx((160e-6, 200e-6))]
    assert tl.gap_labels(tl.gaps()) == ["cudaLaunchKernel", "aten::dot",
                                        HOST_IDLE]
    bd = tl.breakdown()
    assert bd["device_ops"][0][0] == "void dia_spmv_kernel<float>(...)"
    assert bd["idle_gaps"][0] == [HOST_IDLE, pytest.approx(40e-6)]
    assert len(bd["device_ops"]) == 3


def test_readers_on_the_timeline(tmp_path):
    path = str(tmp_path / "t.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    run = harness.Run({"k": 1}, {})
    run.traced = {"iterations": 2, "timeline": Timeline(timeline.load(path)),
                  "launches": {"kernels.DIA_LAUNCHES": 2}}
    vector = harness.reader("vector_ms_per_iter").read(run)
    assert vector == pytest.approx(1e3 * 15e-6 / 2)
    assert harness.reader("device_idle_pct").read(run) == pytest.approx(60)
    assert harness.reader("launches_per_iter").read(run) == 1.0


def test_readers_find_nothing():
    run = harness.Run({"k": 1}, {})
    for m in ("vector_ms_per_iter", "device_idle_pct", "launches_per_iter",
              "spmv_roofline", "spmm_roofline", "rhs_per_s", "solve_s_p95",
              "peak_mem_gib", "iters_per_solve"):
        assert harness.reader(m).read(run) is None, m
    run.traced = {"iterations": 5, "timeline": Timeline([]), "launches": {}}
    assert harness.reader("vector_ms_per_iter").read(run) is None
    assert harness.reader("device_idle_pct").read(run) is None


def test_roofline_reader():
    run = harness.Run({"k": 1}, {"rows": 10 ** 6, "nnz": 7 * 10 ** 6,
                                 "bytes_per_nnz": 4})
    run.device_name = "NVIDIA H100 80GB HBM3"
    run.product_ms = 0.02
    bound = 1e3 * (28e6 + 8e6) / 3.35e12
    assert harness.reader("spmv_roofline").read(run) == pytest.approx(
        100 * bound / 0.02)
    assert harness.reader("spmm_roofline").read(run) is None
    run.cell = {"k": 8}
    assert harness.reader("spmv_roofline").read(run) is None


def test_p95_nearest_rank():
    run = harness.Run({"k": 1}, {})
    run.solves = [harness.Solve(float(s), 1, 1, 1) for s in range(1, 101)]
    assert harness.reader("solve_s_p95").read(run) == 95.0
    run.solves = run.solves[:10]
    assert harness.reader("solve_s_p95").read(run) == 10.0
