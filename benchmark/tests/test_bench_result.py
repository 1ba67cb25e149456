"""The shape of the result line, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from benchmark import harness
from smallcells import small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def check_line(out, trace):
    line = json.dumps(out, allow_nan=False)
    back = json.loads(line)
    keys = list(back)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert isinstance(back["correct"], bool)
    assert back["attempted"] >= 1 and back["failed"] >= 0
    dev = back["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(back["breakdown"][part]) <= 10
            for name, secs in back["breakdown"][part]:
                assert isinstance(name, str) and secs >= 0
    for name, m in back["metrics"].items():
        assert set(m) == {"value", "unit"}
    for name, c in back["checks"].items():
        assert set(c) == {"value", "limit"}
    return back


@pytest.mark.parametrize("name", ["poisson3d-n240.cg",
                                  "bus1138-x1024.cg-k8"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace, tmp_path):
    cell, cfg = small(name, trace_solves=1)
    out = harness.run_cell(name, 2 ** 31 + 11, 0.2, trace, 0.0,
                           device="cpu", cell=cell, cfg=cfg,
                           trace_dir=str(tmp_path))
    back = check_line(out, trace)
    assert back["correct"] is True and back["failed"] == 0
    # a metric split by the cells' pacing, by its base name
    metrics = {m.split(".")[0] for m in back["metrics"]}
    if trace:
        # on the CPU the device readers find nothing and say nothing
        assert {"build_s", "iters_per_solve"} <= metrics
        assert not metrics & {"vector_ms_per_iter", "device_idle_pct",
                              "spmv_roofline", "spmm_roofline"}
        assert len(os.listdir(tmp_path)) == 1
    else:
        assert {"rhs_per_s", "setup_s"} <= metrics
        assert ("solve_s_p95" in metrics) == (name == "poisson3d-n240.cg")


def test_same_seed_same_inputs():
    """One seed, the same inputs; another seed, the same right-hand sides
    (the same work) in another order and scale, and another probe."""
    name = "poisson3d-n240.cg"
    cell, cfg = small(name)
    a, b, c = (harness.Bench(cell, cfg, "cpu") for _ in range(3))
    for bench, seed in ((a, 5), (b, 5), (c, 2 ** 31 + 6)):
        bench.coo = harness.coo_of(cfg)
        bench.make_pool(seed, {})
    assert all(bool((x == y).all()) for x, y in zip(a.pool, b.pool))
    assert bool((a.probe == b.probe).all())
    assert not bool((a.probe == c.probe).all())
    assert any(not bool((x == y).all()) for x, y in zip(a.pool, c.pool))

    def unit(v):   # a power-of-two scale leaves the mantissas alone
        m, _ = torch.frexp(v / v.abs().max())
        return m

    assert sorted(unit(x)[0].item() for x in a.pool) == sorted(
        unit(x)[0].item() for x in c.pool)


def test_no_card_no_result():
    """run.py without a CUDA card: non-zero exit, no result line (skips on
    a machine that has one)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "poisson3d-n240.cg", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: non-zero exit, no result line."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "poisson3d-n240.cg", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
