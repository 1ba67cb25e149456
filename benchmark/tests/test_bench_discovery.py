"""A configuration, a cell and a metric dropped in as new files, with
their entries in BENCHMARK.json, run without an edit to any file the
benchmark has."""

import json
import os
import shutil

from conftest import ROOT
from benchmark import harness

NEW_METRIC = '''"""Solves completed in the window."""


def read(run):
    return float(len(run.solves))
'''


def checkout(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "poisson3d-n240.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "workloads",
                           "poisson3d-n240.cg.json")) as f:
        cell = json.load(f)
    n = 10
    cfg.update(name="poisson3d-n10", n=n, rows=n ** 3,
               nnz=n ** 3 + 6 * n * n * (n - 1))
    cell.update(config="poisson3d-n10", pool=2)
    files = {"benchmark/configs/poisson3d-n10.json": json.dumps(cfg),
             "benchmark/workloads/poisson3d-n10.cg.json": json.dumps(cell),
             "benchmark/metrics/solves_done.py": NEW_METRIC}
    for rel, text in files.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    spec["configs"].append({"name": "poisson3d-n10", "source": "x",
                            "file": "benchmark/configs/poisson3d-n10.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "poisson3d-n10.cg",
                              "config": "poisson3d-n10", "traffic": "cg",
                              "chips": 1, "why": "x"})
    # the new cell reports the device-paced rate, under its bound
    for m in spec["end_to_end"]:
        if m["name"] == "rhs_per_s":
            m["workloads"].append("poisson3d-n10.cg")
    spec["per_layer"].append({"name": "solves_done", "unit": "solve",
                              "better": "higher", "source": "host_clock",
                              "layer": "front door and solvers",
                              "moves": "rhs_per_s",
                              "workloads": ["poisson3d-n10.cg"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def test_new_files_are_found(tmp_path):
    root = checkout(tmp_path)
    entry, cell, cfg = harness.find_cell("poisson3d-n10.cg", root)
    assert cfg["n"] == 10 and cell["config"] == "poisson3d-n10"
    names = [m for m, _ in harness.metric_names("poisson3d-n10.cg", True,
                                                root)]
    assert "solves_done" in names and "spmm_roofline" not in names
    assert "solves_done" not in [m for m, _ in harness.metric_names(
        "poisson3d-n240.cg", True, root)]
    out = harness.run_cell("poisson3d-n10.cg", 5, 0.2, True, 0.0,
                           device="cpu", root=root,
                           trace_dir=os.path.join(root, "traces"))
    assert out["correct"] is True
    assert out["metrics"]["solves_done"]["value"] >= 1
    out = harness.run_cell("poisson3d-n10.cg", 5, 0.2, False, 0.0,
                           device="cpu", root=root)
    # the end-to-end metrics without a workloads key are every cell's,
    # the others those of the cells they list
    assert {"rhs_per_s", "setup_s", "peak_mem_gib"} >= set(out["metrics"])
    assert {"rhs_per_s", "setup_s"} <= set(out["metrics"])


def test_scoped_metric_takes_its_base_reader(tmp_path):
    """``<base>.<scope>``, a metric split by the cells it is reported in,
    is read by ``metrics/<base>.py`` unless it has a file of its own."""
    root = checkout(tmp_path)
    metrics = os.path.join(root, "benchmark", "metrics")
    assert harness.reader_path("rhs_per_s.host_paced", root) == os.path.join(
        metrics, "rhs_per_s.py")
    assert harness.reader_path("solves_done.x", root) == os.path.join(
        metrics, "solves_done.py")
    with open(os.path.join(metrics, "solves_done.x.py"), "w") as f:
        f.write(NEW_METRIC)
    assert harness.reader_path("solves_done.x", root) == os.path.join(
        metrics, "solves_done.x.py")
