"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and a file for every configuration, cell and metric."""

import json
import os
import re

import pytest

from conftest import ROOT
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("name, ok", [
    ("poisson3d-n240.cg", True), ("_x", True), ("rhs_per_s", True),
    ("a" * 64, True), ("a" * 65, False), ("-x", False), (".x", False),
    ("a b", False), ("a,b", False), ("a/b", False), ("µs", False),
    ("", False),
])
def test_name_rule(name, ok):
    assert bool(NAME.match(name)) == ok


@pytest.mark.parametrize("unit, ok", [
    ("rhs/s", True), ("%", True), ("launch/iter", True), ("GiB", True),
    ("tokens per second", False), ("µs", False), ("", False),
    ("a" * 17, False),
])
def test_unit_rule(unit, ok):
    assert bool(UNIT.match(unit)) == ok


def test_top_level_keys_and_size():
    spec = load()
    assert set(spec) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)


def test_command_and_paths():
    spec = load()
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    cmd = spec["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word == p or word.startswith(p + "/")
                       for p in spec["paths"])


def test_time_budget_fits_24_cells():
    r = load()["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    spec = load()
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    assert 1 <= len(spec["configs"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "configs", cfg["generator"] + ".py"))
        for key in ("rows", "nnz", "bytes_per_nnz", "value_dtype",
                    "symmetric"):
            assert key in cfg


def test_workloads():
    spec = load()
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    assert 1 <= len(spec["workloads"]) <= 24
    four = sum(1 for w in spec["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        path = os.path.join(ROOT, "benchmark", "workloads",
                            w["name"] + ".json")
        with open(path) as f:
            cell = json.load(f)
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                    w["traffic"])
        assert set(cell["limits"]) == {"product_err", "resid_max",
                                       "unconverged"}


def test_metrics():
    spec = load()
    cells = {w["name"] for w in spec["workloads"]}
    names = set()
    e2e = spec["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert os.path.exists(harness.reader_path(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"])
        mover = [e for e in e2e if e["name"] == m["moves"]]
        assert mover
        # every cell the metric lists reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(
            mover[0].get("workloads", cells))


def test_every_cell_reports_enough():
    spec = load()
    for w in spec["workloads"]:
        def reported(group):
            return [m["name"] for m in spec[group]
                    if w["name"] in m.get("workloads", [w["name"]])]
        e2e = reported("end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported("per_layer")
