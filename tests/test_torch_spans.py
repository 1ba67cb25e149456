"""The port's spans and counters (``utils/observe.py``) on the CPU: off,
they record nothing and never enter the profiler's ``record_function``;
on, they nest, carry the front door's solve id, count one iteration span
per iteration and one ``host_syncs`` per host read, leave the answers bit
for bit as they were, and merge into a ``trace()`` file on its clock."""

import json

import pytest
import torch

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery.poisson import poisson3d_coo
from pykrylov_tpu_torch.solvers import cg, cg_batched
from pykrylov_tpu_torch.sparse import linop, operator_from_coo
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.utils import observe

DEV = "cpu"  # the port's entry points default to the card
NAME, SID, PARENT, SOLVE, START, END, ATTRS = range(7)


@pytest.fixture(scope="module")
def system():
    vals, rows, cols, shape = poisson3d_coo(8)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          fmt="cuda-dia", device=DEV)
    g = torch.Generator().manual_seed(3)
    B = torch.randn(shape[0], 3, generator=g, dtype=torch.float64)
    return A, B


# name: (call, its iteration span)
RUNS = {
    "cg": (lambda A, B: cg(A, B[:, 0]), "cg.iter"),
    "cg-curvature": (lambda A, B: cg(A, B[:, 0], check_curvature=True),
                     "cg.iter"),
    "cg-verified": (lambda A, B: cg(A, B[:, 0], replace_every=10),
                    "cg.iter"),
    "cg-capped": (lambda A, B: cg(A, B[:, 0], maxiter=7), "cg.iter"),
    "cg_batched": (lambda A, B: cg_batched(A, B), "cg_batched.iter"),
    "cg_batched-capped": (lambda A, B: cg_batched(A, B, maxiter=7),
                          "cg_batched.iter"),
    "solve": (lambda A, B: pt.solve(A, B[:, 0]), "cg.iter"),
    "solve-block": (lambda A, B: pt.solve(A, B), "cg_batched.iter"),
}


def _reads(name, res):
    """The host reads each route makes: the loop's tests (one before the
    loop and one an iteration; a block polls no more once its cap is
    reached), a replacement's one more, and the front door's dispatch
    read."""
    n = int(res.n_iter)
    if name == "cg-verified":
        return 1 + n + int(res.info["n_replacements"])
    if name == "cg_batched-capped":
        return n
    return n + 1 + (name == "solve")


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_off_records_nothing(system, monkeypatch):
    A, B = system
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    before = len(observe.kept())
    assert observe.span("a") is observe.span("b", k=1)
    assert observe.solving(method="cg", K=1) is observe.span("c")
    for call, _ in RUNS.values():
        call(A, B)
    with observe.annotate("alone"):
        pass
    assert len(observe.kept()) == before
    assert observe._stack == [0] and observe._solve == 0


def test_nesting_and_solve_ids():
    with observe.recording() as rec:
        with observe.span("before"):
            pass
        with observe.solving(method="cg", K=2):
            with observe.span("a", x=1):
                with observe.span("b"):
                    pass
                with observe.solving(method="inner", K=1):
                    with observe.span("c"):
                        pass
        with observe.span("after"):
            pass
    got = {s[NAME]: s for s in rec.spans if s[NAME] != observe.SOLVE}
    solves = [s for s in rec.spans if s[NAME] == observe.SOLVE]
    outer = [s for s in solves if s[PARENT] == 0]
    assert len(solves) == 2 and len(outer) == 1
    outer = outer[0]
    assert outer[ATTRS] == {"method": "cg", "K": 2}
    assert got["a"][PARENT] == outer[SID] and got["a"][ATTRS] == {"x": 1}
    assert got["b"][PARENT] == got["a"][SID] and got["b"][ATTRS] is None
    inner = [s for s in solves if s[PARENT] == got["a"][SID]][0]
    assert got["c"][PARENT] == inner[SID]
    for name in ("a", "b", "c"):
        assert got[name][SOLVE] == outer[SID]
    assert inner[SOLVE] == outer[SID]
    assert got["before"][SOLVE] == got["after"][SOLVE] == 0
    assert [s[NAME] for s in rec.spans] == [
        "before", "b", "c", "solve", "a", "solve", "after"]
    for s in rec.spans:
        assert s[START] <= s[END]
    assert got["a"][START] <= got["b"][START] <= got["b"][END] \
        <= got["a"][END]


@pytest.mark.parametrize("name", list(RUNS))
def test_iterations_and_reads(system, name):
    A, B = system
    call, it = RUNS[name]
    with observe.recording() as rec:
        res = call(A, B)
    n = int(res.n_iter)
    assert n == 7 if name.endswith("capped") else n > 7
    iters = [s for s in rec.spans if s[NAME] == it]
    assert len(iters) == n
    reads = [s for s in rec.spans if s[NAME] == "read"]
    assert rec.counts["host_syncs"] == len(reads) == _reads(name, res)
    ids = {s[SID] for s in iters}
    steps = {s[NAME] for s in rec.spans if s[PARENT] in ids}
    want = {"product", "dots", "update", "direction", "read"}
    want |= {"select"} if it == "cg_batched.iter" else set()
    assert want <= steps
    top = [s for s in rec.spans if s[NAME] == observe.SOLVE]
    if name.startswith("solve"):
        assert len(top) == 1
        assert {s[SOLVE] for s in rec.spans} == {top[0][SID]}
        assert top[0][ATTRS] == {"method": "auto",
                                 "K": 3 if name == "solve-block" else 1}
    else:
        assert not top


@pytest.mark.parametrize("name", ["cg-curvature", "cg-verified",
                                  "cg_batched", "solve-block"])
def test_answers_unchanged(system, name):
    A, B = system
    call, _ = RUNS[name]
    off = call(A, B)
    with observe.recording():
        on = call(A, B)
    for k in ("x", "resid_norm", "n_iter", "istop", "converged"):
        assert torch.equal(getattr(off, k), getattr(on, k)), k


def test_solve_under_a_profiler_is_kept(system):
    A, B = system
    observe.kept(clear=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = pt.solve(A, B[:, 0])
    pt.solve(A, B[:, 1])     # the profiler is off: not kept
    kept = observe.kept()
    assert len(kept) == 1
    rec = kept[0]
    assert rec.counts == {"host_syncs": int(res.n_iter) + 2}
    assert sum(s[NAME] == "cg.iter" for s in rec.spans) == int(res.n_iter)
    assert rec.spans[-1][NAME] == observe.SOLVE


@pytest.mark.parametrize("fmt, spans", [
    ("cuda-dia", ["build.container", "build.fill", "build.to_card"]),
    ("ell", ["build.container", "build.fill"]),
    ("auto", ["build.container", "build.fill"]),
])
def test_build_is_kept(fmt, spans):
    vals, rows, cols, shape = poisson3d_coo(6)
    observe.kept(clear=True)
    operator_from_coo(vals, rows, cols, shape, symmetric=True, fmt=fmt,
                      device=DEV)
    (rec,) = observe.kept()
    assert [s[NAME] for s in rec.spans] == spans
    assert all(s[PARENT] == 0 and s[SOLVE] == 0 for s in rec.spans)


def test_bell_build_spans():
    from pykrylov_tpu_torch.gallery.general import tiled_general_coo
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=4,
                                                coupling=0)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    with observe.recording() as rec:
        op = linop._try_bell(coo, True, device=DEV)
    names = [s[NAME] for s in rec.spans if s[PARENT] == 0]
    assert op is not None
    assert names == ["build.fill", "build.to_card"]


def test_trace_merges_on_its_clock(system, tmp_path):
    A, B = system
    with observe.trace(tmp_path) as prof:
        with observe.annotate("outer"):
            res = pt.solve(A, B[:, 0])
    assert bool(res.converged)
    with open(prof.trace_file) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    events = data["traceEvents"]
    mine = {e["args"]["span"]: e for e in events
            if e.get("cat") == "user_annotation" and "span" in e.get(
                "args", {})}
    spans = prof.recording.spans
    # annotate's span is in the file once, from record_function
    assert sum(e.get("name") == "outer" for e in events) == 1
    assert set(mine) == {s[SID] for s in spans if s[NAME] != "outer"}
    for s in spans:
        if s[SID] in mine:
            e = mine[s[SID]]
            assert e["name"] == s[NAME]
            assert e["ts"] == pytest.approx((s[START] - base) / 1e3,
                                            abs=1e-3)
            assert e["dur"] == pytest.approx((s[END] - s[START]) / 1e3,
                                             abs=1e-3)
    # the profiler's own records of the solve's operators fall inside the
    # solve span, so both clocks agree
    (top,) = [e for e in mine.values() if e["name"] == observe.SOLVE]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("name") == "aten::addcmul"]
    assert len(ops) >= 2 * int(res.n_iter)
    slack = 50.0   # us
    for e in ops:
        assert top["ts"] - slack <= e["ts"]
        assert e["ts"] + e["dur"] <= top["ts"] + top["dur"] + slack


def test_count():
    with observe.recording() as rec:
        observe.count("test.things")
        observe.count("test.things", 4)
    with observe.recording() as again:
        observe.count("test.things")
    assert rec.counts == {"test.things": 5}
    assert again.counts == {"test.things": 1}
