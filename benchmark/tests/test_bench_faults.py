"""A run with the port broken underneath the window comes out not
correct: a solve that returns its state unchanged, half of a block left
unsolved, an answer altered where it is produced (shifted by a row or a
column), a product altered, a solve that reports no convergence.  (One
chip: no exchange between chips to leave out.)  The run's own look for
a card is skipped: it runs on the CPU at a small size."""

import pytest

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import sparse
from benchmark import faults, harness
from smallcells import small

REAL_SOLVE = pt.solve
CELLS = ["poisson3d-n240.cg", "bus1138-x1024.cg-k8", "poisson3d-n240.cg-k8"]


def run(name, seed=2 ** 31 + 3):
    cell, cfg = small(name)
    return harness.run_cell(name, seed, 0.2, False, 0.0, device="cpu",
                            cell=cell, cfg=cfg)


CASES = [(n, f) for n in CELLS for f in sorted(faults.SOLVE_FAULTS)
         if faults.applies(f, small(n)[0]["k"])]


@pytest.mark.parametrize("name, fault", CASES)
def test_solve_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(pt, "solve", faults.SOLVE_FAULTS[fault](REAL_SOLVE))
    out = run(name)
    assert out["correct"] is False
    assert out["failed"] > 0
    rate = [v["value"] for m, v in out["metrics"].items()
            if m.split(".")[0] == "rhs_per_s"]
    assert len(rate) == 1 and rate[0] < out["attempted"] / 0.2


@pytest.mark.parametrize("name", CELLS)
def test_product_fault_is_not_correct(name, monkeypatch):
    real = sparse.operator_from_coo

    def built(*args, **kw):
        A = real(*args, **kw)
        apply = type(A)._apply

        def off(self, fn, x, n_in, n_out):
            return faults.off_by_row(apply(self, fn, x, n_in, n_out))

        monkeypatch.setattr(type(A), "_apply", off)
        return A

    monkeypatch.setattr(sparse, "operator_from_coo", built)
    out = run(name)
    assert out["correct"] is False
    assert out["checks"]["product_err"]["value"] > (
        out["checks"]["product_err"]["limit"])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert run(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_plants_each_fault(name):
    """``control.py --faults``: each fault the cell can have, planted
    under the window of one process's operator, reads not correct; a
    sound reading before them stays correct."""
    from benchmark import control
    cell, cfg = small(name)
    names = [f for f in faults.NAMES if faults.applies(f, cell["k"])]
    lines = control.readings(name, [11], [], 0.2, device="cpu", cell=cell,
                             cfg=cfg, emit=lambda s: None,
                             fault_names=names, fault_seeds=[2 ** 31 + 7])
    assert [r["fault"] for r in lines] == [None] + names
    assert [r["correct"] for r in lines] == [True] + [False] * len(names)
    assert pt.solve is REAL_SOLVE
