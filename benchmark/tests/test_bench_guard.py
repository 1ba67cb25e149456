"""The whole-name check for JAX and the JAX package, and that no module of
the benchmark imports them, nor (in the yardstick) the port."""

import ast
import glob
import os
import sys
import types

import pytest

from conftest import ROOT
from benchmark import harness
from smallcells import small

BENCH = os.path.join(ROOT, "benchmark")
# the yardstick: generators, reference, roofline, trace reduction
YARDSTICK = ["reference.py", "roofline.py", "timeline.py", "configs/*.py"]


@pytest.mark.parametrize("names, found", [
    (["jax.numpy"], ["jax"]),
    (["pykrylov_tpu.sparse"], ["pykrylov_tpu"]),
    (["pykrylov_tpu"], ["pykrylov_tpu"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["pykrylov_tpu_torch", "pykrylov_tpu_torch.sparse"], []),
    (["jaxtyping", "numpy", "torch"], []),
])
def test_whole_names(names, found):
    assert harness.forbidden_modules(names) == found


def imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return {n.split(".")[0] for n in out}


def files(patterns):
    return sorted(f for p in patterns
                  for f in glob.glob(os.path.join(BENCH, p)))


def test_no_module_imports_jax():
    every = files(["*.py", "*/*.py"])
    assert len(every) > 10
    for path in every:
        assert not imports(path) & set(harness.FORBIDDEN), path


def test_yardstick_imports_nothing_of_the_port():
    for path in files(YARDSTICK):
        assert "pykrylov_tpu_torch" not in imports(path), path


def test_run_refuses_a_loaded_jax(monkeypatch):
    cell, cfg = small("poisson3d-n240.cg")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.BenchError, match="jax"):
        harness.run_cell("poisson3d-n240.cg", 1, 0.1, False, 0.0,
                         device="cpu", cell=cell, cfg=cfg)
