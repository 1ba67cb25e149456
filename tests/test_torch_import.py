"""pykrylov_tpu_torch imports without JAX, and its kernel build fails with
a clear error where the CUDA toolkit is missing."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pykrylov_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in PACKAGE.rglob("*.py"))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import pykrylov_tpu_torch, pykrylov_tpu_torch._build\n"
        "import pykrylov_tpu_torch.sparse.kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pykrylov_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", SOURCES + ["chip_smoke.py"])
def test_source_does_not_import_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|pykrylov_tpu)\b", text,
                         re.MULTILINE)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from pykrylov_tpu_torch import _build
    monkeypatch.setattr(_build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    # an existing library for the current sources is reused, not rebuilt
    from pykrylov_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    lib = tmp_path / ("libpykrylov_cuda_%s.so" % _build._digest())
    lib.write_bytes(b"")
    monkeypatch.setattr(_build.shutil, "which", lambda *a, **k: None)
    assert _build.build() == str(lib)
