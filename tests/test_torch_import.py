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
        "import pykrylov_tpu_torch.sparse.bell\n"
        "import pykrylov_tpu_torch.gallery.general\n"
        "import pykrylov_tpu_torch.ops.blkop, pykrylov_tpu_torch.ops.lbfgs\n"
        "import pykrylov_tpu_torch.ops.chebyshev\n"
        "import pykrylov_tpu_torch.ops.cholesky\n"
        "import pykrylov_tpu_torch.ops.complex_eq\n"
        "import pykrylov_tpu_torch.solvers.pipelined\n"
        "import pykrylov_tpu_torch.solvers.diff\n"
        "import pykrylov_tpu_torch.parallel\n"
        "import pykrylov_tpu_torch.parallel.bell_sharded\n"
        "import pykrylov_tpu_torch.utils.checkpoint\n"
        "import pykrylov_tpu_torch.utils.observe\n"
        "import pykrylov_tpu_torch.native\n"
        "import pykrylov_tpu_torch.examples.bmark\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pykrylov_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", SOURCES + ["chip_smoke.py",
                                            "chip_sell_variants.py"])
def test_source_does_not_import_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|pykrylov_tpu)\b", text,
                         re.MULTILINE)
    # nor the JAX package's native planner, under any spelling
    assert "pykrylov_tpu.native" not in text
    assert not re.search(r"^\s*from\s+\.+\s+import\s+native\b", text,
                         re.MULTILINE)


# The JAX package's Pallas-only names: the port's counterpart under
# another name, or None where ROADMAP.md lists the name as not ported (the
# kernels take the unpadded container, so there is no block to choose, pad
# or pack)
PALLAS_ONLY = {
    "pallas_dia_sparse_operator": "cuda_dia_sparse_operator",
    "pallas_dia_operator": "cuda_dia_operator",
    "dia_matvec_pallas": "dia_matvec",
    "dia_matvec_packed": "dia_matvec",
    "choose_block": None,
    "ensure_dia_padded": None,
    "pack_dia": None,
    "DEFAULT_BLOCK": None,
}


@pytest.mark.parametrize("module", ["ops", "solvers.diff",
                                    "solvers.pipelined", "parallel",
                                    "utils", "io", "solvers.show", "native",
                                    "", "solvers.common", "sparse.linop",
                                    "sparse.kernels"])
def test_public_names_match_the_jax_package(module):
    # every name of the JAX package's ops, diff, pipelined, parallel, utils,
    # io, show, native, solvers.common, sparse.linop and sparse.kernels
    # modules and of its package root has its counterpart under the same
    # name, or under PALLAS_ONLY's
    import importlib
    jax_mod = importlib.import_module(("pykrylov_tpu." + module).rstrip("."))
    port = importlib.import_module(("pykrylov_tpu_torch." + module)
                                   .rstrip("."))
    names = list(jax_mod.__all__) if module else [
        n for n in dir(jax_mod) if not n.startswith("_")
        and n not in ("annotations", "version")]
    missing = [n for n in names
               if not hasattr(port, PALLAS_ONLY.get(n) or n)
               and PALLAS_ONLY.get(n, n) is not None]
    assert not missing, missing
    roadmap = (REPO / "ROADMAP.md").read_text()
    start = roadmap.index("**Not ported.**")
    not_ported = roadmap[start:roadmap.index("\n- **", start)]
    for name in names:
        if name in PALLAS_ONLY and PALLAS_ONLY[name] is None:
            assert "`%s`" % name in not_ported, name


def test_operator_from_coo_takes_the_jax_options():
    # the JAX package's keyword arguments and defaults, plus the device
    import inspect
    from pykrylov_tpu.sparse import operator_from_coo as jax_version
    from pykrylov_tpu_torch.sparse import operator_from_coo
    jax_params = inspect.signature(jax_version).parameters
    params = inspect.signature(operator_from_coo).parameters
    assert list(params) == list(jax_params) + ["device"]
    for name, p in jax_params.items():
        assert params[name].default == p.default, name
    assert params["device"].default == "cuda"


def test_every_module_imports_without_jax():
    # each module of the package, imported on its own in one process
    mods = [p[:-3].replace("/", ".").replace(".__init__", "")
            for p in SOURCES]
    code = ("import sys, importlib\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pykrylov_tpu'))\n"
            "assert not bad, bad\n" % (mods,))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


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
    libs = {}
    for name in _build.SOURCES:
        libs[name] = str(tmp_path / ("lib%s_%s.so"
                                     % (name, _build._digest(name))))
        open(libs[name], "wb").close()
    monkeypatch.setattr(_build.shutil, "which", lambda *a, **k: None)
    assert _build.build() == libs
    assert _build.build("sell_spmv") == libs["sell_spmv"]


def _public_device_defaults():
    """(qualified name, default of ``device``) for every public function
    and class of the port that takes a ``device``."""
    import importlib
    import inspect
    import pykrylov_tpu_torch
    out = []
    for path in SOURCES:
        mod = importlib.import_module(path[:-3].replace("/", ".")
                                      .replace(".__init__", ""))
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name)
            if getattr(obj, "__module__", None) != mod.__name__:
                continue  # re-exported: checked where it is defined
            fn = obj.__init__ if inspect.isclass(obj) else obj
            if not callable(fn):
                continue
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                continue
            # a required ``device`` has no default to check
            if "device" in params and \
                    params["device"].default is not inspect.Parameter.empty:
                out.append(("%s.%s" % (mod.__name__, name),
                            params["device"].default))
    assert pykrylov_tpu_torch  # the package imported
    return out


def test_public_entry_points_default_to_the_card():
    found = _public_device_defaults()
    names = {n.rsplit(".", 1)[1] for n, _ in found}
    # the entry points named in the port's docs are among those checked
    assert {"operator_from_coo", "sparse_operator", "jacobi_preconditioner",
            "LinearOperator", "poisson3d_operator", "coo_from_arrays",
            "from_numpy", "bell_operator", "bell_from_coo", "make_mesh",
            "default_mesh", "initialize_multihost", "make_mesh2d"} <= names
    bad = [(n, d) for n, d in found if d != "cuda"]
    assert not bad, bad
    # nothing falls back to the CPU: without a card the default raises
    import torch
    from pykrylov_tpu_torch.gallery import poisson1d_coo
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.parallel import make_mesh, make_mesh2d
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            operator_from_coo(*poisson1d_coo(8))
        # a mesh on the card without one raises too
        for build in (make_mesh, lambda: make_mesh(4),
                      lambda: make_mesh2d(2, 2)):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()


def test_as_apply_pair_matches_the_jax_package():
    # (operator, apply, apply_T, apply_H) on a complex unsymmetric matrix,
    # the three products against the JAX package's
    import jax.numpy as jnp
    import numpy as np
    import torch
    from pykrylov_tpu.solvers.common import as_apply_pair as jax_pair
    from pykrylov_tpu_torch.solvers.common import as_apply_pair
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
    x = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    u = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    op, mv, rmv, hmv = as_apply_pair(torch.from_numpy(a))
    jop, jmv, jrmv, jhmv = jax_pair(jnp.asarray(a))
    assert op.shape == jop.shape == (5, 3)
    for port, ref in ((mv(op, torch.from_numpy(x)), jmv(jop, jnp.asarray(x))),
                      (rmv(op, torch.from_numpy(u)),
                       jrmv(jop, jnp.asarray(u))),
                      (hmv(op, torch.from_numpy(u)),
                       jhmv(jop, jnp.asarray(u)))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-13, atol=0)
