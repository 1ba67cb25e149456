"""The port's native host pipeline (``pykrylov_tpu_torch.native``).

Each C++ entry is held array for array against the port's NumPy path and
against the JAX package's ``pykrylov_tpu.native`` (its NumPy path where
its library is unavailable), and each caller (the MatrixMarket reader,
the ELL and DIA fills, the BELL packer at windows 1 and 2 and the window
policy) with the library in use and bypassed in-process.  The library is
compiled by ``g++`` at first use; without ``g++`` the tests skip.
"""

import ctypes
import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pykrylov_tpu import native as jnative
from pykrylov_tpu.io import matrix_market as jmm
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF

from pykrylov_tpu_torch import convert, native
from pykrylov_tpu_torch.gallery import poisson3d_coo, tiled_general_coo
from pykrylov_tpu_torch.io import matrix_market as tmm
from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import formats as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native library is compiled from "
                    "native/native.cpp at first use")
    assert native.available()


@pytest.fixture
def bypass(monkeypatch):
    """Bypass the port's library in this process: every entry returns
    None and the callers take their NumPy paths."""
    def off():
        monkeypatch.setattr(native, "_lib", "bypassed in the test")
        assert not native.available()
    return off


def _jax_native(monkeypatch, on):
    """The JAX package's library on (when it builds) or bypassed."""
    if not on:
        monkeypatch.setattr(jnative, "available", lambda: False)
    return on and jnative.available()


def _same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype, msg)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _same_bell(port, ref):
    """A port BELL (NumPy arrays) against a JAX or a port one, field for
    field, as tensors (a JAX one through the port's conversion)."""
    a = TB.bell_to_device(port, DEV)
    b = (TB.bell_to_device(ref, DEV) if isinstance(ref, TB.BELL)
         else convert.from_numpy(ref, device=DEV))
    for name in TB.BELL._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
        elif isinstance(y, (tuple, int, str)):
            assert x == y, (name, x, y)
        else:
            _same(x.numpy(), y.numpy(), name)


# --- tests/test_native.py, on the port ---------------------------------


def test_mm_parse_matches_numpy(tmp_path, rng, bypass):
    m, n, nnz = 37, 23, 140
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    path = tmp_path / "t.mtx"
    tmm.write_matrix_market(path, vals, rows, cols, (m, n))
    v2, r2, c2, shape, field, symmetry = native.mm_parse_native(str(path))
    assert shape == (m, n) and field == "real" and symmetry == "general"
    bypass()
    v1, r1, c1, shape1, info = tmm.read_matrix_market(
        str(path), expand_symmetric=False)
    # entry order preserved from the file
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(v1, v2)


def test_mm_parse_symmetric_flag(tmp_path):
    path = tmp_path / "s.mtx"
    tmm.write_matrix_market(path, [2.0, -1.0], [0, 1], [0, 0], (2, 2),
                            symmetry="symmetric")
    out = native.mm_parse_native(str(path))
    assert out[5] == "symmetric"
    assert len(out[0]) == 2  # not expanded, as the NumPy parser's raw


def test_mm_parse_bundled_1138bus_end_to_end(tmp_path):
    vals, rows, cols, shape = load_bundled("1138bus")
    low = rows >= cols
    path = tmp_path / "1138bus.mtx"
    tmm.write_matrix_market(path, vals[low], rows[low], cols[low], shape,
                            symmetry="symmetric")
    v, r, c, shape2, info = tmm.read_matrix_market(path)
    assert shape2 == (1138, 1138) and info.nnz_stored == 2596
    # expanded symmetric: 1138 diagonal + 1458 off-diagonal pairs
    assert len(v) == 2 * 2596 - 1138


def test_ell_fill_matches_fallback(rng):
    m, nnz = 50, 300
    keys = np.unique(np.sort(rng.integers(0, m, nnz)) * m
                     + rng.integers(0, m, nnz))
    rows, cols = keys // m, keys % m
    vals = rng.standard_normal(len(keys))
    K = int(np.bincount(rows, minlength=m).max())
    ed, ec = native.ell_fill_native(rows, cols, vals, m, K)
    dense = np.zeros((m, m))
    np.add.at(dense, (np.repeat(np.arange(m), K), ec.ravel()), ed.ravel())
    ref = np.zeros((m, m))
    ref[rows, cols] = vals
    np.testing.assert_array_equal(dense, ref)


def test_dia_fill_matches_fallback(rng):
    m = 64
    offs = np.array([-5, -1, 0, 3], dtype=np.int64)
    idx = [np.arange(max(0, -o), min(m, m - o)) for o in offs]
    rows = np.concatenate(idx)
    cols = np.concatenate([i + o for i, o in zip(idx, offs)])
    vals = rng.standard_normal(len(rows))
    data = native.dia_fill_native(rows, cols, vals, m, offs)
    ref = np.zeros((len(offs), m))
    ref[np.searchsorted(offs, cols - rows), rows] = vals
    np.testing.assert_array_equal(data, ref)


def test_row_counts(rng):
    rows = rng.integers(0, 20, 500)
    _same(native.row_counts_native(rows, 20),
          np.bincount(rows, minlength=20))


def test_bell_plan_native_matches_python():
    rng = np.random.default_rng(7)
    m = 2048
    rows = np.sort(rng.integers(0, m, size=12000))
    cols = rng.integers(0, m, size=12000)
    order = np.lexsort((cols, rows))
    rs, cs = rows[order], cols[order]
    nblocks = -(-m // 128)
    bounds = np.searchsorted(rs // 128, np.arange(nblocks + 1))
    for sc in (12.0, 40.0, None):
        nat = native.bell_plan_native(rs, cs, nblocks, sc)
        py = TB._plan_blocks_py(rs, cs, cs // 128, bounds, nblocks, sc)
        for a, b in zip(nat, py):
            _same(a, b, str(sc))


# --- every entry against the JAX package's -----------------------------


@pytest.mark.parametrize("jax_native", [True, False])
def test_entries_match_the_jax_package(jax_native, monkeypatch, tmp_path):
    jon = _jax_native(monkeypatch, jax_native)
    if jax_native and not jon:
        pytest.skip("the JAX package's native library does not build")
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=4,
                                                dtype=np.float64)
    m = shape[0]
    low = rows >= cols
    path = tmp_path / "a.mtx"
    tmm.write_matrix_market(path, vals[low], rows[low], cols[low], shape,
                            symmetry="symmetric")
    mine = native.mm_parse_native(str(path))
    if jon:
        ref = jnative.mm_parse_native(str(path))
    else:   # the JAX NumPy parser's raw triples
        v, r, c, sh, info = jmm.read_matrix_market(str(path),
                                                   expand_symmetric=False)
        ref = (v, r.astype(np.int32), c.astype(np.int32), sh, info.field,
               info.symmetry)
    for a, b in zip(mine[:3], ref[:3]):
        _same(a, b)
    assert mine[3:] == ref[3:]

    order = np.lexsort((cols, rows))
    rs, cs, vs = rows[order], cols[order], vals[order]
    K = int(np.bincount(rs, minlength=m).max())
    jell = JF.ell_from_coo(JF.coo_from_arrays(vs, rs, cs, shape,
                                              device=False),
                           assume_sorted=True, device=False)
    for a, b in zip(native.ell_fill_native(rs, cs, vs, m, K),
                    (jell.data, jell.cols)):
        _same(a, b)
    pv, pr, pc, pshape = poisson3d_coo(8)
    jdia = JF.dia_from_coo(JF.coo_from_arrays(pv, pr, pc, pshape,
                                              device=False), device=False)
    _same(native.dia_fill_native(pr, pc, pv, pshape[0],
                                 np.unique(pc - pr)), jdia.data)
    counts = (jnative.row_counts_native(rows, m) if jon
              else np.bincount(rows, minlength=m))
    _same(native.row_counts_native(rows, m), counts)

    nblocks = -(-m // 128)
    bounds = np.searchsorted(rs // 128, np.arange(nblocks + 1))
    for sc in (12.0, None):
        ref = (jnative.bell_plan_native(rs, cs, nblocks, sc) if jon
               else JB._plan_blocks_py(rs, cs, cs // 128, bounds, nblocks,
                                       sc))
        for a, b in zip(native.bell_plan_native(rs, cs, nblocks, sc), ref):
            _same(a, b)
        mine = native.bell_sort_plan_w1_native(rows, cols, nblocks, sc)
        if jon:
            ref = jnative.bell_sort_plan_w1_native(rows, cols, nblocks, sc)
        else:   # the NumPy planner's arrays, ordinals from its groups
            o = np.lexsort((cols, rows, cols // 128, rows // 128))
            r2, c2 = rows[o], cols[o]
            _, woff, cap, dpb, gfirst = JB._plan_bands_sorted(
                r2, c2 // 128, r2 // 128, nblocks, sc)
            k = np.arange(len(r2)) - np.repeat(
                gfirst, np.diff(np.r_[gfirst, len(r2)]))
            ref = (o, r2, c2, woff, cap, k, dpb)
        for a, b in zip(mine, ref):
            _same(a, b)


# --- the callers, with the library and bypassed ------------------------


def test_reader_with_and_without_the_library(tmp_path, bypass):
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=4,
                                                dtype=np.float64)
    cases = {}
    for sym in ("general", "symmetric", "skew-symmetric"):
        keep = rows >= cols if sym != "general" else slice(None)
        if sym == "skew-symmetric":
            keep = rows > cols
        p = tmp_path / ("%s.mtx" % sym)
        tmm.write_matrix_market(p, vals[keep], rows[keep], cols[keep],
                                shape, symmetry=sym)
        cases[sym] = p
    p = tmp_path / "c.mtx"
    tmm.write_matrix_market(p, vals[:500] * (1 + 2j), rows[:500],
                            cols[:500], shape, symmetry="hermitian")
    cases["hermitian"] = p
    p = tmp_path / "pattern.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n"
                "3 3 3\n1 1\n2 3\n3 2\n")
    cases["pattern"] = p

    def read_all():
        return {k: tmm.read_matrix_market(p) for k, p in cases.items()}

    with_lib = read_all()
    bypass()
    without = read_all()
    for k, p in cases.items():
        ref = jmm.read_matrix_market(str(p))
        for got in (with_lib[k], without[k]):
            for a, b in zip(got[:3], ref[:3]):
                _same(a, b, k)
            assert got[3] == ref[3]
            assert got[4] == without[k][4]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fills_with_and_without_the_library(dtype, bypass, rng):
    vals, rows, cols, shape = poisson3d_coo(10, dtype=dtype)
    # a perturbed duplicate of 100 entries: both fills add them
    dup = rng.integers(0, len(vals), 100)
    t = (np.concatenate([vals, (vals[dup] * 0.3).astype(dtype)]),
         np.concatenate([rows, rows[dup]]),
         np.concatenate([cols, cols[dup]]), shape)
    coo = TF.coo_from_arrays(*t, device=None)
    jcoo = JF.coo_from_arrays(*t, device=False)
    ell_dia = (TF.ell_from_coo(coo, device=DEV),
               TF.dia_from_coo(coo, device=DEV))
    bypass()
    ell_dia_np = (TF.ell_from_coo(coo, device=DEV),
                  TF.dia_from_coo(coo, device=DEV))
    refs = (convert.from_numpy(JF.ell_from_coo(jcoo, device=False), DEV),
            convert.from_numpy(JF.dia_from_coo(jcoo, device=False), DEV))
    for a, b, r in zip(ell_dia, ell_dia_np, refs):
        for name in type(r)._fields:
            x, y, z = getattr(a, name), getattr(b, name), getattr(r, name)
            if name in ("shape", "offsets"):
                assert x == y == z
            else:
                _same(x.numpy(), y.numpy(), name)
                _same(x.numpy(), z.numpy(), name)


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("spill_cost", [12.0, None])
def test_bell_from_coo_with_and_without_the_library(window, spill_cost,
                                                    monkeypatch, bypass):
    t = tiled_general_coo("1138bus", tiles=16, dtype=np.float64)
    coo = TF.coo_from_arrays(*t, device=None, sort=False)
    kw = dict(window=window, spill_cost=spill_cost, segment=True)
    with_lib = TB.bell_from_coo(coo, device=None, **kw)
    _jax_native(monkeypatch, False)
    ref = JB.bell_from_coo(JF.coo_from_arrays(*t, device=False),
                           device=False, **kw)
    bypass()
    without = TB.bell_from_coo(coo, device=None, **kw)
    _same_bell(with_lib, ref)
    _same_bell(without, ref)


@pytest.mark.parametrize("base,tiles", [("1138bus", 16),
                                        ("jpwh_991", 20)])
def test_window_policy_with_and_without_the_library(base, tiles,
                                                    monkeypatch, bypass):
    # below 100,000 nonzeros (1138bus x 16: 64,864) both window modes are
    # planned either way; above it (jpwh_991 x 20: 120,540) window 2 only
    # with the library, as in the JAX package
    t = tiled_general_coo(base, tiles=tiles, dtype=np.float64)
    coo = TF.coo_from_arrays(*t, device=None, sort=False)
    jcoo = JF.coo_from_arrays(*t, device=False)
    big = len(t[0]) >= 100_000
    planned = []
    pack = TB._pack_levels

    def spy(c, nb_max, sc, levels, device="cuda", window=2):
        planned.append(window)
        return pack(c, nb_max, sc, levels, device=device, window=window)

    monkeypatch.setattr(TB, "_pack_levels", spy)
    out = {}
    for lib in (True, False):
        if not lib:
            bypass()
        del planned[:]
        out[lib] = TB._pack_window_auto(coo, TB.NB_MAX, TB._SPILL_BYTES, 2,
                                        device=None)
        assert planned == ([1, 2] if lib or not big else [1])
        ref = JB._pack_window_auto(jcoo, JB.NB_MAX, JB._SPILL_BYTES, 2,
                                   device=False) \
            if _jax_native(monkeypatch, lib) or not lib else None
        if ref is not None:
            assert len(out[lib]) == len(ref)
            for p, r in zip(out[lib], ref):
                _same_bell(p, r)
    # window 1 wins on these matrices, so both give the same levels
    assert [b.window for b in out[True]] == [b.window for b in out[False]]
    for p, r in zip(out[True], out[False]):
        _same_bell(p, r)


# --- the None contracts and the errors ---------------------------------


def test_entries_return_none_outside_their_interface(tmp_path):
    rows = np.array([0, 1, 2 ** 31])
    cols = np.array([0, 1, 2])
    f64 = np.ones(3)
    assert native.ell_fill_native(rows[:2], cols[:2],
                                  f64[:2].astype(np.float32), 2, 1) is None
    assert native.dia_fill_native(rows[:2], cols[:2],
                                  f64[:2].astype(np.float32), 2,
                                  [0]) is None
    assert native.ell_fill_native(rows, cols, f64, 3, 1) is None
    assert native.dia_fill_native(rows, cols, f64, 3, [0]) is None
    assert native.ell_fill_native(rows[:2], cols[:2], f64[:2], 2 ** 31,
                                  1) is None
    assert native.row_counts_native(rows, 3) is None
    assert native.bell_sort_plan_w1_native(rows, cols, 1, None) is None
    path = tmp_path / "a.mtx.gz"
    with gzip.open(path, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                "2 2 1\n1 1 3.0\n")
    assert native.mm_parse_native(str(path)) is None
    v, r, c, shape, info = tmm.read_matrix_market(path)   # NumPy reads it
    assert shape == (2, 2) and v.tolist() == [3.0]
    arr = tmp_path / "b.mtx"
    arr.write_text("%%MatrixMarket matrix array real general\n"
                   "2 1\n1.5\n2.5\n")
    assert native.mm_parse_native(str(arr)) is None
    assert tmm.read_matrix_market(arr)[0].tolist() == [1.5, 2.5]


def test_entries_raise_on_bad_input(tmp_path):
    rows, cols, vals = np.array([0, 0, 1]), np.array([0, 1, 1]), np.ones(3)
    with pytest.raises(ValueError, match="ELL slots"):
        native.ell_fill_native(rows, cols, vals, 2, 1)
    with pytest.raises(ValueError, match="missing from offsets"):
        native.dia_fill_native(rows, cols, vals, 2, np.array([0]))
    bad = tmp_path / "short.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 3\n1 1 1.0\n")
    with pytest.raises(IOError, match="expected 3 entries, got 1"):
        native.mm_parse_native(str(bad))
    # the reader lets the NumPy parser diagnose it, as the JAX reader does
    with pytest.raises(ValueError, match="expected 3 entries"):
        tmm.read_matrix_market(bad)


# --- the build ---------------------------------------------------------


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    code = ("import sys\n"
            "from pykrylov_tpu_torch import _build, native\n"
            "_build.BUILD_DIR = sys.argv[1]\n"
            "assert native.available()\n"
            "print(native.library_path())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    paths = set()
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0
        paths.add(out.strip())
    files = sorted(os.listdir(tmp_path))
    assert len(paths) == 1 and files == [os.path.basename(paths.pop())]
    lib = ctypes.CDLL(str(tmp_path / files[0]))
    assert lib.bell_sort_plan_w1


def test_a_failed_build_says_why_and_is_not_retried(tmp_path, monkeypatch):
    src = tmp_path / "native.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native._build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native._load()
    runs = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: runs.append(a))
    assert not native.available()
    with pytest.raises(RuntimeError, match="native.cpp"):
        native._load()
    assert runs == [] and not os.listdir(tmp_path / "b")
