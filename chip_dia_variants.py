#!/usr/bin/env python3
"""Time variants of the DIA SpMM or SpMV kernel against its source as
built, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_dia_variants.py                 # the SpMM
    python3 chip_dia_variants.py --spmv          # the SpMV
    python3 chip_dia_variants.py --spmv --baseline OTHER.cu

**The SpMM.** Each source variant is ``pykrylov_tpu_torch/csrc/dia_spmm.cu`` with one
textual change, compiled with the same flags into a temporary directory
and called through ``ctypes`` under the wrapper's plan
(``kernels.dia_matmat_plan``).  Each panel variant is the wrapper itself
with ``kernels.L2_WINDOW_BYTES`` set so that its plan takes panels of Kc
columns.  Every variant's block is held bit for bit against the wrapper's,
on the 3-D Poisson matrix at n = 240 (13.8M rows, the DIA block path's
matrix) at K = 8, 16, 32 and 64.  Times are device times per call
(``chip_smoke.device_ms``: the host enqueues the calls behind a sleep
kernel), best of 3 runs in turns.  The source variants:

  * ``chunk 8``, ``chunk 2``: eight or two diagonals' loads issued ahead
    of their products, not four;
  * ``T/2``, ``2T``: tiles of half or twice the rows (``kRows``);
  * ``stream hints``: the diagonal values loaded and Y stored with the
    evict-first cache hints (``__ldcs``/``__stcs``).

The panel variants, at K = 32 and 64: ``Kc=K``, ``Kc=32``, ``Kc=16``
where they differ from the wrapper's plan.

It prints the card, the compiler's registers and spills (``-Xptxas -v``)
for every template instance of the built source and of each variant, the
wrapper's plan at each K, one line per K with each variant's ms, then
``{"ok": true}``; exits 2 without a card.

**The SpMV** (``--spmv``).  Each source variant is
``pykrylov_tpu_torch/csrc/dia_spmv.cu`` with its tuning constants
(``kTerms``, ``kTileGroups``, ``kPairRows``) set otherwise or with the
designs it leaves out patched in (``MV_PATCHES``: persistent blocks,
evict-first hints, ``__launch_bounds__`` asking two blocks an SM), each
distinct source built once, all at once, and called through ``ctypes`` under the wrapper's plan
(``kernels.dia_matvec_plan``) or that plan changed as the run says; every
run's y is held bit for bit against the wrapper's, on the 3-D Poisson
matrix at n = 240 (f32, bf16 and f64 storage; f32 and f64 x) and on the
2-D convection-diffusion matrix at n = 2048 and its ``dia_transpose``
(f32 storage, f32 and f64 x).  The runs (:func:`mv_runs`): the design's
steps one by one, then one change each beside the built source; with
``--grid`` every terms x persistent x hints x interior; with
``--baseline OTHER.cu`` that source, built the same way, whose entries
take ``(data, offsets, ndiag, x, y, m, n, stream)`` (a one-row-a-thread
kernel with no plan); ``--sass FILE`` writes the built library's
``cuobjdump -sass``.

It prints the card, every variant's registers and spills, the built
source's switches, each matrix and entry's plan and one line a run,
``[mv] matrix entry | run | ms | GB/s`` (the rate over the bytes a matvec
must move), then ``{"ok": true}``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 240
CD_N = 2048
CURVE_K = (8, 16, 32, 64)
PANEL_K = (32, 64)
ROWS = "constexpr int kRows = 256;"
SOURCE_VARIANTS = {
    "chunk 8": [("constexpr int kChunk = 4;", "constexpr int kChunk = 8;")],
    "chunk 2": [("constexpr int kChunk = 4;", "constexpr int kChunk = 2;")],
    "T/2": [(ROWS, "constexpr int kRows = 128;")],
    "2T": [(ROWS, "constexpr int kRows = 512;")],
    "stream hints": [("  return *p;\n", "  return __ldcs(p);\n"),
                     ("  *p = v;\n", """\
  if constexpr (sizeof(P) == 16) {
    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&v));
  } else if constexpr (sizeof(P) == 8) {
    __stcs(reinterpret_cast<float2*>(p), *reinterpret_cast<const float2*>(&v));
  } else {
    __stcs(reinterpret_cast<float*>(p), *reinterpret_cast<const float*>(&v));
  }
""")],
}


def registers(tag, report):
    """The compiler's register and spill lines, one per kernel."""
    name = None
    for line in report.splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            print("[regs] %s %s: %s" % (tag, name, line.strip()), flush=True)


def build_variants(build, name, variants, tmp, extra=()):
    """The library of source ``name`` with each variant's substitutions
    applied, and of each (tag, path) in ``extra`` as it is, all compiled
    at once: tag -> ctypes library."""
    with open(build.SOURCES[name]) as f:
        base = f.read()
    paths = {}
    for tag, subs in variants.items():
        src = base
        for a, b in subs:
            if src.count(a) != 1:
                raise AssertionError("%s: %r not once in %s.cu"
                                     % (tag, a, name))
            src = src.replace(a, b)
        path = os.path.join(tmp, "%s_%s.cu" % (
            name, tag.replace(" ", "_").replace("/", "_").replace(",", "")))
        with open(path, "w") as f:
            f.write(src)
        paths[tag] = path
    paths.update(extra)
    procs = {}
    for tag, path in paths.items():
        lib = os.path.join(tmp, "lib%d.so" % len(procs))
        procs[tag] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError("%s: nvcc failed:\n%s" % (tag, report))
        registers(tag, report)
        libs[tag] = ctypes.CDLL(lib)
    return libs


def caller(K, lib, data, offsets, plan):
    """``f(X)``: the f32 entry of ``lib`` under ``plan``."""
    fn = lib.dia_spmm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    offs = K._offsets_arg(tuple(offsets))

    def run(X):
        Y = torch.empty((data.shape[1], X.shape[1]), device=X.device)
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p),
                 len(offsets), plan.v, plan.kc, X.data_ptr(), Y.data_ptr(),
                 data.shape[1], X.shape[0], X.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("dia_spmm failed with CUDA error %d" % err)
        return Y
    return run


def panel(K, data, offsets, kc):
    """``f(X)``: the wrapper with its L2 budget set for panels of ``kc``
    columns."""
    reach = max(abs(int(o)) for o in offsets)

    def run(X):
        keep = K.L2_WINDOW_BYTES
        K.L2_WINDOW_BYTES = 2 * reach * kc * 4
        try:
            if K.dia_matmat_plan(data, offsets, X).kc != kc:
                raise AssertionError("no plan of Kc=%d" % kc)
            return K.dia_matmat(data, offsets, X)
        finally:
            K.L2_WINDOW_BYTES = keep
    return run


def spmm():
    import chip_smoke as cs
    from pykrylov_tpu_torch import _build
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K

    lib = _build.build("dia_spmm")
    with open(lib + ".log") as f:
        registers("built", f.read())
    tmp = tempfile.mkdtemp()
    libs = build_variants(_build, "dia_spmm", SOURCE_VARIANTS, tmp)

    coo = F.coo_from_arrays(*poisson3d_coo(N, dtype=np.float32), device=None)
    dia = F.dia_from_coo(coo, device="cuda")
    data, offsets = dia.data, dia.offsets
    m = data.shape[1]
    g = torch.Generator(device="cuda").manual_seed(4000)
    for kb in CURVE_K:
        X = torch.randn((m, kb), device="cuda", generator=g)
        plan = K.dia_matmat_plan(data, offsets, X)
        print("K=%d plan: V=%d T=%d Kc=%d" % (kb, plan.v, plan.rows, plan.kc),
              flush=True)
        runs = [("wrapper", lambda X: K.dia_matmat(data, offsets, X))]
        runs += [(tag, caller(K, lib, data, offsets, plan))
                 for tag, lib in libs.items()]
        if kb in PANEL_K:
            runs += [("Kc=%d" % kc, panel(K, data, offsets, kc))
                     for kc in sorted({kb, 32, 16} - {plan.kc}, reverse=True)]
        runs = [(tag, (lambda f: lambda: f(X))(f)) for tag, f in runs]
        ref = K.dia_matmat(data, offsets, X)
        for tag, fn in runs:
            if not torch.equal(fn(), ref):
                raise AssertionError("K=%d: %s differs from the wrapper's "
                                     "block" % (kb, tag))
        best = cs._best_ms(runs, 10)
        print("K=%d: %s" % (kb, ", ".join("%s %.4f ms" % kv
                                          for kv in best.items())),
              flush=True)
        del X, ref, runs


# the SpMV source's tuning constants: name -> the pattern of its line
MV_SWITCHES = {
    "terms": r"constexpr int kTerms = (\w+);",
    "tile groups": r"constexpr int kTileGroups = (\w+);",
    "pair rows": r"constexpr int kPairRows = (\w+);",
}
# designs the source leaves out, as textual patches of it
MV_PATCHES = {
    # one wave of resident blocks walking the tiles
    "persistent": [("  int64_t blocks = (m + kTileRows - 1) / kTileRows;  "
                    "// a block a tile\n", """\
  int64_t blocks = (m + kTileRows - 1) / kTileRows;
  int per_sm = 0;
  int device = 0;
  int sms = 1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > int64_t{sms} * per_sm) blocks = int64_t{sms} * per_sm;
""")],
    # evict-first loads of the diagonals and stores of y
    "hints": [("  return *p;\n", """\
  if constexpr (sizeof(P) == 16) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
    return *reinterpret_cast<const P*>(&w);
  } else if constexpr (sizeof(P) == 8) {
    const double w = __ldcs(reinterpret_cast<const double*>(p));
    return *reinterpret_cast<const P*>(&w);
  } else if constexpr (sizeof(P) == 4) {
    const float w = __ldcs(reinterpret_cast<const float*>(p));
    return *reinterpret_cast<const P*>(&w);
  } else {
    const unsigned short w =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
    return *reinterpret_cast<const P*>(&w);
  }
"""), ("  *p = v;\n", """\
  if constexpr (sizeof(P) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(P) / 16); ++q) {
      __stcs(reinterpret_cast<float4*>(p) + q,
             reinterpret_cast<const float4*>(&v)[q]);
    }
  } else if constexpr (sizeof(P) == 8) {
    __stcs(reinterpret_cast<double*>(p),
           *reinterpret_cast<const double*>(&v));
  } else {
    __stcs(reinterpret_cast<float*>(p), *reinterpret_cast<const float*>(&v));
  }
""")],
    # __launch_bounds__ asking two resident blocks an SM
    "min blocks 2": [("__launch_bounds__(kThreads)\n",
                      "__launch_bounds__(kThreads, 2)\n")],
}


def mv_switches(src):
    """The tuning constants a source holds, and every patch off."""
    out = {}
    for name, pattern in MV_SWITCHES.items():
        hits = re.findall(pattern, src)
        if len(hits) != 1:
            raise AssertionError("%s: %d lines in dia_spmv.cu"
                                 % (name, len(hits)))
        out[name] = int(hits[0])
    return dict(out, **{name: False for name in MV_PATCHES})


def mv_source(src, values):
    """``src`` with its constants set and its patches applied as
    ``values`` says."""
    for name, value in values.items():
        if name in MV_PATCHES:
            for a, b in MV_PATCHES[name] if value else ():
                if src.count(a) != 1:
                    raise AssertionError("%s: %r not once in dia_spmv.cu"
                                         % (name, a))
                src = src.replace(a, b)
        else:
            line = MV_SWITCHES[name].replace(r"(\w+)", str(value))
            src = re.sub(MV_SWITCHES[name], line, src)
    return src


def mv_runs(built, grid):
    """(run, switch values, interior, rows a thread) of each timed run.

    The design's steps, each with the steps before it that the built
    source keeps: ``1 groups`` (16-byte row groups, one diagonal's loads
    at a time, every term checked, a block a tile), ``2 terms T`` (the
    loads of T terms, T / R diagonals, issued before their products),
    ``3 interior`` (interior groups unchecked, at the built source's
    terms), ``4 persistent`` (one wave of blocks walking the tiles), ``5
    hints`` (evict-first diagonals and y); then one change each beside the
    built source: ``R=1`` (through the plan), ``terms T``, ``pair x at
    every R`` (x as two aligned vectors at R = 2 and 4 too), ``scalar
    x`` (x as R scalars at R = 8 too), ``2 groups a tile``, ``min blocks
    2``
    (``__launch_bounds__`` asking two resident blocks an SM); with
    ``grid``, every terms x persistent x hints x interior."""
    plain = dict(built, terms=1, persistent=False, hints=False)
    runs = [("1 groups", plain, False, None)]
    runs += [("2 terms %d" % t, dict(plain, terms=t), False, None)
             for t in (8, 16, 32)]
    step = dict(plain, terms=built["terms"])
    runs.append(("3 interior", step, True, None))
    runs.append(("4 persistent", dict(step, persistent=True), True, None))
    step = dict(step, persistent=built["persistent"])
    runs.append(("5 hints", dict(step, hints=True), True, None))
    runs.append(("R=1", built, True, 1))
    runs += [("terms %d" % t, dict(built, terms=t), True, None)
             for t in (4, 8, 16, 32) if t != built["terms"]]
    runs.append(("pair x at every R", dict(built, **{"pair rows": 2}), True,
                 None))
    runs.append(("scalar x", dict(built, **{"pair rows": 16}), True, None))
    runs.append(("2 groups a tile", dict(built, **{"tile groups": 2}), True,
                 None))
    runs.append(("min blocks 2", dict(built, **{"min blocks 2": True}), True,
                 None))
    if grid:
        runs += [("grid t%d %s %s %s" % (t, "pers" if p else "tile",
                                         "hints" if h else "plain",
                                         "int" if i else "chk"),
                  dict(built, terms=t, persistent=p, hints=h), i, None)
                 for t in (1, 8, 16, 32) for p in (False, True)
                 for h in (False, True) for i in (False, True)]
    return runs


def mv_caller(K, lib, entry, data, offsets, plan):
    """``f(x)``: ``entry`` of ``lib`` under ``plan``."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    offs = K._offsets_arg(tuple(offsets))

    def run(x):
        y = torch.empty(data.shape[1], dtype=x.dtype, device=x.device)
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p),
                 len(offsets), plan.r, plan.lo, plan.hi, x.data_ptr(),
                 y.data_ptr(), data.shape[1], x.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("%s failed with CUDA error %d" % (entry, err))
        return y
    return run


def baseline_caller(K, lib, entry, data, offsets):
    """``f(x)``: ``entry`` of a baseline library, which takes no plan."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    offs = K._offsets_arg(tuple(offsets))

    def run(x):
        y = torch.empty(data.shape[1], dtype=x.dtype, device=x.device)
        err = fn(data.data_ptr(), ctypes.cast(offs, ctypes.c_void_p),
                 len(offsets), x.data_ptr(), y.data_ptr(), data.shape[1],
                 x.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("baseline %s failed with CUDA error %d"
                               % (entry, err))
        return y
    return run


def spmv(baseline, grid, sass):
    import chip_smoke as cs
    from pykrylov_tpu_torch import _build
    from pykrylov_tpu_torch.gallery import convdiff2d_coo, poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K

    lib = _build.build("dia_spmv")
    with open(lib + ".log") as f:
        registers("built", f.read())
    if sass:
        out = subprocess.run([os.path.join(os.path.dirname(_build.find_nvcc()),
                                           "cuobjdump"), "-sass", lib],
                             capture_output=True, text=True, check=True)
        with open(sass, "w") as f:
            f.write(out.stdout)
    with open(_build.SOURCES["dia_spmv"]) as f:
        base = f.read()
    built = mv_switches(base)
    print("built source: %s" % built, flush=True)
    runs = mv_runs(built, grid)
    # one library a distinct source; the built source's is the wrapper's
    sources = {}
    for tag, values, _, _ in runs:
        src = mv_source(base, values)
        if src != base:
            sources.setdefault(src, "v%d" % len(sources))
    tmp = tempfile.mkdtemp()
    variants = {}
    for src, key in sources.items():
        path = os.path.join(tmp, key + ".cu")
        with open(path, "w") as f:
            f.write(src)
        variants[key] = path
    if baseline:
        variants["baseline"] = os.path.abspath(baseline)
    libs = build_variants(_build, "dia_spmv", {}, tmp, variants)
    libs["built"] = _build.load("dia_spmv")
    lib_of = {tag: "built" if mv_source(base, values) == base
              else sources[mv_source(base, values)]
              for tag, values, _, _ in runs}

    def container(coo):
        return F.dia_from_coo(F.coo_from_arrays(*coo, device=None),
                              device="cuda")

    g = torch.Generator(device="cuda").manual_seed(5000)
    poisson = container(poisson3d_coo(N, dtype=np.float32))
    cd = container(convdiff2d_coo(CD_N, wx=CD_N + 1.0, wy=(CD_N + 1) / 2.0,
                                  dtype=np.float32))
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    cases = (("Poisson n=%d" % N, poisson,
              ((f32, f32), (bf16, f32), (f32, f64), (f64, f64),
               (bf16, f64))),
             ("convdiff n=%d A" % CD_N, cd, ((f32, f32), (f32, f64))),
             ("convdiff n=%d A^T" % CD_N, K.dia_transpose(cd),
              ((f32, f32), (f32, f64))))
    for name, dia, entries in cases:
        for storage, xdt in entries:
            data, offsets = dia.data.to(storage), dia.offsets
            m, ndiag = data.shape[1], data.shape[0]
            x = torch.randn(m, device="cuda", generator=g).to(xdt)
            entry = K._ENTRY[(storage, xdt)]
            plan = K.dia_matvec_plan(data, offsets, x)
            label = "%s %s/%s" % (name, str(storage)[6:], str(xdt)[6:])
            print("%s plan: R=%d lo=%d hi=%d" % (label, *plan), flush=True)
            calls = [("wrapper", lambda x: K.dia_matvec(data, offsets, x))]
            for tag, _, interior, r in runs:
                p = plan if interior else plan._replace(lo=0, hi=0)
                if r is not None:
                    p = p._replace(r=r)
                calls.append((tag, mv_caller(K, libs[lib_of[tag]], entry,
                                             data, offsets, p)))
            if baseline:
                calls.append(("baseline", baseline_caller(
                    K, libs["baseline"], entry, data, offsets)))
            ref = K.dia_matvec(data, offsets, x)
            for tag, fn in calls:
                if not torch.equal(fn(x), ref):
                    raise AssertionError("%s: %s differs from the wrapper's "
                                         "y" % (label, tag))
            best = cs._best_ms([(tag, (lambda f: lambda: f(x))(fn))
                                for tag, fn in calls], 100)
            nbytes = (ndiag * data.element_size() + 2 * x.element_size()) * m
            for tag, _ in ([("baseline", None)] if baseline else []) + calls:
                if tag in best:
                    print("[mv] %s | %s | %.4f ms | %.1f GB/s"
                          % (label, tag, best[tag],
                             nbytes / best[tag] * 1e-6), flush=True)
                    del best[tag]
            del data, x, ref, calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--spmv", action="store_true",
                        help="the SpMV kernel's variants, not the SpMM's")
    parser.add_argument("--baseline", metavar="SRC",
                        help="with --spmv: a source timed beside them")
    parser.add_argument("--grid", action="store_true",
                        help="with --spmv: also every chunk x persistent x "
                        "hints x interior")
    parser.add_argument("--sass", metavar="FILE",
                        help="with --spmv: write the built library's SASS "
                        "(cuobjdump -sass) to FILE")
    args = parser.parse_args()
    if (args.baseline or args.grid or args.sass) and not args.spmv:
        parser.error("--baseline, --grid and --sass go with --spmv")
    if not torch.cuda.is_available():
        print("chip_dia_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.spmv:
        spmv(args.baseline, args.grid, args.sass)
    else:
        spmm()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
