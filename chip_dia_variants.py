#!/usr/bin/env python3
"""Time variants of the DIA SpMM kernel against its source as built, on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_dia_variants.py

Each source variant is ``pykrylov_tpu_torch/csrc/dia_spmm.cu`` with one
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
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 240
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


def build_variant(build, subs, tag, tmp):
    """The SpMM library with ``subs`` applied."""
    with open(build.SOURCES["dia_spmm"]) as f:
        src = f.read()
    for a, b in subs:
        if src.count(a) != 1:
            raise AssertionError("%s: %r not once in dia_spmm.cu" % (tag, a))
        src = src.replace(a, b)
    path = os.path.join(tmp, tag.replace(" ", "_").replace("/", "_") + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    out = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                          path], check=True, capture_output=True, text=True)
    registers(tag, out.stdout + out.stderr)
    return ctypes.CDLL(lib)


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


def main():
    if not torch.cuda.is_available():
        print("chip_dia_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pykrylov_tpu_torch import _build
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = _build.build("dia_spmm")
    with open(lib + ".log") as f:
        registers("built", f.read())
    tmp = tempfile.mkdtemp()
    libs = {tag: build_variant(_build, sub, tag, tmp)
            for tag, sub in SOURCE_VARIANTS.items()}

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
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
