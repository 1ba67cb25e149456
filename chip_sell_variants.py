#!/usr/bin/env python3
"""Time variants of the SELL kernels against their sources as built, on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_sell_variants.py

Each variant is the source under ``pykrylov_tpu_torch/csrc/`` with one
textual change, compiled with the same flags into a temporary directory and
called through ``ctypes`` on the same card form and inputs; its output is
held bit for bit against the built kernel's.  Times are device times per
call (``chip_smoke.device_ms``: the host enqueues the calls behind a sleep
kernel), best of 3 runs in turns, on tiled 1138bus (the BELL path's matrix)
and the three ``bench.py`` classes for the SpMV, on tiled 1138bus at
K = 8-64 for the SpMM.  The variants:

  * SpMV ``chunk 4``: rows walked in chunks of four entries, not eight;
  * SpMV ``__ldg``: value and column streams loaded with ``__ldg`` instead
    of ``ld.global.nc.L1::no_allocate``;
  * SpMM ``no bound``: the two-accumulator shape (K = 33-64) without its
    ``__launch_bounds__(256, 8)``.

Prints one line per matrix and K, then ``{"ok": true}``; exits 2 without a
card.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def build_variant(build, name, subs, tag, tmp):
    """The library of source ``name`` with ``subs`` applied."""
    src = open(build.SOURCES[name]).read()
    for a, b in subs:
        if a not in src:
            raise AssertionError("%s: %r not in %s" % (tag, a, name))
        src = src.replace(a, b)
    path = os.path.join(tmp, tag + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(tmp, "lib%s.so" % tag)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


def caller(lib, name):
    """``f(card, x)`` through entry ``name`` of ``lib`` (f32)."""
    fn = getattr(lib, name)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = ([p] * 6 + [i64, p, i64]
                   + ([i64] if "spmm" in name else []) + [p])
    fn.restype = ctypes.c_int

    def run(card, x):
        y = torch.empty((card.rows_out,) + tuple(x.shape[1:]),
                        device=x.device)
        kc = (x.shape[1],) if x.ndim == 2 else ()
        err = fn(card.vals.data_ptr(), card.cols.data_ptr(),
                 card.slice_ptr.data_ptr(), card.row_len.data_ptr(),
                 card.row_idx.data_ptr(), x.data_ptr(), x.shape[0],
                 y.data_ptr(), card.rows_out, *kc,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("%s failed with CUDA error %d" % (name, err))
        return y
    return run


def compare(label, variants, ref, iters, best_ms):
    for name, fn in variants:
        if not torch.equal(fn(), ref):
            raise AssertionError("%s: %s differs from the built kernel"
                                 % (label, name))
    best = best_ms(variants, iters)
    print("%s: %s" % (label, ", ".join("%s %.5f ms" % kv
                                       for kv in best.items())), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_sell_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pykrylov_tpu_torch import _build
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.sparse import sell as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    tmp = tempfile.mkdtemp()
    chunk4 = caller(build_variant(
        _build, "sell_spmv",
        [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
        "chunk4", tmp), "sell_spmv_f32")
    ldg = caller(build_variant(
        _build, "sell_spmv",
        [("ld_stream(c + ", "__ldg(c + "), ("ld_stream(v + ", "__ldg(v + ")],
        "ldg", tmp), "sell_spmv_f32")
    nobound = caller(build_variant(
        _build, "sell_spmm",
        [("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads)")],
        "nobound", tmp), "sell_spmm_f32")

    cases = [("tiled_1138bus",
              tiled_general_coo("1138bus", tiles=1024, coupling=0))]
    cases += [(name, gen()) for name, gen in cs.CLASSES.items()]
    for name, t in cases:
        A = operator_from_coo(*t, symmetric=name == "tiled_1138bus")
        card = A.card
        x = torch.randn(t[3][1], device="cuda")
        compare("SpMV %s" % name,
                [("built", lambda: S.sell_matvec(card, x)),
                 ("chunk 4", lambda: chunk4(card, x)),
                 ("__ldg", lambda: ldg(card, x))],
                S.sell_matvec_plain(card, x), 100, cs._best_ms)
        if name == "tiled_1138bus":
            for kb in (8, 16, 32, 64):
                X = torch.randn(t[3][1], kb, device="cuda")
                compare("SpMM %s K=%d" % (name, kb),
                        [("built", lambda: S.sell_matmat(card, X)),
                         ("no bound", lambda: nobound(card, X))],
                        S.sell_matmat_plain(card, X), 20, cs._best_ms)
        del A, card
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
