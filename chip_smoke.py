#!/usr/bin/env python3
"""Smoke test of pykrylov_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``pykrylov_tpu_torch/csrc``, holds
it against its plain torch version, then drives the port's main path once:
``solve(A, b)`` with CG on the 3-D Poisson matrix at n = 240 (13.8M rows,
96.4M nonzeros), whose operator the automatic format policy puts on the
CUDA DIA kernel.  Phases, in order:

  1. device: torch/CUDA versions, card name and power limit, TF32 off;
  2. build: the kernel library from source, and the compiler's report;
  3. kernel vs plain on the card, in f64, f32 and bf16 storage;
  4. the slice: a short warm-up solve at full size, then the timed
     ``solve(A, b)``, the kernel's launch count against the
     matvec count, the true residual in f64, and the same solve through
     the plain torch DIA operator;
  5. timing: one matvec at n = 240, kernel and plain, f32 and bf16
     storage;
  6. a JSON line naming the kernels, then the result line
     ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the result line.
Without a CUDA device, or without the package beside it, it exits 2.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 240  # bench.py's headline 3-D Poisson grid
DEVICE = "cuda"

# max|y_kernel - y_plain| / max|y_plain|: the kernel rounds each product
# and sum as the plain version does, in the same order, so both should
# agree to the last bit; the bounds leave room for rounding differences.
REL_BOUND = {torch.float64: 1e-12, torch.float32: 1e-6,
             torch.bfloat16: 1e-6}


def log(*args):
    print(*args, flush=True)


def relerr(y, ref):
    scale = ref.abs().max().item()
    return (y - ref).abs().max().item() / (scale if scale else 1.0)


def phase_device():
    log("[1 device] torch %s, CUDA %s, %d device(s)"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1 device] allow_tf32: matmul %s, cudnn %s"
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    return card


def phase_build(pt):
    from pykrylov_tpu_torch import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log("[2 build] %s in %.3f s" % (os.path.basename(lib),
                                    time.perf_counter() - t0))
    with open(lib + ".log") as f:
        for line in f.read().splitlines():
            if line.strip():
                log("[2 build] nvcc: " + line.strip())


def _dia_on_card(vals, rows, cols, shape):
    from pykrylov_tpu_torch.sparse import formats as F
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    return F.dia_from_coo(coo, device=DEVICE)


def _check(label, data, offsets, x, plain=None):
    from pykrylov_tpu_torch.sparse import kernels as K
    y = K.dia_matvec(data, offsets, x)
    torch.cuda.synchronize()
    ref = (K.dia_matvec_plain(data, offsets, x) if plain is None
           else plain())
    torch.cuda.synchronize()
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise AssertionError("%s: kernel gave %s %s, plain %s %s"
                             % (label, tuple(y.shape), y.dtype,
                                tuple(ref.shape), ref.dtype))
    if not torch.isfinite(y).all():
        raise AssertionError("%s: non-finite kernel output" % label)
    err = relerr(y, ref)
    bound = REL_BOUND[data.dtype]
    log("[3 kernel] %-34s rel err %.3e (bound %.0e), max abs err %.3e"
        % (label, err, bound, (y - ref).abs().max().item()))
    if not err <= bound:
        raise AssertionError("%s: relative error %.3e > %.0e"
                             % (label, err, bound))
    return (y - ref).abs().max().item()


def phase_kernel(pt):
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K

    rng = np.random.default_rng(1)
    for dtype in (torch.float64, torch.float32):
        nd = np.float64 if dtype == torch.float64 else np.float32
        dia = _dia_on_card(*poisson3d_coo(64, dtype=nd))
        x = torch.from_numpy(rng.standard_normal(dia.shape[1]).astype(nd))
        _check("poisson3d(64) %s" % str(dtype)[6:], dia.data, dia.offsets,
               x.to(DEVICE))
    dia = _dia_on_card(*poisson3d_coo(64, dtype=np.float32))
    d16 = dia.data.to(torch.bfloat16)
    x = torch.from_numpy(
        rng.standard_normal(dia.shape[1]).astype(np.float32)).to(DEVICE)
    _check("poisson3d(64) bf16 storage", d16, dia.offsets, x,
           plain=lambda: K.dia_matvec_plain(d16.float(), dia.offsets, x))

    # unsymmetric banded matrix with one far diagonal, and its transpose
    m = 100003
    offsets = (-70000, -3, 0, 2, 5, 131)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    for k, off in enumerate(offsets):
        i = np.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    dia = F.DIA(torch.from_numpy(data).to(DEVICE), offsets, (m, m))
    x = torch.from_numpy(
        rng.standard_normal(m).astype(np.float32)).to(DEVICE)
    _check("banded m=100003 A x", dia.data, dia.offsets, x)
    diat = K.dia_transpose(dia)
    _check("banded m=100003 A^T x", diat.data, diat.offsets, x,
           plain=lambda: F.dia_rmatvec(dia, x))

    # CG through the kernel on a small system: checks the solver on the
    # card and loads the library and torch kernels the slice's solve
    # uses, so that phase 4 times a warm solve
    A = K.cuda_dia_operator(_dia_on_card(*poisson3d_coo(64,
                                                         dtype=np.float32)),
                            symmetric=True)
    b = A * torch.ones(A.shape[0], device=DEVICE)
    res = pt.solve(A, b)
    log("[3 kernel] solve at n=64: converged=%s n_iter=%d"
        % (bool(res.converged), int(res.n_iter)))
    if not bool(res.converged):
        raise AssertionError("CG did not converge at n=64")


def phase_slice(pt):
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import operator_from_coo

    t0 = time.perf_counter()
    coo = poisson3d_coo(N, dtype=np.float32)
    A = operator_from_coo(*coo, symmetric=True, device=DEVICE)
    torch.cuda.synchronize()
    m = A.shape[0]
    log("[4 slice] A: %d rows, %d nonzeros, fmt=%s, built in %.1f s"
        % (m, len(coo[0]), A.fmt, time.perf_counter() - t0))
    if A.fmt != "cuda-dia":
        raise AssertionError("auto policy picked %r, not cuda-dia" % A.fmt)
    data, offsets = A.container.data, A.container.offsets

    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(m)
                              .astype(np.float32)).to(DEVICE)
    b = A * x_true
    torch.cuda.synchronize()
    ref = K.dia_matvec_plain(data, offsets, x_true)
    err = (b - ref).abs().max().item()
    log("[4 slice] b = A x_true: kernel vs plain rel err %.3e, "
        "max abs err %.3e" % (relerr(b, ref), err))
    if not relerr(b, ref) <= REL_BOUND[torch.float32]:
        raise AssertionError("kernel disagrees with plain at n=%d" % N)
    del ref

    # a short solve at full size first, so the timed one below is warm
    # (its allocations at this size are already cached)
    t0 = time.perf_counter()
    warm = pt.solve(A, b, maxiter=20)
    torch.cuda.synchronize()
    log("[4 slice] warm-up solve: %d iterations in %.3f s"
        % (int(warm.n_iter), time.perf_counter() - t0))
    del warm

    K.DIA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(A, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.DIA_LAUNCHES
    n_iter, n_matvec = int(res.n_iter), int(res.n_matvec)
    log("[4 slice] solve: converged=%s istop=%d n_iter=%d n_matvec=%d "
        "kernel launches=%d" % (bool(res.converged), int(res.istop),
                                n_iter, n_matvec, launches))
    log("[4 slice] solve: %.3f s, %.3f ms per iteration"
        % (secs, 1e3 * secs / max(n_iter, 1)))
    if not (bool(res.converged) and int(res.istop) == 0):
        raise AssertionError("solve did not converge: %r" % (res,))
    if launches != n_matvec or launches == 0:
        raise AssertionError("%d kernel launches for %d matvecs"
                             % (launches, n_matvec))
    if res.x.shape != (m,) or not torch.isfinite(res.x).all():
        raise AssertionError("bad solution: shape %s" % (tuple(res.x.shape),))
    b64 = b.double()
    r = b64 - K.dia_matvec_plain(data.double(), offsets, res.x.double())
    true_rel = (torch.linalg.vector_norm(r)
                / torch.linalg.vector_norm(b64)).item()
    x_err = (torch.linalg.vector_norm(res.x.double() - x_true.double())
             / torch.linalg.vector_norm(x_true.double())).item()
    log("[4 slice] true relative residual (f64) %.3e, relative error in "
        "x %.3e" % (true_rel, x_err))
    if not true_rel <= 1e-4:
        raise AssertionError("true relative residual %.3e > 1e-4"
                             % true_rel)
    del r, b64

    t0 = time.perf_counter()
    A_plain = operator_from_coo(*coo, symmetric=True, fmt="dia",
                                device=DEVICE)
    del coo
    before = K.DIA_LAUNCHES
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res_plain = pt.solve(A_plain, b)
    torch.cuda.synchronize()
    secs_plain = time.perf_counter() - t1
    n_plain = int(res_plain.n_iter)
    log("[4 slice] plain fmt=dia (built in %.1f s): converged=%s "
        "n_iter=%d, %.3f s, %.3f ms per iteration"
        % (t1 - t0, bool(res_plain.converged), n_plain, secs_plain,
           1e3 * secs_plain / max(n_plain, 1)))
    if K.DIA_LAUNCHES != before:
        raise AssertionError("the plain DIA operator launched the kernel")
    if abs(n_plain - n_iter) > 2:
        raise AssertionError("n_iter %d (kernel) vs %d (plain)"
                             % (n_iter, n_plain))
    return A, {"launches": launches, "max_abs_err": err,
               "n_iter": n_iter, "solve_s": secs}


def _time_chain(fn, data, offsets, m, rep, iters=100):
    """ms per matvec over ``iters`` chained matvecs from a fresh input."""
    g = torch.Generator(device=DEVICE).manual_seed(1000 + rep)
    x = torch.randn(m, device=DEVICE, generator=g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        x = fn(data, offsets, x)
    end.record()
    end.synchronize()
    if not torch.isfinite(x).all():
        raise AssertionError("timing chain went non-finite")
    return start.elapsed_time(end) / iters


def phase_timing(A):
    from pykrylov_tpu_torch.sparse import kernels as K

    offsets = A.container.offsets
    m = A.shape[0]
    ndiag = len(offsets)
    # scaled by 1/12 (spectral radius just under 1, as in bench.py) so a
    # chain of matvecs neither overflows nor underflows
    d32 = A.container.data / 12.0
    d16 = d32.to(torch.bfloat16)
    variants = [("kernel f32", K.dia_matvec, d32),
                ("plain f32", K.dia_matvec_plain, d32),
                ("kernel bf16", K.dia_matvec, d16),
                ("plain bf16", K.dia_matvec_plain, d16)]
    for _, fn, data in variants:  # warm up
        _time_chain(fn, data, offsets, m, 0, iters=5)
    best = {}
    for rep in range(3):
        order = variants if rep % 2 == 0 else variants[::-1]
        for label, fn, data in order:
            ms = _time_chain(fn, data, offsets, m, rep + 1)
            best[label] = min(best.get(label, float("inf")), ms)
    out = {}
    for label, _, data in variants:
        nbytes = (ndiag * data.element_size() + 2 * 4) * m
        gbps = nbytes / (best[label] * 1e-3) / 1e9
        log("[5 timing] %-12s %.4f ms per matvec, %.1f GB/s "
            "(%d bytes per matvec)" % (label, best[label], gbps, nbytes))
        out[label] = (best[label], gbps)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import pykrylov_tpu_torch as pt
    except ImportError as exc:
        print("chip_smoke: pykrylov_tpu_torch not found beside this "
              "script (%s)" % exc, file=sys.stderr)
        return 2
    if os.path.dirname(os.path.abspath(pt.__file__)) != os.path.join(
            HERE, "pykrylov_tpu_torch"):
        print("chip_smoke: imported %s, not this checkout's package"
              % pt.__file__, file=sys.stderr)
        return 2
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    card = phase_device()
    phase_build(pt)
    phase_kernel(pt)
    A, run = phase_slice(pt)
    times = phase_timing(A)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    kernel = {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "pykrylov_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "pykrylov_tpu/sparse/kernels.py:211",
        "launches": run["launches"],
        "max_abs_err": run["max_abs_err"],
        "ms": times["kernel f32"][0],
        "plain_ms": times["plain f32"][0],
        "gbps": times["kernel f32"][1],
        "plain_gbps": times["plain f32"][1],
        "bf16_ms": times["kernel bf16"][0],
        "bf16_plain_ms": times["plain bf16"][0],
    }
    log("[6 result] card: %s; solve n=%d: %d iterations in %.3f s"
        % (card, N, run["n_iter"], run["solve_s"]))
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
