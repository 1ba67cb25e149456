#!/usr/bin/env python3
"""Sweep the probe kernels (``pykrylov_tpu_torch.probes``) on one NVIDIA
GPU: the counterpart of the ``__main__`` blocks of ``tools/probes/``.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_probes.py [--stream] [--dia] [--sell] [--mma]

(no flag: all four).  Every configuration's output is first held bit for
bit against its plain version, then timed with ``chip_smoke.device_ms``
(the host enqueues the calls behind a sleep kernel; best of 3 runs in
turns).  Bounds are bytes at the card's published memory rate
(``chip_smoke.PEAKS``: 3.35 TB/s for an H100 SXM).

* ``--stream`` (``probe_stream_floor.py``): ``stream_fold`` over 512 MB a
  call in one and in two streams, direct with U = 1, 2, 4, 8 rows of
  16-byte loads in flight a thread, and through the TMA ring at chunks of
  4, 16 and 32 KB and depths 2, 4 and 8 (where streams x depth x chunk is
  at most 192 KB); beside them torch's ``a.view(-1, 1024).sum(0)`` on one
  stream and the copy rate of ``chip_smoke.phase_rates`` (bytes read and
  written by a 1 GB ``copy_``).  One line a configuration: ms, GB/s read,
  share of the published rate, against the copy rate.
* ``--dia`` (``probe_dia_manual_dma.py``): ``dia_matvec_ring`` at tiles of
  512, 1024 and 2048 rows and depths 2 and 4, on the 3-D Poisson matrix
  at n = 240 (13.8M rows, 7 diagonals; ``chip_smoke.py`` phase 4's), the
  125-diagonal B-spline Laplacian at n = 128 (``chip_smoke.bspline_dia``,
  2.1M rows; phase 22's) and the convection-diffusion A at n = 2048
  (4.2M rows, 5 diagonals; phase 9's), each beside ``dia_matvec`` (the
  built SpMV), torch's CSR product and the bound ((ndiag + 2) m 4 bytes).
* ``--sell`` (the BELL ablation probes and ``probe_skew.py``): every
  variant of ``sell_matvec_ablated`` on tiled 1138bus (phase 5's card
  form) and the state-estimation A at 512 and 1024 areas
  (``chip_smoke.se_coo``; phase 10's forward card form), each beside its
  bound (the bytes the variant still moves), ``full`` beside
  ``sell_matvec`` (the built kernel: the two must be within 3%) and
  torch's CSR product.
* ``--mma`` (``probe_ablate_r3b.py``, ``probe_int8_mxu.py``): every
  configuration of ``bell_step_mma`` (the probe's nine and the four
  controls) on the probe's matrix (``chip_smoke.probe_mma_matrix``: tiled
  jpwh_991, 1,014,784 rows, window-1 BELL), each held against its plain
  version (the ``add`` scatters bit for bit, the mma scatters within
  ``chip_smoke.MMA_SCATTER_BOUND`` of a row's sum of |group sums|) and
  timed beside its bound (bytes at 3.35 TB/s against the tensor cores'
  dense rates), ``sell.sell_matvec`` over the card form of the same
  container and torch's CSR product; ``onehot_select`` in both modes at
  (1024, 256, 128), timed alone and as a dependent chain of 200 calls (the
  probe's ``fori_loop``: each call's w depends on the last output), beside
  ``w[base]`` and the f32 product ``oh.float() @ w`` timed the same two
  ways.

It prints the card, one line a configuration and, last, a JSON line of
every number, then ``{"ok": true}``.  Without a card it exits 2.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_BYTES = 512 << 20      # bytes a stream fold reads (the probe's)
CHUNKS = (4096, 16384, 32768)
DEPTHS = (2, 4, 8)
DIA_TILES = (512, 1024, 2048)
DIA_DEPTHS = (2, 4)
SE_AREAS = (512, 1024)
ITERS = 20                   # calls a device time averages
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def stream_sweep(cs, rates):
    from pykrylov_tpu_torch.probes import stream_floor as SF

    peak = rates["bytes"]
    out = {}
    for nstreams in (1, 2):
        streams = SF.probe_streams(nstreams, TOTAL_BYTES, seed=nstreams,
                                   device=DEVICE)
        ref = SF.stream_fold_plain(streams)
        configs = [("direct U=%d" % u, dict(mode="direct", unroll=u))
                   for u in SF.UNROLLS]
        configs += [("ring %d KB x %d" % (c // 1024, d),
                     dict(mode="ring", chunk=c, depth=d))
                    for c in CHUNKS for d in DEPTHS
                    if SF.ring_fits(nstreams, c, d)]
        runs = []
        for label, kw in configs:
            y = SF.stream_fold(streams, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                raise AssertionError("stream %d x %s differs from the plain "
                                     "fold" % (nstreams, label))
            runs.append((label, (lambda kw: lambda: SF.stream_fold(
                streams, **kw))(kw)))
        runs.append(("plain", lambda: SF.stream_fold_plain(streams)))
        if nstreams == 1:
            runs.append(("torch sum", lambda: streams[0].view(
                -1, SF.BINS).sum(0)))
        best = cs._best_ms(runs, ITERS)
        nbytes = SF.stream_bytes(streams)
        for label, ms in best.items():
            rate = nbytes / (ms * 1e-3)
            out["%d stream(s) %s" % (nstreams, label)] = {
                "ms": ms, "gbps": rate / 1e9, "of_peak": rate / peak,
                "of_copy": rate / rates["copy"]}
            log("[stream] %d stream(s), %-16s %.4f ms  %7.1f GB/s  %.1f%% of "
                "%.0f GB/s  %.3fx the copy rate"
                % (nstreams, label, ms, rate / 1e9, 100 * rate / peak,
                   peak / 1e9, rate / rates["copy"]))
        del streams
    kernels = {k: v for k, v in out.items()
               if "plain" not in k and "torch" not in k}
    top = max(kernels, key=lambda k: kernels[k]["gbps"])
    log("[stream] best read rate: %s, %.1f GB/s (copy rate %.1f GB/s, "
        "bytes read and written)" % (top, kernels[top]["gbps"],
                                      rates["copy"] / 1e9))
    out["best"] = dict(kernels[top], config=top)
    return out


def dia_matrices(cs):
    from pykrylov_tpu_torch.gallery import convdiff2d_coo, poisson3d_coo
    from pykrylov_tpu_torch.sparse import operator_from_coo

    t0 = time.perf_counter()
    A = operator_from_coo(*poisson3d_coo(cs.N, dtype=np.float32),
                          symmetric=True, device=DEVICE)
    yield "Poisson n=%d" % cs.N, A.container, time.perf_counter() - t0
    del A
    t0 = time.perf_counter()
    dia = cs.bspline_dia(cs.BS_N, device=DEVICE)
    torch.cuda.synchronize()
    yield "B-spline n=%d" % cs.BS_N, dia, time.perf_counter() - t0
    del dia
    t0 = time.perf_counter()
    A = operator_from_coo(*convdiff2d_coo(
        cs.CD_N, wx=cs.CD_N + 1.0, wy=(cs.CD_N + 1) / 2.0, dtype=np.float32),
        device=DEVICE)
    yield "convdiff n=%d A" % cs.CD_N, A.container, time.perf_counter() - t0


def dia_sweep(cs, rates):
    from pykrylov_tpu_torch.probes import dia_ring as DR
    from pykrylov_tpu_torch.sparse import kernels as K

    out = {}
    for name, dia, build_s in dia_matrices(cs):
        data, offsets = dia.data, dia.offsets
        m, n = dia.shape
        g = torch.Generator(device=DEVICE).manual_seed(17)
        x = torch.randn(n, device=DEVICE, generator=g)
        ref = K.dia_matvec_plain(data, offsets, x)
        runs = [("dia_matvec", lambda: K.dia_matvec(data, offsets, x))]
        for tile in DIA_TILES:
            for depth in DIA_DEPTHS:
                y = DR.dia_matvec_ring(data, offsets, x, tile, depth)
                torch.cuda.synchronize()
                if not torch.equal(y, ref):
                    raise AssertionError("%s: ring tile=%d depth=%d differs "
                                         "from the plain product"
                                         % (name, tile, depth))
                runs.append(("ring tile=%d depth=%d" % (tile, depth),
                             (lambda t, d: lambda: DR.dia_matvec_ring(
                                 data, offsets, x, t, d))(tile, depth)))
        if not torch.equal(K.dia_matvec(data, offsets, x), ref):
            raise AssertionError("%s: dia_matvec differs" % name)
        csr = cs._dia_csr(dia)
        runs.append(("torch CSR", lambda: csr @ x))
        best = cs._best_ms(runs, ITERS)
        bound = DR.dia_ring_bytes(len(offsets), m, n) / rates["bytes"] * 1e3
        log("[dia] %s: %d rows, %d diagonals (built in %.1f s); bound %.4f "
            "ms" % (name, m, len(offsets), build_s, bound))
        rows = {}
        for label, ms in best.items():
            rows[label] = {"ms": ms, "of_bound": bound / ms}
            log("[dia] %s | %-22s %.4f ms  %.1f%% of bound"
                % (name, label, ms, 100 * bound / ms))
        rings = {k: v for k, v in rows.items() if k.startswith("ring")}
        top = min(rings, key=lambda k: rings[k]["ms"])
        log("[dia] %s: best ring %s %.4f ms against dia_matvec %.4f ms "
            "(%.3fx)" % (name, top, rings[top]["ms"], rows["dia_matvec"]["ms"],
                         rings[top]["ms"] / rows["dia_matvec"]["ms"]))
        out[name] = {"rows": m, "ndiag": len(offsets), "bound_ms": bound,
                     "runs": rows, "best_ring": top}
        del csr, data, dia, x, ref
    return out


def sell_matrices(cs):
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import operator_from_coo

    t0 = time.perf_counter()
    coo = tiled_general_coo("1138bus", tiles=cs.TILES, coupling=0)
    A = operator_from_coo(*coo, symmetric=True, device=DEVICE)
    yield "tiled 1138bus", A.card, coo, time.perf_counter() - t0
    del A
    for areas in SE_AREAS:
        t0 = time.perf_counter()
        coo = cs.se_coo(areas)
        A = operator_from_coo(*coo, device=DEVICE)
        yield ("state estimation %d areas" % areas, A.cards["fwd"], coo,
               time.perf_counter() - t0)
        del A


def sell_sweep(cs, rates):
    from pykrylov_tpu_torch.probes import sell_ablation as SA
    from pykrylov_tpu_torch.sparse import sell as S

    out = {}
    for name, card, coo, build_s in sell_matrices(cs):
        n = card.n
        g = torch.Generator(device=DEVICE).manual_seed(23)
        x = torch.randn(n, device=DEVICE, generator=g)
        runs = [("sell_matvec", lambda: S.sell_matvec(card, x))]
        for variant in SA.VARIANTS:
            y = SA.sell_matvec_ablated(card, x, variant)
            torch.cuda.synchronize()
            if not torch.equal(y, SA.sell_matvec_ablated_plain(card, x,
                                                               variant)):
                raise AssertionError("%s: %s differs from its plain version"
                                     % (name, variant))
            runs.append((variant, (lambda v: lambda: SA.sell_matvec_ablated(
                card, x, v))(variant)))
        if not torch.equal(S.sell_matvec(card, x),
                           SA.sell_matvec_ablated(card, x, "full")):
            raise AssertionError("%s: full differs from sell_matvec" % name)
        csr = cs._torch_csr(coo, DEVICE)
        runs.append(("torch CSR", lambda: csr @ x))
        best = cs._best_ms(runs, 100)
        nnz = int(card.row_len.sum())
        log("[sell] %s: %d x %d, %d nonzeros, %.2f a row (built in %.1f s)"
            % (name, card.rows_out, n, nnz, nnz / card.rows_out, build_s))
        rows = {}
        for label, ms in best.items():
            variant = label if label in SA.VARIANTS else "full"
            bound = SA.ablation_bytes(card, n, variant) / rates["bytes"] * 1e3
            rows[label] = {"ms": ms, "bound_ms": bound, "of_bound": bound / ms}
            log("[sell] %s | %-13s %.4f ms  bound %.4f ms  %.1f%% of it"
                % (name, label, ms, bound, 100 * bound / ms))
        ratio = rows["full"]["ms"] / rows["sell_matvec"]["ms"]
        log("[sell] %s: full / sell_matvec = %.4f (%s 3%%)"
            % (name, ratio,
               "within" if abs(ratio - 1) <= 0.03 else "NOT within"))
        out[name] = {"rows": card.rows_out, "cols": n, "nnz": nnz,
                     "runs": rows, "full_over_built": ratio}
        del csr, card, x
    return out


CHAIN = 200                  # dependent calls of the select's chain


def mma_sweep(cs, rates):
    from pykrylov_tpu_torch.probes import bell_mma as BM
    from pykrylov_tpu_torch.probes import onehot_mma as OM
    from pykrylov_tpu_torch.sparse import sell as S

    t0 = time.perf_counter()
    forms, coo, x = cs.probe_mma_matrix()
    b32 = forms["f32"]
    card = S.sell_from_levels((b32,), b32.shape[0])
    log("[mma] probe_ablate_r3b.py's matrix: %d x %d, %d nonzeros; %d steps "
        "of %d rows, nb %d, nblk %d (built in %.1f s)"
        % (b32.shape[0], b32.shape[1], len(coo[0]), b32.data.shape[0],
           b32.data.shape[1], b32.nb, b32.nblk, time.perf_counter() - t0))
    configs = BM.PROBE_CONFIGS + BM.CONTROLS
    runs, sums, errs = [], {}, {}
    for cfg in configs:
        label, values = cfg[0], cfg[1]
        y = BM.bell_step_mma(forms[values], x, *cfg[2:])
        torch.cuda.synchronize()
        errs[label] = cs.hold_bell_mma("mma", label, forms[values], x, y,
                                       cfg, sums)
        runs.append((label, (lambda b, args: lambda: BM.bell_step_mma(
            b, x, *args))(forms[values], cfg[2:])))
    del sums
    # the same product, each row's terms summed one by one in slot order
    # (not by 4-row groups and block sums): f32 rounding apart
    m = b32.shape[0]
    rel = cs.relerr(S.sell_matvec(card, x),
                    BM.bell_step_mma(b32, x, "load", "tile", "add")[:m])
    if rel > cs.REL_BOUND[torch.float32]:
        raise AssertionError("sell_matvec off load/tile/add by %.3e" % rel)
    csr = cs._torch_csr(coo, DEVICE)
    runs += [("sell_matvec", lambda: S.sell_matvec(card, x)),
             ("torch CSR", lambda: csr @ x)]
    best = cs._best_ms(runs, ITERS)
    out = {"bell": {}}
    for cfg in configs:
        label, values, stage, _, scatter, nseg = cfg
        b = cs._bound(BM.bell_mma_bytes(forms[values], x.shape[0], nseg),
                      BM.bell_mma_flops(b32, stage, scatter, nseg), rates)
        ms = best[label]
        out["bell"][label] = {"ms": ms, "max_abs_err": errs[label], **b}
        log("[mma] %-32s %.4f ms  bound %.4f ms (%s)  %.1f%% of it  max err "
            "%.3e" % (label, ms, b["bound_ms"], b["bound_by"],
                      100 * b["bound_ms"] / ms, errs[label]))
    for label in ("sell_matvec", "torch CSR"):
        out["bell"][label] = {"ms": best[label]}
        log("[mma] %-32s %.4f ms" % (label, best[label]))
    del csr, card, forms, x

    # the library's product in f32, not tf32 (the default on the card,
    # stated here as chip_smoke.phase_device does)
    torch.backends.cuda.matmul.allow_tf32 = False
    gs, nb, l = cs.PROBE_SELECT
    oh, w = cs.probe_select_inputs(gs, nb, l)
    base = oh.to(torch.uint8).argmax(1)
    ohf = oh.float()
    calls = {"int8": lambda w: OM.onehot_select(oh, w, "int8"),
             "bf16x3": lambda w: OM.onehot_select(oh, w, "bf16x3"),
             "w[base]": lambda w: w[base],
             "oh.float() @ w": lambda w: ohf @ w}
    for mode in OM.MODES:
        ref = OM.onehot_select_plain(oh, w, mode)
        if not torch.equal(calls[mode](w).view(torch.int32),
                           ref.view(torch.int32)):
            raise AssertionError("select %s differs from its plain version"
                                 % mode)

    def chain(fn):
        def run():
            y = fn(w)
            for _ in range(CHAIN - 1):
                y = fn(w + y[0, :1] * 0)
            return y
        return run

    best = cs._best_ms([(k, (lambda f: lambda: f(w))(f))
                        for k, f in calls.items()], ITERS)
    chained = {k: min(cs.events_ms(chain(f), 1) for _ in range(3)) / CHAIN
               for k, f in calls.items()}
    b = cs._bound(OM.onehot_select_bytes(gs, nb, l),
                  {"int8": 4 * 2 * gs * nb * l}, rates)
    out["select"] = {"bound_ms": b["bound_ms"]}
    for k in calls:
        out["select"][k] = {"ms": best[k], "chained_ms": chained[k]}
        log("[mma] select (%d, %d, %d) %-15s %.4f ms, %.4f ms a call in a "
            "chain of %d; bound %.4f ms" % (gs, nb, l, k, best[k],
                                           chained[k], CHAIN,
                                           b["bound_ms"]))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for flag in ("stream", "dia", "sell", "mma"):
        parser.add_argument("--" + flag, action="store_true",
                            help="the %s sweep" % flag)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pykrylov_tpu_torch import _build

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    for name in _build.build():     # one nvcc per source, all at once
        _build.load(name)
    log("built in %.1f s" % (time.perf_counter() - t0))
    rates = cs.phase_rates()
    todo = [f for f in ("stream", "dia", "sell", "mma")
            if getattr(args, f)] or ["stream", "dia", "sell", "mma"]
    sweeps = {"stream": stream_sweep, "dia": dia_sweep, "sell": sell_sweep,
              "mma": mma_sweep}
    result = {"card": torch.cuda.get_device_name(0),
              "copy_gbps": rates["copy"] / 1e9}
    for name in todo:
        t0 = time.perf_counter()
        result[name] = sweeps[name](cs, rates)
        log("[%s] took %.1f s" % (name, time.perf_counter() - t0))
    if any(m.split(".")[0] in ("jax", "jaxlib", "pykrylov_tpu")
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    log(json.dumps(result))
    log(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
