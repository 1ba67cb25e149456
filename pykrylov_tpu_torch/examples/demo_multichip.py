"""Preconditioned CG on sharded 3-D Poisson over 1, 2, 4, ... shard slots.

The same per-shard problem size on each mesh (weak scaling in shape):
the halo-exchange DIA operator over ``d`` shard slots, Jacobi-
preconditioned CG to rtol 1e-6 in float32, best wall time of
``--repeats`` warm solves and the time per iteration against one slot.
The slots share one card (or the CPU), so the column shows the cost of
sharding on one device, not a scaling across cards.

    python -m pykrylov_tpu_torch.examples.demo_multichip [scale]
        [--shards 8] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from pykrylov_tpu_torch.ops import DiagonalOperator
from pykrylov_tpu_torch.parallel import make_mesh, replicate, sharded_poisson3d
from pykrylov_tpu_torch.solvers import cg


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_shards, n_grid, dev, repeats=3):
    mesh = make_mesh(n_shards, device=dev)
    op, b, e, pad = sharded_poisson3d(n_grid, mesh, halo=True,
                                      dtype=np.float32)
    m = n_grid ** 3 + pad
    M = DiagonalOperator(replicate(torch.full((m,), 1.0 / 6.0,
                                              dtype=torch.float32), mesh),
                         device=dev)
    res = cg(op, b, M=M, rtol=1e-6, maxiter=2 * m)   # warm and converge
    _sync(dev)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        cg(op, b, M=M, rtol=1e-6, maxiter=2 * m)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, int(res.n_iter), bool(res.converged)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scale", nargs="?", type=int, default=32,
                   help="grid side on one slot")
    p.add_argument("--shards", type=int, default=8,
                   help="the largest mesh")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print("device: %s" % args.device)
    print("%8s %8s %10s %8s %10s %8s %10s" % (
        "shards", "grid n", "unknowns", "iters", "converged", "time(s)",
        "per-it/1"))
    t1 = None
    d = 1
    out = []
    while d <= args.shards:
        # unknowns per shard held about constant
        n_grid = int(round(args.scale * d ** (1.0 / 3.0)))
        t, iters, conv = run(d, n_grid, args.device, args.repeats)
        t_per_iter = t / max(iters, 1)
        if t1 is None:
            t1 = t_per_iter
        print("%8d %8d %10d %8d %10s %8.3f %10.2f" % (
            d, n_grid, n_grid ** 3, iters, conv, t, t_per_iter / t1))
        out.append((d, n_grid, iters, conv, t))
        d *= 2
    return out


if __name__ == "__main__":
    main()
