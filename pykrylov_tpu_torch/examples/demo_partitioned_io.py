"""Partitioned MatrixMarket ingestion and a verified sharded solve.

A symmetric coordinate .mtx file (lower triangle stored) is written,
stream-parsed in bounded chunks and routed to the sharded operators' own
row blocks (``read_matrix_market_partitioned``; a process of a mesh
across processes would pass ``keep=k`` and hold one block), the sharded
operator is built through ``gather_ell_from_mtx``, and CG runs with
compensated residual replacement; its result is certified against a
float64 host product.  The shard slots share one card (or the CPU).

    python -m pykrylov_tpu_torch.examples.demo_partitioned_io
        [--shards 8] [--device cuda]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from pykrylov_tpu_torch.io.matrix_market import (
    read_matrix_market_partitioned, write_matrix_market)
from pykrylov_tpu_torch.parallel import shard_vector
from pykrylov_tpu_torch.parallel.gather import gather_ell_from_mtx
from pykrylov_tpu_torch.parallel.mesh import make_mesh
from pykrylov_tpu_torch.solvers import cg


def spd_lower(n, rng):
    """Stored entries (lower triangle, diagonal 4) of a random SPD
    matrix, one entry a position."""
    rr = rng.integers(0, n, 6 * n)
    cc = rng.integers(0, n, 6 * n)
    rr, cc = np.maximum(rr, cc), np.minimum(rr, cc)
    _, first = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[first], cc[first]
    vv = 0.08 * rng.standard_normal(len(rr))
    rr = np.concatenate([rr, np.arange(n)])
    cc = np.concatenate([cc, np.arange(n)])
    vv = np.concatenate([vv, np.full(n, 4.0)])
    _, first = np.unique(rr * n + cc, return_index=True)
    return vv[first], rr[first], cc[first]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--n", type=int, default=1200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n, shards, dev = args.n, args.shards, args.device

    vv, rr, cc = spd_lower(n, np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spd.mtx")
        write_matrix_market(path, vv, rr, cc, (n, n), symmetry="symmetric")
        print("wrote %s (%d stored entries, symmetric)" % (path, len(vv)))

        # stream-partitioned load: the row blocks' sizes
        parts, shape, info = read_matrix_market_partitioned(
            path, shards, chunk_entries=512)
        print("streamed in 512-entry chunks -> %d row blocks:" % len(parts))
        for k, (pv, pr, pc) in enumerate(parts):
            lo = int(pr.min()) if len(pr) else -1
            hi = int(pr.max()) if len(pr) else -1
            print("  block %d: %6d entries (rows %d..%d)"
                  % (k, len(pv), lo, hi))

        mesh = make_mesh(shards, device=dev)
        A = gather_ell_from_mtx(path, mesh, symmetric=True,
                                dtype=np.float32, chunk_entries=512)
    ep = torch.zeros(A.nargin, dtype=torch.float32)
    ep[:n] = 1.0
    b = A @ shard_vector(ep, mesh)
    res = cg(A, b, rtol=1e-8, atol=0.0, replace_every=10, maxiter=4 * n)
    # the float64 certificate of the stored (f32) matrix
    a64 = np.zeros((n, n))
    v32 = vv.astype(np.float32).astype(np.float64)
    np.add.at(a64, (rr, cc), v32)
    off = rr != cc
    np.add.at(a64, (cc[off], rr[off]), v32[off])
    x = res.x.double().cpu().numpy()[:n]
    b64 = b.double().cpu().numpy()[:n]
    rel = np.linalg.norm(b64 - a64 @ x) / np.linalg.norm(b64)
    print("verified sharded CG: converged=%s iters=%d  f64-oracle "
          "rel resid=%.2e" % (bool(res.converged), int(res.n_iter), rel))
    return res, rel


if __name__ == "__main__":
    main()
