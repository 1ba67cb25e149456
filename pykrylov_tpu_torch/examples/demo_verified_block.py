"""Verified blocks of right-hand sides: ``solve(A, B, verified=True)``.

Each column of an (n, K) block carries double-f32 (hi, lo) pairs and
stops only on its own recomputed true residual: float32 storage with a
verified 1e-6 per column, on Jacobi-preconditioned 1138bus (CG) and on a
dense nonsymmetric system (block refinement, one ``bicgstab_batched``
solve a leg).

    python -m pykrylov_tpu_torch.examples.demo_verified_block [K]
        [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch import solve
from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.ops import linop_from_ndarray
from pykrylov_tpu_torch.sparse import jacobi_preconditioner, sparse_operator


def _columns(a64, res, B64, label):
    X = (res.x.double() + res.info["x_lo"].double()).cpu().numpy()
    rels = []
    for j in range(B64.shape[1]):
        rel = (np.linalg.norm(a64 @ X[:, j] - B64[:, j])
               / np.linalg.norm(B64[:, j]))
        rels.append(rel)
        print("  col %d: converged=%-5s %sTRUE relres=%.2e"
              % (j, bool(res.converged[j]), label(j), rel))
    return rels


def spd(K, dev):
    vals, rows, cols, shape = load_bundled("1138bus")
    n = shape[0]
    vals32 = vals.astype(np.float32)
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals32.astype(np.float64))
    op = sparse_operator((vals32, rows, cols, shape), symmetric=True,
                         fmt="ell", device=dev)
    M = jacobi_preconditioner((vals32, rows, cols, shape), device=dev)
    rng = np.random.default_rng(0)
    B = torch.as_tensor(np.stack([a64 @ rng.standard_normal(n)
                                  for _ in range(K)], axis=1),
                        dtype=torch.float32, device=dev)
    res = solve(op, B, verified=True, M=M, rtol=1e-6, atol=0.0,
                maxiter=30000, replace_every=500)
    print("verified block solve on 1138bus f32, K=%d:" % K)
    iters = res.info["n_iter_columns"]
    reps = res.info["n_replacements"]
    _columns(a64, res, B.double().cpu().numpy(),
             lambda j: "iters=%5d replacements=%2d "
             % (int(iters[j]), int(reps[j])))
    return res


def general(K, dev, n=400):
    # nonsymmetric verified blocks: block iterative refinement, every leg
    # one bicgstab_batched solve
    rng = np.random.default_rng(1)
    a32 = (rng.standard_normal((n, n)) * 0.08
           + 4.0 * np.eye(n)).astype(np.float32)
    a64 = a32.astype(np.float64)
    op = linop_from_ndarray(torch.from_numpy(a32).to(dev), device=dev)
    B = torch.as_tensor(np.stack([a64 @ rng.standard_normal(n)
                                  for _ in range(K)], axis=1),
                        dtype=torch.float32, device=dev)
    res = solve(op, B, verified=True, rtol=1e-6, atol=0.0, max_legs=20)
    print("verified general block solve (nonsymmetric, n=%d, K=%d): "
          "legs=%d" % (n, K, res.info["n_legs"]))
    _columns(a64, res, B.double().cpu().numpy(), lambda j: "")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("K", nargs="?", type=int, default=4,
                   help="right-hand sides of the SPD block")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return spd(args.K, args.device), general(3, args.device)


if __name__ == "__main__":
    main()
