"""Verified iterative refinement (``solvers/refine.py``).

In float32 an unverified stopping test can be off by orders of
magnitude.  This demo shows the family-wide answer:

1. ``solve(A, b, verified=True)``: the front door's verified solve (CG
   legs for an SPD operator) on 1138bus;
2. ``refined_solve(minres, ...)``: verified MINRES legs on a symmetric
   indefinite system, where CG does not apply;
3. refined ff-MINRES on Jacobi-preconditioned 1138bus (condition ~1e7):
   it converges verified at rtol 1e-6, and a target it cannot reach is
   reported as istop 1 (budget) or 3 (precision floor), never claimed.

    python -m pykrylov_tpu_torch.examples.demo_refined [--n 400]
        [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch import solve
from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.ops import DiagonalOperator
from pykrylov_tpu_torch.solvers import minres, refined_solve
from pykrylov_tpu_torch.sparse import sparse_operator


def _f32(a, dev):
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _true_rel(a64, res, b64):
    """||a64 (x + x_lo) - b64|| / ||b64|| in float64."""
    x = (res.x.double() + res.info["x_lo"].double()).cpu().numpy()
    return np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)


def _bus(dev):
    vals, rows, cols, shape = load_bundled("1138bus")
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals.astype(np.float32).astype(np.float64))
    op = sparse_operator((vals.astype(np.float32), rows, cols, shape),
                         symmetric=True, fmt="ell", device=dev)
    return (vals, rows, cols, shape), a64, op


def spd_front_door(dev):
    _, a64, op = _bus(dev)
    b64 = a64 @ np.ones(a64.shape[0])
    res = solve(op, _f32(b64, dev), verified=True, rtol=1e-6)
    print("[spd] solve(verified=True) on 1138bus f32: converged=%s "
          "legs=%d TRUE relres=%.2e" % (bool(res.converged),
                                        res.info["n_legs"],
                                        _true_rel(a64, res, b64)))
    return res


def indefinite_minres(dev, n=400, nneg=12):
    a = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    eig = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    a -= 0.5 * (eig[nneg - 1] + eig[nneg]) * np.eye(n)
    b64 = a @ np.random.default_rng(0).standard_normal(n)
    res = refined_solve(minres, _f32(a, dev), _f32(b64, dev), rtol=1e-6,
                        leg_maxiter=400)
    print("[indefinite] refined MINRES (%d negative eigenvalues): "
          "converged=%s legs=%d TRUE relres=%.2e"
          % (nneg, bool(res.converged), res.info["n_legs"],
             _true_rel(a, res, b64)))
    return res


def minres_floor(dev, max_legs=12, leg_maxiter=1200):
    (vals, rows, cols, shape), a64, op = _bus(dev)
    d = np.zeros(shape[0], np.float32)
    dm = rows == cols
    d[rows[dm]] = vals[dm].astype(np.float32)
    M = DiagonalOperator(_f32(1.0 / np.maximum(np.abs(d), 1.0), dev),
                         device=dev)
    b64 = a64 @ np.ones(shape[0])
    res = refined_solve(minres, op, _f32(b64, dev), rtol=1e-6, M=M,
                        leg_rtol=1e-2, max_legs=max_legs,
                        leg_maxiter=leg_maxiter)
    print("[hard] refined ff-MINRES on 1138bus (kappa~1e7) at rtol 1e-6: "
          "converged=%s istop=%d legs=%d TRUE relres=%.2e (unreachable "
          "targets report istop 1/3)"
          % (bool(res.converged), int(res.istop), res.info["n_legs"],
             _true_rel(a64, res, b64)))
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=400,
                   help="order of the indefinite system")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return (spd_front_door(args.device),
            indefinite_minres(args.device, args.n),
            minres_floor(args.device))


if __name__ == "__main__":
    main()
