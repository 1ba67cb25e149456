"""General sparsity and verified float32 CG.

1. A large nonsymmetric banded matrix of general sparsity, whose
   automatic format on a card is BELL (the SELL kernels), driving
   BiCGSTAB with a verified final residual;
2. verified residual-replacement CG certifying rtol 1e-6 in float32 on
   the ill-conditioned 1138bus system, where the plain f32 recurrence
   claims a convergence its true residual does not support.

The general matrix has 63,424 rows on a card and 8,192 on the CPU.

    python -m pykrylov_tpu_torch.examples.demo_general [n] [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.solvers.bicgstab import bicgstab
from pykrylov_tpu_torch.solvers.cg import cg
from pykrylov_tpu_torch.sparse import sparse_operator


def general_spmv_demo(n, dev):
    # nonsymmetric banded general matrix, diagonally dominant: BiCGSTAB's
    # f32 recurrence stagnates on jpwh-class matrices, so rtol stays in
    # the attainable range and the final residual is verified
    rng = np.random.default_rng(0)
    k = 8
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-1500, 1501, size=n * k), 0, n - 1)
    vals = rng.standard_normal(n * k).astype(np.float32) * 0.1
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 2.0, np.float32)])

    op = sparse_operator((vals, rows, cols, (n, n)), fmt="auto",
                         device=dev)
    print("general %dx%d, %d nnz -> auto format: %s"
          % (n, n, len(vals), op.fmt))
    b = op * torch.ones(n, dtype=torch.float32, device=dev)
    res = bicgstab(op, b, rtol=1e-4, verify_final=True)
    print("BiCGSTAB: converged=%s matvecs=%d claimed resid=%.2e "
          "VERIFIED true resid=%.2e"
          % (bool(res.converged), int(res.n_matvec),
             float(res.resid_norm), float(res.info["true_resid_norm"])))
    return op, res


def verified_cg_demo(dev):
    vals, rows, cols, shape = load_bundled("1138bus")
    op = sparse_operator((vals.astype(np.float32), rows, cols, shape),
                         symmetric=True, fmt="ell", device=dev)
    b = op * torch.ones(shape[0], dtype=torch.float32, device=dev)

    plain = cg(op, b, rtol=1e-6, atol=0.0, maxiter=20000)
    ver = cg(op, b, rtol=1e-6, atol=0.0, maxiter=20000,
             replace_every=1000)

    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    bb = b.double().cpu().numpy()

    def true_rel(x):
        return (np.linalg.norm(a @ x.double().cpu().numpy() - bb)
                / np.linalg.norm(bb))

    print("1138bus f32 @ rtol 1e-6 (claimed vs TRUE relative residual):")
    print("  plain recurrence: claimed %.1e  TRUE %.1e  (%d matvecs)"
          % (float(plain.resid_norm / plain.resid_norm0),
             true_rel(plain.x), int(plain.n_matvec)))
    print("  verified+compensated: converged=%s claimed %.1e  TRUE %.1e  "
          "(%d matvecs, %d replacements)"
          % (bool(ver.converged), float(ver.resid_norm / ver.resid_norm0),
             true_rel(ver.x), int(ver.n_matvec),
             int(ver.info["n_replacements"])))
    return plain, ver


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=None,
                   help="rows of the general matrix")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n = args.n or (8192 if args.device == "cpu" else 63424)
    return general_spmv_demo(n, args.device) + verified_cg_demo(args.device)


if __name__ == "__main__":
    main()
