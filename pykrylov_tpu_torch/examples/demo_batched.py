"""The bmark trio on a block of right-hand sides.

The reference's benchmark (``examples/bmark.py``) solves one system with
CGS, TFQMR and Bi-CGSTAB in turn.  Here each method solves an (n, K)
block at once (``cgs_batched``, ``tfqmr_batched``, ``bicgstab_batched``):
one block product an iteration streams the matrix once for all K
systems.  jpwh_991 in float32 with the Jacobi preconditioner, rtol 1e-5
(the attainable f32 range for this system; the reference runs its 1e-8
protocol in f64).

    python -m pykrylov_tpu_torch.examples.demo_batched [K] [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch.io.datasets import load_bundled
from pykrylov_tpu_torch.solvers import (bicgstab_batched, cgs_batched,
                                        tfqmr_batched)
from pykrylov_tpu_torch.sparse import jacobi_preconditioner, sparse_operator


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("K", nargs="?", type=int, default=4,
                   help="right-hand sides")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    K, dev = args.K, args.device

    n = load_bundled("jpwh_991")[3][0]
    A = sparse_operator("jpwh_991", dtype=np.float32, device=dev)
    M = jacobi_preconditioner("jpwh_991", device=dev)
    # K right-hand sides: the bmark rhs (A @ ones) plus random solutions
    rng = np.random.default_rng(0)
    Xtrue = torch.from_numpy(np.concatenate(
        [np.ones((n, 1)), rng.standard_normal((n, K - 1))],
        axis=1).astype(np.float32)).to(dev)
    B = A @ Xtrue
    x0 = (1.0 + torch.arange(n, dtype=torch.float32,
                             device=dev))[:, None].repeat(1, K)

    print("jpwh_991, K=%d right-hand sides, rtol 1e-5, Jacobi precon, "
          "device=%s" % (K, dev))
    print("%10s %22s %14s %12s %10s" % ("Name", "Matvecs/col",
                                        "max |resid|", "max err",
                                        "converged"))
    print("-" * 72)
    out = {}
    for name, solver in (("CGS", cgs_batched),
                         ("TFQMR", tfqmr_batched),
                         ("Bi-CGSTAB", bicgstab_batched)):
        res = solver(A, B, x0=x0, M=M, rtol=1e-5, matvec_max=2 * n)
        err = float((res.x - Xtrue).abs().max())
        nmv = [int(v) for v in res.info["n_matvec_columns"]]
        print("%10s %22s %14.3e %12.3e %10s"
              % (name, nmv, float(res.resid_norm.max()), err,
                 bool(res.converged.all())))
        out[name] = res
    return out


if __name__ == "__main__":
    main()
