"""The reference's benchmark script (``examples/bmark.py``).

Runs CGS, TFQMR and Bi-CGSTAB on a matrix (bundled name or .mtx path;
default jpwh_991, the matrix of the reference's published table) in
float64 on ``--device``, with rhs = A·e, guess = 1 + arange(n), reltol
1e-8 and matvec_max 2n, and prints the reference's table.  ``--precon``
adds the diagonal preconditioner M = diag(1/max(|a_ii|, 1)) (the
reference's ``DiagonalPrec``).

The reference's published matvecs (doc/source/bmark.rst): CGS 82, TFQMR
84, Bi-CGSTAB 84; preconditioned 70, 70, 64.

    python -m pykrylov_tpu_torch.examples.bmark [matrix] [--precon]
        [--device cuda]
"""

import argparse

import torch

from pykrylov_tpu_torch.compat import CGS, TFQMR, BiCGSTAB
from pykrylov_tpu_torch.sparse import jacobi_preconditioner

from .demo_common import HDR, load_operator, result_row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrix", nargs="?", default="jpwh_991",
                   help="bundled matrix name or .mtx path")
    p.add_argument("--precon", action="store_true",
                   help="use the diagonal preconditioner")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    print(HDR)
    print("-" * len(HDR))
    op = load_operator(args.matrix, device=args.device)
    dp = (jacobi_preconditioner(args.matrix, floor=1.0, device=args.device)
          if args.precon else None)
    n = op.nargin
    rhs = op * torch.ones(n, dtype=torch.float64, device=args.device)
    out = []
    for KSolver in (CGS, TFQMR, BiCGSTAB):
        ks = KSolver(op, precon=dp, reltol=1.0e-8)
        ks.solve(rhs, guess=1.0 + torch.arange(n, dtype=torch.float64,
                                               device=args.device),
                 matvec_max=2 * n)
        print(result_row(ks))
        out.append(ks)
    return out


if __name__ == "__main__":
    main()
