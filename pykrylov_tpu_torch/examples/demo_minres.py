"""The reference's MINRES demo (``examples/demo_minres.py``).

Solves A x = A·e in float64 on a symmetric matrix (default the bundled
1138bus) to rtol 1e-10, logging to stdout, and prints the reference's
result table.

    python -m pykrylov_tpu_torch.examples.demo_minres [matrix]
        [--device cuda]
"""

import argparse

import torch

from pykrylov_tpu_torch.compat import Minres

from .demo_cg import stdout_logger
from .demo_common import HDR, load_operator, result_row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrix", nargs="?", default="1138bus",
                   help="bundled matrix name or .mtx path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    op = load_operator(args.matrix, symmetric=True, device=args.device)
    rhs = op * torch.ones(op.nargin, dtype=torch.float64,
                          device=args.device)
    K = Minres(op, logger=stdout_logger("MINRES"))
    K.solve(rhs, rtol=1.0e-10)
    print()
    print(HDR)
    print("-" * len(HDR))
    print(result_row(K))
    return K


if __name__ == "__main__":
    main()
