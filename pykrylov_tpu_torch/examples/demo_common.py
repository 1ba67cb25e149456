"""Shared demo driver (the reference's ``examples/demo_common.py``).

:func:`demo` builds the operator from a bundled matrix name or a
MatrixMarket file path, solves with rhs = A·e, guess = 1 + arange(n),
reltol 1e-8 and matvec_max 2n in float64, and prints the reference's
result table.  Run as a script, it applies one of the reference-style
solver classes to a matrix::

    python -m pykrylov_tpu_torch.examples.demo_common [matrix]
        [--solver CG] [--device cuda]
"""

import argparse
import os
from math import sqrt

import torch

from pykrylov_tpu_torch import compat
from pykrylov_tpu_torch.io.datasets import BUNDLED
from pykrylov_tpu_torch.io.matrix_market import read_matrix_market
from pykrylov_tpu_torch.sparse import sparse_operator

HDR_FMT = "%10s  %6s  %8s  %8s  %8s"
HDR = HDR_FMT % ("Name", "Matvec", "Resid0", "Resid", "Error")
FMT = "%10s  %6d  %8.2e  %8.2e  %8.2e"
SOLVERS = ("CG", "Minres", "Symmlq", "BiCGSTAB", "CGS", "TFQMR")


def load_operator(source, symmetric=None, device="cuda"):
    """A float64 operator from a bundled name ('1138bus') or a .mtx file
    path; ``symmetric`` defaults to what the matrix declares."""
    if os.path.exists(source):
        vals, rows, cols, shape, info = read_matrix_market(source)
        if symmetric is None:
            symmetric = info.symmetry == "symmetric"
        return sparse_operator((vals, rows, cols, shape),
                               symmetric=symmetric, device=device)
    if symmetric is None:
        symmetric = BUNDLED.get(source, ((0, 0), False, ""))[1]
    return sparse_operator(source, symmetric=symmetric, device=device)


def error_norm(x):
    """||x - e|| / sqrt(n): the distance to the protocol's solution."""
    return float(torch.linalg.vector_norm(x - 1.0)) / sqrt(x.shape[0])


def result_row(ks):
    """The reference's table row of a solved ``compat`` instance."""
    return FMT % (ks.acronym, ks.nMatvec, ks.residNorm0, ks.residNorm,
                  error_norm(ks.bestSolution))


def demo(KSolver, source, symmetric=None, device="cuda", **kwargs):
    """Solve A x = A e with the reference's protocol and print the row."""
    op = load_operator(source, symmetric=symmetric, device=device)
    n = op.nargin
    rhs = op * torch.ones(n, dtype=torch.float64, device=device)
    ks = KSolver(op, reltol=1.0e-8, **{
        k: kwargs.pop(k) for k in ("logger", "precon") if k in kwargs})
    ks.solve(rhs, guess=1.0 + torch.arange(n, dtype=torch.float64,
                                           device=device),
             matvec_max=2 * n, **kwargs)
    print()
    print(HDR)
    print("-" * len(HDR))
    print(result_row(ks))
    return ks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrix", nargs="?", default="1138bus",
                   help="bundled matrix name or .mtx path")
    p.add_argument("--solver", choices=SOLVERS, default="CG")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return demo(getattr(compat, args.solver), args.matrix,
                device=args.device)


if __name__ == "__main__":
    main()
