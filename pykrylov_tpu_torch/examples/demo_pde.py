"""A 2-D Poisson system through a matrix-free operator closure.

The analogue of the reference's FEniCS example, which passes an
assembled 2-D Poisson FEM matrix and a diagonal preconditioner to CG as
raw closures: the 5-point finite-difference Laplacian on the unit square
wrapped as a :class:`LinearOperator` closure, a manufactured solution,
and diagonally preconditioned CG in float64.

    python -m pykrylov_tpu_torch.examples.demo_pde [n] [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch.gallery import poisson2d_matvec
from pykrylov_tpu_torch.ops import DiagonalOperator, LinearOperator
from pykrylov_tpu_torch.solvers import cg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=64,
                   help="interior grid points per side")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n, dev = args.n, args.device
    h = 1.0 / (n + 1)
    N = n * n

    # matrix-free operator: (1/h^2) * 5-point stencil
    A = LinearOperator(N, N, matvec=lambda x: poisson2d_matvec(x) / h ** 2,
                       symmetric=True, hermitian=True,
                       dtype=torch.float64, device=dev)
    # manufactured solution u = x(1-x) y(1-y): -lap u = 2[x(1-x)+y(1-y)]
    # (not an eigenfunction of the discrete Laplacian)
    xs = np.arange(1, n + 1) * h
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u_exact = X * (1 - X) * Y * (1 - Y)
    f = 2.0 * (X * (1 - X) + Y * (1 - Y))
    M = DiagonalOperator(torch.full((N,), h ** 2 / 4.0,
                                    dtype=torch.float64), device=dev)

    res = cg(A, torch.from_numpy(f.ravel()).to(dev), M=M, rtol=1e-10)
    u = res.x.cpu().numpy().reshape(n, n)
    # the discretisation error is O(h^2); the solver's is far below it
    err = np.max(np.abs(u - u_exact))
    print("CG converged=%s iters=%d resid=%.2e"
          % (bool(res.converged), int(res.n_iter), float(res.resid_norm)))
    print("max |u - u_exact| = %.3e (O(h^2) = %.3e)" % (err, h ** 2))
    if not (bool(res.converged) and err < 10 * h ** 2):
        raise RuntimeError("demo_pde: CG did not reach the discretisation "
                           "error")
    return res, err


if __name__ == "__main__":
    main()
