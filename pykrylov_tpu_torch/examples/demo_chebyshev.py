"""Chebyshev polynomial preconditioning on 3-D Poisson.

The reference's only factorization preconditioner is the CHOLMOD
``CholeskyOperator``.  A matrix-only alternative: estimate the spectral
bounds with a Lanczos sweep, build ``p(A) ~ A^{-1}`` as a fixed-degree
Chebyshev polynomial and hand it to CG as ``M=``; each outer iteration
then does the products of ``degree`` plain ones and pays the dot-product
barriers once.  The grid defaults to 64^3 (262,144 rows, the DIA kernel's
size) on a card and 12^3 on the CPU.

    python -m pykrylov_tpu_torch.examples.demo_chebyshev [grid_n]
        [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch.gallery.poisson import poisson3d_coo
from pykrylov_tpu_torch.ops import chebyshev_preconditioner, lanczos_bounds
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse.linop import operator_from_coo


def device_name(device):
    """The card's name for a CUDA device, else the device string."""
    dev = torch.device(device)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("grid_n", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    n = args.grid_n or (12 if dev == "cpu" else 64)

    vals, rows, cols, shape = poisson3d_coo(n, dtype=np.float32)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          device=dev)
    m = shape[0]
    print("3-D Poisson grid %d^3 -> %d unknowns, format %s (%s)"
          % (n, m, A.fmt, device_name(dev)))
    b = torch.ones(m, dtype=torch.float32, device=dev)

    lmin, lmax = lanczos_bounds(A, k=16)
    print("Lanczos bounds: [%.4f, %.4f]" % (float(lmin), float(lmax)))

    plain = cg(A, b, rtol=1e-6)
    print("plain CG      : %4d iterations, converged=%s"
          % (int(plain.n_iter), bool(plain.converged)))
    out = {"A": A, "plain": plain}
    for degree in (4, 8, 16):
        M = chebyshev_preconditioner(A, degree=degree, bounds=(lmin, lmax))
        pre = cg(A, b, M=M, rtol=1e-6)
        print("Chebyshev(%2d) : %4d iterations (~%4d matvec-equivalents),"
              " converged=%s" % (degree, int(pre.n_iter),
                                 int(pre.n_iter) * degree,
                                 bool(pre.converged)))
        r = float(torch.linalg.vector_norm(b - A * pre.x)
                  / torch.linalg.vector_norm(b))
        print("                true relative residual %.2e" % r)
        out[degree] = pre
    return out


if __name__ == "__main__":
    main()
