"""Complex systems through the real-equivalent formulation.

Solves ``A z = b`` for Hermitian positive definite A as the real system
``[[Re A, -Im A], [Im A, Re A]] [Re z; Im z] = [Re b; Im b]``, whose
spectrum is A's with doubled multiplicity, so CG behaves as on A and the
real-only kernels apply; then a complex least-squares problem through
LSQR the same way.  Float32 on a card (n = 256 by default), float64 on
the CPU (n = 48).

    python -m pykrylov_tpu_torch.examples.demo_complex [n] [--device cuda]
"""

import argparse

import numpy as np

from pykrylov_tpu_torch.ops import complex_solve, real_equivalent_operator
from pykrylov_tpu_torch.solvers import cg, lsqr

from .demo_chebyshev import device_name


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    card = dev != "cpu"
    n = args.n or (256 if card else 48)
    rng = np.random.default_rng(0)

    # Hermitian positive definite system
    Q = np.linalg.qr(rng.standard_normal((n, n))
                     + 1j * rng.standard_normal((n, n)))[0]
    a = (Q * np.logspace(0, 3, n)) @ Q.conj().T
    a = (a + a.conj().T) / 2
    zstar = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = a @ zstar

    dt = np.float32 if card else np.float64
    ct = np.complex64 if card else np.complex128
    op = real_equivalent_operator(a.astype(ct), hermitian=True, dtype=dt,
                                  device=dev)
    print("Hermitian PD n=%d (kappa 1e3) on %s -> real SPD %s"
          % (n, device_name(dev), op.shape))
    res = complex_solve(cg, op, b.astype(ct), rtol=1e-5, device=dev)
    z = res.x.cpu().numpy()
    err = np.linalg.norm(z - zstar) / np.linalg.norm(zstar)
    print("CG: %d iterations, converged=%s, ||z - z*||/||z*|| = %.2e"
          % (int(res.n_iter), bool(res.converged), err))

    # complex least squares: min ||C z - d|| maps exactly
    m2, n2 = 2 * n, n // 2
    C = (rng.standard_normal((m2, n2))
         + 1j * rng.standard_normal((m2, n2))).astype(ct)
    d = (rng.standard_normal(m2) + 1j * rng.standard_normal(m2)).astype(ct)
    zref = np.linalg.lstsq(C, d, rcond=None)[0]
    lres = complex_solve(lsqr, real_equivalent_operator(C, dtype=dt,
                                                        device=dev),
                         d, atol=1e-6, btol=1e-6, device=dev)
    lerr = (np.linalg.norm(lres.x.cpu().numpy() - zref)
            / np.linalg.norm(zref))
    print("LSQR least squares (%dx%d): %d iterations, converged=%s, error "
          "vs lstsq %.2e" % (m2, n2, int(lres.n_iter),
                             bool(lres.converged), lerr))
    return res, lres


if __name__ == "__main__":
    main()
