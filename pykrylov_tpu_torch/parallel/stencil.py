"""Matrix-free halo-exchange 3-D Poisson operator (a z-slab split).

Counterpart of ``pykrylov_tpu/parallel/stencil.py``.  For the constant
seven-point stencil the fastest local product streams no matrix at all:
each shard applies the stencil to its ``(n/P, n, n)`` slab with the two
z-planes of its neighbours (zeros at the global ends).

Vector layout: the natural z-major flat ``(n^3,)`` order, whose z-slabs
are contiguous, so :func:`~.sharded.shard_vector` shards it directly;
``n`` must be divisible by the mesh extent.  :mod:`.halo2d` splits y as
well and shares the brick product below.  On a mesh of ranks each rank
holds its brick and receives its neighbours' faces in one exchange
(:meth:`~.comm.Comm.sendrecv`: up to four faces each way).
"""

from __future__ import annotations

import torch

from ..ops.base import LinearOperator
from ..utils import ranks
from ..utils.types import as_dtype
from .mesh import ROW_AXIS
from .sharded import assemble

__all__ = ["HaloStencilPoisson3DOperator"]


def stencil7(u, zlo, zhi, ylo, yhi, scale):
    """The seven-point Laplacian ``scale * [6, -1 x 6]`` of one brick
    ``u`` (nz, ny, n, K) with its z faces (ny, n, K) and y faces
    (nz, n, K) from its neighbours (zeros at the global ends), as rows
    (nz ny n, K), summed in the JAX package's order."""
    nz, ny, n, K = u.shape
    up = u.new_zeros((nz + 2, ny + 2, n + 2, K))
    up[1:-1, 1:-1, 1:-1] = u
    up[0, 1:-1, 1:-1] = zlo
    up[-1, 1:-1, 1:-1] = zhi
    up[1:-1, 0, 1:-1] = ylo
    up[1:-1, -1, 1:-1] = yhi
    c = up[1:-1, 1:-1, 1:-1]
    Y = (6.0 * c
         - up[:-2, 1:-1, 1:-1] - up[2:, 1:-1, 1:-1]
         - up[1:-1, :-2, 1:-1] - up[1:-1, 2:, 1:-1]
         - up[1:-1, 1:-1, :-2] - up[1:-1, 1:-1, 2:])
    return (scale * Y).reshape(-1, K)


def brick_stencil(mesh, n, rz, ry, scale):
    """The block product ``X -> A X`` of the 3-D Poisson stencil on an
    (rz x ry) grid of bricks in brick order (shard ``zi ry + yi`` holds
    the ``(n/rz, n/ry, n)`` brick): each shard copies its brick and the
    four faces of its neighbours to its slot and applies
    :func:`stencil7`."""
    nzl, nyl = n // rz, n // ry

    def ranked(X):
        """This rank's brick with its neighbours' faces, received."""
        K = X.shape[1]
        zi, yi = divmod(mesh.rank, ry)
        u = ranks.plain(X).reshape(nzl, nyl, n, K)
        peers = (((zi - 1) * ry + yi if zi > 0 else None, u[0]),
                 ((zi + 1) * ry + yi if zi < rz - 1 else None, u[-1]),
                 (zi * ry + yi - 1 if yi > 0 else None, u[:, 0]),
                 (zi * ry + yi + 1 if yi < ry - 1 else None, u[:, -1]))
        live = [(p, f) for p, f in peers if p is not None]
        got = iter(mesh.comm.sendrecv(
            live, [(p, f.shape) for p, f in live], u))
        zlo, zhi, ylo, yhi = (next(got) if p is not None
                              else u.new_zeros(f.shape) for p, f in peers)
        return ranks.shard(stencil7(u, zlo, zhi, ylo, yhi,
                                    scale.to(u.device)))

    def mm(X):
        if mesh.ranked:
            return ranked(X)
        K = X.shape[1]
        B = X.reshape(rz, ry, nzl, nyl, n, K)

        def local(s):
            zi, yi = divmod(s, ry)
            slot = mesh.slots[s]

            def face(ok, pick, shape):
                if not ok:
                    return X.new_zeros(shape, device=slot)
                return pick().to(slot)

            u = B[zi, yi].to(slot)
            zlo = face(zi > 0, lambda: B[zi - 1, yi, -1], (nyl, n, K))
            zhi = face(zi < rz - 1, lambda: B[zi + 1, yi, 0], (nyl, n, K))
            ylo = face(yi > 0, lambda: B[zi, yi - 1, :, -1], (nzl, n, K))
            yhi = face(yi < ry - 1, lambda: B[zi, yi + 1, :, 0],
                       (nzl, n, K))
            return stencil7(u, zlo, zhi, ylo, yhi, scale.to(slot))

        return assemble(mesh, local)

    return mm


class HaloStencilPoisson3DOperator(LinearOperator):
    """Matrix-free seven-point 3-D Poisson over a 1-D z-slab split.

    Acts on natural z-major flat vectors of length ``n**3`` sharded with
    :func:`~.sharded.shard_vector` (no padding: ``n`` must be divisible
    by the mesh extent).  ``scale`` multiplies the [6, -1 x 6] stencil,
    matching ``gallery.poisson3d_matvec`` at 1.0.
    """

    def __init__(self, n, mesh, scale=1.0, axis=ROW_AXIS,
                 dtype=torch.float32, **kwargs):
        n_dev = mesh.shape[axis]
        if n % n_dev:
            raise ValueError("mesh extent %d must divide the grid n=%d"
                             % (n_dev, n))
        dtype = as_dtype(dtype)
        scale = torch.as_tensor(scale, dtype=dtype, device=mesh.home)
        mm = brick_stencil(mesh, int(n), int(n_dev), 1, scale)
        super().__init__(n ** 3, n ** 3, matvec=lambda x: mm(x[:, None])[:, 0],
                         matmat=mm, symmetric=True, hermitian=True,
                         dtype=dtype, device=mesh.home, params=(scale,),
                         **kwargs)
        self.mesh = mesh
        self.grid_n = n
        self.pad = 0
        self.halo_width = n * n
        self.local_kernel = False   # matrix-free: nothing to stream
