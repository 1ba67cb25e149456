"""2-D mesh domain decomposition of the 3-D Poisson operator.

Counterpart of ``pykrylov_tpu/parallel/halo2d.py``.  The grid's z axis is
split over one mesh axis and y over the other (x stays whole), so an
``(rz, ry)`` mesh holds ``(n/rz, n/ry, n)`` bricks and a product
exchanges four faces a brick, ``2 (n/ry + n/rz) n`` values instead of the
z-slab split's ``2 n^2``.

Vector layout: brick order, global position ``((zi ry + yi) brick +
(z_loc nyl + y_loc) n + x)``, so shard ``zi ry + yi`` of the flat vector
is exactly its brick.  :func:`to_bricks` / :func:`from_bricks` convert;
norms and dots do not see the permutation, so the solvers run unchanged.
Under a world of ranks :func:`make_mesh2d` gives a mesh of ranks (rank
``zi ry + yi`` holds brick ``(zi, yi)``) and the faces travel between
ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..utils.types import as_dtype, to_tensor
from ..utils import ranks
from .mesh import Mesh, _slots, _world_up, rank_mesh
from .stencil import brick_stencil

__all__ = ["make_mesh2d", "Halo2DPoissonOperator", "shard_vector_2d",
           "to_bricks", "from_bricks"]


def _permuted(v, shape):
    """``v`` reshaped to ``shape`` with its axes 1 and 2 swapped, flat (a
    NumPy array or a tensor)."""
    v = v.reshape(shape)
    v = v.transpose(0, 2, 1, 3, 4) if isinstance(v, np.ndarray) \
        else v.permute(0, 2, 1, 3, 4)
    return v.reshape(-1)


def to_bricks(v, n, rz, ry):
    """Natural (z, y, x) grid vector -> brick order (a NumPy array or a
    tensor)."""
    return _permuted(v, (rz, n // rz, ry, n // ry, n))


def from_bricks(v, n, rz, ry):
    """Inverse of :func:`to_bricks`."""
    return _permuted(v, (rz, ry, n // rz, n // ry, n))


def make_mesh2d(rz, ry, axis_names=("z", "y"), device="cuda",
                transport=None):
    """An (rz x ry) mesh of shard slots (placed as :func:`~.mesh.make_mesh`
    places rz ry of them, row-major); under a world of ``rz ry`` ranks the
    mesh of ranks of that shape (:func:`~.mesh.rank_mesh`)."""
    if _world_up():
        return rank_mesh((rz, ry), axis_names, device, transport)
    slots = _slots(rz * ry, device)
    return Mesh(np.asarray(slots, dtype=object).reshape(rz, ry),
                axis_names)


def shard_vector_2d(x, mesh):
    """A flat brick-ordered grid vector as a sharded one (a tensor on the
    home slot; on a mesh of ranks this rank's brick).  Convert
    natural-order vectors with :func:`to_bricks` first and results back
    with :func:`from_bricks`."""
    if mesh.ranked:
        if isinstance(x, ranks.RankShard):
            return x
        x = to_tensor(x, device=mesh.home)
        if x.shape[0] % mesh.size:
            raise ValueError("length %d is not a multiple of the mesh's "
                             "%d bricks" % (x.shape[0], mesh.size))
        L = x.shape[0] // mesh.size
        return ranks.shard(x[mesh.rank * L:(mesh.rank + 1) * L])
    x = to_tensor(x, device=mesh.home)
    if x.shape[0] % mesh.size:
        raise ValueError("length %d is not a multiple of the mesh's %d "
                         "bricks" % (x.shape[0], mesh.size))
    return x


class Halo2DPoissonOperator(LinearOperator):
    """Seven-point 3-D Poisson operator on an (rz x ry) mesh.

    Acts on flat brick-ordered vectors of length n^3 sharded with
    :func:`shard_vector_2d`; applied to a natural-ordered vector it
    computes the permuted product P'APv, not Av.  ``n`` must be
    divisible by both mesh extents.  ``scale`` multiplies the stencil.
    """

    def __init__(self, n, mesh, scale=1.0, dtype=torch.float32, **kwargs):
        az, ay = mesh.axis_names
        rz, ry = mesh.shape[az], mesh.shape[ay]
        if n % rz or n % ry:
            raise ValueError(
                "both mesh extents (%d, %d) must divide the grid n=%d"
                % (rz, ry, n))
        dtype = as_dtype(dtype)
        scale = torch.as_tensor(scale, dtype=dtype, device=mesh.home)
        mm = brick_stencil(mesh, int(n), int(rz), int(ry), scale)
        super().__init__(n ** 3, n ** 3, matvec=lambda x: mm(x[:, None])[:, 0],
                         matmat=mm, symmetric=True, hermitian=True,
                         dtype=dtype, device=mesh.home, params=(scale,),
                         **kwargs)
        self.mesh = mesh
        self.grid_n = n
        # per-brick face-exchange volume per matvec, in elements
        self.comm_elems_per_matvec = 2 * (n // rz + n // ry) * n
