"""Sharding over a mesh of shard slots: meshes, sharded operators, halo
and gather exchanges.

Counterpart of ``pykrylov_tpu/parallel``.  The JAX package partitions the
system's rows over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  Here one process holds a :class:`~.mesh.Mesh` of shard
slots (devices, which may repeat: P shards can share one card):

  * a sharded vector is one padded tensor on the mesh's home slot, so the
    solvers run unchanged and their dots are whole-tensor reductions;
  * an operator keeps each shard's storage on its slot and computes each
    shard's rows there, from the rows of x the shard needs: a halo for
    banded matrices (:class:`HaloDiaOperator`, one DIA kernel launch a
    shard on the card), a partition-time gather schedule for general
    sparsity (:class:`GatherEllOperator`; :class:`GatherBellOperator`,
    one SELL kernel launch a shard), whole-x for the generic path
    (:func:`shard_operator`), faces for the matrix-free stencils;
  * a tall operator's ``A^T`` sums the shards' partial products in shard
    order (:class:`TallSkinnyOperator`).

Across processes, after :func:`initialize_multihost` starts a world of
``torch.distributed``, :func:`make_mesh` gives a mesh of ranks: one
shard a rank, each operator building and computing only its own shard,
the exchanges through :mod:`.comm` and the solvers' reductions
all-reduced (:mod:`..utils.ranks`); :mod:`.launch` spawns such a world
on one host.
"""

from .mesh import (Mesh, make_mesh, default_mesh, device_mesh_info,
                   initialize_multihost, ROW_AXIS)
from .sharded import (shard_vector, replicate, shard_operator,
                      sharded_poisson3d, pad_to_multiple)
from .halo import HaloDiaOperator
from .stencil import HaloStencilPoisson3DOperator
from .gather import (GatherEllOperator, build_gather_schedule,
                     gather_ell_from_mtx)
from .bell_sharded import GatherBellOperator
from .tall import TallSkinnyOperator
from .halo2d import (Halo2DPoissonOperator, make_mesh2d, shard_vector_2d,
                     to_bricks, from_bricks)

__all__ = [
    "TallSkinnyOperator",
    "make_mesh", "default_mesh", "device_mesh_info",
    "initialize_multihost",
    "shard_vector", "replicate", "shard_operator", "sharded_poisson3d",
    "HaloDiaOperator", "HaloStencilPoisson3DOperator",
    "GatherEllOperator", "build_gather_schedule",
    "GatherBellOperator",
    "Halo2DPoissonOperator", "make_mesh2d", "shard_vector_2d",
    "to_bricks", "from_bricks",
    "Mesh", "ROW_AXIS", "pad_to_multiple", "gather_ell_from_mtx",
]
