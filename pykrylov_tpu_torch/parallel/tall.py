"""Row-sharded rectangular operators for the least-squares family.

Counterpart of ``pykrylov_tpu/parallel/tall.py``.  A tall m x n system
(m much larger than n) takes the tall-skinny decomposition:

  * the rows of A are blocked over the mesh (shard i holds A_i);
  * the n-side vectors (x, v) are replicated: they are small;
  * ``y = A x`` is local to each shard;
  * ``A' u = sum_i A_i' u_i``: each shard's partial product, summed in
    shard order on the home slot (the JAX package's ``psum``), the only
    reduction of an LSQR iteration.

On a mesh of ranks each rank holds its own row block, the n-side vectors
are plain tensors on every rank, and ``A' u``'s partials are
all-gathered and summed in rank order on every rank: the slot mesh's
shard-order sum, bit for bit, the same on every rank.

The local product is a dense row-block product or an ELL gather/scatter
for sparse tall systems.  The m side is padded to a mesh multiple with
zero rows; the n side is not padded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..sparse import formats as F
from ..utils import ranks
from ..utils.types import to_tensor
from .mesh import ROW_AXIS
from .sharded import assemble, host, pad_to_multiple

__all__ = ["TallSkinnyOperator"]


def _psum(mesh, local):
    """``sum_k local(k)`` in shard order on the home slot (on a mesh of
    ranks, of the all-gathered partials, on every rank)."""
    if mesh.ranked:
        with mesh.on(mesh.rank):
            parts = mesh.comm.all_gather(local(mesh.rank))
        acc = parts[0]
        for k in range(1, mesh.size):
            acc = acc + parts[k]
        return acc
    acc = None
    for k in range(mesh.size):
        with mesh.on(k):
            part = local(k).to(mesh.home)
        acc = part if acc is None else acc + part
    return acc


def _promoted(a, x):
    ct = torch.promote_types(a.dtype, x.dtype)
    return a.to(ct), x.to(ct)


class TallSkinnyOperator(LinearOperator):
    """Row-sharded rectangular operator for sharded LSQR, LSMR, CRAIG.

    Parameters
    ----------
    source : a dense (m, n) array or tensor (row-block products), or a
        rectangular ELL or COO container (gather/scatter products); read
        on the host.
    mesh : 1-D :class:`~.mesh.Mesh`; rows are blocked over ``axis``.

    The operator maps replicated length-n vectors to row-sharded
    length-``m + self.pad`` vectors: shard the rhs with
    :func:`~.sharded.shard_vector` (zero tail) and pass n-side vectors as
    plain tensors on the home slot (on a mesh of ranks: the same whole
    vector on every rank).
    """

    def __init__(self, source, mesh, axis=ROW_AXIS, **kwargs):
        d = mesh.shape[axis] if not mesh.ranked else mesh.size

        def own(k, U):
            """Shard k's rows of a row-side vector (this rank's: all of
            them, unmarked)."""
            if mesh.ranked:
                return ranks.plain(U)
            return U[k * L:(k + 1) * L]
        if isinstance(source, F.COO):
            source = F.ell_from_coo(source, device=None)
        if isinstance(source, F.ELL):
            m, n = source.shape
            mp = pad_to_multiple(m, d)
            data, cols = host(source.data), host(source.cols)
            K = data.shape[1]
            dp = np.zeros((mp, K), dtype=data.dtype)
            cp = np.zeros((mp, K), dtype=np.int64)
            dp[:m], cp[:m] = data, cols
            L = mp // d
            dat = [to_tensor(dp[k * L:(k + 1) * L], device=mesh.slots[k])
                   if k in mesh.shards() else None for k in range(d)]
            cl = [to_tensor(cp[k * L:(k + 1) * L], device=mesh.slots[k])
                  if k in mesh.shards() else None for k in range(d)]

            def fwd(k, X):
                a, Xs = _promoted(dat[k], X.to(mesh.slots[k]))
                g = Xs[cl[k]]                    # (L, w) or (L, w, K)
                if X.ndim == 1:
                    return (a * g).sum(dim=1)
                return torch.einsum("rw,rwk->rk", a, g)

            def adj(k, U):
                a, Us = _promoted(dat[k], own(k, U))
                Us = Us.to(mesh.slots[k])
                prods = a * Us[:, None] if U.ndim == 1 \
                    else a[:, :, None] * Us[:, None, :]
                out = prods.new_zeros((n,) + tuple(U.shape[1:]))
                return out.index_add_(0, cl[k].reshape(-1),
                                      prods.reshape((-1,)
                                                    + tuple(U.shape[1:])))
            params = tuple(t for t in dat if t is not None)
            dtype = dp.dtype
        else:
            a = host(source)
            if a.ndim != 2:
                raise ValueError("TallSkinnyOperator expects a 2-D "
                                 "array or an ELL/COO container")
            m, n = a.shape
            mp = pad_to_multiple(m, d)
            L = mp // d
            blocks = [None] * d
            for k in mesh.shards():
                blk = np.zeros((L, n), dtype=a.dtype)
                lo, hi = k * L, min((k + 1) * L, m)
                if lo < hi:
                    blk[:hi - lo] = a[lo:hi]
                blocks[k] = to_tensor(blk, device=mesh.slots[k])

            def fwd(k, X):
                blk, Xs = _promoted(blocks[k], X.to(mesh.slots[k]))
                return blk @ Xs

            def adj(k, U):
                blk, Us = _promoted(blocks[k], own(k, U))
                return blk.T @ Us.to(mesh.slots[k])
            params = tuple(b for b in blocks if b is not None)
            dtype = a.dtype

        def mv(x):
            return assemble(mesh, lambda k: fwd(k, x))

        def mv_t(u):
            return _psum(mesh, lambda k: adj(k, u))

        super().__init__(n, mp, matvec=mv, matvec_transp=mv_t,
                         matmat=mv, matmat_transp=mv_t, symmetric=False,
                         dtype=dtype, device=mesh.home, params=params,
                         **kwargs)
        self.pad = mp - m
        self.mesh = mesh

    @property
    def container(self):
        """Each shard's row block (dense) or ELL values, on its slot."""
        return self._params
