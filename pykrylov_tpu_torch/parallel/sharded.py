"""Row-block sharding of vectors and sparse operators.

Counterpart of ``pykrylov_tpu/parallel/sharded.py``.  The JAX package puts
a ``NamedSharding`` on the row dimension of containers and vectors and
lets XLA partition the unchanged solver loops.  Here a sharded vector is
one tensor of the padded length on the mesh's home slot, shard k's rows
``[k L, (k+1) L)``; an operator keeps each shard's storage on that
shard's slot, and a product copies each shard's input rows (with the
halo or gathered rows it reads) to the slot, a view where the slot is the
home, runs the local product there and writes the shard's rows of y on
the home.  The solvers do not change: their dots and updates run on the
whole tensors.

Rows are padded to a multiple of the mesh size with zero rows and
columns, so every shard has L rows.  The padding is benign for every
solver: the padded entries of b are zero and the padded block of the
operator is zero, so they stay zero in every Krylov vector.

:func:`shard_operator` is the generic row-block operator (every shard
reads the whole x, the JAX package's XLA all-gather);
:class:`~.halo.HaloDiaOperator` and :class:`~.gather.GatherEllOperator`
exchange only the rows a shard needs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..sparse import formats as F
from ..utils import ranks
from ..utils.types import to_tensor
from .mesh import ROW_AXIS

__all__ = ["shard_vector", "replicate", "shard_operator", "pad_to_multiple",
           "sharded_poisson3d"]


def pad_to_multiple(n, d):
    return (n + d - 1) // d * d


def shard_vector(x, mesh, axis=ROW_AXIS, local=False):
    """A vector (or an (n, K) block) as a sharded one: a tensor on the
    mesh's home slot whose length the mesh axis divides.

    On a mesh of ranks the result is this rank's rows, a
    :class:`~..utils.ranks.RankShard`: ``x`` is the global array (its
    rows ``[rank L, (rank+1) L)`` are taken), this rank's rows already
    (``local=True``), or a rank-sharded tensor (kept)."""
    if mesh.ranked:
        if isinstance(x, ranks.RankShard):
            return x
        x = to_tensor(x, device=mesh.home)
        if not local:
            d = mesh.size
            if x.shape[0] % d:
                raise ValueError("length %d is not a multiple of the %d "
                                 "ranks; pad it first" % (x.shape[0], d))
            L = x.shape[0] // d
            x = x[mesh.rank * L:(mesh.rank + 1) * L]
        return ranks.shard(x)
    x = to_tensor(x, device=mesh.home)
    d = mesh.shape[axis]
    if x.shape[0] % d:
        raise ValueError("length %d is not a multiple of the mesh axis "
                         "%r (%d); pad it first" % (x.shape[0], axis, d))
    return x


def replicate(x, mesh):
    """An array every shard reads (a preconditioner's diagonal, the
    n-side vectors of a tall operator): a tensor on the home slot.  On a
    mesh of ranks every rank holds the whole array: a rank-sharded
    ``x`` (this rank's rows) is all-gathered (:func:`whole`)."""
    if mesh.ranked and isinstance(x, ranks.RankShard):
        return whole(x, mesh)
    return to_tensor(x, device=mesh.home)


def whole(x, mesh):
    """The global rows of a rank-sharded ``x`` on every rank (one
    ``all_gather``), a plain tensor; on a mesh of slots ``x`` itself."""
    if not mesh.ranked:
        return x
    g = mesh.comm.all_gather(ranks.plain(x))
    return g.reshape((-1,) + tuple(g.shape[2:]))


def halo_extend(x, w, mesh):
    """This rank's rows of ``x`` (plain, L rows) with ``w`` rows of each
    neighbour rank on either side, zeros past the global ends: the
    neighbours' boundary rows are received in one exchange (``(w, K)``
    slices for an (L, K) block)."""
    comm = mesh.comm
    r = mesh.rank
    lo = r - 1 if r > 0 else None
    hi = r + 1 if r < mesh.size - 1 else None
    tail = tuple(x.shape[1:])
    if w == 0:
        return x
    sends, recvs = [], []
    if lo is not None:
        sends.append((lo, x[:w]))
        recvs.append((lo, (w,) + tail))
    if hi is not None:
        sends.append((hi, x[-w:]))
        recvs.append((hi, (w,) + tail))
    got = comm.sendrecv(sends, recvs, x)
    below = got.pop(0) if lo is not None else x.new_zeros((w,) + tail)
    above = got.pop(0) if hi is not None else x.new_zeros((w,) + tail)
    return torch.cat([below, x, above])


def rows_on(x, lo, hi, slot):
    """Rows ``[lo, hi)`` of x on ``slot``, zero outside ``[0, len(x))``:
    a view of x where the rows lie inside and the slot is x's device."""
    n = x.shape[0]
    a, b = max(lo, 0), min(hi, n)
    if a == lo and b == hi:
        part = x[lo:hi]
    else:
        part = x.new_zeros((hi - lo,) + tuple(x.shape[1:]))
        if a < b:
            part[a - lo:b - lo] = x[a:b]
    return part.to(slot)


def assemble(mesh, local):
    """The sharded result whose shard k's rows are ``local(k)``, each
    computed with its slot current, gathered on the home slot.  On a mesh
    of ranks: this rank's ``local(rank)``, marked rank-sharded."""
    if mesh.ranked:
        with mesh.on(mesh.rank):
            return ranks.shard(local(mesh.rank))
    pieces = []
    for k in range(mesh.size):
        with mesh.on(k):
            pieces.append(local(k))
    return torch.cat([p.to(mesh.home) for p in pieces])


def dia_local(data_k, offsets, xe, w, L):
    """One shard's shifted-slice DIA product: ``y[r] = sum_d data_k[d, r]
    * xe[w + r + off_d]`` for its L rows, ``xe`` its x rows with w halo
    rows each side (a vector or an (L + 2w, K) block), the diagonals
    added in order, each product and sum rounded on its own."""
    ct = torch.promote_types(data_k.dtype, xe.dtype)
    tail = tuple(xe.shape[1:])
    y = torch.zeros((L,) + tail, dtype=ct, device=xe.device)
    for d, off in enumerate(offsets):
        y.add_(data_k[d].to(ct).reshape((L,) + (1,) * len(tail))
               * xe[w + off:w + off + L].to(ct))
    return y


def _shard_rows(a, mesh, mp, axis_rows=0):
    """Per-slot row blocks of a host array padded to ``mp`` rows along
    ``axis_rows``."""
    a = np.asarray(a)
    shp = list(a.shape)
    shp[axis_rows] = mp
    out = np.zeros(shp, dtype=a.dtype)
    idx = [slice(None)] * a.ndim
    idx[axis_rows] = slice(0, a.shape[axis_rows])
    out[tuple(idx)] = a
    L = mp // mesh.size
    blocks = []
    for k, slot in enumerate(mesh.slots):
        if k not in mesh.shards():
            blocks.append(None)
            continue
        idx[axis_rows] = slice(k * L, (k + 1) * L)
        blocks.append(to_tensor(np.ascontiguousarray(out[tuple(idx)]),
                                device=slot))
    return blocks


def host(a):
    """A tensor (on any device) or an array as a NumPy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class ShardedSparseOperator(LinearOperator):
    """A square ELL or DIA operator row-block sharded over a mesh, padded
    to ``(mp, mp)``: every shard reads the whole x it needs from the home
    slot (the generic path; see :func:`shard_operator`)."""

    def __init__(self, fwd, bwd, mesh, axis=ROW_AXIS, symmetric=False):
        m, _ = fwd.shape
        d = mesh.shape[axis]
        mp = pad_to_multiple(m, d)
        L = mp // d

        def rule(c):
            if isinstance(c, F.ELL):
                data = _shard_rows(host(c.data), mesh, mp)
                cols = _shard_rows(host(c.cols).astype(np.int64), mesh, mp)

                def mv(x):
                    xw = whole(ranks.plain(x), mesh)
                    return assemble(mesh, lambda k: F.ell_matvec(
                        F.ELL(data[k], cols[k], (L, mp)),
                        rows_on(xw, 0, mp, mesh.slots[k])))
                return mv, None, [t for t in data + cols if t is not None]
            offsets = tuple(int(o) for o in c.offsets)
            w = max((abs(o) for o in offsets), default=0)
            data = _shard_rows(host(c.data), mesh, mp, axis_rows=1)

            def mm(x):
                if mesh.ranked:
                    xe = halo_extend(ranks.plain(x), w, mesh)
                    return assemble(mesh, lambda k: dia_local(
                        data[k], offsets, xe, w, L))
                return assemble(mesh, lambda k: dia_local(
                    data[k], offsets,
                    rows_on(x, k * L - w, (k + 1) * L + w, mesh.slots[k]),
                    w, L))
            return mm, mm, [t for t in data if t is not None]

        mv, mm, params = rule(fwd)
        rmv = rmm = None
        if bwd is not None and not symmetric:
            rmv, rmm, more = rule(bwd)
            params = params + more
        dtype = fwd.data.dtype
        super().__init__(mp, mp, matvec=mv, matvec_transp=rmv, matmat=mm,
                         matmat_transp=rmm, symmetric=symmetric,
                         hermitian=symmetric and not dtype.is_complex,
                         dtype=dtype, device=mesh.home,
                         params=tuple(params))
        self.mesh = mesh
        self.fmt = "ell" if isinstance(fwd, F.ELL) else "dia"
        self.pad = mp - m


def shard_operator(op, mesh, axis=ROW_AXIS):
    """Row-block-shard a square operator over ELL or DIA containers (a
    :class:`~..sparse.linop.SparseOperator`, ``fmt`` ``"ell"``,
    ``"dia"`` or ``"cuda-dia"``) over ``mesh``.

    Returns ``(sharded_op, pad)``: the operator acts on vectors of length
    ``m + pad`` (sharded with :func:`shard_vector`); the trailing ``pad``
    entries are structurally zero.  Each shard's product is the plain
    one over its rows."""
    fwd = getattr(op, "container", None)
    if not isinstance(fwd, (F.ELL, F.DIA)):
        raise TypeError(
            "shard_operator expects a SparseOperator over ELL/DIA "
            "containers; got %s (build with fmt='dia'/'ell' to shard)"
            % type(op).__name__)
    m, n = fwd.shape
    if m != n:
        raise ValueError("shard_operator expects a square operator")
    bwd = getattr(op, "container_transp", None)
    sharded = ShardedSparseOperator(fwd, bwd, mesh, axis=axis,
                                    symmetric=op.symmetric)
    return sharded, sharded.pad


def sharded_poisson3d(n, mesh, dtype=np.float64, halo=True,
                      matrix_free=False):
    """The 3-D Poisson system sharded over ``mesh``.

    Returns ``(op, b, exact, pad)`` with ``b = A e``, ``e`` the padded
    ones vector, both sharded.  ``halo=True`` gives the halo-exchange
    :class:`~.halo.HaloDiaOperator`, ``halo=False`` the generic
    :func:`shard_operator` of a DIA operator, ``matrix_free=True`` the
    stencil operator (no stored matrix; the mesh extent must divide n).
    """
    from ..gallery.poisson import poisson3d_coo
    from ..sparse.linop import SparseOperator
    from .halo import HaloDiaOperator

    if matrix_free:
        from .stencil import HaloStencilPoisson3DOperator
        op = HaloStencilPoisson3DOperator(n, mesh, dtype=dtype)
        e = shard_vector(torch.ones(n ** 3, dtype=op.dtype), mesh)
        return op, op * e, e, 0

    if halo and mesh.ranked:
        # this rank's rows only, never the whole matrix
        from ..gallery.poisson import poisson3d_dia_rows
        m = n ** 3
        L = pad_to_multiple(m, mesh.size) // mesh.size
        lo = mesh.rank * L
        data, offsets = poisson3d_dia_rows(n, lo, lo + L, dtype=dtype)
        op = HaloDiaOperator(F.DIA(data, offsets, (m, m)), mesh, local=True)
        e = (np.arange(lo, lo + L) < m).astype(dtype)
        e = shard_vector(e, mesh, local=True)
        return op, op * e, e, op.pad

    vals, rows, cols, shape = poisson3d_coo(n, dtype=dtype)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    dia = F.dia_from_coo(coo, device=None)
    if halo:
        op = HaloDiaOperator(dia, mesh)
        pad = op.pad
    else:
        base = SparseOperator(F.DIA(torch.from_numpy(np.asarray(dia.data)),
                                    dia.offsets, dia.shape),
                              None, symmetric=True)
        op, pad = shard_operator(base, mesh)
    m = shape[0]
    e = np.zeros(m + pad, dtype=dtype)
    e[:m] = 1.0
    e = shard_vector(e, mesh)
    return op, op * e, e, pad
