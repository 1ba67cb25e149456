"""Halo-exchange DIA operator over a mesh of shards.

Counterpart of ``pykrylov_tpu/parallel/halo.py``.  The matrix is stored
in DIA format, row-block partitioned: shard k owns rows ``[k L, (k+1) L)``
of every diagonal.  A product needs only ``w = max|offset|`` boundary
rows of x from each neighbour, so each shard reads its own block of x
with w halo rows on each side (zeros past the global ends), a view of the
home tensor where the slot is the home, and multiplies locally.  The JAX
package exchanges the halo slices with ``ppermute``; on a mesh of slots
the exchange is the copy of those rows to the shard's slot.

The local product: each shard's diagonals are packed once over its
halo-extended block of ``L + 2w`` rows (rows ``[w, w + L)`` hold the
shard's diagonals, the rest are zero), and each product is one
:func:`~..sparse.kernels.dia_matvec` per shard on the extended x (one
:func:`~..sparse.kernels.dia_matmat` for an (n, K) block), whose rows
``[w, w + L)`` are the shard's rows of y.  The wrappers launch the DIA
kernels on card shards and run their plain versions on CPU shards, so a
mesh on the card always takes the kernel; ``kernel`` is accepted for the
JAX signature and chooses nothing.  On a mesh of ranks each rank packs
only its own block the same way, receives the ``w`` boundary rows of each
neighbour rank (``(w, K)`` slices for a block) in one exchange
(:func:`~.sharded.halo_extend`) and launches one kernel on its card.
The TPU kernel's 128-lane layout and block rounding have no
counterpart.  The operator also registers a
compensated (double-f32) product with
:func:`~..solvers.ffmv.register_ff_matvec`, so the verified solvers
certify sharded systems at full strength.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.base import LinearOperator
from ..sparse import formats as F
from ..sparse import kernels as K
from ..utils import ranks
from ..utils.types import to_tensor
from .mesh import ROW_AXIS
from .sharded import assemble, halo_extend, host, pad_to_multiple, rows_on

__all__ = ["HaloDiaOperator"]


def _halo_ff(mesh, shards, offsets, w, L):
    """Compensated halo product ``(xh, xl) -> (yh, yl)``: per shard, the
    TwoProd/TwoSum shifted-slice cascade over its diagonals (columns
    ``[w, w + L)`` of its extended storage) on the (hi, lo) halo-extended
    x.  On a mesh of ranks the (hi, lo) halos travel in one message."""
    from ..utils.ff import two_prod, two_sum

    def extended(k, xh, xl):
        if mesh.ranked:
            both = halo_extend(torch.stack([ranks.plain(xh),
                                            ranks.plain(xl)], dim=1), w,
                               mesh)
            return both[:, 0], both[:, 1]
        slot = mesh.slots[k]
        return (rows_on(xh, k * L - w, (k + 1) * L + w, slot),
                rows_on(xl, k * L - w, (k + 1) * L + w, slot))

    def local(k, xh, xl):
        data = shards[k][:, w:w + L]
        xph, xpl = extended(k, xh, xl)
        yh = xph.new_zeros(L)
        yl = xph.new_zeros(L)
        for d, off in enumerate(offsets):
            dk = data[d].to(xph.dtype)
            gh = xph[w + off:w + off + L]
            gl = xpl[w + off:w + off + L]
            p, pe = two_prod(dk, gh)
            pe = pe + dk * gl
            s, e = two_sum(yh, p)
            yh, yl = two_sum(s, yl + e + pe)
        return torch.stack([yh, yl])

    def ff(xh, xl):
        y = assemble(mesh, lambda k: local(k, xh, xl).T)
        return y[:, 0].contiguous(), y[:, 1].contiguous()

    return ff


class HaloDiaOperator(LinearOperator):
    """Symmetric banded operator whose products exchange halo rows.

    Parameters
    ----------
    dia : square :class:`~..sparse.formats.DIA` container (NumPy arrays or
        tensors on any device; it is read on the host).
    mesh : 1-D :class:`~.mesh.Mesh`; rows are blocked over ``axis``.
    kernel : ``"auto"``, True or False, for the JAX signature: the local
        product is always the DIA kernel's wrapper (see the module
        docstring).

    local : on a mesh of ranks, ``dia.data`` holds this rank's L rows
        only (``(ndiag, L)``, rows ``[rank L, (rank+1) L)`` of the matrix
        of shape ``dia.shape``, zero past its end), so no rank builds the
        whole matrix.

    The operator acts on vectors of length ``m + self.pad`` sharded with
    :func:`~.sharded.shard_vector`; the padded tail is structurally zero.
    The offsets must be symmetric about 0 (the values' symmetry is the
    caller's contract, as for every gallery stencil).
    """

    def __init__(self, dia: F.DIA, mesh, axis=ROW_AXIS, kernel="auto",
                 local=False, **kwargs):
        m, n = dia.shape
        if m != n:
            raise ValueError("HaloDiaOperator expects a square operator")
        n_dev = mesh.shape[axis]
        mp = pad_to_multiple(m, n_dev)
        L = mp // n_dev
        w = max((abs(o) for o in dia.offsets), default=0)
        if w > L:
            raise ValueError(
                "matrix bandwidth %d exceeds rows-per-device %d; "
                "use fewer devices or the ELL fallback" % (w, L))
        symmetric_offsets = set(dia.offsets) == {-o for o in dia.offsets}
        if not symmetric_offsets:
            raise ValueError("offsets must be symmetric about 0; got %s"
                             % (dia.offsets,))
        src = host(dia.data)
        if local and not mesh.ranked:
            raise ValueError("local=True needs a mesh of ranks")
        if local and src.shape[1] != L:
            raise ValueError("local storage holds %d rows; this rank owns "
                             "%d" % (src.shape[1], L))
        offsets_t = tuple(int(o) for o in dia.offsets)
        ndiag = src.shape[0]

        if kernel not in ("auto", True, False):
            raise ValueError("kernel must be 'auto', True or False; got %r"
                             % (kernel,))
        # rows m..mp are zero on every diagonal, so nothing leaks from the
        # padding into the last shard's halo
        shards = [None] * mesh.size
        for k in mesh.shards():
            blk = np.zeros((ndiag, L + 2 * w), dtype=src.dtype)
            if local:
                blk[:, w:w + L] = src
            else:
                hi = min((k + 1) * L, m)
                if k * L < hi:
                    blk[:, w:w + hi - k * L] = src[:, k * L:hi]
            shards[k] = to_tensor(blk, device=mesh.slots[k])

        def extended(k, x):
            if mesh.ranked:
                return halo_extend(ranks.plain(x), w, mesh)
            return rows_on(x, k * L - w, (k + 1) * L + w, mesh.slots[k])

        def product(k, x):
            xe = extended(k, x)
            if x.ndim == 1:
                return K.dia_matvec(shards[k], offsets_t, xe)[w:w + L]
            return K.dia_matmat(shards[k], offsets_t, xe)[w:w + L]

        def mv(x):
            return assemble(mesh, lambda k: product(k, x))

        from ..solvers.ffmv import register_ff_matvec
        register_ff_matvec(mv, _halo_ff(mesh, shards, offsets_t, w, L))

        is_complex = np.issubdtype(src.dtype, np.complexfloating)
        super().__init__(mp, mp, matvec=mv, matmat=mv, symmetric=True,
                         hermitian=not is_complex, dtype=src.dtype,
                         device=mesh.home,
                         params=tuple(t for t in shards if t is not None),
                         **kwargs)
        self.pad = mp - m
        self.mesh = mesh
        self.offsets = dia.offsets
        self.halo_width = w
        # the products launch the DIA kernels (card shards), not their
        # plain versions (CPU shards)
        self.local_kernel = mesh.home.type == "cuda"

    @property
    def container(self):
        """Each shard's diagonal storage, on its slot: (ndiag, L + 2w)
        over its halo-extended block, rows ``[w, w + L)`` its own (on a
        mesh of ranks: this rank's only)."""
        return self._params
