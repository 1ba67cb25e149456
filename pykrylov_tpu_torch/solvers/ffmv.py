"""Compensated (double-f32) matvec resolution for the verified solvers.

Counterpart of ``pykrylov_tpu/solvers/ffmv.py``.  The verified machinery
(ff-CG's and ff-MINRES's ``replace_every``, the refinement drivers of
:mod:`.refine`, the ``verify_final`` certificates) evaluates true
residuals with an error-compensated product when the operator's storage
has one: the plain f32 product floors at ~eps·|A||x| (2.3e-6 relative on
1138bus), above the reference's f64 rtol 1e-6.

The choice follows the storage, as the JAX resolver's does: an ELL
:class:`~..sparse.SparseOperator` (``fmt="ell"``) and a dense
:class:`~..ops.MatrixOperator` have one (the ELL TwoProd/TwoSum cascade
and the column-sequential TwoSum of ``_ff_dense``), and so does the
transpose of either; every other operator has none: the DIA and SELL
kernels' operators (``cuda-dia``, ``BellOperator``), plain ``dia``,
``csr`` and ``coo`` storage, diagonal operators and composites such as
``A - sigma I`` or ``A + B``.  The callers then apply A twice, to the hi
and the lo part, or once to an (n, 2K) block.  The error-free transforms
are real arithmetic, so a complex operator has none either.

A resolved product is a function ``ff(xh, xl) -> (yh, yl)`` bound to the
operator's storage (the JAX package's take the operator's ``_params``).
Where the JAX resolver hands the transpose of an unsymmetric ELL or dense
operator the forward product (its ``_params`` are the forward storage),
this one applies the transpose's own storage.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_ff_matvec", "resolve_ff_matmat", "register_ff_matvec"]

# Operators whose storage the sniff below cannot see (the sharded ones of
# ROADMAP item 19) register their compensated product against the 1-D
# product function their operator applies (``op._mv``).
_MV_REGISTRY = {}


def register_ff_matvec(mv_fn, ff_fn, ff_mm=None):
    """Associate a compensated matvec ``ff_fn(xh, xl)`` (and optionally a
    block product ``ff_mm(Xh, Xl)``) with an operator's product function.
    The default block product applies ``ff_fn`` column by column."""
    if ff_mm is None:
        ff_mm = _columns_of(ff_fn)
    _MV_REGISTRY[mv_fn] = (ff_fn, ff_mm)


def _ff_ell(container):
    from ..sparse import formats as F

    def ff(xh, xl):
        return F.ell_matvec_ff(container, xh, xl)
    return ff


def _ff_dense(a, xh, xl):
    """Compensated dense product: TwoProd of every entry, then a TwoSum
    cascade over the columns in order."""
    from ..utils.ff import two_prod, two_sum
    a = a.to(xh.dtype)
    p, pe = two_prod(a, xh[None, :])
    pe = pe + a * xl[None, :]
    yh = p.new_zeros(a.shape[0])
    yl = p.new_zeros(a.shape[0])
    for j in range(a.shape[1]):
        s, e = two_sum(yh, p[:, j])
        yh, yl = two_sum(s, yl + e + pe[:, j])
    return yh, yl


def _dense(a):
    def ff(xh, xl):
        return _ff_dense(a, xh, xl)
    return ff


def _storage_ff(op, transposed=False):
    """The compensated product of ``op``'s own storage (of its transpose's
    when ``transposed``), or None."""
    from ..sparse import formats as F
    if getattr(op, "fmt", None) == "ell":
        c = op.container_transp if transposed else op.container
        return _ff_ell(c) if isinstance(c, F.ELL) else None
    a = getattr(op, "matrix", None)
    # the JAX resolver's dense sniff matches a transpose only when the
    # stored matrix has the transpose's shape: a square one
    if isinstance(a, torch.Tensor) and a.ndim == 2 \
            and tuple(a.shape) == (op.shape[0], op.shape[1]) \
            and (not transposed or a.shape[0] == a.shape[1]):
        return _dense(a.T if transposed else a)
    return None


def resolve_ff_matvec(A):
    """A compensated matvec ``(xh, xl) -> (yh, yl)`` for the operator's
    storage, or None when it has none (callers then apply A twice,
    limited by the plain product's floor)."""
    reg = _MV_REGISTRY.get(getattr(A, "_mv", None))
    if reg is not None:
        return reg[0]
    if A.dtype.is_complex:
        return None
    ff = _storage_ff(A)
    if ff is None and getattr(A, "_transpose_of", None) is not None:
        ff = _storage_ff(A._transpose_of, transposed=True)
    return ff


def _columns_of(ff_mv):
    def mm(Xh, Xl):
        cols = [ff_mv(Xh[:, j], Xl[:, j]) for j in range(Xh.shape[1])]
        return (torch.stack([c[0] for c in cols], dim=1),
                torch.stack([c[1] for c in cols], dim=1))
    return mm


def resolve_ff_matmat(A):
    """Block counterpart of :func:`resolve_ff_matvec`: a compensated
    product ``(Xh, Xl) -> (Yh, Yl)`` on (n, K) blocks, or None.  It applies
    the compensated matvec column by column, as the JAX package's vmap of
    it does: the verified block path then reads A once a column, trading
    the SpMM's amortization for the certificate."""
    reg = _MV_REGISTRY.get(getattr(A, "_mv", None))
    if reg is not None:
        return reg[1]
    mv = resolve_ff_matvec(A)
    return None if mv is None else _columns_of(mv)
