"""This rank's rows of a vector sharded over a mesh of ranks, and the
global reductions over them.

On a mesh of ranks (:func:`~..parallel.mesh.make_mesh` under a world of
``torch.distributed``) a sharded vector holds only this rank's L rows.
It is a :class:`RankShard`: a tensor subclass whose operations keep the
mark, so every Krylov vector derived from a sharded rhs or from a sharded
operator's product is one too, while a replicated vector (a tall
operator's n side) stays a plain tensor.  A reduction over the rows of a
:class:`RankShard` would give this rank's partial only, and a solver that
read it would step wrongly on every rank without an error.  So:

  * the reductions below take the local partial with plain torch and sum
    it over the ranks with one ``all_reduce`` of the mesh's exchange layer
    (:mod:`..parallel.comm`), bound here when the mesh is built
    (:func:`bind`); several scalars an iteration reads together take one
    ``all_reduce`` (:func:`vdots_norms`).  Every rank gets the same bits,
    so every rank takes the same branches;
  * on plain tensors they are the plain torch reductions, unchanged;
  * a reduction over the rows called on a :class:`RankShard` directly
    (``sum``, ``vdot``, ``vector_norm``, ``any``, a matmul contracting
    the rows, ...) raises :class:`RowReductionError`: no partial reaches
    the host.

A norm is the square root of the all-reduced sum of squares, never a sum
of norms; a block's column sums are one ``all_reduce`` of the (K,)
partials.  A product of a block of vectors' rows with a vector or block
(:func:`matmul_rows`, L-BFGS's ``S @ v`` and ``S @ Y^T``) is one
``all_reduce`` of the small partial product.  A solver's report reads
the global first row (:func:`first_row`, one broadcast from rank 0) and
prints on rank 0 only (:func:`leader`).
"""

from __future__ import annotations

import torch

__all__ = ["RankShard", "RowReductionError", "bind", "world", "sharded",
           "shard", "plain", "rows", "all_reduce", "dot", "vdot", "vdot_real",
           "vdots_norms", "norm", "sum_rows", "col_vdots_real", "col_norms",
           "matmul_rows", "gather_ranks", "first_row", "leader"]


class RowReductionError(RuntimeError):
    """A reduction over the rows of a rank-sharded tensor outside the
    global helpers of :mod:`.ranks`."""


_WORLD = None     # the exchange layer of this process's mesh of ranks


def bind(comm):
    """Make ``comm`` the exchange layer the reductions all-reduce through
    (one per process: the world of ``torch.distributed`` is one)."""
    global _WORLD
    _WORLD = comm


def world():
    """The bound exchange layer; raises when no mesh of ranks was built."""
    if _WORLD is None:
        raise RuntimeError("a rank-sharded tensor needs a mesh of ranks: "
                           "build one with make_mesh() after "
                           "initialize_multihost()")
    return _WORLD


def sharded(*ts):
    """True if any argument is a :class:`RankShard`."""
    return any(isinstance(t, RankShard) for t in ts)


def shard(t):
    """``t`` (this rank's rows) marked as rank-sharded (a view)."""
    return t if isinstance(t, RankShard) else t.as_subclass(RankShard)


def plain(t):
    """A rank-sharded tensor's local rows as a plain tensor (a view);
    any other value as it is."""
    return t.as_subclass(torch.Tensor) if isinstance(t, RankShard) else t


def rows(x):
    """The global leading length of ``x``: this rank's rows times the
    ranks for a :class:`RankShard` (every shard holds L rows), else
    ``x.shape[0]``."""
    if isinstance(x, RankShard):
        return x.shape[0] * world().size
    return x.shape[0]


def all_reduce(t):
    """The sum over the ranks of the partial ``t`` (a plain tensor), as a
    new plain tensor on ``t``'s device."""
    return world().all_reduce(t)


def gather_ranks(t):
    """``t`` of every rank stacked in rank order, shape ``(R,) +
    t.shape``, the same on every rank."""
    return world().all_gather(t)


def _global(partial, is_sharded):
    return all_reduce(partial) if is_sharded else partial


def dot(a, b):
    """The unconjugated dot ``sum(a * b)`` over all rows."""
    s = sharded(a, b)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(torch.dot(a, b), s)


def vdot(a, b):
    """The conjugated dot ``a^H b`` over all rows (complex for complex
    operands)."""
    s = sharded(a, b)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(torch.vdot(a, b), s)


def vdot_real(a, b):
    """The real part of ``a^H b`` over all rows (the partial's real part
    is all-reduced)."""
    s = sharded(a, b)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(torch.vdot(a, b).real, s)


def vdots_norms(pairs, vecs):
    """``[Re(a^H b) for (a, b) in pairs]`` and ``[norm(v) for v in
    vecs]``, as two lists of 0-d tensors: the plain reductions on plain
    tensors; on a mesh of ranks one ``all_reduce`` of all the partials
    (the sums of squares), the norms their square roots."""
    if not sharded(*(t for p in pairs for t in p), *vecs):
        return ([torch.vdot(a, b).real for a, b in pairs],
                [torch.linalg.vector_norm(v) for v in vecs])
    with torch._C.DisableTorchFunctionSubclass():
        part = torch.stack([torch.vdot(a, b).real for a, b in pairs]
                           + [torch.vdot(v, v).real for v in vecs])
        g = all_reduce(part)
    k = len(pairs)
    return list(g[:k]), list(torch.sqrt(g[k:]))


def norm(v):
    """The 2-norm over all rows: ``torch.linalg.vector_norm`` on a plain
    tensor; on a rank-sharded one the square root of the all-reduced sum
    of squares."""
    if not isinstance(v, RankShard):
        return torch.linalg.vector_norm(v)
    with torch._C.DisableTorchFunctionSubclass():
        return torch.sqrt(all_reduce(torch.vdot(v, v).real))


def sum_rows(X):
    """``X.sum(0)`` over all rows (a block's column sums: one
    ``all_reduce`` of the (K,) partials)."""
    s = sharded(X)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(X.sum(0), s)


def col_vdots_real(A, B):
    """``Re(a_k^H b_k)`` for each column pair of two (n, K) blocks over
    all rows (one ``all_reduce`` of the (K,) partials)."""
    s = sharded(A, B)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(torch.linalg.vecdot(A, B, dim=0).real, s)


def col_norms(X):
    """The 2-norm of each column of an (n, K) block over all rows."""
    if not isinstance(X, RankShard):
        return torch.linalg.vector_norm(X, dim=0)
    with torch._C.DisableTorchFunctionSubclass():
        sq = (X.conj() * X).real if X.is_complex() else X * X
        return torch.sqrt(all_reduce(sq.sum(0)))


def matmul_rows(A, B):
    """``A @ B`` contracting the rows of a block of vectors: ``A`` is (m,
    L), m vectors' rows (on a mesh of ranks this rank's L), ``B`` is (L,)
    or (L, k) (a vector, a block, or another block's transpose).  On a
    mesh of ranks one ``all_reduce`` of the (m,) or (m, k) partial; on
    plain tensors the plain product."""
    s = sharded(A, B)
    with torch._C.DisableTorchFunctionSubclass():
        return _global(A @ B, s)


def first_row(x):
    """``x[0]`` of the whole vector: on a rank-sharded ``x`` rank 0's row
    0, broadcast to every rank (one collective); else ``x[0]``."""
    if not isinstance(x, RankShard):
        return x[0]
    with torch._C.DisableTorchFunctionSubclass():
        return world().broadcast(x[0], 0)


def leader(*ts):
    """True where a solve's report is printed: always for plain tensors,
    on rank 0 only when any argument is rank-sharded."""
    return not sharded(*ts) or world().rank == 0


# -- the net -----------------------------------------------------------------

def _fns(*names):
    out = set()
    for n in names:
        for owner in (torch, torch.Tensor, torch.linalg):
            f = getattr(owner, n, None)
            if f is not None:
                out.add(f)
    return frozenset(out)


# reductions whose ``dim`` argument says whether they cross the rows
_REDUCE = _fns("sum", "nansum", "mean", "nanmean", "prod", "amax", "amin",
               "max", "min", "argmax", "argmin", "any", "all",
               "count_nonzero", "norm", "vector_norm", "logsumexp", "std",
               "var", "cumsum", "cumprod", "median")
# their ``dim`` position after the input
_DIM_AT_2 = _fns("norm", "vector_norm")
# contractions: dot products and matrix products
_CONTRACT = _fns("dot", "vdot", "vecdot", "inner", "mv", "matmul", "mm",
                 "bmm", "einsum", "tensordot", "__matmul__", "__rmatmul__")


def _crosses_rows(func, args, kwargs):
    if func in _CONTRACT:
        flat = []
        for a in args:
            flat.extend(a if isinstance(a, (list, tuple)) else [a])
        name = getattr(func, "__name__", "")
        if name in ("matmul", "__matmul__", "mm"):
            a, b = args[0], args[1]
            return (isinstance(b, RankShard)
                    or (isinstance(a, RankShard) and a.ndim == 1))
        if name == "__rmatmul__":
            return isinstance(args[0], RankShard)
        return any(isinstance(t, RankShard) for t in flat)
    x = args[0] if args else kwargs.get("input")
    if not isinstance(x, RankShard):
        return False
    at = 2 if func in _DIM_AT_2 else 1
    if "dim" in kwargs:
        d = kwargs["dim"]
    elif len(args) > at:
        d = args[at]
        if isinstance(d, torch.Tensor):      # max(a, b): elementwise
            return False
    else:
        d = None
    if d is None:
        return True
    dims = d if isinstance(d, (list, tuple)) else (d,)
    return any(int(k) % max(x.ndim, 1) == 0 for k in dims)


class RankShard(torch.Tensor):
    """This rank's rows of a tensor sharded over a mesh of ranks.

    Operations keep the mark (torch's default subclass propagation); a
    reduction over the rows raises :class:`RowReductionError` (use the
    helpers of :mod:`.ranks`, which all-reduce).  Operators strip the mark
    at their input (:func:`plain`) and put it on their output
    (:func:`shard`)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in _REDUCE or func in _CONTRACT) \
                and _crosses_rows(func, args, kwargs):
            raise RowReductionError(
                "%s over the rows of a rank-sharded tensor gives this "
                "rank's partial only; use the global reductions of "
                "pykrylov_tpu_torch.utils.ranks"
                % getattr(func, "__name__", func))
        return super().__torch_function__(func, types, args, kwargs)
