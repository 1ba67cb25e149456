"""Shared solver plumbing: operator coercion, thresholds, history buffers.

Counterpart of ``pykrylov_tpu/solvers/common.py``.  The reductions over
the rows (:func:`vdot_real`, :func:`dotu`, :func:`vdots_norms`,
:func:`norm`, :func:`sum_rows`, :func:`col_norms`,
:func:`col_vdots_real`) are the global ones of
:mod:`..utils.ranks`: plain torch on plain tensors, one ``all_reduce`` of
the local partials on a mesh of ranks, so no solver body knows about
ranks; :func:`rows` is a vector's global length.  Stopping-rule semantics
follow the reference square-system solvers: ``threshold = max(abstol,
reltol * residNorm0)`` (``cg/cg.py:102``) with a matvec cap defaulting to
2n (``cg/cg.py:97``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.base import BaseLinearOperator, LinearOperator, MatrixOperator
from ..utils import ranks
from ..utils.observe import count, span
from ..utils.ranks import (col_norms, col_vdots_real, norm, rows, sum_rows,
                          vdots_norms)
from ..utils.types import result_type, to_tensor

__all__ = ["as_operator", "as_apply_pair", "apply_op", "apply_op_T",
           "apply_op_H", "vdot_real", "dotu", "vdots_norms", "norm",
           "sum_rows", "col_norms", "col_vdots_real", "rows", "fdiv",
           "finite", "real_dtype", "promote_rhs",
           "threshold_of", "default_maxiter", "history_init", "history_push",
           "history_from", "table_init", "table_push", "table_tensor",
           "require_square", "attach_true_residual",
           "attach_true_lls_residual", "host_read"]


def host_read(t, after=None):
    """``t.tolist()``: a solver's read of device values on the host (a
    synchronisation on a card), inside a ``read`` span and counted as
    ``host_syncs`` (:mod:`..utils.observe`).  A 0-d tensor is read with
    ``item()``, whose copy goes through the caching host allocator's
    pinned memory (``tolist()`` copies to pageable memory); a process's
    first such copy pins a block, which takes milliseconds.  With
    ``after``, an event recorded behind the copy that fills the host
    tensor ``t``, the host waits for that event alone, while the work
    enqueued after it runs on."""
    with span("read"):
        if after is not None:
            after.synchronize()
        v = t.item() if t.dim() == 0 else t.tolist()
    count("host_syncs")
    return v


def as_operator(A) -> LinearOperator:
    """Coerce to a LinearOperator (tensors and arrays become
    MatrixOperator: a tensor stays on its device, an array goes to the
    card)."""
    if isinstance(A, BaseLinearOperator):
        return A
    if isinstance(A, torch.Tensor):
        return MatrixOperator(A, device=A.device)
    if isinstance(A, np.ndarray):
        return MatrixOperator(A)
    raise TypeError("cannot interpret %r as a linear operator" % (type(A),))


def as_apply_pair(A):
    """``(operator, apply, apply_T, apply_H)`` for solvers that need the
    adjoint (the least-squares family)."""
    return as_operator(A), apply_op, apply_op_T, apply_op_H


def apply_op(op, x):
    """``op @ x`` without shape checks or counting (solver inner loops)."""
    return op._mv(x)


def apply_op_T(op, x):
    return op._rmv(x)


def apply_op_H(op, x):
    return op._hmv(x)


def vdot_real(a, b):
    """Real part of the conjugated dot ``a^H b`` (CG's and the Lanczos
    solvers' inner products), a 0-d tensor on the vectors' device."""
    return ranks.vdot_real(a, b)


def dotu(a, b):
    """Unconjugated vector dot, the reference's ``np.dot`` semantics
    (``bicgstab.py:103``, ``cgs.py:83``): for complex operands this is
    sum(a*b), not the inner product.  A 0-d tensor on the vectors' device.
    """
    return ranks.dot(a, b)


def fdiv(a, b):
    """``a / b`` on host floats with IEEE semantics: inf or nan where ``b``
    is zero, as the JAX package's device scalars divide (Python raises)."""
    if b:
        return a / b
    if isinstance(a, complex) or isinstance(b, complex):
        return complex(math.nan, math.nan)
    if a == 0 or math.isnan(a):
        return math.nan
    return math.copysign(math.inf, a) * math.copysign(1.0, b)


def finite(v):
    """``math.isfinite`` for a host float or complex."""
    return math.isfinite(abs(v))


def real_dtype(dtype):
    """The real dtype of ``dtype`` (itself when real)."""
    return dtype.to_real() if dtype.is_complex else dtype


def promote_rhs(b, *ops):
    """Promote b to the joint dtype of the rhs and all participating
    operators, mirroring the reference's NumPy promotion
    (``np.result_type(self.op.dtype, rhs.dtype)``).  A NumPy rhs goes to
    the first operator's device; a tensor stays where it is."""
    if not isinstance(b, torch.Tensor):
        dev = next((o.device for o in ops if o is not None), None)
        b = to_tensor(b, device=dev)
    dt = result_type(b.dtype, *[o.dtype for o in ops if o is not None])
    return b.to(dt)


def threshold_of(resid0, rtol, atol):
    """Reference stopping threshold max(abstol, reltol*resid0)."""
    return torch.maximum(torch.full_like(resid0, atol), rtol * resid0)


def default_maxiter(n, matvecs_per_iter=1, matvec_max=None):
    """Iteration cap from the reference's matvec_max (default 2n)."""
    if matvec_max is None:
        matvec_max = 2 * n
    return max(1, int(matvec_max) // int(matvecs_per_iter))


def history_init(store: bool, maxiter: int, dtype, device, n=None):
    """A NaN-filled (maxiter+1,) buffer, or (maxiter+1, n) when ``n`` is
    given; None when not storing."""
    if not store:
        return None
    shape = (maxiter + 1,) if n is None else (maxiter + 1, n)
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


def history_push(hist, k, value):
    """Write row ``k`` on the device (no host synchronisation)."""
    if hist is not None:
        hist[k] = value
    return hist


def history_from(store, maxiter, values, dtype, device):
    """A NaN-filled (maxiter+1,) buffer holding the host floats ``values``
    in rows 0.. (rows past ``maxiter`` are dropped, as the JAX package's
    out-of-range ``.at[k].set`` drops them); None when not storing."""
    hist = history_init(store, maxiter, dtype, device)
    if hist is not None and values:
        keep = values[:maxiter + 1]
        hist[:len(keep)] = torch.tensor(keep, dtype=dtype)
    return hist


def table_init(store: bool, maxiter: int, dtype, device):
    """Per-iteration telemetry for the ``show`` tables, or None.

    The JAX package records the table's columns in a device buffer inside
    its fused loop and renders it after the solve
    (:mod:`~.show`).  Here the scalar columns are host floats already, so a
    row of them goes to a host list; only the first column, ``x[0]``,
    lives on the device, written into a buffer without a synchronisation.
    On a mesh of ranks ``x[0]`` is the whole iterate's (rank 0's first
    row, :func:`~..utils.ranks.first_row`: one broadcast a row, only while
    a table is kept).
    """
    if not store:
        return None
    return {"x0": history_init(True, maxiter, dtype, device), "rows": {}}


def table_push(tab, k, x0, *cols):
    """Record row ``k``: ``x0`` (a float, or the iterate, whose global
    first row's real part is taken) and host floats."""
    if tab is not None:
        if isinstance(x0, torch.Tensor):
            x0 = ranks.first_row(x0).real
        history_push(tab["x0"], k, x0)
        tab["rows"][k] = cols
    return tab


def table_tensor(tab):
    """The table as the JAX package keeps it: a (maxiter+1, 1+ncols)
    tensor on the device, NaN in the rows past the last iteration."""
    x0, rows = tab["x0"], tab["rows"]
    ncols = len(next(iter(rows.values()))) if rows else 6
    host = torch.full((x0.shape[0], ncols), math.nan, dtype=x0.dtype)
    if rows:
        host[list(rows)] = torch.tensor(list(rows.values()), dtype=x0.dtype)
    return torch.cat([x0[:, None], host.to(x0.device)], dim=1)


def _certified_residual(A, b, x):
    """``b - A x`` for the certificates: through the compensated product
    (:func:`~.ffmv.resolve_ff_matvec`) where the operator's storage has
    one, rounded to the working dtype by an error-free ``two_sum``, else
    plain (the plain f32 product floors at ~eps·|A||x|)."""
    from .ffmv import resolve_ff_matvec
    ff = resolve_ff_matvec(A)
    if ff is None or x.dtype.is_complex:
        return b - apply_op(A, x)
    from ..utils.ff import two_sum
    sh, sl = ff(x, torch.zeros_like(x))
    d, de = two_sum(b, -sh)
    return d + (de - sl)


def attach_true_residual(A, b, res, shift=0.0):
    """Post-solve verification: the 2-norm of the true residual ``b - (A -
    shift I) x``, with the compensated product where the operator's
    storage has one, as ``info["true_resid_norm"]``.  One diagnostic
    matvec, not counted in ``n_matvec``."""
    rt = _certified_residual(A, b, res.x)
    if shift:
        rt = rt + shift * res.x
    res.info["true_resid_norm"] = norm(rt)
    return res


def require_square(A, b, solver_name):
    """Shape guard for square-system solvers: A square, b length-matched."""
    m, n = A.shape
    if m != n:
        raise ValueError(
            "%s expects a square operator, got %dx%d (use lsqr/lsmr/craig "
            "for rectangular systems)" % (solver_name, m, n))
    if b.ndim != 1 or rows(b) != n:
        raise ValueError("%s: rhs has shape %s, expected (%d,)"
                         % (solver_name, (tuple(b.shape),), n))


def attach_true_lls_residual(A, b, res, damp=0.0):
    """Post-solve verification for the least-squares family: the true
    residual ``rt = b - A x`` and the least-squares optimality residual
    ``A' rt - damp^2 x``, the quantity LSQR's ``Arnorm`` and LSMR's
    ``normar`` estimate by recurrence.  Both norms are Euclidean (M and N
    are not folded in: this is the certificate a user would compute), in
    the promoted dtype of the solve; recorded as
    ``info["true_resid_norm"]`` and ``info["true_normar"]``.  Two
    diagnostic matvecs, not counted in ``n_matvec``.  The forward product
    is compensated where the operator's storage has one."""
    rt = _certified_residual(A, b, res.x)
    ar = apply_op_T(A, rt)
    if damp:
        ar = ar - (damp * damp) * res.x
    res.info["true_resid_norm"], res.info["true_normar"] = norm(rt), norm(ar)
    return res
