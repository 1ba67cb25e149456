"""Multi-right-hand-side solves: block-batched CG and one solve per column.

Counterpart of ``pykrylov_tpu/solvers/batched.py`` (``cg_batched``, its
unverified path ``_cg_batched``, and ``solve_columns``).  Solving K
systems one by one streams the operator K times; ``cg_batched`` iterates
on an (n, K) block instead and applies the operator to all K direction
columns at once through its native block product (the DIA and BELL SpMM
kernels read the matrix once for the whole block), so an iteration moves
``A_bytes + K·(x+y)_bytes``.

Each column runs the reference CG recurrence (PyKrylov
``pykrylov/cg/cg.py:113-158``) under a per-column active mask: a column
that has stopped freezes, its ``alpha`` forced to 0 and its direction
carried unchanged, so its iterates follow a single-RHS ``cg`` up to the
reduction order of the dots, while the loop runs until every column has
stopped or the iteration cap is hit.  Each column stops on
``resid_k <= max(atol, rtol·resid0_k)`` over the preconditioned norm
``sqrt(r'M r)``.  As in ``solvers/cg.py`` the loop is eager, with one
host synchronisation per iteration, on whether any column is active.
"""

from __future__ import annotations

import torch

from ..ops.base import ShapeError, _block_apply
from .common import as_operator, default_maxiter, promote_rhs, threshold_of
from .result import SolveResult
from ..utils.types import to_tensor

__all__ = ["cg_batched", "solve_columns", "ISTOP_MSG"]

# cg_batched istop codes (per column)
ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "iteration budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}


def _apply_block(op, X):
    """Block product ``A @ X`` on an (n, K) block, uncounted: the
    operator's native block rule when it has one (one kernel launch
    streams A once for all K columns), else column by column."""
    return _block_apply(op, op._mv, X)


def _col_dot(A, B):
    """Per-column conjugated real inner products ``Re(a_k' b_k)``."""
    return torch.linalg.vecdot(A, B, dim=0).real


def _check_x0(x0, B, name):
    """An initial-guess block: exactly (n, K), or (n,) when the rhs came
    as one column.  A size-matching wrong layout (a (K, n) block) raises
    instead of being reshaped."""
    if x0 is None:
        return None
    x0 = x0 if isinstance(x0, torch.Tensor) else to_tensor(x0,
                                                          device=B.device)
    if tuple(x0.shape) == tuple(B.shape):
        return x0
    if x0.ndim == 1 and B.shape[1] == 1 and x0.shape[0] == B.shape[0]:
        return x0[:, None]
    raise ShapeError("%s: x0 of shape %s does not match the rhs block %s"
                     % (name, tuple(x0.shape), tuple(B.shape)))


def cg_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
               maxiter=None, matvec_max=None, check_curvature=False,
               store_history=False, replace_every=None):
    """Solve SPD ``A X = B`` for an (n, K) block of right-hand sides.

    Each column follows the reference CG recurrence and stopping rule on
    its own, under a per-column freeze mask, while the operator is applied
    to the whole direction block at once.

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.cg`: ``x0`` is an
    (n, K) block and costs one extra block product; a 1-D ``B`` is one
    column.  ``maxiter`` caps BLOCK iterations (default from
    ``matvec_max``, 2n); a column that has stopped freezes and stops
    counting (``info["n_iter_columns"]``).  ``replace_every`` (verified
    per-column stopping) is not ported yet and raises.

    Returns
    -------
    :class:`SolveResult` with per-column fields: ``x`` is (n, K);
    ``converged``/``istop``/``resid_norm``/``resid_norm0`` are (K,);
    ``resid_history`` (when stored) is (maxiter+1, K) with NaN after each
    column's own stop.  ``n_iter`` counts block iterations and
    ``n_matvec`` block products (each applies A to K columns);
    ``info["definite"]`` holds the per-column curvature verdicts and
    ``info["active_at_exit"]`` the columns still running at the cap.
    """
    if replace_every:
        raise NotImplementedError(
            "cg_batched(replace_every=...) is the verified-arithmetic path, "
            "not ported yet: ROADMAP.md queue 1 item 15")
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    if not isinstance(B, torch.Tensor):
        B = to_tensor(B, device=A.device)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        raise ShapeError("cg_batched: operator %r with rhs block %s"
                         % (A, tuple(B.shape)))
    B = promote_rhs(B, A, M)
    if maxiter is None:
        maxiter = default_maxiter(B.shape[0], 1, matvec_max)
    maxiter = int(maxiter)
    X0 = _check_x0(x0, B, "cg_batched")
    dtype, dev = B.dtype, B.device
    K = B.shape[1]

    if X0 is None:
        X = torch.zeros_like(B)
        R = B
        extra = 0
    else:
        X = X0.to(device=dev, dtype=dtype)
        R = B - _apply_block(A, X)
        extra = 1
    Y = _apply_block(M, R) if M is not None else R
    ry = _col_dot(R, Y)
    resid0 = torch.sqrt(torch.clamp(ry, min=0))
    thresh = threshold_of(resid0, rtol, atol)
    hist = None
    if store_history:
        hist = torch.full((maxiter + 1, K), float("nan"), dtype=resid0.dtype,
                          device=dev)
        hist[0] = resid0

    P = Y
    resid = resid0
    active = resid0 > thresh
    definite = torch.ones(K, dtype=torch.bool, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=ry.dtype, device=dev)
    k = 0
    while k < maxiter:
        # the one host sync of the iteration
        any_active, all_active = torch.stack([active.any(),
                                              active.all()]).tolist()
        if not any_active:
            break
        AP = _apply_block(A, P)
        pAp = _col_dot(P, AP)
        bad = active & (pAp <= 0) if check_curvature \
            else torch.zeros_like(active)
        act = active & ~bad
        # frozen columns take alpha = 0 and keep their direction, so every
        # block column they own is carried unchanged
        alpha = torch.where(act, ry / torch.where(pAp == 0, one, pAp), 0)
        X2 = torch.addcmul(X, alpha.to(dtype), P)
        R2 = torch.addcmul(R, alpha.to(dtype), AP, value=-1)
        Y2 = _apply_block(M, R2) if M is not None else R2
        ry2 = _col_dot(R2, Y2)
        beta = torch.where(act, ry2 / torch.where(ry == 0, one, ry), 0)
        P2 = torch.addcmul(Y2, beta.to(dtype), P)
        resid2 = torch.where(act, torch.sqrt(torch.clamp(ry2, min=0)),
                             resid)
        # a non-finite column freezes (single cg's loop test resid > thresh
        # is False for NaN) and reports istop 1
        done = act & ((resid2 <= thresh) | ~torch.isfinite(resid2))
        if hist is not None:
            hist[k + 1] = torch.where(active, resid2, float("nan"))
        if check_curvature or not all_active:
            X = torch.where(act, X2, X)
            R = torch.where(act, R2, R)
            Y = R if M is None else torch.where(act, Y2, Y)
            P = torch.where(act, P2, P)
        else:
            # every column active: the masks would select X2, R2, Y2, P2
            # in full, so the block-wide selects are skipped
            X, R, Y, P = X2, R2, Y2, P2
        ry = torch.where(act, ry2, ry)
        resid = resid2
        iters += active.to(torch.int32)
        definite &= ~bad
        active = act & ~done
        k += 1

    converged = resid <= thresh
    istop = torch.where(converged, 0, torch.where(definite, 1, 2))
    info = {"definite": definite, "n_iter_columns": iters,
            "active_at_exit": active}
    return SolveResult(
        x=X, converged=converged, istop=istop.to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(k + extra, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist, info=info)


def solve_columns(solver, A, B, **kwargs):
    """Run ``solver`` once per column of an (n, K) block ``B`` and return
    the list of :class:`SolveResult`, one per column: the plain loop for
    methods without a block variant.  Nothing is amortized; each column's
    result is that of its own call."""
    A = as_operator(A)
    if not isinstance(B, torch.Tensor):
        B = to_tensor(B, device=A.device)
    if B.ndim != 2:
        raise ValueError("solve_columns expects an (n, K) block, got %s"
                         % (tuple(B.shape),))
    return [solver(A, B[:, j], **kwargs) for j in range(B.shape[1])]
