"""Multi-right-hand-side solves: the block-batched Krylov solvers and one
solve per column.

Counterpart of ``pykrylov_tpu/solvers/batched.py``: ``cg_batched``,
``cg_pipelined_batched``, ``bicgstab_batched``, ``cgs_batched``,
``tfqmr_batched``, ``minres_batched``, ``symmlq_batched``,
``lsqr_batched``, ``lsmr_batched``, ``craig_batched``,
``craigmr_batched`` and ``solve_columns``.  Solving K systems one by one streams the operator K
times; a batched solver iterates on an (n, K) block instead and applies
the operator (and, for the least-squares family, its transpose) to all K
columns at once through its native block product (the DIA and SELL SpMM
kernels read the matrix once for the whole block), so an iteration moves
``A_bytes + K·(x+y)_bytes`` a product.

Each column runs its single-RHS solver's reference recurrence and stop
tests under a per-column active mask: a column that has stopped freezes
(every block column and scalar it owns is carried unchanged) while the
loop runs until every column has stopped or the iteration cap is hit.
The loops are eager, with one host synchronisation an iteration, on
whether any column is still active (and whether all are, which lets a
select over the whole block be skipped).  Unlike the port's single
solvers, whose recurrences run on host floats, every per-column scalar
here is a (K,) tensor in the block's dtype, as in the JAX package's
``while_loop`` bodies, and every per-column decision is a
``torch.where``; each product the JAX body applies to the whole block is
applied every iteration here too, so the products an iteration are fixed
per solver:

  * ``cg_batched``, ``minres_batched``: one A product;
  * ``cg_pipelined_batched``: one, and one before the loop;
  * ``bicgstab_batched``, ``cgs_batched``: two; ``tfqmr_batched``: two,
    and one before the loop;
  * ``symmlq_batched``: one, and one before and one after the loop;
  * ``lsqr_batched``, ``lsmr_batched``, ``craig_batched``,
    ``craigmr_batched``: one A and one A^T product, and one A^T before
    the loop;

plus one for an ``x0`` block, and the preconditioners' applies.  With
``replace_every`` (the verified twins of ``cg_batched`` and
``minres_batched``) a verification event adds one (n, 2K) product of
``[X, X_lo]``, and ff-MINRES's Lanczos step is itself one (n, 2K)
product (where the operator's storage has no compensated product); the
host reads once an iteration and once more after a verification.
"""

from __future__ import annotations

import torch

from ..ops.base import ShapeError, _block_apply
from .block_cg import BlockCG, takes as _fused
from .common import (as_operator, col_norms, col_vdots_real, default_maxiter,
                     history_init, host_read, promote_rhs, real_dtype, rows,
                     sum_rows, threshold_of)
from .ffmv import resolve_ff_matmat
from .result import SolveResult
from ..utils.ff import (ff_add_ff, ff_div, ff_hypot, ff_mul, ff_sqrt,
                        ff_vdot_cols, two_prod, two_sum)
from ..utils.observe import count, span
from ..utils.types import to_tensor

__all__ = ["cg_batched", "cg_pipelined_batched", "bicgstab_batched",
           "cgs_batched", "tfqmr_batched", "minres_batched", "symmlq_batched", "lsqr_batched",
           "lsmr_batched", "craig_batched", "craigmr_batched",
           "solve_columns", "ISTOP_MSG", "ISTOP_MSG_TF", "ISTOP_MSG_LSQR",
           "ISTOP_MSG_MINRES", "ISTOP_MSG_SYMMLQ", "ISTOP_MSG_CRAIG",
           "ISTOP_MSG_CRAIGMR"]

# cg_batched istop codes (per column); the other batched solvers' columns
# follow the tables re-exported below
ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "iteration budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}

from .lsqr import ISTOP_MSG as ISTOP_MSG_LSQR  # noqa: E402
from .minres import ISTOP_MSG as ISTOP_MSG_MINRES  # noqa: E402
from .symmlq import ISTOP_MSG as ISTOP_MSG_SYMMLQ  # noqa: E402
from .craig import ISTOP_MSG as ISTOP_MSG_CRAIG  # noqa: E402
from .craigmr import ISTOP_MSG as ISTOP_MSG_CRAIGMR  # noqa: E402

# shared by bicgstab_batched, cgs_batched and tfqmr_batched (breakdown code
# 3 matches the single-RHS solvers' tables)
ISTOP_MSG_TF = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "iteration budget exhausted before convergence",
    3: "breakdown: recurrence scalar vanished / residual not finite",
}


def _apply_block(op, X):
    """Block product ``A @ X`` on an (n, K) block, uncounted: the
    operator's native block rule when it has one (one kernel launch
    streams A once for all K columns), else column by column."""
    return _block_apply(op, op._mv, X)


def _apply_block_T(op, X):
    """Block product ``A^T @ X``: the operator's transpose block rule
    (``matmat_transp``, one launch) when it has one, else column by
    column."""
    return _block_apply(op, op._rmv, X)


def _col_dot(A, B):
    """Per-column conjugated real inner products ``Re(a_k' b_k)``."""
    return col_vdots_real(A, B)


def _dotu_cols(A, B):
    """Per-column unconjugated dots, the reference's ``np.dot`` semantics
    (``bicgstab.py:103``): ``sum(a_k * b_k)``, not the inner product, for
    complex columns (``torch.linalg.vecdot`` conjugates its first
    argument)."""
    return sum_rows(A * B)


def _col_norm(X):
    return col_norms(X)


def _safe(x):
    """``x`` with its zeros replaced by one: a divisor whose zero case a
    mask discards."""
    return torch.where(x == 0, 1, x)


def _poll(active):
    """The iteration's one host read: whether any column is active and
    whether all are (:func:`~.common.host_read`)."""
    return host_read(torch.stack([active.any(), active.all()]))


def _sel(all_on, mask, new, old):
    """``torch.where(mask, new, old)``, skipped when the host already knows
    ``mask`` is all true (the select would copy ``new`` whole)."""
    return new if all_on else torch.where(mask, new, old)


def _block_rhs(name, A, B, *ops, square=True):
    """Coerce the operator, the preconditioners ``ops`` and the rhs block
    (a 1-D ``B`` is one column), check the shapes, and promote ``B`` to
    the joint dtype (``promote_rhs``)."""
    A = as_operator(A)
    ops = [as_operator(o) if o is not None else None for o in ops]
    if not isinstance(B, torch.Tensor):
        B = to_tensor(B, device=A.device)
    if B.ndim == 1:
        B = B[:, None]
    need = A.shape[1] if square else A.shape[0]
    if (B.ndim != 2 or rows(B) != need
            or (square and A.shape[0] != A.shape[1])):
        raise ShapeError("%s: operator %r with rhs block %s"
                         % (name, A, tuple(B.shape)))
    return (A, promote_rhs(B, A, *ops)) + tuple(ops)


def _history(store, rows, first):
    """A NaN-filled (rows, K) history with ``first`` in row 0, or None."""
    hist = history_init(store, rows - 1, first.dtype, first.device,
                        n=first.shape[0])
    if hist is not None:
        hist[0] = first
    return hist


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
               store_history=False, replace_every=None, leg_rtol=1e-2):
    """Solve SPD ``A X = B`` for an (n, K) block of right-hand sides.

    Each column follows the reference CG recurrence and stopping rule on
    its own, under a per-column freeze mask, while the operator is applied
    to the whole direction block at once.

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.cg`: ``x0`` is an
    (n, K) block and costs one extra block product; a 1-D ``B`` is one
    column.  ``maxiter`` caps BLOCK iterations (default from
    ``matvec_max``, 2n); a column that has stopped freezes and stops
    counting (``info["n_iter_columns"]``).

    ``replace_every`` turns on verified per-column stopping, the block
    counterpart of single ``cg``'s ff-CG (:func:`_cg_batched_verified`):
    X and R ride double-f32 (hi, lo) blocks, each column refines in
    ``leg_rtol`` legs from its own last verified residual and stops only on
    a recomputed true residual, in the plain 2-norm.

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
    A, B, M = _block_rhs("cg_batched", A, B, M)
    if maxiter is None:
        maxiter = default_maxiter(rows(B), 1, matvec_max)
    maxiter = int(maxiter)
    X0 = _check_x0(x0, B, "cg_batched")
    if replace_every:
        return _cg_batched_verified(A, B, X0, M, rtol, atol, maxiter,
                                    check_curvature, store_history,
                                    int(replace_every), float(leg_rtol),
                                    resolve_ff_matmat(A))
    if _fused(B):
        return _cg_batched_fused(A, B, X0, M, rtol, atol, maxiter,
                                 check_curvature, store_history)
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
    hist = _history(store_history, maxiter + 1, resid0)

    P = Y
    resid = resid0
    active = resid0 > thresh
    definite = torch.ones(K, dtype=torch.bool, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=ry.dtype, device=dev)
    k = 0
    # the one host sync an iteration, at its end (and one before the loop)
    any_active, all_active = _poll(active) if maxiter > 0 else (False, False)
    while k < maxiter and any_active:
        with span("cg_batched.iter"):
            with span("product"):
                AP = _apply_block(A, P)
            with span("dots"):
                pAp = _col_dot(P, AP)
            with span("update"):
                bad = active & (pAp <= 0) if check_curvature \
                    else torch.zeros_like(active)
                act = active & ~bad
                # frozen columns take alpha = 0 and keep their direction,
                # so every block column they own is carried unchanged
                alpha = torch.where(act, ry / torch.where(pAp == 0, one, pAp),
                                    0)
                X2 = torch.addcmul(X, alpha.to(dtype), P)
                R2 = torch.addcmul(R, alpha.to(dtype), AP, value=-1)
            if M is not None:
                with span("product"):
                    Y2 = _apply_block(M, R2)
            else:
                Y2 = R2
            with span("dots"):
                ry2 = _col_dot(R2, Y2)
                resid2 = torch.where(act, torch.sqrt(torch.clamp(ry2, min=0)),
                                     resid)
            with span("direction"):
                beta = torch.where(act, ry2 / torch.where(ry == 0, one, ry),
                                   0)
                P2 = torch.addcmul(Y2, beta.to(dtype), P)
            with span("select"):
                # a non-finite column freezes (single cg's loop test resid >
                # thresh is False for NaN) and reports istop 1
                done = act & ((resid2 <= thresh) | ~torch.isfinite(resid2))
                if hist is not None:
                    hist[k + 1] = torch.where(active, resid2, float("nan"))
                if check_curvature or not all_active:
                    X = torch.where(act, X2, X)
                    R = torch.where(act, R2, R)
                    Y = R if M is None else torch.where(act, Y2, Y)
                    P = torch.where(act, P2, P)
                else:
                    # every column active: the masks would select X2, R2,
                    # Y2, P2 in full, so the block-wide selects are skipped
                    X, R, Y, P = X2, R2, Y2, P2
                ry = torch.where(act, ry2, ry)
                resid = resid2
                iters += active.to(torch.int32)
                definite &= ~bad
                active = act & ~done
            k += 1
            count("cg_batched.plain")
            if k < maxiter:
                any_active, all_active = _poll(active)

    converged = resid <= thresh
    istop = torch.where(converged, 0, torch.where(definite, 1, 2))
    info = {"definite": definite, "n_iter_columns": iters,
            "active_at_exit": active}
    return SolveResult(
        x=X, converged=converged, istop=istop.to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(k + extra, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist, info=info)


def _cg_batched_fused(A, B, X0, M, rtol, atol, maxiter, check_curvature,
                      store_history):
    """:func:`cg_batched` on a card, its vector work in the three in-place
    passes of :mod:`.block_cg` (``csrc/block_cg.cu``): an iteration is the
    block product, ``coldot`` (P'AP and alpha), ``update_r`` (R and,
    without M, R'R and the stop tests), M's product and ``coldot`` (R'Y
    and the stop tests) when M is given, ``update_xp`` (X and P), and the
    host's read of the two flags.

    X, R and P are the solve's own blocks: R starts as a copy of B, which
    is never written, and P as a copy of the preconditioned residual; each
    iteration's AP is dropped before the next product, so four blocks are
    live (five with M).  The flags the host reads are copied before
    ``update_xp`` is enqueued, so that the next product's launch overlaps
    it.  The per-column rules are the torch path's."""
    dtype, dev = B.dtype, B.device
    if X0 is None:
        X = torch.zeros(B.shape, dtype=dtype, device=dev)
        R = torch.empty(B.shape, dtype=dtype, device=dev).copy_(B)
        extra = 0
    else:
        X = torch.empty(B.shape, dtype=dtype, device=dev).copy_(X0)
        R = (B - _apply_block(A, X)).to(dtype).contiguous()
        extra = 1
    Y = _apply_block(M, R) if M is not None else R
    ry = _col_dot(R, Y)
    resid0 = torch.sqrt(torch.clamp(ry, min=0))
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)
    active = resid0 > thresh
    cg = BlockCG(X, R, torch.empty_like(R).copy_(Y), ry, resid0, thresh,
                 active, check_curvature)
    del Y
    k = 0
    any_active = _poll(active)[0] if maxiter > 0 else False
    # the stream and the device are taken once a solve
    with torch.cuda.device(dev):
        while k < maxiter and any_active:
            row = None if hist is None else hist[k + 1]
            with span("cg_batched.iter"):
                with span("product"):
                    AP = _apply_block(A, cg.P)
                with span("dots"):
                    cg.coldot(cg.P, AP)
                with span("update"):
                    cg.update_r(AP, sums=M is None, hist_row=row)
                del AP
                Y = cg.R
                if M is not None:
                    with span("product"):
                        Y = _apply_block(M, cg.R)
                    with span("dots"):
                        cg.coldot(cg.R, Y, beta=True, hist_row=row)
                k += 1
                if k < maxiter:
                    cg.send_flags()
                with span("direction"):
                    cg.update_xp(Y)
                del Y
                count("cg_batched.fused")
                if k < maxiter:
                    any_active = cg.read_flags()[0]

    converged = cg.resid <= thresh
    istop = torch.where(converged, 0, torch.where(cg.definite, 1, 2))
    info = {"definite": cg.definite, "n_iter_columns": cg.iters,
            "active_at_exit": cg.active}
    return SolveResult(
        x=cg.X, converged=converged, istop=istop.to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(k + extra, dtype=torch.int32, device=dev),
        resid_norm=cg.resid, resid_norm0=resid0, resid_history=hist,
        info=info)


def cg_pipelined_batched(A, B, *, x0=None, M=None, rtol=1.0e-6,
                         atol=1.0e-8, maxiter=None, matvec_max=None,
                         replace_every=0, store_history=False):
    """Solve SPD ``A X = B`` by pipelined (communication-hiding) CG, the
    block twin of :func:`~.pipelined.cg_pipelined` (JAX
    ``solvers/batched.py:2260-2400``).

    Each column runs the single-rhs pipelined recurrence under a
    per-column freeze mask, with its scalars in (K,) tensors; the two
    per-column dot blocks share their operands, and ``M W`` and ``A (M W)``
    are one block product an iteration, applied whatever the columns'
    states, as in the JAX body (the last iteration's too: ``n_matvec`` is
    ``n_iter + 1``, plus one for ``x0``).  ``replace_every`` restores every
    coupled recurrence of the active columns every k iterations, 4 block
    products and 2 preconditioner applies each time, which the JAX
    package's ``n_matvec`` does not count.

    A column that stops, or has stopped, takes ``alpha = beta = 0``, so
    its X, R, U and W are carried unchanged (``v + 0 * d`` is ``v`` for
    finite values) without a block select; its Z, Q, S and P move, but
    with its scalars frozen nothing of the column reads them again.  The
    host reads once an iteration, whether any column is active.
    """
    A, B, M = _block_rhs("cg_pipelined_batched", A, B, M)
    if maxiter is None:
        maxiter = default_maxiter(rows(B), 1, matvec_max)
    maxiter, replace_every = int(maxiter), int(replace_every)
    X0 = _check_x0(x0, B, "cg_pipelined_batched")
    dtype, dev = B.dtype, B.device
    K = B.shape[1]

    def precon(V):
        return _apply_block(M, V) if M is not None else V

    if X0 is None:
        X = torch.zeros_like(B)
        R = B
        extra = 0
    else:
        X = X0.to(device=dev, dtype=dtype)
        R = B - _apply_block(A, X)
        extra = 1
    U = precon(R)
    W = _apply_block(A, U)
    gamma = _col_dot(R, U)
    resid0 = torch.sqrt(torch.abs(gamma))
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)

    Z = Q = S = P = torch.zeros_like(B)
    alpha = torch.ones_like(gamma)
    resid = resid0
    active = resid0 > thresh
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    k = 0
    while k < maxiter:
        if not _poll(active)[0]:                   # the one host sync
            break
        gamma2 = _col_dot(R, U)
        delta = _col_dot(W, U)
        resid2 = torch.where(active, torch.sqrt(torch.abs(gamma2)), resid)
        act = active & ~(resid2 <= thresh)
        Mw = precon(W)
        Nv = _apply_block(A, Mw)
        if k == 0:
            beta = torch.zeros_like(gamma2)
            den = delta
        else:
            beta = gamma2 / _safe(gamma)
            den = delta - beta * gamma2 / _safe(alpha)
        alpha2 = torch.where(act, gamma2 / _safe(den), 0).to(dtype)
        beta = torch.where(act, beta, 0).to(dtype)
        Z = torch.addcmul(Nv, beta, Z)
        Q = torch.addcmul(Mw, beta, Q)
        S = torch.addcmul(W, beta, S)
        P = torch.addcmul(U, beta, P)
        X = torch.addcmul(X, alpha2, P)
        R = torch.addcmul(R, alpha2, S, value=-1)
        U = torch.addcmul(U, alpha2, Q, value=-1)
        W = torch.addcmul(W, alpha2, Z, value=-1)
        if replace_every and (k + 1) % replace_every == 0:
            # full per-column restoration from X and P (partial
            # replacements worsen the drift); the stopped columns keep
            # their blocks
            Rn = B - _apply_block(A, X)
            Un = precon(Rn)
            Wn = _apply_block(A, Un)
            Sn = _apply_block(A, P)
            Qn = precon(Sn)
            Zn = _apply_block(A, Qn)
            R, U, W, S, Q, Z = (torch.where(act, new, old) for new, old in (
                (Rn, R), (Un, U), (Wn, W), (Sn, S), (Qn, Q), (Zn, Z)))
        if hist is not None:
            hist[k + 1] = torch.where(active, resid2, float("nan"))
        gamma = torch.where(act, gamma2, gamma)
        alpha = torch.where(act, alpha2, alpha)
        resid = resid2
        iters += active.to(torch.int32)
        active = act
        k += 1

    converged = resid <= thresh
    return SolveResult(
        x=X, converged=converged,
        istop=torch.where(converged, 0, 1).to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(k + 1 + extra, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist,
        info={"n_iter_columns": iters, "active_at_exit": active})


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


# ---------------------------------------------------------------------------
# The transpose-free family: BiCGSTAB, CGS, TFQMR
# ---------------------------------------------------------------------------

def _tf_result(x, resid, resid0, thresh, broken, k, nmv, active, hist,
               converged=None, **info):
    """The shared result of the transpose-free solvers: istop 0 where the
    column converged, 3 where it broke down, 1 otherwise."""
    if converged is None:
        converged = resid <= thresh
    istop = torch.where(converged, 0, torch.where(broken, 3, 1))
    info.update(n_matvec_columns=nmv, active_at_exit=active)
    return SolveResult(
        x=x, converged=converged, istop=istop.to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=x.device),
        n_matvec=nmv.max(), resid_norm=resid, resid_norm0=resid0,
        resid_history=hist, info=info)


def bicgstab_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                     maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides by Bi-CGSTAB.

    Each column follows the reference recurrence (PyKrylov
    ``bicgstab.py:43-151``) under a per-column freeze mask, with the
    mid-iteration half-step exit (``bicgstab.py:107-114``: a column whose
    half-step residual meets its threshold accepts it and stops) and the
    breakdown guards of :func:`~pykrylov_tpu_torch.solvers.bicgstab`
    (istop 3; a non-finite full step keeps the previous iterate).  Both
    products of an iteration apply to the whole block, whatever the
    columns' states.

    ``maxiter`` caps BLOCK iterations (default ``matvec_max`` / 2 with the
    reference's 2n budget).  Each column's matvecs follow the reference's
    count (the ``x0`` product, then one for the first product and one for
    the second only where it ran) in ``info["n_matvec_columns"]``;
    ``n_matvec`` is their largest.  Returns a :class:`SolveResult` with
    per-column fields (istop codes in :data:`ISTOP_MSG_TF`) and, when
    stored, a (maxiter+1, K) history, NaN after each column's stop.
    """
    A, B, M = _block_rhs("bicgstab_batched", A, B, M)
    if maxiter is None:
        maxiter = default_maxiter(rows(B), 2, matvec_max)
    maxiter = int(maxiter)
    X0 = _check_x0(x0, B, "bicgstab_batched")
    dtype, dev = B.dtype, B.device
    K = B.shape[1]
    if X0 is None:
        X, R0, nmv0 = torch.zeros_like(B), B, 0
    else:
        X = X0.to(device=dev, dtype=dtype)
        R0 = B - _apply_block(A, X)
        nmv0 = 1            # counted, as in the reference (bicgstab.py:61-63)
    rho_next = _dotu_cols(R0, R0)
    resid0 = torch.sqrt(rho_next).abs()
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)

    one = torch.ones(K, dtype=dtype, device=dev)
    finite0 = torch.isfinite(resid0)
    active = (resid0 > thresh) & finite0
    R, P, V = R0, torch.zeros_like(B), torch.zeros_like(B)
    rho, alpha, omega, resid = one, one, one, resid0
    nmv = torch.full((K,), nmv0, dtype=torch.int32, device=dev)
    broken = ~finite0
    k = 0
    while k < maxiter:
        any_active, all_active = _poll(active)
        if not any_active:
            break
        act = active
        beta = (rho_next / _safe(rho)) * (alpha / _safe(omega))
        rho_c = rho_next
        P = _sel(all_active, act, R + beta * (P - omega * V), P)
        Q = _apply_block(M, P) if M is not None else P
        V2 = _apply_block(A, Q)
        nmv = nmv + act.to(torch.int32)
        denom = _dotu_cols(R0, V2)
        alpha_n = rho_c / _safe(denom)
        S = R - alpha_n * V2
        resid_s = _col_norm(_sel(all_active, act, S, 0))
        broken1 = act & ((denom == 0) | ~torch.isfinite(denom)
                         | (rho_c == 0) | ~torch.isfinite(resid_s))
        go = act & ~broken1
        early = go & (resid_s <= thresh)
        second = go & ~early

        Z = _apply_block(M, S) if M is not None else S
        T = _apply_block(A, Z)
        nmv = nmv + second.to(torch.int32)
        tt = _dotu_cols(T, T)
        omega_n = _dotu_cols(T, S) / _safe(tt)
        rho_n2 = -omega_n * _dotu_cols(R0, T)
        Rn = S - omega_n * T
        Xn = X + omega_n * Z + alpha_n * Q
        resid_f = _col_norm(torch.where(second, Rn, 0))
        broken2 = second & ((tt == 0) | ~torch.isfinite(resid_f))
        keep = second & ~torch.isfinite(resid_f)

        # per column: frozen -> unchanged; early -> the half-step;
        # second -> the full step (a non-finite one keeps the iterate)
        full = second & ~keep
        X = torch.where(early, X + alpha_n * Q, torch.where(full, Xn, X))
        R = torch.where(early, S, torch.where(second, Rn, R))
        resid2 = torch.where(early, resid_s,
                             torch.where(full, resid_f, resid))
        done = early | (second & ((resid2 <= thresh) | broken2)) | broken1
        if hist is not None:
            hist[k + 1] = torch.where(act, resid2, float("nan"))
        V = _sel(all_active, act, V2, V)
        rho = torch.where(go, rho_c, rho)
        rho_next = torch.where(second, rho_n2, rho_next)
        alpha = torch.where(go, alpha_n, alpha)
        omega = torch.where(second, omega_n, omega)
        resid = resid2
        broken = broken | broken1 | broken2 | keep
        active = act & ~done
        k += 1
    return _tf_result(X, resid, resid0, thresh, broken, k, nmv, active, hist)


def cgs_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides by CGS.

    Each column follows the reference recurrence (PyKrylov
    ``cgs.py:40-123``) under a per-column freeze mask, with the single-RHS
    solver's breakdown guards (a dead step keeps the previous iterate; a
    vanishing ``rho`` after a good step keeps the step) and its
    matvec-count quirk: the ``x0`` product is not counted
    (``cgs.py:59-60``).  A column also stops when its own count reaches
    ``matvec_max`` (default 2n); ``maxiter`` (default ``matvec_max`` / 2)
    caps block iterations.  Both products of an iteration apply to the
    whole block.  Returns as :func:`bicgstab_batched`.
    """
    A, B, M = _block_rhs("cgs_batched", A, B, M)
    if matvec_max is None:
        matvec_max = 2 * rows(B)
    matvec_max = int(matvec_max)
    if maxiter is None:
        maxiter = max(1, matvec_max // 2)
    maxiter = int(maxiter)
    X0 = _check_x0(x0, B, "cgs_batched")
    dtype, dev = B.dtype, B.device
    K = B.shape[1]
    if X0 is None:
        X, R0 = torch.zeros_like(B), B
    else:
        X = X0.to(device=dev, dtype=dtype)
        R0 = B - _apply_block(A, X)         # not counted (cgs.py:59-60)
    rho = _dotu_cols(R0, R0)
    resid0 = torch.sqrt(rho).abs()
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)

    finite0 = torch.isfinite(resid0)
    active = (resid0 > thresh) & finite0
    R, U, P, resid = R0, R0, R0, resid0
    nmv = torch.zeros(K, dtype=torch.int32, device=dev)
    broken = ~finite0
    k = 0
    while k < maxiter:
        any_active, all_active = _poll(active)
        if not any_active:
            break
        act = active
        Y = _apply_block(M, P) if M is not None else P
        V = _apply_block(A, Y)
        sigma = _dotu_cols(R0, V)
        alpha = rho / _safe(sigma)
        Q = U - alpha * V
        UQ = U + Q
        Z = _apply_block(M, UQ) if M is not None else UQ
        X2 = X + alpha * Z
        AZ = _apply_block(A, Z)
        nmv = nmv + 2 * act.to(torch.int32)
        R2 = R - alpha * AZ
        resid2 = _col_norm(R2)
        rho_n = _dotu_cols(R0, R2)
        # a dead step (sigma breakdown, non-finite residual) keeps the
        # iterate, as the single solver's guard; a vanishing rho_next is
        # seen after a good step, which is kept
        badstep = act & ((sigma == 0) | ~torch.isfinite(sigma)
                         | ~torch.isfinite(resid2))
        brk = badstep | (act & (rho_n == 0))
        done = act & ((resid2 <= thresh) | (nmv >= matvec_max) | brk)
        beta = rho_n / _safe(rho)
        U2 = R2 + beta * Q
        P2 = U2 + beta * (Q + beta * P)
        X2 = torch.where(badstep, X, X2)
        resid_out = torch.where(badstep, resid, resid2)
        if hist is not None:
            hist[k + 1] = torch.where(act, resid_out, float("nan"))
        X = _sel(all_active, act, X2, X)
        R = _sel(all_active, act, R2, R)
        U = _sel(all_active, act, U2, U)
        P = _sel(all_active, act, P2, P)
        rho = torch.where(act, rho_n, rho)
        resid = torch.where(act, resid_out, resid)
        broken = broken | brk
        active = act & ~done
        k += 1
    return _tf_result(X, resid, resid0, thresh, broken, k, nmv, active, hist)


def _tfqmr_half(theta_prev, eta_prev, w, d, x, alpha, u, z, resid, rdt):
    """One quasi-minimisation half-step (``tfqmr.py:93-123``), column by
    column."""
    w2 = w - alpha * u
    scale = torch.where(theta_prev == 0, torch.zeros_like(eta_prev),
                        (theta_prev * theta_prev / alpha) * eta_prev)
    d2 = z + scale * d
    theta2 = (_col_norm(w2) / _safe(resid)).to(rdt)
    c = 1.0 / torch.sqrt(1.0 + theta2 * theta2)
    resid2 = (resid * theta2 * c).to(rdt)
    eta2 = (c * c) * alpha
    x2 = x + eta2 * d2
    return w2, d2, x2, theta2, eta2, resid2


def tfqmr_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                  maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides by transpose-free QMR.

    Each column follows the reference recurrence (PyKrylov
    ``tfqmr.py:39-159``): two quasi-minimisation half-steps an iteration,
    the quasi-residual update ``resid *= theta c`` and the ``sqrt(m+1)``
    safety factor, under a per-column freeze mask; a column can stop after
    either half-step.  The block products (one before the loop, two an
    iteration) apply to the whole block; the ``x0`` product is not counted
    (``tfqmr.py:59-60``).  ``maxiter`` defaults to
    ``default_maxiter(n, 2, matvec_max) + 1``.

    ``resid_norm`` columns are quasi-residual norms (``||r|| <= resid
    sqrt(m+1)``), also in ``info["quasi_residual"]``; per-column matvecs
    (one before the loop, one for the second half-step and one for the
    refresh, where they ran) in ``info["n_matvec_columns"]``.  Returns as
    :func:`bicgstab_batched`.
    """
    A, B, M = _block_rhs("tfqmr_batched", A, B, M)
    if maxiter is None:
        maxiter = max(1, default_maxiter(rows(B), 2, matvec_max) + 1)
    maxiter = int(maxiter)
    X0 = _check_x0(x0, B, "tfqmr_batched")
    dtype, dev = B.dtype, B.device
    rdt = real_dtype(dtype)
    K = B.shape[1]
    if X0 is None:
        X, R0 = torch.zeros_like(B), B
    else:
        X = X0.to(device=dev, dtype=dtype)
        R0 = B - _apply_block(A, X)         # not counted (tfqmr.py:59-60)
    rho = _dotu_cols(R0, R0)
    resid0 = torch.sqrt(rho).abs().to(rdt)
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)

    finite0 = torch.isfinite(resid0)
    active = (resid0 > thresh) & finite0
    Z = _apply_block(M, R0) if M is not None else R0
    U = torch.where(active, _apply_block(A, Z), 0)
    W, Y, V, D = R0, R0, U, torch.zeros_like(B)
    theta = torch.zeros(K, dtype=rdt, device=dev)
    m = torch.zeros(K, dtype=rdt, device=dev)
    eta = torch.zeros(K, dtype=dtype, device=dev)
    resid = resid0
    nmv = active.to(torch.int32)
    broken = ~finite0
    k = 0
    while k < maxiter:
        if not active.any().item():         # the one host sync
            break
        act = active
        k += 1
        sigma = _dotu_cols(R0, V)
        alpha = rho / _safe(sigma)
        broken0 = act & ((sigma == 0) | ~torch.isfinite(sigma)
                         | (rho == 0) | ~torch.isfinite(resid))
        go = act & ~broken0

        # the first half-step
        w1, d1, x1, th1, et1, rs1 = _tfqmr_half(theta, eta, W, D, X, alpha,
                                                U, Z, resid, rdt)
        m1 = torch.tensor(2.0 * k - 1.0, dtype=rdt, device=dev)
        bad1 = go & ~torch.isfinite(rs1)
        stop1 = go & ((rs1 * torch.sqrt(m1 + 1) < thresh) | bad1)
        second = go & ~stop1

        # the second half-step (one block product)
        m2 = m1 + 1.0
        Y2 = Y - alpha * V
        Z2 = _apply_block(M, Y2) if M is not None else Y2
        U2 = _apply_block(A, Z2)
        nmv = nmv + second.to(torch.int32)
        w2, d2, x2, th2, et2, rs2 = _tfqmr_half(th1, et1, w1, d1, x1, alpha,
                                                U2, Z2, rs1, rdt)
        bad2 = second & ~torch.isfinite(rs2)
        stop2 = second & ((rs2 * torch.sqrt(m2 + 1) < thresh) | bad2)
        refresh = second & ~stop2

        # the direction refresh (tfqmr.py:128-151; one more block product)
        rho_n = _dotu_cols(R0, w2)
        beta = rho_n / _safe(rho)
        Y3 = w2 + beta * Y2
        Z3 = _apply_block(M, Y3) if M is not None else Y3
        U3 = _apply_block(A, Z3)
        nmv = nmv + refresh.to(torch.int32)
        V3 = beta * (beta * V + U2) + U3

        # per column (a non-finite half-step keeps the previous iterate)
        ok1, ok2 = stop1 & ~bad1, second & ~bad2
        X = torch.where(ok1, x1, torch.where(ok2, x2, X))
        r_n = torch.where(ok1, rs1, torch.where(ok2, rs2, resid))
        m = torch.where(stop1, m1, torch.where(second, m2, m))
        done = stop1 | stop2 | broken0 | (refresh & bad2)
        if hist is not None:
            hist[k] = torch.where(act, r_n, float("nan"))
        W = torch.where(go, torch.where(second, w2, w1), W)
        Y = torch.where(refresh, Y3, torch.where(second, Y2, Y))
        Z = torch.where(refresh, Z3, torch.where(second, Z2, Z))
        U = torch.where(refresh, U3, torch.where(second, U2, U))
        V = torch.where(refresh, V3, V)
        D = torch.where(go, torch.where(second, d2, d1), D)
        theta = torch.where(go, torch.where(second, th2, th1), theta)
        eta = torch.where(go, torch.where(second, et2, et1), eta)
        rho = torch.where(refresh, rho_n, rho)
        resid = r_n
        broken = broken | broken0 | bad1 | bad2
        active = act & ~done
    converged = resid * torch.sqrt(m + 1) < thresh
    return _tf_result(X, resid, resid0, thresh, broken, k, nmv, active, hist,
                      converged=converged, quasi_residual=resid)


# ---------------------------------------------------------------------------
# The symmetric indefinite family: MINRES, SYMMLQ
# ---------------------------------------------------------------------------

_MINRES_CONVERGED = (1, 2, 3, 4, 10)
_SYMMLQ_CONVERGED = (1, 2)


def _isin(istop, codes):
    return torch.isin(istop, torch.tensor(codes, dtype=istop.dtype,
                                          device=istop.device))


def minres_batched(A, B, *, M=None, shift=0.0, rtol=1.0e-12, etol=None,
                   window=None, itnlim=None, store_history=False,
                   replace_every=None, atol=None):
    """Solve symmetric (possibly indefinite) ``(A - shift I) X = B`` for an
    (n, K) block of right-hand sides by MINRES.

    Each column runs the reference Paige-Saunders recurrence (PyKrylov
    ``minres.py:220-361``): the Lanczos step, the Givens chain, the w
    recurrence and the whole istop battery with the energy-norm
    direct-error window, under a per-column freeze mask, while the product
    and the preconditioner apply to the whole block, one A product an
    iteration.  An indefinite preconditioner freezes only its column
    (istop 9 at entry, 6 mid-loop).

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.minres` (no
    ``check``/``show``/``store_iterates``); this is the estimate-stopping
    mode.  ``replace_every`` turns on the verified per-column mode,
    :func:`_minres_batched_ff`, whose ``atol`` is the absolute floor of its
    stop; as in the JAX package, ``store_history``, ``etol`` and ``window``
    are refused with it, and ``atol`` without it.

    Returns a :class:`SolveResult` with per-column fields (istop codes in
    :data:`ISTOP_MSG_MINRES`; ``resid_norm`` the recurrence's ``phibar``),
    per-column Anorm/Acond/Arnorm/ynorm and ``n_iter_columns`` in ``info``.
    """
    replace_every = int(replace_every) if replace_every else None
    if replace_every is not None:
        if store_history:
            raise ValueError("minres_batched: store_history is unsupported "
                             "with replace_every (verified mode keeps no "
                             "history buffers)")
        if etol is not None or window is not None:
            raise ValueError("minres_batched: the etol/window direct-error "
                             "stop does not exist in verified mode (istop 1 "
                             "fires only on recomputed true residuals)")
        A, B, M = _block_rhs("minres_batched", A, B, M)
        return _minres_batched_ff(
            A, B, M, float(shift), float(rtol),
            float(atol if atol is not None else 0.0),
            int(itnlim if itnlim is not None else 5 * rows(B)),
            replace_every, resolve_ff_matmat(A))
    if atol is not None:
        raise ValueError("minres_batched: atol is only used by the verified "
                         "(replace_every) stopping rule; the "
                         "estimate-stopping mode has no absolute test "
                         "(reference minres.py has none either)")
    A, B, M = _block_rhs("minres_batched", A, B, M)
    itnlim = int(itnlim if itnlim is not None else 5 * rows(B))
    etol = float(etol if etol is not None else 1e-6)
    window = int(window if window is not None else 5)
    shift = float(shift)
    dtype, dev = B.dtype, B.device
    rdt = real_dtype(dtype)
    eps = torch.finfo(rdt).eps
    K = B.shape[1]
    zK = torch.zeros(K, dtype=rdt, device=dev)

    Y = _apply_block(M, B) if M is not None else B
    beta1_sq = _col_dot(B, Y)
    indef_precon = beta1_sq < 0             # istop 9 (minres.py:168-171)
    zero_b = beta1_sq == 0                  # istop 0 (minres.py:173-177)
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    hist = _history(store_history, itnlim + 1, beta1)

    X, R1, R2 = torch.zeros_like(B), B, B
    Wv, W2 = torch.zeros_like(B), torch.zeros_like(B)
    oldb, beta, dbar, epsln = zK, beta1, zK, zK
    phibar, rhs1, rhs2, tnorm2, ynorm2 = beta1, beta1, zK, zK, zK
    cs, sn = -torch.ones(K, dtype=rdt, device=dev), zK
    gmax, gmin, x_nrg2 = zK, zK, zK
    d_err = torch.zeros((window, K), dtype=rdt, device=dev)
    anorm, acond, ynorm, arnorm, rnorm = zK, zK, zK, zK, beta1
    istop = torch.where(indef_precon, 9, 0).to(torch.int32)
    done = indef_precon | zero_b
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    itn = 0
    while itn < itnlim:
        any_active, all_active = _poll(~done)
        if not any_active:
            break
        act = ~done
        # without M, beta^2 = ||r||^2 >= 0: no column turns indefinite, so
        # go is act, and with every column active its selects are skipped
        all_go = all_active and M is None
        itn += 1
        # the Lanczos step (minres.py:236-255), column by column
        v = Y / _safe(beta)
        y = _apply_block(A, v) - shift * v
        if itn >= 2:
            y = y - (beta / _safe(oldb)) * R1
        alfa = _col_dot(v, y)
        y = y - (alfa / _safe(beta)) * R2
        r1n, r2n = R2, y
        y = _apply_block(M, r2n) if M is not None else r2n
        oldb_n = beta
        beta_sq = _col_dot(r2n, y)
        indef = act & (beta_sq < 0)         # istop 6 (minres.py:251-255)
        go = act & ~indef
        beta_n = torch.sqrt(torch.clamp(beta_sq, min=0))

        tnorm2_n = tnorm2 + alfa ** 2 + oldb_n ** 2 + beta_n ** 2
        istop_n = istop
        if itn == 1:
            near_const = beta_n / _safe(beta1) <= 10 * eps
            istop_n = torch.where(go & near_const, -1, istop_n).to(
                torch.int32)
            gmax0 = gmin0 = alfa.abs()
        else:
            gmax0, gmin0 = gmax, gmin

        # the previous rotation (minres.py:266-289)
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        root = torch.hypot(gbar, dbar_n)
        arnorm_n = phibar * root

        gamma = torch.clamp(torch.hypot(gbar, beta_n), min=eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        # the solution update (minres.py:293-297)
        w = (v - oldeps * W2 - delta * Wv) / gamma
        x = X + phi * w

        # the truncated direct-error window (minres.py:303-310): written
        # only for the columns still going
        x_nrg2_n = x_nrg2 + phi * phi
        slot = itn % window
        d_err[slot] = torch.where(go, phi, d_err[slot])
        if itn > window:
            small_err = _col_norm(d_err) < etol * torch.sqrt(x_nrg2_n)
            istop_n = torch.where(go & (istop_n == 0) & small_err, 10,
                                  istop_n).to(torch.int32)

        gmax_n = torch.maximum(gmax0, gamma)
        gmin_n = torch.minimum(gmin0, gamma)
        z = rhs1 / gamma
        ynorm2_n = z ** 2 + ynorm2
        rhs1_n = rhs2 - delta * z
        rhs2_n = -epsln_n * z

        # the norm estimates and stop tests (minres.py:321-361)
        anorm_n = torch.sqrt(tnorm2_n)
        ynorm_n = torch.sqrt(ynorm2_n)
        epsx = anorm_n * ynorm_n * eps
        rnorm_n = phibar_n
        test1 = rnorm_n / _safe(anorm_n * ynorm_n)
        test2 = root / _safe(anorm_n)
        acond_n = gmax_n / _safe(gmin_n)

        code = istop_n
        code = torch.where(1 + test2 <= 1, 2, code)
        code = torch.where(1 + test1 <= 1, 1, code)
        if itn >= itnlim:
            code = torch.full_like(code, 6)
        code = torch.where(acond_n >= 0.1 / eps, 4, code)
        code = torch.where(epsx >= beta1, 3, code)
        code = torch.where(test2 <= rtol, 2, code)
        code = torch.where(test1 <= rtol, 1, code)
        istop_n = torch.where(go & (istop_n == 0), code, istop_n)
        istop = torch.where(indef, 6, istop_n).to(torch.int32)

        def mc(new, old):
            return torch.where(go, new, old)

        if hist is not None:
            hist[itn] = torch.where(go, rnorm_n, float("nan"))
        X, R1, R2 = (_sel(all_go, go, x, X), _sel(all_go, go, r1n, R1),
                     _sel(all_go, go, r2n, R2))
        Y, Wv, W2 = (_sel(all_go, go, y, Y), _sel(all_go, go, w, Wv),
                     _sel(all_go, go, Wv, W2))
        oldb, beta = mc(oldb_n, oldb), mc(beta_n, beta)
        dbar, epsln = mc(dbar_n, dbar), mc(epsln_n, epsln)
        phibar, rhs1, rhs2 = (mc(phibar_n, phibar), mc(rhs1_n, rhs1),
                              mc(rhs2_n, rhs2))
        tnorm2, ynorm2 = mc(tnorm2_n, tnorm2), mc(ynorm2_n, ynorm2)
        cs, sn = mc(cs_n, cs), mc(sn_n, sn)
        gmax, gmin = mc(gmax_n, gmax), mc(gmin_n, gmin)
        x_nrg2 = mc(x_nrg2_n, x_nrg2)
        anorm, acond = mc(anorm_n, anorm), mc(acond_n, acond)
        ynorm, arnorm = mc(ynorm_n, ynorm), mc(arnorm_n, arnorm)
        rnorm = mc(rnorm_n, rnorm)
        # != 0: a -1 (eigenvector rhs) column freezes too
        done = done | (istop != 0)
        iters = iters + act.to(torch.int32)

    X = torch.where(zero_b, 0, X)
    converged = zero_b | _isin(istop, _MINRES_CONVERGED)
    info = {"Anorm": anorm, "Acond": acond, "Arnorm": arnorm,
            "ynorm": ynorm, "n_iter_columns": iters,
            "active_at_exit": ~done}
    n_iter = torch.tensor(itn, dtype=torch.int32, device=dev)
    return SolveResult(
        x=X, converged=converged, istop=istop, n_iter=n_iter,
        n_matvec=n_iter.clone(), resid_norm=torch.where(zero_b, 0, rnorm),
        resid_norm0=beta1, resid_history=hist, info=info)


def symmlq_batched(A, B, *, M=None, shift=0.0, rtol=1.0e-9, matvec_max=None,
                   store_history=False):
    """Solve symmetric (possibly indefinite) ``(A - shift I) X = B`` for an
    (n, K) block of right-hand sides by SYMMLQ.

    Each column runs the reference LQ recurrence (PyKrylov
    ``symmlq.py:65-400``): the Lanczos start with its local
    reorthogonalisation, the plane rotations, the istop battery, the move
    to the CG point where it is better and the final step along ``b``,
    under a per-column freeze mask; the product and the preconditioner
    apply to whole blocks (one A product before the loop, one an
    iteration, one for the final residual).

    Parameters mirror :func:`~pykrylov_tpu_torch.solvers.symmlq` (no
    ``check``/``store_iterates``).  ``matvec_max`` caps each column's
    count (default 2n + 2), in ``info["n_matvec_columns"]``; ``n_matvec``
    is their largest.  ``resid_norm`` columns are the true final residuals
    (istop codes in :data:`ISTOP_MSG_SYMMLQ`).
    """
    A, B, M = _block_rhs("symmlq_batched", A, B, M)
    matvec_max = int(matvec_max if matvec_max is not None
                     else 2 * rows(B) + 2)
    shift = float(shift)
    dtype, dev = B.dtype, B.device
    rdt = real_dtype(dtype)
    eps = torch.finfo(rdt).eps
    itnlim = max(1, matvec_max + 2)
    K = B.shape[1]
    zK = torch.zeros(K, dtype=rdt, device=dev)

    def sdiv(a, d):
        return a / torch.where(d == 0, 1, d)

    # the first and second Lanczos vectors with the local
    # reorthogonalisation (symmlq.py:128-199; one counted product)
    r1 = B
    Y = _apply_block(M, r1) if M is not None else r1
    beta1_sq = _col_dot(r1, Y)
    indef_precon = beta1_sq < 0
    zero_b = beta1_sq == 0
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    v = sdiv(Y, beta1)
    y = _apply_block(A, v) - shift * v
    alfa = _col_dot(v, y)
    y = y - sdiv(alfa, beta1) * r1
    z = _col_dot(v, y)
    ss = _col_dot(v, v)
    y = y - sdiv(z, ss) * v
    r2 = y
    Y = _apply_block(M, r2) if M is not None else r2
    beta_sq = _col_dot(r2, Y)
    indef_precon2 = beta_sq < 0
    dead = indef_precon | zero_b | indef_precon2
    beta = torch.sqrt(torch.clamp(beta_sq, min=0))
    istop = torch.where(indef_precon | indef_precon2, 8, 0)
    istop = torch.where((istop == 0) & (beta <= eps) & ~zero_b, -1,
                        istop).to(torch.int32)
    hist = _history(store_history, itnlim + 1, beta1)

    X, Wv, R1, R2 = torch.zeros_like(B), torch.zeros_like(B), r1, r2
    oldb, gbar, dbar = beta1, alfa, beta
    rhs1, rhs2, snprod, bstep = beta1, zK, torch.ones_like(zK), zK
    tnorm, ynorm2 = alfa ** 2 + beta ** 2, zK
    gmax = gmin = alfa.abs() + eps
    cgnorm, lqnorm = beta1, beta1
    diag = torch.where(alfa == 0, eps, alfa)
    acond, anorm = zK, zK
    nmv = torch.where(dead, 0, 1).to(torch.int32)
    done = dead
    itn = 0
    while itn < itnlim:
        active = ~done & (nmv < matvec_max)
        if not active.any().item():         # the one host sync
            break
        act = active
        itn += 1
        # the per-column norm estimates and tests (symmlq.py:237-277)
        anorm_n = torch.sqrt(tnorm)
        ynorm = torch.sqrt(ynorm2)
        epsa = anorm_n * eps
        epsx = anorm_n * ynorm * eps
        epsr = anorm_n * ynorm * rtol
        diag_n = torch.where(gbar == 0, epsa, gbar)
        lqnorm_n = torch.sqrt(rhs1 ** 2 + rhs2 ** 2)
        qrnorm = snprod * beta1
        cgnorm_n = qrnorm * beta / torch.where(diag_n == 0, eps,
                                               diag_n).abs()
        acond_n = torch.where(lqnorm_n < cgnorm_n, gmax / gmin,
                              gmax / torch.minimum(gmin, diag_n.abs()))
        code = istop
        code = torch.where(nmv >= matvec_max, 5, code)
        code = torch.where(acond_n >= 0.1 / eps, 4, code)
        code = torch.where(epsx >= beta1, 3, code)
        code = torch.where(cgnorm_n <= epsx, 2, code)
        code = torch.where(cgnorm_n <= epsr, 1, code)
        istop = torch.where(act & (istop == 0), code, istop).to(torch.int32)
        go = act & (istop == 0)

        # the Lanczos step (symmlq.py:286-302)
        v = sdiv(Y, beta)
        ya = _apply_block(A, v) - shift * v
        ya = ya - sdiv(beta, oldb) * R1
        alfa = _col_dot(v, ya)
        ya = ya - sdiv(alfa, beta) * R2
        r1n, r2n = R2, ya
        y2 = _apply_block(M, r2n) if M is not None else r2n
        oldb_n = beta
        beta_sq = _col_dot(r2n, y2)
        indef = go & (beta_sq < 0)          # istop 6 (symmlq.py:191-199)
        rot = go & ~indef
        istop = torch.where(indef, 6, istop).to(torch.int32)
        beta_n = torch.sqrt(torch.clamp(beta_sq, min=0))
        tnorm_n = tnorm + alfa ** 2 + oldb_n ** 2 + beta_n ** 2

        # the plane rotation and LQ update (symmlq.py:307-338)
        gamma = torch.hypot(gbar, oldb_n)
        gsafe = torch.where(gamma == 0, eps, gamma)
        cs = gbar / gsafe
        sn = oldb_n / gsafe
        delta = cs * dbar + sn * alfa
        gbar_n = sn * dbar - cs * alfa
        epsln = sn * beta_n
        dbar_n = -cs * beta_n
        zz = rhs1 / gsafe
        x = X + (zz * cs) * Wv + (zz * sn) * v
        w = sn * Wv - cs * v
        bstep_n = snprod * cs * zz + bstep
        snprod_n = snprod * sn
        gmax_n = torch.maximum(gmax, gamma)
        gmin_n = torch.minimum(gmin, gamma)
        ynorm2_n = zz ** 2 + ynorm2
        rhs1_n = rhs2 - delta * zz
        rhs2_n = -epsln * zz

        def ma(new, old):       # committed for every column tested
            return torch.where(act, new, old)

        def mc(new, old):       # committed where the rotation ran
            return torch.where(rot, new, old)

        if hist is not None:
            hist[itn] = torch.where(act, cgnorm_n, float("nan"))
        X, Wv = mc(x, X), mc(w, Wv)
        R1, R2, Y = mc(r1n, R1), mc(r2n, R2), mc(y2, Y)
        oldb, beta = mc(oldb_n, oldb), mc(beta_n, beta)
        gbar, dbar = mc(gbar_n, gbar), mc(dbar_n, dbar)
        rhs1, rhs2 = mc(rhs1_n, rhs1), mc(rhs2_n, rhs2)
        snprod, bstep = mc(snprod_n, snprod), mc(bstep_n, bstep)
        tnorm, ynorm2 = mc(tnorm_n, tnorm), mc(ynorm2_n, ynorm2)
        gmax, gmin = mc(gmax_n, gmax), mc(gmin_n, gmin)
        cgnorm, lqnorm = ma(cgnorm_n, cgnorm), ma(lqnorm_n, lqnorm)
        diag, acond = ma(diag_n, diag), ma(acond_n, acond)
        anorm = ma(anorm_n, anorm)
        # the step's product is spent before indefiniteness shows (the
        # single solver counts it), so count go, not rot
        nmv = nmv + go.to(torch.int32)
        done = done | (act & (istop != 0))

    # a budget spent through the loop guard (the reference leaves istop 0
    # there) reports the limit, as the single symmlq
    istop = torch.where((istop == 0) & ~zero_b, 5, istop).to(torch.int32)

    # move to the CG point where it is better (symmlq.py:356-365)
    move = cgnorm < lqnorm
    zbar = rhs1 / torch.where(diag == 0, eps, diag)
    bstep = torch.where(move, snprod * zbar + bstep, bstep)
    X = torch.where(move, X + zbar * Wv, X)

    # the step along b (symmlq.py:367-374)
    bstep = sdiv(bstep, beta1)
    Yb = _apply_block(M, B) if M is not None else B
    X = X + bstep * Yb

    # the true final residual, one counted product (symmlq.py:376-381)
    Ax = _apply_block(A, X) - shift * X
    rnorm = _col_norm(B - Ax)
    xnorm = _col_norm(X)
    nmv = nmv + torch.where(nmv == 0, 0, 1).to(torch.int32)

    X = torch.where(zero_b, 0, X)
    rnorm = torch.where(zero_b, 0, rnorm)
    converged = zero_b | _isin(istop, _SYMMLQ_CONVERGED)
    info = {"Anorm": anorm, "Acond": acond, "xnorm": xnorm,
            "cgnorm": cgnorm, "lqnorm": lqnorm, "n_matvec_columns": nmv,
            "active_at_exit": ~done}
    return SolveResult(
        x=X, converged=converged, istop=istop,
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=nmv.max(), resid_norm=rnorm, resid_norm0=beta1,
        resid_history=hist, info=info)


# ---------------------------------------------------------------------------
# The least-squares family: LSQR, LSMR, CRAIG, CRAIG-MR
# ---------------------------------------------------------------------------

_LLS_OPTIMAL = (0, 1, 2, 4, 5, 8)


def _gk_init_block(A, B, M, N):
    """The Golub-Kahan start on an (m, K) block: ``lls_common.gk_init``
    column by column (weighted norms, normalisations guarded per column;
    reference ``lls/lsqr.py:188-210``), with alpha and beta (K,) tensors;
    one A^T product."""
    Mu = B
    u = _apply_block(M, Mu) if M is not None else Mu
    beta = torch.sqrt(torch.clamp(_col_dot(u, Mu), min=0))
    sb = torch.where(beta == 0, 1, beta)
    u = torch.where(beta > 0, u / sb, u)
    Mu = torch.where(beta > 0, Mu / sb, Mu)
    Nv = _apply_block_T(A, u)
    v = _apply_block(N, Nv) if N is not None else Nv
    alpha = torch.sqrt(torch.clamp(_col_dot(v, Nv), min=0))
    alpha = torch.where(beta > 0, alpha, 0)
    sa = torch.where(alpha == 0, 1, alpha)
    v = torch.where(alpha > 0, v / sa, v)
    Nv = torch.where(alpha > 0, Nv / sa, Nv)
    return u, Mu, v, Nv, alpha, beta


def _gk_step_block(A, M, N, v, Mu, Nv, alpha):
    """One bidiagonalisation step on the block, as ``lls_common.gk_step``
    with its guards: a column whose new beta is 0 keeps its v, Nv and
    alpha (reference ``lls/lsqr.py:252-272``).  One A and one A^T
    product."""
    Mu2 = _apply_block(A, v) - alpha * Mu
    u2 = _apply_block(M, Mu2) if M is not None else Mu2
    beta = torch.sqrt(torch.clamp(_col_dot(u2, Mu2), min=0))
    ok_b = beta > 0
    sb = torch.where(ok_b, beta, 1)
    u2 = torch.where(ok_b, u2 / sb, u2)
    Mu2 = torch.where(ok_b, Mu2 / sb, Mu2)
    Nv2 = _apply_block_T(A, u2) - beta * Nv
    v2 = _apply_block(N, Nv2) if N is not None else Nv2
    alpha2 = torch.sqrt(torch.clamp(_col_dot(v2, Nv2), min=0))
    ok_a = ok_b & (alpha2 > 0)
    sa = torch.where(ok_a, alpha2, 1)
    v2 = torch.where(ok_a, v2 / sa, v2)
    Nv2 = torch.where(ok_a, Nv2 / sa, Nv2)
    v2 = torch.where(ok_b, v2, v)
    Nv2 = torch.where(ok_b, Nv2, Nv)
    alpha2 = torch.where(ok_b, torch.where(alpha2 > 0, alpha2, 0), alpha)
    return u2, Mu2, v2, Nv2, alpha2, beta


def _sym_ortho_cols(a, b):
    """Stable Givens rotations (c, s, r), r = hypot(a, b), column by
    column: the branch-free form of ``lls_common.sym_ortho`` (reference
    ``symOrtho``, ``lls/lsmr.py:500-519``: ``sign(0) == 1``, and ``b ==
    0`` taking precedence over ``a == 0``)."""
    def sign(x):
        return torch.where(x < 0, -1.0, 1.0).to(x.dtype)

    absa, absb = a.abs(), b.abs()
    tau1 = a / _safe(b)                     # the |b| > |a| branch
    s1 = sign(b) / torch.sqrt(1 + tau1 * tau1)
    c1, r1 = s1 * tau1, b / s1
    tau2 = b / _safe(a)                     # the |a| >= |b| branch
    c2 = sign(a) / torch.sqrt(1 + tau2 * tau2)
    s2, r2 = c2 * tau2, a / c2
    big_b = absb > absa
    c = torch.where(big_b, c1, c2)
    s = torch.where(big_b, s1, s2)
    r = torch.where(big_b, r1, r2)
    c = torch.where(a == 0, 0.0, c)
    s = torch.where(a == 0, sign(b), s)
    r = torch.where(a == 0, absb, r)
    c = torch.where(b == 0, sign(a), c)
    s = torch.where(b == 0, 0.0, s)
    r = torch.where(b == 0, absa, r)
    return c, s, r


def _window_stop(d_err, itn, window, slot_value, act, etol, nrg2):
    """Write this iteration's direct-error term into the window (for the
    active columns only) and return where the truncated direct error has
    fallen below ``etol`` times the energy norm ``sqrt(nrg2)``."""
    slot = itn % window
    d_err[slot] = torch.where(act, slot_value, d_err[slot])
    if itn <= window:
        return torch.zeros_like(act)
    return _col_norm(d_err) < etol * torch.sqrt(nrg2)


def _lls_result(x, istop, converged, itn, resid, resid0, hist, info):
    n_iter = torch.tensor(itn, dtype=torch.int32, device=x.device)
    return SolveResult(x=x, converged=converged, istop=istop, n_iter=n_iter,
                       n_matvec=2 * n_iter, resid_norm=resid,
                       resid_norm0=resid0, resid_history=hist, info=info)


def lsqr_batched(A, B, *, damp=0.0, M=None, N=None, atol=1.0e-9,
                 btol=1.0e-9, conlim=1.0e8, etol=1.0e-6, window=5,
                 itnlim=None, store_history=False):
    """Solve ``min ||A x_k - b_k||`` (damped: ``min ||[A; damp I] x_k -
    [b_k; 0]||``) for an (m, K) block of right-hand sides by LSQR.

    The block companion of :func:`~pykrylov_tpu_torch.solvers.lsqr`
    (reference ``lls/lsqr.py:243-392``): each column drives its own
    Golub-Kahan bidiagonalisation, damp and beta rotations, istop battery
    and direct-error window under a per-column freeze mask, while A and
    A^T apply to whole blocks, one product each an iteration (and one A^T
    before the loop).

    Parameters mirror :func:`lsqr` (no ``wantvar``/``show``); ``itnlim``
    defaults to 3n.  Returns a :class:`SolveResult` with per-column fields
    (istop codes in :data:`ISTOP_MSG_LSQR`), the reference's norms and
    ``n_iter_columns`` in ``info``; ``n_matvec`` counts block products,
    ``2 n_iter``.
    """
    A, B, M, N = _block_rhs("lsqr_batched", A, B, M, N,
                            square=False)
    itnlim = int(itnlim if itnlim is not None else 3 * A.shape[1])
    window, damp = int(window), float(damp)
    dtype, dev = B.dtype, B.device
    n, K = A.shape[1], B.shape[1]
    zK = torch.zeros(K, dtype=dtype, device=dev)
    dampsq = damp * damp
    ctol = 1.0 / conlim if conlim > 0 else 0.0
    inf = float("inf")

    u, Mu, v, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    bnorm = beta
    done = alpha * beta == 0            # the exact solution x = 0 (istop 0)
    hist = _history(store_history, itnlim + 1, beta)
    X, W = torch.zeros_like(v, dtype=dtype), v
    rhobar, phibar = alpha, beta
    cs2, sn2, z = -torch.ones_like(zK), zK, zK
    xxnorm, ddnorm, res2 = zK, zK, zK
    anorm, acond, xnorm = zK, zK, zK
    rnorm = r1norm = r2norm = beta
    arnorm = alpha * beta
    x_nrg2 = zK
    d_err = torch.zeros((window, K), dtype=dtype, device=dev)
    istop = torch.zeros(K, dtype=torch.int32, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    sb = torch.where(bnorm == 0, 1, bnorm)
    itn = 0
    while itn < itnlim:
        any_active, all_active = _poll(~done)
        if not any_active:
            break
        act = ~done
        itn += 1
        u2, Mu2, v2, Nv2, alpha2, beta2 = _gk_step_block(A, M, N, v, Mu, Nv,
                                                         alpha)
        anorm_n = torch.sqrt(anorm ** 2 + alpha ** 2 + beta2 ** 2 + dampsq)

        rhobar1 = torch.hypot(rhobar, torch.full_like(rhobar, damp))
        cs1 = rhobar / rhobar1
        sn1 = damp / rhobar1
        psi = sn1 * phibar
        phibar1 = cs1 * phibar

        rho = torch.hypot(rhobar1, beta2)
        cs = rhobar1 / rho
        sn = beta2 / rho
        theta = sn * alpha2
        rhobar_n = -cs * alpha2
        phi = cs * phibar1
        phibar_n = sn * phibar1
        tau = sn * phi

        t1 = phi / rho
        t2 = -theta / rho
        dk = W / rho
        x = X + t1 * W
        w = t2 * W + v2
        ddnorm_n = ddnorm + _col_dot(dk, dk)

        x_nrg2_n = x_nrg2 + phi * phi
        small = _window_stop(d_err, itn, window, phi, act, etol, x_nrg2_n)
        code = torch.where(small, 8, istop)

        delta = sn2 * rho
        gambar = -cs2 * rho
        rhs = phi - delta * z
        zbar = rhs / torch.where(gambar == 0, 1, gambar)
        xnorm_n = torch.sqrt(xxnorm + zbar ** 2)
        gamma = torch.hypot(gambar, theta)
        cs2_n = gambar / gamma
        sn2_n = theta / gamma
        z_n = rhs / torch.where(gamma == 0, 1, gamma)
        xxnorm_n = xxnorm + z_n * z_n

        acond_n = anorm_n * torch.sqrt(ddnorm_n)
        res1 = phibar_n ** 2
        res2_n = res2 + psi ** 2
        rnorm_n = torch.sqrt(res1 + res2_n)
        arnorm_n = alpha2 * tau.abs()
        r1sq = rnorm_n ** 2 - dampsq * xxnorm_n
        r1norm_n = torch.sign(r1sq) * torch.sqrt(r1sq.abs())
        r2norm_n = rnorm_n

        test1 = rnorm_n / sb
        test2 = torch.where((anorm_n == 0) | (rnorm_n == 0), inf,
                            arnorm_n / (anorm_n * rnorm_n))
        test3 = torch.where(acond_n == 0, inf, 1.0 / acond_n)
        t1t = test1 / (1 + anorm_n * xnorm_n / sb)
        rtol = btol + atol * anorm_n * xnorm_n / sb

        if itn >= itnlim:
            code = torch.full_like(code, 7)
        code = torch.where(1 + test3 <= 1, 6, code)
        code = torch.where(1 + test2 <= 1, 5, code)
        code = torch.where(1 + t1t <= 1, 4, code)
        code = torch.where(test3 <= ctol, 3, code)
        code = torch.where(test2 <= atol, 2, code)
        code = torch.where(test1 <= rtol, 1, code).to(torch.int32)

        # freeze: a stopped column carries every field unchanged
        def mc(new, old):
            return torch.where(act, new, old)

        def mv(new, old):
            return _sel(all_active, act, new, old)

        if hist is not None:
            hist[itn] = torch.where(act, r2norm_n, float("nan"))
        X, W, u, Mu = mv(x, X), mv(w, W), mv(u2, u), mv(Mu2, Mu)
        v, Nv = mv(v2, v), mv(Nv2, Nv)
        alpha, beta = mc(alpha2, alpha), mc(beta2, beta)
        rhobar, phibar = mc(rhobar_n, rhobar), mc(phibar_n, phibar)
        cs2, sn2, z = mc(cs2_n, cs2), mc(sn2_n, sn2), mc(z_n, z)
        xxnorm, ddnorm = mc(xxnorm_n, xxnorm), mc(ddnorm_n, ddnorm)
        res2, anorm = mc(res2_n, res2), mc(anorm_n, anorm)
        acond, xnorm = mc(acond_n, acond), mc(xnorm_n, xnorm)
        rnorm, r1norm = mc(rnorm_n, rnorm), mc(r1norm_n, r1norm)
        r2norm, arnorm = mc(r2norm_n, r2norm), mc(arnorm_n, arnorm)
        x_nrg2 = mc(x_nrg2_n, x_nrg2)
        istop = mc(code, istop)
        iters = iters + act.to(torch.int32)
        done = done | (act & (code > 0))

    optimal = _isin(istop, _LLS_OPTIMAL)
    info = {"r1norm": r1norm, "r2norm": r2norm, "Anorm": anorm,
            "Acond": acond, "Arnorm": arnorm, "xnorm": xnorm,
            "bnorm": bnorm, "optimal": optimal, "n_iter_columns": iters}
    return _lls_result(X, istop, optimal, itn, r2norm, bnorm, hist, info)


def lsmr_batched(A, B, *, damp=0.0, M=None, N=None, atol=1.0e-9,
                 btol=1.0e-9, conlim=1.0e8, etol=1.0e-6, window=5,
                 itnlim=None, store_history=False):
    """Solve ``min ||A x_k - b_k||`` for an (m, K) block of right-hand
    sides by LSMR.

    The block companion of :func:`~pykrylov_tpu_torch.solvers.lsmr`
    (reference double-QR recurrence ``lls/lsmr.py:336-448``): each column
    runs its own bidiagonalisation, the Q/Qbar/Qtilde rotation chains, the
    recursive ``||r||`` estimate and the istop battery under a per-column
    freeze mask, with one A and one A^T block product an iteration.
    ``||x_k||`` is each column's norm on the device: the block loop reads
    no scalar on the host besides its activity, so the single solver's
    Gram matrix (which saves a read) has no use here.

    Parameters mirror :func:`lsmr` (no ``show``/``verify_final``);
    ``itnlim`` defaults to min(m, n).  Returns a :class:`SolveResult` with
    per-column fields, the reference's normr/normar/normA/condA/normx and
    ``n_iter_columns`` in ``info``; ``n_matvec`` counts block products.
    """
    A, B, M, N = _block_rhs("lsmr_batched", A, B, M, N,
                            square=False)
    itnlim = int(itnlim if itnlim is not None else min(A.shape))
    window, damp = int(window), float(damp)
    dtype, dev = B.dtype, B.device
    n, K = A.shape[1], B.shape[1]
    zK = torch.zeros(K, dtype=dtype, device=dev)
    oneK = torch.ones(K, dtype=dtype, device=dev)
    dampK = torch.full((K,), damp, dtype=dtype, device=dev)
    ctol = 1.0 / conlim if conlim > 0 else 0.0

    u, Mu, v, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    normb = beta
    done = alpha * beta == 0
    hist = _history(store_history, itnlim + 1, beta)
    X, H = torch.zeros_like(v, dtype=dtype), v
    Hbar = torch.zeros_like(X)
    zetabar, alphabar = alpha * beta, alpha
    rho, rhobar, cbar, sbar = oneK, oneK, oneK, zK
    betadd, betad, rhodold, tautildeold = beta, zK, oneK, zK
    thetatilde, zeta, d = zK, zK, zK
    normA2, maxrbar = alpha * alpha, zK
    minrbar = torch.full((K,), float("inf"), dtype=dtype, device=dev)
    normr, normar, normA, condA, normx = beta, alpha * beta, alpha, oneK, zK
    x_nrg2 = zK
    d_err = torch.zeros((window, K), dtype=dtype, device=dev)
    istop = torch.zeros(K, dtype=torch.int32, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    sb = torch.where(normb == 0, 1, normb)
    itn = 0
    while itn < itnlim:
        any_active, all_active = _poll(~done)
        if not any_active:
            break
        act = ~done
        itn += 1
        u2, Mu2, v2, Nv2, alpha2, beta2 = _gk_step_block(A, M, N, v, Mu, Nv,
                                                         alpha)

        # the rotations (lsmr.py:336-365)
        chat, shat, alphahat = _sym_ortho_cols(alphabar, dampK)
        rhoold = rho
        c, sn, rho_n = _sym_ortho_cols(alphahat, beta2)
        thetanew = sn * alpha2
        alphabar_n = c * alpha2
        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho_n
        rhotemp = cbar * rho_n
        cbar_n, sbar_n, rhobar_n = _sym_ortho_cols(cbar * rho_n, thetanew)
        zeta_n = cbar_n * zetabar
        zetabar_n = -sbar_n * zetabar

        # h, hbar and x (lsmr.py:367-371)
        hbar = H - (thetabar * rho_n / _safe(rhoold * rhobarold)) * Hbar
        x = X + (zeta_n / _safe(rho_n * rhobar_n)) * hbar
        h = v2 - (thetanew / _safe(rho_n)) * H

        # the direct-error window (lsmr.py:376-384)
        x_nrg2_n = x_nrg2 + zeta_n * zeta_n
        small = _window_stop(d_err, itn, window, zeta_n, act, etol, x_nrg2_n)
        code = torch.where(small, 8, istop)

        # the ||r|| estimate (lsmr.py:386-404)
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd_n = -sn * betaacute
        thetatildeold = thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho_cols(rhodold,
                                                            thetabar)
        thetatilde_n = stildeold * rhobar_n
        rhodold_n = ctildeold * rhobar_n
        betad_n = -stildeold * betad + ctildeold * betahat
        tautildeold_n = ((zetaold - thetatildeold * tautildeold)
                         / _safe(rhotildeold))
        taud = (zeta_n - thetatilde_n * tautildeold_n) / _safe(rhodold_n)
        d_n = d + betacheck * betacheck
        normr_n = torch.sqrt(d_n + (betad_n - taud) ** 2
                             + betadd_n * betadd_n)

        # the ||A|| and cond(A) estimates (lsmr.py:406-412)
        normA2_n = normA2 + beta2 * beta2
        normA_n = torch.sqrt(normA2_n)
        normA2_n = normA2_n + alpha2 * alpha2
        maxrbar_n = torch.maximum(maxrbar, rhobarold)
        minrbar_n = (torch.minimum(minrbar, rhobarold) if itn > 1
                     else minrbar)
        condA_n = (torch.maximum(maxrbar_n, rhotemp)
                   / _safe(torch.minimum(minrbar_n, rhotemp)))

        # the convergence tests (lsmr.py:416-448)
        normar_n = zetabar_n.abs()
        normx_n = _col_norm(x)
        test1 = normr_n / sb
        test2 = normar_n / _safe(normA_n * normr_n)
        test3 = 1.0 / _safe(condA_n)
        t1 = test1 / (1 + normA_n * normx_n / sb)
        rtol = btol + atol * normA_n * normx_n / sb

        if itn >= itnlim:
            code = torch.full_like(code, 7)
        code = torch.where(1 + test3 <= 1, 6, code)
        code = torch.where(1 + test2 <= 1, 5, code)
        code = torch.where(1 + t1 <= 1, 4, code)
        code = torch.where(test3 <= ctol, 3, code)
        code = torch.where(test2 <= atol, 2, code)
        code = torch.where(test1 <= rtol, 1, code).to(torch.int32)

        def mc(new, old):
            return torch.where(act, new, old)

        def mv(new, old):
            return _sel(all_active, act, new, old)

        if hist is not None:
            hist[itn] = torch.where(act, normr_n, float("nan"))
        X, H, Hbar = mv(x, X), mv(h, H), mv(hbar, Hbar)
        u, Mu, v, Nv = mv(u2, u), mv(Mu2, Mu), mv(v2, v), mv(Nv2, Nv)
        alpha, beta = mc(alpha2, alpha), mc(beta2, beta)
        zetabar, alphabar = mc(zetabar_n, zetabar), mc(alphabar_n, alphabar)
        rho, rhobar = mc(rho_n, rho), mc(rhobar_n, rhobar)
        cbar, sbar = mc(cbar_n, cbar), mc(sbar_n, sbar)
        betadd, betad = mc(betadd_n, betadd), mc(betad_n, betad)
        rhodold = mc(rhodold_n, rhodold)
        tautildeold = mc(tautildeold_n, tautildeold)
        thetatilde = mc(thetatilde_n, thetatilde)
        zeta, d = mc(zeta_n, zeta), mc(d_n, d)
        normA2 = mc(normA2_n, normA2)
        maxrbar, minrbar = mc(maxrbar_n, maxrbar), mc(minrbar_n, minrbar)
        normr, normar = mc(normr_n, normr), mc(normar_n, normar)
        normA, condA = mc(normA_n, normA), mc(condA_n, condA)
        normx, x_nrg2 = mc(normx_n, normx), mc(x_nrg2_n, x_nrg2)
        istop = mc(code, istop)
        iters = iters + act.to(torch.int32)
        done = done | (act & (code > 0))

    optimal = _isin(istop, _LLS_OPTIMAL)
    info = {"normr": normr, "normar": normar, "normA": normA,
            "condA": condA, "normx": normx, "optimal": optimal,
            "n_iter_columns": iters}
    return _lls_result(X, istop, optimal, itn, normr, normb, hist, info)


def craig_batched(A, B, *, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
                  etol=1.0e-6, window=5, itnlim=None, store_history=False):
    """Solve the regularised SQD system ``[M A; A' -N] [r; x] = [b; 0]``
    (with M = N = I: ``min ||r||^2 + ||x||^2`` subject to ``Ax + r = b``)
    for an (m, K) block of right-hand sides by the generalised CRAIG
    method.

    Each column runs the reference recurrence (``lls/craig.py:104-520``):
    Golub-Kahan steps, rotations of types I and II, the primal and dual
    iterates, energy norms and the dual truncated direct-error stop,
    under a per-column freeze mask, with one A and one A^T block product
    an iteration.  ``atol`` is accepted and unused, as in the single
    solver.  Parameters mirror :func:`~pykrylov_tpu_torch.solvers.craig`
    (no ``store_iterates``/``show``/``verify_final``); ``itnlim`` defaults
    to 3n.  The dual block ``R`` is ``info["r"]`` (m, K); istop codes in
    :data:`ISTOP_MSG_CRAIG`.
    """
    A, B, M, N = _block_rhs("craig_batched", A, B, M, N,
                            square=False)
    itnlim = int(itnlim if itnlim is not None else 3 * A.shape[1])
    window = int(window)
    dtype, dev = B.dtype, B.device
    K = B.shape[1]
    zK = torch.zeros(K, dtype=dtype, device=dev)
    one = torch.ones(K, dtype=dtype, device=dev)

    U, Mu, V, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    x_is_zero = beta == 0
    bnorm = beta
    # the first iteration's start (craig.py:247-268), column by column
    rho = torch.hypot(alpha, one)
    D = U / rho
    tau = beta / rho
    R = tau * D
    rnorm = tau * tau
    c = alpha / rho
    s = 1.0 / rho
    zeta = s * beta
    eta = c * zeta
    xi = s * zeta
    W = c * V
    Wbar = s * V
    X = zeta * W
    xnorm = eta * eta
    r1norm = xi * xi
    hist = _history(store_history, itnlim + 1, torch.sqrt(rnorm))
    arnorm, r_nrg2, x_nrg2 = zK, zK, zK
    d_err = torch.zeros((window, K), dtype=dtype, device=dev)
    istop = torch.zeros(K, dtype=torch.int32, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    done = x_is_zero
    sb = torch.where(bnorm == 0, 1, bnorm)
    itn = 0
    while itn < itnlim:
        any_active, all_active = _poll(~done)
        if not any_active:
            break
        act = ~done
        itn += 1
        U2, Mu2, V2, Nv2, alpha2, beta2 = _gk_step_block(A, M, N, V, Mu, Nv,
                                                         alpha)
        arnorm_n = (alpha * beta2 * s * zeta).abs()

        # rotations of types I and II (craig.py:333-345)
        beta_hat = c * beta2
        gamma = s * beta2
        delta = torch.hypot(gamma, one)
        alpha_hat = torch.hypot(alpha2, delta)
        ah = torch.where(alpha_hat == 0, 1, alpha_hat)
        c_n = alpha2 / ah
        s_n = delta / ah
        s2 = gamma / delta

        # the dual update (craig.py:347-350)
        D2 = (U2 - beta_hat * D) / ah
        tau_n = -beta_hat * tau / ah
        R2 = R + tau_n * D2

        # the primal update (craig.py:354-365)
        zeta_n = -beta_hat * zeta / ah
        eta = c_n * zeta_n
        xi = s_n * zeta_n
        Wbar_s = Wbar * s2
        W2 = c_n * V2 + s_n * Wbar_s
        Wbar2 = -c_n * Wbar_s + s_n * V2
        X2 = X + zeta_n * W2

        # the energy norms and the dual direct-error stop (craig.py:370-379)
        r_nrg2_n = r_nrg2 + tau_n * tau_n
        x_nrg2_n = x_nrg2 + zeta_n * zeta_n
        small = _window_stop(d_err, itn, window, tau_n, act, etol, r_nrg2_n)
        code = torch.where(act & small, 8, istop)

        rnorm_n = rnorm + tau_n * tau_n
        xnorm_n = xnorm + eta * eta
        r1norm_n = r1norm + xi * xi

        # the active tests (craig.py:438-457)
        test1 = torch.sqrt(rnorm_n) / sb
        if itn >= itnlim:
            code = torch.where(act, 7, code)
        code = torch.where(act & (1 + test1 <= 1), 4, code)
        code = torch.where(act & (test1 <= btol), 1, code).to(torch.int32)

        def mc(new, old):
            return torch.where(act, new, old)

        def mv(new, old):
            return _sel(all_active, act, new, old)

        if hist is not None:
            hist[itn] = torch.where(act, torch.sqrt(rnorm_n), float("nan"))
        X, R, W, Wbar, D = (mv(X2, X), mv(R2, R), mv(W2, W),
                            mv(Wbar2, Wbar), mv(D2, D))
        U, Mu, V, Nv = mv(U2, U), mv(Mu2, Mu), mv(V2, V), mv(Nv2, Nv)
        alpha, beta = mc(alpha2, alpha), mc(beta2, beta)
        c, s = mc(c_n, c), mc(s_n, s)
        zeta, tau = mc(zeta_n, zeta), mc(tau_n, tau)
        rnorm, r1norm = mc(rnorm_n, rnorm), mc(r1norm_n, r1norm)
        xnorm, arnorm = mc(xnorm_n, xnorm), mc(arnorm_n, arnorm)
        r_nrg2, x_nrg2 = mc(r_nrg2_n, r_nrg2), mc(x_nrg2_n, x_nrg2)
        istop = code
        done = done | (istop > 0)
        iters = iters + act.to(torch.int32)

    optimal = _isin(istop, _LLS_OPTIMAL)
    X = torch.where(x_is_zero, 0, X)
    R = torch.where(x_is_zero, 0, R)
    info = {"r": R, "r1norm": torch.sqrt(r1norm),
            "r2norm": torch.sqrt(rnorm), "Arnorm": arnorm, "xnorm": xnorm,
            "rNrgNorm2": r_nrg2, "xNrgNorm2": x_nrg2, "optimal": optimal,
            "n_iter_columns": iters}
    return _lls_result(X, istop, optimal, itn, torch.sqrt(rnorm), bnorm,
                       hist, info)


def craigmr_batched(A, B, *, M=None, N=None, etol=1.0e-6, window=5,
                    itnlim=None, store_history=False):
    """Solve the least-norm minimum-residual problem for an (m, K) block
    of right-hand sides by CRAIG-MR: per column the dual iterate y of
    ``(A N^{-1} A' + M) y = b``.

    Each column runs the reference recurrence (``lls/craigmr.py:51-250``:
    rotations I, II and III, the dual-space iterate of dimension m, the
    truncated direct-error stop as the only active test; the stray debug
    print is not replicated) under a per-column freeze mask, with one A
    and one A^T block product an iteration.  Parameters mirror
    :func:`~pykrylov_tpu_torch.solvers.craigmr`; ``itnlim`` defaults to
    min(m, n).  ``x`` is the (m, K) dual block; istop codes in
    :data:`ISTOP_MSG_CRAIGMR`.
    """
    A, B, M, N = _block_rhs("craigmr_batched", A, B, M, N,
                            square=False)
    itnlim = int(itnlim if itnlim is not None else min(A.shape))
    window = int(window)
    dtype, dev = B.dtype, B.device
    m, K = A.shape[0], B.shape[1]
    zK = torch.zeros(K, dtype=dtype, device=dev)
    one = torch.ones(K, dtype=dtype, device=dev)

    U, Mu, V, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    beta0 = beta
    x_is_zero = alpha * beta == 0
    # the first iteration's start (craigmr.py:104-120), column by column
    alpha_hat = torch.hypot(alpha, one)
    c = alpha / alpha_hat
    s = 1.0 / alpha_hat
    zeta_hat, alpha_tilde, theta = beta, alpha_hat, zK
    D = U / alpha_hat
    hist = _history(store_history, itnlim + 1, beta)
    X = torch.zeros((m, K), dtype=dtype, device=dev)
    Dbar = torch.zeros_like(X)
    zeta, x_nrg2 = zK, zK
    d_err = torch.zeros((window, K), dtype=dtype, device=dev)
    istop = torch.zeros(K, dtype=torch.int32, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    done = x_is_zero
    itn = 0
    while itn < itnlim:
        any_active, all_active = _poll(~done)
        if not any_active:
            break
        act = ~done
        itn += 1
        U2, Mu2, V2, Nv2, alpha2, beta2 = _gk_step_block(A, M, N, V, Mu, Nv,
                                                         alpha)

        # rotations I, II and III (craigmr.py:161-185)
        beta_hat = c * beta2
        gamma = s * beta2
        delta = torch.hypot(gamma, one)
        alpha_hat = torch.hypot(alpha2, delta)
        ah = torch.where(alpha_hat == 0, 1, alpha_hat)
        c_n = alpha2 / ah
        s_n = delta / ah
        rho = torch.hypot(alpha_tilde, beta_hat)
        rh = torch.where(rho == 0, 1, rho)
        c_hat = alpha_tilde / rh
        s_hat = beta_hat / rh

        Dbar2 = (D - theta * Dbar) / rh
        theta_n = s_hat * ah
        alpha_tilde_n = -c_hat * ah
        zeta_n = c_hat * zeta_hat
        zeta_hat_n = s_hat * zeta_hat
        x_nrg2_n = x_nrg2 + zeta_n * zeta_n
        D2 = (U2 - beta_hat * D) / ah
        X2 = X + zeta_n * Dbar2

        # the stop tests (craigmr.py:202-212)
        small = _window_stop(d_err, itn, window, zeta_n, act, etol, x_nrg2_n)
        code = torch.where(act & small, 8, istop)
        if itn >= itnlim:
            code = torch.where(act, 7, code)
        code = code.to(torch.int32)

        def mc(new, old):
            return torch.where(act, new, old)

        def mv(new, old):
            return _sel(all_active, act, new, old)

        if hist is not None:
            hist[itn] = torch.where(act, zeta_n.abs(), float("nan"))
        X, D, Dbar = mv(X2, X), mv(D2, D), mv(Dbar2, Dbar)
        U, Mu, V, Nv = mv(U2, U), mv(Mu2, Mu), mv(V2, V), mv(Nv2, Nv)
        alpha, beta = mc(alpha2, alpha), mc(beta2, beta)
        c, s = mc(c_n, c), mc(s_n, s)
        zeta_hat, alpha_tilde = (mc(zeta_hat_n, zeta_hat),
                                 mc(alpha_tilde_n, alpha_tilde))
        theta, zeta = mc(theta_n, theta), mc(zeta_n, zeta)
        x_nrg2 = mc(x_nrg2_n, x_nrg2)
        istop = code
        done = done | (istop > 0)
        iters = iters + act.to(torch.int32)

    converged = x_is_zero | (istop == 8)
    info = {"xNrgNorm2": x_nrg2, "trncDirErr": _col_norm(d_err),
            "optimal": converged, "n_iter_columns": iters}
    return _lls_result(X, istop, converged, itn, zeta.abs(), beta0, hist,
                       info)


# ---------------------------------------------------------------------------
# The verified block twins: ff cg_batched and ff minres_batched
# ---------------------------------------------------------------------------

def _ff_product(A, ff_mm, Xh, Xl):
    """``A (Xh + Xl)`` as an (hi, lo) pair of blocks: the compensated block
    product where the storage has one, else one (n, 2K) block product of
    ``[Xh, Xl]`` (one SpMM launch instead of two)."""
    if ff_mm is not None:
        return ff_mm(Xh, Xl)
    K = Xh.shape[1]
    SS = _apply_block(A, torch.cat([Xh, Xl], dim=1))
    return SS[:, :K], SS[:, K:]


def _cg_batched_verified(A, B, X0, M, rtol, atol, maxiter, check_curvature,
                         store_history, replace_every, leg_rtol, ff_mm):
    """The JAX package's ``replace_every`` branch of ``_cg_batched``
    (``batched.py:98-248``), the per-column mirror of single ff-CG.

    When a column's recurrence claims its leg target, or every
    ``replace_every`` iterations, the true residual block is recomputed
    from the (hi, lo) iterate, through one compensated block product or
    one (n, 2K) product of ``[X, X_lo]``, and that column's direction
    restarts from it; ``n_replacements`` counts each column's
    replacements, ``n_matvec`` each product once (twice without a
    compensated product).  Each iteration reads the host once: whether any
    column verifies, and whether any would stay active if none did; a
    verification, which runs only when that read says some column is due,
    adds one more read, of the columns still active."""
    dtype, dev = B.dtype, B.device
    n, K = B.shape
    if X0 is None:
        X = torch.zeros_like(B)
        R = B
        extra = 0
    else:
        X = X0.to(device=dev, dtype=dtype)
        R = B - _apply_block(A, X)
        extra = 1
    Z = torch.zeros_like(B)
    Xl = Rl = Z
    Y = _apply_block(M, R) if M is not None else R
    ry = _col_dot(R, Y)
    resid0 = _col_norm(R)
    thresh = threshold_of(resid0, rtol, atol)
    hist = _history(store_history, maxiter + 1, resid0)

    P = Y
    resid = leg_r0 = resid0
    active = resid0 > thresh
    definite = torch.ones(K, dtype=torch.bool, device=dev)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    nrep_cols = torch.zeros(K, dtype=torch.int32, device=dev)
    nrep_evts = 0
    one = torch.ones((), dtype=ry.dtype, device=dev)
    k = 0
    any_active = bool(active.any())
    while any_active and k < maxiter:
        if ff_mm is not None:
            AP, APl = ff_mm(P, Z)
            pAp = _col_dot(P, AP) + _col_dot(P, APl)
        else:
            AP, APl = _apply_block(A, P), None
            pAp = _col_dot(P, AP)
        bad = active & (pAp <= 0) if check_curvature \
            else torch.zeros_like(active)
        act = active & ~bad
        alpha = torch.where(act, ry / torch.where(pAp == 0, one, pAp),
                            0).to(dtype)
        ps, pe = two_prod(alpha, P)
        X2, Xl2 = ff_add_ff(X, Xl, ps, pe)
        qs, qe = two_prod(-alpha, AP)
        if APl is not None:
            qe = qe - alpha * APl
        R2, Rl2 = ff_add_ff(R, Rl, qs, qe)
        Y2 = _apply_block(M, R2) if M is not None else R2
        ry2 = _col_dot(R2, Y2)
        res2 = _col_norm(R2)
        do_rep = act if (k + 1) % replace_every == 0 else \
            act & (res2 <= torch.maximum(leg_rtol * leg_r0, thresh))
        stays = act & ~((res2 <= thresh) | ~torch.isfinite(res2))
        any_rep, any_active = torch.stack([do_rep.any(),
                                           stays.any()]).tolist()
        if any_rep:
            Sh, Sl = _ff_product(A, ff_mm, X2, Xl2)
            D, De = two_sum(B, -Sh)
            Rt, Rtl = two_sum(D, De - Sl)
            R2 = torch.where(do_rep, Rt, R2)
            Rl2 = torch.where(do_rep, Rtl, Rl2)
            Y2 = _apply_block(M, R2) if M is not None else R2
            ry2 = _col_dot(R2, Y2)
            res2 = torch.where(do_rep, _col_norm(Rt), res2)
            nrep_evts += 1
        nrep_cols += do_rep.to(torch.int32)
        leg_r0 = torch.where(do_rep, res2, leg_r0)
        beta = torch.where(act, ry2 / torch.where(ry == 0, one, ry),
                           0).to(dtype)
        P = torch.where(act, torch.where(do_rep, Y2, Y2 + beta * P), P)
        resid2 = torch.where(act, res2, resid)
        done = act & ((resid2 <= thresh) | ~torch.isfinite(resid2))
        if hist is not None:
            hist[k + 1] = torch.where(active, resid2, float("nan"))
        # both halves of each pair are masked: ff_add_ff renormalizes a
        # frozen column's (hi, lo) even under a zero update
        X = torch.where(act, X2, X)
        Xl = torch.where(act, Xl2, Xl)
        R = torch.where(act, R2, R)
        Rl = torch.where(act, Rl2, Rl)
        Y = torch.where(act, Y2, Y)
        ry = torch.where(act, ry2, ry)
        resid = resid2
        iters += active.to(torch.int32)
        definite &= ~bad
        active = act & ~done
        k += 1
        count("cg_batched.plain")
        if any_rep:
            any_active = bool(active.any())

    converged = resid <= thresh
    istop = torch.where(converged, 0, torch.where(definite, 1, 2))
    info = {"definite": definite, "n_iter_columns": iters,
            "active_at_exit": active, "n_replacements": nrep_cols,
            "x_lo": Xl}
    n_matvec = k + extra + nrep_evts * (1 if ff_mm is not None else 2)
    return SolveResult(
        x=X, converged=converged, istop=istop.to(torch.int32),
        n_iter=torch.tensor(k, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor(n_matvec, dtype=torch.int32, device=dev),
        resid_norm=resid, resid_norm0=resid0, resid_history=hist, info=info)


def _minres_batched_ff(A, B, M, shift, rtol, atol, itnlim, replace_every,
                       ff_mm):
    """Verified MINRES on a block, the JAX package's
    ``_minres_batched_ff`` (``batched.py:2058-2258``): single ff-MINRES's
    recurrence per column, with every scalar a (K,) (hi, lo) pair and every
    vector an (n, K) pair on the device, as in the JAX package's loop
    body; istop 1 fires per column only on its recomputed true residual.
    Each iteration applies A to ``[v, v_lo]`` in one (n, 2K) block product
    (or the compensated block product) and reads the host once: whether
    any column verifies and whether any would stay active if none did; a
    verification, one more block product of ``[x, x_lo]``, runs only when
    that read says some column is due and adds one read."""
    dtype, dev = B.dtype, B.device
    n, K = B.shape
    eps = torch.finfo(dtype).eps
    zK = torch.zeros(K, dtype=dtype, device=dev)
    Z = torch.zeros_like(B)
    shift_t = torch.tensor(shift, dtype=dtype, device=dev)

    Y = _apply_block(M, B) if M is not None else B
    beta1_sq = _col_dot(B, Y).to(dtype)
    indef_precon = beta1_sq < 0              # istop 9
    zero_b = beta1_sq == 0
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    bnorm = _col_norm(B)
    vthresh = torch.maximum(torch.full_like(bnorm, atol), rtol * bnorm)

    x = xl = r1l = r2l = yl = w = wl = w2 = w2l = Z
    r1 = r2 = B
    y = Y
    oldb = oldbl = betal = dbar = dbarl = epsln = epslnl = phibarl = zK
    csl = sn = snl = tnorm2 = gmax = gmin = zK
    beta = phibar = beta1
    cs = -torch.ones(K, dtype=dtype, device=dev)
    rnt = bnorm
    lastv = torch.zeros(K, dtype=torch.int32, device=dev)
    nrep = torch.zeros(K, dtype=torch.int32, device=dev)
    nrep_evts = 0
    istop = torch.where(indef_precon, 9, 0).to(torch.int32)
    iters = torch.zeros(K, dtype=torch.int32, device=dev)
    done = indef_precon | zero_b
    itn = 0
    running = bool((~done).any())
    while running and itn < itnlim:
        act = ~done
        itn += 1
        # ---- double-f32 Lanczos, column by column -------------------------
        v, vl = ff_div(y, yl, beta, betal)
        y, ylo = _ff_product(A, ff_mm, v, vl)
        ph0, pe0 = two_prod(-shift_t, v)
        y, ylo = ff_add_ff(y, ylo, ph0, pe0 - shift_t * vl)
        if itn >= 2:
            c1, c1l = ff_div(beta, betal, oldb, oldbl)
            t1h, t1l = two_prod(-c1, r1)
            y, ylo = ff_add_ff(y, ylo, t1h, t1l - c1 * r1l - c1l * r1)
        alfa, alfal = ff_vdot_cols(v, vl, y, ylo)
        c2, c2l = ff_div(alfa, alfal, beta, betal)
        t2h, t2l = two_prod(-c2, r2)
        y, ylo = ff_add_ff(y, ylo, t2h, t2l - c2 * r2l - c2l * r2)
        r1n, r1ln = r2, r2l
        r2n, r2ln = y, ylo
        if M is not None:
            yn, yln = _apply_block(M, r2n), _apply_block(M, r2ln)
        else:
            yn, yln = r2n, r2ln
        oldbn, oldbln = beta, betal
        beta_sq, beta_sql = ff_vdot_cols(r2n, r2ln, yn, yln)
        indef = act & (beta_sq < 0)          # istop 6
        go = act & ~indef
        istop = torch.where(indef, 6, istop).to(torch.int32)

        pos = beta_sq > 0
        betan, betaln = ff_sqrt(torch.clamp(beta_sq, min=0), beta_sql)
        betan = torch.where(pos, betan, 0.0)
        betaln = torch.where(pos, betaln, 0.0)
        tnorm2n = tnorm2 + alfa ** 2 + oldbn ** 2 + betan ** 2
        if itn == 1:
            near_const = betan / torch.where(beta1 == 0, 1, beta1) \
                <= 10 * eps
            istop = torch.where(go & near_const, -1, istop).to(torch.int32)
            gmax0 = gmin0 = alfa.abs()
        else:
            gmax0, gmin0 = gmax, gmin

        # ---- double-f32 Givens chain ------------------------------------
        oldeps, oldepsl = epsln, epslnl
        d1h, d1l = ff_mul(cs, csl, dbar, dbarl)
        d2h, d2l = ff_mul(sn, snl, alfa, alfal)
        delta, deltal = ff_add_ff(d1h, d1l, d2h, d2l)
        g1h, g1l = ff_mul(sn, snl, dbar, dbarl)
        g2h, g2l = ff_mul(cs, csl, alfa, alfal)
        gbar, gbarl = ff_add_ff(g1h, g1l, -g2h, -g2l)
        epslnn, epslnln = ff_mul(sn, snl, betan, betaln)
        dbarn, dbarln = ff_mul(-cs, -csl, betan, betaln)
        gamma, gammal = ff_hypot(gbar, gbarl, betan, betaln)
        gammal = torch.where(gamma <= eps, 0.0, gammal)
        gamma = torch.clamp(gamma, min=eps)
        csn, csln = ff_div(gbar, gbarl, gamma, gammal)
        snn, snln = ff_div(betan, betaln, gamma, gammal)
        phi, phil = ff_mul(csn, csln, phibar, phibarl)
        phibarn, phibarln = ff_mul(snn, snln, phibar, phibarl)

        # ---- double-f32 w recurrence and x update -----------------------
        t1h, t1l = two_prod(-oldeps, w2)
        t1l = t1l - oldeps * w2l - oldepsl * w2
        t2h, t2l = two_prod(-delta, w)
        t2l = t2l - delta * wl - deltal * w
        sh, sl = two_sum(v, t1h)
        sh, e2 = two_sum(sh, t2h)
        wn, wln = ff_div(sh, sl + e2 + t1l + t2l + vl, gamma, gammal)
        uh, ue = two_prod(phi, wn)
        xn, xln = ff_add_ff(x, xl, uh, ue + phi * wln + phil * wn)

        gmaxn = torch.maximum(gmax0, gamma)
        gminn = torch.minimum(gmin0, gamma)
        acond = gmaxn / torch.where(gminn == 0, 1, gminn)

        # ---- verified stopping ------------------------------------------
        code = torch.where(acond >= 0.1 / eps, 4,
                           6 if itn >= itnlim else 0)
        istop = torch.where(go & (istop == 0), code, istop).to(torch.int32)
        do_ver = go & (phibarn <= vthresh) & (itn - lastv >= 5)
        if itn % replace_every == 0:
            do_ver = go.clone()
        stays = ~(done | (istop != 0))
        any_ver, running = torch.stack([do_ver.any(),
                                        stays.any()]).tolist()
        if any_ver:
            sh2, sl2 = _ff_product(A, ff_mm, xn, xln)
            ph, pe = two_prod(shift_t, xn)
            d, de = two_sum(B, -sh2)
            d2, de2 = two_sum(d, ph)
            rt = d2 + (de + de2 + pe + shift_t * xln - sl2)
            rnt = torch.where(do_ver, _col_norm(rt), rnt)
            istop = torch.where(go & (istop == 0) & do_ver & (rnt <= vthresh),
                                1, istop).to(torch.int32)
            nrep_evts += 1

        def mc(new, old):
            return torch.where(go, new, old)

        x, xl = mc(xn, x), mc(xln, xl)
        r1, r1l, r2, r2l = mc(r1n, r1), mc(r1ln, r1l), mc(r2n, r2), \
            mc(r2ln, r2l)
        y, yl = mc(yn, y), mc(yln, yl)
        w2, w2l, w, wl = mc(w, w2), mc(wl, w2l), mc(wn, w), mc(wln, wl)
        oldb, oldbl = mc(oldbn, oldb), mc(oldbln, oldbl)
        beta, betal = mc(betan, beta), mc(betaln, betal)
        dbar, dbarl = mc(dbarn, dbar), mc(dbarln, dbarl)
        epsln, epslnl = mc(epslnn, epsln), mc(epslnln, epslnl)
        phibar, phibarl = mc(phibarn, phibar), mc(phibarln, phibarl)
        cs, csl, sn, snl = mc(csn, cs), mc(csln, csl), mc(snn, sn), \
            mc(snln, snl)
        tnorm2 = mc(tnorm2n, tnorm2)
        gmax, gmin = mc(gmaxn, gmax), mc(gminn, gmin)
        lastv = mc(torch.where(do_ver, itn, lastv), lastv).to(torch.int32)
        nrep += do_ver.to(torch.int32)
        iters += act.to(torch.int32)
        done = done | (istop != 0)
        if any_ver:
            running = bool((~done).any())

    converged = zero_b | (istop == 1)
    mult = 1 if ff_mm is not None else 2
    return SolveResult(
        x=torch.where(zero_b[None, :], 0, x), converged=converged,
        istop=istop,
        n_iter=torch.tensor(itn, dtype=torch.int32, device=dev),
        n_matvec=torch.tensor((itn + nrep_evts) * mult, dtype=torch.int32,
                              device=dev),
        resid_norm=torch.where(zero_b, zK, rnt), resid_norm0=bnorm,
        resid_history=None,
        info={"n_replacements": nrep, "x_lo": xl, "n_iter_columns": iters,
              "active_at_exit": ~done})
