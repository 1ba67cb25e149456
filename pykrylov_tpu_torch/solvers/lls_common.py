"""Shared plumbing for the least-squares (LLS) solver family.

Counterpart of ``pykrylov_tpu/solvers/lls_common.py``.  The four LLS
solvers (LSQR, LSMR, CRAIG, CRAIG-MR) drive the same Golub-Kahan
bidiagonalization of A with optional *inner* preconditioners M (on the
m-side) and N (on the n-side):

    beta * M u = A v   - alpha * M u
    alpha * N v = A' u -  beta * N v

with M-weighted norms ``beta = sqrt(u' M u)`` and ``alpha = sqrt(v' N v)``
(reference ``lls/lsqr.py:188-210,252-272`` and the identical blocks of
``lsmr.py``, ``craig.py`` and ``craigmr.py``).  M and N apply the
*inverse* weights (the reference calls them as ``u = M(Mu)``), like
preconditioners.

A step runs on the device of its vectors with no host read: ``beta`` and
``alpha`` stay 0-d tensors, so ``u = Mu / beta`` is formed before ``A'u``,
and the reference's guard that leaves a vector unnormalized when its norm
is zero selects the divisor on the device.  The solver then reads both
norms, with whatever else its iteration needs, in one synchronisation
(:func:`gk_read`), which also applies the guard that keeps the previous
``v`` when ``beta`` is zero: that one needs no vector work, only the
previous tensors.  The rotations then run on Python floats
(:func:`sym_ortho`).
"""

from __future__ import annotations

import math

import torch

from .common import apply_op, apply_op_T, vdot_real

__all__ = ["sym_ortho", "gk_init", "gk_step", "gk_read"]


def _sign(x):
    return -1.0 if x < 0 else 1.0


def sym_ortho(a, b):
    """Stable Givens rotation (c, s, r) with r = hypot(a, b), on host
    floats.

    The reference ``symOrtho`` (``lls/lsmr.py:500-519``, after Choi's
    thesis), branch for branch, with its sign conventions: ``sign(0) ==
    1``, and ``b == 0`` taking precedence over ``a == 0``.  The JAX
    package's branch-free version computes the same operations in the same
    order, so the two agree bit for bit.
    """
    a, b = float(a), float(b)
    if b == 0:
        return _sign(a), 0.0, abs(a)
    if a == 0:
        return 0.0, _sign(b), abs(b)
    if abs(b) > abs(a):
        tau = a / b
        s = _sign(b) / math.sqrt(1 + tau * tau)
        return s * tau, s, b / s
    tau = b / a
    c = _sign(a) / math.sqrt(1 + tau * tau)
    return c, c * tau, a / c


def _wnorm(v, Nv):
    """``sqrt(max(v' N v, 0))`` as a 0-d tensor on the vectors' device."""
    return torch.sqrt(torch.clamp(vdot_real(v, Nv), min=0))


def _normalize(v, norm):
    """``v / norm`` where ``norm > 0``, else ``v`` as it is: the divisor is
    selected on the device."""
    return v / torch.where(norm > 0, norm, 1.0)


def _weighted(W, Wv):
    """``(v, Wv)`` normalized by ``sqrt(v' Wv)`` with ``v = W(Wv)``, and the
    norm; without a weight ``v`` is ``Wv``, one tensor normalized once."""
    if W is None:
        norm = _wnorm(Wv, Wv)
        v = Wv = _normalize(Wv, norm)
        return v, Wv, norm
    v = apply_op(W, Wv)
    norm = _wnorm(v, Wv)
    return _normalize(v, norm), _normalize(Wv, norm), norm


def gk_init(A, b, M, N):
    """Start the bidiagonalization: ``beta M u = b``, ``alpha N v = A'u``.

    Returns (u, Mu, v, Nv, alpha, beta) with ``alpha`` and ``beta`` host
    floats, read in one synchronisation.  When beta == 0 (zero rhs) or
    alpha == 0 (b orthogonal to the range of A) the vectors stay
    unnormalized, as in the reference (``lsqr.py:188-210``); alpha is 0
    when beta is.
    """
    u, Mu, beta = _weighted(M, b)
    v, Nv, alpha = _weighted(N, apply_op_T(A, u))
    beta, alpha = torch.stack([beta, alpha]).tolist()
    if beta == 0:
        alpha = 0.0
    return u, Mu, v, Nv, alpha, beta


def gk_step(A, M, N, v, Mu, Nv, alpha):
    """One bidiagonalization step from ``v``, ``Mu``, ``Nv`` and the
    previous ``alpha`` (a host float); returns (u, Mu, v, Nv, alpha, beta)
    with the new ``alpha`` and ``beta`` 0-d tensors.

    The reference (``lsqr.py:252-272``) skips the v update when the new
    beta is zero; :func:`gk_read` applies that after the read.
    """
    u, Mu, beta = _weighted(M, torch.sub(apply_op(A, v), Mu, alpha=alpha))
    v, Nv, alpha = _weighted(N, apply_op_T(A, u) - beta * Nv)
    return u, Mu, v, Nv, alpha, beta


def gk_read(step, prev, *extra):
    """The iteration's one host read: ``step``'s beta and alpha and the
    real tensors ``extra`` (flattened), in one ``tolist()``.

    ``prev`` is the (v, Nv, alpha) the step started from: when the new beta
    is zero the reference leaves v, Nv and alpha as they were, and so does
    this.  Returns ((u, Mu, v, Nv), alpha, beta, extra floats).
    """
    u, Mu, v, Nv, alpha_t, beta_t = step
    vals = torch.cat([t.reshape(-1).to(beta_t.dtype)
                      for t in (beta_t, alpha_t) + extra]).tolist()
    beta, alpha = vals[0], vals[1]
    if beta == 0:
        v, Nv, alpha = prev
    return (u, Mu, v, Nv), alpha, beta, vals[2:]
