"""Numerics utilities.

Counterpart of ``pykrylov_tpu/utils/utils.py``, after the reference helpers
(PyKrylov's ``pykrylov/tools/utils.py``): machine epsilon, a stable
quadratic-root solver with Newton refinement, and randomized symmetry and
positive-definiteness probes usable as test oracles.  The probes draw from
an explicit ``torch.Generator`` on the operator's device (seed 1, as the
JAX package's ``PRNGKey(1)`` and the reference's ``np.random.seed(1)``) and
apply the operator once to the whole (n, nprobe) probe block through its
native block rule: on a ``cuda-dia`` or BELL operator that is one SpMM
launch, not one SpMV launch per probe.
"""

from __future__ import annotations

import math

import torch

from .types import as_dtype

__all__ = ["machine_epsilon", "roots_quadratic", "check_symmetric",
           "check_positive_definite"]


def machine_epsilon(dtype=None) -> float:
    """Unit roundoff of ``dtype`` (default: torch's default float)."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    return float(torch.finfo(as_dtype(dtype)).eps)


def roots_quadratic(q2, q1, q0, tol=1.0e-8, nitref=1):
    """Real roots of q2 x^2 + q1 x + q0, numerically stable.

    Handles the degenerate linear and constant cases, picks the root formula
    that avoids cancellation, and polishes each root with ``nitref`` Newton
    steps (the GALAHAD ROOTS approach of the reference's
    ``tools/utils.py:12-60``).  Returns a list of real roots (possibly
    empty).
    """
    q2, q1, q0 = float(q2), float(q1), float(q0)
    a_big = max(abs(q0), abs(q1), abs(q2))
    if a_big == 0.0:
        return [0.0]  # identically zero polynomial: report 0
    # Degeneracy decided on coefficients normalized by the largest one, so a
    # huge |q1| cannot absorb a genuinely nonzero leading coefficient.
    eps64 = machine_epsilon(torch.float64)
    if abs(q2) == 0.0 or abs(q2 / a_big) <= tol * eps64 / 1e-8:
        if abs(q1) == 0.0:
            roots = [] if abs(q0) > 0.0 else [0.0]
        else:
            roots = [-q0 / q1]
    else:
        disc = q1 * q1 - 4.0 * q2 * q0
        if disc < 0.0:
            return []
        sq = math.sqrt(disc)
        # Root with the sign choice that avoids cancellation.
        big = -0.5 * (q1 + sq) if q1 >= 0.0 else -0.5 * (q1 - sq)
        roots = [big / q2, q0 / big] if big != 0.0 else [0.0, 0.0]

    polished = []
    for r in roots:
        for _ in range(nitref):
            val = (q2 * r + q1) * r + q0
            der = 2.0 * q2 * r + q1
            if der != 0.0:
                r = r - val / der
        polished.append(r)
    return polished


def _apply_block(op, X):
    """``op @ X`` through the operator's native block rule, uncounted."""
    # imported here: ops.base imports utils.types, so a module-level import
    # would be circular
    from ..ops.base import _block_apply
    return _block_apply(op, op._mv, X)


def _probes(op, nprobe, generator):
    """(eps of the real dtype, an (n, nprobe) block of standard normal
    probes in the operator's dtype), drawn on the operator's device."""
    dtype = op.dtype
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    if generator is None:
        generator = torch.Generator(device=op.device).manual_seed(1)
    X = torch.randn((op.shape[1], nprobe), dtype=rdtype, device=op.device,
                    generator=generator).to(dtype)
    return machine_epsilon(rdtype), X


def check_symmetric(op, generator=None, nprobe: int = 10, tol=None) -> bool:
    """Randomized symmetry test: compares <Ax, Ax> with <x, A(Ax)>.

    Same oracle as the reference (``tools/utils.py:63-85``): random probes,
    the operator applied twice, and the two inner products compared against
    a scale-aware threshold.  The probes are drawn in the operator's dtype,
    so the products stay in the operator's own kernel entry.  Counts two
    applications per probe in ``op.nMatvec``, as the reference does.
    """
    m, n = op.shape
    if m != n:
        return False
    eps, X = _probes(op, nprobe, generator)
    AX = _apply_block(op, X)
    AAX = _apply_block(op, AX)
    op._nMatvec += 2 * nprobe
    # Unconjugated dots, as the reference's np.dot (tools/utils.py:74-75):
    # this tests symmetry; a conjugated dot would test hermitian-ness and
    # reject complex symmetric operators.
    s1 = (AX * AX).sum(dim=0).tolist()
    s2 = (X * AAX).sum(dim=0).tolist()
    for a, b in zip(s1, s2):
        thresh = tol if tol is not None else (abs(a) + eps) * eps ** (1 / 3)
        if abs(a - b) > thresh:
            return False
    return True


def check_positive_definite(op, generator=None, nprobe: int = 10,
                            semi: bool = False) -> bool:
    """Randomized positive-(semi)definiteness test via <x, Ax> probes.

    Mirrors the reference oracle (``tools/utils.py:88-112``); counts one
    application per probe in ``op.nMatvec``.
    """
    m, n = op.shape
    if m != n:
        return False
    eps, X = _probes(op, nprobe, generator)
    AX = _apply_block(op, X)
    op._nMatvec += nprobe
    xAx = (X.conj() * AX).sum(dim=0).tolist()
    xx = (X.conj() * X).real.sum(dim=0).tolist()
    for v, nx in zip(xAx, xx):
        if isinstance(v, complex):
            if abs(v.imag) > eps ** (1 / 3) * abs(v):
                return False
            v = v.real
        if v <= (-eps if semi else eps * nx):
            return False
    return True
