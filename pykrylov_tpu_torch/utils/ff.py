"""Double-f32 ("float-float") compensated arithmetic.

Counterpart of ``pykrylov_tpu/utils/ff.py``.  These error-free transforms
carry a value as an (hi, lo) pair of working-precision numbers, about
twice the working precision: in float32 a pair holds ~49 bits, in float64
the same functions give double-double pairs.  The verified solvers carry
the solution (ff-CG) or the whole recurrence (ff-MINRES) in pairs and
evaluate true residuals below the plain matvec floor (~eps·|A||x|).

Every function is written from plain tensor ``+``, ``-``, ``*`` and ``/``
(and a correctly rounded square root), one operation a call, so each
result rounds on its own: the transforms are exact only without fused
multiply-adds, so nothing here may use ``addcmul``, ``addcdiv``, ``lerp``,
``add(..., alpha=)`` or ``torch.compile``.  TwoSum is Knuth's branchless
6-flop version; TwoProd uses Dekker splitting (factor 2^12+1 for float32,
2^27+1 for float64).  The arguments are tensors, 0-d ones for scalars.
References: Dekker 1971; Ogita, Rump & Oishi 2005.

On a mesh of ranks (rank-sharded operands, :mod:`.ranks`) the compensated
reductions take each rank's (hi, lo) partial pair, all-gather them and
combine them in rank order with TwoSum, so every rank holds the same pair
and a one-rank world gives the plain pair bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ranks

__all__ = ["two_sum", "two_prod", "ff_add", "ff_add_ff", "ff_renorm",
           "ff_scale", "ff_div", "ff_mul", "ff_sqrt", "ff_hypot",
           "ff_sum", "ff_vdot", "ff_dot2", "ff_sum_cols", "ff_vdot_cols"]

# Dekker split factors 2^ceil(p/2)+1: binary32 (p=24) and binary64 (p=53).
_SPLIT32 = 4097.0
_SPLIT64 = 134217729.0


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    ap = s - b
    bp = s - ap
    da = a - ap
    db = b - bp
    return s, da + db


def _split(a):
    f = _SPLIT32 if a.dtype.itemsize <= 4 else _SPLIT64
    c = f * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b), p + e = a*b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ff_renorm(h, l):
    """Canonicalize an (hi, lo) pair so |lo| <= ulp(hi)/2."""
    return two_sum(h, l)


def ff_add(h, l, b):
    """(h, l) + b where b is a plain value or vector."""
    s, e = two_sum(h, b)
    return ff_renorm(s, e + l)


def ff_add_ff(h, l, bh, bl):
    """(h, l) + (bh, bl)."""
    s, e = two_sum(h, bh)
    return ff_renorm(s, e + l + bl)


def ff_scale(a, vh, vl):
    """Scalar a times pair (vh, vl): exact product of the hi part plus
    first-order lo terms."""
    p, e = two_prod(a, vh)
    return ff_renorm(p, e + a * vl)


def ff_div(h, l, d, dl=None):
    """Pair (h, l) divided by ``d`` (plain, or a pair when ``dl`` is
    given): quotient hi part plus the first-order Newton correction
    ``(h - q*d + l - q*dl) / d`` with the ``q*d`` product taken error-free
    (``h - p`` is exact by Sterbenz since ``p = fl(q*d) ≈ h``)."""
    q = h / d
    p, pe = two_prod(q, d)
    corr = (h - p) - pe + l
    if dl is not None:
        corr = corr - q * dl
    return ff_renorm(q, corr / d)


def ff_mul(ah, al, bh, bl):
    """Pair (ah, al) times pair (bh, bl) to first order."""
    p, pe = two_prod(ah, bh)
    return ff_renorm(p, pe + ah * bl + al * bh)


def _sqrt(a):
    """The correctly rounded square root.  torch's CPU kernel is a
    vectorized approximation, a few hundred in 10^5 results one ulp off
    (the CUDA kernel, NumPy's and XLA's are exact), so a CPU tensor takes
    NumPy's."""
    if a.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(a.numpy())))
    return torch.sqrt(a)


def ff_sqrt(h, l):
    """Square root of a pair via one Newton correction:
    ``s + (h - s^2 + l) / (2s)`` with ``s^2`` taken error-free."""
    s = _sqrt(h)
    p, pe = two_prod(s, s)
    return ff_renorm(s, ((h - p) - pe + l) / (2.0 * s))


def ff_hypot(ah, al, bh, bl):
    """sqrt(a^2 + b^2) of two pairs (no overflow guard: callers square
    quantities far inside the range)."""
    sh, sl = ff_add_ff(*ff_mul(ah, al, ah, al), *ff_mul(bh, bl, bh, bl))
    return ff_sqrt(sh, sl)


def _pairwise(p):
    """The pairwise TwoSum tree over axis 0 of ``p`` (padded with zeros to
    a power of two): log2(n) sweeps of strided halves, each level's
    rounding errors summed into a plain running correction (their own
    rounding is second order).  Returns (top, correction)."""
    n = p.shape[0]
    m = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if m != n:
        p = torch.cat([p, p.new_zeros((m - n,) + tuple(p.shape[1:]))])
    err = p.new_zeros(p.shape[1:])
    while m > 1:
        s, e = two_sum(p[0::2], p[1::2])
        err = err + e.sum(0)
        p = s
        m //= 2
    return p[0], err


def _across_ranks(h, l, corr=None):
    """Every rank's (hi, lo) partial pair (and plain correction) combined
    in rank order: one ``all_gather``, then TwoSum additions on every
    rank."""
    parts = [h, l] if corr is None else [h, l, corr]
    g = ranks.gather_ranks(torch.stack(parts))
    sh, sl = g[0, 0], g[0, 1]
    c = None if corr is None else g[0, 2]
    for k in range(1, g.shape[0]):
        sh, sl = ff_add_ff(sh, sl, g[k, 0], g[k, 1])
        if c is not None:
            c = c + g[k, 2]
    return (sh, sl) if corr is None else (sh, sl, c)


def ff_sum(p):
    """Compensated sum of a real vector as an (hi, lo) pair: the pairwise
    TwoSum tree, about twofold working precision (Ogita-Rump Sum2's
    accuracy) at O(n) vector work with no serial scan."""
    if ranks.sharded(p):
        return _across_ranks(*ff_sum(ranks.plain(p)))
    if p.shape[0] == 0:
        z = p.new_zeros(())
        return z, z
    top, err = _pairwise(p)
    return two_sum(top, err)


def ff_vdot(ah, al, bh, bl):
    """Compensated real dot product of two (hi, lo) vector pairs, as an
    (hi, lo) scalar pair.  The hi*hi products ride an error-free TwoProd
    and the pairwise TwoSum tree; the product errors and first-order cross
    terms are folded through a plain sum (eps-level terms, so their
    rounding is second order)."""
    if ranks.sharded(ah, al, bh, bl):
        return _vdot_ranks(ff_vdot, ah, al, bh, bl)
    p, pe = two_prod(ah, bh)
    sh, sl = ff_sum(p)
    corr = (pe + ah * bl + al * bh).sum()
    return ff_add(sh, sl, corr)


def _vdot_ranks(fn, ah, al, bh, bl):
    """``fn`` (:func:`ff_vdot` or :func:`ff_vdot_cols`) over all ranks:
    each rank's pair and correction before their final addition,
    combined in rank order."""
    ah, al, bh, bl = (ranks.plain(t) for t in (ah, al, bh, bl))
    p, pe = two_prod(ah, bh)
    total = ff_sum if fn is ff_vdot else ff_sum_cols
    sh, sl = total(p)
    corr = (pe + ah * bl + al * bh).sum(0)
    return ff_add(*_across_ranks(sh, sl, corr))


def ff_dot2(x, y):
    """Compensated dot product (Ogita-Rump-Oishi Dot2): the working-dtype
    value of x·y with the products' rounding errors folded in."""
    if ranks.sharded(x, y):
        p, s = two_prod(ranks.plain(x), ranks.plain(y))
        g = ranks.gather_ranks(torch.stack([p.sum(), s.sum()]))
        ps, ss = g[0, 0], g[0, 1]
        for k in range(1, g.shape[0]):
            ps, ss = ps + g[k, 0], ss + g[k, 1]
        return ps + ss
    p, s = two_prod(x, y)
    return p.sum() + s.sum()


def ff_sum_cols(p):
    """Per-column :func:`ff_sum`: compensated sums over axis 0 of an (n, K)
    block, as a (K,) (hi, lo) pair."""
    if ranks.sharded(p):
        return _across_ranks(*ff_sum_cols(ranks.plain(p)))
    if p.shape[0] == 0:
        z = p.new_zeros(p.shape[1:])
        return z, z
    top, err = _pairwise(p)
    return two_sum(top, err)


def ff_vdot_cols(ah, al, bh, bl):
    """Per-column :func:`ff_vdot`: compensated real dots of two (n, K)
    (hi, lo) block pairs, as a (K,) scalar pair."""
    if ranks.sharded(ah, al, bh, bl):
        return _vdot_ranks(ff_vdot_cols, ah, al, bh, bl)
    p, pe = two_prod(ah, bh)
    sh, sl = ff_sum_cols(p)
    corr = (pe + ah * bl + al * bh).sum(0)
    return ff_add(sh, sl, corr)
