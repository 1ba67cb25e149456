"""Pipelined CG, its block twin, the Chebyshev rules and the
differentiable solves' backward on the card, each through the kernels
against the same run through the kernels' plain versions.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_pipelined_card.py

Tolerances: none.  Each kernel equals its plain version bit for bit on
the same containers and card forms (the other card tests hold that), so a
solve whose products go through the kernels must give the bits of the
same solve through the plain versions, with every other operation the
same on the same device; and its launches must be the products the loop
issued: ``n_matvec + 1`` for a pipelined solve that stops on its test
(the product it enqueued before the read is dropped), ``n_matvec`` plus 4
a replacement for the block twin, ``degree - 1`` a Chebyshev apply.
"""

import numpy as np
import pytest
import torch

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.ops import chebyshev_preconditioner, lanczos_bounds
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import sell as S

from test_torch_verified_card import (_bus, _convdiff, _plain, _poisson,
                                      _rect, _rhs)

COUNTERS = ((K, "DIA_LAUNCHES"), (K, "DIA_MM_LAUNCHES"),
            (S, "SELL_LAUNCHES"), (S, "SELL_MM_LAUNCHES"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL and DIA kernels have no "
                    "CPU mode)")
    return "cuda"


def _counted(fn):
    """``fn()`` and the launches of each kernel during it."""
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, name) for mod, name in COUNTERS}


def _same(res, ref):
    assert torch.equal(res.x, ref.x)
    assert int(res.n_iter) == int(ref.n_iter)
    assert int(res.n_matvec) == int(ref.n_matvec)
    assert torch.equal(res.istop, ref.istop)


OPERATORS = {"dia": (_poisson, "DIA_LAUNCHES", "DIA_MM_LAUNCHES"),
             "sell": (_bus, "SELL_LAUNCHES", "SELL_MM_LAUNCHES")}


@pytest.mark.cuda
@pytest.mark.parametrize("replace_every", [0, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_cg_pipelined_through_the_kernels(card, op, dtype, replace_every):
    make, spmv, _ = OPERATORS[op]
    A = make(card)
    b = _rhs(A, card, dtype=dtype)
    # capped: unpreconditioned 1138bus stalls without replacement in f32
    opts = dict(rtol=1e-5, replace_every=replace_every, maxiter=400)
    res, counts = _counted(lambda: PS.cg_pipelined(A, b, **opts))
    ref, plain = _counted(lambda: PS.cg_pipelined(_plain(A), b, **opts))
    _same(res, ref)
    if op == "dia":
        assert int(res.istop) == 0
    # a solve that stops on its test drops the product it enqueued
    dropped = int(bool(res.converged) and int(res.n_iter) > 0)
    assert counts[spmv] == int(res.n_matvec) + dropped
    assert sum(counts.values()) == counts[spmv]
    assert not any(plain.values())


@pytest.mark.cuda
@pytest.mark.parametrize("replace_every", [0, 10])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_cg_pipelined_batched_through_the_spmm(card, op, replace_every):
    make, _, spmm = OPERATORS[op]
    A = make(card)
    B = _rhs(A, card, k=8, dtype=torch.float64)
    opts = dict(rtol=1e-8, replace_every=replace_every, maxiter=300)
    res, counts = _counted(lambda: PS.cg_pipelined_batched(A, B, **opts))
    ref, _ = _counted(lambda: PS.cg_pipelined_batched(_plain(A), B, **opts))
    _same(res, ref)
    if op == "dia":
        assert bool(res.converged.all())
    events = int(res.n_iter) // replace_every if replace_every else 0
    assert counts[spmm] == int(res.n_matvec) + 4 * events
    assert sum(counts.values()) == counts[spmm]


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_chebyshev_rules_through_the_kernels(card, op):
    make, spmv, spmm = OPERATORS[op]
    A = make(card)
    (lmin, lmax), counts = _counted(lambda: lanczos_bounds(A, k=16))
    assert counts[spmv] == 16 and sum(counts.values()) == 16
    bounds = (float(lmin), float(lmax))
    P = _plain(A)
    assert [float(v) for v in lanczos_bounds(P, k=16)] == list(bounds)
    M = chebyshev_preconditioner(A, degree=8, bounds=bounds)
    Mp = chebyshev_preconditioner(P, degree=8, bounds=bounds)
    x = _rhs(A, card)
    X = _rhs(A, card, k=8)
    y, counts = _counted(lambda: M * x)
    assert counts[spmv] == 7 and sum(counts.values()) == 7
    assert torch.equal(y, Mp * x)
    Y, counts = _counted(lambda: M * X)
    assert counts[spmm] == 7 and sum(counts.values()) == 7
    assert torch.equal(Y, Mp * X)
    # CG and cg_batched with the preconditioner: 7 launches an apply
    b = _rhs(A, card, dtype=torch.float64)
    res, counts = _counted(lambda: PS.cg(A, b, M=M, rtol=1e-8))
    _same(res, PS.cg(P, b, M=Mp, rtol=1e-8))
    assert counts[spmv] == int(res.n_matvec) + 7 * (int(res.n_iter) + 1)
    B = _rhs(A, card, k=8, dtype=torch.float64)
    res, counts = _counted(lambda: PS.cg_batched(A, B, M=M, rtol=1e-8))
    _same(res, PS.cg_batched(P, B, M=Mp, rtol=1e-8))
    assert counts[spmm] == int(res.n_matvec) + 7 * (int(res.n_iter) + 1)
    assert counts[spmv] == 0


# case -> (operator, differentiable solve, options, the kernel counter of
# the forward and adjoint solves)
DIFF = {
    "cg_solve DIA": (_poisson, PS.cg_solve, dict(rtol=1e-6),
                     "DIA_LAUNCHES"),
    "bicgstab_solve DIA transpose": (_convdiff, PS.bicgstab_solve,
                                     dict(rtol=1e-8), "DIA_LAUNCHES"),
    "lsqr_solve SELL both cards": (_rect, PS.lsqr_solve,
                                   dict(atol=1e-8, btol=1e-8),
                                   "SELL_LAUNCHES"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DIFF))
def test_backward_through_the_kernels(card, case):
    make, fn, opts, counter = DIFF[case]
    A = make(card)
    m, n = A.shape
    g = torch.Generator(device=card).manual_seed(7)
    w = torch.randn(n, device=card, dtype=torch.float64, generator=g)
    b0 = torch.randn(m, device=card, dtype=torch.float64, generator=g)
    runs = []
    for op in (A, _plain(A)):
        b = b0.clone().requires_grad_(True)
        x, fwd = _counted(lambda: fn(op, b, **opts))
        _, bwd = _counted(lambda: (w @ x).backward())
        runs.append((x.detach(), b.grad, fwd, bwd))
    (x, gk, fwd, bwd), (xp, gp, pfwd, pbwd) = runs
    assert torch.equal(x, xp) and torch.equal(gk, gp)
    assert fwd[counter] > 0 and bwd[counter] > 0
    assert sum(fwd.values()) == fwd[counter]
    assert sum(bwd.values()) == bwd[counter]
    assert not any(pfwd.values()) and not any(pbwd.values())
