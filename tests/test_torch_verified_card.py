"""Verified arithmetic on the card: the double-f32 functions on CUDA
tensors, both SpMM kernels at the verifiers' block width, and every
verified route through the kernels against the same solve through their
plain versions.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_verified_card.py

Tolerances:

  * the elementwise ff functions: bit for bit against the CPU (every
    operation is one IEEE-rounded ``+``, ``-``, ``*``, ``/`` or square
    root on either device); the reductions (``ff_sum``, ``ff_vdot`` and
    their ``_cols`` forms), whose plain sums of error terms run in another
    order on the card: ``hi + lo`` within ``|hi|·2^-44`` (f32) or
    ``2^-100`` (f64);
  * ``dia_matmat`` and ``sell_matmat`` at K = 16 (the (n, 2K) verification
    product of a K = 8 block): bit for bit their plain versions in the f32,
    f64 and f32f64 entries;
  * each verified solve through the kernels: x, x_lo, the counts and the
    stop codes bit for bit the plain products' run, and the launches the
    products the loop issued.
"""

import numpy as np
import pytest
import torch

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.gallery import (convdiff2d_coo, poisson3d_coo,
                                        tiled_general_coo)
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse import sell as S
from pykrylov_tpu_torch.utils import ff

from test_torch_lls_card import _sparse_rect

ENTRIES = {"f32": (np.float32, torch.float32),
           "f64": (np.float64, torch.float64),
           "f32f64": (np.float32, torch.float64)}
KV = 16     # the verifiers' block width: [X, X_lo] of a K = 8 block


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL and DIA kernels have no "
                    "CPU mode)")
    return "cuda"


# --------------------------------------------------------------------------
# the ff functions
# --------------------------------------------------------------------------

ELEMENTWISE = {"two_sum": 2, "two_prod": 2, "_split": 1, "ff_renorm": 2,
               "ff_add": 3, "ff_add_ff": 4, "ff_scale": 3, "ff_div": 3,
               "ff_mul": 4, "ff_sqrt": 2, "ff_hypot": 4}


def _args(name, arity, dt, n=1 << 16):
    rng = np.random.default_rng(len(name))
    args = [(rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n))
            .astype(dt) for _ in range(arity)]
    if name == "ff_sqrt":
        args = [np.abs(a) for a in args]
    if name in ("ff_renorm", "ff_add", "ff_add_ff", "ff_mul", "ff_sqrt",
                "ff_hypot"):
        # the lo halves of pairs, below an ulp of their hi halves
        for k in range(1, arity, 2):
            args[k] = (args[k - 1] * dt(np.finfo(dt).eps / 4)
                       * rng.random(n)).astype(dt)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_ff_elementwise_on_the_card_equal_the_cpu(card, name, dtype):
    dt = ENTRIES[dtype][0]
    args = _args(name, ELEMENTWISE[name], dt)
    fn = getattr(ff, name)
    cpu = fn(*[torch.from_numpy(a) for a in args])
    gpu = fn(*[torch.from_numpy(a).to(card) for a in args])
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    gpu = gpu if isinstance(gpu, tuple) else (gpu,)
    for c, g in zip(cpu, gpu):
        assert g.device.type == "cuda"
        assert torch.equal(c, g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", ["ff_sum", "ff_vdot", "ff_sum_cols",
                                  "ff_vdot_cols"])
def test_ff_reductions_on_the_card(card, name, dtype):
    dt = ENTRIES[dtype][0]
    tol = 2.0 ** -44 if dtype == "f32" else 2.0 ** -100
    rng = np.random.default_rng(7)
    shape = (100003, 8) if name.endswith("_cols") else (100003,)
    args = []
    for k in range(1 if name.startswith("ff_sum") else 4):
        v = (rng.standard_normal(shape) + 2.0).astype(dt)
        if k % 2:
            v = (args[-1] * dt(np.finfo(dt).eps / 4)).astype(dt)
        args.append(v)
    fn = getattr(ff, name)
    ch, cl = fn(*[torch.from_numpy(a) for a in args])
    gh, gl = fn(*[torch.from_numpy(a).to(card) for a in args])
    diff = ((gh.cpu().double() - ch.double()) + (gl.cpu().double()
                                                 - cl.double())).abs()
    assert (diff <= ch.double().abs() * tol).all()


# --------------------------------------------------------------------------
# the SpMMs at the verifiers' width
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_dia_spmm_at_the_verifiers_width(card, entry):
    store, block = ENTRIES[entry]
    A = operator_from_coo(*poisson3d_coo(24, dtype=store), symmetric=True,
                          fmt="cuda-dia", device=card)
    c = A.container
    X = torch.randn((A.shape[0], KV), device=card, dtype=block,
                    generator=torch.Generator(device=card).manual_seed(1))
    Y = K.dia_matmat(c.data, c.offsets, X)
    assert torch.equal(Y, K.dia_matmat_plain(c.data, c.offsets, X))
    for j in range(KV):
        assert torch.equal(Y[:, j], K.dia_matvec(c.data, c.offsets,
                                                 X[:, j].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_sell_spmm_at_the_verifiers_width(card, entry):
    store, block = ENTRIES[entry]
    vals, rows, cols, shape = _sparse_rect()
    A = B.bell_operator((vals.astype(store), rows, cols, shape),
                        device=card)
    g = torch.Generator(device=card).manual_seed(2)
    for key, width in (("fwd", A.shape[1]), ("bwd", A.shape[0])):
        card_form = A.cards[key]
        X = torch.randn((width, KV), device=card, dtype=block, generator=g)
        Y = S.sell_matmat(card_form, X)
        assert torch.equal(Y, S.sell_matmat_plain(card_form, X)), key


# --------------------------------------------------------------------------
# every verified route: kernels against plain products, bit for bit
# --------------------------------------------------------------------------

def _plain(A):
    """``A`` with the plain versions of its kernels as every product, 1-D
    and block, on the same containers and card forms."""
    if isinstance(A, B.BellOperator):
        fwd = A.cards["fwd"]
        bwd = A.cards.get("bwd", fwd)
        rules = (lambda x: S.sell_matvec_plain(fwd, x),
                 lambda x: S.sell_matvec_plain(bwd, x),
                 lambda X: S.sell_matmat_plain(fwd, X),
                 lambda X: S.sell_matmat_plain(bwd, X))
    else:
        c = A.container
        t = c if A.symmetric else K.dia_transpose(c)
        rules = (lambda x: K.dia_matvec_plain(c.data, c.offsets, x),
                 lambda x: K.dia_matvec_plain(t.data, t.offsets, x),
                 lambda X: K.dia_matmat_plain(c.data, c.offsets, X),
                 lambda X: K.dia_matmat_plain(t.data, t.offsets, X))
    return pt.LinearOperator(A.shape[1], A.shape[0], matvec=rules[0],
                             matvec_transp=rules[1], symmetric=A.symmetric,
                             dtype=A.dtype, device=A.device,
                             matmat=rules[2], matmat_transp=rules[3])


def _poisson(dev):
    return operator_from_coo(*poisson3d_coo(24, dtype=np.float32),
                             symmetric=True, fmt="cuda-dia", device=dev)


def _convdiff(dev):
    return operator_from_coo(*convdiff2d_coo(64, wx=65.0, wy=32.5,
                                             dtype=np.float32),
                             fmt="cuda-dia", device=dev)


def _bus(dev):
    return operator_from_coo(*tiled_general_coo("1138bus", tiles=2,
                                                coupling=0),
                             symmetric=True, fmt="bell", device=dev)


def _rect(dev):
    return B.bell_operator(_sparse_rect(), device=dev)


def _rhs(A, dev, k=None, dtype=torch.float32, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (A.shape[0],) if k is None else (A.shape[0], k)
    return torch.randn(shape, device=dev, dtype=dtype, generator=g)


# route -> (operator, rhs block width or None, rhs dtype, call, the kernel's
# counter, the launches as a function of the result)
ROUTES = {
    "refined CG legs": (
        _poisson, None, torch.float32,
        lambda A, b: pt.solve(A, b, verified=True, rtol=1e-6),
        K, "DIA_LAUNCHES", lambda r: int(r.n_matvec)),
    "refined BiCGSTAB legs": (
        _convdiff, None, torch.float32,
        lambda A, b: pt.solve(A, b, verified=True, rtol=1e-6, max_legs=3),
        K, "DIA_LAUNCHES", lambda r: int(r.n_matvec)),
    "refined LSMR legs": (
        _rect, None, torch.float32,
        lambda A, b: pt.solve(A, b, verified=True, atol=1e-5, btol=1e-5,
                              max_legs=3),
        S, "SELL_LAUNCHES",
        lambda r: int(r.n_matvec) + r.info["n_legs"]),
    "ff-CG": (
        _poisson, None, torch.float32,
        lambda A, b: PS.cg(A, b, replace_every=20, rtol=1e-6),
        K, "DIA_LAUNCHES", lambda r: int(r.n_matvec)),
    "ff-MINRES": (
        _bus, None, torch.float64,
        lambda A, b: PS.minres(A, b, replace_every=20, rtol=1e-6,
                               itnlim=300),
        S, "SELL_LAUNCHES", lambda r: int(r.n_matvec)),
    "ff cg_batched": (
        _poisson, 8, torch.float32,
        lambda A, B_: pt.solve(A, B_, verified=True, rtol=1e-6),
        K, "DIA_MM_LAUNCHES",
        lambda r: (int(r.n_iter) + int(r.n_matvec)) // 2),
    "refined_solve_batched": (
        _convdiff, 8, torch.float32,
        lambda A, B_: pt.solve(A, B_, verified=True, rtol=1e-6,
                               max_legs=3),
        K, "DIA_MM_LAUNCHES",
        lambda r: 2 * int(r.n_iter) + r.info["n_legs"]),
    "ff minres_batched": (
        _bus, 8, torch.float64,
        lambda A, B_: pt.solve(A, B_, method="minres", verified=True,
                               rtol=1e-6, itnlim=300),
        S, "SELL_MM_LAUNCHES", lambda r: int(r.n_matvec) // 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_verified_route_through_the_kernels(card, route):
    build, k, dtype, call, mod, counter, launches = ROUTES[route]
    A = build(card)
    b = _rhs(A, card, k, dtype)
    setattr(mod, counter, 0)
    res = call(A, b)
    assert getattr(mod, counter) == launches(res) > 0
    before = getattr(mod, counter)
    ref = call(_plain(A), b)
    assert getattr(mod, counter) == before      # the plain products
    assert torch.equal(res.x, ref.x)
    assert torch.equal(res.info["x_lo"], ref.info["x_lo"])
    assert torch.equal(res.istop, ref.istop)
    assert int(res.n_iter) == int(ref.n_iter)
    assert int(res.n_matvec) == int(ref.n_matvec)
    assert torch.isfinite(res.x).all()
