"""The port's L-BFGS operators against the JAX package's (the cases of
tests/test_lbfgs.py), on the same stored pairs.

Both packages run the same recursions in f64 over the same pairs, the JAX
package as masked loops over every memory slot, the port over the filled
ones (a masked slot adds an exact zero), so products agree to 1e-12
relative (``RTOL``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
from pykrylov_tpu_torch.ops import (CompactLBFGSOperator,
                                    InverseLBFGSOperator, LBFGSOperator,
                                    StructuredLBFGSOperator,
                                    forward_lbfgs_matvec, lbfgs_init,
                                    lbfgs_restart, lbfgs_store)
from pykrylov_tpu_torch.utils import check_positive_definite, check_symmetric

DEV = "cpu"  # the port's entry points default to the card
N = 10
NPAIRS = 5
RTOL = 1e-12
CLASSES = {"inverse": (InverseLBFGSOperator, jops.InverseLBFGSOperator),
           "forward": (LBFGSOperator, jops.LBFGSOperator),
           "compact": (CompactLBFGSOperator, jops.CompactLBFGSOperator)}


def _pair(rng):
    s, y = rng.standard_normal(N), rng.standard_normal(N)
    return s, (-y if np.dot(s, y) < 0 else y)


def filled(rng, scaling=False, npairs=NPAIRS + 2):
    """The three operators of both packages with the same pairs (more than
    the memory: the ring buffer wraps)."""
    ops = {k: (t(N, NPAIRS, scaling=scaling, dtype=torch.float64,
                 device=DEV),
               j(N, NPAIRS, scaling=scaling, dtype=np.float64))
           for k, (t, j) in CLASSES.items()}
    for _ in range(npairs):
        s, y = _pair(rng)
        for t, j in ops.values():
            t.store(s, y)
            j.store(jnp.asarray(s), jnp.asarray(y))
    return ops


def same(t, j, x):
    np.testing.assert_allclose((t * torch.from_numpy(x)).numpy(),
                               np.asarray(j * jnp.asarray(x)), rtol=RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("npairs", [3, NPAIRS + 2])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_products_match_jax(kind, npairs, scaling, rng):
    t, j = filled(rng, scaling, npairs)[kind]
    assert t.insert == j.insert
    assert t.data.valid.tolist() == np.asarray(j.data.valid).tolist()
    same(t, j, rng.standard_normal(N))
    assert check_symmetric(t) and check_positive_definite(t)


def test_inverse_starts_as_identity_and_restarts(rng):
    H = InverseLBFGSOperator(N, NPAIRS, dtype=torch.float64, device=DEV)
    x = torch.arange(1.0, N + 1, dtype=torch.float64)
    assert torch.equal(H * x, x)
    t, _ = filled(rng)["inverse"]
    t.restart()
    assert torch.equal(t * x, x)


def test_secant_equations(rng):
    s, y = _pair(rng)
    H = InverseLBFGSOperator(N, NPAIRS, scaling=False, dtype=torch.float64,
                             device=DEV)
    H.store(s, y)
    np.testing.assert_allclose((H * torch.from_numpy(y)).numpy(), s,
                               rtol=1e-12)
    B = LBFGSOperator(N, NPAIRS, scaling=False, dtype=torch.float64,
                      device=DEV)
    B.store(s, y)
    np.testing.assert_allclose((B * torch.from_numpy(s)).numpy(), y,
                               rtol=1e-12)


def test_curvature_rejection(rng):
    H = InverseLBFGSOperator(N, NPAIRS, dtype=torch.float64, device=DEV)
    s = rng.standard_normal(N)
    H.store(s, -s)                          # s.y < 0
    assert not bool(H.data.valid.any())
    x = torch.arange(1.0, N + 1, dtype=torch.float64)
    assert torch.equal(H * x, x)


@pytest.mark.parametrize("scaling", [False, True])
def test_forward_inverts_inverse(rng, scaling):
    ops = filled(rng, scaling)
    H, B, C = (ops[k][0] for k in ("inverse", "forward", "compact"))
    eye = torch.eye(N, dtype=torch.float64)
    BH = torch.stack([B * (H * eye[:, i]) for i in range(N)], 1)
    np.testing.assert_allclose(BH.numpy(), np.eye(N), atol=1e-8)
    x = torch.from_numpy(rng.standard_normal(N))
    np.testing.assert_allclose((C * x).numpy(), (B * x).numpy(), rtol=1e-8,
                               atol=1e-10)


def test_functional_api(rng):
    # lbfgs_store returns new data and leaves the old; a rejected pair
    # returns the data as it was
    d0 = lbfgs_init(N, 3, torch.float64, DEV)
    s, y = _pair(rng)
    d1 = lbfgs_store(d0, torch.from_numpy(s), torch.from_numpy(y))
    assert d1.insert == 1 and d0.insert == 0 and not d0.valid.any()
    assert lbfgs_store(d1, torch.from_numpy(s), -torch.from_numpy(s)) is d1
    assert lbfgs_restart(d1).insert == 0


def _dense_oracle(pairs, n, gamma):
    """The structured secant updates on an explicit matrix."""
    B = np.eye(n) / gamma
    for s, y, yd in pairs:
        ys = y @ s
        A = yd - B @ s
        B = (B + (np.outer(A, y) + np.outer(y, A)) / ys
             - (s @ A) * np.outer(y, y) / ys ** 2)
    return B


@pytest.mark.parametrize("mem,npairs", [(NPAIRS, 3), (3, 5)])
def test_structured_matches_oracle_and_jax(mem, npairs, rng):
    S = StructuredLBFGSOperator(N, mem, scaling=False, dtype=torch.float64,
                                device=DEV)
    jS = jops.StructuredLBFGSOperator(N, mem, scaling=False,
                                      dtype=np.float64)
    pairs = []
    for _ in range(npairs):
        s, y = _pair(rng)
        yd = y + 0.1 * rng.standard_normal(N)
        pairs.append((s, y, yd))
        S.store(s, y, yd)
        jS.store(jnp.asarray(s), jnp.asarray(y), jnp.asarray(yd))
        # the structured secant condition for the newest pair
        np.testing.assert_allclose((S * torch.from_numpy(s)).numpy(), yd,
                                   rtol=1e-9, atol=1e-9)
    v = rng.standard_normal(N)
    same(S, jS, v)
    B = _dense_oracle(pairs[-mem:], N, 1.0)
    np.testing.assert_allclose((S * torch.from_numpy(v)).numpy(), B @ v,
                               rtol=1e-9, atol=1e-9)
    assert check_symmetric(S)


def test_structured_rejects_bad_pair_and_restarts(rng):
    S = StructuredLBFGSOperator(N, NPAIRS, scaling=False,
                                dtype=torch.float64, device=DEV)
    s = rng.standard_normal(N)
    S.store(s, -s, -s)
    assert not bool(S.data["valid"].any())
    s, y = _pair(rng)
    S.store(s, y, y)
    assert bool(S.data["valid"].any())
    S.restart()
    assert not bool(S.data["valid"].any())


def _integer_pairs(rng, count=3):
    """(s, y) pairs of small integers with s.y > 0: their f32 dot products
    are exact, so both packages store the same f32 ys and gamma."""
    out = []
    while len(out) < count:
        s = rng.integers(-3, 4, size=N).astype(np.float32)
        y = s + rng.integers(-1, 2, size=N).astype(np.float32)
        if float(np.dot(s, y)) > 0:
            out.append((s, y))
    return out


@pytest.mark.parametrize("kind", ["inverse", "compact"])
def test_f32_pairs_promote_f64_vector(kind, rng):
    t = CLASSES[kind][0](N, NPAIRS, dtype=torch.float32, device=DEV)
    j = CLASSES[kind][1](N, NPAIRS, dtype=np.float32)
    for s, y in _integer_pairs(rng):
        t.store(s, y)
        j.store(jnp.asarray(s), jnp.asarray(y))
    np.testing.assert_array_equal(t.data.ys.numpy(), np.asarray(j.data.ys))
    x = rng.standard_normal(N)
    yt = t * torch.from_numpy(x)
    yj = np.asarray(j * jnp.asarray(x))
    assert yt.dtype == torch.float64 and yj.dtype == np.float64
    np.testing.assert_allclose(yt.numpy(), yj, rtol=RTOL, atol=1e-14)


def test_forward_f32_pairs_promote_f64_vector(rng):
    # the JAX package's forward operator raises here (a TypeError in its
    # scan carry); the port promotes as its other L-BFGS operators do, to
    # the product over the same pairs and scalars widened to f64
    t32 = LBFGSOperator(N, NPAIRS, dtype=torch.float32, device=DEV)
    for s, y in _integer_pairs(rng):
        t32.store(s, y)
    d = t32.data
    wide = d._replace(s=d.s.double(), y=d.y.double(), ys=d.ys.double(),
                      gamma=d.gamma.double())
    x = torch.from_numpy(rng.standard_normal(N))
    y32 = t32 * x
    assert y32.dtype == torch.float64
    assert torch.equal(y32, forward_lbfgs_matvec(wide, x))
