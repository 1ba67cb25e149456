"""The BELL slice end to end: the auto policy's choice, CG through a BELL
operator, and ``solve()`` in the permuted space, against the JAX package.

The policy tests run ``_try_bell`` in both packages on scaled-down copies
of ``bench.py``'s three matrix classes and on tiled 1138bus: the port must
accept exactly what the JAX package accepts, with the same layout, row
split and permutation.  The solver tests run the port's CG over the
kernel's plain version (the wrapper's choice for CPU tensors) against JAX
CG over the Pallas kernel in interpret mode, in float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.gallery.general import (
    tiled_general_coo as jax_tiled_general_coo)
from pykrylov_tpu.solvers import cg as jax_cg
from pykrylov_tpu.sparse import bell as JB
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse import linop as JL
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery import tiled_general_coo
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse import bell as TB
from pykrylov_tpu_torch.sparse import formats as TF
from pykrylov_tpu_torch.sparse import linop as TL
from pykrylov_tpu_torch.sparse import operator_from_coo, sparse_operator

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# bench.py's matrix classes (bench.py imports jax, so they are copied),
# here at 8,192 rows
def gen_power_law(n=1 << 13, seed=0):
    rng = np.random.default_rng(seed)
    deg = np.clip((rng.pareto(2.0, n) + 1).astype(int) * 3, 3, 400)
    rws = np.repeat(np.arange(n), deg)
    base = rws + rng.integers(-300, 301, rws.shape)
    far = rng.random(rws.shape) < 0.05
    cls = np.where(far, rng.integers(0, n, rws.shape), base) % n
    vls = rng.standard_normal(rws.shape).astype(np.float32)
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


def gen_stencil_scatter(n=1 << 13, spr=0.25, seed=1):
    rng = np.random.default_rng(seed)
    offs = np.array([-1024, -32, -1, 0, 1, 32, 1024])
    rws, cls, vls = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, n - o))
        rws.append(r)
        cls.append(r + o)
        vls.append(np.full(len(r), 6.0 if o == 0 else -1.0, np.float32))
    ns = int(spr * n)
    sr = rng.integers(0, n, ns)
    blocks = rng.integers(0, n // 128, 64)
    sc = blocks[rng.integers(0, 64, ns)] * 128 + rng.integers(0, 128, ns)
    rws.append(sr)
    cls.append(sc)
    vls.append(0.1 * rng.standard_normal(ns).astype(np.float32))
    rws, cls, vls = (np.concatenate(a) for a in (rws, cls, vls))
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


def gen_permuted_blockdiag(n=1 << 13, blk=192, seed=2):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    rws, cls, vls = [], [], []
    for b0 in range(0, n, blk):
        k = 6 * blk
        rr = rng.integers(b0, min(b0 + blk, n), k)
        cc = rng.integers(b0, min(b0 + blk, n), k)
        rws.append(perm[rr])
        cls.append(perm[cc])
        vls.append(0.1 * rng.standard_normal(k).astype(np.float32))
    rws, cls, vls = (np.concatenate(a) for a in (rws, cls, vls))
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


def tiled_1138bus():
    return tiled_general_coo("1138bus", tiles=4, coupling=0)


_CLASSES = {
    "power_law": (gen_power_law, False),
    "stencil_scatter": (gen_stencil_scatter, False),
    "permuted_blockdiag": (gen_permuted_blockdiag, False),
    "tiled_1138bus": (tiled_1138bus, True),
    "tiled_1138bus_unsym": (tiled_1138bus, False),
}


def _levels_layout(levels):
    return [(int(b.window), int(b.nb), int(b.nblk), tuple(b.data.shape),
             b.seg is not None, int(b.seg_mixed), int(b.nnz))
            for b in levels]


@pytest.mark.parametrize("name", sorted(_CLASSES))
def test_try_bell_matches_jax(name):
    make, symmetric = _CLASSES[name]
    t = make()
    jop = JL._try_bell(JF.coo_from_arrays(*t, device=False), symmetric)
    top = TL._try_bell(TF.coo_from_arrays(*t, device=None), symmetric,
                       device=DEV)
    assert (top is None) == (jop is None)
    if jop is None:
        return
    assert top.fmt == "bell"
    jparams = jop._params
    assert _levels_layout(top.levels) == _levels_layout(jparams[0])
    assert top.split_rows == getattr(jop, "split_rows", 0)
    if top.split_rows:
        np.testing.assert_array_equal(top._args["split"][0].numpy(),
                                      np.asarray(jparams[2]))
    jperm = getattr(jop, "solve_permutation", None)
    assert (top.solve_permutation is None) == (jperm is None)
    if jperm is not None:
        np.testing.assert_array_equal(top.solve_permutation[0].numpy(),
                                      np.asarray(jperm[0]))
    # the transpose: symmetric, ELL (the row-packed forward only), or BELL
    jbwd_ell = len(jparams) == 3 and not top.split_rows
    assert (top._args["bwd_ell"] is not None) == jbwd_ell
    if top._args["bwd"] is not None and not top.split_rows:
        assert _levels_layout(top._args["bwd"]) == _levels_layout(jparams[1])
    # the accepted operator multiplies as the matrix does
    a = np.zeros(t[3])
    np.add.at(a, (t[1], t[2]), np.asarray(t[0], np.float64))
    x = np.random.default_rng(1).standard_normal(t[3][1]).astype(np.float32)
    y = (top * torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, a @ x, rtol=1e-4,
                               atol=1e-5 * np.abs(a @ x).max())


def test_gallery_matches_jax():
    for kw in (dict(base="1138bus", tiles=3, coupling=0),
               dict(base="jpwh_991", tiles=3, coupling=4, seed=5)):
        port, ref = tiled_general_coo(**kw), jax_tiled_general_coo(**kw)
        assert port[3] == ref[3]
        for a, b in zip(port[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)


def test_auto_branch_is_keyed_on_the_card_and_the_size(monkeypatch):
    # general sparsity of >= 4,096 rows on a CUDA device goes to _try_bell;
    # on the CPU, or below the threshold, it never does
    calls = []

    def fake(coo, symmetric, device):
        calls.append((coo.shape, symmetric, device))
        return "bell operator"

    monkeypatch.setattr(TL, "_try_bell", fake)
    big = gen_power_law(1 << 12)
    assert operator_from_coo(*big, device="cuda") == "bell operator"
    assert calls == [((4096, 4096), False, "cuda")]
    assert operator_from_coo(*big, device=DEV).fmt == "ell"
    small = gen_power_law(4095)
    assert operator_from_coo(*small, device=DEV).fmt == "ell"
    assert len(calls) == 1


def _spd(m=1500, seed=9):
    """A well-conditioned sparse SPD matrix (diagonally dominant)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 4)
    cols = np.where(rng.random(rows.shape) < 0.3, rng.integers(0, m, rows.shape),
                    np.clip(rows + rng.integers(-60, 61, rows.shape), 0, m - 1))
    vals = 0.1 * rng.standard_normal(rows.shape)
    r = np.concatenate([rows, cols, np.arange(m)])
    c = np.concatenate([cols, rows, np.arange(m)])
    d = np.zeros(m)
    np.add.at(d, rows, np.abs(vals))
    np.add.at(d, cols, np.abs(vals))
    v = np.concatenate([vals, vals, d + 0.5])
    key = r.astype(np.int64) * m + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    first = np.r_[True, key[1:] != key[:-1]]
    sums = np.add.reduceat(v, np.flatnonzero(first))
    return sums, r[first], c[first], (m, m)


def test_cg_through_bell_matches_jax():
    t = _spd()
    top = TB.bell_operator(t, symmetric=True, device=DEV)
    jop = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                           symmetric=True, interpret=True)
    b = np.random.default_rng(4).standard_normal(t[3][0])
    res = cg(top, torch.from_numpy(b), rtol=1e-10)
    jres = jax_cg(jop, jnp.asarray(b), rtol=1e-10)
    assert bool(res.converged) and bool(jres.converged)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jres.x)).max())


def test_1138bus_bell_matvec_count():
    # the mirror of test_torch_cg.py's ELL case through a BELL operator:
    # f64 CG at rtol 1e-6 within 10 matvecs of the JAX package's count and
    # within 90 of the reference's 1759
    top = sparse_operator("1138bus", symmetric=True, fmt="bell", device=DEV)
    assert top.fmt == "bell"
    jop = jax_sparse_operator("1138bus", symmetric=True)
    e = np.ones(1138)
    b = (top * torch.from_numpy(e)).numpy()
    t = cg(top, torch.from_numpy(b), rtol=1e-6, matvec_max=2 * 1138)
    j = jax_cg(jop, jnp.asarray(b), rtol=1e-6, matvec_max=2 * 1138)
    assert bool(t.converged) and bool(j.converged)
    assert abs(int(t.n_matvec) - int(j.n_matvec)) <= 10
    assert abs(int(t.n_matvec) - 1759) <= 90
    assert np.linalg.norm(t.x.numpy() - e) / np.sqrt(1138) < 5e-5


def test_solve_in_the_permuted_space():
    # an RCM-wrapped operator is solved through its inner operator (no
    # gathers per product) and x is un-permuted once: the result equals
    # the unpermuted solve and the JAX package's
    t = _spd(m=1200, seed=12)
    A = TB.bell_operator(t, symmetric=True, reorder=True, device=DEV)
    plain = TB.bell_operator(t, symmetric=True, device=DEV)
    p, ip, inner = A.solve_permutation
    b = np.random.default_rng(6).standard_normal(t[3][0])
    calls = {"outer": 0, "inner": 0}

    def spy(op, key):
        mv = op._mv

        def counted(x):
            calls[key] += 1
            return mv(x)
        op._mv = counted

    spy(A, "outer")
    spy(inner, "inner")
    res = pt.solve(A, torch.from_numpy(b), rtol=1e-10)
    assert calls == {"outer": 0, "inner": int(res.n_matvec)}
    ref = pt.solve(plain, torch.from_numpy(b), rtol=1e-10)
    assert bool(res.converged) and abs(int(res.n_iter) - int(ref.n_iter)) <= 2
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=1e-8,
                               atol=1e-9)
    jA = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                          symmetric=True, reorder=True, interpret=True)
    import pykrylov_tpu
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b), rtol=1e-10)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-10)
    # a Jacobi preconditioner is carried into the permuted space
    d = np.zeros(t[3][0])
    np.add.at(d, t[1][t[1] == t[2]], t[0][t[1] == t[2]])
    M = pt.ops.DiagonalOperator(torch.from_numpy(1.0 / d), device=DEV)
    pre = pt.solve(A, torch.from_numpy(b), rtol=1e-10, M=M)
    pref = pt.solve(plain, torch.from_numpy(b), rtol=1e-10, M=M)
    np.testing.assert_allclose(pre.x.numpy(), pref.x.numpy(), rtol=1e-8,
                               atol=1e-9)
