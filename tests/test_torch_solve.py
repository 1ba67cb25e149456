"""The slice end to end: ``solve(operator_from_coo(...), b)`` in the port
against the JAX package, the automatic format policy, and the branches
that once were not ported (route tests now); the CG→MINRES and
BiCGSTAB→TFQMR fallbacks, as ``tests/test_solve_frontdoor.py`` holds the
JAX package's, and ``method=`` routing to each solver against the JAX
package's ``solve``.

At ``poisson3d_coo(16)`` both packages pick DIA on the CPU and run CG in
float64 with the same stored matrix; only summation order differs, so the
iteration counts must be equal and the solutions agree to 1e-10
relative."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu
from pykrylov_tpu.gallery import poisson3d_coo
from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.sparse import operator_from_coo as jax_operator_from_coo

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.ops import DiagonalOperator, MatrixOperator
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse.linop import auto_format

from test_torch_lls import rect, rel

DEV = "cpu"  # the port's entry points default to the card


def test_slice_matches_jax():
    vals, rows, cols, shape = poisson3d_coo(16)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          device=DEV)
    jA = jax_operator_from_coo(vals, rows, cols, shape, symmetric=True)
    assert A.fmt == "dia"
    assert type(jA.container).__name__ == "DIA"
    x_true = np.random.default_rng(0).standard_normal(shape[0])
    b = (A * torch.from_numpy(x_true)).numpy()
    res = pt.solve(A, torch.from_numpy(b))
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b))
    assert isinstance(res, pt.SolveResult)
    assert bool(res.converged) and int(res.istop) == 0
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10, atol=1e-12)
    assert "infinite_descent" in res.info  # solve() checks curvature
    explicit = pt.solve(A, torch.from_numpy(b), method="cg")
    assert int(explicit.n_iter) == int(res.n_iter)
    assert "infinite_descent" not in explicit.info


@pytest.mark.parametrize("args,expected", [
    ((7, 1.0, (70000, 70000), "cuda"), "cuda-dia"),
    ((7, 1.0, (70000, 70000), "cpu"), "dia"),
    ((7, 1.0, (65535, 65535), "cuda"), "dia"),
    ((7, 1.0, (70000, 69999), "cuda"), "dia"),
    ((64, 0.25, (1 << 16, 1 << 16), "cuda"), "cuda-dia"),
    ((65, 1.0, (70000, 70000), "cuda"), "ell"),
    ((7, 0.2, (70000, 70000), "cuda"), "ell"),
])
def test_auto_format_policy(args, expected):
    # the JAX package's thresholds: <= 64 diagonals, >= 0.25 fill, and the
    # kernel from 65,536 rows on the accelerator
    assert auto_format(*args) == expected


@pytest.mark.parametrize("ndiag", [K.MAX_DIAGS + 1, 100, 4096])
def test_auto_format_never_exceeds_the_kernel(ndiag):
    # the policy's diagonal limit is the kernel's: a matrix the kernel
    # would refuse never gets fmt="cuda-dia"
    assert auto_format(ndiag, 1.0, (1 << 20, 1 << 20), "cuda") != "cuda-dia"
    assert auto_format(K.MAX_DIAGS, 1.0, (1 << 20, 1 << 20),
                       "cuda") == "cuda-dia"


def test_no_unported_knobs():
    # options of the JAX package that the port does not implement are not
    # accepted silently
    spd = MatrixOperator(torch.eye(3, dtype=torch.float64) * 2,
                         symmetric=True, device=DEV)
    # cg's leg_rtol came back with the verified path (ff-CG's leg target);
    # without replace_every it changes nothing, as in the JAX package
    b = torch.ones(3, dtype=torch.float64)
    assert torch.equal(cg(spd, b, leg_rtol=1e-3).x, cg(spd, b).x)
    with pytest.raises(TypeError, match="leg_tol"):
        cg(spd, b, leg_tol=1e-2)
    vals, rows, cols, shape = poisson3d_coo(4)
    with pytest.raises(TypeError, match="max_diags"):
        operator_from_coo(vals, rows, cols, shape, max_diags=100,
                          device=DEV)


def test_auto_on_cpu_keeps_plain_dia_for_large_stencils():
    vals, rows, cols, shape = poisson3d_coo(41)  # 68,921 rows
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                          device=DEV)
    assert A.fmt == "dia" and A.device.type == "cpu"


# the two block cases name item 14, which ported their batched solvers:
# they are route tests now (the port's solve(A, B) against the JAX
# package's, through the twin it picks)
BLOCK_ROUTES = {"block_rhs": "bicgstab_batched",
                "rectangular_block": "lsqr_batched"}
# the cases that named item 15 (verified arithmetic) are route tests too:
# the port's verified route against the JAX package's, the same solver it
# picks (refined CG legs, ff-CG, refined_lls with LSMR legs, refined legs
# in the RCM permuted space); and the verified routes that stay errors
VERIFIED_ROUTES = ("verified", "replace_every", "rectangular_verified",
                   "permuted_verified")
VERIFIED_ERRORS = {
    "craig_verified": "unsupported for the SQD solvers",
    "rectangular_block_verified": "supported for square systems",
    "verified_block_replace_every_0": "requires replace_every >= 1"}


def _verified_route(case):
    """(port result, JAX result, the port's call through the solver that
    the JAX package's route picks) of one verified route."""
    rng = np.random.default_rng(15)
    if case == "rectangular_verified":
        a = rect(40, 15, seed=15)
        b = a @ rng.standard_normal(15) + 0.01 * rng.standard_normal(40)
        A = MatrixOperator(a, device=DEV)
        opts = dict(atol=1e-10, btol=1e-10, max_legs=6)

        def direct():
            return pt.solvers.refined_lls(pt.solvers.lsmr, A,
                                          torch.from_numpy(b), **opts)
        res = pt.solve(A, torch.from_numpy(b), verified=True, **opts)
        jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(a)), jnp.asarray(b),
                                  verified=True, **opts)
        return res, jres, direct
    if case == "permuted_verified":
        from test_torch_batched import _sparse_spd
        from pykrylov_tpu.sparse import bell as JB
        from pykrylov_tpu.sparse import formats as JF
        a, t = _sparse_spd(n=500, seed=15)
        b = rng.standard_normal(500)
        A = operator_from_coo(*t, symmetric=True, fmt="bell-rcm",
                              device=DEV)
        assert A.solve_permutation is not None
        jA = JB.bell_operator(JF.coo_from_arrays(*t, device=False),
                              symmetric=True, interpret=True, reorder=True)
        opts = dict(rtol=1e-12, leg_rtol=1e-4)
        res = pt.solve(A, torch.from_numpy(b), verified=True, **opts)
        jres = pykrylov_tpu.solve(jA, jnp.asarray(b), verified=True, **opts)
        # the JAX package leaves x_lo in the permuted space (ROADMAP.md
        # queue 3); the port un-permutes it with x
        p = A.solve_permutation[0].numpy()
        jres.info["x_lo"] = np.asarray(jres.info["x_lo"])[np.argsort(p)]
        assert rel(res.x.numpy(), np.linalg.solve(a, b)) <= 1e-10

        def direct():
            # refined CG legs on the inner operator, in the permuted space
            p, ip, inner = A.solve_permutation
            r = pt.solvers.refined_solve(cg, inner, torch.from_numpy(b)[p],
                                         check_curvature=True, **opts)
            return dataclasses.replace(r, x=r.x[ip], info=dict(
                r.info, x_lo=r.info["x_lo"][ip]))
        return res, jres, direct
    a = np.diag(np.linspace(1.0, 4.0, 30))
    a[0, 5] = a[5, 0] = 0.3
    b = rng.standard_normal(30)
    A = MatrixOperator(a, symmetric=True, device=DEV)
    jA = JMatrix(jnp.asarray(a), symmetric=True)
    if case == "verified":
        res = pt.solve(A, torch.from_numpy(b), verified=True, rtol=1e-12)
        jres = pykrylov_tpu.solve(jA, jnp.asarray(b), verified=True,
                                  rtol=1e-12)
        return res, jres, lambda: pt.solvers.refined_solve(
            cg, A, torch.from_numpy(b), rtol=1e-12, check_curvature=True)
    res = cg(A, torch.from_numpy(b), replace_every=5, rtol=1e-12)
    jres = pykrylov_tpu.solvers.cg(jA, jnp.asarray(b), replace_every=5,
                                   rtol=1e-12)
    return res, jres, lambda: cg(A, torch.from_numpy(b), replace_every=5,
                                 rtol=1e-12)


@pytest.mark.parametrize("case,item", [
    ("block_rhs", 14), ("verified", 15), ("cg_pipelined", 16),
    ("replace_every", 15), ("rectangular_verified", 15),
    ("rectangular_block", 14), ("permuted_verified", 15),
    ("craig_verified", 15), ("rectangular_block_verified", 15),
    ("verified_block_replace_every_0", 15),
])
def test_not_ported_branches_name_their_roadmap_item(case, item):
    spd = MatrixOperator(torch.eye(3, dtype=torch.float64) * 2,
                         symmetric=True, device=DEV)
    b = torch.ones(3, dtype=torch.float64)
    rop = MatrixOperator(torch.ones(4, 3, dtype=torch.float64), device=DEV)
    if case in VERIFIED_ROUTES:
        res, jres, direct = _verified_route(case)
        assert set(res.info) == set(jres.info)
        assert int(res.istop) == int(jres.istop) == 0
        assert int(res.n_iter) == int(jres.n_iter)
        assert int(res.n_matvec) == int(jres.n_matvec)
        for key in ("n_legs", "n_replacements"):
            if key in res.info:
                assert int(res.info[key]) == int(jres.info[key])
        assert rel(res.x.numpy(), np.asarray(jres.x)) <= 1e-10
        # (x, x_lo) pairs: canonical, the low part below an ulp of x
        for hi, lo in ((res.x.numpy(), res.info["x_lo"].numpy()),
                       (np.asarray(jres.x), np.asarray(jres.info["x_lo"]))):
            assert (np.abs(lo) <= 2.3e-16 * np.abs(hi)).all()
        # the route is that solver's: the same call gives the same bits
        again = direct()
        assert torch.equal(res.x, again.x)
        assert torch.equal(res.info["x_lo"], again.info["x_lo"])
        return
    if case in VERIFIED_ERRORS:
        calls = {
            "craig_verified": lambda: pt.solve(
                rop, torch.ones(4, dtype=torch.float64), method="craig",
                verified=True),
            "rectangular_block_verified": lambda: pt.solve(
                rop, torch.ones(4, 2, dtype=torch.float64), verified=True),
            "verified_block_replace_every_0": lambda: pt.solve(
                spd, torch.ones(3, 2, dtype=torch.float64), verified=True,
                replace_every=0)}
        jspd = JMatrix(2 * jnp.eye(3), symmetric=True)
        jrop = JMatrix(jnp.ones((4, 3)))
        jcalls = {
            "craig_verified": lambda: pykrylov_tpu.solve(
                jrop, jnp.ones(4), method="craig", verified=True),
            "rectangular_block_verified": lambda: pykrylov_tpu.solve(
                jrop, jnp.ones((4, 2)), verified=True),
            "verified_block_replace_every_0": lambda: pykrylov_tpu.solve(
                jspd, jnp.ones((3, 2)), verified=True, replace_every=0)}
        for call in (calls[case], jcalls[case]):
            with pytest.raises(ValueError, match=VERIFIED_ERRORS[case]):
                call()
        return
    if case in BLOCK_ROUTES:
        # an (n, K) block on a square unsymmetric operator goes to
        # bicgstab_batched, on a rectangular one to lsqr_batched, as in
        # the JAX package
        rng = np.random.default_rng(item)
        if case == "block_rhs":
            a = np.eye(50) + 0.3 * np.triu(rng.standard_normal((50, 50)),
                                           1) / np.sqrt(50)
            opts = dict(rtol=1e-10)
        else:
            a = rect(70, 30, seed=item)
            opts = dict(atol=1e-10, btol=1e-10, etol=0.0)
        B = rng.standard_normal((a.shape[0], 2))
        A = MatrixOperator(a, device=DEV)
        res = pt.solve(A, torch.from_numpy(B), **opts)
        jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(a)), jnp.asarray(B),
                                  **opts)
        twin = getattr(pt.solvers, BLOCK_ROUTES[case])
        assert torch.equal(res.x, twin(A, torch.from_numpy(B), **opts).x)
        assert set(res.info) == set(jres.info)
        np.testing.assert_array_equal(res.istop.numpy(),
                                      np.asarray(jres.istop))
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                                   rtol=1e-8, atol=1e-12)
        assert bool(res.converged.all())
        return
    # method="cg_pipelined" (item 16) goes to cg_pipelined, as in the JAX
    # package: the same counts, x to 1e-10, and the solver's own bits
    res = pt.solve(spd, b, method=case, rtol=1e-8)
    jres = pykrylov_tpu.solve(JMatrix(2 * jnp.eye(3), symmetric=True),
                              jnp.ones(3), method=case, rtol=1e-8)
    assert torch.equal(res.x, pt.solvers.cg_pipelined(spd, b, rtol=1e-8).x)
    assert int(res.istop) == int(jres.istop) == 0
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    assert rel(res.x.numpy(), np.asarray(jres.x)) <= 1e-10


@pytest.mark.parametrize("case", ["rectangular", "lsqr", "lsmr", "craig",
                                  "craigmr"])
def test_least_squares_routes_match_jax(case):
    # solve() on a rectangular operator goes to LSMR, and method= to each
    # least-squares solver, in both packages: equal counts and stop codes,
    # x within 1e-10 relative
    A = rect(90, 40, seed=7)
    rng = np.random.default_rng(8)
    b = A @ rng.standard_normal(40) + 0.01 * rng.standard_normal(90)
    method = None if case == "rectangular" else case
    opts = {"etol": 1e-12} if case.startswith("craig") else {
        "atol": 1e-12, "btol": 1e-12, "etol": 0.0}
    res = pt.solve(MatrixOperator(torch.from_numpy(A), device=DEV),
                   torch.from_numpy(b), method=method, **opts)
    jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(A)), jnp.asarray(b),
                              method=method, **opts)
    assert int(res.n_iter) == int(jres.n_iter) > 0
    assert int(res.istop) == int(jres.istop)
    assert int(res.n_matvec) == int(jres.n_matvec) == 2 * int(res.n_iter)
    xj = np.asarray(jres.x)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert res.x.shape == ((90,) if case == "craigmr" else (40,))
    if case == "rectangular":
        assert "normar" in res.info and int(res.istop) == 2
        x_ls, *_ = np.linalg.lstsq(A, b, rcond=None)
        np.testing.assert_allclose(res.x.numpy(), x_ls, atol=1e-10)


@pytest.mark.parametrize("fmt", ["bell", "bell-rcm"])
def test_bell_formats_raise(fmt):
    # the BELL formats are ported: they build a BELL operator on request
    # (and no longer raise) whatever the device, and its product is A x
    vals, rows, cols, shape = poisson3d_coo(4)
    A = operator_from_coo(vals, rows, cols, shape, fmt=fmt, device=DEV)
    assert A.fmt == "bell"
    assert (A.solve_permutation is not None) == (fmt == "bell-rcm")
    x = np.random.default_rng(1).standard_normal(shape[1])
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose((A * torch.from_numpy(x)).numpy(), dense @ x,
                               rtol=1e-12, atol=1e-12)


def test_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        pt.solve(MatrixOperator(torch.eye(2, dtype=torch.float64),
                                device=DEV),
                 torch.ones(2, dtype=torch.float64), method="gmres")


def _indefinite_system(n=24, seed=3):
    """``tests/test_solve_frontdoor.py:17``'s system: a strongly indefinite
    spectrum, so CG's curvature check trips early."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.linspace(-5.0, 5.0, n)
    eigs[np.abs(eigs) < 0.4] = 0.5
    A = (Q * eigs) @ Q.T
    A = 0.5 * (A + A.T)
    x_true = rng.standard_normal(n)
    return A, x_true, A @ x_true


def _sym_op(A):
    return MatrixOperator(torch.from_numpy(A), symmetric=True, device=DEV)


def test_minres_fallback_triggers_and_solves():
    A, x_true, b = _indefinite_system()
    cgr = cg(_sym_op(A), torch.from_numpy(b), rtol=1e-10,
             check_curvature=True)
    assert int(cgr.istop) == 2
    res = pt.solve(_sym_op(A), torch.from_numpy(b), rtol=1e-10)
    jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(A), symmetric=True),
                              jnp.asarray(b), rtol=1e-10)
    assert bool(res.converged) and "Acond" in res.info    # MINRES's result
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6)
    assert int(res.istop) == int(jres.istop)
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-9)


def test_minres_fallback_honors_x0():
    A, x_true, b = _indefinite_system()
    # a guess close to the solution: with atol met at x0, the fallback
    # stops at once; a dropped x0 would restart from zero
    x0 = x_true + 1e-9
    res = pt.solve(_sym_op(A), torch.from_numpy(b), x0=torch.from_numpy(x0),
                   rtol=1e-14, atol=1e-6)
    assert int(res.n_iter) <= 2
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6)
    # a far guess: CG trips, MINRES solves the residual system and adds x0
    # back, one more counted matvec
    x0 = np.full_like(x_true, 3.0)
    res = pt.solve(_sym_op(A), torch.from_numpy(b), x0=torch.from_numpy(x0),
                   rtol=1e-10)
    jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(A), symmetric=True),
                              jnp.asarray(b), x0=jnp.asarray(x0),
                              rtol=1e-10)
    assert bool(res.converged)
    assert int(res.n_matvec) == int(res.n_iter) + 1
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-5, atol=1e-7)


def test_minres_fallback_honors_atol():
    A, _, b = _indefinite_system()
    loose = pt.solve(_sym_op(A), torch.from_numpy(b), rtol=1e-14,
                     atol=1e-2 * float(np.linalg.norm(b)))
    tight = pt.solve(_sym_op(A), torch.from_numpy(b), rtol=1e-14, atol=0.0)
    assert int(loose.n_iter) < int(tight.n_iter)


@pytest.mark.parametrize("cap", [{"matvec_max": 5}, {"maxiter": 4}])
def test_minres_fallback_respects_the_cap(cap):
    A, _, b = _indefinite_system()
    res = pt.solve(_sym_op(A), torch.from_numpy(b), rtol=1e-14, atol=0.0,
                   **cap)
    assert int(res.n_iter) <= list(cap.values())[0]
    assert int(res.istop) == 6                 # MINRES's iteration limit


def test_bicgstab_breakdown_falls_back_to_tfqmr_with_every_option():
    """A quarter-turn rotation with b = e_1 breaks BiCGSTAB down at once
    (``r0' A r0 = 0``, istop 3); ``solve`` reruns TFQMR with the same
    options, so the result is TFQMR's, x0, M, rtol, atol, matvec_max,
    store_history and verify_final included."""
    n = 12
    R = np.eye(n)
    R[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    b = np.zeros(n)
    b[0] = 1.0
    op = MatrixOperator(torch.from_numpy(R), device=DEV)
    M = DiagonalOperator(torch.full((n,), 2.0, dtype=torch.float64),
                         device=DEV)
    opts = dict(x0=torch.zeros(n, dtype=torch.float64), M=M, rtol=1e-9,
                atol=1e-12, matvec_max=4 * n, store_history=True,
                verify_final=True)
    first = pt.bicgstab(op, torch.from_numpy(b), **opts)
    assert int(first.istop) == 3
    res = pt.solve(op, torch.from_numpy(b), **opts)
    alone = pt.tfqmr(op, torch.from_numpy(b), **opts)
    assert "quasi_residual" in res.info and "true_resid_norm" in res.info
    assert int(res.n_matvec) == int(alone.n_matvec)
    assert torch.equal(res.x, alone.x)
    assert res.resid_history.shape == alone.resid_history.shape
    jres = pykrylov_tpu.solve(JMatrix(jnp.asarray(R)), jnp.asarray(b),
                              rtol=1e-9, atol=1e-12, matvec_max=4 * n)
    tres = pt.solve(op, torch.from_numpy(b), rtol=1e-9, atol=1e-12,
                    matvec_max=4 * n)
    # TFQMR's shadow product r0' A r0 vanishes too: both packages end in
    # its breakdown with a finite x
    assert int(tres.istop) == int(jres.istop) == 3
    assert int(tres.n_matvec) == int(jres.n_matvec)
    assert torch.isfinite(tres.x).all()


def test_unsymmetric_routes_to_bicgstab():
    from pykrylov_tpu.gallery import convdiff2d_coo
    coo = convdiff2d_coo(12, wx=30.0, wy=15.0)
    A = operator_from_coo(*coo, device=DEV)
    jA = jax_operator_from_coo(*coo)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    res = pt.solve(A, torch.from_numpy(b), rtol=1e-10)
    alone = pt.bicgstab(A, torch.from_numpy(b), rtol=1e-10)
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b), rtol=1e-10)
    assert int(res.istop) == 0 and torch.equal(res.x, alone.x)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-10)


@pytest.mark.parametrize("method", ["cg", "minres", "symmlq", "bicgstab",
                                    "cgs", "tfqmr"])
def test_method_routes_to_each_solver(method):
    spd = method in ("cg",)
    if spd:
        vals, rows, cols, shape = poisson3d_coo(6)
        A = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                              device=DEV)
        jA = jax_operator_from_coo(vals, rows, cols, shape, symmetric=True)
        b = np.random.default_rng(1).standard_normal(shape[0])
    elif method in ("minres", "symmlq"):
        Ad, _, b = _indefinite_system()
        A, jA = _sym_op(Ad), JMatrix(jnp.asarray(Ad), symmetric=True)
    else:
        from pykrylov_tpu.gallery import convdiff2d_coo
        coo = convdiff2d_coo(10, wx=30.0, wy=15.0)
        A, jA = operator_from_coo(*coo, device=DEV), \
            jax_operator_from_coo(*coo)
        b = np.random.default_rng(1).standard_normal(A.shape[0])
    res = pt.solve(A, torch.from_numpy(b), method=method, rtol=1e-8)
    jres = pykrylov_tpu.solve(jA, jnp.asarray(b), method=method, rtol=1e-8)
    assert int(res.istop) == int(jres.istop)
    assert int(res.n_iter) == int(jres.n_iter)
    assert int(res.n_matvec) == int(jres.n_matvec)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=1e-8, atol=1e-12)
