"""The port's checkpointed solves (``utils/checkpoint.py``) against the JAX
package's, on the same systems and the same files.

Both packages solve the same dense SPD system (f64, condition about 40)
in chunks of a few iterations; each chunk restarts the solver from the
saved iterate.  The iterates agree to 1e-10 relative, ``total_matvec``
and the chunk count are equal, and the absolute threshold frozen after
the first chunk is the same number in both checkpoints.  A solve stopped
by ``keep_going`` resumes from its file, and from a file the other
package wrote."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.ops as jops
import pykrylov_tpu.solvers as jsol
from pykrylov_tpu.utils import checkpoint as jck

from pykrylov_tpu_torch import solvers as tsol
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.utils import (checkpointed_solve, load_result,
                                      save_result)

DEV = "cpu"  # the port's entry points default to the card
N = 120


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = (q * np.linspace(1.0, 40.0, N)) @ q.T
    a = 0.5 * (a + a.T)
    b = rng.standard_normal(N)
    return (MatrixOperator(a, symmetric=True, device=DEV),
            jops.MatrixOperator(jnp.asarray(a), symmetric=True), a, b)


def both(system, name, tmp_path, tag, **kw):
    top, jop, _, b = system
    pt, pj = tmp_path / ("t_%s.npz" % tag), tmp_path / ("j_%s.npz" % tag)
    rt = checkpointed_solve(getattr(tsol, name), top, torch.from_numpy(b),
                            str(pt), **kw)
    rj = jck.checkpointed_solve(getattr(jsol, name), jop, jnp.asarray(b),
                                str(pj), **kw)
    return rt, rj, load_result(str(pt)), jck.load_result(str(pj))


def agree(rt, rj, st, sj):
    assert int(rt.info["total_matvec"]) == int(rj.info["total_matvec"])
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.n_iter) == int(rj.n_iter)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-12)
    assert int(st["extra_chunk"]) == int(sj["extra_chunk"])
    assert int(st["extra_total_matvec"]) == int(sj["extra_total_matvec"])
    np.testing.assert_allclose(float(st["extra_abs_threshold"]),
                               float(sj["extra_abs_threshold"]), rtol=1e-12)
    assert set(st) == set(sj)


@pytest.mark.parametrize("name", ["cg", "cg_pipelined", "minres", "bicgstab",
                                  "cgs", "tfqmr", "lsqr"])
def test_cap_keyword_and_freeze_as_jax(name):
    # the cap keyword (maxiter, else matvec_max) and whether the threshold
    # can be frozen are read from the signature: the same on both sides
    import inspect
    pt = inspect.signature(getattr(tsol, name)).parameters
    pj = inspect.signature(getattr(jsol, name)).parameters
    for key in ("maxiter", "matvec_max", "rtol", "atol", "x0"):
        assert (key in pt) == (key in pj)
    for key in ("rtol", "atol"):
        if key in pt:
            assert pt[key].default == pj[key].default


@pytest.mark.parametrize("name,chunk", [("cg", 7), ("cg_pipelined", 9),
                                        ("bicgstab", 12)])
def test_chunked_solve_matches_jax(system, name, chunk, tmp_path):
    rt, rj, st, sj = both(system, name, tmp_path, "run", chunk_iters=chunk,
                          rtol=1e-9)
    assert bool(rt.converged) and int(st["extra_chunk"]) >= 2
    agree(rt, rj, st, sj)
    # the frozen threshold is the first chunk's rtol * ||b|| (x0 = 0)
    b = system[3]
    np.testing.assert_allclose(float(st["extra_abs_threshold"]),
                               1e-9 * np.linalg.norm(b), rtol=1e-12)
    a = system[2]
    x = rt.x.numpy()
    assert np.linalg.norm(a @ x - b) <= 1.1e-9 * np.linalg.norm(b)


def test_default_tolerances_are_frozen(system, tmp_path):
    rt, rj, st, sj = both(system, "cg", tmp_path, "dflt", chunk_iters=10)
    agree(rt, rj, st, sj)
    assert float(st["extra_abs_threshold"]) > 0


def _stop_after_first(chunk, res):
    return False


def test_resume_matches_jax(system, tmp_path):
    kw = dict(chunk_iters=8, rtol=1e-10)
    rt, rj, st, sj = both(system, "cg", tmp_path, "res",
                          keep_going=_stop_after_first, **kw)
    assert not bool(rt.converged) and int(st["extra_chunk"]) == 0
    agree(rt, rj, st, sj)
    # a second call resumes from each file, with the frozen threshold
    rt2, rj2, st2, sj2 = both(system, "cg", tmp_path, "res", **kw)
    assert bool(rt2.converged)
    agree(rt2, rj2, st2, sj2)
    np.testing.assert_allclose(float(st2["extra_abs_threshold"]),
                               float(st["extra_abs_threshold"]), rtol=0)
    assert int(rt2.info["total_matvec"]) > int(rt.info["total_matvec"])


def test_resume_from_a_jax_file(system, tmp_path):
    top, jop, a, b = system
    kw = dict(chunk_iters=8, rtol=1e-10)
    pj = str(tmp_path / "j.npz")
    jck.checkpointed_solve(jsol.cg, jop, jnp.asarray(b), pj,
                           keep_going=_stop_after_first, **kw)
    pt = str(tmp_path / "t.npz")
    shutil.copy(pj, pt)
    rt = checkpointed_solve(tsol.cg, top, torch.from_numpy(b), pt, **kw)
    rj = jck.checkpointed_solve(jsol.cg, jop, jnp.asarray(b), pj, **kw)
    agree(rt, rj, load_result(pt), jck.load_result(pj))
    # and the JAX package resumes from a file the port wrote
    pt2, pj2 = str(tmp_path / "t2.npz"), str(tmp_path / "j2.npz")
    checkpointed_solve(tsol.cg, top, torch.from_numpy(b), pt2,
                       keep_going=_stop_after_first, **kw)
    shutil.copy(pt2, pj2)
    rj2 = jck.checkpointed_solve(jsol.cg, jop, jnp.asarray(b), pj2, **kw)
    rt2 = checkpointed_solve(tsol.cg, top, torch.from_numpy(b), pt2, **kw)
    agree(rt2, rj2, load_result(pt2), jck.load_result(pj2))


def test_resume_puts_x0_on_b_device_and_dtype(system, tmp_path):
    top, _, a, b = system
    path = str(tmp_path / "f64.npz")
    checkpointed_solve(tsol.cg, top, torch.from_numpy(b), path,
                       chunk_iters=5, keep_going=_stop_after_first)
    seen = {}

    def spy(A, b, x0=None, maxiter=None, rtol=1e-6, atol=0.0):
        seen["x0"] = x0
        return tsol.cg(A, b, x0=x0, maxiter=maxiter, rtol=rtol, atol=atol)

    saved = load_result(path)["x"]
    b32 = torch.from_numpy(b).float()
    top32 = MatrixOperator(a.astype(np.float32), symmetric=True, device=DEV)
    checkpointed_solve(spy, top32, b32, path, chunk_iters=5, max_chunks=1)
    assert seen["x0"].dtype == torch.float32
    assert seen["x0"].device == b32.device
    np.testing.assert_array_equal(seen["x0"].numpy(),
                                  saved.astype(np.float32))


def test_save_and_load_match_jax(system, tmp_path):
    top, jop, _, b = system
    rt = tsol.cg(top, torch.from_numpy(b), rtol=1e-8, store_history=True)
    rj = jsol.cg(jop, jnp.asarray(b), rtol=1e-8, store_history=True)
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_result(pt, rt, extra={"tag": 3})
    jck.save_result(pj, rj, extra={"tag": 3})
    st, sj = load_result(pt), jck.load_result(pj)
    assert set(st) == set(sj)
    for k in st:
        assert st[k].shape == sj[k].shape, k
        if k not in ("x", "resid_norm", "resid_norm0", "resid_history"):
            np.testing.assert_array_equal(st[k], sj[k])
    assert load_result(str(tmp_path / "none.npz")) is None
    # written atomically: no temporary file is left beside the checkpoint
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "t.npz"]


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_solve_checkpoints_as_jax(P, tmp_path):
    # a sharded vector is one padded tensor: its checkpoint is its values,
    # and a chunked CG through the halo operator matches the JAX one's
    import pykrylov_tpu.parallel as jpar
    from pykrylov_tpu.sparse import formats as JF
    from pykrylov_tpu_torch import parallel as par
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as TF
    trip = poisson3d_coo(6)
    jd = JF.dia_from_coo(JF.coo_from_arrays(*trip, device=False),
                         device=False)
    td = TF.dia_from_coo(TF.coo_from_arrays(*trip, device=None), device=None)
    jo = jpar.HaloDiaOperator(jd, jpar.make_mesh(P))
    to = par.HaloDiaOperator(td, par.make_mesh(P, device=DEV))
    b = np.zeros(to.nargin)
    b[:216] = np.random.default_rng(3).standard_normal(216)
    kw = dict(chunk_iters=6, rtol=1e-10)
    pt_, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    rt = checkpointed_solve(tsol.cg, to, par.shard_vector(b, to.mesh), pt_,
                            **kw)
    rj = jck.checkpointed_solve(jsol.cg, jo, jpar.shard_vector(
        jnp.asarray(b), jo.mesh), pj, **kw)
    agree(rt, rj, load_result(pt_), jck.load_result(pj))
    assert load_result(pt_)["x"].shape == (to.nargin,)
