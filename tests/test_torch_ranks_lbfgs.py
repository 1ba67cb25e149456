"""L-BFGS operators, checkpointed solves and ``show`` tables on a mesh of
ranks: spawned gloo worlds of 2 and 4 CPU processes, in f64.

One world per size runs :func:`rank_world` (this module's rank function:
the spawned ranks import this module, which imports no JAX; the JAX
package enters only inside the parent's fixtures).  Each rank builds the
four L-BFGS operators over the mesh from the same numpy pairs (one of them
rejected, and more than the memory, so the ring wraps), applies them to a
rank-sharded vector and runs CG preconditioned by the inverse operator;
runs LSQR with ``show=True`` on a gather operator; and runs a
``checkpointed_solve`` of CG on the halo operator: the 2-rank world stops
it after its first chunk, the 4-rank world resumes the file the 2-rank
world wrote.  The parent holds the products to the JAX package's
operators on the whole vectors (1e-12 relative), the preconditioned count
to the unsharded port's (within 1), the checkpoint to the all-gathered
iterate and the resumed solves (4 ranks and unsharded) to an unsharded
checkpointed solve's ``total_matvec`` (within 3), and rank 0's table's
x(1) column to the JAX table's (1e-12).
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.ops import (CompactLBFGSOperator,
                                    InverseLBFGSOperator, LBFGSOperator,
                                    MatrixOperator, StructuredLBFGSOperator)
from pykrylov_tpu_torch.parallel.launch import spawn_ranks
from pykrylov_tpu_torch.solvers import cg, lsqr
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.utils import ranks
from pykrylov_tpu_torch.utils.checkpoint import (checkpointed_solve,
                                                 load_result)

import torch_rank_legs as L

DEV = "cpu"
N = 512             # the 8^3 Poisson matrix's rows
MEM = 3             # pairs kept: the 5 offered (4 accepted) wrap the ring
RTOL = 1e-12
CG_RTOL = 1e-10
CHUNK = 10          # iterations a chunk of the checkpointed CG
KINDS = ("inverse", "forward", "compact", "structured")
CLASSES = {"inverse": InverseLBFGSOperator, "forward": LBFGSOperator,
           "compact": CompactLBFGSOperator,
           "structured": StructuredLBFGSOperator}


# -- seeded inputs, shared by the ranks and the parent ----------------------

def poisson_dense():
    vals, rows, cols, shape = poisson3d_coo(8)
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    return a


def pairs():
    """(s, y, yd) triples: y = A s on the Poisson matrix, yd = y plus a
    small perturbation (the structured operator's gradient difference);
    the third has s.y < 0 and is rejected."""
    a = poisson_dense()
    rng = np.random.default_rng(31)
    out = []
    for k in range(5):
        s = rng.standard_normal(N)
        y = -s if k == 2 else a @ s
        out.append((s, y, y + 0.1 * rng.standard_normal(N)))
    return out


def operator(kind, mesh=None):
    """An L-BFGS operator of ``kind`` (the structured one without
    scaling, as the JAX package's tests run it) holding :func:`pairs`."""
    opts = {"scaling": kind != "structured", "dtype": torch.float64,
            "device": DEV}
    op = CLASSES[kind](N, MEM, mesh=mesh, **opts)
    for s, y, yd in pairs():
        if mesh is not None:
            s, y, yd = (par.shard_vector(v, mesh) for v in (s, y, yd))
        if kind == "structured":
            op.store(s, y, yd)
        else:
            op.store(s, y)
    return op


def lsqr_coo():
    return L.general_coo(3, 45, 29)


def _local(t):
    return ranks.plain(t).detach().cpu().numpy()


# -- what every rank runs ----------------------------------------------------

def rank_world(P, ckpt, stop_after_first):
    """On each rank of a world of P: the L-BFGS products and the
    preconditioned CG, LSQR with ``show=True``, and the checkpointed CG
    on ``ckpt`` (stopped after its first chunk, or run to the end)."""
    torch.set_num_threads(1)
    mesh = par.make_mesh(device=DEV)
    out = {}
    v = par.shard_vector(L.vectors(40, N), mesh)
    for kind in KINDS:
        op = operator(kind, mesh)
        valid = op.data["valid"] if kind == "structured" else op.data.valid
        out[kind] = {"y": _local(op * v), "valid": valid.tolist()}
    H = par.HaloDiaOperator(L.poisson_dia(8), mesh)
    b = par.shard_vector(L.vectors(41, N), mesh)
    res = cg(H, b, M=operator("inverse", mesh), rtol=CG_RTOL)
    out["cg_lbfgs"] = {"n_iter": int(res.n_iter), "istop": int(res.istop),
                       "x": _local(res.x)}

    g = par.GatherEllOperator(F.coo_from_arrays(*lsqr_coo(), device=None),
                              mesh)
    bg = par.shard_vector(L.padded(L.vectors(42, 45), g.nargout), mesh)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = lsqr(g, bg, atol=1e-10, btol=1e-10, show=True)
    out["show"] = {"text": text.getvalue(), "n_iter": int(res.n_iter),
                   "table": res.info["show_table"].numpy(),
                   "x": _local(res.x)}

    keep = (lambda chunk, r: False) if stop_after_first else None
    res = checkpointed_solve(cg, H, b, ckpt, chunk_iters=CHUNK,
                             keep_going=keep, rtol=CG_RTOL)
    out["ckpt"] = {"x": _local(res.x), "converged": bool(res.converged),
                   "total_matvec": int(res.info["total_matvec"])}
    return out


# -- the parent --------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, and the checkpoint files: ``two`` as the
    2-rank world left it, ``resumed_4`` and ``unsharded`` copies of it."""
    tmp = tmp_path_factory.mktemp("ckpt")
    two = str(tmp / "two.npz")
    out = {2: spawn_ranks(rank_world, 2, 2, two, True, deadline=150.0)}
    files = {"two": load_result(two)}
    for name in ("resumed_4", "unsharded"):
        shutil.copy(two, str(tmp / (name + ".npz")))
    out[4] = spawn_ranks(rank_world, 4, 4, str(tmp / "resumed_4.npz"),
                         False, deadline=150.0)
    return out, files, str(tmp)


def rows(world, key, field):
    return np.concatenate([w[key][field] for w in world])


@pytest.fixture(scope="module")
def jax_products():
    import jax.numpy as jnp
    import pykrylov_tpu.ops as jops
    jclasses = {"inverse": jops.InverseLBFGSOperator,
                "forward": jops.LBFGSOperator,
                "compact": jops.CompactLBFGSOperator,
                "structured": jops.StructuredLBFGSOperator}
    x = jnp.asarray(L.vectors(40, N))
    out = {}
    for kind in KINDS:
        j = jclasses[kind](N, MEM, scaling=kind != "structured",
                           dtype=np.float64)
        for s, y, yd in pairs():
            args = (s, y, yd) if kind == "structured" else (s, y)
            j.store(*(jnp.asarray(a) for a in args))
        out[kind] = (np.asarray(j * x), np.asarray(j.data["valid"]
                                                   if kind == "structured"
                                                   else j.data.valid))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", [2, 4])
def test_lbfgs_products_match_jax(worlds, jax_products, P, kind):
    out, _, _ = worlds
    ref, valid = jax_products[kind]
    got = rows(out[P], kind, "y")
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())
    # every rank kept the same pairs (the rejected one on none)
    for w in out[P]:
        assert w[kind]["valid"] == valid.tolist()
    assert sum(valid) == MEM


@pytest.mark.parametrize("P", [2, 4])
def test_lbfgs_preconditioned_cg_takes_the_unsharded_count(worlds, P):
    out, _, _ = worlds
    A = MatrixOperator(poisson_dense(), symmetric=True, device=DEV)
    ref = cg(A, torch.from_numpy(L.vectors(41, N)), M=operator("inverse"),
             rtol=CG_RTOL)
    got = out[P][0]["cg_lbfgs"]
    assert got["istop"] == int(ref.istop) == 0
    assert abs(got["n_iter"] - int(ref.n_iter)) <= 1
    assert len({w["cg_lbfgs"]["n_iter"] for w in out[P]}) == 1
    np.testing.assert_allclose(rows(out[P], "cg_lbfgs", "x"), ref.x.numpy(),
                               rtol=0, atol=1e-8 * ref.x.abs().max().item())


def test_checkpoint_holds_the_gathered_iterate(worlds):
    out, files, _ = worlds
    saved = files["two"]
    np.testing.assert_array_equal(saved["x"], rows(out[2], "ckpt", "x"))
    assert int(saved["extra_chunk"]) == 0
    assert int(saved["n_iter"]) == CHUNK and not out[2][0]["ckpt"][
        "converged"]


def test_checkpoint_resumes_on_other_meshes(worlds):
    out, _, tmp = worlds
    A = MatrixOperator(poisson_dense(), symmetric=True, device=DEV)
    b = torch.from_numpy(L.vectors(41, N))
    ref = checkpointed_solve(cg, A, b, os.path.join(tmp, "fresh.npz"),
                             chunk_iters=CHUNK, rtol=CG_RTOL)
    flat = checkpointed_solve(cg, A, b, os.path.join(tmp, "unsharded.npz"),
                              chunk_iters=CHUNK, rtol=CG_RTOL)
    four = out[4][0]["ckpt"]
    want = int(ref.info["total_matvec"])
    assert bool(ref.converged) and bool(flat.converged) and four["converged"]
    assert abs(four["total_matvec"] - want) <= 3
    assert abs(int(flat.info["total_matvec"]) - want) <= 3
    assert len({w["ckpt"]["total_matvec"] for w in out[4]}) == 1
    # the 4-rank world's file holds its whole, converged iterate
    saved = load_result(os.path.join(tmp, "resumed_4.npz"))
    np.testing.assert_array_equal(saved["x"], rows(out[4], "ckpt", "x"))


def test_checkpoint_of_another_system_is_refused(worlds):
    _, _, tmp = worlds
    A = MatrixOperator(poisson_dense()[:256, :256], symmetric=True,
                       device=DEV)
    with pytest.raises(ValueError, match="another system"):
        checkpointed_solve(cg, A, torch.ones(256, dtype=torch.float64),
                           os.path.join(tmp, "two.npz"), chunk_iters=CHUNK)


@pytest.fixture(scope="module")
def jax_table():
    import jax.numpy as jnp
    from pykrylov_tpu.ops import linop_from_ndarray
    from pykrylov_tpu.solvers import lsqr as jlsqr
    vals, r, c, shape = lsqr_coo()
    a = np.zeros(shape)
    np.add.at(a, (r, c), vals)
    with contextlib.redirect_stdout(io.StringIO()):
        res = jlsqr(linop_from_ndarray(jnp.asarray(a)),
                    jnp.asarray(L.vectors(42, 45)), atol=1e-10, btol=1e-10,
                    show=True)
    return int(res.n_iter), np.asarray(res.info["show_table"])


@pytest.mark.parametrize("P", [2, 4])
def test_show_table_is_global_and_printed_once(worlds, jax_table, P):
    out, _, _ = worlds
    n_iter, jtab = jax_table
    first = out[P][0]["show"]
    assert first["n_iter"] == n_iter
    col, jcol = first["table"][:n_iter + 1, 0], jtab[:n_iter + 1, 0]
    np.testing.assert_allclose(col, jcol, rtol=0,
                               atol=RTOL * np.abs(jcol).max())
    # x(1) of the last row is the whole x's first row, on every rank
    assert col[-1] == rows(out[P], "show", "x")[0]
    for w in out[P][1:]:
        np.testing.assert_array_equal(w["show"]["table"], first["table"])
        assert w["show"]["text"] == ""
    assert "LSQR" in first["text"] and "Itn" in first["text"]
