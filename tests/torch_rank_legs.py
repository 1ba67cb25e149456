"""What the spawned ranks of the rank-mesh tests run.

Each function runs on every rank of a world that
``pykrylov_tpu_torch.parallel.launch.spawn_ranks`` started, builds the
mesh of ranks on the host (gloo), and returns this rank's results as NumPy
arrays for the parent to assemble and compare.  This module imports only
the port and NumPy (a spawned rank imports it by name), never JAX; the
inputs come from the seeded functions below, which the parent calls too.
"""

import numpy as np
import torch

from pykrylov_tpu_torch import parallel as par
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.utils import ranks

DEV = "cpu"


# -- seeded inputs, shared with the parent -----------------------------------

def poisson_dia(n=8):
    vals, rows, cols, shape = poisson3d_coo(n)
    return F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                            device=None), device=None)


def general_coo(seed, m, n, symmetric=False):
    """A random diagonally dominant (m, n) matrix's COO triples."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n))
    k = min(m, n)
    a[np.arange(k), np.arange(k)] = 4.0
    rr, cc = rng.integers(0, m, 4 * m), rng.integers(0, n, 4 * m)
    a[rr, cc] += 0.3 * rng.standard_normal(4 * m)
    if symmetric:
        a = a + a.T
    r, c = np.nonzero(a)
    return a[r, c], r, c, (m, n)


def vectors(seed, n, k=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k))


def padded(x, n_to):
    out = np.zeros((n_to,) + x.shape[1:])
    out[:x.shape[0]] = x
    return out


def tall_dense(P):
    rng = np.random.default_rng(5)
    return rng.standard_normal((37 * P + 5, 9))


def _coo(t):
    return F.coo_from_arrays(*t, device=None)


def _local(t):
    return ranks.plain(t).detach().cpu().numpy()


def _mesh():
    return par.make_mesh(device=DEV)


# -- operator products -------------------------------------------------------

def operator_products(P):
    """This rank's rows of every sharded operator's products, and the
    replicated results (the tall operator's ``A^T u``)."""
    torch.set_num_threads(1)
    mesh = _mesh()
    out = {"info": par.device_mesh_info(mesh)}

    # the halo DIA operator, from the whole container and from this
    # rank's rows only (sharded_poisson3d)
    op = par.HaloDiaOperator(poisson_dia(8), mesh, kernel=True)
    x, X = vectors(1, 512), vectors(2, 512, 3)
    out["halo_x"] = _local(op * par.shard_vector(x, mesh))
    out["halo_X"] = _local(op * par.shard_vector(X, mesh))
    own, b, e, pad = par.sharded_poisson3d(8, mesh)
    out["halo_local_equal"] = bool(torch.equal(
        own * par.shard_vector(x, mesh), op * par.shard_vector(x, mesh)))
    out["halo_b"] = _local(b)

    # gather ELL: square nonsymmetric (forward and transposed) and
    # rectangular (both sides blocked)
    for name, (m, n) in (("sq", (61, 61)), ("rect", (45, 29))):
        g = par.GatherEllOperator(_coo(general_coo(3, m, n)), mesh)
        xn = padded(vectors(4, n), g.nargin)
        um = padded(vectors(5, m), g.nargout)
        out["ell_%s_fwd" % name] = _local(g * par.shard_vector(xn, mesh))
        out["ell_%s_bwd" % name] = _local(g.T * par.shard_vector(um, mesh))
        out["ell_%s_attrs" % name] = np.array(
            [g.comm_entries_per_matvec, g.comm_entries_true,
             g.allgather_entries_per_matvec])

    # gather BELL: forward, transposed, (n, K)
    gb = par.GatherBellOperator(_coo(general_coo(6, 70, 70)), mesh,
                                with_transpose=True)
    xb = padded(vectors(7, 70), gb.nargin)
    Xb = padded(vectors(8, 70, 3), gb.nargin)
    out["bell_fwd"] = _local(gb * par.shard_vector(xb, mesh))
    out["bell_bwd"] = _local(gb.T * par.shard_vector(xb, mesh))
    out["bell_fwd_K"] = _local(gb * par.shard_vector(Xb, mesh))
    out["bell_bwd_K"] = _local(gb.T * par.shard_vector(Xb, mesh))
    out["bell_slots"] = np.array([gb.slots_per_device])

    # tall: dense and ELL row blocks
    a = tall_dense(P)
    for name, src in (("dense", a), ("ell", _coo((a[np.nonzero(a)],)
                                                  + np.nonzero(a)
                                                  + (a.shape,)))):
        t = par.TallSkinnyOperator(src, mesh)
        xt = torch.from_numpy(vectors(9, 9))
        ut = padded(vectors(10, a.shape[0]), t.nargout)
        out["tall_%s_fwd" % name] = _local(t * xt)
        out["tall_%s_bwd" % name] = _local(t.T * par.shard_vector(ut,
                                                                   mesh))

    # the 2-D mesh (bricks) and the z-slab stencil
    mesh2 = par.make_mesh2d(2, P // 2, device=DEV)
    o2 = par.Halo2DPoissonOperator(8, mesh2, dtype=torch.float64)
    out["mesh2d"] = _local(o2 * par.shard_vector_2d(vectors(11, 512),
                                                    mesh2))
    st = par.HaloStencilPoisson3DOperator(8, mesh, dtype=torch.float64)
    out["stencil_x"] = _local(st * par.shard_vector(x, mesh))
    out["stencil_X"] = _local(st * par.shard_vector(X, mesh))

    # the generic operator (whole x by all_gather; DIA by halo)
    from pykrylov_tpu_torch.sparse.linop import SparseOperator
    c = _coo(general_coo(12, 61, 61))
    for fmt, build in (("ell", F.ell_from_coo), ("dia", F.dia_from_coo)):
        if fmt == "dia":
            vals, rows, cols, shape = poisson3d_coo(4)
            c = _coo((vals, rows, cols, shape))
        sop = SparseOperator(build(c, device=DEV), None, symmetric=True)
        s, pad = par.shard_operator(sop, mesh)
        xs = padded(vectors(13, c.shape[0]), c.shape[0] + pad)
        out["generic_%s" % fmt] = _local(s * par.shard_vector(xs, mesh))
    return out


# -- solves -------------------------------------------------------------------

def _solve_out(res, hist=True):
    d = {"x": _local(res.x), "n_iter": int(res.n_iter),
         "istop": int(res.istop), "n_matvec": int(res.n_matvec)}
    if hist and res.resid_history is not None:
        d["hist"] = res.resid_history.cpu().numpy()
    return d


def solves(P, mtx_path=None):
    """Every solver leg on the mesh of ranks, in f64."""
    from pykrylov_tpu_torch.ops import DiagonalOperator, IdentityOperator
    from pykrylov_tpu_torch.solvers import (bicgstab_batched, cg,
                                            cg_batched, cg_pipelined, lsqr,
                                            minres)
    torch.set_num_threads(1)
    mesh = _mesh()
    out = {}
    op = par.HaloDiaOperator(poisson_dia(8), mesh)
    b = par.shard_vector(vectors(20, 512), mesh)
    out["cg"] = _solve_out(cg(op, b, rtol=1e-10, store_history=True))
    M = DiagonalOperator(par.shard_vector(np.full(512, 1 / 6.0), mesh),
                         device=DEV)
    out["cg_jacobi"] = _solve_out(cg(op, b, M=M, rtol=1e-10,
                                     store_history=True))
    out["minres"] = _solve_out(minres(op, b, rtol=1e-10,
                                      store_history=True))
    eye = IdentityOperator(512, dtype=torch.float64, device=DEV)
    # parity systems with gapped spectra: A - 0.5 I has one negative
    # eigenvalue (-0.14) away from zero; A + 2 I, condition ~6, keeps the
    # pipelined recurrences on the classic ones
    out["minres_indefinite"] = _solve_out(minres(op - 0.5 * eye, b,
                                                 rtol=1e-10,
                                                 store_history=True))
    out["pipelined"] = _solve_out(cg_pipelined(op + 2.0 * eye, b,
                                               rtol=1e-8,
                                               store_history=True))
    B = par.shard_vector(vectors(21, 512, 2), mesh)
    rb = cg_batched(op, B, rtol=1e-10)
    out["cg_batched"] = {"x": _local(rb.x), "n_iter": rb.n_iter.tolist(),
                         "istop": rb.istop.tolist()}
    out["cg_verified"] = _solve_out(cg(op, b, rtol=1e-10, replace_every=10),
                                    hist=False)

    g = par.GatherEllOperator(_coo(general_coo(3, 61, 61, True)), mesh,
                              symmetric=True)
    bg = par.shard_vector(padded(vectors(22, 61), g.nargout), mesh)
    out["cg_verified_gather"] = _solve_out(
        cg(g, bg, rtol=1e-10, atol=0.0, replace_every=10), hist=False)

    r = par.GatherEllOperator(_coo(general_coo(3, 45, 29)), mesh)
    br = par.shard_vector(padded(vectors(23, 45), r.nargout), mesh)
    out["lsqr_gather"] = _solve_out(lsqr(r, br, atol=1e-10, btol=1e-10,
                                         store_history=True))
    t = par.TallSkinnyOperator(tall_dense(P), mesh)
    bt = par.shard_vector(padded(vectors(24, 37 * P + 5), t.nargout), mesh)
    out["lsqr_tall"] = _solve_out(lsqr(t, bt, atol=1e-10, btol=1e-10,
                                       store_history=True))
    # the tall solution is replicated: every rank holds all of it
    out["lsqr_tall"]["x_is_plain"] = not ranks.sharded(
        lsqr(t, bt, atol=1e-10, btol=1e-10).x)

    gb = par.GatherBellOperator(_coo(general_coo(6, 70, 70)), mesh,
                                with_transpose=True)
    Bb = par.shard_vector(padded(vectors(25, 70, 2), gb.nargout), mesh)
    rbb = bicgstab_batched(gb, Bb, rtol=1e-10)
    out["bicgstab_batched"] = {"x": _local(rbb.x),
                               "n_iter": rbb.n_iter.tolist(),
                               "istop": rbb.istop.tolist()}

    if mtx_path is not None:
        # each rank parses the file and keeps its own rows
        gm = par.gather_ell_from_mtx(mtx_path, mesh, symmetric=None)
        xm = padded(vectors(26, gm.shape[1] - gm.pad_n), gm.nargin)
        out["mtx_fwd"] = _local(gm * par.shard_vector(xm, mesh))
        out["mtx_rows"] = int(gm.container[0][mesh.rank].shape[0])
    return out


def raise_on_rank_one():
    """Rank 1 raises; the others wait in a collective it never joins."""
    mesh = _mesh()
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    ranks.all_reduce(torch.ones(1))
    return mesh.rank
