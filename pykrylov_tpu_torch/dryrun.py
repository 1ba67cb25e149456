"""Entry points: the flagship single-card step and the sharded dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.  :func:`entry`
returns ``(fn, example_args)``: the verified (ff-CG) solve of the bundled
1138bus system with Jacobi, the reference's flagship configuration.
:func:`dryrun_multichip` runs the twelve sharded legs of the JAX dry run,
at its sizes, with its asserts and printed lines: on a mesh of shard
slots in one process, or on the mesh of ranks when a world of
``torch.distributed`` is up (every rank runs the same legs in lockstep
and prints the same lines).

    python -m pykrylov_tpu_torch.dryrun [n] [--ranks R] [--device cpu]
        [--transport host]

runs it over ``n`` slots (default 8), or with ``--ranks R`` over R
spawned ranks joined through a ``FileStore`` in a temporary directory
(gloo for ``--device cpu`` and for ``--transport host``, else NCCL).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """``(fn, example_args)``: ff-CG on 1138bus (f32 storage and vectors)
    with the Jacobi preconditioner, rtol 1e-6 on the unpreconditioned
    2-norm, ``replace_every=1000``; ``fn(op, M, b)`` returns ``(x,
    resid_norm, n_iter)``."""
    from .solvers import cg
    from .sparse import jacobi_preconditioner, sparse_operator

    op = sparse_operator("1138bus", symmetric=True, dtype=np.float32,
                         fmt="ell", device=device)
    M = jacobi_preconditioner("1138bus", device=device)
    b = op * torch.ones(1138, dtype=torch.float32, device=device)

    def fn(op, M, b):
        # the reference certifies the unpreconditioned residual at 1e-6;
        # in f32 that needs the verified path (double-f32 x, compensated
        # replacements), Jacobi accelerating each leg
        res = cg(op, b, M=M, rtol=1e-6, atol=0.0, maxiter=20000,
                 replace_every=1000)
        return res.x, res.resid_norm, res.n_iter

    return fn, (op, M, b)


def _on_mesh(x, mesh):
    from .utils import ranks
    if mesh.ranked:
        return isinstance(x, ranks.RankShard) and x.device == mesh.home
    return x.device == mesh.home


def dryrun_multichip(n_devices, device="cuda", transport=None, log=print):
    """Build an ``n_devices`` mesh and run the twelve sharded legs of the
    JAX dry run (f32), asserting each as it does.  Under a world of
    ``torch.distributed`` the mesh is the mesh of ranks (``n_devices``
    must be the world size; ``transport`` as
    :func:`~.parallel.mesh.rank_mesh` takes it).  Returns a dict of each
    leg's iterations and error, and ``log``s the JAX package's lines."""
    from .ops import (DiagonalOperator, IdentityOperator,
                      chebyshev_preconditioner, lanczos_bounds)
    from .parallel import (GatherBellOperator, GatherEllOperator,
                           Halo2DPoissonOperator, TallSkinnyOperator,
                           make_mesh, make_mesh2d, replicate, shard_vector,
                           shard_vector_2d, sharded_poisson3d)
    from .solvers import (bicgstab_batched, cg, cg_batched, cg_pipelined,
                          lsqr, minres)
    from .sparse import formats as F
    from .utils.ranks import norm

    mesh = make_mesh(n_devices, device=device, transport=transport)
    home = mesh.home
    out = {}
    f32 = torch.float32

    def sh(a):
        return shard_vector(torch.as_tensor(np.asarray(a)), mesh)

    # n = 1.5x the device count: shards hold several z-planes and the
    # n^2 halo crosses shard boundaries both ways (the JAX sizes)
    n = max(4, int(n_devices) * 3 // 2)
    op, b, e, pad = sharded_poisson3d(n, mesh, halo=True, dtype=np.float32)
    m_tot = n ** 3 + pad
    diag = np.full(m_tot, 6.0, dtype=np.float32)
    # the Jacobi diagonal, sharded as the vectors it scales (on a mesh of
    # slots the same tensor the JAX leg replicates)
    M = DiagonalOperator(sh(1.0 / diag), device=home)
    res = cg(op, b, M=M, rtol=1e-6, maxiter=2 * m_tot)
    assert _on_mesh(res.x, mesh)
    err = float(norm(res.x - e))
    assert bool(res.converged), (int(res.istop), float(res.resid_norm))
    assert err < 1e-3 * n ** 3, err
    out["halo_cg"] = (int(res.n_iter), err)
    log("dryrun_multichip OK: %d devices, n=%d (m=%d), %d iters, "
        "err=%.2e" % (n_devices, n, m_tot, int(res.n_iter), err))

    # multi-RHS CG over the same operator through its block product
    B2 = torch.stack([b, 0.5 * b], dim=1)
    resb = cg_batched(op, B2, M=M, rtol=1e-6, maxiter=2 * m_tot)
    assert bool(resb.converged.all()), resb.istop.tolist()
    errb = float(norm(resb.x[:, 0] - e))
    assert errb < 1e-3 * n ** 3, errb
    out["block_cg"] = (int(resb.n_iter), errb)
    log("dryrun_multichip batched OK: K=2 block CG, %d iters, err=%.2e"
        % (int(resb.n_iter), errb))

    # 2-D (rz x ry) mesh: face exchanges along both axes
    if n_devices % 2 == 0:
        rz, ry = 2, n_devices // 2
        n2 = max(8, rz, ry)
        while n2 % rz or n2 % ry:
            n2 += 1
        mesh2 = make_mesh2d(rz, ry, device=device, transport=transport)
        op2 = Halo2DPoissonOperator(n2, mesh2)
        e2 = shard_vector_2d(torch.ones(n2 ** 3, dtype=f32), mesh2)
        b2 = op2 * e2
        res2 = cg(op2, b2, rtol=1e-6, maxiter=4 * n2 ** 3)
        assert _on_mesh(res2.x, mesh2)
        assert bool(res2.converged), int(res2.istop)
        err2 = float(norm(res2.x - e2))
        assert err2 < 1e-3 * n2 ** 3, err2
        out["mesh2d_cg"] = (int(res2.n_iter), err2)
        log("dryrun_multichip 2-D mesh OK: (%d x %d), n=%d, %d iters, "
            "err=%.2e" % (rz, ry, n2, int(res2.n_iter), err2))

    # tall-skinny LSQR: rows blocked, the n side on every shard
    rng = np.random.default_rng(0)
    mt, nt = 37 * n_devices + 5, 9
    at = rng.standard_normal((mt, nt)).astype(np.float32)
    xt = rng.standard_normal(nt).astype(np.float32)
    opt = TallSkinnyOperator(at, mesh)
    bt = np.zeros(opt.nargout, np.float32)
    bt[:mt] = at @ xt
    res3 = lsqr(opt, sh(bt), atol=1e-6, btol=1e-6)
    err3 = float(torch.linalg.vector_norm(res3.x.cpu() - torch.from_numpy(
        xt)))
    assert err3 < 1e-3, err3
    out["tall_lsqr"] = (int(res3.n_iter), err3)
    log("dryrun_multichip tall-skinny LSQR OK: m=%d n=%d (pad %d), "
        "%d iters, err=%.2e" % (mt, nt, opt.pad, int(res3.n_iter), err3))

    # both sides blocked: gather schedule and its reversed transpose
    mr, nr = 23 * n_devices + 3, 11 * n_devices + 5
    rows = np.arange(mr)
    cols = (np.arange(mr) * 7 + 3) % nr
    vals = 2.0 + 0.1 * rng.standard_normal(mr)
    extra = rng.integers(0, mr, 4 * mr), rng.integers(0, nr, 4 * mr)
    ar = np.zeros((mr, nr), np.float32)
    np.add.at(ar, (rows, cols), vals)
    ar[extra] += 0.05 * rng.standard_normal(4 * mr).astype(np.float32)
    rr, cc = np.nonzero(ar)
    coo = F.coo_from_arrays(ar[rr, cc], rr, cc, (mr, nr), device=None)
    opr = GatherEllOperator(coo, mesh)
    br = np.zeros(opr.nargout, np.float32)
    br[:mr] = rng.standard_normal(mr)
    res4 = lsqr(opr, sh(br), atol=1e-5, btol=1e-5, itnlim=8 * nr)
    assert _on_mesh(res4.x, mesh)
    opt_res = float(norm(opr.T * (sh(br) - opr * res4.x)))
    assert opt_res < 1e-2 * float(np.linalg.norm(br)), opt_res
    out["gather_lsqr"] = (int(res4.n_iter), opt_res)
    log("dryrun_multichip rectangular gather LSQR OK: m=%d n=%d "
        "(pads %d/%d), %d iters, ||A'r||=%.2e"
        % (mr, nr, opr.pad, opr.pad_n, int(res4.n_iter), opt_res))

    # bicgstab_batched over general sparsity with the SELL products
    ng = 192 * n_devices
    rngg = np.random.default_rng(7)
    rowsg = np.repeat(np.arange(ng), 5)
    offs = rngg.integers(1, 41, size=len(rowsg)) \
        * rngg.choice([-1, 1], size=len(rowsg))
    colsg = (rowsg + offs) % ng
    valsg = 0.2 * rngg.standard_normal(len(rowsg))
    rowsg = np.concatenate([rowsg, np.arange(ng)])
    colsg = np.concatenate([colsg, np.arange(ng)])
    valsg = np.concatenate([valsg, np.full(ng, 4.0)])
    key = rowsg * ng + colsg
    _, first = np.unique(key, return_index=True)
    coog = F.coo_from_arrays(valsg[first].astype(np.float32), rowsg[first],
                             colsg[first], (ng, ng), device=None)
    opg = GatherBellOperator(coog, mesh, with_transpose=True)
    eg = np.zeros(opg.nargin, np.float32)
    eg[:ng] = 1.0
    bg1 = opg * sh(eg)
    Bg = torch.stack([bg1, 0.5 * bg1], dim=1)
    res5 = bicgstab_batched(opg, Bg, rtol=1e-4)
    assert bool(res5.converged.all()), res5.istop.tolist()
    err5 = float((replicate(res5.x, mesh)[:ng, 0] - 1.0).abs().max())
    assert err5 < 1e-3, err5
    out["bell_bicgstab_batched"] = (int(res5.n_iter), err5)
    log("dryrun_multichip sharded-BELL bicgstab_batched OK: n=%d K=2, "
        "%d iters, err=%.2e" % (ng, int(res5.n_iter), err5))

    # LSQR over the same operator: A^T through the transposed shards
    bg = np.zeros(opg.nargout, np.float32)
    bg[:ng] = rngg.standard_normal(ng)
    res6 = lsqr(opg, sh(bg), atol=1e-6, btol=1e-6, itnlim=4 * ng)
    opt6 = float(norm(opg.T * (sh(bg) - opg * res6.x)))
    assert opt6 < 1e-2 * float(np.linalg.norm(bg)), opt6
    out["bell_transpose_lsqr"] = (int(res6.n_iter), opt6)
    log("dryrun_multichip GatherBell-transpose LSQR OK: n=%d, "
        "%d iters, ||A'r||=%.2e" % (ng, int(res6.n_iter), opt6))

    # matrix-free stencil CG
    nf = 2 * n_devices
    opf, bf, ef, padf = sharded_poisson3d(nf, mesh, matrix_free=True,
                                          dtype=np.float32)
    assert padf == 0
    res8 = cg(opf, bf, rtol=1e-6, maxiter=4 * nf ** 3)
    assert _on_mesh(res8.x, mesh)
    assert bool(res8.converged), int(res8.istop)
    err8 = float((replicate(res8.x - ef, mesh)).abs().max())
    assert err8 < 1e-3, err8
    out["stencil_cg"] = (int(res8.n_iter), err8)
    log("dryrun_multichip matrix-free stencil CG OK: n=%d, %d iters, "
        "err=%.2e" % (nf, int(res8.n_iter), err8))

    # Chebyshev polynomial preconditioner over the halo operator
    lmin, lmax = lanczos_bounds(op, k=12)
    Mc = chebyshev_preconditioner(op, degree=6,
                                  bounds=(float(lmin), float(lmax)))
    res7 = cg(op, b, M=Mc, rtol=1e-6, maxiter=2 * m_tot)
    assert _on_mesh(res7.x, mesh)
    assert bool(res7.converged), int(res7.istop)
    err7 = float(norm(res7.x - e))
    assert err7 < 1e-3 * n ** 3, err7
    assert int(res7.n_iter) < int(res.n_iter), (int(res7.n_iter),
                                                int(res.n_iter))
    out["chebyshev_cg"] = (int(res7.n_iter), err7)
    log("dryrun_multichip Chebyshev-sharded CG OK: degree 6, "
        "%d iters (plain %d), err=%.2e"
        % (int(res7.n_iter), int(res.n_iter), err7))

    # symmetric indefinite: MINRES on A - sigma I
    sigma = 2.0
    op_ind = op - sigma * IdentityOperator(m_tot, dtype=f32, device=home)
    b_ind = op_ind * e
    res9 = minres(op_ind, b_ind, rtol=1e-5, itnlim=4 * m_tot)
    assert _on_mesh(res9.x, mesh)
    assert bool(res9.converged), int(res9.istop)
    err9 = float(norm(res9.x - e))
    assert err9 < 1e-2 * n ** 3, err9
    out["indefinite_minres"] = (int(res9.n_iter), err9)
    log("dryrun_multichip sharded indefinite MINRES OK: shift=%.1f, "
        "%d iters, err=%.2e" % (sigma, int(res9.n_iter), err9))

    # pipelined CG over the same system
    res10 = cg_pipelined(op, b, M=M, rtol=1e-6, maxiter=2 * m_tot)
    assert _on_mesh(res10.x, mesh)
    assert bool(res10.converged), int(res10.istop)
    err10 = float(norm(res10.x - e))
    assert err10 < 1e-3 * n ** 3, err10
    out["pipelined_cg"] = (int(res10.n_iter), err10)
    log("dryrun_multichip pipelined CG OK: %d iters (classic %d), "
        "err=%.2e" % (int(res10.n_iter), int(res.n_iter), err10))

    # verified CG over a gather operator (compensated products, the f64
    # host oracle of the f32-stored matrix as the certificate)
    nv = 64 * n_devices
    rv = np.random.default_rng(3)
    av = np.zeros((nv, nv), np.float32)
    iv = rv.integers(0, nv, 6 * nv), rv.integers(0, nv, 6 * nv)
    av[iv] += 0.05 * rv.standard_normal(6 * nv).astype(np.float32)
    av = av + av.T
    av[np.arange(nv), np.arange(nv)] = 4.0
    rr2, cc2 = np.nonzero(av)
    coov = F.coo_from_arrays(av[rr2, cc2], rr2, cc2, (nv, nv), device=None)
    opv = GatherEllOperator(coov, mesh, symmetric=True)
    ev = np.zeros(opv.nargin, np.float32)
    ev[:nv] = 1.0
    bv = opv * sh(ev)
    res11 = cg(opv, bv, rtol=1e-6, atol=0.0, replace_every=10, maxiter=4000)
    assert bool(res11.converged), int(res11.istop)
    bv64 = replicate(bv, mesh).cpu().numpy().astype(np.float64)[:nv]
    x64 = replicate(res11.x, mesh).cpu().numpy().astype(np.float64)[:nv]
    r64 = bv64 - av.astype(np.float64) @ x64
    rel11 = float(np.linalg.norm(r64) / np.linalg.norm(bv64))
    assert rel11 < 1e-6, rel11
    out["verified_cg"] = (int(res11.n_iter), rel11)
    log("dryrun_multichip VERIFIED sharded CG OK: n=%d, %d iters, "
        "f64-oracle rel resid=%.2e" % (nv, int(res11.n_iter), rel11))
    return out


def _rank_run(n_ranks, device, transport):
    lines = []
    out = dryrun_multichip(n_ranks, device=device, transport=transport,
                           log=lines.append)
    return out, lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="shard slots of the one-process mesh")
    p.add_argument("--ranks", type=int, default=0,
                   help="run over this many spawned ranks instead")
    p.add_argument("--device", default="cuda")
    p.add_argument("--transport", default=None, choices=("host", "nccl"))
    p.add_argument("--deadline", type=float, default=600.0)
    args = p.parse_args(argv)
    if not args.ranks:
        dryrun_multichip(args.n, device=args.device)
        return
    from .parallel.launch import spawn_ranks
    gloo = torch.device(args.device).type == "cpu" \
        or args.transport == "host"
    results = spawn_ranks(_rank_run, args.ranks, args.ranks, args.device,
                          args.transport,
                          backend="gloo" if gloo else "nccl",
                          deadline=args.deadline)
    outs = [r[0] for r in results]
    if any(o != outs[0] for o in outs[1:]):
        raise RuntimeError("the ranks disagree: %r" % (outs,))
    for line in results[0][1]:
        print(line)


if __name__ == "__main__":
    main()
