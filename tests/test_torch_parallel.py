"""The port's meshes of shard slots and its halo-exchange operators
against the JAX package's sharded ones, on the same numpy inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on a CPU mesh of as many slots (``make_mesh(P, device="cpu")``),
at P = 1, 2, 4 and 8.  ``HaloDiaOperator(kernel=True)`` runs the JAX
Pallas DIA kernels in interpret mode and the port's kernel path through
the kernels' plain versions (the wrappers take them for CPU tensors), so
the kernel path's packing (each shard's diagonals over its halo-extended
block) is held here too.  Products are compared in f64 to 1e-12 relative
(``RTOL``); solves must take the JAX counts with histories to 1e-10.
The partitioned MatrixMarket reader is held on files the port's writer
wrote, read by both packages' readers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.gallery import poisson1d_coo, poisson3d_coo
from pykrylov_tpu.io import matrix_market as jmm
from pykrylov_tpu.solvers import cg as jcg
from pykrylov_tpu.solvers import minres as jminres
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.linop import SparseOperator as JSparseOperator

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.io import matrix_market as tmm
from pykrylov_tpu_torch.solvers import cg, minres
from pykrylov_tpu_torch.solvers.ffmv import resolve_ff_matvec
from pykrylov_tpu_torch.sparse import formats as TF
from pykrylov_tpu_torch.sparse.linop import SparseOperator

DEV = "cpu"  # the port's entry points default to the card
RTOL = 1e-12
PS = [1, 2, 4, 8]

# the JAX operators' products, compiled once per operator structure (an
# eager product of a shard_map operator retraces it: seconds a call)
jmul = jax.jit(lambda op, v: op * v)
jmul_t = jax.jit(lambda op, v: op.T * v)


def close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-300)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale)


def meshes(P):
    return jpar.make_mesh(P), par.make_mesh(P, device=DEV)


def dias(coo_triples):
    vals, rows, cols, shape = coo_triples
    jd = JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape,
                                            device=False), device=False)
    td = TF.dia_from_coo(TF.coo_from_arrays(vals, rows, cols, shape,
                                            device=None), device=None)
    return jd, td


def padded(rng, n, pad, k=None):
    shape = (n + pad,) if k is None else (n + pad, k)
    x = rng.standard_normal(shape)
    x[n:] = 0.0
    return x


# -- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("P", PS)
def test_mesh_info_matches_jax(P):
    jm, tm = meshes(P)
    ji, ti = jpar.device_mesh_info(jm), par.device_mesh_info(tm)
    # the JAX keys, and the process index, count and transport
    assert set(ti) == set(ji) | {"process_index", "process_count",
                                 "transport"}
    for key in ("axis_names", "shape", "n_devices"):
        assert ti[key] == ji[key]
    assert ti["platform"] == "cpu"
    assert (ti["process_index"], ti["process_count"]) == (0, 1)
    assert ti["transport"] == "slots" and not tm.ranked
    assert tm.slots == (torch.device("cpu"),) * P and tm.home.type == "cpu"


def test_default_mesh_and_cuda_slots(monkeypatch):
    assert par.default_mesh(device=DEV).size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            par.make_mesh(4)
    # slots of a bare "cuda" round-robin over the cards, and name them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = par.make_mesh(5)
    assert [s.index for s in mesh.slots] == [0, 1, 0, 1, 0]
    assert mesh.slots[0] == torch.device("cuda:0") and mesh.platform == "gpu"
    assert par.make_mesh(device="cuda:1").slots == (torch.device("cuda:1"),)


def test_initialize_multihost_plain_launch_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    info = par.initialize_multihost(device=DEV)
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["n_devices"] == 1 and info["platform"] == "cpu"
    assert not torch.distributed.is_initialized()


def test_initialize_multihost_explicit_and_idempotent(monkeypatch):
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        info = par.initialize_multihost("localhost:%d" % port, 1, 0,
                                        device=DEV)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (info["process_index"], info["process_count"]) == (0, 1)
        again = par.initialize_multihost("localhost:%d" % port, 1, 0,
                                         device=DEV)
        assert again == info
        # under the world the mesh is the mesh of ranks: one shard a rank
        mesh = par.make_mesh(device=DEV)
        assert mesh.ranked and mesh.size == 1 and mesh.rank == 0
        mi = par.device_mesh_info(mesh)
        assert (mi["process_index"], mi["process_count"]) == (0, 1)
        assert mi["transport"] == "host" and mi["n_devices"] == 1
        with pytest.raises(ValueError, match="one shard a rank"):
            par.make_mesh(2, device=DEV)
    finally:
        monkeypatch.undo()
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shard_vector_and_replicate():
    mesh = par.make_mesh(4, device=DEV)
    x = np.arange(8.0)
    xs = par.shard_vector(x, mesh)
    assert xs.device == mesh.home and torch.equal(xs, torch.arange(8.0,
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="multiple"):
        par.shard_vector(np.arange(7.0), mesh)
    assert par.replicate(x[:3], mesh).device == mesh.home
    assert par.pad_to_multiple(61, 8) == 64 == par.pad_to_multiple(64, 8)


# -- HaloDiaOperator ---------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("P", PS)
def test_halo_products_match_jax(P, kernel, rng):
    jd, td = dias(poisson3d_coo(8))      # halo width 64 = 512 / 8 rows
    jm, tm = meshes(P)
    jo = jpar.HaloDiaOperator(jd, jm, kernel=kernel)
    to = par.HaloDiaOperator(td, tm, kernel=kernel)
    assert (to.pad, to.halo_width, to.offsets) == (
        jo.pad, jo.halo_width, jo.offsets)
    # CPU shards: the kernels' wrappers run their plain versions
    assert to.local_kernel is False
    for shape in [(), (3,)]:
        x = rng.standard_normal((512,) + shape)
        yj = jmul(jo, jpar.shard_vector(jnp.asarray(x), jm))
        yt = to * par.shard_vector(x, tm)
        close(yt, yj)
    # each shard's storage is its packed halo-extended block (rows [w,
    # w+L) hold the shard's diagonals, the rest zero): the JAX kernel
    # path's packed block, or its plain path's flat (ndiag, mp) columns
    jc = np.asarray(jo.container)
    L, w = 512 // P, to.halo_width
    for k, c in enumerate(to.container):
        c = c.numpy()
        assert c.shape == (jc.shape[0], L + 2 * w)
        assert not c[:, :w].any() and not c[:, w + L:].any()
        if kernel:
            ref = jc[:, k].reshape(jc.shape[0], -1)[:, :L + 2 * w]
            np.testing.assert_array_equal(c, ref)
        else:
            np.testing.assert_array_equal(c[:, w:w + L],
                                          jc[:, k * L:(k + 1) * L])


@pytest.mark.parametrize("P", [2, 8])
def test_halo_padding_stays_zero(P, rng):
    jd, td = dias(poisson1d_coo(61))     # 61 rows: padded to 62 or 64
    jm, tm = meshes(P)
    jo = jpar.HaloDiaOperator(jd, jm)
    to = par.HaloDiaOperator(td, tm, kernel=True)
    assert to.pad == jo.pad and to.nargin == 61 + to.pad
    x = padded(rng, 61, to.pad)
    yt = to * par.shard_vector(x, tm)
    close(yt, jmul(jo, jpar.shard_vector(jnp.asarray(x), jm)))
    assert not yt[61:].any()


def test_halo_checks_and_texts():
    mesh = par.make_mesh(8, device=DEV)
    jm = jpar.make_mesh(8)
    jd, td = dias(poisson3d_coo(4))      # 64 rows, 8 a shard, halo 16
    with pytest.raises(ValueError) as et:
        par.HaloDiaOperator(td, mesh)
    with pytest.raises(ValueError) as ej:
        jpar.HaloDiaOperator(jd, jm)
    assert str(et.value) == str(ej.value)
    vals, rows, cols, shape = poisson1d_coo(16)
    keep = cols >= rows                  # upper bidiagonal: offsets {0, 1}
    jd, td = dias((vals[keep], rows[keep], cols[keep], shape))
    with pytest.raises(ValueError) as et:
        par.HaloDiaOperator(td, mesh)
    with pytest.raises(ValueError) as ej:
        jpar.HaloDiaOperator(jd, jm)
    assert str(et.value) == str(ej.value)
    rect = TF.DIA(np.zeros((1, 4)), (0,), (4, 5))
    with pytest.raises(ValueError, match="square"):
        par.HaloDiaOperator(rect, mesh)


@pytest.mark.parametrize("kernel", ["auto", False, True])
def test_halo_local_product_is_the_kernel_wrapper(kernel, rng, monkeypatch):
    # whatever ``kernel`` says, each product is one DIA wrapper call a
    # shard (the kernel on card shards, its plain version here)
    from pykrylov_tpu_torch.sparse import kernels as K
    calls = {"dia_matvec": 0, "dia_matmat": 0}

    def counted(name):
        fn = getattr(K, name)

        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper
    for name in calls:
        monkeypatch.setattr(K, name, counted(name))
    td = dias(poisson3d_coo(8))[1]
    to = par.HaloDiaOperator(td, par.make_mesh(4, device=DEV),
                             kernel=kernel)
    to * par.shard_vector(rng.standard_normal(512), to.mesh)
    to * par.shard_vector(rng.standard_normal((512, 3)), to.mesh)
    assert calls == {"dia_matvec": 4, "dia_matmat": 4}


def test_halo_kernel_limits():
    mesh = par.make_mesh(2, device=DEV)
    td = dias(poisson3d_coo(8))[1]
    with pytest.raises(ValueError, match="kernel must be"):
        par.HaloDiaOperator(td, mesh, kernel="plain")
    # 65 symmetric diagonals: one more than the DIA kernel takes
    n = 256
    offs = list(range(-32, 33))
    diag = TF.DIA(np.ones((len(offs), n)), tuple(offs), (n, n))
    with pytest.raises(ValueError, match="65 diagonals exceed the DIA "
                                         "kernel's 64"):
        par.HaloDiaOperator(diag, mesh)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("P", [2, 8])
def test_halo_compensated_product_matches_jax(P, kernel, rng):
    from pykrylov_tpu.solvers.ffmv import resolve_ff_matvec as jresolve
    jd, td = dias(poisson3d_coo(8))
    jm, tm = meshes(P)
    jo = jpar.HaloDiaOperator(jd, jm, kernel=kernel)
    to = par.HaloDiaOperator(td, tm, kernel=kernel)
    ff = resolve_ff_matvec(to)
    assert ff is not None
    xh = rng.standard_normal(512)
    xl = xh * 1e-17
    yh, yl = ff(torch.from_numpy(xh), torch.from_numpy(xl))
    jh, jl = jax.jit(jresolve(jo))(
        jo._params, jpar.shard_vector(jnp.asarray(xh), jm),
        jpar.shard_vector(jnp.asarray(xl), jm))
    # the hi parts bit for bit; XLA contracts the jitted cascade's
    # products differently, which moves the lo parts by ~1e-30
    np.testing.assert_array_equal(yh.numpy(), np.asarray(jh))
    close(yl, jl)
    # two operators, two registrations
    other = par.HaloDiaOperator(td, tm, kernel=kernel)
    assert resolve_ff_matvec(other) is not ff


def _same_solve(rt, rj, n_hist=True):
    assert int(rt.istop) == int(rj.istop)
    assert int(rt.n_iter) == int(rj.n_iter)
    assert int(rt.n_matvec) == int(rj.n_matvec)
    if n_hist:
        k = int(rt.n_iter) + 1
        np.testing.assert_allclose(rt.resid_history[:k].numpy(),
                                   np.asarray(rj.resid_history)[:k],
                                   rtol=1e-10)
    close(rt.x, rj.x, rtol=1e-10)


@pytest.mark.parametrize("P", PS)
def test_cg_and_minres_through_halo_match_jax(P, rng):
    jd, td = dias(poisson3d_coo(8))
    jm, tm = meshes(P)
    jo = jpar.HaloDiaOperator(jd, jm, kernel=P == 4)
    to = par.HaloDiaOperator(td, tm, kernel=P == 4)
    b = rng.standard_normal(512)
    bj, bt = jpar.shard_vector(jnp.asarray(b), jm), par.shard_vector(b, tm)
    _same_solve(cg(to, bt, rtol=1e-10, store_history=True),
                jcg(jo, bj, rtol=1e-10, store_history=True))
    _same_solve(minres(to, bt, rtol=1e-10, store_history=True),
                jminres(jo, bj, rtol=1e-10, store_history=True))


def test_cg_replace_every_through_halo_matches_jax(rng):
    jd, td = dias(poisson3d_coo(8))
    jm, tm = meshes(4)
    jo, to = jpar.HaloDiaOperator(jd, jm), par.HaloDiaOperator(td, tm)
    b = rng.standard_normal(512)
    rt = cg(to, par.shard_vector(b, tm), rtol=1e-10, replace_every=10)
    rj = jcg(jo, jpar.shard_vector(jnp.asarray(b), jm), rtol=1e-10,
             replace_every=10)
    _same_solve(rt, rj, n_hist=False)


# -- generic sharding, the Poisson system, the stencil -----------------------

@pytest.mark.parametrize("fmt", ["dia", "ell"])
@pytest.mark.parametrize("P", PS)
def test_shard_operator_matches_jax(P, fmt, rng):
    vals, rows, cols, shape = poisson1d_coo(61)
    keep = (cols - rows) != 1            # unsymmetric: drop the upper band
    vals, rows, cols = vals[keep], rows[keep], cols[keep]
    jm, tm = meshes(P)
    jcoo = JF.coo_from_arrays(vals, rows, cols, shape, device=False)
    jbuild = {"dia": JF.dia_from_coo, "ell": JF.ell_from_coo}[fmt]
    jop = JSparseOperator(jbuild(jcoo, device=False),
                          jbuild(JF.transpose_coo(jcoo), device=False))
    jsh, jpad = jpar.shard_operator(jop, jm)
    tcoo = TF.coo_from_arrays(vals, rows, cols, shape, device=None)
    build = {"dia": TF.dia_from_coo, "ell": TF.ell_from_coo}[fmt]
    top = SparseOperator(build(tcoo, device=DEV),
                         build(TF.transpose_coo(tcoo), device=DEV))
    tsh, tpad = par.shard_operator(top, tm)
    assert tpad == jpad and tsh.shape == jsh.shape
    x = padded(rng, 61, tpad)
    close(tsh * par.shard_vector(x, tm),
          jmul(jsh, jpar.shard_vector(jnp.asarray(x), jm)))
    close(tsh.T * par.shard_vector(x, tm),
          jmul_t(jsh, jpar.shard_vector(jnp.asarray(x), jm)))
    with pytest.raises(TypeError, match="ELL/DIA"):
        par.shard_operator(tsh, tm)


@pytest.mark.parametrize("how", ["halo", "generic", "matrix_free"])
def test_sharded_poisson3d_matches_jax(how):
    # the JAX builder's eager b = A e retraces its shard_map (seconds a
    # call): one mesh size here, the operators at every P above
    P = 4
    jm, tm = meshes(P)
    opts = dict(halo=how == "halo", matrix_free=how == "matrix_free")
    jo, jb, je, jpad = jpar.sharded_poisson3d(8, jm, **opts)
    to, tb, te, tpad = par.sharded_poisson3d(8, tm, **opts)
    assert tpad == jpad
    close(tb, jb)
    close(te, je)
    rt, rj = cg(to, tb, rtol=1e-10), jcg(jo, jb, rtol=1e-10)
    assert int(rt.n_iter) == int(rj.n_iter)
    close(rt.x, rj.x, rtol=1e-10)


@pytest.mark.parametrize("P", PS)
def test_stencil_matches_jax(P, rng):
    jm, tm = meshes(P)
    jo = jpar.HaloStencilPoisson3DOperator(8, jm, dtype=jnp.float64)
    to = par.HaloStencilPoisson3DOperator(8, tm, dtype=torch.float64)
    assert (to.pad, to.halo_width, to.local_kernel, to.grid_n) == (
        jo.pad, jo.halo_width, jo.local_kernel, jo.grid_n)
    for shape in [(), (3,)]:
        x = rng.standard_normal((512,) + shape)
        close(to * par.shard_vector(x, tm),
              jmul(jo, jpar.shard_vector(jnp.asarray(x), jm)))
    b = rng.standard_normal(512)
    _same_solve(cg(to, par.shard_vector(b, tm), rtol=1e-10,
                   store_history=True),
                jcg(jo, jpar.shard_vector(jnp.asarray(b), jm), rtol=1e-10,
                    store_history=True))
    with pytest.raises(ValueError, match="divide"):
        par.HaloStencilPoisson3DOperator(6, par.make_mesh(4, device=DEV))


# -- MatrixMarket: the writer and the partitioned reader ---------------------

def _random_coo(rng, m, n, nnz, complex_=False):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    if complex_:
        vals = vals + 1j * rng.standard_normal(nnz)
    return vals, rows, cols


@pytest.mark.parametrize("complex_", [False, True])
def test_writer_matches_jax_byte_for_byte(tmp_path, rng, complex_):
    vals, rows, cols = _random_coo(rng, 9, 7, 20, complex_)
    tmm.write_matrix_market(tmp_path / "t.mtx", torch.from_numpy(vals),
                            rows, cols, (9, 7), comment="two\nlines")
    jmm.write_matrix_market(tmp_path / "j.mtx", vals, rows, cols, (9, 7),
                            comment="two\nlines")
    assert (tmp_path / "t.mtx").read_bytes() == \
        (tmp_path / "j.mtx").read_bytes()
    got = tmm.read_matrix_market(tmp_path / "t.mtx")
    np.testing.assert_array_equal(got[0], vals)


@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
@pytest.mark.parametrize("P", PS)
def test_partitioned_reader_matches_jax(P, symmetry, tmp_path, rng):
    m = 37
    vals, rows, cols = _random_coo(rng, m, m, 90)
    if symmetry != "general":            # the lower triangle is stored
        lo = rows > cols if symmetry == "skew-symmetric" else rows >= cols
        vals, rows, cols = vals[lo], rows[lo], cols[lo]
    path = tmp_path / "a.mtx"
    tmm.write_matrix_market(path, vals, rows, cols, (m, m),
                            symmetry=symmetry)
    for keep in [None] + list(range(P)):
        tp, tshape, tinfo = tmm.read_matrix_market_partitioned(
            path, P, keep=keep, chunk_entries=16)
        jp, jshape, jinfo = jmm.read_matrix_market_partitioned(
            path, P, keep=keep, chunk_entries=16)
        assert tshape == jshape and tinfo == tinfo.__class__(**vars(jinfo))
        assert len(tp) == len(jp)
        for a, b in zip(tp, jp):
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    # the parts are the whole matrix's rows, shard by shard
    whole = tmm.read_matrix_market(path)
    parts = tmm.read_matrix_market_partitioned(path, P)[0]
    L = par.pad_to_multiple(m, P) // P
    for k, (v, r, c) in enumerate(parts):
        assert ((r // L) == k).all()
    assert sum(len(p[0]) for p in parts) == len(whole[0])
