"""The port's 2-D mesh decomposition of the 3-D Poisson operator
(``parallel/halo2d.py``) against the JAX package's, on the same numpy
inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(``make_mesh2d(rz, ry)``); the port on a CPU mesh of as many slots
(``make_mesh2d(rz, ry, device="cpu")``), at 2x4, 4x2, 1x8 and 8x1 and at
2x2.  Products, single and block, agree in f64 to 1e-12 relative; CG
takes the JAX count with its history to 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pykrylov_tpu.parallel as jpar
from pykrylov_tpu.solvers import cg as jcg

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.solvers import cg, cg_batched

from test_torch_gather import close, _same

DEV = "cpu"  # the port's entry points default to the card
GRIDS = [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)]
N = 8

jmul = jax.jit(lambda op, v: op * v)


def ops(rz, ry, n=N, dtype=np.float64):
    return (jpar.Halo2DPoissonOperator(n, jpar.make_mesh2d(rz, ry),
                                       dtype=dtype),
            par.Halo2DPoissonOperator(n, par.make_mesh2d(rz, ry, device=DEV),
                                      dtype=dtype))


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_and_bricks_match_jax(grid, rng):
    rz, ry = grid
    jm, tm = jpar.make_mesh2d(rz, ry), par.make_mesh2d(rz, ry, device=DEV)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape) and tm.size == rz * ry
    assert par.device_mesh_info(tm)["shape"] == dict(jm.shape)
    v = rng.standard_normal(N ** 3)
    vb = par.to_bricks(v, N, rz, ry)
    np.testing.assert_array_equal(
        vb, np.asarray(jpar.to_bricks(jnp.asarray(v), N, rz, ry)))
    np.testing.assert_array_equal(par.from_bricks(vb, N, rz, ry), v)
    assert torch.equal(par.to_bricks(torch.from_numpy(v), N, rz, ry),
                       torch.from_numpy(vb))


@pytest.mark.parametrize("grid", GRIDS)
def test_products_match_jax(grid, rng):
    rz, ry = grid
    jo, to = ops(rz, ry)
    assert to.comm_elems_per_matvec == jo.comm_elems_per_matvec
    v = par.to_bricks(rng.standard_normal(N ** 3), N, rz, ry)
    jv = jpar.shard_vector_2d(jnp.asarray(v), jo.mesh)
    close(to * par.shard_vector_2d(v, to.mesh), jmul(jo, jv))
    V = np.stack([par.to_bricks(rng.standard_normal(N ** 3), N, rz, ry)
                  for _ in range(3)], axis=1)
    Y = to * par.shard_vector_2d(V, to.mesh)
    ref = np.stack([np.asarray(jmul(jo, jpar.shard_vector_2d(
        jnp.asarray(V[:, j]), jo.mesh))) for j in range(3)], axis=1)
    close(Y, ref)


def test_natural_order_product_is_the_stencil(rng):
    # from_bricks(A to_bricks(v)) is the natural-order Poisson product
    vals, rows, cols, shape = poisson3d_coo(N)
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    to = ops(2, 4)[1]
    v = rng.standard_normal(N ** 3)
    y = to * par.shard_vector_2d(par.to_bricks(v, N, 2, 4), to.mesh)
    np.testing.assert_allclose(par.from_bricks(y.numpy(), N, 2, 4), a @ v,
                               rtol=1e-12, atol=1e-12)


def test_cg_matches_jax(rng):
    jo, to = ops(2, 4)
    b = par.to_bricks(rng.standard_normal(N ** 3), N, 2, 4)
    rt = cg(to, par.shard_vector_2d(b, to.mesh), rtol=1e-10,
            store_history=True)
    rj = jcg(jo, jpar.shard_vector_2d(jnp.asarray(b), jo.mesh), rtol=1e-10,
             store_history=True)
    _same(rt, rj)
    # the 1-D z-slab split of the same system takes the same count
    op1 = par.HaloStencilPoisson3DOperator(N, par.make_mesh(8, device=DEV),
                                           dtype=torch.float64)
    r1 = cg(op1, torch.from_numpy(par.from_bricks(b, N, 2, 4)), rtol=1e-10)
    assert int(r1.n_iter) == int(rt.n_iter)
    np.testing.assert_allclose(par.from_bricks(rt.x.numpy(), N, 2, 4),
                               r1.x.numpy(), rtol=1e-8, atol=1e-10)


def test_batched_cg_over_bricks():
    to = ops(2, 4, dtype=np.float32)[1]
    e = par.shard_vector_2d(torch.ones(N ** 3), to.mesh)
    b = to * e
    res = cg_batched(to, torch.stack([b, 0.5 * b], dim=1), rtol=1e-6)
    assert bool(res.converged.all())
    assert float((res.x[:, 1] - 0.5 * e).abs().max()) < 1e-3


def test_bad_grid_raises():
    with pytest.raises(ValueError):
        par.Halo2DPoissonOperator(15, par.make_mesh2d(2, 4, device=DEV))
    with pytest.raises(ValueError):
        par.shard_vector_2d(np.ones(10), par.make_mesh2d(2, 4, device=DEV))
