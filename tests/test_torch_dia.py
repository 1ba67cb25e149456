"""The DIA kernel's module on the CPU against the JAX package.

On CPU tensors ``kernels.dia_matvec`` runs the plain torch version; it is
held against the Pallas kernel in interpret mode (``dia_matvec_pallas``)
and the XLA product (``formats.dia_matvec``) on the same stored diagonals,
carried across with ``convert.from_numpy``.  The CUDA kernel itself runs
only on the card (``chip_smoke.py``).

Tolerances: 1e-12 relative (max norm) in float64, where only the
summation order differs; 1e-6 for bf16 storage, where both sides multiply
the same bf16 values promoted to float32.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.gallery import poisson1d_coo, poisson3d_coo
from pykrylov_tpu.sparse import formats as JF
from pykrylov_tpu.sparse.kernels import (dia_matvec_pallas, ensure_dia_padded,
                                         pallas_dia_operator)
from pykrylov_tpu.sparse.kernels import dia_transpose as jax_dia_transpose

from pykrylov_tpu_torch import convert
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K

DEV = "cpu"  # the port's entry points default to the card


def rel(port, ref):
    ref = np.asarray(ref)
    return np.abs(port.numpy() - ref).max() / np.abs(ref).max()


def jax_dia(coo_args):
    vals, rows, cols, shape = coo_args
    return JF.dia_from_coo(JF.coo_from_arrays(vals, rows, cols, shape))


def pallas(dia, x, block):
    """The Pallas kernel (interpret mode) on the padded container."""
    dia_p, _ = ensure_dia_padded(dia, block=block)
    xp = np.zeros(dia_p.shape[0], dtype=x.dtype)
    xp[:x.shape[0]] = x
    y = dia_matvec_pallas(dia_p, jnp.asarray(xp), block=block,
                          interpret=True)
    return np.asarray(y)[:dia.shape[0]]


def banded(rng, m, offsets):
    data = rng.standard_normal((len(offsets), m))
    for k, off in enumerate(offsets):
        i = np.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    return JF.DIA(jnp.asarray(data), offsets, (m, m))


@pytest.mark.parametrize("coo_args,block", [
    (poisson1d_coo(1000), 256),       # offsets (-1, 0, 1)
    (poisson3d_coo(9), 384),          # offsets ±1, ±9, ±81
    (poisson3d_coo(12), 1024),        # block > bandwidth comfortably
], ids=["p1d-1000", "p3d-9", "p3d-12"])
def test_plain_and_operator_match_pallas_and_xla(coo_args, block, rng):
    jdia = jax_dia(coo_args)
    dia = convert.from_numpy(jdia, device=DEV)
    x = rng.standard_normal(dia.shape[1])
    xt = torch.from_numpy(x)
    y_pallas = pallas(jdia, x, block)
    y_xla = JF.dia_matvec(jdia, jnp.asarray(x))
    y_plain = K.dia_matvec_plain(dia.data, dia.offsets, xt)
    y_op = K.cuda_dia_operator(dia, symmetric=True) * xt
    for y in (y_plain, y_op):
        assert y.dtype == torch.float64 and y.shape == (dia.shape[0],)
        assert rel(y, y_pallas) <= 1e-12
        assert rel(y, y_xla) <= 1e-12


def test_unsymmetric_banded_and_transpose(rng):
    m, offsets = 300, (-3, 0, 2, 5)
    jdia = banded(rng, m, offsets)
    dia = convert.from_numpy(jdia, device=DEV)
    # the host transposes agree exactly
    jt, t = jax_dia_transpose(jdia), K.dia_transpose(dia)
    assert t.offsets == jt.offsets
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(jt.data))
    x = rng.standard_normal(m)
    op = K.cuda_dia_operator(dia, symmetric=False)
    jop = pallas_dia_operator(jdia, symmetric=False, block=384,
                              interpret=True)
    xp = np.zeros(jop.nargin)
    xp[:m] = x
    y_ref = np.asarray(jop.T * jnp.asarray(xp))[:m]
    assert rel(op.T * torch.from_numpy(x), y_ref) <= 1e-12
    assert rel(F.dia_rmatvec(dia, torch.from_numpy(x)), y_ref) <= 1e-12
    assert rel(op * torch.from_numpy(x), pallas(jdia, x, 384)) <= 1e-12


def test_bf16_storage_f32_compute():
    rng = np.random.default_rng(17)
    vals, rows, cols, shape = poisson3d_coo(9)
    vals = vals * (1.0 + 0.3 * rng.standard_normal(len(vals)))
    v16 = np.asarray(vals, dtype=ml_dtypes.bfloat16)
    jdia = JF.dia_from_coo(JF.coo_from_arrays(v16, rows, cols, shape),
                           device=False)
    dia = convert.from_numpy(jdia, device=DEV)
    assert dia.data.dtype == torch.bfloat16
    x = rng.standard_normal(shape[0]).astype(np.float32)
    y = K.dia_matvec(dia.data, dia.offsets, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert rel(y, pallas(jdia, x, 384)) <= 1e-6


def test_wrapper_checks_and_counts(rng):
    dia = convert.from_numpy(jax_dia(poisson1d_coo(50)), device=DEV)
    x = torch.from_numpy(rng.standard_normal(50))
    before = K.DIA_LAUNCHES
    K.dia_matvec(dia.data, dia.offsets, x)
    assert K.DIA_LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="offsets"):
        K.dia_matvec(dia.data, dia.offsets[:2], x)
    with pytest.raises(ValueError, match="expects data"):
        K.dia_matvec(dia.data[0], dia.offsets, x)
    # neither CPU nor CUDA: no silent fallback to the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        K.dia_matvec(dia.data.to("meta"), dia.offsets, x.to("meta"))
    # past 64 diagonals the kernels take the wide path, up to
    # dia_from_coo's 4096
    wide = F.DIA(torch.ones(65, 100, dtype=torch.float64),
                 tuple(range(-32, 33)), (100, 100))
    y = K.cuda_dia_operator(wide, symmetric=True) * x.new_ones(100)
    assert torch.equal(y, F.to_dense(wide) @ x.new_ones(100))
    over = F.DIA(torch.zeros(K.MAX_DIAGS + 1, 100),
                 tuple(range(K.MAX_DIAGS + 1)), (100, 100))
    assert K.MAX_DIAGS == 4096
    with pytest.raises(ValueError, match="exceed"):
        K.cuda_dia_operator(over, symmetric=True) * torch.zeros(100)
