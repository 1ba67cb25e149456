"""The kernels' entry tables on the CPU: which (storage, vector) pairs the
four CUDA kernels take, and the plain products those pairs must equal.

An f32 or bf16 operator meets an f64 vector whenever a solve promotes
(``solvers/common.py::promote_rhs``: an f64 Jacobi preconditioner lifts b
to f64).  The plain versions promote with ``.to(float64)``; widening f32 or
bf16 to f64 is exact, so the kernels' ``*_f32f64`` and ``*_bf16f64``
entries compute in f64 and must equal the plain product of the widened
data bit for bit (held on the card by ``tests/test_torch_spmm_card.py``
and ``tests/test_torch_bell_card.py``).  Pairs outside the table raise.
"""

import os
import re

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.sparse import bell as B
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import sell as S

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")
f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
TAKEN = [(f32, f32, f32), (bf16, f32, f32), (f64, f64, f64),
         (f32, f64, f64), (bf16, f64, f64)]
REFUSED = [(bf16, bf16), (torch.float16, torch.float16),
           (f32, torch.complex64), (f64, torch.complex128),
           (torch.float16, f32)]


def _entries(source):
    with open(os.path.join(CSRC, source + ".cu")) as f:
        text = f.read()
    return set(re.findall(r"\b((?:dia|sell)_sp(?:mv|mm)_\w+)\(", text)) | \
        set(re.findall(r"ENTRY\((\w+),", text))


@pytest.mark.parametrize("storage,vector,compute", TAKEN)
def test_tables_take_the_pair(storage, vector, compute):
    data = torch.zeros((3, 8), dtype=storage)
    x = torch.zeros(8, dtype=vector)
    assert K._compute_dtype(data, x) == compute
    for table, source in ((K._ENTRY, "dia_spmv"), (K._MM_ENTRY, "dia_spmm"),
                          (S._ENTRY, "sell_spmv"),
                          (S._MM_ENTRY, "sell_spmm")):
        name = table[(storage, compute)]
        assert name in _entries(source), (name, source)


def test_mixed_entries_are_named_for_their_pair():
    assert K._ENTRY[(f32, f64)] == "dia_spmv_f32f64"
    assert K._MM_ENTRY[(bf16, f64)] == "dia_spmm_bf16f64"
    assert S._ENTRY[(f32, f64)] == "sell_spmv_f32f64"
    assert S._MM_ENTRY[(bf16, f64)] == "sell_spmm_bf16f64"
    assert len(K._ENTRY) == len(S._ENTRY) == 5


@pytest.mark.parametrize("storage,vector", REFUSED)
def test_tables_refuse_the_rest(storage, vector):
    data = torch.zeros((3, 8), dtype=storage)
    x = torch.zeros(8, dtype=vector)
    with pytest.raises(TypeError, match="DIA kernels take"):
        K._compute_dtype(data, x)
    card = S.SELL(vals=torch.zeros(32, dtype=storage),
                  cols=torch.zeros(32, dtype=torch.int32),
                  slice_ptr=torch.zeros(2, dtype=torch.int64),
                  row_len=torch.ones(32, dtype=torch.int32),
                  row_idx=torch.arange(32, dtype=torch.int32), rows_out=32,
                  n=8)
    for xx in (x, x[:, None].repeat(1, 3)):
        with pytest.raises(TypeError, match="SELL kernels take"):
            S._launch(card, xx)


@pytest.mark.parametrize("storage", [f32, bf16])
def test_mixed_plain_products_equal_the_widened_data(storage):
    """What the mixed entries must reproduce: on CPU tensors the wrappers
    run their plain versions, which promote to f64; the product equals the
    f64 product of the widened data, bit for bit, and so does each block
    column."""
    rng = np.random.default_rng(0)
    vals, rows, cols, shape = poisson3d_coo(8)
    vals = vals * rng.uniform(0.5, 1.5, len(vals))
    dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                           device=None), device="cpu")
    data = dia.data.to(storage)
    x = torch.from_numpy(rng.standard_normal(shape[0]))
    X = torch.from_numpy(rng.standard_normal((shape[0], 3)))
    y = K.dia_matvec(data, dia.offsets, x)
    assert y.dtype == f64
    assert torch.equal(y, K.dia_matvec_plain(data.double(), dia.offsets, x))
    Y = K.dia_matmat(data, dia.offsets, X)
    assert torch.equal(Y, K.dia_matmat_plain(data.double(), dia.offsets, X))
    assert torch.equal(Y[:, 1], K.dia_matvec(data, dia.offsets,
                                             X[:, 1].contiguous()))
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                          device=None), spill_cost=None,
                        window=1, device="cpu")
    b = B.bell_with_values_dtype(b, storage)
    card = S.sell_from_levels((b,), shape[0])
    wide = card._replace(vals=card.vals.double())
    y = S.sell_matvec(card, x)
    assert y.dtype == f64 and torch.equal(y, S.sell_matvec_plain(wide, x))
    Y = S.sell_matmat(card, X)
    assert torch.equal(Y, S.sell_matmat_plain(wide, X))
    assert torch.equal(Y[:, 2], S.sell_matvec(card, X[:, 2].contiguous()))
