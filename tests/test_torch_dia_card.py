"""The DIA SpMV kernel against its plain version on an NVIDIA GPU.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_dia_card.py

(``tests/conftest.py`` configures JAX, hence ``--noconftest``.)

The kernel rounds every product and sum on its own in ascending container
order, as ``kernels.dia_matvec_plain`` does, so the two agree bit for bit
at all five entries (f32, bf16 storage with f32 x, f64, f32 and bf16
storage with f64 x), on the row-group path (R rows a thread, 16-byte
loads) and on the scalar path (R = 1) alike.  Every slot whose column lies
outside [0, n) holds NaN or inf here: the kernel must skip those terms, not
multiply them by zero.
"""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K

ENTRIES = {
    "f32": (torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.float32),
    "f64": (torch.float64, torch.float64),
    "f32f64": (torch.float32, torch.float64),
    "bf16f64": (torch.bfloat16, torch.float64),
}
STENCIL = (-144, -12, -1, 0, 1, 12, 144)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SpMV kernel has no CPU mode)")
    return "cuda"


def poison(data, offsets, n):
    """NaN and inf in every slot whose column lies outside [0, n)."""
    i = torch.arange(data.shape[1], device=data.device)
    for k, off in enumerate(offsets):
        out = torch.nonzero((i + off < 0) | (i + off >= n)).flatten()
        data[k, out[0::2]] = float("nan")
        data[k, out[1::2]] = float("inf")
    return data


def case(card, entry, m, n, offsets, seed):
    storage, xdt = ENTRIES[entry]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m))).to(
        card, storage)
    x = torch.from_numpy(rng.standard_normal(n)).to(card, xdt)
    return poison(data, offsets, n), x


def hold(data, offsets, x, r=None):
    """One launch of the SpMV kernel, bit for bit against the plain
    version on the same tensors; ``r``, where given, is the rows a thread
    the plan must take."""
    plan = K.dia_matvec_plan(data, offsets, x)
    if r is not None:
        assert plan.r == r
    before = K.DIA_LAUNCHES
    y = K.dia_matvec(data, offsets, x)
    torch.cuda.synchronize()
    assert K.DIA_LAUNCHES == before + 1
    ref = K.dia_matvec_plain(data, offsets, x)
    assert y.shape == ref.shape == (data.shape[1],)
    assert y.dtype == ref.dtype == torch.promote_types(data.dtype, x.dtype)
    assert torch.isfinite(ref).all()
    assert torch.equal(y, ref)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("m", [1, 3, 37, 20011, 100003])
def test_odd_sizes_take_the_scalar_path(card, entry, m):
    offsets = (-max(1, m // 3), -130, -1, 0, 3, 129)
    data, x = case(card, entry, m, m, offsets, m)
    hold(data, offsets, x, r=1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_poisson64_takes_row_groups(card, entry):
    storage, xdt = ENTRIES[entry]
    vals, rows, cols, shape = poisson3d_coo(64, dtype=np.float64)
    rng = np.random.default_rng(64)
    vals = vals * (1.0 + 0.3 * rng.standard_normal(len(vals)))
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    dia = F.dia_from_coo(coo, device=card)
    data = poison(dia.data.to(storage), dia.offsets, shape[1])
    assert data.shape == (7, 262144)
    x = torch.from_numpy(rng.standard_normal(shape[1])).to(card, xdt)
    hold(data, dia.offsets, x, r=16 // data.element_size())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("name,m,n,offsets", [
    ("unsorted with duplicates", 20016, 20016,
     (5, -3, 0, 5, -3, 144, -144)),
    ("past m", 20016, 20016, (-30000, -3, 0, 2, 25000)),
    ("every offset past m", 1000, 1000, (-1200, 1001, 5000)),
    ("64 diagonals", 40000, 40000, tuple(range(-40, 24))),
    ("64 far diagonals", 40000, 40000,
     tuple(range(-31 * 613, 33 * 613, 613))),
    ("rectangular, wide", 20016, 21000, (-700, -1, 0, 2, 990)),
    ("rectangular, tall", 20016, 15000, (-700, -1, 0, 2, 990)),
    ("rectangular, n < R", 64, 3, (-1, 0, 1, 2)),
    ("rectangular, R does not divide n", 20016, 20013,
     (-700, -1, 0, 2, 990)),
    ("halo shard, L + 2w rows", 3456 + 2 * 144, 3456 + 2 * 144, STENCIL),
    ("no diagonals", 64, 64, ()),
    # past 64 the offsets travel as int32, those outside (-m, n) clamped
    ("65 diagonals", 40000, 40000, tuple(range(-40, 25))),
    ("125 B-spline diagonals", 13824, 13824,
     tuple(a * 576 + b * 24 + c for a in range(-2, 3) for b in range(-2, 3)
           for c in range(-2, 3))),
    ("125 unsorted, repeated, past m", 20016, 20016,
     tuple(range(600, -600, -10)) + (5, -3, 5, -30000, 1 << 40)),
    ("4096 diagonals", 20016, 20016, tuple(range(-2048, 2048))),
    ("4096 diagonals, rectangular", 9000, 12000,
     tuple(range(-1000, 3096))),
])
def test_container_cases(card, entry, name, m, n, offsets):
    data, x = case(card, entry, m, n, offsets, m + n + len(offsets))
    hold(data, offsets, x, r=16 // data.element_size())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_misaligned_views_take_the_scalar_path(card, entry):
    storage, xdt = ENTRIES[entry]
    m = 20016
    data, x = case(card, entry, m, m + 1, STENCIL, 9)
    hold(data, STENCIL, x[:m], r=16 // data.element_size())
    # x handed in as the contiguous view x[1:]
    view = x[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    hold(data, STENCIL, view, r=1)
    # data whose container rows start misaligned: a shifted buffer, and
    # an odd m, which no R > 1 divides
    buf = torch.zeros(len(STENCIL) * m + 8, dtype=storage, device=card)
    shifted = buf[1:1 + len(STENCIL) * m].view(len(STENCIL), m)
    shifted.copy_(data)
    hold(shifted, STENCIL, x[:m], r=1)
    odd = poison(data[:, :m - 1].contiguous(), STENCIL, m - 1)
    hold(odd, STENCIL, x[:m - 1], r=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose(card, dtype):
    rng = np.random.default_rng(5)
    m, offsets = 100000, (-70000, -3, 0, 2, 5, 131)
    data = torch.from_numpy(rng.standard_normal((len(offsets), m)))
    for k, off in enumerate(offsets):
        i = torch.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    dia = F.DIA(data.to(card, dtype), offsets, (m, m))
    t = K.dia_transpose(dia)
    x = torch.from_numpy(rng.standard_normal(m)).to(card, dtype)
    hold(dia.data, dia.offsets, x, r=16 // dtype.itemsize)
    yt = hold(t.data, t.offsets, x, r=16 // dtype.itemsize)
    # the transpose's product is A^T x up to the order of the sums
    ref = F.dia_rmatvec(dia, x)
    assert ((yt - ref).abs().max() / ref.abs().max()).item() <= (
        1e-12 if dtype == torch.float64 else 1e-6)
    if dtype == torch.float32:
        hold(t.data, t.offsets, x.double(), r=4)


@pytest.mark.cuda
def test_inf_in_x_reaches_only_its_rows(card):
    # an inf in x inside the matrix reaches the rows that read it, as in
    # the plain version; a NaN slot outside the matrix reaches none
    m = 1728
    data, x = case(card, "f32", m, m, STENCIL, 11)
    x[700] = float("inf")
    y = K.dia_matvec(data, STENCIL, x)
    ref = K.dia_matvec_plain(data, STENCIL, x)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(y), torch.isfinite(ref))
    assert (~torch.isfinite(y)).sum().item() <= len(STENCIL)
    fin = torch.isfinite(ref)
    assert torch.equal(y[fin], ref[fin])


@pytest.mark.cuda
def test_a_refused_plan_raises(card, monkeypatch):
    # the launcher refuses an interior that would read x out of range; the
    # wrapper raises and does not fall back to the plain version
    data, x = case(card, "f32", 1024, 1024, STENCIL, 13)

    def bad(offsets, m, n, itemsize, aligned):
        return K.DiaMVPlan(4, 0, m)

    monkeypatch.setattr(K, "dia_mv_plan", bad)
    before = K.DIA_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.dia_matvec(data, STENCIL, x)
    assert K.DIA_LAUNCHES == before
