"""``cg_batched``'s fused vector work (``solvers/block_cg.py``,
``csrc/block_cg.cu``).

On the CPU: the dispatch rule (CPU, complex and ``RankShard`` blocks and
``replace_every`` take the torch path, counted as ``cg_batched.plain``),
and the kernels' plan and summation order, written out in NumPy.  Marked
``cuda`` (skipped without a card, since the kernels have no CPU mode): the
fused loop through the kernels on the card against the torch path on CPU
copies of the same inputs.  The file imports neither JAX nor the JAX
package, so the card's tests run on a machine without them, from the
repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_block_cg.py

Tolerances.  The two sides add each column's terms in another order (the
kernels in float64 over a fixed tree, torch's CPU sums in the block's
dtype) and round ``r - alpha * ap`` once (FMA) where torch rounds twice,
so their iterates part at the rounding of the block's dtype and drift
apart with the iterations, as two CG runs do.  On the small Poisson
system (well conditioned, ~50 iterations) that stays far below the stop
tests' margins: the counts are equal in float64 and within 1 in float32,
and X and the final residuals agree to ``TOL`` (about 10x the largest
difference seen).  On 1138_bus (condition ~1e6, ~700-1100 iterations)
CG's residual is not monotone and creeps along plateaus, so rounding
decides the step at which it crosses the threshold: the torch path and
the same loop with its sums in float64 part by up to 5.5% of a column's
count in float64 and 3.7% in float32 on the CPU.  There each column's
count is held within ``BUS_ITERS`` of the torch path's, unless the side
that ran on had come within ``BUS_NEAR`` of the threshold where the other
stopped.  That near miss is real: with the Jacobi M in float32, column 3
(scaled by 2^-18, so the absolute tolerance 1e-8 stops it) reaches
1.0015e-8 at iteration 477 on the torch path and then rises again until
752; the kernels' rounding puts it under 1e-8 at 477, with a true residual
as small as the torch path's (7.8e-7).  Each answer's true residual is
held within ``BUS_TRUE`` times the torch path's.  The stop codes,
convergence and curvature verdicts are equal throughout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch import _build
from pykrylov_tpu_torch.gallery import poisson3d_coo, tiled_general_coo
from pykrylov_tpu_torch.ops.base import DiagonalOperator
from pykrylov_tpu_torch.solvers import batched as BT
from pykrylov_tpu_torch.solvers import block_cg as BC
from pykrylov_tpu_torch.solvers.common import threshold_of
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.utils import observe
from pykrylov_tpu_torch.utils.ranks import RankShard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NP = {torch.float32: np.float32, torch.float64: np.float64}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# the Poisson cases: dtype -> (iterations a column's count may differ by,
# X over its column's largest |x|, the final residuals over the first ones)
TOL = {torch.float64: (0, 1e-12, 1e-14), torch.float32: (1, 1e-5, 1e-9)}
# the 1138_bus cases: the share of a column's count it may differ by, the
# share above its threshold that the torch path's residual may stand at
# where the fused path stopped a column further apart (a near miss that
# rounding decides), and the true residual over the torch path's answer's
BUS_ITERS = 0.1
BUS_NEAR = 0.01
BUS_TRUE = 10.0

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (block CG's kernels have no CPU "
                    "mode)")
    return "cuda"


# --------------------------------------------------------------------------
# systems and blocks
# --------------------------------------------------------------------------

def _poisson(dtype, dev, n=16, shift=0.0):
    vals, rows, cols, shape = poisson3d_coo(n, dtype=NP[dtype])
    vals = vals.copy()
    vals[rows == cols] -= shift
    return operator_from_coo(vals, rows, cols, shape, symmetric=True,
                             fmt="cuda-dia", device=dev)


def _bus(dtype, dev):
    return operator_from_coo(*tiled_general_coo("1138bus", tiles=2,
                                                coupling=0,
                                                dtype=NP[dtype]),
                             symmetric=True, fmt="bell", device=dev)


def _jacobi(A_coo, dtype, dev):
    vals, rows, cols, shape = A_coo
    d = np.zeros(shape[0])
    np.add.at(d, rows[rows == cols], vals[rows == cols])
    return DiagonalOperator(torch.tensor(1.0 / d, dtype=dtype), device=dev)


def _block(n, k, dtype, A=None, seed=3):
    """An (n, k) block whose columns stop at different iterations: random
    columns (with ``A``, their products by A) scaled by 1, 2^-6, 2^-12,
    2^-18 in turn (the smaller ones stop on the absolute tolerance),
    column 1 zero from K = 3 and column K - 2 NaN in its first row from
    K = 8."""
    rng = np.random.default_rng(seed)
    B = torch.tensor(rng.standard_normal((n, k))
                     * 2.0 ** (-6.0 * (np.arange(k) % 4)), dtype=dtype)
    if A is not None:
        B = A @ B
    if k >= 3:
        B[:, 1] = 0.0
    if k >= 8:
        B[0, k - 2] = float("nan")
    return B


def _eigvec(n, a, b, c):
    """The 3-D Poisson matrix's eigenvector of wave numbers (a, b, c) and
    its eigenvalue."""
    t = np.arange(1, n + 1) * np.pi / (n + 1)
    v = np.einsum("i,j,k->ijk", np.sin(a * t), np.sin(b * t),
                  np.sin(c * t)).ravel()
    lam = sum(2.0 - 2.0 * np.cos(w * np.pi / (n + 1)) for w in (a, b, c))
    return v / np.linalg.norm(v), lam


def _indefinite(dtype, dev, n=8):
    """The Poisson matrix shifted between its two least eigenvalues, and a
    block of [v_min, v_2, a random column]: v_min meets negative curvature
    at once (istop 2 under ``check_curvature``), v_2 converges in a step."""
    v1, l1 = _eigvec(n, 1, 1, 1)
    v2, l2 = _eigvec(n, 2, 1, 1)
    A = _poisson(dtype, dev, n, shift=0.5 * (l1 + l2))
    rng = np.random.default_rng(7)
    B = np.stack([v1, v2, rng.standard_normal(n ** 3)], axis=1)
    return A, torch.tensor(B, dtype=dtype)


def _top(t):
    """The largest entry of ``t``, 0 for none."""
    return float(t.max()) if t.numel() else 0.0


def _same(res, ref, dtype, system, A, B):
    """The fused solve ``res`` against the torch path's ``ref`` of ``A X =
    B`` (on the CPU): stop codes, convergence and curvature verdicts equal,
    the counts, X and the residuals within ``TOL`` (Poisson) or the counts
    within ``BUS_ITERS`` (or a near miss, ``BUS_NEAR``, on the residual
    histories both sides stored) and the true residuals within
    ``BUS_TRUE`` (1138_bus).  Returns the largest differences of the
    counts, X and the residuals (the true residuals' ratio on
    1138_bus)."""
    cpu = {k: v.cpu() for k, v in res.info.items()}
    assert torch.equal(res.istop.cpu(), ref.istop)
    assert torch.equal(res.converged.cpu(), ref.converged)
    assert torch.equal(cpu["definite"], ref.info["definite"])
    counts = ref.info["n_iter_columns"]
    d = (cpu["n_iter_columns"] - counts).abs()
    x, xr = res.x.cpu(), ref.x
    ok = torch.isfinite(xr).all(0)
    assert torch.equal(torch.isfinite(x).all(0), ok)
    if system == "bus":
        thresh = threshold_of(ref.resid_norm0, 1e-6, 1e-8)
        for j, (c, cr) in enumerate(zip(cpu["n_iter_columns"].tolist(),
                                        counts.tolist())):
            if abs(c - cr) <= BUS_ITERS * cr:
                continue
            # the side that ran on, at the iteration the other stopped
            h = (ref.resid_history if c < cr
                 else res.resid_history.cpu())[min(c, cr), j]
            print("[block_cg] column %d: %d iterations against %d, the "
                  "residual of the side that ran on %.4e at the other's "
                  "stop, threshold %.4e" % (j, c, cr, h, thresh[j]))
            assert h <= (1 + BUS_NEAR) * thresh[j], (
                j, cpu["n_iter_columns"], counts)
        fin = torch.isfinite(B).all(0)
        b = B.double().norm(dim=0).clamp(min=1e-300)
        true, true_ref = ((B - A @ X).double().norm(dim=0) / b
                          for X in (x, xr))
        ratio = _top((true / true_ref.clamp(min=1e-300))[fin & (b > 1e-300)])
        assert bool((true <= BUS_TRUE * true_ref + 1e-12)[fin].all()), (
            true, true_ref)
        return _top(d), float("nan"), ratio
    iters, x_tol, r_tol = TOL[dtype]
    assert _top(d) <= iters, (cpu["n_iter_columns"], counts)
    assert abs(int(res.n_iter) - int(ref.n_iter)) <= _top(d)
    scale = xr.double().abs().amax(0).clamp(min=1e-300)
    err = (x.double() - xr.double()).abs().amax(0) / scale
    assert _top(err[ok]) <= x_tol, err
    r, rr = res.resid_norm.cpu().double(), ref.resid_norm.double()
    r0 = ref.resid_norm0.double().clamp(min=1e-300)
    fin = torch.isfinite(rr)
    assert torch.equal(torch.isfinite(r), fin)
    rerr = _top(((r - rr).abs() / r0)[fin])
    assert rerr <= r_tol, rerr
    return _top(d), _top(err[ok]), rerr


def _counted(fn):
    """``fn()`` and the counters' moves over it."""
    with observe.recording() as rec:
        out = fn()
    return out, rec.counts


# --------------------------------------------------------------------------
# CPU: the dispatch rule
# --------------------------------------------------------------------------

def test_block_cg_is_a_registered_source():
    assert "block_cg" in _build.SOURCES
    assert os.path.isfile(_build.SOURCES["block_cg"])


def test_module_imports_without_nvcc(tmp_path):
    # importing the module (and the solvers) builds and loads nothing
    code = ("import pykrylov_tpu_torch.solvers.block_cg as BC\n"
            "from pykrylov_tpu_torch import _build\n"
            "assert _build.load.cache_info().currsize == 0\n"
            "assert BC.BLOCK_CG_LAUNCHES == 0\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_takes_plain_cuda_float_blocks_only(monkeypatch):
    # every tensor reads as a CUDA tensor here: the rule's type and dtype
    # tests decide
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    block = torch.zeros(4, 2)
    assert BC.takes(block) and BC.takes(block.double())
    assert not BC.takes(block.as_subclass(RankShard))
    for dtype in (torch.complex64, torch.complex128, torch.bfloat16,
                  torch.float16):
        assert not BC.takes(block.to(dtype)), dtype


def test_takes_nothing_on_the_cpu():
    assert not BC.takes(torch.zeros(4, 2))
    assert not BC.takes(torch.zeros(4, 2, dtype=torch.float64))


@pytest.mark.parametrize("case", ["f32", "f64", "complex", "replace_every"])
def test_cpu_blocks_take_the_torch_path(case):
    dtype = torch.complex128 if case == "complex" else DTYPES.get(
        case, torch.float32)
    A = _poisson(torch.float64 if case == "complex" else dtype, "cpu", n=6)
    B = torch.tensor(np.random.default_rng(1).standard_normal((216, 3)),
                     dtype=dtype)
    if case == "complex":
        B = B * (1 + 0.5j)
    opts = {"replace_every": 10} if case == "replace_every" else {}
    before = BC.BLOCK_CG_LAUNCHES
    res, counts = _counted(lambda: BT.cg_batched(A, B, **opts))
    assert counts.get("cg_batched.plain") == int(res.n_iter) > 0
    assert "cg_batched.fused" not in counts
    assert BC.BLOCK_CG_LAUNCHES == before
    assert bool(res.converged.all())


# --------------------------------------------------------------------------
# CPU: the plan and the kernels' summation order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,itemsize,aligned", [
    (13824000, 8, 4, True),     # the Poisson cell: V = 4
    (13824000, 8, 8, True),     # its float64 twin: V = 2
    (1000, 8, 4, False),        # a block off 16 bytes: V = 1
    (999, 3, 4, True),          # K = 3 in float32, a 12-byte row: V = 1
    (1000, 3, 8, True),         # V = 2 does not divide K: V = 1
    (1000, 12, 4, True),        # K does not divide THREADS * V: the grid
                                # rounds up to a multiple of 3
    (40, 300, 4, True),         # K past THREADS: a multiple of 75
    (7, 5, 8, True),            # fewer vectors than one block's threads
    (1, 1, 4, True)])
def test_plan_rules(n, k, itemsize, aligned):
    vw = 16 // itemsize
    v, blocks = BC.block_cg_plan(n, k, itemsize, aligned, sms=132)
    assert v == (vw if aligned and k % vw == 0 else 1)
    # the grid's stride is a multiple of K, so a thread keeps its columns
    assert blocks >= 1 and (blocks * BC.THREADS * v) % k == 0
    step = k // np.gcd(k, BC.THREADS * v)
    cap = max(1, min(BC.BLOCKS_PER_SM * 132,
                     -(-(n * k // v) // BC.THREADS)))
    assert cap <= blocks < cap + step


def test_plan_of_an_empty_block():
    # no columns or no rows: one block, no division by K
    for n, k in ((0, 0), (10, 0), (0, 8)):
        assert BC.block_cg_plan(n, k, 4, True, sms=132).blocks >= 1


def _fold(s, length, unit):
    """``fold`` of csrc/block_cg.cu, one step at a time."""
    if unit >= length:
        return
    h = unit
    while 2 * h < length:
        h *= 2
    while h >= unit:
        i = np.arange(h)
        i = i[i + h < length]
        s[i] += s[i + h]
        length = h
        h //= 2


def _kernel_sums(terms, k, v, blocks):
    """The column sums of an (n, k) block of float64 ``terms`` as the
    kernels take them: each thread's lanes over the grid-stride loop, each
    block's fold and partials, and the last block's groups and fold."""
    threads = BC.THREADS
    flat = terms.reshape(-1)
    nvec = flat.size // v
    G = blocks * threads
    i = np.arange(nvec)
    g = i % G
    # the stride keeps each lane's column: the thread's first one's
    for j in range(v):
        assert np.array_equal((i * v + j) % k, (g * v + j) % k)
    acc = np.zeros((G, v))
    np.add.at(acc, g, flat.reshape(nvec, v))
    L = threads * v
    partial = np.zeros((blocks, k))
    for b in range(blocks):
        s = acc[b * threads:(b + 1) * threads].reshape(-1).copy()
        _fold(s, L, k)
        base = (b * L) % k
        held = min(k, L)
        for c in range(k):
            f = (c - base + k) % k
            partial[b, c] = s[f] if f < held else 0.0
    out = np.zeros(k)
    if k <= threads:
        groups = threads // k
        s = np.zeros(threads)
        for t in range(groups * k):
            s[t] = partial[t // k::groups, t % k].sum()
        _fold(s, groups * k, k)
        out[:] = s[:k]
    else:
        out[:] = partial.sum(0)
    return out


@pytest.mark.parametrize("n,k,itemsize", [(1000, 1, 4), (999, 3, 4),
                                          (1000, 8, 4), (333, 16, 8),
                                          (50, 6, 8), (40, 300, 4),
                                          (7, 5, 8), (4096, 64, 4)])
def test_kernel_summation_order_sums_each_column(n, k, itemsize):
    rng = np.random.default_rng(k)
    # integers: every order of the adds gives the same float64 sum
    terms = rng.integers(-1000, 1000, size=(n, k)).astype(np.float64)
    for aligned in (True, False):
        v, blocks = BC.block_cg_plan(n, k, itemsize, aligned, sms=2)
        got = _kernel_sums(terms, k, v, blocks)
        assert np.array_equal(got, terms.sum(0)), (v, blocks)


# --------------------------------------------------------------------------
# the card: the kernels against the torch path on the CPU
# --------------------------------------------------------------------------

def _case(name, dtype, dev, k, n=8):
    """(operator, block, options, system) of a named case on ``dev``, the
    Poisson cases on n^3 rows; the block on the CPU."""
    if name == "indefinite":
        A, B = _indefinite(dtype, dev)
        return A, B, {"check_curvature": True}, "poisson"
    if name in ("bus", "jacobi"):
        opts = {"store_history": True}
        if name == "jacobi":
            opts["M"] = _jacobi(tiled_general_coo(
                "1138bus", tiles=2, coupling=0, dtype=NP[dtype]), dtype, dev)
        return (_bus(dtype, dev), _block(2276, k, dtype, _bus(dtype, "cpu")),
                opts, "bus")
    A = _poisson(dtype, dev, n=n)
    B = _block(A.shape[0], k, dtype)
    if name == "history":
        return A, B, {"store_history": True}, "poisson"
    if name == "x0":
        return A, B, {"x0": 0.5 * B.nan_to_num()}, "poisson"
    return A, B, {}, "poisson"


def _compare_history(res, ref, dtype):
    h, hr = res.resid_history.cpu().double(), ref.resid_history.double()
    rows = int(ref.n_iter) + 1
    assert torch.equal(torch.isnan(h[:rows]), torch.isnan(hr[:rows])) \
        or dtype == torch.float32
    # each row's residuals against the torch path's, at X's tolerance
    both = ~torch.isnan(h[:rows]) & ~torch.isnan(hr[:rows])
    rel = (h[:rows] - hr[:rows]).abs() / hr[:rows].abs().clamp(min=1e-300)
    assert _top(rel[both]) <= TOL[dtype][1]


CARD_CASES = [("poisson", k) for k in (1, 3, 8, 16)] \
    + [("bus", k) for k in (1, 3, 8, 16)] \
    + [("history", 8), ("x0", 8), ("jacobi", 8), ("jacobi", 3),
       ("indefinite", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name,k", CARD_CASES)
def test_fused_cg_batched_on_the_card_matches_the_torch_path(card, name, k,
                                                             dt):
    dtype = DTYPES[dt]
    if name == "indefinite" and dtype == torch.float32:
        pytest.skip("the indefinite case is held in float64")
    case = "plain" if name == "poisson" else name
    Ac, Bc, opts_c, system = _case(case, dtype, "cpu", k, n=16)
    Ag, _, opts_g, _ = _case(case, dtype, card, k, n=16)
    Bg = Bc.to(card)
    B0 = Bg.clone()
    if "x0" in opts_c:
        opts_g["x0"] = opts_c["x0"].to(card)
        x00 = opts_g["x0"].clone()
    ref = BT.cg_batched(Ac, Bc, **opts_c)
    before = BC.BLOCK_CG_LAUNCHES
    res, counts = _counted(lambda: BT.cg_batched(Ag, Bg, **opts_g))
    torch.cuda.synchronize()
    n_iter = int(res.n_iter)
    assert counts.get("cg_batched.fused") == n_iter > 0
    assert "cg_batched.plain" not in counts
    per_iter = 4 if "M" in opts_g else 3
    assert BC.BLOCK_CG_LAUNCHES - before == per_iter * n_iter
    # the caller's B, bit for bit
    assert torch.equal(Bg.nan_to_num(), B0.nan_to_num())
    assert torch.equal(torch.isnan(Bg), torch.isnan(B0))
    if "x0" in opts_g:
        assert torch.equal(opts_g["x0"], x00)
    d, xerr, rerr = _same(res, ref, dtype, system, Ac, Bc)
    print("[block_cg] %s K=%d %s: %d iterations, counts differ by %d, x "
          "%.3e, residuals %.3e (1138_bus: the true residuals' ratio)"
          % (name, k, dt, n_iter, d, xerr, rerr))
    if system == "poisson" and opts_c.get("store_history"):
        _compare_history(res, ref, dtype)
    if name == "indefinite":
        assert res.istop.tolist()[:2] == [2, 0]
    if k >= 8 and name in ("poisson", "bus"):
        iters = res.info["n_iter_columns"].tolist()
        assert len(set(iters)) > 2, iters


@pytest.mark.cuda
def test_fused_cg_batched_takes_a_strided_block_on_the_card(card):
    # a transposed view: the solve's own blocks are contiguous copies
    Ac, Ag = _poisson(torch.float64, "cpu", n=6), _poisson(torch.float64,
                                                           card, n=6)
    Bt = torch.tensor(np.random.default_rng(2).standard_normal((3, 216)))
    Bg = Bt.to(card).T
    assert not Bg.is_contiguous()
    ref = BT.cg_batched(Ac, Bt.T)
    res, counts = _counted(lambda: BT.cg_batched(Ag, Bg))
    assert counts.get("cg_batched.fused") == int(res.n_iter) > 0
    _same(res, ref, torch.float64, "poisson", Ac, Bt.T)
    assert res.x.is_contiguous() and torch.equal(Bg.T.cpu(), Bt)


@pytest.mark.cuda
def test_rank_shards_on_the_card_take_the_torch_path(card):
    block = torch.zeros(4, 2, device=card)
    assert BC.takes(block)
    assert not BC.takes(block.as_subclass(RankShard))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_solves_repeat_bit_for_bit(card, dt):
    # fixed summation order: two solves of one block give the same bits
    dtype = DTYPES[dt]
    A = _poisson(dtype, card)
    B = _block(A.shape[0], 8, dtype).to(card)
    a = BT.cg_batched(A, B)
    b = BT.cg_batched(A, B)
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.info["n_iter_columns"], b.info["n_iter_columns"])
    assert torch.equal(a.resid_norm.nan_to_num(), b.resid_norm.nan_to_num())
