"""The sharded operators on the card: a mesh of shard slots that all sit
on one card, each shard's local product one kernel launch.

Every test here needs a card and nvcc (a CUDA kernel has no CPU mode) and
skips without them.  The file imports neither JAX nor the JAX package, so
it runs on a machine without them, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_card.py

Tolerances: none.  A ``HaloDiaOperator`` on the card runs the DIA
kernels over each shard's halo-extended block whatever its ``kernel``
argument says, whose rows sum the same
diagonals in the same order over the same x values as the unsharded
kernel's: products and a CG through it equal the unsharded ones bit for
bit.  A ``GatherBellOperator``'s shard rows are its SELL kernel's product
on that shard's private x, which equals the plain version bit for bit.
Launches are the mesh size times the products issued.
"""

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch import parallel as par
from pykrylov_tpu_torch import solvers as PS
from pykrylov_tpu_torch.gallery import poisson3d_coo, tiled_general_coo
from pykrylov_tpu_torch.parallel.gather import private_rows
from pykrylov_tpu_torch.sparse import formats as F
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo
from pykrylov_tpu_torch.sparse import sell as S

COUNTERS = ((K, "DIA_LAUNCHES"), (K, "DIA_MM_LAUNCHES"),
            (S, "SELL_LAUNCHES"), (S, "SELL_MM_LAUNCHES"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SELL and DIA kernels have no "
                    "CPU mode)")
    return "cuda"


def _counted(fn):
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, name) for mod, name in COUNTERS}


def _rhs(n, dev, k=None, dtype=torch.float32, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n,) if k is None else (n, k)
    return torch.randn(shape, device=dev, dtype=dtype, generator=g)


@pytest.mark.cuda
def test_mesh_slots_on_the_card(card):
    mesh = par.make_mesh(4)
    cards = torch.cuda.device_count()
    assert mesh.slots == tuple(torch.device("cuda", k % cards)
                               for k in range(4))
    assert par.device_mesh_info(mesh)["platform"] == "gpu"
    # "cuda" and "cuda:0" name one slot
    assert par.make_mesh(2, device="cuda:0").slots[0] == \
        par.make_mesh(1, device="cuda").slots[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["auto", True, False])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_kernel_path_equals_the_unsharded_kernel(card, P, dtype,
                                                      kernel):
    # 3,456 rows a shard at P = 4: small shards launch the kernel too
    A = operator_from_coo(*poisson3d_coo(24, dtype=np.float32),
                          symmetric=True, fmt="cuda-dia", device=card)
    H = par.HaloDiaOperator(A.container, par.make_mesh(P), kernel=kernel)
    assert H.local_kernel
    m = A.shape[0]
    x = _rhs(m, card, dtype=dtype)
    X = _rhs(m, card, k=8, dtype=dtype)
    y, counts = _counted(lambda: H * x)
    assert torch.equal(y, A * x)
    assert counts["DIA_LAUNCHES"] == P and sum(counts.values()) == P
    Y, counts = _counted(lambda: H * X)
    assert torch.equal(Y, A * X)
    assert counts["DIA_MM_LAUNCHES"] == P and sum(counts.values()) == P
    res, counts = _counted(lambda: PS.cg(H, x, rtol=1e-6))
    ref = PS.cg(A, x, rtol=1e-6)
    assert torch.equal(res.x, ref.x) and int(res.n_iter) == int(ref.n_iter)
    assert counts["DIA_LAUNCHES"] == P * int(res.n_matvec)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4])
def test_gather_sell_shards_are_their_kernels(card, P):
    # three tiles: every P > 1 here cuts a tile, so the shards exchange
    vals, rows, cols, shape = tiled_general_coo("1138bus", tiles=3,
                                                coupling=0)
    G = par.GatherBellOperator(F.coo_from_arrays(vals, rows, cols, shape,
                                                 device=None),
                               par.make_mesh(P), with_transpose=True)
    assert all(c.vals.is_cuda for c in G.cards + G.cards_t)
    assert (G.comm_entries_true > 0) == (P > 1)
    x = _rhs(G.nargin, card)
    y, counts = _counted(lambda: G * x)
    assert counts["SELL_LAUNCHES"] == P and sum(counts.values()) == P
    L = G.nargout // P
    priv = private_rows(G.schedule[1], P, G.nargin // P)
    for k, c in enumerate(G.cards):
        xk = x[torch.from_numpy(priv[k]).to(card)]
        assert torch.equal(y[k * L:(k + 1) * L],
                           S.sell_matvec_plain(c, xk))
    X = _rhs(G.nargin, card, k=8)
    Y, counts = _counted(lambda: G * X)
    assert counts["SELL_MM_LAUNCHES"] == P and sum(counts.values()) == P
    for k, c in enumerate(G.cards):
        Xk = X[torch.from_numpy(priv[k]).to(card)]
        assert torch.equal(Y[k * L:(k + 1) * L],
                           S.sell_matmat_plain(c, Xk))
    u = _rhs(G.nargout, card, dtype=torch.float64)
    yt, counts = _counted(lambda: G.T * u)
    assert counts["SELL_LAUNCHES"] == P and sum(counts.values()) == P
    ref = torch.zeros(G.nargin, dtype=torch.float64, device=card)
    for k, c in enumerate(G.cards_t):
        ref.index_add_(0, torch.from_numpy(priv[k]).to(card),
                       S.sell_matvec_plain(c, u[k * L:(k + 1) * L]))
    assert torch.equal(yt, ref)
    # CG through the symmetric operator: P launches a matvec
    S_op = par.GatherBellOperator(
        F.coo_from_arrays(vals, rows, cols, shape, device=None),
        par.make_mesh(P), symmetric=True)
    b = _rhs(S_op.nargin, card)
    res, counts = _counted(lambda: PS.cg(S_op, b, rtol=1e-5, maxiter=300))
    assert counts["SELL_LAUNCHES"] == P * int(res.n_matvec)
    assert sum(counts.values()) == counts["SELL_LAUNCHES"]
