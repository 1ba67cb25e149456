"""Limited-memory BFGS operators.

Counterpart of ``pykrylov_tpu/ops/lbfgs.py``, after the reference L-BFGS
family (``linop/lbfgs.py``).  The pair history is an :class:`LBFGSData`
record (fixed-size ``(mem, n)`` buffers and an insertion counter) that the
functions below take and return, and the classes keep the reference's
mutable API (``store``, ``restart``, operator algebra) by swapping the
record.  The JAX package's masked ``fori_loop`` recursions over the memory
slots become plain loops over the stored pairs, oldest to newest: which
slots are filled (``valid``) and the counter live on the host, the
vectors and their scalars on the buffers' device.

On a mesh of ranks (``mesh=`` a mesh of :func:`~..parallel.make_mesh`
under a world of ranks) the buffers hold this rank's rows of the pairs,
``(mem, L)`` :class:`~..utils.ranks.RankShard` tensors, so ``s[k]`` is a
rank-sharded vector; every dot and every product over the rows goes
through the global reductions of :mod:`..utils.ranks` (one ``all_reduce``
each; the compact form's ``S Y^T``, ``S S^T``, ``S v`` and ``Y v`` one
each), and the accept test reads the global ``s.y``, so every rank keeps
or drops the same pair.  On plain tensors those helpers are the plain
torch calls, so an unsharded operator (or one on a mesh of slots) computes
what it computed before.

Reference bugs intentionally not replicated (SURVEY §2.1):
``StructuredLBFGSOperator``'s broken constructor and ``self.matvec``
calls (``lbfgs.py:277,338,349``); the structured update is implemented
per its documented intent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import LinearOperator
from ..utils import ranks
from ..utils.ranks import matmul_rows, vdot, vdot_real
from ..utils.types import as_dtype, to_tensor

__all__ = [
    "LBFGSData",
    "lbfgs_init",
    "lbfgs_store",
    "lbfgs_restart",
    "inverse_lbfgs_matvec",
    "forward_lbfgs_matvec",
    "compact_lbfgs_matvec",
    "structured_lbfgs_matvec",
    "InverseLBFGSOperator",
    "LBFGSOperator",
    "CompactLBFGSOperator",
    "StructuredLBFGSOperator",
]

# curvature acceptance threshold (reference: ``lbfgs.py:51``)
ACCEPT_THRESHOLD = 1.0e-20


class LBFGSData(NamedTuple):
    """A fixed-size ring buffer of (s, y) pairs."""
    s: torch.Tensor       # (mem, n), or (mem, L) rank-sharded rows
    y: torch.Tensor       # (mem, n), or (mem, L) rank-sharded rows
    ys: torch.Tensor      # (mem,)  cached s.y products
    valid: torch.Tensor   # (mem,)  bool mask of filled slots, on the host
    insert: int           # next slot (counts every accepted pair)
    gamma: torch.Tensor   # () scaling factor


def _pair_rows(n, device, mesh):
    """``(rows, device, mark)`` of a pair buffer for vectors of global
    length ``n``: all of them on ``device``, or on a mesh of ranks this
    rank's ``n / R`` on its card, marked rank-sharded."""
    if mesh is None or not mesh.ranked:
        return n, device, (lambda t: t)
    if n % mesh.size:
        raise ValueError("a mesh of %d ranks shards vectors of a length "
                         "divisible by %d (the sharded operator's padded "
                         "nargin); got n=%d" % (mesh.size, mesh.size, n))
    return n // mesh.size, mesh.home, ranks.shard


def lbfgs_init(n, mem=5, dtype=torch.float32, device="cuda", mesh=None):
    """An empty history of ``mem`` pairs of length-``n`` vectors; on a
    mesh of ranks (``mesh``) of this rank's ``n / R`` rows of each."""
    dtype = as_dtype(dtype)
    rows, device, mark = _pair_rows(n, device, mesh)
    z = mark(torch.zeros((mem, rows), dtype=dtype, device=device))
    return LBFGSData(
        s=z, y=z.clone(), ys=torch.zeros(mem, dtype=dtype, device=device),
        valid=torch.zeros(mem, dtype=torch.bool), insert=0,
        gamma=torch.ones((), dtype=dtype, device=device))


def _order(insert, mem):
    """Slot indices from oldest to newest."""
    base = insert % mem if insert >= mem else 0
    return [(base + i) % mem for i in range(mem)]


def _stored(data):
    """The filled slots, oldest to newest."""
    valid = data.valid.tolist()
    return [k for k in _order(data.insert, data.s.shape[0]) if valid[k]]


def _promoted(data, v):
    """``data`` with its pairs and scalars in the promoted dtype of the
    pairs and ``v``: an f32 history applied to an f64 vector computes in
    f64 on the exactly widened pairs, as the JAX package's dtype promotion
    does (the same record when no widening is needed)."""
    ct = torch.promote_types(data.s.dtype, v.dtype)
    if ct == data.s.dtype:
        return data
    return data._replace(s=data.s.to(ct), y=data.y.to(ct),
                         ys=data.ys.to(ct), gamma=data.gamma.to(ct))


def _as_pair(buf, v):
    """``v`` on the pair buffer ``buf``'s device and dtype, rank-sharded
    when it is."""
    v = to_tensor(v, device=buf.device).to(buf.dtype)
    return ranks.shard(v) if ranks.sharded(buf) else v


def lbfgs_store(data: LBFGSData, s, y, scaling: bool = True) -> LBFGSData:
    """Insert a pair if its curvature ``s.y`` exceeds the threshold
    (``InverseLBFGSOperator.store``, ``lbfgs.py:70-87``); a rejected pair
    leaves the data as it was.  One host read, of ``s.y`` (global on a
    mesh of ranks)."""
    s, y = _as_pair(data.s, s), _as_pair(data.s, y)
    ys = vdot_real(y, s).to(data.ys.dtype)
    if not ys.item() > ACCEPT_THRESHOLD:
        return data
    k = data.insert % data.s.shape[0]
    gamma = (ys / vdot_real(y, y)).to(data.gamma.dtype) if scaling \
        else data.gamma
    S, Y, YS, valid = (data.s.clone(), data.y.clone(), data.ys.clone(),
                       data.valid.clone())
    S[k], Y[k], YS[k], valid[k] = s, y, ys, True
    return LBFGSData(s=S, y=Y, ys=YS, valid=valid, insert=data.insert + 1,
                     gamma=gamma)


def lbfgs_restart(data: LBFGSData) -> LBFGSData:
    """Forget all stored pairs (``lbfgs.py:89-95``); the buffers keep
    their shape, device and rank-sharding."""
    return LBFGSData(s=torch.zeros_like(data.s), y=torch.zeros_like(data.y),
                     ys=torch.zeros_like(data.ys),
                     valid=torch.zeros_like(data.valid), insert=0,
                     gamma=torch.ones_like(data.gamma))


def inverse_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """Two-loop recursion: the inverse-Hessian approximation H applied to
    v (``InverseLBFGSOperator.lbfgs_matvec``, ``lbfgs.py:97-127``)."""
    data = _promoted(data, v)
    order = _stored(data)
    q = v
    alphas = {}
    for k in reversed(order):               # newest -> oldest
        alphas[k] = vdot(data.s[k], q) / data.ys[k]
        q = q - alphas[k] * data.y[k]
    r = q * data.gamma if scaling else q
    for k in order:                         # oldest -> newest
        beta = vdot(data.y[k], r) / data.ys[k]
        r = r + (alphas[k] - beta) * data.s[k]
    return r


def forward_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """The forward Hessian approximation B applied to v
    (``LBFGSOperator.lbfgs_matvec``, ``lbfgs.py:140-173``): from B0 =
    I/gamma, the BFGS update of each stored pair, oldest first, with each
    ``B_i s_i`` recomputed through the earlier updates."""
    data = _promoted(data, v)
    order = _stored(data)

    def apply_B(upto, w):
        acc = w / data.gamma if scaling else w
        for i in range(upto):
            k = order[i]
            t1 = vdot(data.y[k], w) / data.ys[k]
            t2 = vdot(Bs[i], w) / sBs[i]
            acc = acc + t1 * data.y[k] - t2 * Bs[i]
        return acc

    Bs, sBs = [], []
    for i, k in enumerate(order):
        Bs.append(apply_B(i, data.s[k]))
        sBs.append(vdot(data.s[k], Bs[i]))
    return apply_B(len(order), v)


def structured_lbfgs_matvec(params, v, scaling: bool = True):
    """The structured forward L-BFGS approximation B applied to v.

    The reference's recursion is broken in code (``lbfgs.py:277,338,349``);
    this is its documented intent ([Nocedal06] structured secant): with
    ``A_k = yd_k - B_k s_k``,

        B_{k+1} = B_k + (A_k y_k' + y_k A_k')/y_k's_k
                      - (s_k'A_k) y_k y_k' / (y_k's_k)^2,

    which satisfies ``B_{k+1} s_k = yd_k`` and keeps B symmetric, with
    ``B_k s_k`` computed through the accumulated updates.

    ``params``: dict with s/y/yd (mem, n), ys (mem,), valid (mem, on the
    host), insert (int) and gamma.
    """
    mem = params["s"].shape[0]
    valid = params["valid"].tolist()
    order = [k for k in _order(params["insert"], mem) if valid[k]]
    gamma = params["gamma"]

    def apply_B(upto, w):
        acc = w / gamma if scaling else w
        for j in range(upto):
            k = order[j]
            y, s, ys = params["y"][k], params["s"][k], params["ys"][k]
            t = 1.0 / ys
            yw = vdot(y, w)
            Aw = vdot(A_all[j], w)
            sA = vdot(s, A_all[j])
            acc = acc + (Aw * t) * y + (yw * t) * A_all[j] \
                - (sA * yw * t * t) * y
        return acc

    A_all = []
    for i, k in enumerate(order):
        A_all.append(params["yd"][k] - apply_B(i, params["s"][k]))
    return apply_B(len(order), v)


def compact_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """The forward approximation through the compact representation
    (``CompactLBFGSOperator.lbfgs_matvec``, ``lbfgs.py:188-254``):
    ``B = B0 - [B0 S  Y] W^{-1} [B0 S  Y]^T``, W the 2m x 2m "minimat"
    ``[[S^T B0 S, L], [L^T, -D]]``, with an empty slot's rows and columns
    of W replaced by the identity's, as in the JAX package.  W is built in
    the pairs' dtype and only the products with v are promoted, so an f32
    history applied to an f64 vector rounds as the JAX package's does."""
    mem = data.s.shape[0]
    order = _order(data.insert, mem)
    S, Y = data.s[order], data.y[order]
    valid = data.valid[order].to(data.s.device)
    ys = data.ys[order]
    theta = 1.0 / data.gamma if scaling else torch.ones(
        (), dtype=v.dtype, device=v.device)
    StY = matmul_rows(S, Y.T)
    L = torch.tril(StY, -1)                  # strictly lower part of S^T Y
    W = torch.cat([torch.cat([theta * matmul_rows(S, S.T), L], 1),
                   torch.cat([L.T, -torch.diag(ys)], 1)], 0)
    mask2 = torch.cat([valid, valid])
    Wm = torch.where(mask2[:, None] & mask2[None, :], W,
                     torch.eye(2 * mem, dtype=W.dtype, device=W.device))
    ct = torch.promote_types(W.dtype, v.dtype)
    S, Y = S.to(ct), Y.to(ct)
    rhs = torch.cat([theta * matmul_rows(S, v), matmul_rows(Y, v)]) * mask2
    coef = torch.linalg.solve(Wm.to(ct), rhs) * mask2
    corr = theta * (S.T @ coef[:mem]) + Y.T @ coef[mem:]
    return theta * v - corr


# ---------------------------------------------------------------------------
# Class wrappers (reference-style mutable API)
# ---------------------------------------------------------------------------


class InverseLBFGSOperator(LinearOperator):
    """The inverse-Hessian L-BFGS approximation as an operator
    (``lbfgs.py:14-127``): ``store(s, y)`` and ``restart()`` swap its
    :class:`LBFGSData`; the product is the two-loop recursion.

    ``mesh``: a mesh of ranks makes the operator global over them: ``n``
    is the vectors' global (padded) length, the pairs given to ``store``
    and the vectors it is applied to are this rank's rows (rank-sharded),
    and it lives on this rank's card.  A mesh of slots changes nothing
    (its vectors are whole tensors)."""

    _matvec_fn = staticmethod(inverse_lbfgs_matvec)

    def __init__(self, n, npairs=5, scaling: bool = True, dtype=None,
                 device="cuda", mesh=None, **kwargs):
        dtype = as_dtype(dtype) if dtype is not None \
            else torch.get_default_dtype()
        self.scaling = scaling
        self._npairs = npairs
        self._data = lbfgs_init(n, npairs, dtype, device, mesh)
        device = self._data.s.device
        fn = type(self)._matvec_fn
        super().__init__(n, n, matvec=lambda x: fn(self._data, x, scaling),
                         symmetric=True, hermitian=True, dtype=dtype,
                         device=device, **kwargs)

    @property
    def npairs(self):
        return self._npairs

    @property
    def data(self) -> LBFGSData:
        return self._data

    @property
    def insert(self):
        return self._data.insert % self._npairs

    def store(self, new_s, new_y):
        self._data = lbfgs_store(self._data, new_s, new_y, self.scaling)

    def restart(self):
        self._data = lbfgs_restart(self._data)

    def lbfgs_matvec(self, v):
        return self._mv(self._as_tensor(v))


class LBFGSOperator(InverseLBFGSOperator):
    """The forward Hessian approximation B (``lbfgs.py:130-173``)."""

    _matvec_fn = staticmethod(forward_lbfgs_matvec)


class CompactLBFGSOperator(InverseLBFGSOperator):
    """The forward approximation in compact form (``lbfgs.py:176-254``)."""

    _matvec_fn = staticmethod(compact_lbfgs_matvec)


class StructuredLBFGSOperator(LinearOperator):
    """The structured forward L-BFGS update (``lbfgs.py:257-350``), per
    its documented intent (:func:`structured_lbfgs_matvec`).  Pairs are
    ``(s, y, yd)``, ``yd`` the structured gradient difference; a pair is
    accepted when ``y's + sqrt(y's * s'Bs) >= accept_threshold``
    (``lbfgs.py:330-342``), B the current approximation: one host read.
    ``mesh`` as :class:`InverseLBFGSOperator`'s."""

    def __init__(self, n, npairs=5, scaling: bool = True, dtype=None,
                 accept_threshold: float = 1.0e-8, device="cuda", mesh=None,
                 **kwargs):
        dtype = as_dtype(dtype) if dtype is not None \
            else torch.get_default_dtype()
        self.scaling = scaling
        self._npairs = npairs
        self._mesh = mesh
        self.accept_threshold = accept_threshold
        rows, device, mark = _pair_rows(n, device, mesh)
        z = mark(torch.zeros((npairs, rows), dtype=dtype, device=device))
        self._data = dict(s=z, y=z.clone(), yd=z.clone(),
                          ys=torch.zeros(npairs, dtype=dtype, device=device),
                          valid=torch.zeros(npairs, dtype=torch.bool),
                          insert=0,
                          gamma=torch.ones((), dtype=dtype, device=device))
        super().__init__(
            n, n, matvec=lambda x: structured_lbfgs_matvec(
                self._data, x, scaling),
            symmetric=True, hermitian=True, dtype=dtype, device=device,
            **kwargs)

    @property
    def data(self):
        return self._data

    def store(self, new_s, new_y, new_yd):
        d = self._data
        dt = self.dtype
        s, y, yd = (_as_pair(d["s"], v) for v in (new_s, new_y, new_yd))
        ys = vdot(y, s)
        sBs = vdot(s, self._mv(s))
        ys_h, sBs_h = torch.stack([ys, sBs]).tolist()
        if not (ys_h + max(ys_h * sBs_h, 0.0) ** 0.5
                >= self.accept_threshold):
            return
        k = d["insert"] % d["s"].shape[0]
        gamma = (ys / vdot(y, y)).to(dt) \
            if (self.scaling and ys_h > 0) else d["gamma"]
        new = {key: d[key].clone() for key in ("s", "y", "yd", "ys",
                                               "valid")}
        new["s"][k], new["y"][k], new["yd"][k] = s, y, yd
        new["ys"][k], new["valid"][k] = ys, True
        self._data = dict(new, insert=d["insert"] + 1, gamma=gamma)

    def restart(self):
        self.__init__(self.nargin, self._npairs, self.scaling, self.dtype,
                      accept_threshold=self.accept_threshold,
                      device=self.device, mesh=self._mesh)

    def lbfgs_matvec(self, v):
        return self._mv(self._as_tensor(v))
