"""Block CG's vector work on the card: the three passes of
``csrc/block_cg.cu``.

:func:`~.batched.cg_batched` runs an iteration on a plain CUDA block of
float32 or float64 (:func:`takes`) as its block product and three in-place
passes over the solve's own (n, K) blocks:

  * ``coldot``: the per-column dots ``a_k' b_k`` of two blocks, each read
    once: ``P'AP``, and ``R'Y`` when a preconditioner is given;
  * ``update_r``: ``R <- R - alpha o AP``, with ``R'R`` of the new R summed
    in the same pass when there is no preconditioner;
  * ``update_xp``: ``X <- X + alpha o P`` and ``P <- Y + beta o P``.

Each pass writes a column only where the iteration's ``act`` mask is on (a
frozen column keeps its values bit for bit).  A summing pass adds each
column's terms in float64, across blocks in a fixed order (no float
atomics), and its last block runs the iteration's per-column scalar step
on the sums rounded to the block's dtype, with the torch loop's rules:
the curvature test and alpha after ``P'AP``; the residual, the stop tests,
beta, the history row, the counts, the mask and the poll's flags after
``R'R`` or ``R'Y``.  The per-column state lives on the card in the
:class:`BlockCG` of the solve; the host reads its two ``flags`` (any and
all columns active) once an iteration.  Their copy to pinned host memory
is enqueued right behind the pass that sets them
(:meth:`BlockCG.send_flags`), before ``update_xp``, so the host learns
them, and enqueues the next iteration's product, while ``update_xp`` runs
(:meth:`BlockCG.read_flags`).

The passes exist only on the card: every other block takes
``cg_batched``'s torch loop, which the card tests hold the kernels
against.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .common import host_read

__all__ = ["BLOCK_CG_LAUNCHES", "BlockCG", "BlockCGPlan", "block_cg_plan",
           "takes"]

# Launches of the three kernels in this process; each pass adds one per
# launch and nothing else touches it except a caller resetting it.
BLOCK_CG_LAUNCHES = 0

THREADS = 256         # kThreads in csrc/block_cg.cu
BLOCKS_PER_SM = 4     # kMinBlocks there: the kernels' launch bounds

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ALPHA, _BETA = 0, 1  # the kernels' scalar steps (kAlpha, kBeta)


def takes(B):
    """Whether ``cg_batched`` runs the block ``B`` through the kernels: a
    plain CUDA tensor (a ``RankShard``'s dots all-reduce across ranks) of
    float32 or float64."""
    return type(B) is torch.Tensor and B.is_cuda and B.dtype in _SUFFIX


class BlockCGPlan(NamedTuple):
    """How the kernels cover an (n, K) block (:func:`block_cg_plan`):
    ``v`` elements a load, ``blocks`` blocks of ``THREADS`` threads."""
    v: int
    blocks: int


def block_cg_plan(n, k, itemsize, aligned, sms):
    """The kernels' plan for an (n, k) block of ``itemsize``-byte values
    whose blocks are all 16-byte ``aligned``, on a card of ``sms`` SMs.

    V is 16 bytes of values (4 in float32, 2 in float64) when it divides k
    and the blocks are aligned, else 1.  The grid is ``BLOCKS_PER_SM``
    blocks an SM, fewer where the block has fewer vectors than that many
    threads, rounded up to a multiple of ``k / gcd(k, THREADS * V)``, so
    that the grid's stride of ``blocks * THREADS * V`` elements is a
    multiple of k: each thread meets the same columns throughout.
    """
    vw = 16 // itemsize
    v = vw if aligned and k % vw == 0 else 1
    step = k // math.gcd(k, THREADS * v) or 1
    need = -(-(n * k // v) // THREADS)
    blocks = max(1, min(BLOCKS_PER_SM * sms, need))
    return BlockCGPlan(v, -(-blocks // step) * step)


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("block_cg"), name)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    if name.startswith("block_cg_coldot"):
        fn.argtypes = [p, p, i64, i64, i32, i32, i32, p, i32, p, p, p, p]
    elif name.startswith("block_cg_update_r"):
        fn.argtypes = [p, p, i64, i64, i32, i32, i32, p, p, p, p, p]
    else:
        fn.argtypes = [p, p, p, i64, i64, i32, i32, p, p]
    fn.restype = ctypes.c_int
    return fn


class BlockCG:
    """One solve's vector work on the card: the blocks X, R and P, updated
    in place, the per-column state on the card (``ry``, ``resid``,
    ``thresh``, ``alpha``, ``beta``, ``act``, ``active``, ``definite``,
    ``iters`` and the poll's ``flags``) and the three passes.  The plan,
    the stream and the kernels' entries are taken once, here."""

    def __init__(self, X, R, P, ry, resid, thresh, active, check_curvature):
        dev, K = X.device, X.shape[1]
        self.X, self.R, self.P = X, R, P
        self.ry, self.resid, self.thresh = ry.clone(), resid.clone(), thresh
        self.active = active.clone()
        self.alpha = torch.zeros_like(self.ry)
        self.beta = torch.zeros_like(self.ry)
        self.act = torch.zeros(K, dtype=torch.bool, device=dev)
        self.definite = torch.ones(K, dtype=torch.bool, device=dev)
        self.iters = torch.zeros(K, dtype=torch.int32, device=dev)
        self.flags = torch.zeros(2, dtype=torch.bool, device=dev)
        self.check = bool(check_curvature)
        for t in (X, R, P, self.ry, self.resid, self.thresh):
            if t.dtype != X.dtype or not t.is_contiguous():
                raise ValueError("block CG's kernels take contiguous %s "
                                 "blocks and scalars, got %s"
                                 % (X.dtype, t.dtype))
        self.plan = block_cg_plan(
            X.shape[0], K, X.element_size(),
            all(t.data_ptr() % 16 == 0 for t in (X, R, P)),
            torch.cuda.get_device_properties(dev).multi_processor_count)
        self.partial = torch.empty(self.plan.blocks * K, dtype=torch.float64,
                                   device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.state = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in (
            self.ry, self.resid, self.thresh, self.alpha, self.beta,
            self.act, self.active, self.definite, self.iters, self.flags)])
        sfx = _SUFFIX[X.dtype]
        self._coldot = _entry("block_cg_coldot_" + sfx)
        self._update_r = _entry("block_cg_update_r_" + sfx)
        self._update_xp = _entry("block_cg_update_xp_" + sfx)
        self._shape = (X.numel(), K, self.plan.v, self.plan.blocks)
        self.host_flags = torch.empty(2, dtype=torch.bool, pin_memory=True)
        self.flags_sent = torch.cuda.Event()

    def send_flags(self):
        """Enqueue the copy of the poll's flags to the host, behind the
        pass that set them."""
        self.host_flags.copy_(self.flags, non_blocking=True)
        self.flags_sent.record()

    def read_flags(self):
        """The poll's flags, any and all columns active, on the host: the
        iteration's one host read, of the copy :meth:`send_flags`
        enqueued."""
        return host_read(self.host_flags, after=self.flags_sent)

    def _operand(self, T):
        """A block from outside the solve (AP, Y) as the kernels take it:
        X's shape and dtype, contiguous, 16-byte aligned."""
        X = self.X
        if T.shape != X.shape:
            raise ValueError("block of shape %s for a (%d, %d) solve"
                             % (tuple(T.shape), *X.shape))
        if T.dtype != X.dtype or not T.is_contiguous():
            T = T.to(X.dtype).contiguous()
        if T.data_ptr() % 16:
            T = T.clone()
        return T

    def _done(self, err, what):
        global BLOCK_CG_LAUNCHES
        if err != 0:
            raise RuntimeError("block CG %s kernel launch failed with CUDA "
                               "error %d" % (what, err))
        BLOCK_CG_LAUNCHES += 1

    def coldot(self, A, B, beta=False, hist_row=None):
        """``a_k' b_k`` for each column, then the scalar step: alpha's
        (``A`` = P, ``B`` = AP) or, with ``beta``, beta's (``A`` = R, ``B``
        = Y), which writes ``hist_row`` when given."""
        B = self._operand(B)
        n, k, v, blocks = self._shape
        self._done(self._coldot(
            A.data_ptr(), B.data_ptr(), n, k, v, blocks,
            _BETA if beta else _ALPHA, self.state, int(self.check),
            None if hist_row is None else hist_row.data_ptr(),
            self.partial.data_ptr(), self.ticket.data_ptr(), self.stream),
            "coldot")

    def update_r(self, AP, sums=True, hist_row=None):
        """``R <- R - alpha o AP`` on the active columns; with ``sums``,
        ``R'R`` of the new R and beta's scalar step."""
        AP = self._operand(AP)
        n, k, v, blocks = self._shape
        self._done(self._update_r(
            self.R.data_ptr(), AP.data_ptr(), n, k, v, blocks, int(sums),
            self.state, None if hist_row is None else hist_row.data_ptr(),
            self.partial.data_ptr(), self.ticket.data_ptr(), self.stream),
            "update_r")

    def update_xp(self, Y):
        """``X <- X + alpha o P`` and ``P <- Y + beta o P`` on the active
        columns, from the old P."""
        Y = self._operand(Y)
        n, k, v, blocks = self._shape
        self._done(self._update_xp(
            self.X.data_ptr(), self.P.data_ptr(), Y.data_ptr(), n, k, v,
            blocks, self.state, self.stream), "update_xp")
