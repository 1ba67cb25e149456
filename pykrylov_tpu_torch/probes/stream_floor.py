"""How fast a kernel reads device memory: f32 streams folded into 1024 bins.

Counterpart of ``tools/probes/probe_stream_floor.py`` (its ``blockspec_stream``
and ``ring_stream`` kernels).  :func:`stream_fold` launches
``csrc/probe_stream.cu`` for CUDA tensors and runs :func:`stream_fold_plain`
for CPU tensors; anything else raises.  The TPU kernel returns the last
grid step's fold; this function sums every block's (see the source's
header), so with one block the two agree and with several it is the sum of
the TPU kernel run on each block alone.

The probe streams integers 0-7 (:func:`probe_streams`): every partial sum
is then an integer below 2**24, and the kernel's atomics give the plain
version's bits in any order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["BINS", "MODES", "STREAM_LAUNCHES", "probe_streams",
           "ring_fits", "stream_bytes", "stream_fold", "stream_fold_plain"]

BINS = 1024            # floats a row: out.view(-1)[q] sums a_k[1024 i + q]
MODES = ("direct", "ring")
UNROLLS = (1, 2, 4, 8)         # rows whose loads a thread issues at once
RING_BYTES = 192 * 1024        # shared memory a block's ring may take
MAX_DEPTH = 8

# Launches of the kernel in this process (see probes.COUNTERS)
STREAM_LAUNCHES = 0


def stream_fold_plain(streams):
    """``sum_k a_k.view(-1, 1024).sum(0)`` as (8, 128) f32."""
    streams = _check(streams)
    return sum(a.view(-1, BINS).sum(0) for a in streams).view(8, 128)


def stream_bytes(streams):
    """Bytes a fold must read: every stream once (the 4 KB out apart)."""
    return sum(a.numel() * 4 for a in streams)


def ring_fits(nstreams, chunk, depth):
    """Whether a ring of ``depth`` slots of ``chunk`` bytes a stream fits
    the kernel: chunk a multiple of 4 KB, depth 2-8, at most 192 KB."""
    return (chunk >= 4 * BINS and chunk % (4 * BINS) == 0
            and 2 <= depth <= MAX_DEPTH
            and nstreams * depth * chunk <= RING_BYTES)


def probe_streams(nstreams, total_bytes, seed=0, device="cuda"):
    """``nstreams`` f32 streams of ``total_bytes`` in all (the probe's
    split: ``total_bytes // nstreams`` each), integers 0-7 drawn from a
    seeded generator on ``device``."""
    n = total_bytes // (4 * nstreams)
    if n % BINS or n == 0:
        raise ValueError("%d bytes in %d streams is not a whole number of "
                         "%d-float rows a stream"
                         % (total_bytes, nstreams, BINS))
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, 8, (n,), generator=g, device=device,
                          dtype=torch.int32).float()
            for _ in range(nstreams)]


def stream_fold(streams, mode="direct", unroll=4, chunk=16384, depth=4,
                blocks=0):
    """The fold of :func:`stream_fold_plain`: the CUDA kernel for CUDA
    tensors (``mode`` "direct": ``unroll`` rows of 16-byte loads in flight
    a thread; "ring": ``depth`` slots of ``chunk`` bytes a stream, fed by
    TMA bulk copies), the plain version for CPU tensors.  ``blocks`` is
    the grid (0: the SMs times the blocks an SM holds)."""
    streams = _check(streams)
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (MODES, mode))
    devices = {a.device for a in streams}
    if devices == {torch.device("cpu")}:
        return stream_fold_plain(streams)
    if len(devices) != 1 or streams[0].device.type != "cuda":
        raise ValueError("stream_fold: streams on %s; the kernel takes them "
                         "on one CUDA device" % sorted(map(str, devices)))
    return _launch(streams, mode, unroll, chunk, depth, blocks)


def _check(streams):
    streams = list(streams)
    if len(streams) not in (1, 2):
        raise ValueError("stream_fold takes 1 or 2 streams, got %d"
                         % len(streams))
    for a in streams:
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("stream_fold takes contiguous f32 streams, got "
                             "%s" % (a.dtype,))
        if a.numel() == 0 or a.numel() % BINS:
            raise ValueError("a stream's length must be a positive multiple "
                             "of %d, got %d" % (BINS, a.numel()))
    return [a.view(-1) for a in streams]


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("probe_stream"), name)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = ([p, p, i64, i64, i64, i64, p, p] if name.endswith("direct")
                   else [p, p, i64, i64, i64, i64, i64, p, p])
    fn.restype = ctypes.c_int
    return fn


def _launch(streams, mode, unroll, chunk, depth, blocks):
    global STREAM_LAUNCHES
    n = streams[0].numel()
    if any(a.numel() != n for a in streams):
        raise ValueError("the kernel takes streams of one length, got %s"
                         % [a.numel() for a in streams])
    if any(a.data_ptr() % 16 for a in streams):
        raise ValueError("the kernel reads 16-byte aligned streams")
    if mode == "direct" and unroll not in UNROLLS:
        raise ValueError("unroll must be one of %s, got %r"
                         % (UNROLLS, unroll))
    if mode == "ring" and not ring_fits(len(streams), chunk, depth):
        raise ValueError("a ring of %d slots of %d bytes for %d streams: "
                         "chunk must be a multiple of 4096, depth 2-%d, "
                         "streams x depth x chunk at most %d bytes"
                         % (depth, chunk, len(streams), MAX_DEPTH,
                            RING_BYTES))
    if not 0 <= blocks < 2 ** 31:
        raise ValueError("blocks must lie in [0, 2**31), got %r" % blocks)
    out = torch.zeros(BINS, dtype=torch.float32, device=streams[0].device)
    a0 = streams[0].data_ptr()
    a1 = streams[-1].data_ptr()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if mode == "direct":
            err = _entry("probe_stream_direct")(
                a0, a1, len(streams), n, unroll, blocks, out.data_ptr(),
                stream)
        else:
            err = _entry("probe_stream_ring")(
                a0, a1, len(streams), n, chunk, depth, blocks,
                out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("stream fold kernel (%s) launch failed with CUDA "
                           "error %d" % (mode, err))
    STREAM_LAUNCHES += 1
    return out.view(8, 128)
