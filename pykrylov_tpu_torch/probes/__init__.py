"""The TPU probes' kernels on the card: hand-written CUDA kernels that ask
of the H100 what ``tools/probes/`` asked of the TPU.  None of them is on a
solver's path; ``chip_probes.py`` sweeps them and ``chip_smoke.py`` (phase
23) holds each against its plain version.

* :mod:`.stream_floor` -- how fast a kernel reads device memory: one or two
  f32 streams folded into 1024 bins, by 16-byte loads or through a TMA
  ring (``csrc/probe_stream.cu``; ``probe_stream_floor.py``).
* :mod:`.dia_ring` -- the DIA SpMV with its diagonals fed through a TMA
  ring in shared memory (``csrc/probe_dia_ring.cu``;
  ``probe_dia_manual_dma.py``).
* :mod:`.sell_ablation` -- the SELL SpMV whole and with one part removed
  at a time, each variant a defined function
  (``csrc/probe_sell_ablation.cu``; ``probe_bell_ablation.py``,
  ``probe_bell_ablation_w1.py``, ``probe_ablate_r3.py``, ``probe_skew.py``).
* :mod:`.onehot_mma` -- a one-hot select ``oh @ w`` on the tensor cores,
  f32 values carried as four u8 byte planes (exact for every pattern) or
  three bf16 pieces (``csrc/probe_onehot_mma.cu``, with the one-hot
  fragments and transports of ``csrc/onehot_mma.cuh``;
  ``probe_int8_mxu.py``).
* :mod:`.bell_mma` -- one product over a window-1 BELL container with the
  x window staged and the group sums scattered by one-hot products on the
  tensor cores (bf16 or tf32 pieces) or by loads and adds, and two folds
  (``csrc/probe_bell_mma.cu``; ``probe_ablate_r3b.py``).

Each wrapper launches its kernel for CUDA tensors, runs its plain torch
version for CPU tensors and raises for anything else, and adds one to its
module's launch counter (``COUNTERS``) per launch.
"""

from __future__ import annotations

import importlib

from . import bell_mma, dia_ring, onehot_mma, sell_ablation, stream_floor

__all__ = ["COUNTERS", "bell_mma", "counts", "dia_ring", "onehot_mma",
           "reset_counts", "sell_ablation", "stream_floor"]

# (kernel, module, counter): each wrapper adds one per launch and nothing
# else touches them except a caller resetting them
COUNTERS = (("probe_stream", "stream_floor", "STREAM_LAUNCHES"),
            ("probe_dia_ring", "dia_ring", "DIA_RING_LAUNCHES"),
            ("probe_sell_ablation", "sell_ablation",
             "SELL_ABLATION_LAUNCHES"),
            ("probe_onehot_mma", "onehot_mma", "ONEHOT_LAUNCHES"),
            ("probe_bell_mma", "bell_mma", "BELL_MMA_LAUNCHES"))


def _module(name):
    return importlib.import_module(__name__ + "." + name)


def reset_counts():
    """Set every probe kernel's launch counter to 0."""
    for _, mod, attr in COUNTERS:
        setattr(_module(mod), attr, 0)


def counts():
    """{kernel: launches} of the probe kernels."""
    return {name: getattr(_module(mod), attr)
            for name, mod, attr in COUNTERS}
