"""The benchmark of pykrylov_tpu_torch on an NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, cell or metric
is a file of its own, found by its name:

* ``configs/<config>.json``: the matrix as it is run (sizes, the bytes a
  nonzero must stream, source, assumptions), with its generator, a
  module of ``configs/``, beside it;
* ``workloads/<cell>.json``: the traffic of one cell (block width, pool
  of right-hand sides, tolerance, dtype, traced solves, the limits of the
  comparison that decides ``correct``);
* ``metrics/<metric>.py``: one reader per metric, ``read(run)``.

The yardstick (generators, the plain reference, roofline bytes and peaks,
the trace reduction) lives here and imports nothing of the JAX package.
"""
