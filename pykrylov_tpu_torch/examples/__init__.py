"""The port's versions of the scripts in ``examples/``.

Each script runs as ``python -m pykrylov_tpu_torch.examples.<name>`` and
has a ``main(argv=None)`` that takes ``--device`` (default ``cuda``; pass
``cpu`` to run without a card) and the original script's size arguments;
importing one does nothing.  They call only the port's public API.

  * ``bmark``: the reference's benchmark protocol (CGS, TFQMR and
    Bi-CGSTAB on jpwh_991, f64), and ``demo_common``, its shared driver;
  * ``demo_cg``, ``demo_minres``: the reference's CG and MINRES demos
    (f64, per-iteration logging);
  * ``demo_batched``: the bmark trio on a block of right-hand sides;
  * ``demo_chebyshev``: Chebyshev-preconditioned CG on 3-D Poisson;
  * ``demo_complex``: complex systems through the real equivalent;
  * ``demo_general``: a general-sparsity operator and verified f32 CG;
  * ``demo_general_sharded``, ``demo_multichip``,
    ``demo_partitioned_io``: the sharded operators on a mesh of shard
    slots (several slots share one card);
  * ``demo_pde``: a matrix-free 2-D Poisson operator;
  * ``demo_refined``, ``demo_verified_block``: verified refinement.
"""
