#!/usr/bin/env python3
"""Smoke test of pykrylov_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pykrylov_tpu_torch/csrc``, holds
each against its plain torch version, then drives the port's main paths,
through ``operator_from_coo`` (automatic format) and ``solve``, each with
one right-hand side and with a block of K = 8:

  * DIA: CG on the 3-D Poisson matrix at n = 240 (13.8M rows, 96.4M
    nonzeros), which the policy puts on the CUDA DIA kernels;
  * BELL: CG on 1138bus tiled 1024 times (1,165,312 rows, 4,151,296
    nonzeros, general sparsity), which the policy packs into BELL levels;
    the operator derives their padding-free SELL-C-sigma card form and runs
    every product through the CUDA SELL kernels;

and, with one right-hand side, the indefinite and nonsymmetric paths:
the CG→MINRES fallback and SYMMLQ on a Helmholtz-shifted Poisson matrix
at n = 240 (DIA), MINRES's Jacobi golden on tiled 1138bus (SELL),
BiCGSTAB, CGS and TFQMR on a 4.2M-row convection-diffusion matrix (DIA),
and the reference's bmark on jpwh_991 tiled 256 times (SELL, f64); and
the least-squares path, whose solvers apply A and A^T: LSMR (``solve``'s
rectangular branch) and LSQR on a 1.34M x 0.58M power-system
state-estimation matrix (SELL in both directions), and LSQR, LSMR, CRAIG
and CRAIG-MR on the convection-diffusion matrix (DIA in both
directions); and, with blocks of K = 2, the nine batched solvers on the
same operators, through the SpMM kernels on A and A^T; and every
verified route (``solve(verified=True)``, ff-CG, ff-MINRES and the
verified block twins) on the same operators, with f32 storage; and
pipelined CG and its block twin, the differentiable solves, the Chebyshev
preconditioner, a complex system through its real equivalent and the
block-diagonal, L-BFGS and Cholesky operators; and a checkpointed and a
traced solve, and the sharded operators on a mesh of shard slots that
share the card, each shard's product one kernel launch; and the native
host pipeline (the C++ MatrixMarket parser, DIA fill and BELL planners)
held against the NumPy path at full size, and the port's examples; and
the kernels that ask of the card what ``tools/probes/`` asked of the TPU
(its read floor, a DIA SpMV fed by a TMA ring, the SELL SpMV with parts
removed), each held against its plain version.

Phases, in order:

  1. device: torch/CUDA versions, card name and power limit, TF32 off;
  2. build: every kernel library from source at once (the four SpMV and
     SpMM kernels and the three probe kernels of phase 23), the native
     host library (g++, ``native/native.cpp``) beside them (the phase
     fails without g++ or if the library does not load), the compiler's
     registers and spills per kernel, the card's published peaks
     (``PEAKS``), which set the bounds below, and its copy rate (a large
     ``copy_``), which sets the achievable times beside them;
  3. SpMV kernels vs plain on the card: DIA in f64, f32 and bf16 storage;
     SELL on the card forms, at both sorting windows (SIGMAS), of the auto
     policy's packings of ``bench.py``'s three matrix classes at 131,072
     rows and of explicit containers (int8 indices, bf16 storage, f64,
     window 2, two levels, a COO remainder): kernel = plain bit for bit,
     and the card form's plain product against the container's own;
  3b. SpMM kernels vs plain on the same matrices (DIA at K = 1, 3, 8, 64,
     SELL at K = 3, 8, 64, and the row-split and RCM operators at K = 8),
     and every column of every block product bit for bit against the SpMV
     kernel on that column;
  3c. the mixed pairs: the four kernels with f32 and with bf16 storage
     against an f64 x or X (their f32f64 and bf16f64 entries) on phase 3's
     matrices, each product bit for bit its plain version (the widened
     data's f64 product) and each block column the mixed SpMV on it;
  4. the DIA path: a warm-up solve, then the timed ``solve(A, b)`` with
     the kernel's launches counted from 0, the true residual in f64, one
     more solve under torch.profiler (device time by kernel, idle share),
     and the same solve through the plain DIA operator;
  4b. the DIA block path: ``solve(A, B)`` with B = A X_true, X_true (n, 8),
     the SpMM launches counted from 0 (= block products) and block CG's
     passes (3 a block iteration: ``cg_batched``'s fused loop), every
     column's true residual in f64 and its iterations against a single
     solve of that column, a profile of its first PROFILE_ITERS / 2 block
     iterations, and the block solve through the plain operator (its
     vector work still block CG's passes, 3 a block iteration);
  5. the BELL path: the same on tiled 1138bus, one SELL launch per
     matvec, the time to derive the card form, its first PROFILE_ITERS
     iterations profiled, the same solve through the
     plain BELL operator (the containers' own products), and, in turns
     with the kernel's, through ``fmt="ell"`` (the policy's CUDA choice
     before the BELL kernel) and ``fmt="csr"``;
  5b. the BELL block path: as 4b on tiled 1138bus, one SELL SpMM launch
     per block product;
  8. the indefinite path: Poisson n = 240 shifted by sigma midway between
     its two lowest eigenvalues (one negative eigenvalue), f32 storage on
     the DIA kernel, b standard normal in f64 (``HELM_RTOL``): CG alone
     meets nonpositive curvature (istop 2); ``solve`` then takes CG and
     MINRES, with DIA launches = CG's matvecs + MINRES's and the true
     relative residual in f64 at most 1e-4; the same MINRES on the f32 b
     (logged: the f32 recurrence's true residual); then
     ``solve(method="symmlq")`` with the same checks; a profiled run of
     each (device busy and idle share; SYMMLQ's first PROFILE_ITERS
     iterations);
  8b. MINRES's golden (BASELINE config #2): tiled 1138bus from phase 5
     with M = 1/max(|d|, 1) in f64 (the SELL f32f64 entry), b = A 1 /
     sqrt(TILES) (which keeps beta1, and so every stop test, the single
     matrix's): 412 iterations at rtol 1e-6 and 583-584 at 1e-8, within
     one, one SELL launch a matvec, the true residual logged;
  9. the nonsymmetric path: ``convdiff2d_coo(2048, wx=2049, wy=1024.5)``
     (4,194,304 rows, |w| h = 1 and 0.5), f32 storage on the DIA kernel,
     b = A x_true in f64 (the f32 recurrences stall above rtol 1e-6 here;
     an f32 BiCGSTAB capped at 4000 matvecs is logged to show it):
     ``solve`` (BiCGSTAB), CGS, TFQMR and BiCGSTAB with an f64 Jacobi M,
     each istop 0, DIA launches = matvecs, true relative residual at most
     1e-4; BiCGSTAB's first PROFILE_ITERS iterations profiled;
  9b. the reference's bmark: jpwh_991 tiled 256 times in f64 through
     ``fmt="auto"`` (logged whether ``_try_bell`` accepts it; else
     ``fmt="bell"``), x0 = tile(1 + arange(991)), rtol 1e-8, matvec_max =
     2 * 991: CGS, TFQMR and BiCGSTAB within 4 of 82, 84 and 84 matvecs
     (70, 70 and 64 with Jacobi floor=1), one SELL launch a matvec (CGS
     and TFQMR launch one more, for the guess they do not count);
  10. the rectangular path: :func:`se_coo`, the DC state-estimation
     measurement matrix of 512 areas of the 1138bus grid (1,335,296 x
     582,656, 3,574,784 nonzeros, f32): ``fmt="auto"`` must give SELL
     card forms of A and of A^T (no ELL transpose, split or permutation),
     each kernel bit for bit its plain version (f32 and f64 x); b = A
     x_true + 1% noise in f64; ``solve`` (LSMR) and ``lsqr`` at atol =
     btol = 1e-6, etol = 0, each istop 1 or 2, SELL launches = matvecs + 1
     (the uncounted A'u of the start), ``||A'r|| / (||A||_F ||r||)`` in
     f64 through the plain products at most 1e-5, the first
     PROFILE_ITERS iterations of each profiled; LSQR capped at 200
     iterations through the kernels and through the plain products on the
     same card forms:
     istop 7 both, x bit for bit; each direction's SpMV timed (f32 and
     f64 x, plain, torch CSR) against its bound;
  10b. the square unsymmetric path on phase 9's operator (DIA, A^T through
     ``dia_transpose``): LSQR and LSMR with damp 0.1, CRAIG and CRAIG-MR,
     each within 5% of the JAX package's count, DIA launches = matvecs + 1,
     the damped optimality certificate at most 1e-5 and CRAIG's and
     CRAIG-MR's SQD certificates at most 1e-8 in f64, one profiled run
     each; both directions' SpMV timed;
  11. unsymmetric blocks: phase 9's operator with an (n, 2) f64 block
     whose column 0 is phase 9's b and the other standard normal
     from seed 0: ``solve(A, B)`` (``bicgstab_batched``), CGS and TFQMR,
     every block product through the DIA SpMM (launches = the solver's
     block products, no SpMV launch), every column's true relative
     residual in f64 at most 1e-4, column 0's count within 10% of phase
     9's (25% for CGS and TFQMR), a profile of the first 25 block
     iterations of each, and BiCGSTAB capped at 100 block iterations
     through the plain products: x bit for bit;
  12. indefinite blocks: phase 8's operator and b, the same way:
     ``solve(A, B, method="minres")`` (etol 0, so the rtol test decides)
     and SYMMLQ at HELM_RTOL, MINRES capped through the plain products;
  13. least-squares blocks: phase 10's state-estimation operator and b,
     ``solve(A, B)`` (``lsqr_batched``) and LSMR through the SELL SpMM on
     ``cards["fwd"]`` and ``cards["bwd"]``, every column's ``||A'r|| /
     (||A||_F ||r||)`` at most 1e-5, LSQR capped through the plain
     products; phase 9's operator and b, CRAIG and CRAIG-MR through the
     DIA SpMM on A and ``dia_transpose(A)``, every column's SQD residuals
     at most 1e-8, CRAIG capped through the plain products; each SpMM on
     A^T timed at K = 8 (f32 and f64 block, plain, torch's CSR SpMM)
     against its bound;
  14. verified solves, one right-hand side, f32 storage, verified rtol
     1e-6 (:func:`phase_verified_single`): refined CG legs and ff-CG on
     phase 4's Poisson operator and b (DIA SpMV); refined BiCGSTAB legs
     on phase 9's operator with the f32 b, rerun with the f64 b if it
     stops short (istop 1 or 3); ff-MINRES and refined ff-MINRES legs on
     phase 8b's tiled 1138bus, Jacobi M and b (SELL SpMV, f64 vectors);
     ``refined_lls`` with LSMR legs on phase 10's state-estimation
     operator and b (SELL SpMV on both card forms).  Each solve: launches
     = the products the loop issued (two SpMVs a verification: DIA and
     SELL storage have no compensated product), the verified stop code,
     an independent f64 check of x + x_lo at or below the target (14d:
     phase 10's certificate) that the solver's verified value meets to
     1e-2 plus the verifier's own rounding, a profiled window of at most
     40 iterations, the earlier phase's unverified time beside; one
     capped run of each through the plain products, bit for bit;
  15. verified blocks, K = 2, column 0 the single phase's b, the other
     standard normal (seed 0) (:func:`phase_verified_blocks`): ff
     ``cg_batched`` on Poisson (f32; (n, 2) products and (n, 4)
     replacements through the DIA SpMM), ``refined_solve_batched`` with
     BiCGSTAB legs on convection-diffusion (f32 where 14b's f32 passed,
     rerun in f64 if it stops short; legs capped at phase 11's count),
     ff ``minres_batched`` on tiled 1138bus with Jacobi (f64; one (n, 4)
     SELL SpMM an iteration); the checks of 14 per column; then both
     SpMMs at K = 16 with an f64 block timed against their bound and
     torch's CSR SpMM in f64;
  16a. pipelined CG (:func:`phase_pipelined`), f64 vectors: ``cg_pipelined``
     on phase 4's operator and b, replace_every 0 and 10 (DIA SpMV), and
     on tiled 1138bus with phase 8b's Jacobi M and b, replace_every 10
     (SELL SpMV), each beside a classic ``cg`` of the same vectors and M:
     istop 0, launches = n_matvec + 1 (the product enqueued before the
     read that stops the loop is dropped), the true relative residual in
     f64 at most 1e-4, iterations within 10% of the classic solve's, a
     profiled window of each (idle share beside the classic solve's);
  16b. ``solve(A, B, method="cg_pipelined")`` with a K = 8 f64 block,
     column 0 phase 4's b, through the DIA SpMM (n_iter + 1 launches),
     every column's true residual at most 1e-4, column 0 within 10% of
     16a's;
  16c. the differentiable solves, ``L = w'x``, one backward each:
     ``cg_solve`` on Poisson (DIA on A), ``bicgstab_solve`` on phase 9's
     operator (the adjoint on ``dia_transpose``), ``lsqr_solve`` on phase
     10's operator (SELL on both card forms): the forward's and the
     adjoint's launches and walls, ``||A g - w||`` (or ``A'``) at most
     1e-4 of ``||w||`` in f64;
  17a. ``chebyshev_preconditioner`` (Lanczos 16, degree 8) on phase 4's
     operator: 16 SpMVs for the bounds; ``cg`` with it (launches =
     n_matvec + 7 (n_iter + 1)) and ``solve(A, B, M=M)`` through the DIA
     SpMM (block CG's passes 4 a block iteration), outer iterations
     beside phase 4's;
  17b. ``complex_solve(cg, ...)`` on a Hermitian positive definite complex
     system (3-D Poisson at n = 160 plus a shift, plus i times a skew
     first difference: 8,192,000 real rows), the kernel ``fmt="auto"``
     picked for the real equivalent, the true complex residual through a
     complex128 torch CSR product at most 1e-4;
  17c. CG on a ``BlockDiagonalLinearOperator`` of phase 4's and phase 5's
     operators (one DIA and one SELL launch an iteration, each block's
     true residual at most 1e-4); an ``InverseLBFGSOperator`` of 5 pairs
     (s, A s) (the secant equation to 1e-6); a ``CholeskyOperator`` of a
     dense SPD matrix of order 4096 (its residual to 1e-10);
  18a. ``checkpointed_solve(cg, ...)`` on phase 4's operator and b in
     chunks of 50 iterations (:func:`phase_checkpoint`): stopped by
     ``keep_going`` after its first chunk, resumed from the file to
     convergence (true residual at most 1e-4, DIA launches =
     ``total_matvec``), beside phase 4's count;
  18b. ``trace`` around phase 5's solve capped at 200 iterations, with
     ``annotate`` spans: the Chrome trace holds the spans and one SELL
     SpMV kernel event a launch, ``solve_stats`` agrees with the result;
  19a. ``HaloDiaOperator`` of phase 4's matrix over 4 shard slots on the
     card (the kernel path, 3,456,000 rows a shard): a product and a K = 8
     block product bit for bit phase 4's, CG in phase 4's count, 4 DIA
     launches a product;
  19b. ``GatherBellOperator`` of tiled 1138bus over 4 slots (one SELL
     launch a shard a product; CG within 10% of phase 5's count; over 12
     slots, whose partition cuts tiles, the same with the exchange;
     ``cg(replace_every=50)`` over its verified shadow, capped at 200) and
     of phase 10's state-estimation matrix with ``with_transpose=True``
     (A and A^T against phase 10's card forms; LSQR capped at 500 held to
     the unsharded capped LSQR);
  19c. ``HaloStencilPoisson3DOperator`` (4 z-slabs) and
     ``Halo2DPoissonOperator`` (2 x 2 bricks) at n = 240, CG within 2 of
     phase 4's count; ``TallSkinnyOperator`` of a dense f32 2^20 x 256
     matrix, LSQR's f64 certificate at most 1e-5;
  20a. the native host pipeline at full size, against the port's NumPy
     path in the same process (the library bypassed, no environment
     switch): phase 5's tiled 1138bus and phase 10's state-estimation
     matrix with its transpose, which those phases packed through the
     native planner, against the NumPy path in the window mode each
     product holds: the window planner on the whole matrix native and
     NumPy (arrays equal, both times logged), the levels packed again
     with the library bypassed (every level's arrays forward and backward
     and every SELL card form equal), one SELL SpMV and one (n, 8) SpMM
     on each card form of each packing bit for bit; tiled 1138bus written
     by the port's MatrixMarket writer and parsed by ``mm_parse_native``
     and by the NumPy parser, the arrays equal and equal to what was
     written;
     the f64 3-D Poisson matrix at n = 160 (4,096,000 rows) filled into
     DIA by ``dia_fill_native`` and by NumPy, equal, one DIA SpMV on each
     bit for bit;
  20b. the examples through their ``main``: ``bmark`` (f64, jpwh_991),
     without and with ``--precon``, within 4 of 82/84/84 and 70/70/64
     matvecs; ``demo_chebyshev`` at n = 64 (262,144 rows, ``cuda-dia``)
     and ``demo_general`` at 63,424 rows (``bell``), each converged with
     its kernel's launches counted;
  21a. a mesh of ranks (:func:`phase_ranks`): RANKS spawned processes
     sharing the card in a gloo world, ``transport="host"`` (CUDA tensors
     staged through pinned host buffers), every rank building only its
     own shard: halo DIA CG on phase 4's Poisson matrix (each rank's rows
     from ``sharded_poisson3d``; each rank's product of phase 4's x_true
     bit for bit phase 4's b; within 3 of phase 4's count, true residual
     at most 1e-4 in f64), gather-SELL CG on phase 5's tiled 1138bus
     (each rank's rows from its ``keep=rank`` part of the MatrixMarket
     file 20a wrote; within 10% of phase 5's count, true residual at most
     1e-4), LSQR on phase 10's state-estimation matrix with transposed
     shards (x within 1e-4 of the unsharded LSQR at 500 iterations); on
     every rank the same counts and stop codes, one kernel launch a
     product, ms per iteration, all-reduces per iteration and their share
     of the wall, and the idle share (a profiled window), beside phase
     19's mesh of slots and the unsharded phase; a control: the halo CG
     on one gloo rank with the same host staging;
  21b. NCCL: a one-rank NCCL world runs the exchange layer's NCCL branch
     on CUDA tensors (``all_reduce``, ``all_to_all_single``) and a halo CG
     (the legs over several cards are ``--nccl``'s, below);
  21c. ``pykrylov_tpu_torch.dryrun.dryrun_multichip(RANKS)`` over RANKS
     ranks on the card (gloo, host transport): the twelve legs of the JAX
     package's dry run, every rank printing the same lines;
  21d. in 21a's world, on 21a's halo operator and transposed shards: CG
     preconditioned by an ``InverseLBFGSOperator`` over the mesh of
     LBFGS_PAIRS pairs (s, H s); ``checkpointed_solve`` of the halo CG
     stopped by ``keep_going`` after its first chunk and resumed from the
     file (after each call the one file, written by rank 0, holds the
     gathered iterate; DIA launches = ``total_matvec``); ``lsqr(show=True)``
     capped at 20 iterations (rank 0 alone prints, every rank keeps the
     same table, whose last x(1) is the whole x's first row); the same
     lockstep, launch and residual checks as 21a;
  22. the DIA path past 64 diagonals (:func:`phase_wide`): the Galerkin
     Laplacian of quadratic B-splines on a 128^3 grid (:func:`bspline_dia`;
     2,097,152 rows, 125 diagonals, 1.05 GB of f32 diagonals built on the
     card, no COO): the SpMV kernel at all five entries and the SpMM at K
     = 1, 8, 16 bit for bit their plain versions, on it and on its
     diagonals shuffled with five repeated; ``solve`` (CG, rtol 1e-6,
     ``b = A x_true``) with DIA launches = matvecs and the f64 true
     residual at most 1e-4; ``A.T @ x`` of the Laplacian plus a first
     derivative along x through ``dia_transpose`` against
     ``formats.dia_rmatvec``; ``HaloDiaOperator`` on 4 slots bit for bit
     the unsharded kernel; ``operator_from_coo(max_diags=128)`` at n = 48
     gives ``cuda-dia`` and the default the BELL policy (a SELL card form
     at n = 16); the wide SpMV and K = 8 SpMM timed against their bound
     and torch's CSR product, and a wrapper call's host time at 125 and 7
     diagonals;
  23. the TPU probes' kernels (:func:`phase_probes`; ``chip_probes.py``
     sweeps them): with every launch count set to 0 just before and read
     just after, ``stream_fold`` over 512 MB in one and two streams,
     direct and through its TMA ring, ``dia_matvec_ring`` on phase 4's
     Poisson container and every ``sell_matvec_ablated`` variant on phase
     5's card form (4, 1 and 7 launches, no solver kernel), each bit for
     bit its plain version; edge cases at small size (lengths the chunk
     does not divide, 1, 7, 64, 65 and 125 diagonals, offsets past the
     matrix, ragged last tiles, depth 2 with odd diagonal counts, a card
     form with empty rows); one timed point of each against its plain
     version, its bound and one torch call of the same function.  On the
     same path, the tensor-core probes at the probes' sizes:
     ``bell_step_mma``'s nine configurations of ``probe_ablate_r3b.py``
     and two controls (``load``/``tile``/``add``, ``load``/``halves``/
     ``add``) on its matrix (tiled jpwh_991, 1,014,784 rows; window-1
     BELL, f32 and bf16 values; 11 launches), the ``add`` scatters bit for
     bit their plain version and the mma scatters within 2**-20 of each
     row's sum of |group sums| (largest error logged), and
     ``onehot_select`` in both modes at ``probe_int8_mxu.py``'s (1024,
     256, 128) (2 launches) bit for bit; every f32 pattern through both at
     a small size; the baseline configuration, the control and both
     selects timed against their plain versions, bounds (bytes at 3.35
     TB/s against the tensor cores' dense rates) and torch's CSR product,
     ``w[base]`` and the f32 product ``oh.float() @ w``;
  24. block CG's passes (:func:`phase_block_cg`; ``csrc/block_cg.cu``) on
     (n, K) card blocks at phase 4's n: f32 K = 8 (16-byte loads), f32
     K = 3 (a 12-byte row, one value a load) and f64 K = 8, each pass held
     against its plain torch version on the same inputs, with columns
     running, frozen, meeting negative curvature and stopping, the frozen
     ones bit for bit, without and with M (7 launches a case, no other
     kernel); then each pass timed alone and the iteration's three against
     their 10-pass bound and the torch loop's block work (17 passes);
  6. timing (CUDA events around back-to-back calls that a sleep kernel
     lets the host enqueue ahead of the device, so that a kernel shorter
     than its wrapper's host work is timed and not the host; best of 3
     runs in turns; a call's time with its host work is logged apart):
     each SpMV
     kernel (SELL at both sorting windows), its plain version, the BELL
     container's plain product, the port's plain ELL operator (BELL
     matrices) and torch's CSR matvec (cuSPARSE, timed as a yardstick
     only), against the bound: the smaller of the matrix's bytes as the
     kernel stores it and as CSR, plus x and y, at the card's published
     memory rate, or its operations at the float32 rate if longer (and
     the same bytes at the measured copy rate, as the achievable time);
     the DIA and SELL SpMV kernels also with f32 storage and an f64 x
     (Poisson n = 240, tiled 1138bus), against the same bound with f64 x
     and y and the operations at the float64 rate;
  6b. the K-curve: each SpMM kernel at K = 8, 16, 32, 64 on both matrices,
     per block and per column, against K times its SpMV kernel, its plain
     version, its bound (the matrix once plus K columns of X and Y) and
     ``torch.sparse.mm`` of torch's CSR tensor with the block (cuSPARSE
     SpMM, timed as a yardstick only);
  7. a line of each phase's numbers, then a JSON line naming the kernels
     (each with its launches in every run of phases 8-22,
     ``launches_by_phase``; the DIA kernels with phase 22's 125-diagonal
     times, ``wide``; and the verified solves of phases 14-15 that
     ran through it, ``verified_solves``; the SpMMs with their K = 16
     f64-block times, ``k16_f64_block``; the SpMV kernels with their
     mixed-pair times and bounds and both directions of the least-squares
     path,
     ``lls_directions``; the SpMM kernels with their mixed-pair times at
     K = 8, their A^T times (``transpose``) and the block solves of
     phases 11-13 that ran through them (``block_solves``); the DIA
     SpMM's with its host plan, V columns a thread, T rows a tile, Kc
     columns a panel, at each K, and each template instance's registers
     and spill bytes; the three probe kernels with phase 23's launches
     and times, the fold with its best read rate; block CG's passes with
     their launches in 4b, 5b, 17a and 24, phase 24's times, bounds and
     torch times), then the result line
     ``{"ok": true, "device": {...}}``.

Phases 8-24 run after 5b and before 6; each resets every launch count
to 0 just before a solve and reads the counts just after.  Each phase's
seconds are logged as it ends (``[time]``).

``python3 chip_smoke.py --nccl`` runs phases 1, 2 and 4 and then NCCL
worlds on the machine's cards.  Where there are two cards or more:

  21e. a probe of the exchanges (``NCCL_DEBUG=INFO`` into files, NCCL's
     chosen transports logged): each rank's card and threads, the cards
     each rank holds a context on (nvidia-smi), the round trip of a local
     op, of an ``all_reduce`` and of a halo exchange, ``all_reduce`` calls
     enqueued back to back, the halo exchange as the exchange layer's
     ``batch_isend_irecv`` and as one ``all_to_all_single``, and the halo
     CG in turns with each of them and with a 1/R share of the threads;

then the unsharded references on the first card (phase 5's tiled 1138bus
and its CG, 20a's MatrixMarket file, phase 10's state-estimation operator
and LSQR), a world of one NCCL rank a card running every leg of 21a and
21d with their checks, and the dry run's twelve legs (21c).  On one card
a world of two NCCL ranks on it must be refused.

Any failure raises and the script exits non-zero without the result line.
Without a CUDA device, or without the package beside it, it exits 2.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 240             # bench.py's headline 3-D Poisson grid
TILES = 1024        # 1138bus tiles of the BELL path (bench.py's 1M-row scale)
CLASS_ROWS = 1 << 17  # rows of bench.py's matrix classes
COPY_BYTES = 1 << 30  # bytes of the copy that measures the copy rate
DEVICE = "cuda"
# Published peaks by the name torch.cuda.get_device_name reports (NVIDIA's
# data sheet, H100 SXM at its 700 W limit): device-memory bytes a second,
# float32 operations a second outside the tensor cores, and the tensor
# cores' dense rates (bf16, tf32, int8).  The bounds divide by these; the
# copy rate measured in phase 2 gives an achievable time beside them.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes": 3.35e12, "f32": 67e12,
                                   "f64": 34e12, "bf16": 989e12,
                                   "tf32": 495e12, "int8": 1979e12}}
SLEEP_HZ = 2e9      # above the card's SM clock: a sleep of n cycles lasts
                    # at least n / SLEEP_HZ seconds
KB = 8              # right-hand sides of the block paths (phases 4b, 5b)
KB_CUT = 2          # right-hand sides of the blocks of phases 11-13 and
                    # 15: a quarter of KB, their depth cut to keep the
                    # smoke within its time
SIGMAS = (256, 4096)  # SELL sorting windows held and timed
DIA_MM_K = (1, 3, 8, 64)   # block widths of the DIA SpMM checks (3b)
BELL_MM_K = (3, 8, 64)     # block widths of the BELL SpMM checks (3b)
CURVE_K = (8, 16, 32, 64)  # block widths of the K-curve (6b)
ITER_RTOL = 0.1     # block vs single solve, iterations per column
MIXED_K = (3, 8)    # block widths of the mixed-pair SpMM checks (3c)
# iterations a profiled solve keeps when it runs longer (phases 5, 8's
# SYMMLQ, 9, 10; blocks of 4b, 5b: half as many), against the same share
# of its unprofiled wall: the profiler's cost grows with the events it
# keeps (~25 kernels an iteration)
PROFILE_ITERS = 400
HELM_RTOL = 1e-8    # rtol of the indefinite path (8): MINRES's test is
                    # relative to Anorm ynorm, so 1e-6 leaves the true
                    # residual near 1e-4 at this n
CD_N = 2048         # convection-diffusion grid of the nonsymmetric path (9)
BMARK_TILES = 256   # jpwh_991 tiles of the bmark path (9b; 1024 until the
                    # smoke needed room: the build was 26 s of the phase)
# the reference's bmark on jpwh_991 (examples/bmark.py): matvecs to rtol
# 1e-8 from x0 = 1 + arange(n), unpreconditioned and with Jacobi floor=1
BMARK = {"cgs": (82, 70), "tfqmr": (84, 70), "bicgstab": (84, 64)}
BMARK_BOUND = 4     # matvecs off that table (9b, 20b)

# max|y - y_ref| / max|y_ref|, where an output is held against another
# product that sums in another order: the SELL card form against the BELL
# container's own product, which sums a 4-row group in torch's order and
# adds group sums with index_add_, whose order on the card is not fixed.
# Every kernel equals its own plain version bit for bit.
REL_BOUND = {torch.float64: 1e-12, torch.float32: 1e-6,
             torch.bfloat16: 1e-6}


def log(*args):
    print(*args, flush=True)


def relerr(y, ref):
    scale = ref.abs().max().item()
    return (y - ref).abs().max().item() / (scale if scale else 1.0)


def events_ms(fn, iters):
    """ms per call of ``fn`` over ``iters`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# 1-2. device, build, rates
# --------------------------------------------------------------------------

def phase_device():
    log("[1 device] torch %s, CUDA %s, %d device(s)"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1 device] allow_tf32: matmul %s, cudnn %s"
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    return card


def phase_build():
    import shutil
    import threading
    from pykrylov_tpu_torch import _build, native

    if shutil.which("g++") is None:
        raise AssertionError("g++ not found on PATH: nvcc's host compiler "
                             "builds the native host pipeline")
    built = {}

    def build_native():
        # g++ beside the nvcc compiles; _load raises g++'s report
        t0 = time.perf_counter()
        try:
            native._load()
        except RuntimeError as exc:
            built["error"] = exc
        built["s"] = time.perf_counter() - t0

    gxx = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    gxx.start()
    libs = _build.build()   # one nvcc per source, all started together
    for name in libs:
        _build.load(name)
    nvcc_s = time.perf_counter() - t0
    gxx.join()
    if "error" in built:
        raise AssertionError("native build failed: %s" % built["error"])
    if not native.available():
        raise AssertionError("the native library does not load")
    log("[2 build] %s in %.3f s; %s (g++) in %.3f s beside them" % (
        ", ".join(os.path.basename(p) for p in libs.values()), nvcc_s,
        os.path.basename(native.library_path()), built["s"]))
    regs = {}
    for name, lib in libs.items():
        fn = None
        with open(lib + ".log") as f:
            for line in f.read().splitlines():
                if "entry function" in line:
                    fn = line.split("'")[1]
                    log("[2 build] %s: %s" % (name, fn))
                elif "spill" in line or "registers" in line:
                    log("[2 build] %s:     %s" % (name, line.strip()))
                    if fn is not None:
                        regs.setdefault(name, {}).setdefault(fn, []).append(
                            line.strip())
    return {name: {_instance(fn): _usage(" ".join(lines))
                   for fn, lines in fns.items()}
            for name, fns in regs.items()}


def _usage(report):
    """{"registers": n, "spill_bytes": stores + loads} of one kernel's
    ``-Xptxas -v`` lines."""
    spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
    used = re.search(r"Used (\d+) registers", report)
    return {"registers": int(used.group(1)) if used else None,
            "spill_bytes": sum(int(s) for s in spill)}


def _instance(mangled):
    """A template instance of a DIA kernel by its types and its rows a
    thread R (the SpMV) or columns a thread V (the SpMM): "f32 R=4",
    "f32/f64 V=2" for f32 data with f64 compute, "f32 R=4 wide" for the
    instance past 64 diagonals; other kernels keep their mangled names."""
    hit = re.search(r"dia_sp(mv|mm)_kernelI(13__nv_bfloat16|f|d)([fd])"
                    r"Li(\d+)E", mangled)
    if not hit:
        return mangled
    kind = {"f": "f32", "d": "f64"}.get(hit.group(2), "bf16")
    if hit.group(3) == "d" and kind != "f64":
        kind += "/f64"
    return "%s %s=%s%s" % (kind, "R" if hit.group(1) == "mv" else "V",
                           hit.group(4),
                           " wide" if "WideOffsets" in mangled else "")


def phase_rates():
    """The card's published peaks (``PEAKS``) and, as ``copy``, the
    device-memory rate of a large ``copy_`` (bytes read + written per
    second), best of 5."""
    name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        raise AssertionError("no published peak for %r in PEAKS" % name)
    src = torch.ones(COPY_BYTES // 4, device=DEVICE)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms = min(events_ms(lambda: dst.copy_(src), 10) for _ in range(5))
    rate = 2 * COPY_BYTES / (ms * 1e-3)
    log("[2 build] copy rate: %.1f GB/s (copy of %d bytes, %.4f ms); "
        "published peak %.1f GB/s" % (rate / 1e9, COPY_BYTES, ms,
                                     PEAKS[name]["bytes"] / 1e9))
    del src, dst
    return dict(PEAKS[name], copy=rate)


# --------------------------------------------------------------------------
# 3. kernels vs plain
# --------------------------------------------------------------------------

def _dia_on_card(vals, rows, cols, shape):
    from pykrylov_tpu_torch.sparse import formats as F
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=None)
    return F.dia_from_coo(coo, device=DEVICE)


def _hold(label, y, ref, dtype, tag="3 kernel"):
    """Hold a kernel's output against its plain version's."""
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise AssertionError("%s: kernel gave %s %s, plain %s %s"
                             % (label, tuple(y.shape), y.dtype,
                                tuple(ref.shape), ref.dtype))
    if not torch.isfinite(y).all():
        raise AssertionError("%s: non-finite kernel output" % label)
    err = relerr(y, ref)
    bound = REL_BOUND[dtype]
    log("[%s] %-44s rel err %.3e (bound %.0e), max abs err %.3e"
        % (tag, label, err, bound, (y - ref).abs().max().item()))
    if not err <= bound:
        raise AssertionError("%s: relative error %.3e > %.0e"
                             % (label, err, bound))
    return (y - ref).abs().max().item()


def _check_dia(cases, label, data, offsets, x, r, join=True):
    """The DIA SpMV kernel against its plain version, bit for bit, under a
    plan of ``r`` rows a thread; with ``join`` the matrix joins ``cases``
    for the SpMM checks of phases 3b and 3c."""
    from pykrylov_tpu_torch.sparse import kernels as K
    if join:
        cases.append((label, data, offsets))
    plan = K.dia_matvec_plan(data, offsets, x)
    if plan.r != r:
        raise AssertionError("%s: the plan took R=%d, not %d"
                             % (label, plan.r, r))
    y = K.dia_matvec(data, offsets, x)
    torch.cuda.synchronize()
    _exact("%s (R=%d, interior %d:%d)" % (label, *plan), y,
           K.dia_matvec_plain(data, offsets, x))


def _poison(data, offsets, n):
    """NaN and inf in every slot of ``data`` whose column lies outside
    [0, n): the kernel must skip those terms, not multiply them."""
    i = torch.arange(data.shape[1], device=data.device)
    for k, off in enumerate(offsets):
        out = torch.nonzero((i + off < 0) | (i + off >= n)).flatten()
        data[k, out[0::2]] = float("nan")
        data[k, out[1::2]] = float("inf")
    return data


DIA_ENTRIES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.float64, torch.float64), (torch.float32, torch.float64),
               (torch.bfloat16, torch.float64))


def _dia_plan_cases(cases, rng):
    """The SpMV plan's paths at all five entries, bit for bit: unsorted
    and repeated offsets with NaN and inf in every slot outside the
    matrix (row groups), x handed in as the contiguous view x[1:] and an
    m that R does not divide (both the scalar path, R = 1)."""
    m = 1 << 20
    offsets = (5, -3, 0, 5, -3, 1024, -1024)
    base = torch.from_numpy(rng.standard_normal((len(offsets), m))).to(DEVICE)
    xs = torch.from_numpy(rng.standard_normal(m + 1)).to(DEVICE)
    for storage, xdt in DIA_ENTRIES:
        name = "%s/%s" % (str(storage)[6:], str(xdt)[6:])
        data = _poison(base.to(storage, copy=True), offsets, m)
        x = xs.to(xdt)
        rw = 16 // data.element_size()
        _check_dia(cases, "DIA unsorted, NaN/inf outside, %s" % name, data,
                   offsets, x[:m], rw, join=False)
        _check_dia(cases, "DIA x as the view x[1:], %s" % name, data,
                   offsets, x[1:], 1, join=False)
        odd = _poison(base[:, :m - 1].to(storage, copy=True), offsets,
                      m - 1)
        _check_dia(cases, "DIA m %% R != 0, %s" % name, odd, offsets,
                   x[:m - 1], 1, join=False)


def phase_dia_kernel(pt):
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K

    rng = np.random.default_rng(1)
    cases = []
    for dtype in (torch.float64, torch.float32):
        nd = np.float64 if dtype == torch.float64 else np.float32
        dia = _dia_on_card(*poisson3d_coo(64, dtype=nd))
        x = torch.from_numpy(rng.standard_normal(dia.shape[1]).astype(nd))
        _check_dia(cases, "DIA poisson3d(64) %s" % str(dtype)[6:], dia.data,
                   dia.offsets, x.to(DEVICE), 16 // dtype.itemsize)
    dia = _dia_on_card(*poisson3d_coo(64, dtype=np.float32))
    d16 = dia.data.to(torch.bfloat16)
    x = torch.from_numpy(
        rng.standard_normal(dia.shape[1]).astype(np.float32)).to(DEVICE)
    _check_dia(cases, "DIA poisson3d(64) bf16 storage", d16, dia.offsets, x,
               8)

    # unsymmetric banded matrix with one far diagonal, and its transpose
    m = 100003
    offsets = (-70000, -3, 0, 2, 5, 131)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    for k, off in enumerate(offsets):
        i = np.arange(m)
        data[k, (i + off < 0) | (i + off >= m)] = 0.0
    dia = F.DIA(torch.from_numpy(data).to(DEVICE), offsets, (m, m))
    x = torch.from_numpy(
        rng.standard_normal(m).astype(np.float32)).to(DEVICE)
    _check_dia(cases, "DIA banded m=100003 A x", dia.data, dia.offsets, x, 1)
    diat = K.dia_transpose(dia)
    _check_dia(cases, "DIA banded m=100003 A^T x", diat.data, diat.offsets, x,
               1)
    # the transpose's product is A^T x up to the order of the sums
    _hold("DIA banded m=100003 A^T x against A's rmatvec",
          K.dia_matvec(diat.data, diat.offsets, x), F.dia_rmatvec(dia, x),
          torch.float32)
    _dia_plan_cases(cases, rng)

    # CG through the kernel on a small system: checks the solver on the
    # card and loads the library and torch kernels the DIA path's solve
    # uses, so that phase 4 times a warm solve
    A = K.cuda_dia_operator(_dia_on_card(*poisson3d_coo(64,
                                                         dtype=np.float32)),
                            symmetric=True)
    b = A * torch.ones(A.shape[0], device=DEVICE)
    res = pt.solve(A, b)
    log("[3 kernel] DIA solve at n=64: converged=%s n_iter=%d"
        % (bool(res.converged), int(res.n_iter)))
    if not bool(res.converged):
        raise AssertionError("CG did not converge at n=64")
    return cases


# bench.py's matrix classes (bench.py:278-340; bench.py imports jax, so
# they are copied here)
def gen_power_law(n=CLASS_ROWS, seed=0):
    """Heavy-tailed row degrees, banded locality + 5% uniform tail."""
    rng = np.random.default_rng(seed)
    deg = np.clip((rng.pareto(2.0, n) + 1).astype(int) * 3, 3, 400)
    rws = np.repeat(np.arange(n), deg)
    base = rws + rng.integers(-300, 301, rws.shape)
    far = rng.random(rws.shape) < 0.05
    cls = np.where(far, rng.integers(0, n, rws.shape), base) % n
    vls = rng.standard_normal(rws.shape).astype(np.float32)
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


def gen_stencil_scatter(n=CLASS_ROWS, spr=0.25, seed=1):
    """7-diagonal stencil + clustered long-range scatter into 64 hot
    128-column blocks."""
    rng = np.random.default_rng(seed)
    offs = np.array([-1024, -32, -1, 0, 1, 32, 1024])
    rws, cls, vls = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, n - o))
        rws.append(r)
        cls.append(r + o)
        vls.append(np.full(len(r), 6.0 if o == 0 else -1.0, np.float32))
    ns = int(spr * n)
    sr = rng.integers(0, n, ns)
    blocks = rng.integers(0, n // 128, 64)
    sc = blocks[rng.integers(0, 64, ns)] * 128 + rng.integers(0, 128, ns)
    rws.append(sr)
    cls.append(sc)
    vls.append(0.1 * rng.standard_normal(ns).astype(np.float32))
    rws, cls, vls = (np.concatenate(a) for a in (rws, cls, vls))
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


def gen_permuted_blockdiag(n=CLASS_ROWS, blk=192, seed=2):
    """Dense-ish coupling blocks scattered by a random permutation: the
    raw ordering exceeds the window budget, RCM rescues it."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    rws, cls, vls = [], [], []
    for b0 in range(0, n, blk):
        k = 6 * blk
        rr = rng.integers(b0, min(b0 + blk, n), k)
        cc = rng.integers(b0, min(b0 + blk, n), k)
        rws.append(perm[rr])
        cls.append(perm[cc])
        vls.append(0.1 * rng.standard_normal(k).astype(np.float32))
    rws, cls, vls = (np.concatenate(a) for a in (rws, cls, vls))
    key = rws.astype(np.int64) * n + cls
    _, first = np.unique(key, return_index=True)
    return vls[first], rws[first], cls[first], (n, n)


CLASSES = {"power_law": gen_power_law,
           "stencil_scatter": gen_stencil_scatter,
           "permuted_blockdiag": gen_permuted_blockdiag}


SE_TILES = 512      # areas of the state-estimation matrix (phase 10; 1024
                    # until PR 14 cut it to keep the smoke inside its time)
SE_PMU_EVERY = 100  # an angle (PMU) measurement at every 100th bus


def se_coo(tiles=SE_TILES, dtype=np.float32):
    """COO triples of the DC power-system state-estimation measurement
    matrix (Abur & Exposito, *Power System State Estimation*, 2004, ch.
    2-3) on ``tiles`` areas of the 1138bus grid.  Each area contributes,
    in this order: one injection row per bus (the bus's row of 1138bus),
    one flow row per branch, ``b_ij (theta_i - theta_j)`` with
    ``b_ij = -a_ij`` over the 1458 off-diagonal pairs i < j, and one angle
    row at every ``SE_PMU_EVERY``-th bus: 2608 rows by 1138 columns and
    6982 nonzeros an area.  The areas are stacked block-diagonally with
    their rows grouped, so every row of A^T stays inside its area."""
    from pykrylov_tpu_torch.io.datasets import load_bundled

    vals, rows, cols, (n, _) = load_bundled("1138bus")
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    up = rows < cols
    order = np.lexsort((cols[up], rows[up]))
    bi, bj, bv = rows[up][order], cols[up][order], -vals[up][order]
    nb = len(bi)
    pmu = np.arange(0, n, SE_PMU_EVERY, dtype=np.int64)
    m = n + nb + len(pmu)
    flow = n + np.arange(nb, dtype=np.int64)
    r = np.concatenate([rows, flow, flow, n + nb + np.arange(len(pmu))])
    c = np.concatenate([cols, bi, bj, pmu])
    v = np.concatenate([vals, bv, -bv, np.ones(len(pmu))])
    area = np.arange(tiles, dtype=np.int64)[:, None]
    return (np.tile(v, tiles).astype(dtype), (r + area * m).reshape(-1),
            (c + area * n).reshape(-1), (tiles * m, tiles * n))


BS_N = 128          # grid of phase 22's B-spline Laplacian (2,097,152 rows)
BS_ROUTE_N = 48     # grid of phase 22's route check (110,592 rows >= 65,536)
BS_MASS = (1, 26, 66, 26, 1)       # h / 120 times: int N_i N_{i+s}
BS_STIFF = (-1, -2, 6, -2, -1)     # 1 / (6 h) times: int N_i' N_{i+s}'
BS_ADVECT = (-1, -10, 0, 10, 1)    # 1 / 24 times: int N_i N_{i+s}'


def bspline_dia(n, dtype=torch.float32, device=None, drift=0.0):
    """The Galerkin Laplacian of uniform quadratic B-splines on an n x n x
    n grid (isogeometric analysis: Cottrell, Hughes & Bazilevs, 2009), in
    natural order (x slowest), as a DIA container built on ``device``
    without a COO:

        A = K (x) M (x) M  +  M (x) K (x) M  +  M (x) M (x) K
            + drift * D (x) M (x) M,

    with the 1-D rows M = h/120 [1, 26, 66, 26, 1], K = 1/(6h) [-1, -2, 6,
    -2, -1] and D = 1/24 [-1, -10, 0, 10, 1] (a first derivative along x,
    which makes A unsymmetric), h = 1/n, each truncated at the grid's
    ends.  125 diagonals at the ascending offsets a n^2 + b n + c, a, b, c
    in -2..2; every stored value is its coefficient (rounded once from f64
    to ``dtype``) or 0 where the column leaves the grid.  SPD for drift 0.
    """
    device = DEVICE if device is None else device
    f64 = torch.float64
    h = 1.0 / n
    one_d = [torch.tensor(v, dtype=f64) * w for v, w in (
        (BS_MASS, h / 120), (BS_STIFF, 1 / (6 * h)), (BS_ADVECT, 1 / 24))]
    mass, stiff, adv = one_d
    coef = (torch.einsum("a,b,c->abc", stiff, mass, mass)
            + torch.einsum("a,b,c->abc", mass, stiff, mass)
            + torch.einsum("a,b,c->abc", mass, mass, stiff)
            + drift * torch.einsum("a,b,c->abc", adv, mass, mass))
    shift = torch.arange(-2, 3, device=device)
    p = torch.arange(n, device=device)
    inside = ((p[None, :] + shift[:, None] >= 0)
              & (p[None, :] + shift[:, None] < n)).to(f64)     # (5, n)
    coef = coef.to(device)
    data = torch.empty((125, n ** 3), dtype=dtype, device=device)
    for a in range(5):         # a fifth of the diagonals at a time in f64
        block = (coef[a][:, :, None, None, None]
                 * inside[a][None, None, :, None, None]
                 * inside[:, None, None, :, None]
                 * inside[None, :, None, None, :])
        data[25 * a:25 * (a + 1)] = block.reshape(25, -1)
    offsets = tuple(a * n * n + b * n + c for a in range(-2, 3)
                    for b in range(-2, 3) for c in range(-2, 3))
    from pykrylov_tpu_torch.sparse import formats as F
    return F.DIA(data, offsets, (n ** 3, n ** 3))


def bspline_coo(n, drift=0.0, dtype=np.float64):
    """COO triples of :func:`bspline_dia` (its nonzeros, a diagonal after
    another), built on the host."""
    dia = bspline_dia(n, torch.float64, "cpu", drift)
    data = dia.data.numpy()
    k, rows = np.nonzero(data)
    cols = rows + np.asarray(dia.offsets, dtype=np.int64)[k]
    return data[k, rows].astype(dtype), rows, cols, dia.shape


def _banded(m, nnz_per_row, bw, seed, dtype):
    """Random banded triples, deduplicated."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=nnz_per_row * m)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=len(rows)),
                   0, m - 1)
    key = rows.astype(np.int64) * m + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(len(first)).astype(dtype)
    return vals, rows[first], cols[first], (m, m)


def _far_cluster(m, seed=51):
    """A band of width 13 plus ten entries 40 bands away: in a 16-band
    budget the far ones stay a COO remainder."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 4)
    cols = np.clip(rows + rng.integers(-6, 7, size=len(rows)), 0, m - 1)
    rows = np.r_[rows, np.arange(10)]
    cols = np.r_[cols, 40 * 128 + np.arange(10)]
    key = rows * m + cols
    _, first = np.unique(key, return_index=True)
    vals = rng.standard_normal(len(first)).astype(np.float32)
    return vals, rows[first], cols[first], (m, m)


def _exact(label, y, ref, tag="3 kernel"):
    """Hold a kernel's output against its plain version's, bit for bit."""
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise AssertionError("%s: kernel gave %s %s, plain %s %s"
                             % (label, tuple(y.shape), y.dtype,
                                tuple(ref.shape), ref.dtype))
    if not torch.isfinite(y).all():
        raise AssertionError("%s: non-finite kernel output" % label)
    if not torch.equal(y, ref):
        raise AssertionError("%s: kernel differs from plain (max abs %.3e)"
                             % (label, (y - ref).abs().max().item()))
    log("[%s] %-44s kernel = plain bit for bit" % (tag, label))


def _card_forms(levels, rows_out):
    """The card form of the levels at each sorting window, and the seconds
    the first derivation took."""
    from pykrylov_tpu_torch.sparse import sell as S
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cards = {S.SIGMA: S.sell_from_levels(levels, rows_out)}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for sigma in SIGMAS:
        if sigma not in cards:
            cards[sigma] = S.sell_from_levels(levels, rows_out, sigma=sigma)
    return cards, secs


def _check_levels(cases, label, levels, rows_out, n_in, rng):
    """The SELL kernel on the levels' card forms (each sorting window)
    against its plain version, bit for bit, and the card form's product
    against the container's own, on one random x; the levels join
    ``cases`` for the SpMM checks of phase 3b."""
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import sell as S
    cards, secs = _card_forms(levels, rows_out)
    nnz = int(cards[S.SIGMA].row_len.sum())
    log("[3 kernel] %s: card form of %d rows, %d entries, derived in %.3f "
        "s; fill %s" % (label, rows_out, nnz, secs, ", ".join(
            "%.3f at sigma %d" % (nnz / max(1, c.vals.numel()), sg)
            for sg, c in sorted(cards.items()))))
    cases.append((label, cards, levels, rows_out, n_in))
    dtype = levels[0].data.dtype
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.from_numpy(rng.standard_normal(n_in)).to(DEVICE, xdt)
    for sigma, card in sorted(cards.items()):
        y = S.sell_matvec(card, x)
        torch.cuda.synchronize()
        _exact("%s sigma %d" % (label, sigma), y, S.sell_matvec_plain(card, x))
    ref = B.bell_levels_matvec(levels, x, rows_out)
    torch.cuda.synchronize()
    return _hold("%s card vs container" % label, y, ref, dtype)


def phase_bell_kernel(pt):
    """The SELL kernel on the card form of every container variant the BELL
    packer emits."""
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import operator_from_coo

    rng = np.random.default_rng(2)
    classes = {}
    cases = []
    for name, gen in CLASSES.items():
        t = gen()
        t0 = time.perf_counter()
        A = operator_from_coo(*t, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if A.fmt != "bell":
            raise AssertionError("%s: auto policy picked %r, not bell"
                                 % (name, A.fmt))
        b0 = A.levels[0]
        log("[3 kernel] %s: %d rows, %d nnz, built in %.2f s: %d level(s), "
            "window %d, nb %d, nblk %d, data %s, %s, split rows %d, "
            "permuted %s, fill %.3f; card form %d bytes, BELL %d"
            % (name, t[3][0], len(t[0]), secs, len(A.levels), b0.window,
               b0.nb, b0.nblk, tuple(b0.data.shape),
               "segmented (%d wide)" % b0.seg_mixed if b0.seg is not None
               else "monolithic", A.split_rows,
               A.solve_permutation is not None, A.fill, A.card_bytes,
               A.stream_bytes))
        _check_levels(cases, "BELL %s levels" % name, A.levels, A.level_rows,
                      t[3][1], rng)
        x = torch.from_numpy(rng.standard_normal(t[3][1])
                             .astype(np.float32)).to(DEVICE)
        _hold("BELL %s operator" % name, A * x, A.plain() * x,
              torch.float32)
        classes[name] = (A, t)

    # explicit containers: index bytes, storage types, window 2, levels,
    # a COO remainder
    t = CLASSES["stencil_scatter"]()
    for label, dtype, kw in (
            ("int8 idx f32", np.float32, dict(window=1, idx_fmt="int8")),
            ("bf16 storage", np.float32, dict(window=1, bf16=True)),
            ("f64", np.float64, dict(window=1))):
        kw = dict(kw)
        bf16 = kw.pop("bf16", False)
        coo = F.coo_from_arrays(t[0].astype(dtype), t[1], t[2], t[3],
                                device=None)
        b = B.bell_from_coo(coo, spill_cost=None, segment=True,
                            device=DEVICE, **kw)
        if bf16:
            b = B.bell_with_values_dtype(b, torch.bfloat16)
        _check_levels(cases, "BELL stencil_scatter %s" % label, (b,), t[3][0],
                      t[3][1], rng)
    m = 1 << 16
    t = _banded(m, 8, 90, 1, np.float32)
    b = B.bell_from_coo(F.coo_from_arrays(*t, device=None), window=2,
                        spill_cost=None, device=DEVICE)
    _check_levels(cases, "BELL banded window 2 f32", (b,), m, m, rng)
    lv = B._pack_levels(F.coo_from_arrays(*t, device=None), B.NB_MAX,
                        12.0, 2, device=DEVICE, window=2)
    if len(lv) != 2:
        raise AssertionError("expected a two-level packing, got %d"
                             % len(lv))
    _check_levels(cases, "BELL banded two levels", lv, m, m, rng)
    t = _far_cluster(m)
    lv = B._pack_levels(F.coo_from_arrays(*t, device=None), 16, 12.0, 2,
                        device=DEVICE, window=1)
    if not lv[-1].nnz_spill:
        raise AssertionError("expected a COO remainder")
    _check_levels(cases, "BELL banded + %d-entry remainder"
                  % lv[-1].nnz_spill, lv, m, m, rng)
    return classes, cases


def _same_columns(label, Y, spmv, X):
    """Every column of a block product equals the SpMV kernel on that
    column, bit for bit."""
    for k in range(X.shape[1]):
        y = spmv(X[:, k].contiguous())
        if not torch.equal(Y[:, k], y):
            raise AssertionError(
                "%s: column %d differs from the SpMV kernel (max abs %.3e)"
                % (label, k, (Y[:, k] - y).abs().max().item()))


def phase_spmm_kernels(dia_cases, bell_cases, classes):
    """3b: the SpMM kernels against their plain versions, and column by
    column against the SpMV kernels, on phase 3's matrices."""
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S

    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    checks = 0
    for label, data, offsets in dia_cases:
        xdt = torch.float64 if data.dtype == torch.float64 \
            else torch.float32
        n = data.shape[1]
        for kb in DIA_MM_K:
            X = torch.from_numpy(rng.standard_normal((n, kb))).to(DEVICE, xdt)
            Y = K.dia_matmat(data, offsets, X)
            torch.cuda.synchronize()
            ref = K.dia_matmat_plain(data, offsets, X)
            _hold("%s K=%d" % (label, kb), Y, ref, data.dtype, tag="3b spmm")
            _same_columns(label, Y, lambda x: K.dia_matvec(data, offsets, x),
                          X)
            checks += 1
    for label, cards, levels, rows_out, n_in in bell_cases:
        dtype = levels[0].data.dtype
        xdt = torch.float64 if dtype == torch.float64 else torch.float32
        for kb in BELL_MM_K:
            X = torch.from_numpy(rng.standard_normal((n_in, kb))).to(DEVICE,
                                                                     xdt)
            for sigma, card in sorted(cards.items()):
                Y = S.sell_matmat(card, X)
                torch.cuda.synchronize()
                _exact("%s sigma %d K=%d" % (label, sigma, kb), Y,
                       S.sell_matmat_plain(card, X), tag="3b spmm")
                _same_columns(label, Y, lambda x: S.sell_matvec(card, x), X)
                checks += 1
            ref = B.bell_levels_matmat(levels, X, rows_out)
            _hold("%s K=%d card vs container" % (label, kb), Y, ref, dtype,
                  tag="3b spmm")
            del ref
    # the operators' block rules: the row split's fold and two-piece
    # transpose, the RCM operator's gathers
    for name in ("power_law", "permuted_blockdiag"):
        A, t = classes[name]
        X = torch.from_numpy(rng.standard_normal((t[3][1], KB)).astype(
            np.float32)).to(DEVICE)
        plain = A.plain()
        _hold("BELL %s operator A X" % name, A @ X, plain @ X,
              torch.float32, tag="3b spmm")
        _hold("BELL %s operator A^T X" % name, A.T @ X, plain.T @ X,
              torch.float32, tag="3b spmm")
    log("[3b spmm] %d block products held against plain and SpMV, every "
        "column bit for bit, in %.1f s" % (checks, time.perf_counter() - t0))


def phase_mixed_pairs(dia_cases, bell_cases):
    """3c: the four kernels with f32 and with bf16 storage against an f64
    x or X (the f32f64 and bf16f64 entries), on phase 3's matrices: each
    product equals its plain version (the widened data's f64 product) bit
    for bit, and each SpMM column the mixed SpMV on that column."""
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "3c mixed"
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    checks = 0
    for label, data, offsets in dia_cases:
        if data.dtype == torch.float64:
            continue
        storages = ((torch.bfloat16,) if data.dtype == torch.bfloat16
                    else (torch.float32, torch.bfloat16))
        for storage in storages:
            d = data.to(storage)
            name = "%s, %s data, f64 x" % (label, str(storage)[6:])
            x = torch.from_numpy(rng.standard_normal(d.shape[1])).to(DEVICE)
            y = K.dia_matvec(d, offsets, x)
            torch.cuda.synchronize()
            _exact(name, y, K.dia_matvec_plain(d, offsets, x), tag=tag)
            for kb in MIXED_K:
                X = torch.from_numpy(rng.standard_normal((d.shape[1], kb))).to(
                    DEVICE)
                Y = K.dia_matmat(d, offsets, X)
                torch.cuda.synchronize()
                _exact("%s K=%d" % (name, kb), Y,
                       K.dia_matmat_plain(d, offsets, X), tag=tag)
                _same_columns(name, Y, lambda v: K.dia_matvec(d, offsets, v),
                              X)
                checks += 1
    for label, cards, levels, rows_out, n_in in bell_cases:
        if levels[0].data.dtype == torch.float64:
            continue
        card = cards[S.SIGMA]
        for storage in (torch.float32, torch.bfloat16):
            c = card._replace(vals=card.vals.to(storage))
            name = "%s, %s values, f64 x" % (label, str(storage)[6:])
            x = torch.from_numpy(rng.standard_normal(n_in)).to(DEVICE)
            y = S.sell_matvec(c, x)
            torch.cuda.synchronize()
            _exact(name, y, S.sell_matvec_plain(c, x), tag=tag)
            for kb in MIXED_K:
                X = torch.from_numpy(rng.standard_normal((n_in, kb))).to(
                    DEVICE)
                Y = S.sell_matmat(c, X)
                torch.cuda.synchronize()
                _exact("%s K=%d" % (name, kb), Y, S.sell_matmat_plain(c, X),
                       tag=tag)
                _same_columns(name, Y, lambda v: S.sell_matvec(c, v), X)
                checks += 1
    log("[%s] %d mixed-pair block products and their SpMVs held against "
        "plain and, column by column, the mixed SpMV, bit for bit, in %.1f s"
        % (tag, checks, time.perf_counter() - t0))


# --------------------------------------------------------------------------
# 4-5. the main paths
# --------------------------------------------------------------------------

def _profile_solve(pt, tag, A, b, secs, n=None, **opts):
    """One more warm ``solve(A, b, **opts)`` under torch.profiler: device
    time by kernel per iteration (``n`` iterations, else the result's), and
    the device's idle share of ``secs``, the unprofiled solve's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = pt.solve(A, b, **opts)
        torch.cuda.synchronize()
    n = max(int(res.n_iter) if n is None else n, 1)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        raise AssertionError("%s: the profiler saw no device time" % tag)
    busy = sum(r[0] for r in rows) * 1e-6
    idle = max(0.0, 1 - busy / secs)
    log("[%s] profile: device busy %.4f ms per iteration over %d "
        "iterations; unprofiled wall %.4f ms per iteration, device idle "
        "%.1f%% of it; the profiled run and its reading took %.1f s"
        % (tag, 1e3 * busy / n, n, 1e3 * secs / n, 100 * idle,
           time.perf_counter() - t0))
    for us, count, key in rows[:8]:
        log("[%s] profile: %.4f ms per iteration, %.2f calls per "
            "iteration: %s" % (tag, us * 1e-3 / n, count / n, key[:80]))
    return {"busy_ms_per_iter": 1e3 * busy / n, "idle": idle}


def phase_dia_path(pt):
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.sparse.linop import SparseOperator

    t0 = time.perf_counter()
    coo = poisson3d_coo(N, dtype=np.float32)
    A = operator_from_coo(*coo, symmetric=True, device=DEVICE)
    torch.cuda.synchronize()
    m = A.shape[0]
    log("[4 DIA path] A: %d rows, %d nonzeros, fmt=%s, built in %.1f s"
        % (m, len(coo[0]), A.fmt, time.perf_counter() - t0))
    if A.fmt != "cuda-dia":
        raise AssertionError("auto policy picked %r, not cuda-dia" % A.fmt)
    data, offsets = A.container.data, A.container.offsets

    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(m)
                              .astype(np.float32)).to(DEVICE)
    b = A * x_true
    torch.cuda.synchronize()
    ref = K.dia_matvec_plain(data, offsets, x_true)
    err = (b - ref).abs().max().item()
    log("[4 DIA path] plan %s" % (K.dia_matvec_plan(data, offsets, x_true),))
    _exact("b = A x_true", b, ref, tag="4 DIA path")
    del ref

    # a short solve at full size first, so the timed one below is warm
    # (its allocations at this size are already cached)
    t0 = time.perf_counter()
    warm = pt.solve(A, b, maxiter=20)
    torch.cuda.synchronize()
    log("[4 DIA path] warm-up solve: %d iterations in %.3f s"
        % (int(warm.n_iter), time.perf_counter() - t0))
    del warm

    K.DIA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(A, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.DIA_LAUNCHES
    n_iter, n_matvec = int(res.n_iter), int(res.n_matvec)
    log("[4 DIA path] solve: converged=%s istop=%d n_iter=%d n_matvec=%d "
        "kernel launches=%d" % (bool(res.converged), int(res.istop),
                                n_iter, n_matvec, launches))
    log("[4 DIA path] solve: %.3f s, %.3f ms per iteration"
        % (secs, 1e3 * secs / max(n_iter, 1)))
    if not (bool(res.converged) and int(res.istop) == 0):
        raise AssertionError("solve did not converge: %r" % (res,))
    if launches != n_matvec or launches == 0:
        raise AssertionError("%d kernel launches for %d matvecs"
                             % (launches, n_matvec))
    if res.x.shape != (m,) or not torch.isfinite(res.x).all():
        raise AssertionError("bad solution: shape %s" % (tuple(res.x.shape),))
    b64 = b.double()
    r = b64 - K.dia_matvec_plain(data.double(), offsets, res.x.double())
    true_rel = (torch.linalg.vector_norm(r)
                / torch.linalg.vector_norm(b64)).item()
    x_err = (torch.linalg.vector_norm(res.x.double() - x_true.double())
             / torch.linalg.vector_norm(x_true.double())).item()
    log("[4 DIA path] true relative residual (f64) %.3e, relative error "
        "in x %.3e" % (true_rel, x_err))
    if not true_rel <= 1e-4:
        raise AssertionError("true relative residual %.3e > 1e-4"
                             % true_rel)
    del r, b64
    prof = _profile_solve(pt, "4 DIA path", A, b, secs)

    # the plain DIA operator over the same container (the products of
    # fmt="dia"), not built again from the triples
    t0 = time.perf_counter()
    A_plain = SparseOperator(A.container, None, symmetric=True, fmt="dia")
    before = K.DIA_LAUNCHES
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res_plain = pt.solve(A_plain, b)
    torch.cuda.synchronize()
    secs_plain = time.perf_counter() - t1
    n_plain = int(res_plain.n_iter)
    log("[4 DIA path] plain fmt=dia (built in %.1f s): converged=%s "
        "n_iter=%d, %.3f s, %.3f ms per iteration"
        % (t1 - t0, bool(res_plain.converged), n_plain, secs_plain,
           1e3 * secs_plain / max(n_plain, 1)))
    if K.DIA_LAUNCHES != before:
        raise AssertionError("the plain DIA operator launched the kernel")
    if abs(n_plain - n_iter) > 2:
        raise AssertionError("n_iter %d (kernel) vs %d (plain)"
                             % (n_iter, n_plain))
    return A, coo, {"launches": launches, "max_abs_err": err,
                    "n_iter": n_iter, "solve_s": secs, "plain_op": A_plain,
                    "b": b, "true_rel": true_rel, "profile": prof}


def _timed_solve(pt, label, A, b):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(A, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_iter = int(res.n_iter)
    log("[5 BELL path] %s: converged=%s istop=%d n_iter=%d n_matvec=%d, "
        "%.3f s, %.4f ms per iteration"
        % (label, bool(res.converged), int(res.istop), n_iter,
           int(res.n_matvec), secs, 1e3 * secs / max(n_iter, 1)))
    if not bool(res.converged):
        raise AssertionError("%s did not converge: %r" % (label, res))
    return res, secs


def phase_bell_path(pt):
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.sparse import sell as S

    t0 = time.perf_counter()
    coo = tiled_general_coo("1138bus", tiles=TILES, coupling=0)
    A = operator_from_coo(*coo, symmetric=True, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = A.shape[0]
    if A.fmt != "bell":
        raise AssertionError("auto policy picked %r, not bell" % A.fmt)
    levels = A.levels
    b0 = levels[0]
    log("[5 BELL path] A: %d rows, %d nonzeros, fmt=%s, built in %.2f s "
        "(tiling + host packing + transfer): %d level(s), window %d, "
        "nb %d, nblk %d, data %s, %s, fill %.4f, %.1f stream bytes per "
        "nonzero" % (m, len(coo[0]), A.fmt, build_s, len(levels),
                     b0.window, b0.nb, b0.nblk, tuple(b0.data.shape),
                     "segmented" if b0.seg is not None else "monolithic",
                     A.fill, A.bytes_per_nnz))
    card = A.card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S.sell_from_levels(levels, A.level_rows)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    log("[5 BELL path] card form (sigma %d): %d slots for %d entries "
        "(fill %.4f), %d bytes, %.1f per nonzero; derived in %.3f s (part "
        "of the build)" % (S.SIGMA, card.vals.numel(),
                           int(card.row_len.sum()),
                           int(card.row_len.sum()) / card.vals.numel(),
                           A.card_bytes, A.card_bytes / len(coo[0]), card_s))

    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(m)
                              .astype(np.float32)).to(DEVICE)
    b = A * x_true
    torch.cuda.synchronize()
    ref = S.sell_matvec_plain(card, x_true)
    _exact("5 BELL path: b = A x_true", b, ref, tag="5 BELL path")
    err = (b - ref).abs().max().item()
    ref = A.plain() * x_true
    log("[5 BELL path] b = A x_true: card form vs the BELL container's "
        "product rel err %.3e, max abs err %.3e"
        % (relerr(b, ref), (b - ref).abs().max().item()))
    if not relerr(b, ref) <= REL_BOUND[torch.float32]:
        raise AssertionError("the card form disagrees with the container")
    del ref

    t0 = time.perf_counter()
    warm = pt.solve(A, b, maxiter=20)
    torch.cuda.synchronize()
    log("[5 BELL path] warm-up solve: %d iterations in %.3f s"
        % (int(warm.n_iter), time.perf_counter() - t0))
    del warm

    S.SELL_LAUNCHES = 0
    res, secs = _timed_solve(pt, "solve", A, b)
    launches = S.SELL_LAUNCHES
    n_iter, n_matvec = int(res.n_iter), int(res.n_matvec)
    log("[5 BELL path] kernel launches=%d for %d matvecs (%d level(s), one "
        "card form)" % (launches, n_matvec, len(levels)))
    if launches != n_matvec or launches == 0:
        raise AssertionError("%d kernel launches for %d matvecs"
                             % (launches, n_matvec))
    if int(res.istop) != 0:
        raise AssertionError("solve stopped with istop %d" % int(res.istop))
    if res.x.shape != (m,) or not torch.isfinite(res.x).all():
        raise AssertionError("bad solution: shape %s" % (tuple(res.x.shape),))
    # the true residual in f64, through the COO triples (not the card)
    rows = torch.from_numpy(coo[1]).to(DEVICE)
    cols = torch.from_numpy(coo[2]).to(DEVICE)
    vals = torch.from_numpy(coo[0]).to(DEVICE, torch.float64)
    x64 = res.x.double()
    ax = torch.zeros(m, dtype=torch.float64, device=DEVICE)
    ax.index_add_(0, rows, vals * x64[cols])
    b64 = b.double()
    true_rel = (torch.linalg.vector_norm(b64 - ax)
                / torch.linalg.vector_norm(b64)).item()
    x_err = (torch.linalg.vector_norm(x64 - x_true.double())
             / torch.linalg.vector_norm(x_true.double())).item()
    log("[5 BELL path] true relative residual (f64) %.3e, relative error "
        "in x %.3e" % (true_rel, x_err))
    if not true_rel <= 1e-4:
        raise AssertionError("true relative residual %.3e > 1e-4"
                             % true_rel)
    del rows, cols, vals, x64, ax, b64
    cap = min(PROFILE_ITERS, n_iter)
    prof = _profile_solve(pt, "5 BELL path", A, b, secs * cap / n_iter,
                          maxiter=cap)

    before = S.SELL_LAUNCHES
    res_plain, secs_plain = _timed_solve(pt, "plain BELL", A.plain(), b)
    if S.SELL_LAUNCHES != before:
        raise AssertionError("the plain BELL operator launched the kernel")
    n_plain = int(res_plain.n_iter)
    if abs(n_plain - n_iter) > 0.1 * n_iter:
        raise AssertionError("n_iter %d (kernel) vs %d (plain): more than "
                             "10%% apart" % (n_iter, n_plain))

    # the same solve through the formats a user could pick instead: ELL
    # (plain torch, what the auto policy gave general matrices on CUDA
    # before the BELL kernel) and CSR (plain torch); in turns with the
    # kernel's, best of two each, since host-clock solve times drift
    others = {}
    for fmt in ("ell", "csr"):
        t0 = time.perf_counter()
        others[fmt] = operator_from_coo(*coo, symmetric=True, fmt=fmt,
                                        device=DEVICE)
        torch.cuda.synchronize()
        log("[5 BELL path] fmt=%s built in %.2f s"
            % (fmt, time.perf_counter() - t0))
    order = [("bell (kernel)", A)] + [("plain fmt=%s" % f, op)
                                      for f, op in others.items()]
    per_iter = {}
    for rep in range(2):
        for label, op in (order if rep == 0 else order[::-1]):
            res_k, secs_k = _timed_solve(pt, label, op, b)
            per_iter[label] = min(per_iter.get(label, float("inf")),
                                  1e3 * secs_k / max(int(res_k.n_iter), 1))
    log("[5 BELL path] ms per iteration, best of 2: %s" % ", ".join(
        "%s %.4f" % kv for kv in per_iter.items()))
    del others
    return A, coo, {"launches": launches, "max_abs_err": err,
                    "n_iter": n_iter, "solve_s": secs, "build_s": build_s,
                    "card_s": card_s, "plain_n_iter": n_plain,
                    "plain_solve_s": secs_plain, "ms_per_iter": per_iter,
                    "b": b, "profile": prof}


def _block_cg_passes(tag, label, n_iter):
    """The launches of block CG's passes (``csrc/block_cg.cu``) since the
    counts were set to 0, which a solve through ``cg_batched``'s fused
    loop without M makes 3 a block iteration: checked and returned."""
    from pykrylov_tpu_torch.solvers import block_cg as BC
    got = BC.BLOCK_CG_LAUNCHES
    log("[%s] %s: %d block CG launches for %d block iterations"
        % (tag, label, got, n_iter))
    if got != 3 * n_iter or got == 0:
        raise AssertionError("%s %s: %d block CG launches for %d block "
                             "iterations" % (tag, label, got, n_iter))
    return got


def _block_checks(pt, tag, A, Bm, res, ax64):
    """What phases 4b and 5b check of a block solve: convergence, a finite
    (n, K) solution, every column's true relative residual in f64 (``ax64``
    gives A X in f64), and every column's iterations within ITER_RTOL of a
    single solve of that column."""
    m, kb = Bm.shape
    if not (bool(res.converged.all()) and int(res.istop.max()) == 0):
        raise AssertionError("%s: block solve did not converge: istop %s"
                             % (tag, res.istop.tolist()))
    if res.x.shape != (m, kb) or not torch.isfinite(res.x).all():
        raise AssertionError("%s: bad solution: shape %s"
                             % (tag, tuple(res.x.shape)))
    b64 = Bm.double()
    r = b64 - ax64(res.x.double())
    true_rel = (torch.linalg.vector_norm(r, dim=0)
                / torch.linalg.vector_norm(b64, dim=0)).tolist()
    del r, b64
    log("[%s] true relative residual per column (f64): %s"
        % (tag, " ".join("%.3e" % v for v in true_rel)))
    if not max(true_rel) <= 1e-4:
        raise AssertionError("%s: true relative residual %.3e > 1e-4"
                             % (tag, max(true_rel)))
    cols = res.info["n_iter_columns"].tolist()
    singles = []
    for j in range(kb):
        one = pt.solve(A, Bm[:, j].contiguous())
        singles.append(int(one.n_iter))
        if not bool(one.converged):
            raise AssertionError("%s: single solve of column %d did not "
                                 "converge" % (tag, j))
    log("[%s] iterations per column, block / single: %s"
        % (tag, " ".join("%d/%d" % p for p in zip(cols, singles))))
    for j, (c, s1) in enumerate(zip(cols, singles)):
        if abs(c - s1) > ITER_RTOL * s1:
            raise AssertionError("%s: column %d took %d iterations in the "
                                 "block, %d alone" % (tag, j, c, s1))
    n_iter = int(res.n_iter)
    return {"n_iter": n_iter, "columns": cols, "singles": singles,
            "true_rel": max(true_rel)}


def _timed_block_solve(pt, A, Bm):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(A, Bm)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_dia_block(pt, A, dia):
    """4b: ``solve(A, B)`` for KB right-hand sides through the DIA SpMM
    kernel."""
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "4b DIA block"
    data, offsets = A.container.data, A.container.offsets
    m = A.shape[0]
    X_true = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, KB)).astype(np.float32)).to(DEVICE)
    Bm = A @ X_true
    torch.cuda.synchronize()
    ref = K.dia_matmat_plain(data, offsets, X_true)
    err = (Bm - ref).abs().max().item()
    plan = K.dia_matmat_plan(data, offsets, X_true)
    log("[%s] B = A X_true (%d x %d): kernel vs plain rel err %.3e, max "
        "abs err %.3e; SpMM plan V=%d T=%d Kc=%d"
        % (tag, m, KB, relerr(Bm, ref), err, plan.v, plan.rows, plan.kc))
    if not relerr(Bm, ref) <= REL_BOUND[torch.float32]:
        raise AssertionError("%s: kernel disagrees with plain" % tag)
    del ref
    warm = pt.solve(A, Bm, maxiter=20)
    torch.cuda.synchronize()
    del warm

    _reset_counts()
    res, secs = _timed_block_solve(pt, A, Bm)
    launches, spmv = K.DIA_MM_LAUNCHES, K.DIA_LAUNCHES
    n_iter, n_matvec = int(res.n_iter), int(res.n_matvec)
    log("[%s] solve: converged=%s n_iter=%d n_matvec=%d SpMM launches=%d "
        "SpMV launches=%d" % (tag, res.converged.tolist(), n_iter, n_matvec,
                              launches, spmv))
    if launches != n_matvec or launches == 0 or spmv != 0:
        raise AssertionError("%s: %d SpMM and %d SpMV launches for %d block "
                             "products" % (tag, launches, spmv, n_matvec))
    passes = _block_cg_passes(tag, "solve", n_iter)
    single_ms = 1e3 * dia["solve_s"] / max(dia["n_iter"], 1)
    out = _block_checks(
        pt, tag, A, Bm, res,
        lambda X: K.dia_matmat_plain(data.double(), offsets, X))
    per_iter = 1e3 * secs / max(n_iter, 1)
    log("[%s] solve: %.3f s, %.4f ms per block iteration, %.4f ms per "
        "column-iteration; single solve (phase 4) %.4f ms per iteration"
        % (tag, secs, per_iter, per_iter / KB, single_ms))
    cap = min(PROFILE_ITERS // 2, n_iter)
    _profile_solve(pt, tag, A, Bm, secs * cap / max(n_iter, 1), maxiter=cap)

    A_plain = dia.pop("plain_op")
    _reset_counts()
    res_p, secs_p = _timed_block_solve(pt, A_plain, Bm)
    n_p = int(res_p.n_iter)
    log("[%s] plain fmt=dia, column by column: converged=%s n_iter=%d, "
        "%.3f s, %.4f ms per block iteration"
        % (tag, res_p.converged.tolist(), n_p, secs_p,
           1e3 * secs_p / max(n_p, 1)))
    if (K.DIA_MM_LAUNCHES, K.DIA_LAUNCHES) != (0, 0):
        raise AssertionError("%s: the plain operator launched a kernel" % tag)
    passes += _block_cg_passes(tag, "plain fmt=dia solve", n_p)
    cols_p = res_p.info["n_iter_columns"].tolist()
    if any(abs(a - b) > ITER_RTOL * b for a, b in zip(out["columns"],
                                                        cols_p)):
        raise AssertionError("%s: iterations %s (kernel) vs %s (plain)"
                             % (tag, out["columns"], cols_p))
    out.update(launches=launches, max_abs_err=err, solve_s=secs,
               ms_per_iter=per_iter, plain_solve_s=secs_p,
               block_cg_launches=passes)
    return out


def phase_bell_block(pt, A, coo, bell):
    """5b: ``solve(A, B)`` for KB right-hand sides through the SELL SpMM
    kernel."""
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "5b BELL block"
    m = A.shape[0]
    X_true = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, KB)).astype(np.float32)).to(DEVICE)
    Bm = A @ X_true
    torch.cuda.synchronize()
    ref = S.sell_matmat_plain(A.card, X_true)
    _exact("%s: B = A X_true" % tag, Bm, ref, tag=tag)
    err = (Bm - ref).abs().max().item()
    ref = A.plain() @ X_true
    log("[%s] B = A X_true (%d x %d): card form vs the BELL container's "
        "product rel err %.3e, max abs err %.3e"
        % (tag, m, KB, relerr(Bm, ref), (Bm - ref).abs().max().item()))
    if not relerr(Bm, ref) <= REL_BOUND[torch.float32]:
        raise AssertionError("%s: the card form disagrees with the "
                             "container" % tag)
    del ref
    warm = pt.solve(A, Bm, maxiter=20)
    torch.cuda.synchronize()
    del warm

    _reset_counts()
    res, secs = _timed_block_solve(pt, A, Bm)
    launches, spmv = S.SELL_MM_LAUNCHES, S.SELL_LAUNCHES
    n_iter, n_matvec = int(res.n_iter), int(res.n_matvec)
    log("[%s] solve: converged=%s n_iter=%d n_matvec=%d SpMM launches=%d, "
        "SpMV launches=%d" % (tag, res.converged.tolist(), n_iter, n_matvec,
                              launches, spmv))
    if launches != n_matvec or launches == 0 or spmv != 0:
        raise AssertionError("%s: %d SpMM and %d SpMV launches for %d block "
                             "products" % (tag, launches, spmv, n_matvec))
    passes = _block_cg_passes(tag, "solve", n_iter)
    rows = torch.from_numpy(coo[1]).to(DEVICE)
    cols = torch.from_numpy(coo[2]).to(DEVICE)
    vals = torch.from_numpy(coo[0]).to(DEVICE, torch.float64)

    def ax64(X):
        out = torch.zeros((m, X.shape[1]), dtype=torch.float64, device=DEVICE)
        return out.index_add_(0, rows, vals[:, None] * X[cols])

    single_ms = 1e3 * bell["solve_s"] / max(bell["n_iter"], 1)
    out = _block_checks(pt, tag, A, Bm, res, ax64)
    del rows, cols, vals
    per_iter = 1e3 * secs / max(n_iter, 1)
    log("[%s] solve: %.3f s, %.4f ms per block iteration, %.4f ms per "
        "column-iteration; single solve (phase 5) %.4f ms per iteration"
        % (tag, secs, per_iter, per_iter / KB, single_ms))
    cap = min(PROFILE_ITERS // 2, n_iter)
    _profile_solve(pt, tag, A, Bm, secs * cap / max(n_iter, 1), maxiter=cap)

    # the plain BELL product streams the container on the host's plan
    # (25 ms a K = 8 block iteration): the first KB_CUT columns are enough
    # to hold the kernel's counts to it
    _reset_counts()
    res_p, secs_p = _timed_block_solve(pt, A.plain(),
                                       Bm[:, :KB_CUT].contiguous())
    n_p = int(res_p.n_iter)
    log("[%s] plain BELL, the first %d columns: converged=%s n_iter=%d, "
        "%.3f s, %.4f ms per block iteration"
        % (tag, KB_CUT, res_p.converged.tolist(), n_p, secs_p,
           1e3 * secs_p / max(n_p, 1)))
    if (S.SELL_MM_LAUNCHES, S.SELL_LAUNCHES) != (0, 0):
        raise AssertionError("%s: the plain operator launched a kernel" % tag)
    passes += _block_cg_passes(tag, "plain BELL solve", n_p)
    cols_p = res_p.info["n_iter_columns"].tolist()
    if any(abs(a - b) > ITER_RTOL * b for a, b in zip(out["columns"],
                                                        cols_p)):
        raise AssertionError("%s: iterations %s (kernel) vs %s (plain)"
                             % (tag, out["columns"], cols_p))
    out.update(launches=launches, max_abs_err=err, solve_s=secs,
               ms_per_iter=per_iter, plain_solve_s=secs_p,
               block_cg_launches=passes)
    return out


# --------------------------------------------------------------------------
# 8-9. indefinite and nonsymmetric systems
# --------------------------------------------------------------------------

COUNTERS = (("dia_spmv", "sparse.kernels", "DIA_LAUNCHES"),
            ("dia_spmm", "sparse.kernels", "DIA_MM_LAUNCHES"),
            ("sell_spmv", "sparse.sell", "SELL_LAUNCHES"),
            ("sell_spmm", "sparse.sell", "SELL_MM_LAUNCHES"),
            ("block_cg", "solvers.block_cg", "BLOCK_CG_LAUNCHES"))


def _reset_counts():
    import importlib
    for _, mod, attr in COUNTERS:
        setattr(importlib.import_module("pykrylov_tpu_torch." + mod), attr,
                0)


def _counts():
    import importlib
    return {name: getattr(importlib.import_module(
        "pykrylov_tpu_torch." + mod), attr)
        for name, mod, attr in COUNTERS}


def _counted_solve(tag, label, fn, kernel, expect=lambda res: 0):
    """``fn()`` with every launch count set to 0 just before and read just
    after; ``kernel``'s launches must equal the result's matvecs plus
    ``expect(res)``, and no other kernel may launch.  Returns (result,
    seconds, counts)."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    n_iter, n_mv = int(res.n_iter), int(res.n_matvec)
    log("[%s] %s: converged=%s istop=%d n_iter=%d n_matvec=%d, %d %s "
        "launches, %.3f s, %.4f ms per iteration"
        % (tag, label, bool(res.converged), int(res.istop), n_iter, n_mv,
           counts[kernel], kernel, secs, 1e3 * secs / max(n_iter, 1)))
    want = n_mv + expect(res)
    if counts[kernel] != want or want == 0:
        raise AssertionError("%s %s: %d %s launches for %d matvecs"
                             % (tag, label, counts[kernel], kernel, want))
    if any(v for k, v in counts.items() if k != kernel):
        raise AssertionError("%s %s: other kernels launched: %s"
                             % (tag, label, counts))
    if not torch.isfinite(res.x).all():
        raise AssertionError("%s %s: non-finite solution" % (tag, label))
    return res, secs, counts


def _true_rel(b, ax64, x):
    """``||b - A x|| / ||b||`` in f64, ``ax64`` giving A x in f64."""
    b64 = b.double()
    return (torch.linalg.vector_norm(b64 - ax64(x.double()))
            / torch.linalg.vector_norm(b64)).item()


def phase_indefinite(pt, coo):
    """8: a Helmholtz-shifted 3-D Poisson matrix at n = N, shifted midway
    between the Laplacian's two lowest eigenvalues (one negative
    eigenvalue), f32 storage on the DIA kernel: ``solve`` takes CG, which
    meets nonpositive curvature, then MINRES; then SYMMLQ.  b is standard
    normal (its part along the negative eigenvector is far above rtol) in
    f64, so the recurrences run in f64 through the f32f64 entry; the same
    MINRES on the f32 b shows why (its true residual is logged).  Returns
    the phase's numbers and (A, b), which phase 12 solves with."""
    from pykrylov_tpu_torch.gallery import poisson_eigenvalue_bounds
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import operator_from_coo

    tag = "8 indefinite"
    vals, rows, cols, shape = coo
    h = np.pi / (2 * (N + 1))
    l1 = poisson_eigenvalue_bounds(N, 3)[0]
    l2 = 8 * np.sin(h) ** 2 + 4 * np.sin(2 * h) ** 2
    sigma = 0.5 * (l1 + l2)
    t0 = time.perf_counter()
    shifted = np.where(rows == cols, vals - np.float32(sigma),
                       vals).astype(np.float32)
    A = operator_from_coo(shifted, rows, cols, shape, symmetric=True,
                          device=DEVICE)
    del shifted
    torch.cuda.synchronize()
    m = shape[0]
    log("[%s] A = poisson3d(%d) - sigma I, sigma %.6e between %.6e and "
        "%.6e: %d rows, fmt=%s, %s, built in %.1f s"
        % (tag, N, sigma, l1, l2, m, A.fmt, str(A.dtype)[6:],
           time.perf_counter() - t0))
    if A.fmt != "cuda-dia" or A.dtype != torch.float32:
        raise AssertionError("auto policy picked %r, %s" % (A.fmt, A.dtype))
    data, offsets = A.container.data, A.container.offsets

    def ax64(x):
        return K.dia_matvec_plain(data.double(), offsets, x)

    b = torch.from_numpy(np.random.default_rng(0).standard_normal(m)).to(
        DEVICE)
    s = torch.sin(torch.arange(1, N + 1, dtype=torch.float64,
                               device=DEVICE) * (np.pi / (N + 1)))
    v = (s[:, None, None] * s[None, :, None] * s[None, None, :]).reshape(-1)
    part = (torch.dot(v, b) / (torch.linalg.vector_norm(v)
                               * torch.linalg.vector_norm(b))).item()
    del s, v
    log("[%s] b standard normal (f64), part along the negative "
        "eigenvector %.3e of ||b||" % (tag, part))
    pt.cg(A, b, rtol=HELM_RTOL, maxiter=20)          # warm-ups
    pt.minres(A, b, rtol=HELM_RTOL, itnlim=20)
    pt.symmlq(A, b, rtol=HELM_RTOL, matvec_max=20)

    cg, cg_s, _ = _counted_solve(
        tag, "CG alone (check_curvature)",
        lambda: pt.cg(A, b, rtol=HELM_RTOL, check_curvature=True),
        "dia_spmv")
    if int(cg.istop) != 2:
        raise AssertionError("CG did not meet nonpositive curvature: %r"
                             % (cg,))
    cg_mv = int(cg.n_matvec)
    res, secs, counts = _counted_solve(
        tag, "solve (CG, then MINRES)",
        lambda: pt.solve(A, b, rtol=HELM_RTOL), "dia_spmv",
        expect=lambda r: cg_mv)
    if not (bool(res.converged) and "Acond" in res.info):
        raise AssertionError("the MINRES fallback did not converge: %r"
                             % (res,))
    true_rel = _true_rel(b, ax64, res.x)
    mr_it = int(res.n_iter)
    log("[%s] fallback: CG %d iterations to the trip (%.3f s), MINRES %d "
        "iterations (istop %d, about %.4f ms per iteration); true relative "
        "residual (f64) %.3e" % (tag, int(cg.n_iter), cg_s, mr_it,
                                 int(res.istop),
                                 1e3 * (secs - cg_s) / max(mr_it, 1),
                                 true_rel))
    if not true_rel <= 1e-4:
        raise AssertionError("true relative residual %.3e > 1e-4" % true_rel)
    prof = _profile_solve(pt, tag, A, b, secs, n=int(cg.n_iter) + mr_it,
                          rtol=HELM_RTOL)
    out = {"cg_iter": int(cg.n_iter), "cg_s": cg_s, "minres_iter": mr_it,
           "solve_s": secs, "true_rel": true_rel, "profile": prof,
           "launches": {"fallback": counts}}

    r32, s32, _ = _counted_solve(
        tag, "MINRES on the f32 b (the f32 recurrence)",
        lambda: pt.minres(A, b.float(), rtol=HELM_RTOL), "dia_spmv")
    out["f32_true_rel"] = _true_rel(b.float(), ax64, r32.x)
    log("[%s] the f32 recurrence: istop %d after %d iterations, true "
        "relative residual (f64) %.3e" % (tag, int(r32.istop),
                                          int(r32.n_iter),
                                          out["f32_true_rel"]))

    sres, ssecs, scounts = _counted_solve(
        tag, "solve(method='symmlq')",
        lambda: pt.solve(A, b, method="symmlq", rtol=HELM_RTOL), "dia_spmv")
    strue = _true_rel(b, ax64, sres.x)
    log("[%s] SYMMLQ: true relative residual (f64) %.3e" % (tag, strue))
    if not (bool(sres.converged) and strue <= 1e-4):
        raise AssertionError("SYMMLQ: %r, true relative residual %.3e"
                             % (sres, strue))
    out.update(symmlq_iter=int(sres.n_iter),
               symmlq_matvec=int(sres.n_matvec), symmlq_s=ssecs,
               symmlq_true_rel=strue,
               symmlq_profile=_profile_solve(
                   pt, tag + " symmlq", A, b,
                   ssecs * min(1, PROFILE_ITERS / sres.n_iter),
                   method="symmlq", rtol=HELM_RTOL,
                   matvec_max=PROFILE_ITERS + 1))
    out["launches"]["symmlq"] = scounts
    return out, (A, b)


def phase_minres_golden(pt, A, coo):
    """8b: MINRES's golden (1138bus with Jacobi, BASELINE config #2) on
    the card, over the tiled operator of phase 5 (BELL, f32 storage) with
    M = 1/max(|d|, 1) in f64, so every product goes through the SELL
    kernel's f32f64 entry.  b = A 1 / sqrt(TILES): MINRES's Anorm estimate
    takes in beta1, which grows as sqrt(TILES) with b = A 1; scaled so,
    beta1 and every stop test are the single matrix's, whose counts are
    412 iterations at rtol 1e-6 and 583-584 at 1e-8.  Returns the
    phase's numbers and (M, b), which phases 14c and 15c solve with."""
    from pykrylov_tpu_torch.io.datasets import load_bundled
    from pykrylov_tpu_torch.ops import DiagonalOperator

    tag = "8b MINRES golden"
    bv, br, bc, bshape = load_bundled("1138bus")
    d = np.zeros(bshape[0])
    np.add.at(d, br[br == bc], bv[br == bc])
    M = DiagonalOperator(torch.from_numpy(np.tile(
        1.0 / np.maximum(np.abs(d), 1.0), TILES)), device=DEVICE)
    m = A.shape[0]
    b = A * torch.full((m,), TILES ** -0.5, device=DEVICE)
    rows = torch.from_numpy(coo[1]).to(DEVICE)
    cols = torch.from_numpy(coo[2]).to(DEVICE)
    vals = torch.from_numpy(coo[0]).to(DEVICE, torch.float64)

    def ax64(x):
        out = torch.zeros(m, dtype=torch.float64, device=DEVICE)
        return out.index_add_(0, rows, vals * x[cols])

    pt.minres(A, b, M=M, rtol=1e-6, itnlim=20)       # warm-up
    out = {}
    for rtol, golden, code in ((1e-6, (412,), 1), (1e-8, (583, 584), 10)):
        res, secs, counts = _counted_solve(
            tag, "minres rtol %.0e" % rtol,
            lambda: pt.minres(A, b, M=M, rtol=rtol, itnlim=8000),
            "sell_spmv")
        true_rel = _true_rel(b, ax64, res.x)
        n_iter = int(res.n_iter)
        log("[%s] rtol %.0e: %d iterations (golden %s), istop %d, x %s, "
            "true relative residual (f64) %.3e"
            % (tag, rtol, n_iter, "-".join(map(str, golden)),
               int(res.istop), str(res.x.dtype)[6:], true_rel))
        if (res.x.dtype != torch.float64 or int(res.istop) != code
                or min(abs(n_iter - g) for g in golden) > 1):
            raise AssertionError("%s rtol %.0e: %r against %s"
                                 % (tag, rtol, res, golden))
        out["%.0e" % rtol] = {"n_iter": n_iter, "solve_s": secs,
                              "true_rel": true_rel, "launches": counts}
    del rows, cols, vals
    return out, (M, b)


def phase_nonsym(pt):
    """9: 2-D convection-diffusion at n = CD_N, |w| h = 1 and 0.5, f32
    storage on the DIA kernel, b = A x_true in f64 (the f32 recurrences
    stall above rtol 1e-6 on this system; the f32 BiCGSTAB below shows
    it): ``solve`` routes to BiCGSTAB; then CGS, TFQMR, and BiCGSTAB with
    an f64 Jacobi preconditioner.  Returns the phase's numbers and (the
    operator, its triples, b), which phases 10b, 11 and 13 solve with."""
    from pykrylov_tpu_torch.gallery import convdiff2d_coo
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import (jacobi_preconditioner,
                                           operator_from_coo)

    tag = "9 nonsymmetric"
    t0 = time.perf_counter()
    coo = convdiff2d_coo(CD_N, wx=CD_N + 1.0, wy=(CD_N + 1) / 2.0,
                         dtype=np.float32)
    A = operator_from_coo(*coo, device=DEVICE)
    torch.cuda.synchronize()
    m = A.shape[0]
    log("[%s] A = convdiff2d(%d, wx=%.1f, wy=%.1f): %d rows, %d nonzeros, "
        "fmt=%s, %s, built in %.1f s" % (tag, CD_N, CD_N + 1.0,
                                        (CD_N + 1) / 2.0, m, len(coo[0]),
                                        A.fmt, str(A.dtype)[6:],
                                        time.perf_counter() - t0))
    if A.fmt != "cuda-dia" or A.symmetric:
        raise AssertionError("auto policy picked %r" % A.fmt)
    data, offsets = A.container.data, A.container.offsets
    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(m)).to(
        DEVICE)
    b = A * x_true
    torch.cuda.synchronize()
    _exact("%s: b = A x_true (f32 data, f64 x)" % tag, b,
           K.dia_matvec_plain(data, offsets, x_true), tag=tag)
    M = jacobi_preconditioner((coo[0].astype(np.float64),) + coo[1:],
                              device=DEVICE)

    def ax64(x):
        return K.dia_matvec_plain(data.double(), offsets, x)

    runs = (("solve (BiCGSTAB)", {}), ("cgs", {"method": "cgs"}),
            ("tfqmr", {"method": "tfqmr"}),
            ("bicgstab, f64 Jacobi M", {"method": "bicgstab", "M": M}))
    for _, opts in runs:                                # warm-ups
        pt.solve(A, b, rtol=1e-6, matvec_max=20, **opts)
    out = {}
    for label, opts in runs:
        res, secs, counts = _counted_solve(
            tag, label, lambda: pt.solve(A, b, rtol=1e-6, **opts),
            "dia_spmv")
        true_rel = _true_rel(b, ax64, res.x)
        log("[%s] %s: true relative residual (f64) %.3e" % (tag, label,
                                                           true_rel))
        if int(res.istop) != 0 or not true_rel <= 1e-4:
            raise AssertionError("%s %s: %r, true relative residual %.3e"
                                 % (tag, label, res, true_rel))
        out[label] = {"n_iter": int(res.n_iter),
                      "n_matvec": int(res.n_matvec), "solve_s": secs,
                      "true_rel": true_rel, "launches": counts}
    bicg = out["solve (BiCGSTAB)"]
    cap = min(PROFILE_ITERS, bicg["n_iter"])
    out["profile"] = _profile_solve(pt, tag, A, b,
                                    bicg["solve_s"] * cap / bicg["n_iter"],
                                    rtol=1e-6, matvec_max=2 * cap)
    r32, _, _ = _counted_solve(
        tag, "BiCGSTAB on the f32 b, capped at 4000 matvecs",
        lambda: pt.bicgstab(A, b.float(), rtol=1e-6, matvec_max=4000),
        "dia_spmv")
    out["f32"] = {"istop": int(r32.istop), "n_matvec": int(r32.n_matvec),
                  "true_rel": _true_rel(b.float(), ax64, r32.x)}
    log("[%s] the f32 recurrence: istop %d after %d matvecs, true "
        "relative residual (f64) %.3e" % (tag, out["f32"]["istop"],
                                          out["f32"]["n_matvec"],
                                          out["f32"]["true_rel"]))
    return out, (A, coo, b)


def phase_bmark(pt):
    """9b: the reference's bmark (examples/bmark.py) on jpwh_991 tiled
    BMARK_TILES times, f64 storage, unsymmetric, through ``fmt="auto"``
    (``fmt="bell"`` if the policy refuses BELL): CGS, TFQMR and BiCGSTAB
    from x0 = tile(1 + arange(991)) to rtol 1e-8 with the per-tile cap
    matvec_max = 2 * 991, plain and with Jacobi floor=1.  The tiles are
    independent and equal, and every stop test of these solvers scales
    with them, so the counts are the single matrix's."""
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import (jacobi_preconditioner,
                                           operator_from_coo)

    tag = "9b bmark"
    t0 = time.perf_counter()
    coo = tiled_general_coo("jpwh_991", tiles=BMARK_TILES, coupling=0,
                            dtype=np.float64)
    A = operator_from_coo(*coo, symmetric=False, device=DEVICE)
    torch.cuda.synchronize()
    auto = A.fmt
    if A.fmt != "bell":
        A = operator_from_coo(*coo, symmetric=False, fmt="bell",
                              device=DEVICE)
        torch.cuda.synchronize()
    m = A.shape[0]
    log("[%s] A = jpwh_991 tiled %d times: %d rows, %d nonzeros, f64; "
        "fmt='auto' gave %r%s; built in %.1f s"
        % (tag, BMARK_TILES, m, len(coo[0]), auto,
           "" if auto == "bell" else " (_try_bell refused), so fmt='bell'",
           time.perf_counter() - t0))
    b = A * torch.ones(m, dtype=torch.float64, device=DEVICE)
    x0 = torch.arange(1, 992, dtype=torch.float64,
                      device=DEVICE).repeat(BMARK_TILES)
    M = jacobi_preconditioner(coo, floor=1.0, device=DEVICE)
    out = {"auto_fmt": auto}
    for name, refs in BMARK.items():
        fn = getattr(pt, name)
        for jac, ref in zip((False, True), refs):
            # CGS and TFQMR do not count the guess matvec; it launches
            res, secs, counts = _counted_solve(
                tag, "%s%s" % (name, ", Jacobi" if jac else ""),
                lambda: fn(A, b, x0=x0, M=M if jac else None, rtol=1e-8,
                           matvec_max=2 * 991),
                "sell_spmv", expect=lambda r: int(name != "bicgstab"))
            if not bool(res.converged) or \
                    abs(int(res.n_matvec) - ref) > BMARK_BOUND:
                raise AssertionError("%s %s: %r against %d matvecs"
                                     % (tag, name, res, ref))
            out["%s%s" % (name, "_jacobi" if jac else "")] = {
                "n_matvec": int(res.n_matvec), "ref": ref, "solve_s": secs,
                "launches": counts}
    del A, coo
    return out


# --------------------------------------------------------------------------
# 10. least squares: the SELL and DIA kernels in both directions
# --------------------------------------------------------------------------

LLS_TOL = 1e-6      # atol and btol of the least-squares solves (10, 10b)
CERT_BOUND = 1e-5   # bound on the f64 optimality certificates
SQD_BOUND = 1e-8    # bound on CRAIG's and CRAIG-MR's f64 certificates
LLS_PLAIN_ITERS = 200   # LSQR over the plain products against the kernels
# phase 10b's counts: the JAX package's LSQR, LSMR (damp 0.1), CRAIG and
# CRAIG-MR on this matrix in f64 (n = 128 and 256; size-independent)
LLS_COUNTS = {"lsqr": 367, "lsmr": 190, "craig": 129, "craigmr": 120}
LLS_COUNT_RTOL = 0.05


def _initial_launch(res):
    """The launches a least-squares solve makes besides its counted
    matvecs: ``gk_init``'s transpose product A'u, which ``n_matvec = 2
    n_iter`` leaves out (``solvers/lls_common.py``), as the reference
    does."""
    return 1


def _lls_solve(pt, tag, label, fn, kernel, out, check, codes=None):
    """One counted least-squares solve, ``check(res)`` giving its
    certificates (name -> (value, bound)); every certificate within its
    bound and the stop code in ``codes`` (where given), or the phase
    fails.  Records the run in ``out[label]``."""
    res, secs, counts = _counted_solve(tag, label, fn, kernel,
                                       expect=_initial_launch)
    certs = check(res)
    n_iter = int(res.n_iter)
    log("[%s] %s: %d iterations, istop %d, %.3f s, %.4f ms per iteration; "
        "%s" % (tag, label, n_iter, int(res.istop), secs,
                1e3 * secs / max(n_iter, 1),
                ", ".join("%s %.3e (bound %.0e)" % (k, v, bnd)
                          for k, (v, bnd) in certs.items())))
    bad = {k: v for k, (v, bnd) in certs.items() if not v <= bnd}
    if (bad or res.x.dtype != torch.float64
            or (codes is not None and int(res.istop) not in codes)):
        raise AssertionError("%s %s: %r, certificates %s" % (tag, label, res,
                                                             certs))
    out[label] = {"n_iter": n_iter, "istop": int(res.istop),
                  "n_matvec": int(res.n_matvec), "solve_s": secs,
                  "ms_per_iter": 1e3 * secs / max(n_iter, 1),
                  "launches": counts,
                  "certificates": {k: v for k, (v, _) in certs.items()}}
    return res


def _direction_timing(tag, directions, rates):
    """Device ms of one SpMV kernel in each direction the least-squares
    path runs: ``directions`` maps a label ("A", "A^T") to (kernel, plain,
    torch CSR tensor, coo-free sizes (rows out, columns in, nnz), matrix
    bytes as the kernel stores it).  Each direction is timed with f32 x
    (kernel and torch CSR, whose matvec is the library's call) and with
    f64 x (the f32f64 entry the solves run, and its plain version: no
    library call multiplies f32 values by an f64 x), against its bounds:
    the smaller of the kernel's and CSR's matrix bytes plus x and y, at
    the published memory rate, or 2 nnz operations at the f32 (f64) rate
    if longer."""
    out = {}
    g = torch.Generator(device=DEVICE).manual_seed(4000)
    for label, (kern, plain, csr, (rows, cols, nnz), own) in \
            directions.items():
        x = torch.randn(cols, device=DEVICE, generator=g)
        x64 = x.double()
        variants = [("kernel f32", lambda: kern(x)),
                    ("kernel f32/f64", lambda: kern(x64)),
                    ("plain f32/f64", lambda: plain(x64)),
                    ("torch CSR f32", lambda: csr @ x)]
        best = _best_ms(variants, 50, host_waits=("plain f32/f64",))
        csr_matrix = nnz * 8 + (rows + 1) * 4
        b32 = _bound(min(own, csr_matrix) + 4 * (rows + cols), 2 * nnz,
                     rates)
        b64 = _bound(min(own, csr_matrix) + 8 * (rows + cols), 2 * nnz,
                     rates, "f64")
        log("[%s] %-4s SpMV: kernel %.4f ms (f32 x), %.4f (f64 x); plain "
            "%.4f (f64 x); torch CSR %.4f (f32); bound %.4f ms (%s) f32, "
            "%.4f (%s) f64 x: kernel at %.1f%% and %.1f%% of them"
            % (tag, label, best["kernel f32"], best["kernel f32/f64"],
               best["plain f32/f64"], best["torch CSR f32"], b32["bound_ms"],
               b32["bound_by"], b64["bound_ms"], b64["bound_by"],
               100 * b32["bound_ms"] / best["kernel f32"],
               100 * b64["bound_ms"] / best["kernel f32/f64"]))
        out[label] = {"ms": best["kernel f32"],
                      "mixed_ms": best["kernel f32/f64"],
                      "mixed_plain_ms": best["plain f32/f64"],
                      "library_ms": best["torch CSR f32"],
                      "bound_ms": b32["bound_ms"],
                      "bound_by": b32["bound_by"],
                      "mixed_bound_ms": b64["bound_ms"],
                      "mixed_bound_by": b64["bound_by"]}
        del x, x64, variants
    return out


def phase_lls_sell(pt, rates):
    """10: the DC state-estimation matrix (:func:`se_coo`, SE_TILES areas,
    f32 storage), rectangular and of general sparsity: ``fmt="auto"`` must
    give a ``BellOperator`` with SELL card forms of A and of A^T (no ELL
    transpose, no row split, no permutation); both kernels bit for bit
    their plain versions on one x, f32 and f64; ``solve`` (LSMR) and
    ``lsqr`` at atol = btol = LLS_TOL with etol = 0 on b = A x_true + 1%
    noise in f64, each istop 1 or 2 with SELL launches = matvecs + 1 and
    the optimality certificate ``||A'r|| / (||A||_F ||r||)`` in f64
    through the plain products at most CERT_BOUND; a profiled run of the
    first PROFILE_ITERS iterations of each;
    then LSQR capped at LLS_PLAIN_ITERS over an operator whose products are
    the plain versions on the same card forms, which must give the kernel
    run's istop 7 and its x bit for bit.  Returns the phase's numbers and
    (A, its triples, b), which phase 13 solves with."""
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "10 least squares, SELL"
    t0 = time.perf_counter()
    coo = se_coo(SE_TILES)
    A = operator_from_coo(*coo, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m, n = A.shape
    log("[%s] A = state estimation on 1138bus, %d areas: %d x %d, %d "
        "nonzeros, f32; fmt=%s, built in %.1f s"
        % (tag, SE_TILES, m, n, len(coo[0]), A.fmt, build_s))
    if (not isinstance(A, B.BellOperator) or A.cards is None
            or set(A.cards) != {"fwd", "bwd"}
            or A._args["bwd_ell"] is not None or A.split_rows
            or A.solve_permutation is not None):
        raise AssertionError("%s: fmt='auto' gave %r, not SELL card forms "
                             "of A and A^T" % (tag, A))
    fwd, bwd = A.cards["fwd"], A.cards["bwd"]
    log("[%s] card forms: A %d bytes, A^T %d bytes" % (
        tag, S.sell_bytes(fwd), S.sell_bytes(bwd)))
    g = torch.Generator(device=DEVICE).manual_seed(10)
    for name, card, width in (("A", fwd, n), ("A^T", bwd, m)):
        x = torch.randn(width, device=DEVICE, generator=g)
        for xx in (x, x.double()):
            _exact("%s x, %s x" % (name, str(xx.dtype)[6:]),
                   S.sell_matvec(card, xx), S.sell_matvec_plain(card, xx),
                   tag=tag)

    rng = np.random.default_rng(0)
    x_true = torch.from_numpy(rng.standard_normal(n)).to(DEVICE)
    ax = S.sell_matvec_plain(fwd, x_true)
    b = ax + 0.01 * ax.abs().mean() * torch.from_numpy(
        rng.standard_normal(m)).to(DEVICE)
    fro = float(np.sqrt((coo[0].astype(np.float64) ** 2).sum()))

    def certificate(res):
        r = b - S.sell_matvec_plain(fwd, res.x)
        return {"||A'r||/(||A||_F ||r||)": (
            (torch.linalg.vector_norm(S.sell_matvec_plain(bwd, r))
             / (fro * torch.linalg.vector_norm(r))).item(), CERT_BOUND)}

    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0}
    runs = (("solve (LSMR)", {}), ("lsqr", {"method": "lsqr"}))
    for _, extra in runs:                               # warm-ups
        pt.solve(A, b, itnlim=20, **opts, **extra)
    out = {"build_s": build_s, "shape": [m, n],
           "card_bytes": [S.sell_bytes(fwd), S.sell_bytes(bwd)]}
    for label, extra in runs:
        _lls_solve(pt, tag, label,
                   lambda: pt.solve(A, b, **opts, **extra), "sell_spmv",
                   out, certificate, codes=(1, 2))
        n_iter = out[label]["n_iter"]
        cap = min(PROFILE_ITERS, n_iter)
        out[label]["profile"] = _profile_solve(
            pt, "%s, %s" % (tag, label), A, b,
            out[label]["solve_s"] * cap / n_iter, itnlim=cap, **opts,
            **extra)

    # the same LSQR over the plain products on the same card forms
    plain = pt.LinearOperator(n, m,
                              matvec=lambda x: S.sell_matvec_plain(fwd, x),
                              matvec_transp=lambda x: S.sell_matvec_plain(
                                  bwd, x),
                              dtype=A.dtype, device=A.device)
    capped = dict(opts, itnlim=LLS_PLAIN_ITERS)
    label = "lsqr, itnlim=%d" % LLS_PLAIN_ITERS
    kern, _, counts = _counted_solve(tag, label,
                                     lambda: pt.lsqr(A, b, **capped),
                                     "sell_spmv", expect=_initial_launch)
    out[label] = {"launches": counts}
    _reset_counts()
    ref = pt.lsqr(plain, b, **capped)
    torch.cuda.synchronize()
    if any(_counts().values()):
        raise AssertionError("%s: the plain products launched %s"
                             % (tag, _counts()))
    same = torch.equal(kern.x, ref.x)
    log("[%s] lsqr over the plain products, itnlim=%d: istop %d and %d, x "
        "bit for bit the kernels' run: %s" % (tag, LLS_PLAIN_ITERS,
                                             int(kern.istop),
                                             int(ref.istop), same))
    if not (int(kern.istop) == int(ref.istop) == 7 and same):
        raise AssertionError("%s: the kernels' LSQR differs from the plain "
                             "products' (%r, %r)" % (tag, kern, ref))
    vals, rows, cols, _ = coo
    out["timing"] = _direction_timing(tag, {
        "A": (lambda x: S.sell_matvec(fwd, x),
              lambda x: S.sell_matvec_plain(fwd, x),
              _torch_csr((vals, rows, cols, (m, n)), DEVICE),
              (m, n, len(vals)), S.sell_bytes(fwd)),
        "A^T": (lambda x: S.sell_matvec(bwd, x),
                lambda x: S.sell_matvec_plain(bwd, x),
                _torch_csr((vals, cols, rows, (n, m)), DEVICE),
                (n, m, len(vals)), S.sell_bytes(bwd))}, rates)
    del plain
    return out, (A, coo, b)


def phase_lls_dia(pt, A, coo, rates):
    """10b: phase 9's convection-diffusion operator (``cuda-dia``, f32
    storage; its transpose is the DIA kernel on ``dia_transpose``), b = A
    x_true in f64: LSQR and LSMR with damp = 0.1 at atol = btol = LLS_TOL,
    CRAIG at btol 1e-8 and etol 1e-10, CRAIG-MR at etol 1e-10.  Each
    within LLS_COUNT_RTOL of the JAX package's count (LLS_COUNTS), with DIA
    launches = matvecs + 1 and its certificates in f64 through the plain
    products: damped LSQR and LSMR ``||A'r - damp^2 x|| / (||A||_F
    ||[r; damp x]||)`` at most CERT_BOUND; CRAIG ``||b - Ax - r||/||b||``
    and ``||A'r - x||/||x||``, CRAIG-MR ``||(AA' + I) y - b||/||b||``, at
    most SQD_BOUND.  A profiled run of each."""
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "10b least squares, DIA"
    if A.fmt != "cuda-dia" or A.symmetric:
        raise AssertionError("%s: operator is %r" % (tag, A.fmt))
    data, offsets = A.container.data, A.container.offsets
    t = K.dia_transpose(A.container)
    m = A.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(11)
    x = torch.randn(m, device=DEVICE, generator=g)
    for xx in (x, x.double()):
        _exact("A^T x, %s x" % str(xx.dtype)[6:], A.T * xx,
               K.dia_matvec_plain(t.data, t.offsets, xx), tag=tag)

    def ax(v):
        return K.dia_matvec_plain(data, offsets, v)

    def atx(v):
        return K.dia_matvec_plain(t.data, t.offsets, v)

    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(
        m)).to(DEVICE)
    b = ax(x_true)
    fro = float(np.sqrt((coo[0].astype(np.float64) ** 2).sum()))
    bn = torch.linalg.vector_norm(b).item()
    damp = 0.1

    def damped(res):
        r = b - ax(res.x)
        num = atx(r) - damp * damp * res.x
        den = fro * torch.sqrt(torch.linalg.vector_norm(r) ** 2
                               + (damp * torch.linalg.vector_norm(res.x))
                               ** 2)
        return {"||A'r - damp^2 x||/(||A||_F ||[r; damp x]||)": (
            (torch.linalg.vector_norm(num) / den).item(), CERT_BOUND)}

    def sqd(res):
        r = res.info["r"]
        return {"||b - Ax - r||/||b||": (
                    torch.linalg.vector_norm(b - ax(res.x) - r).item() / bn,
                    SQD_BOUND),
                "||A'r - x||/||x||": (
                    (torch.linalg.vector_norm(atx(r) - res.x)
                     / torch.linalg.vector_norm(res.x)).item(), SQD_BOUND)}

    def dual(res):
        y = res.x
        return {"||(AA' + I)y - b||/||b||": (
            torch.linalg.vector_norm(ax(atx(y)) + y - b).item() / bn,
            SQD_BOUND)}

    runs = (("lsqr", {"damp": damp, "atol": LLS_TOL, "btol": LLS_TOL},
             damped),
            ("lsmr", {"damp": damp, "atol": LLS_TOL, "btol": LLS_TOL},
             damped),
            ("craig", {"btol": 1e-8, "etol": 1e-10}, sqd),
            ("craigmr", {"etol": 1e-10}, dual))
    for method, opts, _ in runs:                        # warm-ups
        pt.solve(A, b, method=method, itnlim=20, **opts)
    out = {}
    for method, opts, check in runs:
        res = _lls_solve(pt, tag, method,
                         lambda: pt.solve(A, b, method=method, **opts),
                         "dia_spmv", out, check)
        ref = LLS_COUNTS[method]
        if abs(int(res.n_iter) - ref) > LLS_COUNT_RTOL * ref:
            raise AssertionError("%s %s: %d iterations against the JAX "
                                 "package's %d" % (tag, method,
                                                   int(res.n_iter), ref))
        out[method]["ref"] = ref
        out[method]["profile"] = _profile_solve(
            pt, "%s, %s" % (tag, method), A, b, out[method]["solve_s"],
            method=method, **opts)
    vals, rows, cols, _ = coo
    own = len(offsets) * m * 4
    out["timing"] = _direction_timing(tag, {
        "A": (lambda x: K.dia_matvec(data, offsets, x),
              lambda x: K.dia_matvec_plain(data, offsets, x),
              _torch_csr(coo, DEVICE), (m, m, len(vals)), own),
        "A^T": (lambda x: K.dia_matvec(t.data, t.offsets, x),
                lambda x: K.dia_matvec_plain(t.data, t.offsets, x),
                _torch_csr((vals, cols, rows, (m, m)), DEVICE),
                (m, m, len(vals)), own)}, rates)
    return out


# --------------------------------------------------------------------------
# 11-13. blocks of right-hand sides through the batched solvers
# --------------------------------------------------------------------------

BLOCK_PLAIN_ITERS = 100     # block iterations of the plain-product runs
# profiled block iterations a solve (the profiler's cost grows with the
# events it keeps, ~40-100 kernels a block iteration; 25 keeps the whole
# smoke, phases 14-15 and 21 included, within its time)
BLOCK_PROFILE_ITERS = 25
# block products a batched solve makes in k block iterations
# (solvers/batched.py): the SpMM launches it must count, A and A^T
BLOCK_PRODUCTS = {"bicgstab": lambda k: 2 * k, "cgs": lambda k: 2 * k,
                  "tfqmr": lambda k: 2 * k + 1, "minres": lambda k: k,
                  "symmlq": lambda k: k + 2, "lsqr": lambda k: 2 * k + 1,
                  "lsmr": lambda k: 2 * k + 1, "craig": lambda k: 2 * k + 1,
                  "craigmr": lambda k: 2 * k + 1,
                  # phases 16b and 17a: the pipelined twin (its last
                  # iteration's product too), cg_batched with the Chebyshev
                  # preconditioner (degree - 1 products an apply)
                  "cg_pipelined": lambda k: k + 1,
                  "cg_cheb": lambda k: k + (CHEB_DEGREE - 1) * (k + 1)}
# launches of block CG's passes (csrc/block_cg.cu) a block iteration of
# the routes that run cg_batched's fused loop: 4 with a preconditioner
BLOCK_CG_PASSES = {"cg_cheb": 4}
# column 0 against the single solve of the same b: CGS's and TFQMR's
# counts swing with the rounding order (phase 9's CGS takes 46% of the JAX
# package's count on this system), the others within ITER_RTOL
COL0_RTOL = {"cgs": 0.25, "tfqmr": 0.25}
# the per-column cap that stands for a block-iteration cap
CAP_OPTION = {"bicgstab": "maxiter", "cgs": "maxiter", "tfqmr": "maxiter",
              "minres": "itnlim", "symmlq": "matvec_max", "lsqr": "itnlim",
              "lsmr": "itnlim", "craig": "itnlim", "craigmr": "itnlim",
              "cg_pipelined": "maxiter", "cg_cheb": "maxiter"}


def _block_of(b, k=KB):
    """The (n, k) f64 block of a block phase: column 0 is the single
    phase's b, the other k - 1 columns standard normal from seed 0
    (torch's generator on the device)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rest = torch.randn((b.shape[0], k - 1), generator=g, device=DEVICE,
                       dtype=torch.float64)
    return torch.cat([b.double()[:, None], rest], dim=1)


def _plain_block_op(pt, A):
    """``A`` with the plain versions of its kernels as its products, on the
    same DIA containers (A and ``dia_transpose``) or SELL card forms
    (``cards["fwd"]`` and ``cards["bwd"]``)."""
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S
    if getattr(A, "cards", None) is not None:
        fwd = A.cards["fwd"]
        bwd = A.cards.get("bwd", fwd)       # a symmetric matrix has one
        rules = (lambda x: S.sell_matvec_plain(fwd, x),
                 lambda x: S.sell_matvec_plain(bwd, x),
                 lambda X: S.sell_matmat_plain(fwd, X),
                 lambda X: S.sell_matmat_plain(bwd, X))
    else:
        c = A.container
        t = c if A.symmetric else K.dia_transpose(c)
        rules = (lambda x: K.dia_matvec_plain(c.data, c.offsets, x),
                 lambda x: K.dia_matvec_plain(t.data, t.offsets, x),
                 lambda X: K.dia_matmat_plain(c.data, c.offsets, X),
                 lambda X: K.dia_matmat_plain(t.data, t.offsets, X))
    return pt.LinearOperator(A.shape[1], A.shape[0], matvec=rules[0],
                             matvec_transp=rules[1], symmetric=A.symmetric,
                             dtype=A.dtype, device=A.device,
                             matmat=rules[2], matmat_transp=rules[3])


def _col_rel(num, den):
    """Per-column ``||num|| / ||den||`` of two (n, K) blocks, host floats."""
    return (torch.linalg.vector_norm(num, dim=0)
            / torch.linalg.vector_norm(den, dim=0)).tolist()


def _block_solve(pt, tag, label, name, A, Bm, opts, kernel, single, check,
                 out):
    """One batched solve, ``solve(A, Bm, **opts)`` (``opts`` names the
    method but for the default route), with every launch count set to 0
    just before and read just after: ``kernel``'s launches must be the
    solver's block products (``BLOCK_PRODUCTS``), block CG's passes those
    of ``BLOCK_CG_PASSES``, no other kernel may launch; every column converged, its certificates (``check(res)``:
    name -> (per-column values, bound)) within their bound, and column 0's
    count within COL0_RTOL of ``single`` = (count, ms per iteration), the
    earlier phase's single solve of the same b.  Then a profiled run of the
    first BLOCK_PROFILE_ITERS block iterations.  Records ``out[label]``."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(A, Bm, **opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    k = int(res.n_iter)
    want = BLOCK_PRODUCTS[name](k)
    key = ("n_iter_columns" if "n_iter_columns" in res.info
           else "n_matvec_columns")
    cols = res.info[key].tolist()
    ms = 1e3 * secs / max(k, 1)
    s_count, s_ms = single
    log("[%s] %s: %d block iterations, istop %s, %s %s (single solve of "
        "column 0: %d); %d %s launches for %d block products; %.3f s, %.4f "
        "ms per block iteration, %.4f ms per column-iteration (single "
        "solve %.4f ms per iteration)"
        % (tag, label, k, res.istop.tolist(), key, cols, s_count,
           counts[kernel], kernel, want, secs, ms, ms / Bm.shape[1], s_ms))
    if counts[kernel] != want or want == 0:
        raise AssertionError("%s %s: %d %s launches for %d block products"
                             % (tag, label, counts[kernel], kernel, want))
    passes = BLOCK_CG_PASSES.get(name, 0) * k
    if counts["block_cg"] != passes:
        raise AssertionError("%s %s: %d block CG launches for %d"
                             % (tag, label, counts["block_cg"], passes))
    if any(v for kk, v in counts.items() if kk not in (kernel, "block_cg")):
        raise AssertionError("%s %s: other kernels launched: %s"
                             % (tag, label, counts))
    if (res.x.dtype != torch.float64 or res.x.shape[1] != Bm.shape[1]
            or not torch.isfinite(res.x).all()):
        raise AssertionError("%s %s: bad solution %s %s" % (
            tag, label, tuple(res.x.shape), res.x.dtype))
    certs = check(res)
    for cname, (vals, bound) in certs.items():
        log("[%s] %s: %s per column (bound %.0e): %s" % (
            tag, label, cname, bound, " ".join("%.3e" % v for v in vals)))
    bad = [c for c, (vals, bound) in certs.items()
           if not max(vals) <= bound]
    rtol = COL0_RTOL.get(name, ITER_RTOL)
    if bad or not bool(res.converged.all()):
        raise AssertionError("%s %s: %r, certificates over their bound: %s"
                             % (tag, label, res, bad))
    if abs(cols[0] - s_count) > rtol * s_count:
        raise AssertionError("%s %s: column 0 took %d, the single solve %d "
                             "(more than %.0f%% apart)"
                             % (tag, label, cols[0], s_count, 100 * rtol))
    cap = min(BLOCK_PROFILE_ITERS, k)
    popts = dict(opts)
    popts[CAP_OPTION[name]] = (cap if name != "symmlq"
                               else cap + 1)     # its init spends one
    prof = _profile_solve(pt, "%s, %s" % (tag, label), A, Bm,
                          secs * cap / max(k, 1), **popts)
    out[label] = {"kernel": kernel, "n_iter": k, "columns": cols,
                  "single": s_count,
                  "single_ms_per_iter": s_ms, "solve_s": secs,
                  "ms_per_iter": ms,
                  "ms_per_column_iter": ms / Bm.shape[1],
                  "launches": counts, "profile": prof,
                  "istop": res.istop.tolist(),
                  "certificates": {c: max(v) for c, (v, _) in certs.items()}}
    return res


def _plain_equal(pt, tag, name, A, Bm, opts, out):
    """The batched solver ``name`` capped at BLOCK_PLAIN_ITERS block
    iterations through the kernels and through their plain versions on
    the same containers (:func:`_plain_block_op`): x bit for bit."""
    from pykrylov_tpu_torch import solvers as PS
    solver = getattr(PS, name + "_batched")
    capped = dict(opts, **{CAP_OPTION[name]: BLOCK_PLAIN_ITERS})
    kern = solver(A, Bm, **capped)
    plain = _plain_block_op(pt, A)
    _reset_counts()
    ref = solver(plain, Bm, **capped)
    torch.cuda.synchronize()
    if any(_counts().values()):
        raise AssertionError("%s: the plain products launched %s"
                             % (tag, _counts()))
    same = (torch.equal(kern.x, ref.x) and torch.equal(kern.istop, ref.istop)
            and int(kern.n_iter) == int(ref.n_iter))
    log("[%s] %s_batched capped at %d block iterations, kernels and plain "
        "products: %d and %d block iterations, x bit for bit: %s"
        % (tag, name, BLOCK_PLAIN_ITERS, int(kern.n_iter), int(ref.n_iter),
           same))
    if not same:
        raise AssertionError("%s: the kernels' %s_batched differs from the "
                             "plain products'" % (tag, name))
    out["plain_%s" % name] = {"n_iter": int(kern.n_iter), "equal": same}


def phase_block_nonsym(pt, A, coo, b, single):
    """11: phase 9's convection-diffusion operator (DIA, f32 storage) with
    a K = KB_CUT f64 block whose column 0 is phase 9's b: ``solve(A, B)`` (the
    default route, ``bicgstab_batched``), CGS and TFQMR at rtol 1e-6,
    every block product through the DIA SpMM kernel; each column's true
    relative residual in f64 at most 1e-4, column 0's matvecs against
    phase 9's; BiCGSTAB capped through the plain products."""
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "11 unsymmetric blocks"
    data, offsets = A.container.data, A.container.offsets
    Bm = _block_of(b, KB_CUT)

    def true_rel(res):
        r = Bm - K.dia_matmat_plain(data.double(), offsets, res.x)
        return {"||b - Ax||/||b||": (_col_rel(r, Bm), 1e-4)}

    runs = (("solve (bicgstab_batched)", "bicgstab", {}, "solve (BiCGSTAB)"),
            ("cgs_batched", "cgs", {"method": "cgs"}, "cgs"),
            ("tfqmr_batched", "tfqmr", {"method": "tfqmr"}, "tfqmr"))
    for _, name, opts, _ in runs:                       # warm-ups
        pt.solve(A, Bm, rtol=1e-6, maxiter=10, **opts)
    out = {}
    for label, name, opts, ref in runs:
        s = single[ref]
        _block_solve(pt, tag, label, name, A, Bm, dict(opts, rtol=1e-6),
                     "dia_spmm",
                     (s["n_matvec"], 1e3 * s["solve_s"] / s["n_iter"]),
                     true_rel, out)
    _plain_equal(pt, tag, "bicgstab", A, Bm, {"rtol": 1e-6}, out)
    return out


def phase_block_indefinite(pt, A, b, single):
    """12: phase 8's Helmholtz-shifted Poisson operator (DIA, f32 storage,
    one negative eigenvalue) with a K = KB_CUT f64 block whose column 0
    is phase 8's b: ``solve(A, B, method="minres")`` and SYMMLQ at
    HELM_RTOL through the DIA SpMM kernel; each column's true relative
    residual in f64 at most 1e-4, column 0's count against phase 8's
    MINRES (after CG's trip) and SYMMLQ; MINRES capped through the plain
    products.  MINRES runs with etol = 0: its direct-error window (istop
    10, a convergence code) stops some standard-normal columns of this
    system at half the iterations, above the 1e-4 bound, while phase 8's
    b stops on rtol (istop 1) either way."""
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "12 indefinite blocks"
    data, offsets = A.container.data, A.container.offsets
    Bm = _block_of(b, KB_CUT)

    def true_rel(res):
        r = Bm - K.dia_matmat_plain(data.double(), offsets, res.x)
        return {"||b - Ax||/||b||": (_col_rel(r, Bm), 1e-4)}

    opts = {"minres": {"rtol": HELM_RTOL, "etol": 0.0},
            "symmlq": {"rtol": HELM_RTOL}}
    for name in ("minres", "symmlq"):                   # warm-ups
        pt.solve(A, Bm, method=name, **opts[name],
                 **{CAP_OPTION[name]: 10})
    out = {}
    mr_s = single["solve_s"] - single["cg_s"]
    for label, name, s_count, s_ms in (
            ("solve(method='minres')", "minres", single["minres_iter"],
             1e3 * mr_s / single["minres_iter"]),
            ("symmlq_batched", "symmlq", single["symmlq_matvec"],
             1e3 * single["symmlq_s"] / single["symmlq_iter"])):
        _block_solve(pt, tag, label, name, A, Bm,
                     dict(opts[name], method=name), "dia_spmm",
                     (s_count, s_ms), true_rel, out)
    _plain_equal(pt, tag, "minres", A, Bm, opts["minres"], out)
    return out


def _spmm_transpose_timing(tag, kern, plain, csr, sizes, own, rates):
    """Device ms of one SpMM kernel on A^T at K = KB: with an f32 block
    (kernel and torch's CSR SpMM, cuSPARSE, the library's call) and with an
    f64 block (the f32f64 entry the block solves run, and its plain
    version), against the bounds: the smaller of the kernel's and CSR's
    matrix bytes plus K columns of X and Y, at the published memory rate,
    or 2 nnz K operations at the f32 (f64) rate if longer."""
    rows, cols, nnz = sizes
    g = torch.Generator(device=DEVICE).manual_seed(5000)
    X = torch.randn((cols, KB), device=DEVICE, generator=g)
    X64 = X.double()
    best = _best_ms([("kernel f32", lambda: kern(X)),
                     ("kernel f32/f64", lambda: kern(X64)),
                     ("plain f32/f64", lambda: plain(X64)),
                     ("torch CSR SpMM f32", lambda: torch.sparse.mm(csr, X))],
                    20, host_waits=("plain f32/f64",))
    matrix = min(own, nnz * 8 + (rows + 1) * 4)
    b32 = _bound(matrix + 4 * KB * (rows + cols), 2 * nnz * KB, rates)
    b64 = _bound(matrix + 8 * KB * (rows + cols), 2 * nnz * KB, rates,
                 "f64")
    log("[%s] A^T SpMM, K=%d: kernel %.4f ms (f32 block), %.4f (f64 "
        "block); plain %.4f (f64); torch CSR SpMM %.4f (f32); bound %.4f ms "
        "(%s) f32, %.4f (%s) f64: kernel at %.1f%% and %.1f%% of them"
        % (tag, KB, best["kernel f32"], best["kernel f32/f64"],
           best["plain f32/f64"], best["torch CSR SpMM f32"],
           b32["bound_ms"], b32["bound_by"], b64["bound_ms"],
           b64["bound_by"], 100 * b32["bound_ms"] / best["kernel f32"],
           100 * b64["bound_ms"] / best["kernel f32/f64"]))
    return {"k": KB, "ms": best["kernel f32"],
            "mixed_ms": best["kernel f32/f64"],
            "mixed_plain_ms": best["plain f32/f64"],
            "library_ms": best["torch CSR SpMM f32"],
            "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
            "mixed_bound_ms": b64["bound_ms"],
            "mixed_bound_by": b64["bound_by"]}


def phase_block_lls(pt, se, cd, single_se, single_cd, rates):
    """13: the least-squares blocks.  Phase 10's state-estimation operator
    (SELL card forms of A and A^T) with a K = KB_CUT f64 block whose
    column 0 is phase 10's b: ``solve(A, B)`` (the rectangular default,
    ``lsqr_batched``) and LSMR at atol = btol = LLS_TOL, etol = 0, every
    product through the SELL SpMM kernel on ``cards["fwd"]`` and
    ``cards["bwd"]``; each column's ``||A'r||/(||A||_F ||r||)`` in f64
    at most CERT_BOUND; LSQR capped through the plain products.  Phase 9's
    convection-diffusion operator with a block whose column 0 is phase
    10b's b: CRAIG (btol 1e-8, etol 1e-10) and CRAIG-MR (etol 1e-10)
    through the DIA SpMM kernel on A and on ``dia_transpose(A)``, each
    column's SQD residuals at most SQD_BOUND; CRAIG capped through the
    plain products.  Each column 0's count against phase 10's or 10b's,
    and each SpMM timed on A^T at K = KB."""
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "13 least-squares blocks"
    A, coo, b = se
    m, n = A.shape
    fwd, bwd = A.cards["fwd"], A.cards["bwd"]
    Bm = _block_of(b, KB_CUT)
    fro = float(np.sqrt((coo[0].astype(np.float64) ** 2).sum()))

    def certificate(res):
        r = Bm - S.sell_matmat_plain(fwd, res.x)
        ar = torch.linalg.vector_norm(S.sell_matmat_plain(bwd, r), dim=0)
        return {"||A'r||/(||A||_F ||r||)": (
            (ar / (fro * torch.linalg.vector_norm(r, dim=0))).tolist(),
            CERT_BOUND)}

    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0}
    for method in (None, "lsmr"):                       # warm-ups
        pt.solve(A, Bm, method=method, itnlim=10, **opts)
    out = {}
    for label, name, method, ref in (
            ("solve (lsqr_batched)", "lsqr", None, "lsqr"),
            ("lsmr_batched", "lsmr", "lsmr", "solve (LSMR)")):
        s = single_se[ref]
        _block_solve(pt, tag, label, name, A, Bm,
                     dict(opts, method=method), "sell_spmm",
                     (s["n_iter"], s["ms_per_iter"]), certificate, out)
    _plain_equal(pt, tag, "lsqr", A, Bm, opts, out)
    vals, rows, cols, _ = coo
    out["sell_transpose"] = _spmm_transpose_timing(
        tag + ", SELL", lambda X: S.sell_matmat(bwd, X),
        lambda X: S.sell_matmat_plain(bwd, X),
        _torch_csr((vals, cols, rows, (n, m)), DEVICE), (n, m, len(vals)),
        S.sell_bytes(bwd), rates)
    del Bm

    A, coo, b = cd
    m = A.shape[0]
    data, offsets = A.container.data, A.container.offsets
    t = K.dia_transpose(A.container)
    Bm = _block_of(b, KB_CUT)
    bn = torch.linalg.vector_norm(Bm, dim=0)

    def ax(X):
        return K.dia_matmat_plain(data, offsets, X)

    def atx(X):
        return K.dia_matmat_plain(t.data, t.offsets, X)

    def sqd(res):
        r = res.info["r"]
        return {"||b - Ax - r||/||b||": (
                    (torch.linalg.vector_norm(Bm - ax(res.x) - r, dim=0)
                     / bn).tolist(), SQD_BOUND),
                "||A'r - x||/||x||": (_col_rel(atx(r) - res.x, res.x),
                                      SQD_BOUND)}

    def dual(res):
        y = res.x
        return {"||(AA' + I)y - b||/||b||": (
            (torch.linalg.vector_norm(ax(atx(y)) + y - Bm, dim=0)
             / bn).tolist(), SQD_BOUND)}

    runs = (("craig_batched", "craig", {"btol": 1e-8, "etol": 1e-10}, sqd),
            ("craigmr_batched", "craigmr", {"etol": 1e-10}, dual))
    for _, name, o, _ in runs:                          # warm-ups
        pt.solve(A, Bm, method=name, itnlim=10, **o)
    for label, name, o, check in runs:
        s = single_cd[name]
        _block_solve(pt, tag, label, name, A, Bm, dict(o, method=name),
                     "dia_spmm", (s["n_iter"], s["ms_per_iter"]), check, out)
    _plain_equal(pt, tag, "craig", A, Bm, runs[0][2], out)
    vals, rows, cols, _ = coo
    out["dia_transpose"] = _spmm_transpose_timing(
        tag + ", DIA", lambda X: K.dia_matmat(t.data, t.offsets, X),
        lambda X: K.dia_matmat_plain(t.data, t.offsets, X),
        _torch_csr((vals, cols, rows, (m, m)), DEVICE), (m, m, len(vals)),
        len(t.offsets) * m * 4, rates)
    return out


# --------------------------------------------------------------------------
# 14-15. verified arithmetic: refinement legs, ff-CG, ff-MINRES, and the
# verified block twins, on the operators of phases 4-13
# --------------------------------------------------------------------------

VER_RTOL = 1e-6         # the verified target of phases 14-15
# a solver's verified residual against the independent f64 check, relative,
# beside the verifier's own rounding: without a compensated product its two
# applies round in the working dtype, eps ||(|A| |x|)|| / ||b|| (:func:
# `_rel_check`), which an f32 block column of the convection-diffusion
# matrix (standard normal b, a large x) puts at 1.8e-6 of ||b||
VER_AGREE = 1e-2
# iterations of each profiled window (the profiler's cost grows with the
# events it keeps: the ff solves launch 75-1290 kernels an iteration)
VER_PROFILE_ITERS = 40
# the profiled window of a refinement driver: two legs of at most half the
# window each (a first leg to rtol 1e-2 may take only a few iterations)
LEG_WINDOW = {"max_legs": 2, "leg_maxiter": VER_PROFILE_ITERS // 2}
VER_PLAIN_ITERS = 100   # ff-CG's and ff-MINRES's plain-product runs
VER_PLAIN_LEGS = 2      # the refinement drivers' plain-product runs, each
                        # leg capped at VER_PLAIN_ITERS
# a BiCGSTAB refinement leg (14b, 15b) is capped at the work the earlier
# phase's unverified solve of the same b took to reach rtol from scratch
# (the single solver's cap is in matvecs, the block twin's in block
# iterations): a leg whose tightened rtol the f32 recurrence cannot reach
# otherwise runs to the solver's default cap of 2n (8.4M here), and a cap
# of 2000 block iterations stopped four f32 columns and one f64 column at
# their first leg's 1e-2 (istop 3, on an NVIDIA H100 80GB HBM3); a capped
# leg ends, is verified, and counts towards the driver's precision floor
CD_MAX_LEGS = 6
# legs of 15b's f32 block attempt: its columns that stall do so after their
# first leg (five columns at 1e-2 after six legs, 70 s, on an NVIDIA H100
# 80GB HBM3), so three legs show the outcome at half the cost
CD_F32_BLOCK_LEGS = 3
# (label, where a profiled kernel's name says what it is)
PROFILE_GROUPS = (("kernel", ("spmv_kernel", "spmm_kernel")),
                  ("reductions", ("reduce",)),
                  ("elementwise", ("elementwise",)))


def _profile_call(tag, fn, wall_per_iter):
    """One run of ``fn()`` (a verified solve capped at VER_PROFILE_ITERS
    iterations) under torch.profiler: device ms per iteration of the four
    kernels, of the ff elementwise passes and of the reductions, busy, the
    unprofiled wall (``wall_per_iter``, the full solve's) and the idle
    share of it, and the launches an iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    n = max(int(res.n_iter), 1)
    groups = {label: 0.0 for label, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        launches += e.count
        label = next((g for g, keys in PROFILE_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[label] += e.self_device_time_total * 1e-3 / n
    busy = sum(groups.values())
    if busy == 0:
        raise AssertionError("%s: the profiler saw no device time" % tag)
    out = {k + "_ms": v for k, v in groups.items()}
    out.update(busy_ms_per_iter=busy, wall_ms_per_iter=wall_per_iter,
               idle=max(0.0, 1 - busy / wall_per_iter),
               launches_per_iter=launches / n, iterations=n)
    log("[%s] profile of %d iterations, ms per iteration: kernel %.4f, ff "
        "elementwise %.4f, reductions %.4f, other %.4f; busy %.4f, wall "
        "%.4f, idle %.1f%%; %.1f launches per iteration"
        % (tag, n, groups["kernel"], groups["elementwise"],
           groups["reductions"], groups["other"], busy, wall_per_iter,
           100 * out["idle"], out["launches_per_iter"]))
    return out


def _verified(tag, label, fn, kernel, launches_of, codes, check, profile,
              unverified, out):
    """One verified solve ``fn()`` with every launch count set to 0 just
    before and read just after: ``kernel``'s launches must equal the
    products the loop issued (``launches_of(res)``), no other kernel may
    launch, the stop code must be in ``codes``, and ``check(res)`` (name ->
    (independent f64 values, the solver's verified values, bound, the
    verifier's rounding floors), a value per column for a block) must hold
    every independent value within its bound and the solver's within
    VER_AGREE of the larger of the two plus the floor.  Then ``profile()``,
    the
    same solve capped at VER_PROFILE_ITERS, under the profiler.
    ``unverified`` = (seconds, true residual) of the earlier phase's
    unverified solve of the same right-hand side, logged beside.  Records
    ``out[label]`` and returns the result."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    n_iter, n_mv = int(res.n_iter), int(res.n_matvec)
    info = res.info
    legs = info.get("n_legs")
    nrep = info.get("n_replacements")
    nrep = None if nrep is None else (int(nrep) if nrep.ndim == 0
                                      else nrep.tolist())
    istop = res.istop.tolist()
    want = launches_of(res)
    log("[%s] %s: istop %s, %s%d iterations, %s%d matvecs, %d %s launches "
        "(%d products issued), %.3f s, %.4f ms per iteration"
        % (tag, label, istop, "" if legs is None else "%d legs, " % legs,
           n_iter, "" if nrep is None else "replacements %s, " % (nrep,),
           n_mv, counts[kernel], kernel, want, secs,
           1e3 * secs / max(n_iter, 1)))
    if counts[kernel] != want or want == 0:
        raise AssertionError("%s %s: %d %s launches for %d products"
                             % (tag, label, counts[kernel], kernel, want))
    if any(v for k, v in counts.items() if k != kernel):
        raise AssertionError("%s %s: other kernels launched: %s"
                             % (tag, label, counts))
    if not (torch.isfinite(res.x).all() and torch.isfinite(
            info["x_lo"]).all()):
        raise AssertionError("%s %s: non-finite solution" % (tag, label))
    certs = check(res)
    for name, (vals, claimed, bound, floor) in certs.items():
        log("[%s] %s: %s (f64, independent) %s, the solver's %s (bound "
            "%.0e; the verifier's rounding %s)"
            % (tag, label, name, " ".join("%.3e" % v for v in vals),
               " ".join("%.3e" % v for v in claimed), bound,
               " ".join("%.1e" % f for f in floor)))
    codes_ok = all(c in codes for c in (istop if isinstance(istop, list)
                                        else [istop]))
    bad = [name for name, (vals, claimed, bound, floor) in certs.items()
           if not (max(vals) <= bound and all(
               abs(c - v) <= VER_AGREE * max(v, c) + f
               for v, c, f in zip(vals, claimed, floor)))]
    u_s, u_rel = unverified
    log("[%s] %s: to the verified target in %.3f s; the unverified solve "
        "of the same b: %.3f s, true relative residual %.3e"
        % (tag, label, secs, u_s, u_rel))
    if bad or not codes_ok:
        raise AssertionError("%s %s: istop %s, checks failed: %s (%r)"
                             % (tag, label, istop, bad, certs))
    out[label] = {"istop": istop, "n_legs": legs, "n_iter": n_iter,
                  "n_replacements": nrep, "n_matvec": n_mv,
                  "launches": counts, "kernel": kernel, "solve_s": secs,
                  "ms_per_iter": 1e3 * secs / max(n_iter, 1),
                  "unverified_s": u_s, "unverified_true_rel": u_rel,
                  "checks": {k: max(v[0]) for k, v in certs.items()}}
    out[label]["profile"] = _profile_call(
        "%s, %s" % (tag, label), profile, 1e3 * secs / max(n_iter, 1))
    return res


def _plain_same(tag, label, fn, A, plain, out):
    """``fn(op)`` capped, through the kernels (``A``) and through their
    plain versions on the same containers (``plain``): x and x_lo bit for
    bit, and the plain products launch nothing."""
    kern = fn(A)
    _reset_counts()
    ref = fn(plain)
    torch.cuda.synchronize()
    if any(_counts().values()):
        raise AssertionError("%s: the plain products launched %s"
                             % (tag, _counts()))
    same = (torch.equal(kern.x, ref.x)
            and torch.equal(kern.info["x_lo"], ref.info["x_lo"])
            and int(kern.n_iter) == int(ref.n_iter))
    log("[%s] %s through the kernels and through the plain products: %d "
        "and %d iterations, x and x_lo bit for bit: %s"
        % (tag, label, int(kern.n_iter), int(ref.n_iter), same))
    if not same:
        raise AssertionError("%s: %s differs from the plain products' run"
                             % (tag, label))
    out["plain " + label] = {"n_iter": int(kern.n_iter), "equal": same}


def _rel_check(b, ax64, absax64):
    """A ``check`` of :func:`_verified`: the independent f64 relative
    residual of ``x + x_lo`` (``ax64`` gives A x in f64) against the
    solver's verified ``resid_norm / ||b||``, per column for a block, and
    the rounding of a verification in the solve's dtype, ``eps ||(|A|
    |x|)|| / ||b||`` (``absax64`` gives |A| x in f64)."""
    b64 = b.double()
    bn = torch.linalg.vector_norm(b64, dim=0)

    def check(res):
        x = res.x.double() + res.info["x_lo"].double()
        rel = torch.linalg.vector_norm(b64 - ax64(x), dim=0) / bn
        claimed = res.resid_norm.double() / bn
        floor = (torch.finfo(res.x.dtype).eps
                 * torch.linalg.vector_norm(absax64(x.abs()), dim=0) / bn)
        return {"||b - Ax||/||b||": (rel.reshape(-1).tolist(),
                                     claimed.reshape(-1).tolist(), VER_RTOL,
                                     floor.reshape(-1).tolist())}
    return check


def _dia_f64(A, absolute=False):
    """A x (|A| x) in f64 through the DIA kernel's plain version, for a
    vector or a block."""
    from pykrylov_tpu_torch.sparse import kernels as K
    c = A.container
    data = (c.data.abs() if absolute else c.data).double()
    return lambda x: (K.dia_matvec_plain if x.ndim == 1
                      else K.dia_matmat_plain)(data, c.offsets, x)


def _sell_f64(card, absolute=False):
    """A x (|A| x) in f64 through the SELL kernel's plain version on the
    card form (f32 values, an f64 x)."""
    from pykrylov_tpu_torch.sparse import sell as S
    if absolute:
        card = card._replace(vals=card.vals.abs())
    return lambda x: (S.sell_matvec_plain if x.ndim == 1
                      else S.sell_matmat_plain)(card, x)


def _single_products(res):
    """The SpMV launches of a single-rhs verified solve without a
    compensated product: its matvecs (two applies a verification, each
    counted)."""
    return int(res.n_matvec)


def phase_verified_single(pt, dia, A_dia, A_bus, bus, cd, se, single):
    """14: one right-hand side, every verified route, f32 storage.

    14a Poisson n = N (phase 4's operator and f32 b), the DIA SpMV:
    ``solve(verified=True)`` (refined CG legs with the curvature check)
    and ``cg(replace_every=50)`` (ff-CG).  14b convection-diffusion
    (phase 9's operator): ``solve(verified=True)`` (refined BiCGSTAB legs,
    each capped at phase 9's matvecs) on the f32 b; if it stops short
    (istop 1 or 3) its floor is logged and the f64 b (the f32f64 entry)
    must pass.  14c tiled
    1138bus with phase 8b's f64 Jacobi M and b (the SELL SpMV's f32f64
    entry): ``minres(replace_every=50)`` (ff-MINRES) and
    ``solve(method="minres", verified=True)`` (refined ff-MINRES legs).
    14d state estimation (phase 10's operator and b): ``solve(verified=
    True)`` (``refined_lls`` with LSMR legs) through the SELL SpMV on
    ``cards["fwd"]`` and ``cards["bwd"]``, held to phase 10's certificate.
    Each solve: launches = the products the loop issued, the verified stop
    code, an independent f64 check at or below VER_RTOL (14d: CERT_BOUND)
    that the solver's verified residual meets to VER_AGREE, a profiled
    window; and one capped run of each sub-phase through the plain
    products, bit for bit."""
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "14"
    out = {}
    cap = VER_PROFILE_ITERS

    # ---- 14a: Poisson, DIA --------------------------------------------
    b = dia["b"]
    check = _rel_check(b, _dia_f64(A_dia), _dia_f64(A_dia, True))
    plain = _plain_block_op(pt, A_dia)
    unver = (dia["solve_s"], dia["true_rel"])
    pt.solve(A_dia, b, verified=True, max_legs=1, leg_maxiter=20)  # warm
    pt.cg(A_dia, b, replace_every=50, maxiter=20)
    _verified(tag + "a verified, Poisson", "solve(verified=True)",
              lambda: pt.solve(A_dia, b, verified=True, rtol=VER_RTOL),
              "dia_spmv", _single_products, (0,), check,
              lambda: pt.solve(A_dia, b, verified=True, rtol=VER_RTOL,
                               **LEG_WINDOW), unver, out)
    _verified(tag + "a verified, Poisson", "cg(replace_every=50)",
              lambda: pt.cg(A_dia, b, replace_every=50, rtol=VER_RTOL),
              "dia_spmv", _single_products, (0,), check,
              lambda: pt.cg(A_dia, b, replace_every=50, rtol=VER_RTOL,
                            maxiter=cap), unver, out)
    _plain_same(tag + "a verified, Poisson", "cg(replace_every=50, maxiter=%d)"
                % VER_PLAIN_ITERS,
                lambda op: pt.cg(op, b, replace_every=50, rtol=VER_RTOL,
                                 maxiter=VER_PLAIN_ITERS), A_dia, plain, out)
    del plain

    # ---- 14b: convection-diffusion, DIA ----------------------------------
    A_cd, _, b_cd = cd
    ax_cd, absax_cd = _dia_f64(A_cd), _dia_f64(A_cd, True)
    s9 = single["9"]["solve (BiCGSTAB)"]
    unver = (s9["solve_s"], s9["true_rel"])
    b32 = b_cd.float()
    # the leg cap goes to BiCGSTAB's matvec_max: phase 9's matvecs
    cd_opts = {"rtol": VER_RTOL, "leg_maxiter": s9["n_matvec"],
               "max_legs": CD_MAX_LEGS}
    pt.solve(A_cd, b32, verified=True, max_legs=1, leg_maxiter=20)
    label = "solve(verified=True), f32 b"
    tag_b = tag + "b verified, convection-diffusion"
    r32 = _verified(tag_b, label,
                    lambda: pt.solve(A_cd, b32, verified=True, **cd_opts),
                    "dia_spmv", _single_products, (0, 1, 3),
                    lambda res: {} if int(res.istop)
                    else _rel_check(b32, ax_cd, absax_cd)(res),
                    lambda: pt.solve(A_cd, b32, verified=True, rtol=VER_RTOL,
                                     **LEG_WINDOW), unver, out)
    out["f32_floor"] = None
    if int(r32.istop):
        floor = float(r32.resid_norm) / float(
            torch.linalg.vector_norm(b32))
        out["f32_floor"] = floor
        log("[%s] the f32 vectors stop short (istop %d) at a verified "
            "relative residual of %.3e; the f64 b through the f32f64 "
            "entry:" % (tag_b, int(r32.istop), floor))
        _verified(tag_b, "solve(verified=True), f64 b",
                  lambda: pt.solve(A_cd, b_cd, verified=True, **cd_opts),
                  "dia_spmv", _single_products, (0,),
                  _rel_check(b_cd, ax_cd, absax_cd),
                  lambda: pt.solve(A_cd, b_cd, verified=True,
                                   rtol=VER_RTOL, **LEG_WINDOW), unver, out)
    b_cap = b32 if out["f32_floor"] is None else b_cd
    _plain_same(tag_b, "solve(verified=True, max_legs=%d)" % VER_PLAIN_LEGS,
                lambda op: pt.solve(op, b_cap, verified=True, rtol=VER_RTOL,
                                    max_legs=VER_PLAIN_LEGS,
                                    leg_maxiter=VER_PLAIN_ITERS),
                A_cd, _plain_block_op(pt, A_cd), out)

    # ---- 14c: tiled 1138bus, Jacobi, SELL (f64 vectors) -----------------
    M, b_bus = bus
    check = _rel_check(b_bus, _sell_f64(A_bus.cards["fwd"]),
                       _sell_f64(A_bus.cards["fwd"], True))
    s8b = single["8b"]["1e-06"]
    unver = (s8b["solve_s"], s8b["true_rel"])
    tag_c = tag + "c verified, tiled 1138bus"
    pt.minres(A_bus, b_bus, M=M, replace_every=50, itnlim=20)
    _verified(tag_c, "minres(replace_every=50)",
              lambda: pt.minres(A_bus, b_bus, M=M, replace_every=50,
                                rtol=VER_RTOL),
              "sell_spmv", _single_products, (1,), check,
              lambda: pt.minres(A_bus, b_bus, M=M, replace_every=50,
                                rtol=VER_RTOL, itnlim=cap), unver, out)
    _verified(tag_c, "solve(method='minres', verified=True)",
              lambda: pt.solve(A_bus, b_bus, M=M, method="minres",
                               verified=True, rtol=VER_RTOL),
              "sell_spmv", _single_products, (0,), check,
              lambda: pt.solve(A_bus, b_bus, M=M, method="minres",
                               verified=True, rtol=VER_RTOL, **LEG_WINDOW),
              unver, out)
    _plain_same(tag_c, "minres(replace_every=50, itnlim=%d)"
                % VER_PLAIN_ITERS,
                lambda op: pt.minres(op, b_bus, M=M, replace_every=50,
                                     rtol=VER_RTOL, itnlim=VER_PLAIN_ITERS),
                A_bus, _plain_block_op(pt, A_bus), out)

    # ---- 14d: state estimation, SELL on A and A^T -----------------------
    A_se, coo_se, b_se = se
    fwd, bwd = A_se.cards["fwd"], A_se.cards["bwd"]
    fro = float(np.sqrt((coo_se[0].astype(np.float64) ** 2).sum()))

    def certificate(res):
        x = res.x.double() + res.info["x_lo"].double()
        r = b_se - S.sell_matvec_plain(fwd, x)
        rn = torch.linalg.vector_norm(r)
        arn = torch.linalg.vector_norm(S.sell_matvec_plain(bwd, r))
        cert = (arn / (fro * rn)).item()
        claimed = (res.info["true_normar"] / (fro * res.resid_norm)).item()
        # f64 vectors: the verification's rounding is negligible here
        return {"||A'r||/(||A||_F ||r||)": ([cert], [claimed], CERT_BOUND,
                                            [0.0]),
                "||r||": ([rn.item()], [float(res.resid_norm)], np.inf,
                          [0.0])}

    s10 = single["10"]["solve (LSMR)"]
    unver = (s10["solve_s"], s10["certificates"]["||A'r||/(||A||_F ||r||)"])
    opts = {"atol": LLS_TOL, "btol": LLS_TOL}
    tag_d = tag + "d verified, state estimation"
    pt.solve(A_se, b_se, verified=True, max_legs=1, leg_maxiter=20, **opts)
    _verified(tag_d, "solve(verified=True) (refined_lls, LSMR legs)",
              lambda: pt.solve(A_se, b_se, verified=True, **opts),
              "sell_spmv",
              lambda res: int(res.n_matvec) + res.info["n_legs"], (0,),
              certificate,
              lambda: pt.solve(A_se, b_se, verified=True, **LEG_WINDOW,
                               **opts), unver, out)
    _plain_same(tag_d, "solve(verified=True, max_legs=%d)" % VER_PLAIN_LEGS,
                lambda op: pt.solve(op, b_se, verified=True,
                                    max_legs=VER_PLAIN_LEGS,
                                    leg_maxiter=VER_PLAIN_ITERS, **opts),
                A_se, _plain_block_op(pt, A_se), out)
    return out


def _k16_timing(tag, name, mm, plain_mm, coo, own_matrix, rates):
    """The verifiers' (n, 2 KB) product with an f64 block: the kernel, its
    plain version and torch's CSR SpMM in f64 (cuSPARSE, a yardstick)
    against the bound (the matrix once plus 2 KB f64 columns of X and Y,
    or the f64 operations if longer)."""
    vals, rows, cols, (m, n) = coo
    kb = 2 * KB
    csr = _torch_csr(coo, DEVICE)
    csr64 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                    csr.values().double(), size=(m, n))
    del csr
    X = torch.randn((n, kb), device=DEVICE, dtype=torch.float64,
                    generator=torch.Generator(device=DEVICE).manual_seed(16))
    best = _best_ms([("kernel", lambda: mm(X)), ("plain", lambda: plain_mm(X)),
                     ("torch CSR SpMM f64", lambda: torch.sparse.mm(csr64,
                                                                    X))],
                    10, ("plain",))
    b = _bound(min(own_matrix, len(vals) * 8 + (m + 1) * 4)
               + kb * (n + m) * 8, 2 * len(vals) * kb, rates, "f64")
    log("[%s] %s K=%d, f32 storage with an f64 block (the verifiers' "
        "product): kernel %.4f ms, plain %.4f, torch CSR SpMM (f64) %.4f; "
        "bound %.4f ms (%s), kernel at %.1f%% of it"
        % (tag, name, kb, best["kernel"], best["plain"],
           best["torch CSR SpMM f64"], b["bound_ms"], b["bound_by"],
           100 * b["bound_ms"] / best["kernel"]))
    del X, csr64
    return {"k": kb, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["torch CSR SpMM f64"], **b}


def phase_verified_blocks(pt, dia, A_dia, A_bus, bus, cd, single, rates,
                          coo_bus, coo_cd, f64_cd):
    """15: blocks of K = KB_CUT, column 0 the single phase's b and the
    others standard normal from seed 0 (:func:`_block_of`).  15a Poisson
    n = N, an f32 block: ``solve(A, B, verified=True)`` (ff
    ``cg_batched``), its iterations' (n, K) products and its
    replacements' (n, 2 K) through the DIA SpMM.  15b convection-diffusion, f32 block (f64 where 14b's
    f32 stopped at its floor): ``solve(A, B, verified=True)``
    (``refined_solve_batched`` with BiCGSTAB legs), the DIA SpMM.  15c
    tiled 1138bus with the f64 Jacobi M, f64 block: ``solve(A, B, M=M,
    method="minres", verified=True)`` (ff ``minres_batched``), one (n, 2
    KB) SELL SpMM an iteration.  The checks of phase 14 per column; each
    capped through the plain products; the SpMMs timed at K = 2 KB with
    an f64 block.  15b's refinement legs are capped at phase 11's
    unverified block iterations (an f32 block gets CD_F32_BLOCK_LEGS
    legs); an f32 block with a column short of the target (istop 1 or 3)
    is logged and rerun as an f64 block, as 14b does."""
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "15 verified blocks"
    out = {}
    cap = VER_PROFILE_ITERS

    # ---- 15a: Poisson, f32 block ----------------------------------------
    Bm = _block_of(dia["b"], KB_CUT).float()
    ax_dia = _dia_f64(A_dia)

    tag_a = "15a verified blocks, Poisson"
    pt.solve(A_dia, Bm, maxiter=10)                     # warm-ups
    pt.solve(A_dia, Bm, verified=True, maxiter=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    un = pt.solve(A_dia, Bm)
    torch.cuda.synchronize()
    un_s = time.perf_counter() - t0
    un_rel = max(_col_rel(Bm.double() - ax_dia(un.x.double()), Bm.double()))
    log("[%s] the unverified cg_batched of the same block: %d block "
        "iterations, %.3f s, true relative residual up to %.3e"
        % (tag_a, int(un.n_iter), un_s, un_rel))
    del un
    # iterations' (n, K) products and one (n, 2 K) a replacement event:
    # n_matvec = n_iter + 2 events
    _verified(tag_a, "solve(A, B, verified=True) (ff cg_batched)",
              lambda: pt.solve(A_dia, Bm, verified=True, rtol=VER_RTOL),
              "dia_spmm",
              lambda res: (int(res.n_iter) + int(res.n_matvec)) // 2, (0,),
              _rel_check(Bm, ax_dia, _dia_f64(A_dia, True)),
              lambda: pt.solve(A_dia, Bm, verified=True, rtol=VER_RTOL,
                               maxiter=cap), (un_s, un_rel), out)
    _plain_same(tag_a, "cg_batched(replace_every=50, maxiter=%d)"
                % VER_PLAIN_ITERS,
                lambda op: pt.solvers.cg_batched(
                    op, Bm, replace_every=50, check_curvature=True,
                    rtol=VER_RTOL, maxiter=VER_PLAIN_ITERS),
                A_dia, _plain_block_op(pt, A_dia), out)
    del Bm

    # ---- 15b: convection-diffusion --------------------------------------
    A_cd, _, b_cd = cd
    B64 = _block_of(b_cd, KB_CUT)
    s11 = single["11"]["solve (bicgstab_batched)"]
    cd_opts = {"rtol": VER_RTOL, "leg_maxiter": s11["n_iter"]}
    tag_b = "15b verified blocks, convection-diffusion"
    unver = (s11["solve_s"], s11["certificates"]["||b - Ax||/||b||"])
    blocks = [B64] if f64_cd else [B64.float(), B64]
    pt.solve(A_cd, blocks[0], verified=True, max_legs=1, leg_maxiter=10)
    for Bm in blocks:
        check = _rel_check(Bm, _dia_f64(A_cd), _dia_f64(A_cd, True))
        # each leg's two block products an iteration and one (n, 2 KB)
        # product a verification, one a leg
        legs = {"max_legs": CD_F32_BLOCK_LEGS
                if Bm.dtype == torch.float32 else CD_MAX_LEGS}
        res = _verified(
            tag_b, "solve(A, B, verified=True) (refined_solve_batched, %s "
            "block)" % str(Bm.dtype)[6:],
            lambda: pt.solve(A_cd, Bm, verified=True, **cd_opts, **legs),
            "dia_spmm",
            lambda res: 2 * int(res.n_iter) + res.info["n_legs"],
            (0, 1, 3) if Bm.dtype == torch.float32 else (0,),
            lambda res: {} if bool(res.istop.any()) else check(res),
            lambda: pt.solve(A_cd, Bm, verified=True, rtol=VER_RTOL,
                             **LEG_WINDOW), unver, out)
        if not bool(res.istop.any()):
            break
        # the f64 rule of 14b: f32 columns short of the target (istop 1 or
        # 3) are logged, and the f64 block must pass
        out["f32_block_floor"] = (res.resid_norm.double() / torch.linalg
                                  .vector_norm(Bm.double(), dim=0)).tolist()
        log("[%s] f32 block: istop %s, verified relative residuals %s; "
            "the f64 block through the f32f64 entry:"
            % (tag_b, res.istop.tolist(), " ".join(
                "%.3e" % v for v in out["f32_block_floor"])))
    f64_cd = Bm.dtype == torch.float64
    _plain_same(tag_b, "solve(A, B, verified=True, max_legs=%d)"
                % VER_PLAIN_LEGS,
                lambda op: pt.solve(op, Bm, verified=True, rtol=VER_RTOL,
                                    max_legs=VER_PLAIN_LEGS,
                                    leg_maxiter=VER_PLAIN_ITERS),
                A_cd, _plain_block_op(pt, A_cd), out)
    del Bm, B64, blocks

    # ---- 15c: tiled 1138bus, Jacobi, f64 block ---------------------------
    M, b_bus = bus
    card = A_bus.cards["fwd"]
    Bm = _block_of(b_bus, KB_CUT)
    ax_bus = _sell_f64(card)

    tag_c = "15c verified blocks, tiled 1138bus"
    pt.solve(A_bus, Bm, M=M, method="minres", verified=True, itnlim=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    un = pt.solve(A_bus, Bm, M=M, method="minres", rtol=VER_RTOL, etol=0.0)
    torch.cuda.synchronize()
    un_s = time.perf_counter() - t0
    un_rel = max(_col_rel(Bm - ax_bus(un.x), Bm))
    log("[%s] the unverified minres_batched of the same block (etol 0): %d "
        "block iterations, %.3f s, true relative residual up to %.3e"
        % (tag_c, int(un.n_iter), un_s, un_rel))
    del un
    # one (n, 2 KB) product a Lanczos step and one a verification event,
    # each counted twice
    _verified(tag_c, "solve(A, B, M=M, method='minres', verified=True) "
              "(ff minres_batched)",
              lambda: pt.solve(A_bus, Bm, M=M, method="minres",
                               verified=True, rtol=VER_RTOL),
              "sell_spmm", lambda res: int(res.n_matvec) // 2, (1,),
              _rel_check(Bm, ax_bus, _sell_f64(card, True)),
              lambda: pt.solve(A_bus, Bm, M=M, method="minres",
                               verified=True, rtol=VER_RTOL, itnlim=cap),
              (un_s, un_rel), out)
    _plain_same(tag_c, "minres_batched(replace_every=50, itnlim=%d)"
                % VER_PLAIN_ITERS,
                lambda op: pt.solvers.minres_batched(
                    op, Bm, M=M, replace_every=50, rtol=VER_RTOL,
                    itnlim=VER_PLAIN_ITERS),
                A_bus, _plain_block_op(pt, A_bus), out)
    del Bm

    # ---- the verifiers' (n, 2 KB) f64-block products, timed -------------
    out["sell_spmm_k16"] = _k16_timing(
        tag, "SELL tiled 1138bus", lambda X: S.sell_matmat(card, X),
        lambda X: S.sell_matmat_plain(card, X), coo_bus,
        S.sell_bytes(card), rates)
    if f64_cd:
        c = A_cd.container
        out["dia_spmm_k16"] = _k16_timing(
            tag, "DIA convection-diffusion",
            lambda X: K.dia_matmat(c.data, c.offsets, X),
            lambda X: K.dia_matmat_plain(c.data, c.offsets, X), coo_cd,
            len(c.offsets) * A_cd.shape[0] * 4, rates)
    return out


# --------------------------------------------------------------------------
# 16-17. pipelined CG, the differentiable solves, the remaining operators
# --------------------------------------------------------------------------

PIPE_RTOL = 1e-6        # rtol of the solves of phases 16-17
# pipelined against classic CG on the same vectors and M, iterations (the
# JAX package's claim for replace_every = 10, pipelined.py:166-169)
PIPE_ITER_RTOL = 0.1
PIPE_PROFILE_ITERS = 100    # profiled iterations of a single solve
                            # (16-21)
CHEB_DEGREE = 8         # Chebyshev preconditioner (17a): degree - 1 SpMVs
CHEB_LANCZOS = 16       # Lanczos steps of its bounds
CX_N = 160              # complex system (17b): 2 * 160^3 real rows
CX_SHIFT, CX_SKEW = 1.0, 0.4
LBFGS_PAIRS = 5         # (s, A s) pairs of the inverse L-BFGS operator (17c)
CHOL_N = 4096           # dense SPD matrix of the Cholesky operator (17c)
CKPT_CHUNK = 50         # iterations a chunk of the checkpointed solve (18a)
MESH_SHARDS = 4         # shard slots of the sharded phases (19a-19c), all
                        # on the one card
SHARD_FF_ITERS = 200    # cap of 19b's verified-shadow ff-CG
SHARD_LLS_ITERS = 500   # cap of 19b's LSQR through the transposed shards
# 19b holds that LSQR to the unsharded one by its residual norm and x at
# the cap.  The state-estimation areas fall whole into the shards (256 a
# shard), so no entry crosses a shard and the transposed exchange adds
# each partial to zeros: the sharded A'u is the unsharded one's bits.
# Where the partition cuts areas, LSQR's iterates part at the rounding of
# A'u alone past about 20 iterations (the control below: A'u perturbed by
# 1e-16 relative moves x by about 1e-3 at 500 iterations)
SHARD_LLS_RTOL = 1e-2   # the residual norms at the cap, relative
SHARD_LLS_XTOL = 1e-4   # x at the cap, relative
# 19b's mesh whose partition cuts 1138bus tiles.  A shard's private
# address space is [own block | received rows], so a row at a shard's edge
# spans the whole block: the window-1 BELL packing takes at most 1024
# bands of 128 columns (SpanError past it, in the JAX package too), which
# 3 shards of 388,438 rows exceed and 12 of 97,110 stay within
EXCHANGE_SHARDS = 12
# 19b's mesh whose partition cuts state-estimation areas.  A shard's
# transposed block has its private columns as rows and its own rows as
# columns, and a step of private columns received from both neighbours
# spans the whole row block: 12 shards of 222,552 rows raise SpanError
# (1737 bands), 24 of 111,276 stay within the 1024-band budget
SE_EXCHANGE_SHARDS = 24
# cap of 19b's LSQR through the transposed exchange over SE_EXCHANGE_SHARDS
# slots, whose partition cuts state-estimation areas: below about 20
# iterations the iterates have not yet parted at the rounding of A'u, so
# the sharded LSQR is held to the unsharded one's residual norm and x at
# the cap (CPU rehearsal at 50 areas: 5e-16 and 3e-9 apart, the control's
# 7e-16 and 3e-9; at 40 iterations both 1e-5)
SHARD_XLLS_ITERS = 20
SHARD_XLLS_RTOL = 1e-10  # the residual norms at that cap, relative
SHARD_XLLS_XTOL = 1e-6   # x at that cap, relative
TRACE_ITERS = 200       # iterations of phase 5's solve traced in 18b
# launches of a one-element add at the start of 18b's trace, before the
# traced solve: a session's first host launches may get no device record
# (the first 57 of one session late in a full run of this script, on an
# NVIDIA H100 80GB HBM3; every launch kept its record in 81 sessions run
# alone), so these absorb that loss and the solve's launches all keep
# theirs
TRACE_WARMUP = 1000
TALL_M, TALL_N = 1 << 20, 256   # dense f32 tall matrix of 19c


def _dropped(res):
    """The operator product a pipelined solve enqueued before the read
    that stopped it and then dropped: ``cg_pipelined``'s launches are its
    ``n_matvec`` plus this."""
    return int(bool(res.converged) and int(res.n_iter) > 0)


def _col_check(Bm, ax64):
    """A ``check`` of :func:`_block_solve`: every column's true relative
    residual in f64 (``ax64`` gives A X in f64) at most 1e-4."""
    return lambda res: {"||b - Ax||/||b||": (
        _col_rel(Bm.double() - ax64(res.x.double()), Bm.double()), 1e-4)}


def phase_pipelined(pt, A_dia, dia, A_bus, bus, bell):
    """16a: ``cg_pipelined`` with f64 vectors on phase 4's Poisson
    operator and b (the DIA SpMV's f32f64 entry), replace_every 0 and 10,
    and on phase 5's tiled 1138bus with phase 8b's f64 Jacobi M and b
    (the SELL SpMV), replace_every 10; each beside a classic ``cg`` of the
    same vectors and M.  In f32 vectors the pipelined recurrence stalls on
    both (PERF.md §6), and unpreconditioned tiled 1138bus takes 8%
    more iterations than classic CG even in f64.  Each solve: istop 0,
    launches = n_matvec plus the dropped product of the stopping iteration
    (:func:`_dropped`), the true relative residual in f64 at most 1e-4,
    the pipelined count within PIPE_ITER_RTOL of the classic one, and a
    profiled window of at most PIPE_PROFILE_ITERS iterations."""
    tag = "16a pipelined CG"
    M, b_bus = bus
    systems = (("Poisson", A_dia, dia["b"].double(), None, _dia_f64(A_dia),
                "dia_spmv", (0, 10), dia),
               ("tiled 1138bus + Jacobi", A_bus, b_bus, M,
                _sell_f64(A_bus.cards["fwd"]), "sell_spmv", (10,), bell))
    out = {}
    for name, A, b, MM, ax64, kernel, everies, earlier in systems:
        pt.solvers.cg_pipelined(A, b, M=MM, maxiter=20)      # warm-up
        runs = [("%s, classic cg" % name, None)] + [
            ("%s, cg_pipelined(replace_every=%d)" % (name, e), e)
            for e in everies]
        classic = None
        for label, every in runs:
            if every is None:
                def fn(cap=None):
                    return pt.cg(A, b, M=MM, rtol=PIPE_RTOL, maxiter=cap)
                extra = lambda res: 0                       # noqa: E731
            else:
                def fn(cap=None):
                    return pt.solvers.cg_pipelined(
                        A, b, M=MM, rtol=PIPE_RTOL, maxiter=cap,
                        replace_every=every)
                extra = _dropped
            res, secs, counts = _counted_solve(tag, label, fn, kernel, extra)
            n_iter = int(res.n_iter)
            true_rel = _true_rel(b, ax64, res.x)
            log("[%s] %s: true relative residual (f64) %.3e"
                % (tag, label, true_rel))
            if int(res.istop) != 0 or not true_rel <= 1e-4:
                raise AssertionError("%s %s: %r, true relative residual "
                                     "%.3e" % (tag, label, res, true_rel))
            if classic is None:
                classic = n_iter
            elif abs(n_iter - classic) > PIPE_ITER_RTOL * classic:
                raise AssertionError("%s %s: %d iterations, classic CG %d"
                                     % (tag, label, n_iter, classic))
            ms = 1e3 * secs / max(n_iter, 1)
            prof = _profile_call("%s, %s" % (tag, label),
                                 lambda: fn(PIPE_PROFILE_ITERS), ms)
            out[label] = {"kernel": kernel, "n_iter": n_iter,
                          "n_matvec": int(res.n_matvec), "launches": counts,
                          "solve_s": secs, "ms_per_iter": ms,
                          "true_rel": true_rel, "profile": prof}
        log("[%s] %s: classic CG %d iterations here; the f32 classic CG of "
            "phase %s: %d iterations, %.4f ms per iteration, device idle "
            "%.1f%%" % (tag, name, classic, "4" if kernel == "dia_spmv"
                        else "5 (no M)", earlier["n_iter"],
                        1e3 * earlier["solve_s"] / earlier["n_iter"],
                        100 * earlier["profile"]["idle"]))
    return out


def phase_pipelined_block(pt, A_dia, dia, single):
    """16b: ``solve(A, B, method="cg_pipelined")`` (cg_pipelined_batched)
    on phase 4's operator with a K = KB f64 block whose column 0 is phase
    4's b: every block product through the DIA SpMM (n_iter + 1, no
    replacement), every column's true relative residual in f64 at most
    1e-4, column 0's count within ITER_RTOL of 16a's single solve of the
    same b (plus the iteration whose test stops it, which a block column
    counts), a profiled window."""
    tag = "16b pipelined CG block"
    Bm = _block_of(dia["b"])
    pt.solve(A_dia, Bm, method="cg_pipelined", maxiter=20)   # warm-up
    s = single["Poisson, cg_pipelined(replace_every=0)"]
    out = {}
    _block_solve(pt, tag, "solve(A, B, method='cg_pipelined')",
                 "cg_pipelined", A_dia, Bm,
                 {"method": "cg_pipelined", "rtol": PIPE_RTOL}, "dia_spmm",
                 (s["n_iter"] + 1, s["ms_per_iter"]),
                 _col_check(Bm, _dia_f64(A_dia)), out)
    return out


def phase_diff(pt, A_dia, dia, cd, se):
    """16c: the differentiable solves, ``L = w'x``, ``dL/db`` by one
    backward: ``cg_solve`` on phase 4's operator and f32 b (DIA SpMV on A
    in both solves; ``||A g - w|| / ||w||``), ``bicgstab_solve`` on phase
    9's operator and f64 b (the adjoint through ``dia_transpose``;
    ``||A' g - w|| / ||w||``), each with w standard normal (seed 0), and
    ``lsqr_solve`` on phase 10's state-estimation operator (SELL on
    ``cards["fwd"]`` and ``cards["bwd"]`` in both solves; ``||A' g - w|| /
    ||w||``) at atol = btol = 1e-8, with b = A x, x standard normal, and
    w = A'u, u standard normal: ``L = u'A x`` of the fitted measurements.
    There phase 10's noisy b would keep the forward LSQR to its iteration
    cap at that tolerance, and a standard normal w the adjoint (its small
    singular directions) above 1e-2 (PERF.md §6).  Each gradient
    residual at most 1e-4 in f64, with the forward solve's and the
    backward's launches (only the expected kernel) and walls."""
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "16c differentiable solves"
    A_cd, _, b_cd = cd
    A_se = se[0]
    t = K.dia_transpose(A_cd.container)
    g = torch.Generator(device=DEVICE).manual_seed(0)

    def normal(n, dtype):
        return torch.randn(n, generator=g, device=DEVICE, dtype=dtype)

    m_se, n_se = A_se.shape
    cases = (("cg_solve, Poisson", A_dia, dia["b"], None,
              pt.solvers.cg_solve, {"rtol": PIPE_RTOL}, _dia_f64(A_dia)),
             ("bicgstab_solve, convection-diffusion", A_cd, b_cd, None,
              pt.solvers.bicgstab_solve, {"rtol": 1e-6},
              lambda x: K.dia_matvec_plain(t.data.double(), t.offsets, x)),
             ("lsqr_solve, state estimation", A_se,
              A_se * normal(n_se, torch.float64),
              A_se.T * normal(m_se, torch.float64), pt.solvers.lsqr_solve,
              {"atol": 1e-8, "btol": 1e-8}, _sell_f64(A_se.cards["bwd"])))
    out = {}
    for label, A, b, w, fn, opts, atg in cases:
        kernel = "dia_spmv" if getattr(A, "cards", None) is None \
            else "sell_spmv"
        if w is None:
            w = normal(A.shape[1], b.dtype)
        bb = b.detach().clone().requires_grad_(True)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = fn(A, bb, **opts)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd = _counts()
        _reset_counts()
        t0 = time.perf_counter()
        (w @ x).backward()
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0
        bwd = _counts()
        grad = bb.grad
        rel = (torch.linalg.vector_norm(atg(grad.double()) - w.double())
               / torch.linalg.vector_norm(w.double())).item()
        log("[%s] %s: forward %d %s launches in %.3f s, backward (the "
            "adjoint solve) %d in %.3f s; ||A%s g - w|| / ||w|| (f64) %.3e"
            % (tag, label, fwd[kernel], kernel, fwd_s, bwd[kernel], bwd_s,
               "" if A is A_dia else "'", rel))
        for counts in (fwd, bwd):
            if counts[kernel] == 0 or any(v for k, v in counts.items()
                                          if k != kernel):
                raise AssertionError("%s %s: launches %s" % (tag, label,
                                                             counts))
        if not (rel <= 1e-4 and torch.isfinite(grad).all()):
            raise AssertionError("%s %s: gradient residual %.3e"
                                 % (tag, label, rel))
        out[label] = {"kernel": kernel, "forward_s": fwd_s,
                      "backward_s": bwd_s, "rel": rel,
                      "launches": {k: fwd[k] + bwd[k] for k in fwd},
                      "forward_launches": fwd[kernel],
                      "adjoint_launches": bwd[kernel]}
        del x, bb, grad
    return out


def phase_chebyshev(pt, A_dia, dia):
    """17a: ``chebyshev_preconditioner`` (Lanczos CHEB_LANCZOS steps,
    degree CHEB_DEGREE) on phase 4's operator: CHEB_LANCZOS SpMVs for the
    bounds; ``cg`` with it on phase 4's b in f64 (DIA launches = n_matvec
    + (CHEB_DEGREE - 1) a preconditioner apply, n_iter + 1 applies; the
    true residual at most 1e-4) beside phase 4's outer count; and
    ``solve(A, B, M=M)`` (cg_batched) with a K = KB f64 block, the
    preconditioner's block rule through the DIA SpMM."""
    tag = "17a Chebyshev"
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M = pt.chebyshev_preconditioner(A_dia, degree=CHEB_DEGREE,
                                    k_lanczos=CHEB_LANCZOS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    log("[%s] Lanczos bounds [%.6g, %.6g] in %.3f s, %s" % (
        tag, M.lmin, M.lmax, secs, counts))
    if counts != {"dia_spmv": CHEB_LANCZOS, "dia_spmm": 0, "sell_spmv": 0,
                  "sell_spmm": 0, "block_cg": 0}:
        raise AssertionError("%s: Lanczos launches %s" % (tag, counts))
    out = {"bounds": [M.lmin, M.lmax],
           "lanczos": {"launches": counts, "s": secs}}
    b = dia["b"].double()
    pt.cg(A_dia, b, M=M, maxiter=3)                          # warm-up
    label = "cg, M = Chebyshev(%d)" % CHEB_DEGREE
    res, secs, counts = _counted_solve(
        tag, label, lambda: pt.cg(A_dia, b, M=M, rtol=PIPE_RTOL),
        "dia_spmv",
        lambda res: (CHEB_DEGREE - 1) * (int(res.n_iter) + 1))
    n_iter = int(res.n_iter)
    true_rel = _true_rel(b, _dia_f64(A_dia), res.x)
    ms = 1e3 * secs / max(n_iter, 1)
    log("[%s] %s: %d outer iterations (phase 4 without M: %d), %.4f ms "
        "per outer iteration (phase 4: %.4f), true relative residual (f64) "
        "%.3e" % (tag, label, n_iter, dia["n_iter"], ms,
                  1e3 * dia["solve_s"] / dia["n_iter"], true_rel))
    if int(res.istop) != 0 or not true_rel <= 1e-4:
        raise AssertionError("%s %s: %r, true relative residual %.3e"
                             % (tag, label, res, true_rel))
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.cg(
        A_dia, b, M=M, rtol=PIPE_RTOL, maxiter=PIPE_PROFILE_ITERS), ms)
    out[label] = {"kernel": "dia_spmv", "n_iter": n_iter,
                  "n_matvec": int(res.n_matvec), "launches": counts,
                  "solve_s": secs, "ms_per_iter": ms, "true_rel": true_rel,
                  "profile": prof}
    Bm = _block_of(dia["b"])
    pt.solve(A_dia, Bm, M=M, maxiter=3)                      # warm-up
    _block_solve(pt, tag, "solve(A, B, M = Chebyshev(%d))" % CHEB_DEGREE,
                 "cg_cheb", A_dia, Bm, {"M": M, "rtol": PIPE_RTOL},
                 "dia_spmm", (n_iter, ms), _col_check(Bm, _dia_f64(A_dia)),
                 out)
    return out


def cx_coo(n=CX_N):
    """A Hermitian positive definite complex system: 3-D Poisson on an
    n^3 grid plus CX_SHIFT I plus i times a real skew-symmetric first
    difference of CX_SKEW along x (its eigenvalues lie within 2 CX_SKEW <
    CX_SHIFT of 0): complex COO triples (vals, rows, cols, shape)."""
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    vals, rows, cols, shape = poisson3d_coo(n)
    vals = vals + CX_SHIFT * (rows == cols)
    i = np.arange(shape[0])
    r = i[(i % n) < n - 1]
    skew = np.full(len(r), CX_SKEW)
    return (np.concatenate([vals.astype(np.complex128), 1j * skew,
                            -1j * skew]),
            np.concatenate([rows, r, r + 1]),
            np.concatenate([cols, r + 1, r]), shape)


def phase_complex(pt):
    """17b: ``complex_solve(cg, ...)`` on :func:`cx_coo` through
    ``real_equivalent_operator(..., hermitian=True)`` with f32 storage (the
    auto policy's pick logged: it must be a kernel), b complex standard
    normal (seed 0) in complex128 (f64 vectors, the f32f64 entry): istop
    0, launches = n_matvec, the true complex residual in complex128
    through torch's CSR product at most 1e-4, a profiled window."""
    tag = "17b complex"
    t0 = time.perf_counter()
    vals, rows, cols, shape = cx_coo(CX_N)
    op = pt.real_equivalent_operator((vals, rows, cols, shape),
                                     hermitian=True, dtype=np.float32,
                                     device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kernel = {"cuda-dia": "dia_spmv", "bell": "sell_spmv"}.get(
        getattr(op, "fmt", None))
    log("[%s] A: %d complex rows, %d nonzeros; real equivalent %d x %d, "
        "fmt=%s (auto), %s, built in %.1f s" % (
            tag, shape[0], len(vals), op.shape[0], op.shape[1],
            getattr(op, "fmt", None), str(op.dtype)[6:], build_s))
    if kernel is None or not op.symmetric:
        raise AssertionError("%s: the auto policy gave %r" % (tag, op))
    g = torch.Generator(device=DEVICE).manual_seed(0)
    bz = torch.complex(*(torch.randn(shape[0], generator=g, device=DEVICE,
                                     dtype=torch.float64) for _ in range(2)))
    pt.complex_solve(pt.cg, op, bz, maxiter=3)               # warm-up
    label = "complex_solve(cg)"
    res, secs, counts = _counted_solve(
        tag, label, lambda: pt.complex_solve(pt.cg, op, bz, rtol=PIPE_RTOL),
        kernel)
    idx = torch.from_numpy(np.stack([rows, cols])).to(DEVICE)
    Acsr = torch.sparse_coo_tensor(idx, torch.from_numpy(vals).to(DEVICE),
                                   shape).coalesce().to_sparse_csr()
    del idx
    true_rel = (torch.linalg.vector_norm(bz - Acsr @ res.x)
                / torch.linalg.vector_norm(bz)).item()
    n_iter = int(res.n_iter)
    ms = 1e3 * secs / max(n_iter, 1)
    log("[%s] %s: x %s, true complex relative residual (complex128 CSR) "
        "%.3e" % (tag, label, str(res.x.dtype)[6:], true_rel))
    if (int(res.istop) != 0 or res.x.dtype != torch.complex128
            or not true_rel <= 1e-4):
        raise AssertionError("%s: %r, true relative residual %.3e"
                             % (tag, res, true_rel))
    del Acsr
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.complex_solve(
        pt.cg, op, bz, rtol=PIPE_RTOL, maxiter=PIPE_PROFILE_ITERS), ms)
    return {"fmt": op.fmt, "build_s": build_s, "shape": list(op.shape),
            label: {"kernel": kernel, "n_iter": n_iter,
                    "n_matvec": int(res.n_matvec), "launches": counts,
                    "solve_s": secs, "ms_per_iter": ms,
                    "true_rel": true_rel, "profile": prof}}


def phase_operators(pt, A_dia, dia, A_bus, bell):
    """17c: CG on ``BlockDiagonalLinearOperator([A_dia, A_bus])`` (phase 4's
    and phase 5's operators, b their f32 b's each scaled to norm 1): one
    DIA and one SELL launch an iteration, each block's true relative
    residual in f64 at most 1e-4, a profiled window; an
    ``InverseLBFGSOperator`` of LBFGS_PAIRS pairs (s, A s), s standard
    normal in f64 (the DIA SpMV's f32f64 entry): the secant equation of
    the newest pair ``||H y - s|| / ||s||`` at most 1e-6; a
    ``CholeskyOperator`` of a dense SPD matrix of order CHOL_N in f64:
    ``||A (C^-1 b) - b|| / ||b||`` at most 1e-10."""
    tag = "17c operators"
    out = {}
    b1 = dia["b"] / torch.linalg.vector_norm(dia["b"])
    b2 = bell["b"] / torch.linalg.vector_norm(bell["b"])
    op = pt.BlockDiagonalLinearOperator([A_dia, A_bus])
    b = torch.cat([b1, b2])
    n1 = b1.shape[0]
    pt.cg(op, b, maxiter=3)                                  # warm-up
    label = "cg, BlockDiagonalLinearOperator([DIA, SELL])"
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.cg(op, b, rtol=PIPE_RTOL)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    n_iter, n_mv = int(res.n_iter), int(res.n_matvec)
    rels = [_true_rel(b1, _dia_f64(A_dia), res.x[:n1]),
            _true_rel(b2, _sell_f64(A_bus.cards["fwd"]), res.x[n1:])]
    ms = 1e3 * secs / max(n_iter, 1)
    log("[%s] %s: istop %d, %d iterations, %.3f s, %.4f ms per iteration, "
        "launches %s; true relative residual (f64) per block %.3e %.3e"
        % (tag, label, int(res.istop), n_iter, secs, ms, counts, *rels))
    if (counts != {"dia_spmv": n_mv, "sell_spmv": n_mv, "dia_spmm": 0,
                   "sell_spmm": 0, "block_cg": 0} or int(res.istop) != 0
            or not max(rels) <= 1e-4):
        raise AssertionError("%s %s: %r, launches %s, residuals %s"
                             % (tag, label, res, counts, rels))
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.cg(
        op, b, rtol=PIPE_RTOL, maxiter=PIPE_PROFILE_ITERS), ms)
    out[label] = {"n_iter": n_iter, "launches": counts, "solve_s": secs,
                  "ms_per_iter": ms, "true_rel": rels, "profile": prof}
    del op, b, res

    m = A_dia.shape[0]
    H = pt.InverseLBFGSOperator(m, LBFGS_PAIRS, dtype=torch.float64,
                                device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    _reset_counts()
    for _ in range(LBFGS_PAIRS):
        s = torch.randn(m, generator=g, device=DEVICE, dtype=torch.float64)
        y = A_dia * s
        H.store(s, y)
    torch.cuda.synchronize()
    counts = _counts()
    t0 = time.perf_counter()
    hy = H * y
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    rel = (torch.linalg.vector_norm(hy - s)
           / torch.linalg.vector_norm(s)).item()
    log("[%s] InverseLBFGSOperator, %d pairs (s, A s) on %d rows: launches "
        "%s; H y = s for the newest pair to %.3e (f64); one apply %.3f s"
        % (tag, LBFGS_PAIRS, m, counts, rel, h_s))
    if counts["dia_spmv"] != LBFGS_PAIRS or not rel <= 1e-6:
        raise AssertionError("%s: L-BFGS launches %s, secant %.3e"
                             % (tag, counts, rel))
    out["InverseLBFGSOperator"] = {"launches": counts, "secant_rel": rel,
                                   "apply_s": h_s}
    del H, s, y, hy

    Q = torch.randn(CHOL_N, CHOL_N, generator=g, device=DEVICE,
                    dtype=torch.float64)
    A = Q @ Q.T / CHOL_N + torch.eye(CHOL_N, dtype=torch.float64,
                                     device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C = pt.CholeskyOperator(A, device=DEVICE)
    torch.cuda.synchronize()
    f_s = time.perf_counter() - t0
    bc = torch.randn(CHOL_N, generator=g, device=DEVICE,
                     dtype=torch.float64)
    t0 = time.perf_counter()
    x = C * bc
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    rel = (torch.linalg.vector_norm(A @ x - bc)
           / torch.linalg.vector_norm(bc)).item()
    log("[%s] CholeskyOperator, dense SPD %d x %d (f64): factor %.3f s, "
        "apply %.4f s, ||A (C^-1 b) - b|| / ||b|| %.3e"
        % (tag, CHOL_N, CHOL_N, f_s, a_s, rel))
    if not rel <= 1e-10:
        raise AssertionError("%s: Cholesky residual %.3e" % (tag, rel))
    out["CholeskyOperator"] = {"factor_s": f_s, "apply_s": a_s, "rel": rel}
    return out


# --------------------------------------------------------------------------
# 18-19. checkpointed and traced solves; the sharded operators
# --------------------------------------------------------------------------

def _ckpt_run(pt, A, b, path, log_chunks, **kw):
    """``checkpointed_solve(cg, A, b, path, chunk_iters=CKPT_CHUNK, **kw)``
    with each chunk's (iterations, matvecs) appended to ``log_chunks``."""
    import functools
    from pykrylov_tpu_torch.utils import checkpointed_solve

    @functools.wraps(pt.cg)
    def chunk_cg(*args, **kwargs):
        res = pt.cg(*args, **kwargs)
        log_chunks.append((int(res.n_iter), int(res.n_matvec)))
        return res
    return checkpointed_solve(chunk_cg, A, b, path, chunk_iters=CKPT_CHUNK,
                              **kw)


def phase_checkpoint(pt, A_dia, dia):
    """18a: ``checkpointed_solve(cg, ...)`` on phase 4's Poisson operator
    and f32 b (the DIA SpMV), in chunks of CKPT_CHUNK iterations: a first
    call whose ``keep_going`` stops it after its first chunk, then a
    second call that resumes from the file and runs to convergence.  The
    file after the first call holds chunk 0, its iterate bit for bit and
    the frozen threshold ``rtol ||b||``; the resumed run converges with
    istop 0, a true relative residual in f64 at most 1e-4, and DIA
    launches over both calls = ``total_matvec`` = the chunks' matvecs
    (the x0 product of each resumed chunk included).  Logs
    ``total_matvec`` beside phase 4's count, the restart cost in matvecs
    and seconds, one save's time and a profiled window of two chunks."""
    import shutil
    import tempfile
    import types
    from pykrylov_tpu_torch.utils import load_result, save_result

    tag = "18a checkpointed CG"
    b = dia["b"]
    chunks = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(tmp, "poisson.npz")
        pt.cg(A_dia, b, maxiter=3)                           # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = _ckpt_run(pt, A_dia, b, path, chunks,
                          keep_going=lambda chunk, res: False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = load_result(path)
        thresh = 1e-6 * float(torch.linalg.vector_norm(b))
        log("[%s] first call: %d chunk(s) %s, converged=%s, saved chunk %d, "
            "frozen threshold %.6e (rtol ||b|| = %.6e), %.3f s"
            % (tag, len(chunks), chunks, bool(first.converged),
               int(state["extra_chunk"]), float(state["extra_abs_threshold"]),
               thresh, t1 - t0))
        if (len(chunks) != 1 or bool(first.converged)
                or int(state["extra_chunk"]) != 0
                or not np.array_equal(state["x"], first.x.cpu().numpy())
                or not abs(float(state["extra_abs_threshold"]) - thresh)
                <= 1e-6 * thresh):
            raise AssertionError("%s: the first call's checkpoint is wrong: "
                                 "%s, %r" % (tag, chunks, sorted(state)))
        res = _ckpt_run(pt, A_dia, b, path, chunks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        total = int(res.info["total_matvec"])
        n_iter = sum(c[0] for c in chunks)
        true_rel = _true_rel(b, _dia_f64(A_dia), res.x)
        t2 = time.perf_counter()
        save_result(os.path.join(tmp, "save.npz"), res)
        save_s = time.perf_counter() - t2
        ms = 1e3 * secs / max(n_iter, 1)
        phase4_s = dia["solve_s"]
        log("[%s] resumed: %d chunks in all %s, istop %d, total_matvec %d "
            "(phase 4: %d), DIA launches %s; true relative residual (f64) "
            "%.3e; both calls %.3f s, %.4f ms per iteration (phase 4: %.3f "
            "s); restart cost %d matvecs, %.3f s; one save of x %.3f s"
            % (tag, len(chunks), chunks, int(res.istop), total,
               dia["launches"], counts, true_rel, secs, ms, phase4_s,
               total - dia["launches"], secs - phase4_s, save_s))
        if (int(res.istop) != 0 or not bool(res.converged)
                or total != sum(c[1] for c in chunks)
                or counts != {"dia_spmv": total, "dia_spmm": 0,
                              "sell_spmv": 0, "sell_spmm": 0, "block_cg": 0}
                or not true_rel <= 1e-4):
            raise AssertionError("%s: %r, total_matvec %d, launches %s, "
                                 "residual %.3e" % (tag, res, total, counts,
                                                    true_rel))

        def window():
            del chunks[:]
            _ckpt_run(pt, A_dia, b, os.path.join(tmp, "window.npz"), chunks,
                      max_chunks=2)
            return types.SimpleNamespace(n_iter=sum(c[0] for c in chunks))
        prof = _profile_call(tag, window, ms)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"checkpointed cg": {
        "n_iter": n_iter, "chunks": len(chunks), "total_matvec": total,
        "phase4_matvec": dia["launches"], "launches": counts,
        "solve_s": secs, "phase4_s": phase4_s, "ms_per_iter": ms,
        "save_s": save_s, "true_rel": true_rel, "profile": prof}}


def _kernel_events(events, name):
    """The device kernel events of a Chrome trace whose name holds
    ``name``."""
    return sum(1 for e in events
               if str(e.get("cat", "")).lower() == "kernel"
               and name in str(e.get("name", "")))


def _device_calls(prof, name):
    """The calls of device kernels whose name holds ``name`` that a
    profiler session recorded."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_window(events, first, last):
    """From a Chrome trace: the host span ``first``'s start to the host
    span ``last``'s end; the device events (kernels, copies, fills) that
    start inside it and their busy microseconds; the kernels of the host
    launches made inside it, matched by correlation id (the device
    timeline's clock can run a millisecond off the host's, so a kernel
    launched just after ``first`` starts may carry a device time before
    it); the least and greatest (kernel start - launch start) in
    microseconds; and the host launches whose kernel record is missing,
    before the window and inside it."""
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in (first, last)}
    lo = spans[first]["ts"]
    hi = spans[last]["ts"] + spans[last]["dur"]
    device = [e for e in events if str(e.get("cat", "")).lower()
              in DEVICE_CATS and lo <= e["ts"] <= hi]
    kernels = {e["args"]["correlation"]: e for e in events
               if str(e.get("cat", "")).lower() == "kernel"
               and "correlation" in e.get("args", {})}
    launches = [e for e in events
                if str(e.get("cat", "")).lower() == "cuda_runtime"
                and "LaunchKernel" in str(e.get("name", ""))
                and "correlation" in e.get("args", {})]
    delays = [kernels[e["args"]["correlation"]]["ts"] - e["ts"]
              for e in launches if e["args"]["correlation"] in kernels]
    missing = [e["ts"] for e in launches
               if e["args"]["correlation"] not in kernels]
    launched = [kernels[e["args"]["correlation"]] for e in launches
                if lo <= e["ts"] <= hi
                and e["args"]["correlation"] in kernels]
    return {"device": device, "launched": launched,
            "busy_us": sum(min(e["ts"] + e.get("dur", 0), hi) - e["ts"]
                           for e in device),
            "delay_us": (min(delays, default=None),
                         max(delays, default=None)),
            "launches": len(launches),
            "missing_before": sum(1 for t in missing if t < lo),
            "missing_inside": sum(1 for t in missing if t >= lo)}


def phase_trace(pt, A_bell, bell):
    """18b: ``trace`` around phase 5's solve (CG on tiled 1138bus, the SELL
    SpMV) capped at TRACE_ITERS iterations, an ``annotate`` span around
    the solve and another around the synchronisation after it, after
    TRACE_WARMUP one-element launches in the same trace.  The Chrome
    trace file must exist in the trace directory and hold both spans and,
    between them, one SELL SpMV kernel event for each launch counted and
    no host launch without its kernel record; ``solve_stats`` must agree
    with the result.  The log gives the launches' delays to their
    kernels' starts and the warm-up launches that lost their records.
    The device time between the spans over their wall gives the idle
    share; the traced wall beside phase 5's untraced one gives the
    tracing's cost."""
    import shutil
    import tempfile
    from pykrylov_tpu_torch.utils import annotate, solve_stats, trace

    tag = "18b traced CG"
    b = bell["b"]
    spans = ("chip_smoke.18b.solve", "chip_smoke.18b.sync")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        warm = torch.zeros(1, device=DEVICE)
        torch.cuda.synchronize()
        with trace(tmp) as prof:
            for _ in range(TRACE_WARMUP):
                warm.add_(1)
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            with annotate(spans[0]):
                res = pt.solve(A_bell, b, maxiter=TRACE_ITERS)
            with annotate(spans[1]):
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
        files = sorted(os.listdir(tmp))
        size = os.path.getsize(prof.trace_file)
        with open(prof.trace_file) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_iter, n_mv = int(res.n_iter), int(res.n_matvec)
    names = {e.get("name") for e in events}
    if not set(spans) <= names:
        raise AssertionError("%s: the trace lacks the spans %s" % (tag, spans))
    win = _trace_window(events, *spans)
    kernels = _kernel_events(win["launched"], "sell_spmv_kernel")
    recorded = _device_calls(prof, "sell_spmv_kernel")
    busy = 1e-6 * win["busy_us"]
    stats = solve_stats(res, secs)
    ms = 1e3 * secs / max(n_iter, 1)
    idle = max(0.0, 1 - busy / secs)
    log("[%s] trace %s (%d bytes, %d events): spans %s; between them %d "
        "SELL SpMV kernel events of launches for %d launches counted "
        "(the profiler's "
        "count, warm-up aside, %d); %d host launches, their kernels start "
        "%s to %s us after them, %d without a kernel record before the "
        "solve (of %d warm-up launches) and %d during it; %d iterations (the "
        "cap %d), %.3f s traced, %.4f ms per iteration (phase 5 untraced: "
        "%.4f), device busy %.4f ms per iteration, idle %.1f%%; solve_stats "
        "%s" % (tag, files, size, len(events),
                sorted(n for n in names if str(n).startswith("chip_smoke.")),
                kernels, counts["sell_spmv"], recorded, win["launches"],
                win["delay_us"][0], win["delay_us"][1],
                win["missing_before"], TRACE_WARMUP, win["missing_inside"],
                n_iter, TRACE_ITERS, secs, ms,
                1e3 * bell["solve_s"] / bell["n_iter"], 1e3 * busy / n_iter,
                100 * idle, stats))
    if (len(files) != 1 or counts["sell_spmv"] != n_mv or kernels != n_mv
            or win["missing_inside"] != 0
            or n_iter != TRACE_ITERS or int(res.istop) != 1
            or stats["n_iter"] != n_iter or stats["n_matvec"] != n_mv
            or stats["converged"] is not False
            or stats["resid_norm"] != float(res.resid_norm)
            or busy <= 0):
        raise AssertionError("%s: files %s, %d kernel events, launches %s, "
                             "%r, stats %s" % (tag, files, kernels, counts,
                                               res, stats))
    return {"traced cg": {"n_iter": n_iter, "launches": counts,
                          "kernel_events": kernels, "recorded": recorded,
                          "launch_delay_us": list(win["delay_us"]),
                          "warmup_records_lost": win["missing_before"],
                          "solve_s": secs,
                          "ms_per_iter": ms, "trace_bytes": size,
                          "profile": {"busy_ms_per_iter": 1e3 * busy / n_iter,
                                      "idle": idle}}}


def _mesh_of(pt):
    """MESH_SHARDS shard slots on the card: every slot the one device."""
    mesh = pt.parallel.make_mesh(MESH_SHARDS, device=DEVICE)
    if len(set(mesh.slots)) != 1 or mesh.size != MESH_SHARDS:
        raise AssertionError("mesh %r: not %d slots of one device"
                             % (mesh, MESH_SHARDS))
    return mesh


def _sharded_solve(tag, label, fn, kernel, products):
    """:func:`_counted_solve` of a sharded operator: ``kernel`` launches
    MESH_SHARDS times a product, ``products(res)`` products in all."""
    return _counted_solve(tag, label, fn, kernel, lambda res: (
        MESH_SHARDS * products(res) - int(res.n_matvec)))


def phase_halo(pt, A_dia, dia):
    """19a: ``HaloDiaOperator`` of phase 4's Poisson matrix (f32) over a
    mesh of MESH_SHARDS slots on the card (3,456,000 rows a shard at n =
    240), built with its defaults.  One product and one K = KB block
    product, each MESH_SHARDS launches: each shard's rows bit for bit
    the plain version (``dia_matvec_plain`` / ``dia_matmat_plain``) on
    that shard's halo-extended storage and x, and the whole against
    phase 4's unsharded kernel products on the same x (bit for bit: each
    shard's rows sum the same diagonals in the same order over the same
    x values); CG on phase 4's b: phase 4's count (exactly, when the
    products are bit for bit), DIA launches = MESH_SHARDS x matvecs, the
    true relative residual in f64 at most 1e-4, a profiled window."""
    from pykrylov_tpu_torch.parallel import HaloDiaOperator, shard_vector
    from pykrylov_tpu_torch.parallel.sharded import rows_on
    from pykrylov_tpu_torch.sparse import kernels as K

    tag = "19a halo DIA"
    mesh = _mesh_of(pt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H = HaloDiaOperator(A_dia.container, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = A_dia.shape[0]
    L = m // MESH_SHARDS
    log("[%s] %r: %d shards of %d rows, halo width %d, pad %d, kernel path "
        "%s, built in %.2f s" % (tag, mesh, MESH_SHARDS, L, H.halo_width,
                                 H.pad, H.local_kernel, build_s))
    if not H.local_kernel or H.pad != 0:
        raise AssertionError("%s: kernel path %s, pad %d"
                             % (tag, H.local_kernel, H.pad))
    g = torch.Generator(device=DEVICE).manual_seed(19)
    out = {"build_s": build_s}
    w, offsets = H.halo_width, tuple(H.offsets)
    for label, x, kernel, plain in (
            ("product", torch.randn(m, generator=g, device=DEVICE),
             "dia_spmv", K.dia_matvec_plain),
            ("K=%d block product" % KB,
             torch.randn(m, KB, generator=g, device=DEVICE), "dia_spmm",
             K.dia_matmat_plain)):
        xs = shard_vector(x, mesh)
        _reset_counts()
        y = H * xs
        torch.cuda.synchronize()
        counts = _counts()
        # each shard's rows: the plain version on its extended block
        for k, data in enumerate(H.container):
            xe = rows_on(xs, k * L - w, (k + 1) * L + w, mesh.slots[k])
            _exact("%s, shard %d" % (label, k), y[k * L:(k + 1) * L],
                   plain(data, offsets, xe)[w:w + L], tag=tag)
            del xe
        ref = A_dia * x
        same = torch.equal(y, ref)
        err = relerr(y, ref)
        log("[%s] %s: %s launches, bit for bit phase 4's unsharded kernel "
            "product: %s (rel err %.3e)" % (tag, label, counts[kernel], same,
                                            err))
        if counts[kernel] != MESH_SHARDS or sum(counts.values()) != \
                MESH_SHARDS or not err <= REL_BOUND[torch.float32]:
            raise AssertionError("%s %s: launches %s, rel err %.3e"
                                 % (tag, label, counts, err))
        out[label] = {"launches": counts, "bit_for_bit": same,
                      "rel_err": err}
        del x, xs, y, ref
    b = shard_vector(dia["b"], mesh)
    pt.cg(H, b, maxiter=3)                                   # warm-up
    res, secs, counts = _sharded_solve(tag, "cg", lambda: pt.cg(H, b),
                                       "dia_spmv", lambda r: int(r.n_matvec))
    n_iter = int(res.n_iter)
    true_rel = _true_rel(b, _dia_f64(A_dia), res.x)
    ms = 1e3 * secs / max(n_iter, 1)
    exact = all(out[k]["bit_for_bit"] for k in out if k != "build_s")
    log("[%s] cg: %d iterations (phase 4: %d), true relative residual (f64) "
        "%.3e, %.4f ms per iteration (phase 4 unsharded: %.4f)"
        % (tag, n_iter, dia["n_iter"], true_rel, ms,
           1e3 * dia["solve_s"] / dia["n_iter"]))
    if (int(res.istop) != 0 or not true_rel <= 1e-4
            or abs(n_iter - dia["n_iter"]) > (0 if exact else 2)):
        raise AssertionError("%s: %r, %d iterations against phase 4's %d, "
                             "residual %.3e" % (tag, res, n_iter,
                                                dia["n_iter"], true_rel))
    prof = _profile_call("%s, cg" % tag, lambda: pt.cg(
        H, b, maxiter=PIPE_PROFILE_ITERS), ms)
    out["cg"] = {"kernel": "dia_spmv", "n_iter": n_iter,
                 "n_matvec": int(res.n_matvec), "launches": counts,
                 "solve_s": secs, "ms_per_iter": ms, "true_rel": true_rel,
                 "phase4_ms_per_iter": 1e3 * dia["solve_s"] / dia["n_iter"],
                 "profile": prof}
    return out


def _coo_f64(coo, n_out, transpose=False):
    """A x (A' x) in f64 through the COO triples, for a true residual."""
    vals, rows, cols, _ = coo
    r = torch.from_numpy(np.asarray(rows)).to(DEVICE)
    c = torch.from_numpy(np.asarray(cols)).to(DEVICE)
    v = torch.from_numpy(np.asarray(vals)).to(DEVICE, torch.float64)
    if transpose:
        r, c = c, r

    def ax(x):
        y = torch.zeros(n_out, dtype=torch.float64, device=DEVICE)
        return y.index_add_(0, r, v * x.double()[c])
    return ax


def _gather_exchange(pt, tag, coo, A_bell, bell, ax64):
    """19b's exchange leg: tiled 1138bus over EXCHANGE_SHARDS slots, whose
    partition cuts tiles, so each shard receives rows from its
    neighbours: one product against phase 5's card form (to REL_BOUND),
    CG within ITER_RTOL of phase 5's count with EXCHANGE_SHARDS SELL
    launches a matvec, the true relative residual in f64 at most 1e-4."""
    from pykrylov_tpu_torch.parallel import (GatherBellOperator, make_mesh,
                                             shard_vector)
    from pykrylov_tpu_torch.sparse import formats as F
    vals, rows, cols, shape = coo
    mesh = make_mesh(EXCHANGE_SHARDS, device=DEVICE)
    t0 = time.perf_counter()
    G = GatherBellOperator(F.coo_from_arrays(vals, rows, cols, shape,
                                             device=None),
                           mesh, symmetric=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(19)
    x = torch.zeros(G.nargin, device=DEVICE)
    x[:m] = torch.randn(m, generator=g, device=DEVICE)
    _reset_counts()
    y = G * shard_vector(x, mesh)
    torch.cuda.synchronize()
    counts = _counts()
    err = relerr(y[:m], A_bell * x[:m])
    log("[%s] exchange: tiled 1138bus over %r, built in %.2f s, pad %d, "
        "comm entries %d a product (true %d), product: %s SELL launches, "
        "rel err against phase 5's card form %.3e"
        % (tag, mesh, build_s, G.pad, G.comm_entries_per_matvec,
           G.comm_entries_true, counts["sell_spmv"], err))
    if (G.comm_entries_true == 0 or counts["sell_spmv"] != EXCHANGE_SHARDS
            or not err <= REL_BOUND[torch.float32] or y[m:].any()):
        raise AssertionError("%s exchange: comm %d, launches %s, rel err "
                             "%.3e" % (tag, G.comm_entries_true, counts,
                                       err))
    b = torch.zeros(G.nargin, device=DEVICE)
    b[:m] = bell["b"]
    b = shard_vector(b, mesh)
    res, secs, counts = _counted_solve(
        tag, "exchange cg", lambda: pt.solve(G, b), "sell_spmv",
        lambda r: (EXCHANGE_SHARDS - 1) * int(r.n_matvec))
    n_iter = int(res.n_iter)
    true_rel = _true_rel(b[:m], ax64, res.x[:m])
    ms = 1e3 * secs / max(n_iter, 1)
    log("[%s] exchange cg: %d iterations (phase 5: %d), true relative "
        "residual (f64) %.3e, %.4f ms per iteration"
        % (tag, n_iter, bell["n_iter"], true_rel, ms))
    if (int(res.istop) != 0 or not true_rel <= 1e-4
            or abs(n_iter - bell["n_iter"]) > ITER_RTOL * bell["n_iter"]):
        raise AssertionError("%s exchange: %r, residual %.3e"
                             % (tag, res, true_rel))
    prof = _profile_call("%s, exchange cg" % tag, lambda: pt.cg(
        G, b, maxiter=PIPE_PROFILE_ITERS), ms)
    return {"n_iter": n_iter, "launches": counts, "solve_s": secs,
            "ms_per_iter": ms, "true_rel": true_rel, "build_s": build_s,
            "comm_entries": G.comm_entries_per_matvec,
            "comm_entries_true": G.comm_entries_true, "product_rel": err,
            "profile": prof}


def _perturbed_twin(pt, A):
    """19b's control: the unsharded operator with its A'u rounded
    differently (a seeded relative perturbation of 1e-16), as a sharded
    exchange's shard-order sum rounds it."""
    m, n = A.shape
    ge = torch.Generator(device=DEVICE).manual_seed(1)
    return pt.LinearOperator(
        n, m, matvec=lambda v: A * v,
        matvec_transp=lambda u: (A.T * u) * (1 + 1e-16 * torch.randn(
            n, generator=ge, device=DEVICE, dtype=torch.float64)),
        dtype=A.dtype, device=DEVICE)


def _transposed_exchange(pt, tag, se, opts):
    """19b's transposed exchange leg: phase 10's state-estimation matrix
    with ``with_transpose=True`` over SE_EXCHANGE_SHARDS slots, whose
    partition cuts areas, so each shard's transposed partials reach rows
    that other shards own.  A v, A^T u and an f64 K = KB block A^T U
    against phase 10's unsharded card forms (to REL_BOUND), one launch a
    shard each; A^T u bit for bit the shards' plain partials summed into
    their owners' rows in shard order; LSQR capped at SHARD_XLLS_ITERS
    with SELL launches = SE_EXCHANGE_SHARDS x (matvecs + 1), held to the
    unsharded capped LSQR by its residual norm (SHARD_XLLS_RTOL) and x
    (SHARD_XLLS_XTOL), beside the control of :func:`phase_gather_bell`
    at the same cap; a profiled window."""
    from pykrylov_tpu_torch.parallel import (GatherBellOperator, make_mesh,
                                             shard_vector)
    from pykrylov_tpu_torch.parallel.gather import private_rows
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import sell as S
    A_se, coo_se, b_se = se
    vals, rows, cols, shape = coo_se
    m, n = shape
    mesh = make_mesh(SE_EXCHANGE_SHARDS, device=DEVICE)
    t0 = time.perf_counter()
    G = GatherBellOperator(F.coo_from_arrays(vals, rows, cols, shape,
                                             device=None),
                           mesh, with_transpose=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log("[%s] transposed exchange: state estimation over %r, built in %.2f "
        "s, pad %d x %d, comm entries %d a product (true %d)"
        % (tag, mesh, build_s, G.pad, G.pad_n, G.comm_entries_per_matvec,
           G.comm_entries_true))
    if G.comm_entries_true == 0:
        raise AssertionError("%s transposed exchange: the partition cuts "
                             "no area" % tag)
    out = {"build_s": build_s, "comm_entries": G.comm_entries_per_matvec,
           "comm_entries_true": G.comm_entries_true}
    L = G.nargout // SE_EXCHANGE_SHARDS
    priv = [torch.from_numpy(r).to(DEVICE) for r in private_rows(
        G.schedule[1], SE_EXCHANGE_SHARDS, G.nargin // SE_EXCHANGE_SHARDS)]
    g = torch.Generator(device=DEVICE).manual_seed(19)

    for label, prod, ref_prod, w_in, w_out, cols, kernel in (
            ("A v (f64 v)", lambda v: G * v, lambda v: A_se * v, n, m,
             None, "sell_spmv"),
            ("A^T u (f64 u)", lambda u: G.T * u, lambda u: A_se.T * u, m, n,
             None, "sell_spmv"),
            ("A^T U (f64 U, K=%d)" % KB, lambda u: G.T * u,
             lambda u: A_se.T * u, m, n, KB, "sell_spmm")):
        total = G.nargin if w_in == n else G.nargout
        v = torch.zeros((total,) if cols is None else (total, cols),
                        dtype=torch.float64, device=DEVICE)
        v[:w_in] = torch.randn(v[:w_in].shape, generator=g, device=DEVICE,
                               dtype=torch.float64)
        v = shard_vector(v, mesh)
        _reset_counts()
        y = prod(v)
        torch.cuda.synchronize()
        counts = _counts()
        err = relerr(y[:w_out], ref_prod(v[:w_in]))
        log("[%s] transposed exchange %s: %d %s launches, rel err against "
            "phase 10's unsharded card form %.3e" % (tag, label,
                                                     counts[kernel], kernel,
                                                     err))
        if (counts[kernel] != SE_EXCHANGE_SHARDS
                or sum(counts.values()) != SE_EXCHANGE_SHARDS
                or not err <= REL_BOUND[torch.float64] or y[w_out:].any()):
            raise AssertionError("%s transposed exchange %s: launches %s, "
                                 "rel err %.3e" % (tag, label, counts, err))
        out[label] = {"launches": counts, "rel_err": err}
        if label.startswith("A^T u"):
            # the reversed exchange: each shard's private partials summed
            # into their owners' rows in shard order
            ref = torch.zeros_like(y)
            for k, card in enumerate(G.cards_t):
                ref.index_add_(0, priv[k], S.sell_matvec_plain(
                    card, v[k * L:(k + 1) * L]))
            _exact("transposed exchange A^T u", y, ref, tag=tag)
        del v, y

    bb = torch.zeros(G.nargout, dtype=b_se.dtype, device=DEVICE)
    bb[:m] = b_se
    bs = shard_vector(bb, mesh)
    cap = dict(opts, itnlim=SHARD_XLLS_ITERS)
    label = "lsqr, transposed exchange, itnlim=%d" % SHARD_XLLS_ITERS
    res, secs, counts = _counted_solve(
        tag, label, lambda: pt.lsqr(G, bs, **cap), "sell_spmv",
        lambda r: SE_EXCHANGE_SHARDS * (int(r.n_matvec)
                                        + _initial_launch(r))
        - int(r.n_matvec))
    ref = pt.lsqr(A_se, b_se, **cap)
    ctrl = pt.lsqr(_perturbed_twin(pt, A_se), b_se, **cap)

    def rel(x, y):
        return (torch.linalg.vector_norm(x - y)
                / torch.linalg.vector_norm(y)).item()
    x_rel, ctrl_rel = rel(res.x[:n], ref.x), rel(ctrl.x, ref.x)
    r_rel = abs(float(res.resid_norm) - float(ref.resid_norm)) \
        / float(ref.resid_norm)
    ms = 1e3 * secs / max(int(res.n_iter), 1)
    log("[%s] %s: istop %d and %d (unsharded), %d iterations, ||r|| %.9e "
        "and %.9e (%.3e apart); x against the unsharded capped LSQR's %.3e "
        "relative, the control's (A'u perturbed by 1e-16) %.3e; %.4f ms per "
        "iteration" % (tag, label, int(res.istop), int(ref.istop),
                       int(res.n_iter), float(res.resid_norm),
                       float(ref.resid_norm), r_rel, x_rel, ctrl_rel, ms))
    if (int(res.n_iter) != int(ref.n_iter) or int(res.istop) != 7
            or not r_rel <= SHARD_XLLS_RTOL or not x_rel <= SHARD_XLLS_XTOL
            or res.x[n:].any()):
        raise AssertionError("%s %s: %r against %r, ||r|| %.3e apart, x "
                             "%.3e apart" % (tag, label, res, ref, r_rel,
                                             x_rel))
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.lsqr(
        G, bs, **dict(opts, itnlim=PROFILE_ITERS // 2)), ms)
    out[label] = {"kernel": "sell_spmv", "n_iter": int(res.n_iter),
                  "launches": counts, "solve_s": secs, "ms_per_iter": ms,
                  "x_rel": x_rel, "control_x_rel": ctrl_rel,
                  "resid_rel": r_rel, "profile": prof}
    return out


def phase_gather_bell(pt, A_bell, coo_bell, bell, se):
    """19b: ``GatherBellOperator`` over a mesh of MESH_SHARDS slots on the
    card, each shard's window-1 BELL packing as one SELL card form.  Tiled
    1138bus (symmetric, with the verified shadow): one product and one
    K = KB block product against phase 5's unsharded card form (to
    REL_BOUND: another packing sums in another order), each shard's rows
    its kernel's product on its private x, bit for bit the plain
    version; CG on phase 5's b within ITER_RTOL of phase 5's count, SELL
    launches = MESH_SHARDS x matvecs, the true relative residual in f64
    at most 1e-4, a profiled window; the same over EXCHANGE_SHARDS slots,
    whose partition cuts tiles (:func:`_gather_exchange`);
    ``cg(replace_every=50)`` capped at SHARD_FF_ITERS (its products
    compensated over the shadow ELL arrays, as the JAX package's are: no
    SELL launch), its verified residual the f64 one to VER_AGREE.  Phase
    10's state-estimation matrix with ``with_transpose=True``: A and A^T
    on an f64 vector and an f64 K = KB block against phase 10's unsharded
    card forms (A bit for bit, A^T to REL_BOUND: the partials are summed
    in shard order), then LSQR capped at SHARD_LLS_ITERS with SELL
    launches = MESH_SHARDS x (matvecs + 1), held to the unsharded capped
    LSQR by its residual norm (SHARD_LLS_RTOL) and x (SHARD_LLS_XTOL),
    beside a control: the unsharded operator with its A'u perturbed by
    1e-16 relative; the same matrix over SE_EXCHANGE_SHARDS slots, whose
    partition cuts areas (:func:`_transposed_exchange`)."""
    from pykrylov_tpu_torch.parallel import GatherBellOperator, shard_vector
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "19b gather SELL"
    mesh = _mesh_of(pt)
    out = {}
    vals, rows, cols, shape = coo_bell
    t0 = time.perf_counter()
    G = GatherBellOperator(F.coo_from_arrays(vals, rows, cols, shape,
                                             device=None),
                           mesh, symmetric=True, verified_shadow=True)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    log("[%s] tiled 1138bus over %r: built in %.2f s, pad %d, comm entries "
        "%d a product (true %d, all-gather %d), %d BELL slots a device, "
        "card forms %s bytes" % (tag, mesh, out["build_s"], G.pad,
                                 G.comm_entries_per_matvec,
                                 G.comm_entries_true,
                                 G.allgather_entries_per_matvec,
                                 G.slots_per_device,
                                 [S.sell_bytes(c) for c in G.cards]))
    m = shape[0]
    L = G.nargout // MESH_SHARDS
    from pykrylov_tpu_torch.parallel.gather import private_rows
    rows_k = [torch.from_numpy(r).to(DEVICE) for r in private_rows(
        G.schedule[1], MESH_SHARDS, G.nargin // MESH_SHARDS)]
    g = torch.Generator(device=DEVICE).manual_seed(19)
    for label, shp, kernel, product, plain in (
            ("product", (G.nargin,), "sell_spmv", S.sell_matvec,
             S.sell_matvec_plain),
            ("K=%d block product" % KB, (G.nargin, KB), "sell_spmm",
             S.sell_matmat, S.sell_matmat_plain)):
        x = shard_vector(torch.randn(shp, generator=g, device=DEVICE), mesh)
        _reset_counts()
        y = G * x
        torch.cuda.synchronize()
        counts = _counts()
        err = relerr(y[:m], A_bell * x[:m])
        log("[%s] %s: %s launches, rel err against phase 5's card form "
            "%.3e" % (tag, label, counts[kernel], err))
        if counts[kernel] != MESH_SHARDS or sum(counts.values()) != \
                MESH_SHARDS or not err <= REL_BOUND[torch.float32]:
            raise AssertionError("%s %s: launches %s, rel err %.3e"
                                 % (tag, label, counts, err))
        out[label] = {"launches": counts, "rel_err": err}
        # each shard's rows: its kernel on its private x, bit for bit the
        # plain version
        for k, card in enumerate(G.cards):
            xk = x[rows_k[k]]
            _exact("%s, shard %d" % (label, k), product(card, xk),
                   plain(card, xk), tag=tag)
            if not torch.equal(product(card, xk), y[k * L:(k + 1) * L]):
                raise AssertionError("%s %s: shard %d's rows are not its "
                                     "kernel's product" % (tag, label, k))
        del x, y

    b = shard_vector(bell["b"], mesh)
    ax64 = _coo_f64(coo_bell, m)
    out["exchange"] = _gather_exchange(pt, tag, coo_bell, A_bell, bell, ax64)
    pt.cg(G, b, maxiter=3)                                   # warm-up
    res, secs, counts = _sharded_solve(tag, "cg", lambda: pt.solve(G, b),
                                       "sell_spmv", lambda r: int(r.n_matvec))
    n_iter = int(res.n_iter)
    true_rel = _true_rel(b, ax64, res.x)
    ms = 1e3 * secs / max(n_iter, 1)
    log("[%s] cg: %d iterations (phase 5: %d), true relative residual (f64) "
        "%.3e, %.4f ms per iteration (phase 5 unsharded: %.4f)"
        % (tag, n_iter, bell["n_iter"], true_rel, ms,
           1e3 * bell["solve_s"] / bell["n_iter"]))
    if (int(res.istop) != 0 or not true_rel <= 1e-4
            or abs(n_iter - bell["n_iter"]) > ITER_RTOL * bell["n_iter"]):
        raise AssertionError("%s: %r, %d iterations against phase 5's %d, "
                             "residual %.3e" % (tag, res, n_iter,
                                                bell["n_iter"], true_rel))
    prof = _profile_call("%s, cg" % tag, lambda: pt.cg(
        G, b, maxiter=PIPE_PROFILE_ITERS), ms)
    out["cg"] = {"kernel": "sell_spmv", "n_iter": n_iter,
                 "n_matvec": int(res.n_matvec), "launches": counts,
                 "solve_s": secs, "ms_per_iter": ms, "true_rel": true_rel,
                 "phase5_ms_per_iter": 1e3 * bell["solve_s"] / bell["n_iter"],
                 "profile": prof}

    label = "cg(replace_every=50), verified shadow, maxiter=%d" \
        % SHARD_FF_ITERS
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.cg(G, b, replace_every=50, maxiter=SHARD_FF_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    true_rel = _true_rel(b, ax64, res.x.double() + res.info["x_lo"].double())
    claimed = float(res.resid_norm) / float(torch.linalg.vector_norm(
        b.double()))
    nrep = int(res.info["n_replacements"])
    ms = 1e3 * secs / max(int(res.n_iter), 1)
    log("[%s] %s: istop %d, %d iterations, %d replacements, launches %s, "
        "verified relative residual %.3e, f64 %.3e, %.3f s, %.4f ms per "
        "iteration" % (tag, label, int(res.istop), int(res.n_iter), nrep,
                       counts, claimed, true_rel, secs, ms))
    if (int(res.n_iter) != SHARD_FF_ITERS or int(res.istop) != 1
            or nrep < SHARD_FF_ITERS // 50 or any(counts.values())
            or not abs(claimed - true_rel) <= VER_AGREE * true_rel):
        raise AssertionError("%s %s: %r, launches %s, claimed %.3e, f64 "
                             "%.3e" % (tag, label, res, counts, claimed,
                                       true_rel))
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.cg(
        G, b, replace_every=50, maxiter=VER_PROFILE_ITERS), ms)
    out[label] = {"n_iter": int(res.n_iter), "launches": counts,
                  "replacements": nrep, "solve_s": secs, "ms_per_iter": ms,
                  "true_rel": true_rel, "profile": prof}
    del G, b, res

    A_se, coo_se, b_se = se
    vals, rows, cols, shape = coo_se
    t0 = time.perf_counter()
    Gs = GatherBellOperator(F.coo_from_arrays(vals, rows, cols, shape,
                                              device=None),
                            mesh, with_transpose=True)
    torch.cuda.synchronize()
    out["se_build_s"] = time.perf_counter() - t0
    log("[%s] state estimation %d x %d over %r, with_transpose: built in "
        "%.2f s, pad %d x %d, comm entries %d a product"
        % (tag, shape[0], shape[1], mesh, out["se_build_s"], Gs.pad,
           Gs.pad_n, Gs.comm_entries_per_matvec))
    g = torch.Generator(device=DEVICE).manual_seed(19)
    for name, prod, ref_prod, width, bound in (
            ("A", lambda v: Gs * v, lambda v: A_se * v, shape[1], 0.0),
            ("A^T", lambda v: Gs.T * v, lambda v: A_se.T * v, shape[0],
             REL_BOUND[torch.float64])):
        for cols, kernel in ((None, "sell_spmv"), (KB, "sell_spmm")):
            shp = (width,) if cols is None else (width, cols)
            v = shard_vector(torch.randn(shp, generator=g, device=DEVICE,
                                         dtype=torch.float64), mesh)
            _reset_counts()
            y = prod(v)
            torch.cuda.synchronize()
            counts = _counts()
            err = relerr(y, ref_prod(v))
            label = "%s v (f64 v)" % name if cols is None \
                else "%s V (f64 V, K=%d)" % (name, cols)
            log("[%s] %s: %d %s launches, rel err against phase 10's "
                "unsharded card form %.3e (bound %.0e)"
                % (tag, label, counts[kernel], kernel, err, bound))
            if counts[kernel] != MESH_SHARDS or \
                    sum(counts.values()) != MESH_SHARDS or not err <= bound:
                raise AssertionError("%s %s: launches %s, rel err %.3e"
                                     % (tag, label, counts, err))
            out["state estimation " + label] = {"launches": counts,
                                                "rel_err": err}
    bs = shard_vector(b_se, mesh)
    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0,
            "itnlim": SHARD_LLS_ITERS}
    pt.lsqr(Gs, bs, **dict(opts, itnlim=3))                  # warm-up
    label = "lsqr, with_transpose, itnlim=%d" % SHARD_LLS_ITERS
    res, secs, counts = _sharded_solve(
        tag, label, lambda: pt.lsqr(Gs, bs, **opts), "sell_spmv",
        lambda r: int(r.n_matvec) + _initial_launch(r))
    ref = pt.lsqr(A_se, b_se, **opts)
    ctrl = pt.lsqr(_perturbed_twin(pt, A_se), b_se, **opts)

    def rel(x, y):
        return (torch.linalg.vector_norm(x - y)
                / torch.linalg.vector_norm(y)).item()
    x_rel, ctrl_rel = rel(res.x, ref.x), rel(ctrl.x, ref.x)
    r_rel = abs(float(res.resid_norm) - float(ref.resid_norm)) \
        / float(ref.resid_norm)
    ms = 1e3 * secs / max(int(res.n_iter), 1)
    log("[%s] %s: istop %d and %d (unsharded), %d iterations, ||r|| %.6e "
        "and %.6e (%.3e apart); x against the unsharded capped LSQR's "
        "%.3e relative, the control's (A'u perturbed by 1e-16) %.3e; %.4f "
        "ms per iteration" % (tag, label, int(res.istop), int(ref.istop),
                              int(res.n_iter), float(res.resid_norm),
                              float(ref.resid_norm), r_rel, x_rel, ctrl_rel,
                              ms))
    if (int(res.n_iter) != int(ref.n_iter) or int(res.istop) != 7
            or not r_rel <= SHARD_LLS_RTOL or not x_rel <= SHARD_LLS_XTOL):
        raise AssertionError("%s %s: %r against %r, ||r|| %.3e apart, x "
                             "%.3e apart" % (tag, label, res, ref, r_rel,
                                             x_rel))
    prof = _profile_call("%s, %s" % (tag, label), lambda: pt.lsqr(
        Gs, bs, **dict(opts, itnlim=PROFILE_ITERS // 2)), ms)
    out[label] = {"kernel": "sell_spmv", "n_iter": int(res.n_iter),
                  "launches": counts, "solve_s": secs, "ms_per_iter": ms,
                  "x_rel": x_rel, "control_x_rel": ctrl_rel,
                  "resid_rel": r_rel, "profile": prof}
    del Gs, bs
    out["transposed exchange"] = _transposed_exchange(pt, tag, se, opts)
    return out


def phase_stencils(pt, A_dia, dia):
    """19c: the matrix-free products over MESH_SHARDS slots on the card:
    ``HaloStencilPoisson3DOperator`` (a z-slab a shard) and
    ``Halo2DPoissonOperator`` on a 2 x 2 mesh (bricks) at n = N, f32, CG
    on phase 4's b (brick-ordered for the 2-D mesh) within 2 iterations
    of phase 4's count, the true relative residual in f64 through phase
    4's matrix at most 1e-4, no kernel launch; ``TallSkinnyOperator`` of a
    dense f32 TALL_M x TALL_N matrix (standard normal, seed 19): LSQR on
    an f32 b to atol = btol = LLS_TOL, istop 1 or 2, the optimality
    certificate ``||A'r|| / (||A||_F ||r||)`` in f64 at most CERT_BOUND.
    Each solve with a profiled window."""
    from pykrylov_tpu_torch import parallel as par

    tag = "19c matrix-free and tall"
    out = {}
    b = dia["b"]
    ax64 = _dia_f64(A_dia)
    mesh = _mesh_of(pt)
    rz, ry = 2, MESH_SHARDS // 2
    mesh2 = par.make_mesh2d(rz, ry, device=DEVICE)
    for label, op, rhs, back in (
            ("HaloStencilPoisson3DOperator, %d z-slabs" % MESH_SHARDS,
             par.HaloStencilPoisson3DOperator(N, mesh, dtype=torch.float32),
             par.shard_vector(b, mesh), lambda x: x),
            ("Halo2DPoissonOperator, %d x %d bricks" % (rz, ry),
             par.Halo2DPoissonOperator(N, mesh2, dtype=torch.float32),
             par.shard_vector_2d(par.to_bricks(b, N, rz, ry), mesh2),
             lambda x: par.from_bricks(x, N, rz, ry))):
        pt.cg(op, rhs, maxiter=3)                            # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.cg(op, rhs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        n_iter = int(res.n_iter)
        true_rel = _true_rel(b, ax64, back(res.x))
        ms = 1e3 * secs / max(n_iter, 1)
        log("[%s] cg, %s: istop %d, %d iterations (phase 4: %d), true "
            "relative residual (f64) %.3e, launches %s, %.3f s, %.4f ms per "
            "iteration" % (tag, label, int(res.istop), n_iter, dia["n_iter"],
                           true_rel, counts, secs, ms))
        if (int(res.istop) != 0 or abs(n_iter - dia["n_iter"]) > 2
                or not true_rel <= 1e-4 or any(counts.values())):
            raise AssertionError("%s %s: %r, residual %.3e, launches %s"
                                 % (tag, label, res, true_rel, counts))
        prof = _profile_call("%s, %s" % (tag, label), lambda: pt.cg(
            op, rhs, maxiter=PIPE_PROFILE_ITERS), ms)
        out[label] = {"n_iter": n_iter, "launches": counts, "solve_s": secs,
                      "ms_per_iter": ms, "true_rel": true_rel,
                      "profile": prof}
        del op, rhs, res

    g = torch.Generator(device=DEVICE).manual_seed(19)
    a = torch.randn(TALL_M, TALL_N, generator=g, device=DEVICE)
    t0 = time.perf_counter()
    T = par.TallSkinnyOperator(a, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bt = par.shard_vector(torch.randn(TALL_M, generator=g, device=DEVICE),
                          mesh)
    opts = {"atol": LLS_TOL, "btol": LLS_TOL}
    pt.lsqr(T, bt, itnlim=3, **opts)                         # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.lsqr(T, bt, **opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    a64 = a.double()
    r = bt.double() - a64 @ res.x.double()
    cert = (torch.linalg.vector_norm(a64.T @ r)
            / (torch.linalg.vector_norm(a64) * torch.linalg.vector_norm(r))
            ).item()
    del a64, r
    n_iter = int(res.n_iter)
    ms = 1e3 * secs / max(n_iter, 1)
    label = "TallSkinnyOperator, dense f32 %d x %d, lsqr" % (TALL_M, TALL_N)
    log("[%s] %s (built in %.2f s): istop %d, %d iterations, certificate "
        "||A'r||/(||A||_F ||r||) (f64) %.3e, launches %s, %.3f s, %.4f ms "
        "per iteration" % (tag, label, build_s, int(res.istop), n_iter, cert,
                           counts, secs, ms))
    if int(res.istop) not in (1, 2) or not cert <= CERT_BOUND \
            or any(counts.values()):
        raise AssertionError("%s %s: %r, certificate %.3e, launches %s"
                             % (tag, label, res, cert, counts))
    prof = _profile_call("%s, %s" % (tag, label),
                         lambda: pt.lsqr(T, bt, **opts), ms)
    out[label] = {"n_iter": n_iter, "launches": counts, "solve_s": secs,
                  "ms_per_iter": ms, "certificate": cert, "build_s": build_s,
                  "profile": prof}
    return out


# --------------------------------------------------------------------------
# 20. the native host pipeline; the examples on the card
# --------------------------------------------------------------------------

POISSON_FILL_N = 160    # 3-D Poisson grid of the DIA fill check (20a)
CHEB_N = 64             # demo_chebyshev's grid on a card (20b)
GENERAL_N = 63424       # demo_general's rows on a card (20b)


@contextlib.contextmanager
def native_bypassed():
    """Within the block the native library is bypassed in this process:
    every native entry returns None and each caller takes its NumPy path
    (the port's ``_plan_bands_sorted``, ``_plan_blocks_py``, NumPy parser
    and fills), as where the library is unavailable."""
    from pykrylov_tpu_torch import native
    saved = native._lib
    native._lib = "bypassed by chip_smoke"
    try:
        if native.available():
            raise AssertionError("the native library is still in use")
        yield
    finally:
        native._lib = saved


def _same_arrays(label, a, b):
    """Two packings' fields equal: tensors and arrays element for element
    with the same dtype, everything else by ``==``."""
    if isinstance(a, (torch.Tensor, np.ndarray)):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            raise AssertionError("%s: the packings differ" % label)
        return 1
    if isinstance(a, (tuple, list)) and not hasattr(a, "_fields"):
        if len(a) != len(b):
            raise AssertionError("%s: %d against %d parts"
                                 % (label, len(a), len(b)))
        return sum(_same_arrays("%s[%d]" % (label, i), x, y)
                   for i, (x, y) in enumerate(zip(a, b)))
    if hasattr(a, "_fields"):
        return sum(_same_arrays("%s.%s" % (label, f), getattr(a, f),
                                getattr(b, f)) for f in a._fields)
    if a != b:
        raise AssertionError("%s: %r against %r" % (label, a, b))
    return 0


def _planners(label, coo, window):
    """The window planner of ``bell_from_coo`` on the whole of ``coo``
    (the first level's, spill cost ``_SPILL_BYTES``), native and NumPy:
    the arrays equal, and each one's seconds.  Window 1: the fused sort
    and plan against the lexsort, ``_plan_bands_sorted`` and the ordinal
    pass; window 2: ``bell_plan_native`` against ``_plan_blocks_py`` on
    the same (row, col)-sorted arrays."""
    from pykrylov_tpu_torch import native
    from pykrylov_tpu_torch.sparse import bell as B
    rows = np.asarray(coo.row).astype(np.int64)
    cols = np.asarray(coo.col).astype(np.int64)
    L = B.LANES
    nblocks = max(1, -(-coo.shape[0] // L))
    sc = B._SPILL_BYTES
    if window == 1:
        t0 = time.perf_counter()
        nat = native.bell_sort_plan_w1_native(rows, cols, nblocks, sc)
        t1 = time.perf_counter()
        order = np.lexsort((cols, rows, cols // L, rows // L))
        rs, cs = rows[order], cols[order]
        _, woff, cap, dpb, gfirst = B._plan_bands_sorted(
            rs, cs // L, rs // L, nblocks, sc)
        k = np.arange(len(rs)) - np.repeat(gfirst,
                                           np.diff(np.r_[gfirst, len(rs)]))
        ref = (order, rs, cs, woff, cap, k, dpb)
    else:
        order = np.lexsort((cols, rows))
        rs, cs = rows[order], cols[order]
        bounds = np.searchsorted(rs // L, np.arange(nblocks + 1))
        t0 = time.perf_counter()
        nat = native.bell_plan_native(rs, cs, nblocks, sc)
        t1 = time.perf_counter()
        ref = B._plan_blocks_py(rs, cs, cs // L, bounds, nblocks, sc)
    t2 = time.perf_counter()
    held = _same_arrays("%s planner" % label, tuple(nat), tuple(ref))
    return held, t1 - t0, t2 - t1


def _repack(tag, label, A, coo):
    """Each product of the native-built operator ``A`` against the NumPy
    path in the window mode ``A`` holds (the window rule plans window 2
    only with the library or below 100,000 nonzeros, so the paths are
    compared per mode): the window planner on the whole matrix, native
    and NumPy (:func:`_planners`), and the levels packed again from
    ``coo`` with the library bypassed.  Every level's arrays equal ``A``'s,
    forward and backward; the NumPy packing's card forms equal
    ``A.cards``; one SELL SpMV and one (n, KB) SpMM on each card form of
    each packing, bit for bit.  Returns the numbers for this matrix."""
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import sell as S
    m, n = A.shape
    host = F.coo_from_arrays(*coo, device=None)
    dirs = {"fwd": (host, m, n)}
    if "bwd" in A.cards:
        dirs["bwd"] = (F.transpose_coo(host), n, m)
    if set(A.cards) != set(dirs) or A._args["split"] is not None \
            or A._args["perm"] is not None:
        raise AssertionError("%s %s: cards %s, split or permutation"
                             % (tag, label, sorted(A.cards)))
    out = {}
    g = torch.Generator(device=DEVICE).manual_seed(20)
    for key, (c, rows_out, n_in) in dirs.items():
        window = A._args[key][0].window
        held, plan_native_s, plan_numpy_s = _planners(
            "%s %s" % (label, key), c, window)
        with native_bypassed():
            t0 = time.perf_counter()
            levels = B._pack_levels(c, B.NB_MAX, B._SPILL_BYTES, 2,
                                    device=None, window=window)
            pack_s = time.perf_counter() - t0
        levels = B._levels_on(levels, DEVICE)
        held += _same_arrays("%s %s levels" % (label, key), levels,
                             A._args[key])
        card_np = S.sell_from_levels(levels, rows_out)
        held += _same_arrays("%s %s card form" % (label, key), card_np,
                             A.cards[key])
        x = torch.randn(n_in, device=DEVICE, generator=g)
        X = torch.randn(n_in, KB, device=DEVICE, generator=g)
        _reset_counts()
        for what, y, y_np in (
                ("SpMV", S.sell_matvec(A.cards[key], x),
                 S.sell_matvec(card_np, x)),
                ("(n, %d) SpMM" % KB, S.sell_matmat(A.cards[key], X),
                 S.sell_matmat(card_np, X))):
            torch.cuda.synchronize()
            if not torch.equal(y, y_np) or not torch.isfinite(y).all():
                raise AssertionError("%s %s %s %s: the packings' products "
                                     "differ" % (tag, label, key, what))
        counts = _counts()
        if counts["sell_spmv"] != 2 or counts["sell_spmm"] != 2:
            raise AssertionError("%s %s %s: launches %s"
                                 % (tag, label, key, counts))
        log("[%s] %s %s: window %d, %d level(s); the window planner on the "
            "whole matrix %.3f s native, %.3f s NumPy; the NumPy packing "
            "%.2f s; %d arrays equal (both planners, the operator's levels "
            "and the NumPy packing's, the card forms); one SELL SpMV and one "
            "(n, %d) SpMM on each packing's card form bit for bit (%s)"
            % (tag, label, key, window, len(levels), plan_native_s,
               plan_numpy_s, pack_s, held, KB, counts))
        out[key] = {"window": window, "plan_native_s": plan_native_s,
                    "plan_numpy_s": plan_numpy_s, "numpy_pack_s": pack_s,
                    "arrays_equal": held, "launches": counts}
        del levels, card_np
    return out


def phase_native(pt, A_bell, coo_bell, bell, se, se_build_s):
    """20a: the native host pipeline at full size, against the port's
    NumPy path in the same process (:func:`native_bypassed`).

    1. Phase 5's tiled 1138bus and phase 10's state-estimation matrix
       (with its transpose), which those phases built through the native
       planner, against the NumPy path in the window mode each product
       holds (:func:`_repack`): both planners' arrays, every level's
       arrays forward and backward, and the SELL card forms equal; one
       SELL SpMV and one (n, KB) SpMM on each card form of each packing,
       bit for bit.
    2. Tiled 1138bus (lower triangle, symmetric) written by the port's
       MatrixMarket writer, read back by ``mm_parse_native`` and by the
       NumPy parser: the arrays equal, and equal to what was written.
    3. The f64 3-D Poisson matrix at n = POISSON_FILL_N filled into DIA
       storage by ``dia_fill_native`` and by the NumPy fill: the arrays
       equal; one DIA SpMV on each, bit for bit, and against the plain
       product."""
    import tempfile
    from pykrylov_tpu_torch import native
    from pykrylov_tpu_torch.gallery import poisson3d_coo
    from pykrylov_tpu_torch.io import matrix_market as MM
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import operator_from_coo

    tag = "20a native"
    if not native.available():
        raise AssertionError("%s: the native library is not in use" % tag)
    out = {}
    for label, A, coo, build_s in (
            ("tiled 1138bus", A_bell, coo_bell, bell["build_s"]),
            ("state estimation", se[0], se[1], se_build_s)):
        out[label] = _repack(tag, label, A, coo)
        out[label]["operator_build_s"] = build_s
        out[label]["launches"] = {
            k: sum(d["launches"][k] for d in out[label].values()
                   if isinstance(d, dict)) for k, *_ in COUNTERS}

    # the MatrixMarket round trip, of phase 5's triples
    vals, rows, cols, shape = coo_bell
    low = rows >= cols
    vals, rows, cols = vals[low].astype(np.float64), rows[low], cols[low]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "tiled_1138bus.mtx")
    try:
        t0 = time.perf_counter()
        MM.write_matrix_market(path, vals, rows, cols, shape,
                               symmetry="symmetric")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = native.mm_parse_native(path)
        parse_native_s = time.perf_counter() - t0
        with native_bypassed():
            t0 = time.perf_counter()
            v_np, r_np, c_np, shape_np, info = MM.read_matrix_market(
                path, expand_symmetric=False)
            parse_numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = MM.read_matrix_market(path)
        read_native_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    except BaseException:
        shutil.rmtree(tmp)
        raise
    if raw is None or raw[3:] != (shape_np, info.field, info.symmetry):
        raise AssertionError("%s: mm_parse_native gave %r" % (
            tag, None if raw is None else raw[3:]))
    for a, b, name in ((raw[0], v_np, "values"), (raw[1], r_np, "rows"),
                       (raw[2], c_np, "cols")):
        if not np.array_equal(a, b):
            raise AssertionError("%s: native and NumPy %s differ"
                                 % (tag, name))
    if not (np.array_equal(v_np, vals) and np.array_equal(r_np, rows)
            and np.array_equal(c_np, cols)):
        raise AssertionError("%s: the file read back is not what was "
                             "written" % tag)
    if len(whole[0]) != 2 * len(vals) - int((rows == cols).sum()):
        raise AssertionError("%s: the symmetric expansion gave %d entries"
                             % (tag, len(whole[0])))
    log("[%s] MatrixMarket: tiled 1138bus, %d stored entries, %d bytes, "
        "written in %.2f s; parsed in %.3f s native, %.3f s NumPy: arrays "
        "equal and equal to what was written; read_matrix_market (native, "
        "expanded to %d) %.3f s"
        % (tag, len(vals), size, write_s, parse_native_s, parse_numpy_s,
           len(whole[0]), read_native_s))
    out["matrix_market"] = {"entries": len(vals), "bytes": size,
                            "write_s": write_s,
                            "parse_native_s": parse_native_s,
                            "parse_numpy_s": parse_numpy_s,
                            "read_native_s": read_native_s}
    del raw, v_np, r_np, c_np, whole

    # the DIA fill
    t0 = time.perf_counter()
    coo = F.coo_from_arrays(*poisson3d_coo(POISSON_FILL_N), device=None)
    coo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dia = F.dia_from_coo(coo, device=None)
    fill_native_s = time.perf_counter() - t0
    with native_bypassed():
        t0 = time.perf_counter()
        dia_np = F.dia_from_coo(coo, device=None)
        fill_numpy_s = time.perf_counter() - t0
    held = _same_arrays("DIA fill", dia, dia_np)
    data = torch.from_numpy(dia.data).to(DEVICE)
    data_np = torch.from_numpy(dia_np.data).to(DEVICE)
    x = torch.randn(data.shape[1], dtype=torch.float64, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(21))
    _reset_counts()
    y = K.dia_matvec(data, dia.offsets, x)
    y_np = K.dia_matvec(data_np, dia_np.offsets, x)
    torch.cuda.synchronize()
    counts = _counts()
    if counts["dia_spmv"] != 2 or not torch.equal(y, y_np):
        raise AssertionError("%s: DIA SpMV on the fills: %s, equal %s"
                             % (tag, counts, torch.equal(y, y_np)))
    _exact("DIA SpMV on the native fill", y,
           K.dia_matvec_plain(data, dia.offsets, x), tag=tag)
    log("[%s] DIA fill: f64 3-D Poisson n=%d, %d rows, %d diagonals, %d "
        "entries (COO in %.2f s): filled in %.3f s native, %.3f s NumPy, "
        "%d arrays equal; one DIA SpMV on each bit for bit"
        % (tag, POISSON_FILL_N, data.shape[1], data.shape[0],
           len(coo.data), coo_s, fill_native_s, fill_numpy_s, held))
    out["dia_fill"] = {"rows": int(data.shape[1]),
                       "fill_native_s": fill_native_s,
                       "fill_numpy_s": fill_numpy_s, "launches": counts}
    del coo, dia, dia_np, data, data_np
    # the file stays for phase 21's ranks, which read their parts of it
    out["mtx_path"] = path
    return out


def phase_examples(pt):
    """20b: the port's examples on the card, through their ``main``:
    ``bmark`` (f64, jpwh_991) without and with ``--precon``, each matvec
    count within BMARK_BOUND of the reference's published table;
    ``demo_chebyshev`` at CHEB_N (the kernel DIA format) and
    ``demo_general`` at GENERAL_N rows (BELL), each with its kernel's
    launches counted from 0 and its printed results converged."""
    from pykrylov_tpu_torch.examples import bmark, demo_chebyshev
    from pykrylov_tpu_torch.examples import demo_general

    tag = "20b examples"
    out = {}
    for precon in (False, True):
        label = "bmark%s" % (" --precon" if precon else "")
        _reset_counts()
        t0 = time.perf_counter()
        runs = bmark.main(["--device", DEVICE]
                          + (["--precon"] if precon else []))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        got = {}
        for ks, name in zip(runs, ("cgs", "tfqmr", "bicgstab")):
            ref = BMARK[name][precon]
            got[name] = ks.nMatvec
            if not ks.converged or abs(ks.nMatvec - ref) > BMARK_BOUND:
                raise AssertionError("%s %s %s: %d matvecs, converged %s, "
                                     "against %d" % (tag, label, name,
                                                     ks.nMatvec,
                                                     ks.converged, ref))
        log("[%s] %s: matvecs %s (published %s, bound %d), fmt %s, %.3f s"
            % (tag, label, got, {k: v[precon] for k, v in BMARK.items()},
               BMARK_BOUND, runs[0].op.fmt, secs))
        out[label] = {"n_matvec": got, "fmt": runs[0].op.fmt,
                      "solve_s": secs, "launches": counts}

    for label, run, fmt, kernel in (
            ("demo_chebyshev",
             lambda: demo_chebyshev.main([str(CHEB_N), "--device", DEVICE]),
             "cuda-dia", "dia_spmv"),
            ("demo_general",
             lambda: demo_general.main([str(GENERAL_N), "--device",
                                        DEVICE]),
             "bell", "sell_spmv")):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        A = res["A"] if isinstance(res, dict) else res[0]
        results = ([v for k, v in res.items() if k != "A"]
                   if isinstance(res, dict) else [r for r in res[1:]])
        if A.fmt != fmt or counts[kernel] == 0:
            raise AssertionError("%s %s: fmt %r (want %r), %s"
                                 % (tag, label, A.fmt, fmt, counts))
        conv = [bool(r.converged) for r in results]
        if not all(conv):
            raise AssertionError("%s %s: converged %s" % (tag, label, conv))
        log("[%s] %s: %d rows, fmt %s, returned in %.2f s, %d %s launches "
            "(%s)" % (tag, label, A.shape[0], A.fmt, secs, counts[kernel],
                      kernel, counts))
        out[label] = {"rows": A.shape[0], "fmt": A.fmt, "seconds": secs,
                      "launches": counts}
    return out


# --------------------------------------------------------------------------
# 21. a mesh of ranks: spawned ranks sharing the card, NCCL, the dry run
# --------------------------------------------------------------------------

RANKS = 4               # ranks of 21a, 21c and 21d, all on the one card
RANK_TIMEOUT = 300.0    # seconds a collective may wait: a lost rank fails
                        # the others instead of hanging them
RANK_DEADLINE = 600.0   # seconds a spawned world may take in all
RANK_ITER_SLACK = 3     # 21a's halo CG against phase 4's count: its dots
                        # are per-rank partials, all-reduced
RANK_PROFILE_ITERS = 20  # profiled iterations of 21d's L-BFGS CG (12
                         # all-reduces an iteration)
PROBE_REPS = 200        # collectives each of 21e's timings averages


def _rank_solve(mesh, tag, label, fn, kernel, extra, capped):
    """On a rank: ``fn()`` with the launch counts and the exchange layer's
    counts set to 0 just before and read just after; ``kernel`` launches
    once a product on this rank (``n_matvec + extra(res)`` products), no
    other kernel launches; then ``capped()`` under the profiler for the
    idle share.  Returns (result, record)."""
    from pykrylov_tpu_torch.utils import ranks
    comm = mesh.comm
    comm.reset_counts()
    _reset_counts()
    comm.barrier()                   # the ranks start together
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    calls, comm_s = dict(comm.calls), comm.seconds
    n = max(int(res.n_iter), 1)
    want = int(res.n_matvec) + extra(res)
    ms = 1e3 * secs / n
    log("[%s] %s: istop %d, %d iterations, %d %s launches for %d products, "
        "%.3f s, %.4f ms per iteration, %.2f all-reduces per iteration "
        "(%.1f%% of the wall), exchanges %s"
        % (tag, label, int(res.istop), int(res.n_iter), counts[kernel],
           kernel, want, secs, ms, calls["all_reduce"] / n,
           100 * comm_s / secs, calls))
    if counts[kernel] != want or want == 0 or any(
            v for k, v in counts.items() if k != kernel):
        raise AssertionError("%s %s: launches %s for %d products"
                             % (tag, label, counts, want))
    if not torch.isfinite(ranks.plain(res.x)).all():
        raise AssertionError("%s %s: non-finite rows" % (tag, label))
    prof = _profile_call("%s, %s" % (tag, label), capped, ms)
    return res, {"n_iter": int(res.n_iter), "istop": int(res.istop),
                 "n_matvec": int(res.n_matvec), "launches": counts,
                 "solve_s": secs, "ms_per_iter": ms,
                 "all_reduces_per_iter": calls["all_reduce"] / n,
                 "comm_share": comm_s / secs, "exchanges": calls,
                 "idle": prof["idle"], "profile": prof,
                 "resid_norm": float(res.resid_norm)}


def _halo_leg(mesh):
    """21a's halo DIA CG on one rank: this rank's rows of phase 4's
    Poisson matrix from ``sharded_poisson3d``, its product of phase 4's
    x_true (the parent holds it to phase 4's b bit for bit), CG on that
    product.  Returns (operator, b, record)."""
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch import parallel as par
    from pykrylov_tpu_torch.utils import ranks

    r, R = mesh.rank, mesh.size
    tag = "21 halo DIA, rank %d of %d (%s)" % (r, R, mesh.transport)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H, _, _, pad = par.sharded_poisson3d(N, mesh, dtype=np.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = H.nargout // R
    x_true = np.random.default_rng(0).standard_normal(N ** 3).astype(
        np.float32)[r * L:(r + 1) * L]
    xs = par.shard_vector(torch.from_numpy(x_true).to(DEVICE), mesh,
                          local=True)
    _reset_counts()
    b = H * xs
    torch.cuda.synchronize()
    counts = _counts()
    if counts["dia_spmv"] != 1 or sum(counts.values()) != 1:
        raise AssertionError("%s: the product launched %s" % (tag, counts))
    log("[%s] %r: %d rows built in %.2f s (pad %d, halo %d), the product "
        "one DIA launch" % (tag, mesh, L, build_s, pad, H.halo_width))
    pt.cg(H, b, maxiter=3)                                   # warm-up
    res, rec = _rank_solve(mesh, tag, "cg", lambda: pt.cg(H, b),
                           "dia_spmv", lambda res: 0,
                           lambda: pt.cg(H, b, maxiter=PIPE_PROFILE_ITERS))
    rec.update(build_s=build_s, b=ranks.plain(b).cpu().numpy(),
               x=ranks.plain(res.x).cpu().numpy(),
               info=par.device_mesh_info(mesh))
    return H, b, rec


def _rank_halo(transport):
    """21a's halo DIA CG (:func:`_halo_leg`) on one rank of a world."""
    from pykrylov_tpu_torch import parallel as par
    return _halo_leg(par.make_mesh(device=DEVICE, transport=transport))[2]


def _lbfgs_leg(mesh, H, b):
    """21d on one rank: CG on the halo operator preconditioned by an
    ``InverseLBFGSOperator`` over the mesh of LBFGS_PAIRS pairs (s, H s),
    s this rank's rows of a normal vector seeded by the pair and the
    rank (the products launch before the counted solve)."""
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch.utils import ranks

    r, R = mesh.rank, mesh.size
    tag = "21d L-BFGS CG, rank %d of %d (%s)" % (r, R, mesh.transport)
    M = pt.InverseLBFGSOperator(H.nargin, LBFGS_PAIRS, dtype=torch.float32,
                                device=DEVICE, mesh=mesh)
    for k in range(LBFGS_PAIRS):
        g = torch.Generator(device=mesh.home).manual_seed(1000 * k + r)
        s = ranks.shard(torch.randn(b.shape[0], generator=g,
                                    device=mesh.home))
        M.store(s, H * s)
    if int(M.data.valid.sum()) != LBFGS_PAIRS:
        raise AssertionError("%s: kept %s of %d pairs"
                             % (tag, M.data.valid.tolist(), LBFGS_PAIRS))
    label = "cg, M = InverseLBFGSOperator (%d pairs)" % LBFGS_PAIRS
    pt.cg(H, b, M=M, maxiter=3)                              # warm-up
    res, rec = _rank_solve(
        mesh, tag, label, lambda: pt.cg(H, b, M=M), "dia_spmv",
        lambda res: 0, lambda: pt.cg(H, b, M=M, maxiter=RANK_PROFILE_ITERS))
    rec["x"] = ranks.plain(res.x).cpu().numpy()
    return rec


def _ckpt_leg(mesh, H, b, path):
    """21d on one rank: ``checkpointed_solve`` of the halo CG in chunks of
    CKPT_CHUNK, stopped by ``keep_going`` after its first chunk and then
    resumed from the file to convergence.  After each call the file (one,
    written by rank 0) holds the whole iterate: this rank's rows of it
    are its own, bit for bit; DIA launches over both calls =
    ``total_matvec``."""
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch.utils import load_result, ranks

    r, R = mesh.rank, mesh.size
    tag = "21d checkpointed CG, rank %d of %d (%s)" % (r, R, mesh.transport)
    comm, L = mesh.comm, b.shape[0]

    def rows_saved(x, chunk):
        state = load_result(path)
        mine = state["x"][r * L:(r + 1) * L]
        if (state["x"].shape[0] != R * L or int(state["extra_chunk"]) != chunk
                or not np.array_equal(mine, ranks.plain(x).cpu().numpy())):
            raise AssertionError("%s: the file after chunk %d is not the "
                                 "gathered iterate" % (tag, chunk))
    chunks = []
    comm.reset_counts()
    _reset_counts()
    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = _ckpt_run(pt, H, b, path, chunks,
                      keep_going=lambda chunk, res: False)
    rows_saved(first.x, 0)
    if len(chunks) != 1 or bool(first.converged):
        raise AssertionError("%s: the first call ran %s" % (tag, chunks))
    res = _ckpt_run(pt, H, b, path, chunks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, calls, comm_s = _counts(), dict(comm.calls), comm.seconds
    rows_saved(res.x, len(chunks) - 2)
    total = int(res.info["total_matvec"])
    n = sum(c[0] for c in chunks)
    ms = 1e3 * secs / n
    log("[%s] stopped after chunk 0, resumed: %d chunks %s, istop %d, "
        "total_matvec %d, launches %s, %.3f s, %.4f ms per iteration (saves "
        "and restarts included), %.2f all-reduces per iteration (%.1f%% of "
        "the wall), exchanges %s" % (tag, len(chunks), chunks,
                                     int(res.istop), total, counts, secs, ms,
                                     calls["all_reduce"] / n,
                                     100 * comm_s / secs, calls))
    if (int(res.istop) != 0 or total != sum(c[1] for c in chunks)
            or counts != {"dia_spmv": total, "dia_spmm": 0, "sell_spmv": 0,
                          "sell_spmm": 0, "block_cg": 0}):
        raise AssertionError("%s: %r, total_matvec %d, launches %s"
                             % (tag, res, total, counts))
    return {"n_iter": n, "istop": int(res.istop), "n_matvec": total,
            "chunks": len(chunks), "launches": counts, "solve_s": secs,
            "ms_per_iter": ms, "all_reduces_per_iter": calls["all_reduce"] / n,
            "comm_share": comm_s / secs, "exchanges": calls, "idle": None,
            "resid_norm": float(res.resid_norm),
            "x": ranks.plain(res.x).cpu().numpy()}


def _show_leg(mesh, Gs, bs, opts):
    """21d on one rank: ``lsqr(show=True)`` on the transposed shards,
    SHARD_XLLS_ITERS iterations: every rank keeps the table, rank 0 alone
    prints it, and its x(1) column is the whole x's first row (one
    broadcast an iteration)."""
    import io
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch.utils import ranks

    r, R = mesh.rank, mesh.size
    tag = "21d lsqr(show=True), rank %d of %d (%s)" % (r, R, mesh.transport)
    comm = mesh.comm
    text = io.StringIO()
    comm.reset_counts()
    _reset_counts()
    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        res = pt.lsqr(Gs, bs, show=True, **dict(opts,
                                                itnlim=SHARD_XLLS_ITERS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, calls, comm_s = _counts(), dict(comm.calls), comm.seconds
    n = max(int(res.n_iter), 1)
    want = int(res.n_matvec) + _initial_launch(res)
    log("[%s] %d iterations, %d sell_spmv launches for %d products, %.3f "
        "s, %.4f ms per iteration, %.2f all-reduces and %.2f broadcasts per "
        "iteration (%.1f%% of the wall), %d lines printed"
        % (tag, int(res.n_iter), counts["sell_spmv"], want, secs,
           1e3 * secs / n, calls["all_reduce"] / n, calls["broadcast"] / n,
           100 * comm_s / secs, len(text.getvalue().splitlines())))
    if counts["sell_spmv"] != want or sum(counts.values()) != want:
        raise AssertionError("%s: launches %s for %d products"
                             % (tag, counts, want))
    return {"n_iter": int(res.n_iter), "istop": int(res.istop),
            "n_matvec": int(res.n_matvec), "launches": counts,
            "solve_s": secs, "ms_per_iter": 1e3 * secs / n,
            "all_reduces_per_iter": calls["all_reduce"] / n,
            "broadcasts_per_iter": calls["broadcast"] / n,
            "comm_share": comm_s / secs, "exchanges": calls, "idle": None,
            "resid_norm": float(res.resid_norm), "text": text.getvalue(),
            "table": res.info["show_table"].cpu().numpy(),
            "x": ranks.plain(res.x).cpu().numpy()}


def _rank_paths(transport, mtx_path, b_bus_path, se_path, ckpt_path):
    """21a and 21d on one rank of a world (``transport`` ``"host"``: gloo
    with host staging; ``"nccl"``): the halo DIA CG (:func:`_halo_leg`),
    the L-BFGS-preconditioned and the checkpointed CG on the same
    operator, gather-SELL CG on this rank's ``keep=rank`` part of tiled
    1138bus, LSQR on the state-estimation matrix with transposed shards
    and its ``show`` table (its sorted triples and b from ``se_path``);
    this rank's rows of each x for the parent."""
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch import parallel as par
    from pykrylov_tpu_torch.io.matrix_market import \
        read_matrix_market_partitioned
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.utils import ranks

    mesh = par.make_mesh(device=DEVICE, transport=transport)
    out = {}
    H, b, out["halo"] = _halo_leg(mesh)
    out["lbfgs"] = _lbfgs_leg(mesh, H, b)
    out["ckpt"] = _ckpt_leg(mesh, H, b, ckpt_path)
    del H, b
    r, R = mesh.rank, mesh.size
    tag = "21a gather SELL, rank %d of %d (%s)" % (r, R, mesh.transport)
    t0 = time.perf_counter()
    parts, shape, _ = read_matrix_market_partitioned(mtx_path, R, keep=r,
                                                     dtype=np.float32)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    G = par.GatherBellOperator(F.coo_from_arrays(*parts[0], shape,
                                                 device=None),
                               mesh, symmetric=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log("[%s] tiled 1138bus: %d entries of this rank's part read in %.2f "
        "s, operator built in %.2f s, comm entries %d a product (true %d)"
        % (tag, len(parts[0][0]), read_s, build_s,
           G.comm_entries_per_matvec, G.comm_entries_true))
    del parts
    b = par.shard_vector(torch.from_numpy(np.load(b_bus_path)).to(DEVICE),
                         mesh)
    pt.cg(G, b, maxiter=3)                                   # warm-up
    res, rec = _rank_solve(mesh, tag, "cg", lambda: pt.solve(G, b),
                           "sell_spmv", lambda res: 0,
                           lambda: pt.cg(G, b, maxiter=PIPE_PROFILE_ITERS))
    rec.update(read_s=read_s, build_s=build_s,
               x=ranks.plain(res.x).cpu().numpy())
    out["gather"] = rec
    del G, b, res

    tag = "21a state estimation, rank %d of %d (%s)" % (r, R,
                                                       mesh.transport)
    t0 = time.perf_counter()
    se = np.load(se_path)
    Gs = par.GatherBellOperator(F.coo_from_arrays(
        se["vals"], se["rows"], se["cols"], tuple(se["shape"].tolist()),
        sort=False, device=None), mesh, with_transpose=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log("[%s] %d x %d, with_transpose: this rank's rows built in %.2f s, "
        "comm entries %d a product" % (tag, Gs.shape[0], Gs.shape[1],
                                       build_s, Gs.comm_entries_per_matvec))
    bs = par.shard_vector(torch.from_numpy(se["b"]).to(DEVICE),
                          mesh)
    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0,
            "itnlim": SHARD_LLS_ITERS}
    short = pt.lsqr(Gs, bs, **dict(opts, itnlim=SHARD_XLLS_ITERS))
    res, rec = _rank_solve(
        mesh, tag, "lsqr, itnlim=%d" % SHARD_LLS_ITERS,
        lambda: pt.lsqr(Gs, bs, **opts), "sell_spmv", _initial_launch,
        lambda: pt.lsqr(Gs, bs, **dict(opts, itnlim=RANK_PROFILE_ITERS)))
    rec.update(build_s=build_s, x=ranks.plain(res.x).cpu().numpy(),
               x_short=ranks.plain(short.x).cpu().numpy(),
               short=(int(short.n_iter), float(short.resid_norm)))
    out["lsqr"] = rec
    out["show"] = _show_leg(mesh, Gs, bs, opts)
    return out


def _rank_nccl():
    """21b on a one-rank NCCL world: the exchange layer's NCCL branch on
    CUDA tensors, then a halo CG at n = 64 on the one-rank mesh."""
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch import parallel as par
    mesh = par.make_mesh(device=DEVICE)
    comm = mesh.comm
    info = par.device_mesh_info(mesh)
    if info["transport"] != "nccl" or comm.backend != "nccl":
        raise AssertionError("21b: transport %r, backend %r"
                             % (info["transport"], comm.backend))
    x = torch.arange(12, dtype=torch.float64, device=DEVICE)
    s = comm.all_reduce(x)
    a = comm.all_to_all(x.reshape(6, 2), [6], [6])
    torch.cuda.synchronize()
    if not (torch.equal(s, x) and torch.equal(a, x.reshape(6, 2))
            and s.is_cuda and a.is_cuda):
        raise AssertionError("21b: all_reduce %s, all_to_all %s" % (s, a))
    H, b, e, _ = par.sharded_poisson3d(64, mesh, dtype=np.float32)
    res = pt.cg(H, b)
    err = float(pt.utils.ranks.norm(res.x - e))
    if not (bool(res.converged) and err < 1e-2 * 64 ** 1.5):
        raise AssertionError("21b: %r, error %.3e" % (res, err))
    return {"info": info, "n_iter": int(res.n_iter), "err": err,
            "calls": dict(comm.calls)}


def _earlier(new_s, dia, bell):
    """Phase 19's slot-mesh and the unsharded phases' ms per iteration of
    21a's and 21d's legs: (mesh of slots, unsharded); the L-BFGS CG
    beside phase 4's CG, the checkpointed CG beside 18a's, the ``show``
    LSQR beside the unsharded LSQR."""
    s19a, s19b, s10 = new_s["19a"][0], new_s["19b"][0], new_s["10"][0]
    lsqr19 = s19b["lsqr, with_transpose, itnlim=%d" % SHARD_LLS_ITERS]
    dia_ms = 1e3 * dia["solve_s"] / dia["n_iter"]
    lsqr_ms = 1e3 * s10["lsqr"]["solve_s"] / s10["lsqr"]["n_iter"]
    return {"halo": (s19a["cg"]["ms_per_iter"], dia_ms),
            "gather": (s19b["cg"]["ms_per_iter"],
                       1e3 * bell["solve_s"] / bell["n_iter"]),
            "lsqr": (lsqr19["ms_per_iter"], lsqr_ms),
            "lbfgs": (None, dia_ms),
            "ckpt": (None, new_s["18a"][0]["checkpointed cg"]["ms_per_iter"]),
            "show": (None, lsqr_ms)}


LEGS = ("halo", "lbfgs", "ckpt", "gather", "lsqr", "show")


def _check_legs(pt, tag, worlds, A_dia, dia, coo_bell, bell, se, ckpt_path,
                earlier):
    """The parent's checks of :func:`_rank_paths`' legs over a world:
    every rank the same counts, stop codes and residual norms (lockstep);
    the halo products phase 4's b bit for bit and the halo CG within
    RANK_ITER_SLACK of phase 4's count; the gather CG within 10% of phase
    5's; every CG's true residual (f64) at most 1e-4; LSQR's x and
    residual norm against the unsharded LSQR's at SHARD_XLLS_ITERS and
    SHARD_LLS_ITERS; the checkpoint file the whole converged iterate; the
    ``show`` table printed by rank 0 alone, the same on every rank, its
    last x(1) the whole x's first row and its x the capped LSQR's bit for
    bit.  Returns the legs' records by rank, with the checks."""
    from pykrylov_tpu_torch.utils import load_result

    A_se, coo_se, b_se = se
    for leg in LEGS:
        recs = [w[leg] for w in worlds]
        same = {(r["n_iter"], r["istop"], r["n_matvec"], r["resid_norm"])
                for r in recs}
        if len(same) != 1:
            raise AssertionError("%s %s: the ranks disagree: %s"
                                 % (tag, leg, same))

    def gathered(leg, key="x"):
        return torch.from_numpy(np.concatenate(
            [w[leg][key] for w in worlds])).to(DEVICE)

    halo = [w["halo"] for w in worlds]
    b_ranks = torch.from_numpy(np.concatenate([h["b"] for h in halo])).to(
        DEVICE)
    same_b = torch.equal(b_ranks, dia["b"])
    del b_ranks
    ax = _dia_f64(A_dia)
    rels = {leg: _true_rel(dia["b"], ax, gathered(leg))
            for leg in ("halo", "lbfgs", "ckpt")}
    n_h = halo[0]["n_iter"]
    log("[%s] halo DIA: each rank's product rows of phase 4's x_true bit "
        "for bit phase 4's b: %s; cg %d iterations (phase 4: %d), true "
        "relative residual (f64) %.3e; L-BFGS-preconditioned cg %d "
        "iterations, %.3e; checkpointed cg %d iterations in %d chunks, "
        "total_matvec %d, %.3e"
        % (tag, same_b, n_h, dia["n_iter"], rels["halo"],
           worlds[0]["lbfgs"]["n_iter"], rels["lbfgs"],
           worlds[0]["ckpt"]["n_iter"], worlds[0]["ckpt"]["chunks"],
           worlds[0]["ckpt"]["n_matvec"], rels["ckpt"]))
    if (not same_b or abs(n_h - dia["n_iter"]) > RANK_ITER_SLACK
            or not max(rels.values()) <= 1e-4
            or any(worlds[0][leg]["istop"] != 0 for leg in rels)):
        raise AssertionError("%s halo: bit for bit %s, %d iterations, "
                             "residuals %s" % (tag, same_b, n_h, rels))
    saved = load_result(ckpt_path)["x"]
    if not np.array_equal(saved, np.concatenate([w["ckpt"]["x"]
                                                 for w in worlds])):
        raise AssertionError("%s: the checkpoint is not the gathered "
                             "iterate" % tag)
    gat = [w["gather"] for w in worlds]
    m = bell["b"].shape[0]
    gat_rel = _true_rel(bell["b"], _coo_f64(coo_bell, m), gathered(
        "gather")[:m])
    n_g = gat[0]["n_iter"]
    log("[%s] gather SELL: cg %d iterations (phase 5: %d), true relative "
        "residual (f64) %.3e" % (tag, n_g, bell["n_iter"], gat_rel))
    if (abs(n_g - bell["n_iter"]) > ITER_RTOL * bell["n_iter"]
            or not gat_rel <= 1e-4 or gat[0]["istop"] != 0):
        raise AssertionError("%s gather: %d iterations, residual %.3e"
                             % (tag, n_g, gat_rel))
    # LSQR: the ranks' dots are all-reduced partials, which round unlike
    # the unsharded whole-vector dots, and this system's LSQR moves x by
    # ~1e-3 at 500 iterations for a 1e-16 rounding of A'u (19b's
    # control): held as 19b's exchange leg holds its cut partition, x and
    # the residual norm at SHARD_XLLS_ITERS, and at SHARD_LLS_ITERS the
    # count, stop code and residual norm, x beside the control's
    lsq = [w["lsqr"] for w in worlds]
    n = A_se.shape[1]
    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0,
            "itnlim": SHARD_LLS_ITERS}

    def rel(x, y):
        return (torch.linalg.vector_norm(x - y)
                / torch.linalg.vector_norm(y)).item()
    checks = {}
    for key, its, xtol, rtol in (
            ("x_short", SHARD_XLLS_ITERS, SHARD_XLLS_XTOL, SHARD_XLLS_RTOL),
            ("x", SHARD_LLS_ITERS, None, SHARD_LLS_RTOL)):
        x = gathered("lsqr", key)
        ref = pt.lsqr(A_se, b_se, **dict(opts, itnlim=its))
        ctrl = pt.lsqr(_perturbed_twin(pt, A_se), b_se,
                       **dict(opts, itnlim=its))
        n_it, rn = lsq[0]["short"] if key == "x_short" else (
            lsq[0]["n_iter"], lsq[0]["resid_norm"])
        x_rel, ctrl_rel = rel(x[:n], ref.x), rel(ctrl.x, ref.x)
        r_rel = abs(rn - float(ref.resid_norm)) / float(ref.resid_norm)
        log("[%s] lsqr with transposed shards, itnlim=%d: %d iterations "
            "(unsharded %d, istop %d); ||r|| %.3e apart; x against the "
            "unsharded LSQR's %.3e relative, the control's (A'u perturbed "
            "by 1e-16) %.3e" % (tag, its, n_it, int(ref.n_iter),
                                int(ref.istop), r_rel, x_rel, ctrl_rel))
        if (n_it != int(ref.n_iter) or not r_rel <= rtol or x[n:].any()
                or (xtol is not None and not x_rel <= xtol)):
            raise AssertionError("%s lsqr itnlim=%d: %d iterations "
                                 "against %d, ||r|| %.3e apart, x %.3e "
                                 "apart" % (tag, its, n_it,
                                            int(ref.n_iter), r_rel, x_rel))
        checks["itnlim %d" % its] = {"x_rel": x_rel,
                                     "control_x_rel": ctrl_rel,
                                     "resid_rel": r_rel}
    if lsq[0]["istop"] != 7:
        raise AssertionError("%s lsqr: istop %d" % (tag, lsq[0]["istop"]))
    show = [w["show"] for w in worlds]
    x_show = gathered("show")
    table = show[0]["table"]
    printed = [bool(s["text"]) for s in show]
    same_table = all(np.array_equal(s["table"], table, equal_nan=True)
                     for s in show)
    same_x = torch.equal(x_show, gathered("lsqr", "x_short"))
    last = table[show[0]["n_iter"], 0]
    log("[%s] lsqr(show=True), itnlim=%d: printed by ranks %s; the tables "
        "equal on every rank: %s; last x(1) %.9e, the whole x's first row "
        "%.9e; x the capped LSQR's bit for bit: %s; rank 0's table:\n%s"
        % (tag, SHARD_XLLS_ITERS, [r for r, p in enumerate(printed) if p],
           same_table, last, x_show[0].item(), same_x,
           show[0]["text"].rstrip()))
    if (printed != [True] + [False] * (len(show) - 1) or not same_table
            or last != x_show[0].item() or not same_x):
        raise AssertionError("%s show: printed %s, tables equal %s, x(1) "
                             "%r against %r, x equal %s"
                             % (tag, printed, same_table, last,
                                x_show[0].item(), same_x))
    checks = {"halo": {"bit_for_bit": same_b, "true_rel": rels["halo"]},
              "lbfgs": {"true_rel": rels["lbfgs"]},
              "ckpt": {"true_rel": rels["ckpt"], "file_is_x": True},
              "gather": {"true_rel": gat_rel}, "lsqr": checks,
              "show": {"x1_is_x0": True, "printed_by": 0}}
    out = {}
    for leg in LEGS:
        for r, w in enumerate(worlds):
            rec = {k: v for k, v in w[leg].items()
                   if k not in ("x", "x_short", "b", "profile", "info",
                                "text", "table")}
            rec.update(checks[leg], slot_mesh_ms=earlier[leg][0],
                       unsharded_ms=earlier[leg][1])
            out["%s rank %d" % (leg, r)] = rec
            log("[%s] %s, rank %d: %.4f ms per iteration (phase 19's %d "
                "slots: %s, unsharded: %.4f), %.2f all-reduces per "
                "iteration, %.1f%% of the wall in exchanges, idle %s, "
                "exchanges %s, launches %s"
                % (tag, leg, r, rec["ms_per_iter"], MESH_SHARDS,
                   "%.4f" % earlier[leg][0] if earlier[leg][0] else "-",
                   earlier[leg][1], rec["all_reduces_per_iter"],
                   100 * rec["comm_share"],
                   "%.1f%%" % (100 * rec["idle"]) if rec["idle"] is not None
                   else "not profiled", rec["exchanges"],
                   {k: c for k, c in rec["launches"].items() if c}))
    return out


def _spawn_legs(tag, transport, n_ranks, backend, se, mtx_path, bell, tmp):
    """Every rank of a world of ``n_ranks`` runs :func:`_rank_paths`;
    returns (the ranks' results, the checkpoint's path, seconds)."""
    from pykrylov_tpu_torch.parallel.launch import spawn_ranks
    from pykrylov_tpu_torch.sparse import formats as F
    b_bus_path = os.path.join(tmp, "b_bus.npy")
    se_path = os.path.join(tmp, "se.npz")
    ckpt_path = os.path.join(tmp, "ckpt_%s.npz" % transport)
    np.save(b_bus_path, bell["b"].cpu().numpy())
    # the state-estimation triples, sorted once here for every rank
    coo = F.coo_from_arrays(*se[1], device=None)
    np.savez(se_path, vals=coo.data, rows=coo.row, cols=coo.col,
             shape=np.asarray(coo.shape), b=se[2].cpu().numpy())
    del coo
    t0 = time.perf_counter()
    worlds = spawn_ranks(_rank_paths, n_ranks, transport, mtx_path,
                         b_bus_path, se_path, ckpt_path, backend=backend,
                         timeout=RANK_TIMEOUT, deadline=RANK_DEADLINE)
    secs = time.perf_counter() - t0
    log("[%s] %d ranks (%s) ran the legs in %.1f s" % (tag, n_ranks,
                                                      transport, secs))
    return worlds, ckpt_path, secs


def _dryrun_legs(tag, n_ranks, transport, backend):
    """21c: the dry run's twelve legs over a world of ``n_ranks``, every
    rank printing the same lines.  Returns (results, seconds)."""
    from pykrylov_tpu_torch import dryrun
    from pykrylov_tpu_torch.parallel.launch import spawn_ranks
    t0 = time.perf_counter()
    runs = spawn_ranks(dryrun._rank_run, n_ranks, n_ranks, DEVICE, transport,
                       backend=backend, timeout=RANK_TIMEOUT,
                       deadline=RANK_DEADLINE)
    lines = runs[0][1]
    if any(r != runs[0] for r in runs[1:]) or len(lines) != 12:
        raise AssertionError("%s 21c: the ranks disagree or ran %d legs"
                             % (tag, len(lines)))
    for line in lines:
        log("[%s] 21c (%d ranks, %s): %s" % (tag, n_ranks, transport, line))
    return runs[0][0], time.perf_counter() - t0


def phase_ranks(pt, A_dia, dia, coo_bell, bell, se, mtx_path, earlier):
    """21: the mesh of ranks (21a-21d in the module docstring).
    ``earlier`` holds phase 19's slot-mesh ms per iteration and the
    unsharded phases' beside which 21a's and 21d's are logged."""
    from pykrylov_tpu_torch.parallel.launch import spawn_ranks

    tag = "21 mesh of ranks"
    tmp = os.path.dirname(mtx_path)
    # ---- 21a, 21d: four ranks sharing the card, gloo, host transport ----
    log("[%s] 21a, 21d: %d ranks on %s, gloo, transport='host' (CUDA "
        "tensors staged through pinned host buffers)"
        % (tag, RANKS, torch.cuda.get_device_name(0)))
    worlds, ckpt_path, secs = _spawn_legs(tag, "host", RANKS, "gloo", se,
                                          mtx_path, bell, tmp)
    out = {"21a_s": secs}
    out.update(("21a " + k if k.split()[0] in ("halo", "gather", "lsqr")
                else "21d " + k, v)
               for k, v in _check_legs(pt, tag, worlds, A_dia, dia,
                                       coo_bell, bell, se, ckpt_path,
                                       earlier).items())
    del worlds
    # the control: the same halo CG on one rank of a gloo world with the
    # same host staging, no card shared between processes
    one = spawn_ranks(_rank_halo, 1, "host", backend="gloo",
                      timeout=RANK_TIMEOUT, deadline=RANK_DEADLINE)[0]
    if not torch.equal(torch.from_numpy(one["b"]).to(DEVICE), dia["b"]):
        raise AssertionError("%s control: the one-rank product is not "
                             "phase 4's b" % tag)
    log("[%s] control: halo DIA CG on one gloo rank, host staging: %d "
        "iterations, %.4f ms per iteration, %.2f all-reduces per iteration "
        "(%.1f%% of the wall), idle %.1f%%"
        % (tag, one["n_iter"], one["ms_per_iter"],
           one["all_reduces_per_iter"], 100 * one["comm_share"],
           100 * one["idle"]))
    out["21a halo control, one rank"] = {
        k: v for k, v in one.items() if k not in ("x", "b", "profile",
                                                  "info")}

    # ---- 21b: NCCL -------------------------------------------------------
    t0 = time.perf_counter()
    one = spawn_ranks(_rank_nccl, 1, backend="nccl", timeout=RANK_TIMEOUT,
                      deadline=RANK_DEADLINE)[0]
    log("[%s] 21b: a one-rank NCCL world: %s, all_reduce and "
        "all_to_all_single on CUDA tensors exact, halo CG at n = 64 in %d "
        "iterations (error %.2e), exchanges %s, %.1f s"
        % (tag, one["info"], one["n_iter"], one["err"], one["calls"],
           time.perf_counter() - t0))
    out["21b one rank"] = {"n_iter": one["n_iter"], "calls": one["calls"]}
    log("[%s] 21b: the legs over NCCL ranks, one a card, run in "
        "`chip_smoke.py --nccl` (%d card(s) here)"
        % (tag, torch.cuda.device_count()))

    # ---- 21c: the dry run over four ranks --------------------------------
    out["21c"], out["21c_s"] = _dryrun_legs(tag, RANKS, "host", "gloo")
    return out


# -- --nccl: the legs over NCCL ranks, one a card ---------------------------

def _nccl_references(pt, tmp):
    """``--nccl``'s unsharded references on the first card: phase 5's
    tiled 1138bus (its b = A x_true and CG count), 20a's MatrixMarket
    file of it in ``tmp``, phase 10's state-estimation operator and b, and
    each unsharded solve's ms per iteration.  Returns (coo_bell, bell,
    se, mtx_path, ms)."""
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.io import matrix_market as MM
    from pykrylov_tpu_torch.sparse import operator_from_coo

    tag = "21 NCCL references"
    coo = tiled_general_coo("1138bus", tiles=TILES, coupling=0)
    A = operator_from_coo(*coo, symmetric=True, device=DEVICE)
    m = A.shape[0]
    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(m)
                              .astype(np.float32)).to(DEVICE)
    b = A * x_true
    pt.solve(A, b, maxiter=20)                               # warm-up
    res, secs = _timed_solve(pt, "21 reference, tiled 1138bus", A, b)
    bell = {"b": b, "n_iter": int(res.n_iter), "solve_s": secs}
    vals, rows, cols, shape = coo
    low = rows >= cols
    mtx_path = os.path.join(tmp, "tiled_1138bus.mtx")
    MM.write_matrix_market(mtx_path, vals[low].astype(np.float64),
                           rows[low], cols[low], shape, symmetry="symmetric")
    del A, res

    coo_se = se_coo(SE_TILES)
    A_se = operator_from_coo(*coo_se, device=DEVICE)
    n = A_se.shape[1]
    rng = np.random.default_rng(0)
    x_true = torch.from_numpy(rng.standard_normal(n)).to(DEVICE)
    ax = A_se * x_true          # phase 10's product: the kernel's bits
    b_se = ax + 0.01 * ax.abs().mean() * torch.from_numpy(
        rng.standard_normal(A_se.shape[0])).to(DEVICE)
    opts = {"atol": LLS_TOL, "btol": LLS_TOL, "etol": 0.0,
            "itnlim": SHARD_LLS_ITERS}
    pt.lsqr(A_se, b_se, **dict(opts, itnlim=20))             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pt.lsqr(A_se, b_se, **opts)
    torch.cuda.synchronize()
    lsqr_ms = 1e3 * (time.perf_counter() - t0) / int(ref.n_iter)
    ms = {"gather": 1e3 * secs / bell["n_iter"], "lsqr": lsqr_ms}
    log("[%s] tiled 1138bus: CG %d iterations, %.4f ms per iteration; "
        "state estimation %d x %d: LSQR %d iterations, %.4f ms per "
        "iteration" % (tag, bell["n_iter"], ms["gather"], *A_se.shape,
                       int(ref.n_iter), lsqr_ms))
    return coo, bell, (A_se, coo_se, b_se), mtx_path, ms


def _rank_nccl_probe(reps):
    """21e on one rank of an NCCL world, one rank a card: where an
    iteration's time goes.  This rank's pid, card, intra-op threads and
    cores; rank 0 reads the compute processes on every card (nvidia-smi)
    once every rank holds its context; the round trip of a local op read
    back to the host, of a one-element ``all_reduce`` read back, and of a
    halo exchange (N^2 rows to each neighbour, and one row) waited for,
    through the exchange layer (one ``batch_isend_irecv``) and as one
    ``all_to_all_single`` of the same messages, and the time of ``reps``
    one-element ``all_reduce`` calls enqueued back to back, with and
    without waiting for them; then phase 4's halo CG timed in turns with
    the exchange layer's halo, with the halo as one ``all_to_all_single``
    and with torch's intra-op threads on a 1/R share of the cores (an NCCL
    rank keeps every core), and a profiled window of it: each NCCL
    kernel's device ms and calls an iteration."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import pykrylov_tpu_torch as pt
    from pykrylov_tpu_torch import parallel as par

    mesh = par.make_mesh(device=DEVICE)
    comm, r, R = mesh.comm, mesh.rank, mesh.size
    one = torch.ones(1, device=mesh.home)
    halo = torch.ones(N * N, device=mesh.home)
    peers = [p for p in (r - 1, r + 1) if 0 <= p < R]

    def halo_wait(rows=halo):
        comm.sendrecv([(p, rows) for p in peers],
                      [(p, rows.shape) for p in peers], rows)
        torch.cuda.synchronize()

    def a2a(sends, recvs, like):
        """The exchange as one all_to_all_single of the flattened
        messages, nothing to the ranks that are not neighbours."""
        send_n, recv_n = [0] * R, [0] * R
        for p, t in sends:
            send_n[p] = t.numel()
        for p, shape in recvs:
            recv_n[p] = int(np.prod(shape))
        by_peer = dict(sends)
        send = torch.cat([by_peer[p].reshape(-1) for p in range(R)
                          if p in by_peer])
        got = dict(zip(range(R), comm.all_to_all(send, send_n,
                                                 recv_n).split(recv_n)))
        return [got[p].reshape(shape) for p, shape in recvs]

    def halo_a2a(rows=halo):
        a2a([(p, rows) for p in peers], [(p, rows.shape) for p in peers],
            rows)
        torch.cuda.synchronize()

    def timed(fn, wait=True):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        comm.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if wait:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        return ms

    out = {"rank": r, "pid": os.getpid(), "card": torch.cuda.current_device(),
           "threads": torch.get_num_threads(),
           "cores": len(os.sched_getaffinity(0)),
           "local_round_trip_ms": timed(lambda: (one + 1).item()),
           "all_reduce_round_trip_ms": timed(
               lambda: comm.all_reduce(one).item()),
           "all_reduce_enqueued_ms": timed(lambda: comm.all_reduce(one)),
           "all_reduce_host_ms": timed(lambda: comm.all_reduce(one),
                                       wait=False),
           "raw_all_reduce_host_ms": timed(lambda: dist.all_reduce(one),
                                           wait=False),
           "halo_round_trip_ms": timed(halo_wait),
           "one_row_exchange_ms": timed(lambda: halo_wait(one)),
           "halo_a2a_ms": timed(halo_a2a),
           "one_row_a2a_ms": timed(lambda: halo_a2a(one))}
    comm.barrier()
    if r == 0:
        out["apps"] = _smi("--query-compute-apps=pid,gpu_uuid,used_memory")
        out["gpus"] = _smi("--query-gpu=index,uuid")
        out["memory"] = _smi("--query-gpu=index,memory.used")
    comm.barrier()
    H, b, _, _ = par.sharded_poisson3d(N, mesh, dtype=np.float32)
    pt.cg(H, b, maxiter=3)                                   # warm-up
    variants = ("batch_isend_irecv", "all_to_all_single", "1/R threads")
    out["cg_ms"] = {v: [] for v in variants}
    for order in (variants, variants[::-1]):           # in turns
        for v in order:
            if v == "all_to_all_single":
                comm.sendrecv = a2a
            if v == "1/R threads":
                torch.set_num_threads(max(1, out["cores"] // R))
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pt.cg(H, b)
            torch.cuda.synchronize()
            out["cg_ms"][v].append(
                1e3 * (time.perf_counter() - t0) / int(res.n_iter))
            comm.__dict__.pop("sendrecv", None)
            torch.set_num_threads(out["threads"])
    comm.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = pt.cg(H, b, maxiter=PIPE_PROFILE_ITERS)
        torch.cuda.synchronize()
    n = int(res.n_iter)
    out["nccl_kernels"] = {
        e.key[:48]: (e.self_device_time_total * 1e-3 / n, e.count / n)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()
        and e.self_device_time_total > 0}
    return out


def _smi(query):
    """``nvidia-smi <query> --format=csv,noheader`` as lines."""
    return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()


NCCL_DEBUG_ENV = {"NCCL_DEBUG": "INFO",
                  "NCCL_DEBUG_SUBSYS": "INIT,P2P,SHM,NET"}


def phase_nccl_probe(tag, cards):
    """21e: :func:`_rank_nccl_probe` over an NCCL world of one rank a card
    with ``NCCL_DEBUG=INFO`` written to files: logs each rank's numbers,
    which card each process holds a context on (every rank on its own
    card only), and the transports NCCL chose (its ``via`` lines)."""
    import tempfile
    from pykrylov_tpu_torch.parallel.launch import spawn_ranks

    logs = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    env = dict(NCCL_DEBUG_ENV,
               NCCL_DEBUG_FILE=os.path.join(logs, "nccl.%h.%p.log"))
    saved = {k: os.environ.get(k) for k in env}
    log("[%s] 21e: NCCL settings in the environment: %s" % (tag, {
        k: v for k, v in os.environ.items() if k.startswith("NCCL_")}))
    base = _smi("--query-gpu=index,memory.used")
    os.environ.update(env)
    try:
        probes = spawn_ranks(_rank_nccl_probe, cards, PROBE_REPS,
                             backend="nccl", timeout=RANK_TIMEOUT,
                             deadline=RANK_DEADLINE)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = []
    for name in sorted(os.listdir(logs)):
        with open(os.path.join(logs, name), errors="replace") as f:
            lines += [ln.split(" NCCL INFO ", 1)[-1].strip() for ln in f
                      if " via " in ln or "NCCL version" in ln
                      or " WARN " in ln or "Using network" in ln]
    shutil.rmtree(logs, ignore_errors=True)
    uuid = {u.split(",")[1].strip(): int(u.split(",")[0])
            for u in probes[0]["gpus"]}
    held = {}
    for app in probes[0]["apps"]:
        pid, gpu = (f.strip() for f in app.split(",")[:2])
        held.setdefault(int(pid), []).append(uuid.get(gpu))
    for p in probes:
        log("[%s] 21e rank %d (pid %d, card %d, %d of %d cores' threads): "
            "local op read back %.4f ms, all_reduce read back %.4f ms, "
            "all_reduce enqueued back to back %.4f ms a call (host %.4f; "
            "torch.distributed's own, in place, %.4f), halo exchange "
            "waited %.4f ms (one row %.4f; as one all_to_all_single %.4f, "
            "one row %.4f); halo CG, ms per iteration in turns: %s; NCCL "
            "kernels (ms, calls an iteration) %s; contexts on cards %s"
            % (tag, p["rank"], p["pid"], p["card"], p["threads"], p["cores"],
               p["local_round_trip_ms"], p["all_reduce_round_trip_ms"],
               p["all_reduce_enqueued_ms"], p["all_reduce_host_ms"],
               p["raw_all_reduce_host_ms"], p["halo_round_trip_ms"],
               p["one_row_exchange_ms"], p["halo_a2a_ms"],
               p["one_row_a2a_ms"],
               {k: ", ".join("%.4f" % t for t in v)
                for k, v in p["cg_ms"].items()},
               {k: "%.4f, %.2f" % v for k, v in p["nccl_kernels"].items()},
               held.get(p["pid"])))
    for line in sorted(set(lines)):
        log("[%s] 21e NCCL: %s" % (tag, line))
    def mib(rows):
        return {int(r.split(",")[0]): int(r.split(",")[1].split()[0])
                for r in rows}
    grew = {k: v - mib(base).get(k, 0)
            for k, v in mib(probes[0]["memory"]).items()}
    log("[%s] 21e: device memory each card gained once every rank held "
        "its context (MiB; a context is some hundreds): %s" % (tag, grew))
    per_card = {}
    for cards_of in held.values():
        for c in cards_of:
            per_card[c] = per_card.get(c, 0) + 1
    log("[%s] 21e: compute processes per card (nvidia-smi): %s; this "
        "process holds card 0" % (tag, per_card))
    visible = any(p["pid"] in held for p in probes)
    if not visible:
        log("[%s] 21e: nvidia-smi lists none of the ranks' pids (%s): "
            "another pid namespace" % (tag, sorted(held)))
    if visible and any(per_card.get(c, 0) != (2 if c == 0 else 1)
                       for c in range(cards)):
        raise AssertionError("%s 21e: processes per card %s: a context "
                             "off its rank's card" % (tag, per_card))
    stray = {p["rank"]: held[p["pid"]] for p in probes
             if p["pid"] in held and held[p["pid"]] != [p["card"]]}
    if stray:
        raise AssertionError("%s 21e: ranks with contexts off their own "
                             "card: %s" % (tag, stray))
    return {"ranks": [{k: v for k, v in p.items() if k not in ("apps",
                                                              "gpus")}
                      for p in probes],
            "processes_per_card": per_card, "memory_gained_mib": grew,
            "nccl_lines": sorted(set(lines))}


# --------------------------------------------------------------------------
# 22. the DIA path past 64 diagonals
# --------------------------------------------------------------------------

BS_DEFAULT_N = 16       # grid of 22's default-route build (4,096 rows, the
                        # BELL policy's least; 48's BELL packing takes ~1 min
                        # of host work)
WIDE_MM_K = (1, 8, 16)  # block widths of 22's SpMM checks
WIDE_ITERS = 20         # calls a timing of 22 averages (plain versions and
                        # torch's CSR SpMM: 5)
WIDE_HOST_CALLS = 200   # wrapper calls of 22's host-cost timing


def _dia_csr(dia):
    """torch's CSR tensor of a DIA container's nonzeros (f32 values, int32
    indices), built on the card from the diagonals without a COO: its
    products are cuSPARSE calls, timed as a yardstick only."""
    m, n = dia.shape
    offs = torch.tensor(dia.offsets, device=dia.data.device)
    order = torch.argsort(offs)        # ascending columns within a row
    cols = torch.arange(m, device=offs.device)[:, None] + offs[order]
    vals = dia.data[order].T
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(m + 1, dtype=torch.int64, device=offs.device)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(),
                                   vals[keep].float(), size=(m, n))


def _wide_host_us(K, dia):
    """Host microseconds a DIA SpMV call takes on a small container (4,096
    rows, whose kernel is shorter than the call), at its 125 diagonals
    (WideOffsets, 16 KB of parameters) and at its first 7 (Offsets, 1
    KB): through the wrapper, and through the C entry alone with the
    wrapper's arguments made once (what the launch costs)."""
    import ctypes
    x = torch.ones(dia.shape[1], device=DEVICE)
    out = {}
    for ndiag in (len(dia.offsets), 7):
        data, offsets = dia.data[:ndiag].contiguous(), dia.offsets[:ndiag]
        y = K.dia_matvec(data, offsets, x)
        plan = K.dia_matvec_plan(data, offsets, x)
        fn = K._entry("dia_spmv_f32")
        offs = ctypes.cast(K._offsets_info(offsets)[0], ctypes.c_void_p)
        stream = torch.cuda.current_stream().cuda_stream
        args = (data.data_ptr(), offs, ndiag, plan.r, plan.lo, plan.hi,
                x.data_ptr(), y.data_ptr(), data.shape[1], x.shape[0],
                stream)
        for label, call in (("%d diagonals" % ndiag,
                             lambda: K.dia_matvec(data, offsets, x)),
                            ("%d diagonals, entry alone" % ndiag,
                             lambda: fn(*args))):
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(WIDE_HOST_CALLS):
                    call()
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                best = min(best, 1e6 * host / WIDE_HOST_CALLS)
            out[label] = best
    return out


def phase_wide(pt, rates):
    """22: the DIA path past 64 diagonals, on :func:`bspline_dia`'s
    125-diagonal 3-D B-spline Laplacian at n = BS_N (2,097,152 rows, 1.05
    GB of f32 diagonals), built on the card as a DIA container.

    * the SpMV kernel (WideOffsets) at all five entries and the SpMM at K
      in WIDE_MM_K bit for bit their plain versions, on the Laplacian and
      on a 125-diagonal container of its diagonals in shuffled order with
      five repeated;
    * CG (``solve``) with f32 storage, ``b = A x_true``, rtol 1e-6: DIA
      launches = matvecs, the f64 true residual at most 1e-4;
    * ``A.T @ x`` of the Laplacian plus a first derivative along x (drift
      BS_N: unsymmetric) through ``dia_transpose`` and the kernel, against
      ``formats.dia_rmatvec`` (f64 x: the sums' order differs);
    * ``HaloDiaOperator`` over MESH_SHARDS slots: a product and a K = KB
      block product bit for bit the unsharded kernel's;
    * the route: ``operator_from_coo(max_diags=128)`` at n = BS_ROUTE_N
      (110,592 rows) gives ``cuda-dia``, the default ``max_diags`` the
      BELL policy (held by ``auto_format``; built at n = BS_DEFAULT_N, a
      SELL card form);
    * the wide SpMV and the K = KB SpMM timed against their bound and
      torch's CSR product, and a wrapper call's host time at 125 and 7
      diagonals."""
    from pykrylov_tpu_torch.parallel import HaloDiaOperator, shard_vector
    from pykrylov_tpu_torch.sparse import formats as F
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import linop as L

    tag = "22 wide DIA"
    out = {}
    t0 = time.perf_counter()
    dia = bspline_dia(BS_N)
    torch.cuda.synchronize()
    m, ndiag = dia.shape[0], len(dia.offsets)
    data, offsets = dia.data, dia.offsets
    out["build_s"] = time.perf_counter() - t0
    log("[%s] B-spline Laplacian n=%d: %d rows, %d diagonals, %.1f MB of "
        "f32 diagonals, built on the card in %.2f s"
        % (tag, BS_N, m, ndiag, data.numel() * 4 / 1e6, out["build_s"]))
    if ndiag != 125 or ndiag <= 64:
        raise AssertionError("%s: %d diagonals" % (tag, ndiag))

    # a. the kernels against their plain versions
    g = torch.Generator(device=DEVICE).manual_seed(22)
    perm = torch.randperm(ndiag, generator=g, device=DEVICE)
    pick = torch.cat([perm[:ndiag - 5], perm[:5]])  # 120 shuffled, 5 twice
    shuffled = (data[pick], tuple(offsets[k] for k in pick.tolist()))
    x = torch.randn(m, generator=g, device=DEVICE)
    plans = {}
    for label, (d32, offs) in (("Laplacian", (data, offsets)),
                               ("shuffled, 5 repeated", shuffled)):
        for storage, xdt in DIA_ENTRIES:
            name = "%s %s/%s" % (label, str(storage)[6:], str(xdt)[6:])
            d, xc = d32.to(storage), x.to(xdt)
            plan = K.dia_matvec_plan(d, offs, xc)
            plans[name] = plan._asdict()
            y = K.dia_matvec(d, offs, xc)
            torch.cuda.synchronize()
            _exact("SpMV %s (R=%d, interior %d:%d)" % (name, *plan), y,
                   K.dia_matvec_plain(d, offs, xc), tag=tag)
            del d, xc, y
        for kb in WIDE_MM_K:
            X = torch.randn(m, kb, generator=g, device=DEVICE)
            Y = K.dia_matmat(d32, offs, X)
            torch.cuda.synchronize()
            _exact("SpMM %s K=%d (%s)" % (
                label, kb, K.dia_matmat_plan(d32, offs, X)), Y,
                K.dia_matmat_plain(d32, offs, X), tag=tag)
            _exact("SpMM %s K=%d column %d = SpMV" % (label, kb, kb - 1),
                   Y[:, kb - 1], K.dia_matvec(d32, offs,
                                              X[:, kb - 1].contiguous()),
                   tag=tag)
            del X, Y
    del shuffled, pick
    out["plans"] = plans

    # b. CG through the SpMV kernel
    A = K.cuda_dia_operator(dia, symmetric=True)
    x_true = torch.randn(m, generator=g, device=DEVICE)
    b = A * x_true
    _exact("b = A x_true", b, K.dia_matvec_plain(data, offsets, x_true),
           tag=tag)
    warm = pt.solve(A, b, maxiter=20)
    torch.cuda.synchronize()
    del warm
    res, secs, counts = _counted_solve(tag, "solve (CG)",
                                       lambda: pt.solve(A, b), "dia_spmv")
    rel = _true_rel(b, lambda v: K.dia_matvec(data, offsets, v), res.x)
    n_iter = int(res.n_iter)
    log("[%s] solve: true relative residual %.3e in f64 (bound 1e-4), "
        "%.4f ms per iteration" % (tag, rel, 1e3 * secs / n_iter))
    if not (bool(res.converged) and int(res.istop) == 0 and rel <= 1e-4):
        raise AssertionError("%s: converged %s istop %d true residual %.3e"
                             % (tag, bool(res.converged), int(res.istop),
                                rel))
    out["cg"] = {"kernel": "dia_spmv", "n_iter": n_iter,
                 "n_matvec": int(res.n_matvec), "launches": counts,
                 "solve_s": secs, "ms_per_iter": 1e3 * secs / n_iter,
                 "true_rel": rel}
    del res, A

    # c. A^T x of an unsymmetric container through the repaired transpose
    U = K.cuda_dia_operator(bspline_dia(BS_N, drift=float(BS_N)),
                            symmetric=False)
    x64 = x.double()
    _reset_counts()
    y = U.T * x64
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts["dia_spmv"]
    ut = U.container_transp
    _exact("A^T x (f32 storage, f64 x), dia_transpose", y,
           K.dia_matvec_plain(ut.data, ut.offsets, x64), tag=tag)
    err = relerr(y, F.dia_rmatvec(U.container, x64))
    log("[%s] A^T x against formats.dia_rmatvec: rel err %.3e (bound "
        "%.0e), %d launch" % (tag, err, REL_BOUND[torch.float64], launches))
    if (not err <= REL_BOUND[torch.float64] or launches != 1
            or sum(counts.values()) != 1):
        raise AssertionError("%s A^T x: rel err %.3e, %d launches"
                             % (tag, err, launches))
    out["transpose"] = {"launches": counts, "rel_err": err}
    del U, ut, y, x64

    # d. the halo operator on MESH_SHARDS slots of the card
    mesh = _mesh_of(pt)
    t0 = time.perf_counter()
    H = HaloDiaOperator(dia, mesh)
    torch.cuda.synchronize()
    halo_s = time.perf_counter() - t0
    log("[%s] halo operator: %d shards, halo width %d, kernel path %s, "
        "built in %.2f s" % (tag, MESH_SHARDS, H.halo_width, H.local_kernel,
                            halo_s))
    for label, v, kernel, whole in (
            ("product", x, "dia_spmv", K.dia_matvec),
            ("K=%d block product" % KB,
             torch.randn(m, KB, generator=g, device=DEVICE), "dia_spmm",
             K.dia_matmat)):
        _reset_counts()
        y = H * shard_vector(v, mesh)
        torch.cuda.synchronize()
        counts = _counts()
        _exact("halo %s = the unsharded kernel's" % label, y,
               whole(data, offsets, v), tag=tag)
        if counts[kernel] != MESH_SHARDS or sum(counts.values()) != \
                MESH_SHARDS or not H.local_kernel:
            raise AssertionError("%s halo %s: launches %s" % (tag, label,
                                                              counts))
        out["halo " + label] = {"launches": counts}
        del y
    out["halo_build_s"] = halo_s
    del H

    # e. the route
    coo = bspline_coo(BS_ROUTE_N, dtype=np.float32)
    t0 = time.perf_counter()
    R = L.operator_from_coo(*coo, symmetric=True, max_diags=128,
                            device=DEVICE)
    torch.cuda.synchronize()
    route = {"rows": coo[3][0], "build_s": time.perf_counter() - t0,
             "fmt": R.fmt}
    ndiag_r, density = F.bandwidth_profile(F.COO(*coo))
    route["default_auto"] = L.auto_format(ndiag_r, density, coo[3], "cuda")
    xr = torch.randn(R.shape[1], generator=g, device=DEVICE)
    _exact("route n=%d product" % BS_ROUTE_N, R * xr,
           K.dia_matvec_plain(R.container.data, R.container.offsets, xr),
           tag=tag)
    del R, coo, xr
    t0 = time.perf_counter()
    D = L.operator_from_coo(*bspline_coo(BS_DEFAULT_N, dtype=np.float32),
                            symmetric=True, device=DEVICE)
    route.update(default_fmt=getattr(D, "fmt", None),
                 default_build_s=time.perf_counter() - t0,
                 default_card=type(getattr(D, "card", None)).__name__)
    log("[%s] route: n=%d (%d rows, %d diagonals, fill %.3f) with "
        "max_diags=128 gave fmt=%s in %.2f s; the default max_diags: "
        "auto_format %r; at n=%d fmt=%s (card form %s) in %.2f s"
        % (tag, BS_ROUTE_N, route["rows"], ndiag_r, density, route["fmt"],
           route["build_s"], route["default_auto"], BS_DEFAULT_N,
           route["default_fmt"], route["default_card"],
           route["default_build_s"]))
    if (route["fmt"] != "cuda-dia" or route["default_auto"] != "ell"
            or route["default_fmt"] != "bell"
            or route["default_card"] != "SELL"):
        raise AssertionError("%s route: %s" % (tag, route))
    out["route"] = route
    del D

    # f. timing against the bound and torch's CSR product
    csr = _dia_csr(dia)
    nnz = csr.values().numel()
    matrix = min(ndiag * 4 * m, nnz * 8 + (m + 1) * 4)
    best = _best_ms([("kernel", lambda: K.dia_matvec(data, offsets, x)),
                     ("torch CSR", lambda: csr @ x)], WIDE_ITERS)
    best.update(_best_ms([("plain", lambda: K.dia_matvec_plain(
        data, offsets, x))], 5))
    # the matrix once (its own bytes: (125 + 2) m 4 with x and y), x read
    # and y written once
    bound = _bound(matrix + 2 * 4 * m, 2 * nnz, rates)
    spmv = {"ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["torch CSR"], "nnz": nnz, **bound}
    log("[%s] SpMV f32: kernel %.4f ms (%.1f GB/s), plain %.4f, torch CSR "
        "%.4f (%d nonzeros); bound %.4f ms (%s), kernel at %.1f%% of it; "
        "achievable %.4f"
        % (tag, best["kernel"], (matrix + 8 * m) / best["kernel"] / 1e6,
           best["plain"], best["torch CSR"], nnz, bound["bound_ms"],
           bound["bound_by"], 100 * bound["bound_ms"] / best["kernel"],
           bound["achievable_ms"]))
    # the two paths on the same rows: the first 64 diagonals (Offsets) and
    # the first 65 (WideOffsets), each against its own bytes' bound
    best = _best_ms([("%d diagonals" % k,
                      (lambda k: lambda: K.dia_matvec(data[:k], offsets[:k],
                                                      x))(k))
                     for k in (64, 65)], WIDE_ITERS)
    spmv["paths"] = {}
    for k in (64, 65):
        b = _bound((k + 2) * 4 * m, 2 * k * m, rates)
        spmv["paths"][str(k)] = {"ms": best["%d diagonals" % k], **b}
        log("[%s] SpMV f32, the first %d diagonals (%s): %.4f ms, bound "
            "%.4f ms, kernel at %.1f%% of it"
            % (tag, k, "Offsets" if k <= 64 else "WideOffsets",
               best["%d diagonals" % k], b["bound_ms"],
               100 * b["bound_ms"] / best["%d diagonals" % k]))
    X = torch.randn(m, KB, generator=g, device=DEVICE)
    best = _best_ms([("kernel", lambda: K.dia_matmat(data, offsets, X))],
                    WIDE_ITERS)
    best.update(_best_ms([("plain", lambda: K.dia_matmat_plain(
        data, offsets, X)), ("torch CSR SpMM",
                             lambda: torch.sparse.mm(csr, X))], 5))
    bound = _bound(matrix + KB * 2 * m * 4, 2 * nnz * KB, rates)
    spmm = {"k": KB, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["torch CSR SpMM"],
            "plan": K.dia_matmat_plan(data, offsets, X)._asdict(), **bound}
    log("[%s] SpMM f32 K=%d: kernel %.4f ms, plain %.4f, torch CSR SpMM "
        "%.4f; bound %.4f ms (%s), kernel at %.1f%% of it; achievable %.4f"
        % (tag, KB, best["kernel"], best["plain"], best["torch CSR SpMM"],
           bound["bound_ms"], bound["bound_by"],
           100 * bound["bound_ms"] / best["kernel"], bound["achievable_ms"]))
    del csr, X
    host = _wide_host_us(K, bspline_dia(BS_DEFAULT_N))
    log("[%s] host time a SpMV wrapper call at 4,096 rows: %s"
        % (tag, ", ".join("%s %.1f us" % kv for kv in host.items())))
    out.update(spmv=spmv, spmm=spmm, host_us=host)
    return out


PROBE_BYTES = 512 << 20  # bytes a stream fold of 23 reads (the probe's)
PROBE_UNROLL = 4        # rows of loads in flight a thread, 23's direct fold
PROBE_RING = (16384, 4)  # chunk bytes and depth of 23's ring fold
PROBE_DIA = (1024, 2)   # tile rows and depth of 23's DIA ring
PROBE_ITERS = 20        # calls a timing of 23 averages


def _probe_edges(tag):
    """23b: the probe kernels at small sizes on their edge cases, each bit
    for bit its plain version."""
    from pykrylov_tpu_torch.probes import bell_mma as BM
    from pykrylov_tpu_torch.probes import dia_ring as DR
    from pykrylov_tpu_torch.probes import onehot_mma as OM
    from pykrylov_tpu_torch.probes import sell_ablation as SA
    from pykrylov_tpu_torch.probes import stream_floor as SF
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import operator_from_coo

    # lengths of 37 rows of 4 KB: no chunk above 4 KB divides them
    for nstreams in (1, 2):
        streams = SF.probe_streams(nstreams, nstreams * 37 * 4096, seed=37,
                                   device=DEVICE)
        ref = SF.stream_fold_plain(streams)
        for label, kw in (("direct U=8", dict(mode="direct", unroll=8)),
                          ("direct, 1 block", dict(mode="direct", blocks=1)),
                          ("ring 16 KB x 2", dict(mode="ring", chunk=16384,
                                                  depth=2)),
                          ("ring 32 KB x 3, 1 block",
                           dict(mode="ring", chunk=32768, depth=3,
                                blocks=1))):
            y = SF.stream_fold(streams, **kw)
            torch.cuda.synchronize()
            _exact("fold, %d stream(s) of 37 rows, %s" % (nstreams, label),
                   y, ref, tag=tag)
    bspline = tuple(a * 576 + b * 24 + c for a in range(-2, 3)
                    for b in range(-2, 3) for c in range(-2, 3))
    rng = np.random.default_rng(23)
    # (label, m, n, offsets, tile, depth): depth 2 with 1, 5, 7 and 125
    # diagonals (odd: ring positions cross tiles on alternating slots);
    # every m here leaves a ragged last tile
    for label, m, n, offsets, tile, depth in (
            ("1 diagonal", 20012, 20012, (0,), 1024, 2),
            ("7 diagonals", 20012, 20012, (-400, -20, -1, 0, 1, 20, 400),
             1024, 2),
            ("64 diagonals", 40004, 40004, tuple(range(-40, 24)), 2048, 4),
            ("65 diagonals", 40004, 40004, tuple(range(-40, 25)), 512, 3),
            ("125 B-spline diagonals", 13828, 13828, bspline, 1024, 2),
            ("offsets past the matrix", 20016, 20016,
             (-30000, -3, 0, 2, 25000), 256, 2),
            ("rectangular", 20016, 15000, (-700, -1, 0, 2, 990), 4096, 8)):
        data = torch.from_numpy(rng.standard_normal((len(offsets), m))).to(
            DEVICE, torch.float32)
        x = torch.from_numpy(rng.standard_normal(n)).to(DEVICE,
                                                        torch.float32)
        data = _poison(data, offsets, n)
        y = DR.dia_matvec_ring(data, offsets, x, tile, depth)
        torch.cuda.synchronize()
        _exact("DIA ring, %s (m=%d, tile %d, depth %d)"
               % (label, m, tile, depth), y,
               K.dia_matvec_plain(data, offsets, x), tag=tag)
    # a rectangular card form with empty rows and rows of 40-odd entries
    rows = np.concatenate([rng.integers(0, 1500, 9000),
                           np.repeat(rng.integers(0, 1500, 5), 40)])
    cols = rng.integers(0, 1700, len(rows))
    keys = np.unique(rows * 1700 + cols)
    rect = operator_from_coo(
        rng.standard_normal(len(keys)).astype(np.float32), keys // 1700,
        keys % 1700, (3000, 1700), fmt="bell", device=DEVICE).card
    x = torch.from_numpy(rng.standard_normal(1700)).to(DEVICE, torch.float32)
    for variant in SA.VARIANTS:
        y = SA.sell_matvec_ablated(rect, x, variant)
        torch.cuda.synchronize()
        _exact("SELL %s, 3000 x 1700 with empty rows" % variant, y,
               SA.sell_matvec_ablated_plain(rect, x, variant), tag=tag)
    # every f32 pattern through both selects, at the probe's shape and a
    # ragged one
    for shape in ((1024, 256, 128), (512, 96, 96)):
        oh, w = probe_select_inputs(*shape, seed=1,
                                    specials=SELECT_SPECIALS)
        for mode in OM.MODES:
            y = OM.onehot_select(oh, w, mode)
            torch.cuda.synchronize()
            _hold_select("select %s at %s, every pattern" % (mode, shape),
                         y, OM.onehot_select_plain(oh, w, mode), tag)
    # a short x, whose window columns past it read 0, on 16 tiles
    forms, _, x = probe_mma_matrix(tiles=16)
    x = x[:-1000].contiguous()
    for stage in BM.STAGES:
        for fold in BM.FOLDS:
            y = BM.bell_step_mma(forms["bf16"], x, stage, fold, "add", 4)
            torch.cuda.synchronize()
            _exact("BELL mma %s/%s/add nseg 4, bf16 values, short x"
                   % (stage, fold), y, BM.bell_step_mma_plain(
                       forms["bf16"], x, stage, fold, "add", 4), tag=tag)


PROBE_MMA_TILES = 1024   # jpwh_991 tiles of 23's BELL mma product
PROBE_SELECT = (1024, 256, 128)  # GS, NB, L of 23's one-hot select
MMA_SCATTER_BOUND = 2.0 ** -20   # the mma scatters, of a row's sum of
                                 # |group sums|: the tensor cores sum a
                                 # block's groups in f32 in their own order
# the f32 patterns the select must carry beside normals, by kind
SELECT_SPECIALS = {
    "-0": (0x80000000,),
    "subnormal": (0x00000001, 0x807FFFFF, 0x00012345),
    "inf": (0x7F800000, 0xFF800000),
    "nan": (0x7FC00000, 0xFFC12345, 0x7F800001, 0x7FBFFFFF),
}


def probe_mma_matrix(tiles=None, device=None):
    """``probe_ablate_r3b.py:26-33``'s matrix: ``tiled_general_coo(tiles)``
    (jpwh_991, coupling 4) scaled by its largest absolute row sum, as its
    window-1 BELL packing on ``device``: {"f32": container, "bf16": the
    same with bf16 values}, the COO triples and x (standard normal, seed
    23)."""
    from pykrylov_tpu_torch.gallery import tiled_general_coo
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import formats as F

    device = device or DEVICE
    vals, rows, cols, shape = tiled_general_coo(
        tiles=tiles or PROBE_MMA_TILES)
    rowsum = np.zeros(shape[0])
    np.add.at(rowsum, rows, np.abs(vals))
    vals = (vals / rowsum.max()).astype(np.float32)
    b = B.bell_from_coo(F.coo_from_arrays(vals, rows, cols, shape,
                                          device=None),
                        spill_cost=None, device=device, window=1)
    x = torch.randn(shape[1], device=device, generator=torch.Generator(
        device=device).manual_seed(23))
    return ({"f32": b, "bf16": B.bell_with_values_dtype(b, torch.bfloat16)},
            (vals, rows, cols, shape), x)


def probe_select_inputs(gs, nb, l, seed=0, specials=(), device=None):
    """``probe_int8_mxu.py``'s inputs: a (gs, nb) bool one-hot oh of random
    rows (every row of w picked where gs >= nb) and a standard-normal
    (nb, l) f32 w, with the patterns of the kinds ``specials`` (keys of
    SELECT_SPECIALS) placed in columns of their own."""
    device = device or DEVICE
    rng = np.random.default_rng(seed)
    base = rng.permutation(np.arange(gs) % nb)
    oh = base[:, None] == np.arange(nb)[None, :]
    w = rng.standard_normal((nb, l)).astype(np.float32)
    wb = w.view(np.uint32)
    placed = [p for kind in specials for p in SELECT_SPECIALS[kind]]
    for i, p in enumerate(placed):
        wb[rng.integers(0, nb), 3 + 7 * i] = p
    return torch.from_numpy(oh).to(device), torch.from_numpy(w).to(device)


def _hold_select(label, y, ref, tag):
    """The select bit for bit its plain version; NaN where it is NaN (any
    payload) in ``bf16x3``."""
    nan = torch.isnan(ref)
    same = torch.equal(torch.isnan(y), nan) and torch.equal(
        y.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])
    if not same:
        raise AssertionError("%s: kernel differs from plain" % label)
    log("[%s] %-44s kernel = plain bit for bit (%d NaN)"
        % (tag, label, int(nan.sum())))


def hold_bell_mma(tag, label, b, x, y, cfg, sums):
    """A ``bell_step_mma`` output against its plain version: the group sums
    (computed once a staging, fold and nseg, in ``sums``) scattered as the
    plain version does.  ``add``: bit for bit; mma: within
    MMA_SCATTER_BOUND of each row's sum of |group sums|.  Returns the
    largest absolute error."""
    from pykrylov_tpu_torch.probes import bell_mma as BM

    _, values, stage, fold, scatter, nseg = cfg
    key = (values, stage, fold, nseg)
    if key not in sums:
        sums[key] = BM.bell_group_sums(b, x, stage, fold, nseg)
    ps = sums[key]
    ref = BM.bell_block_sums(b, ps, scatter)
    if scatter == "add":
        _exact(label, y, ref, tag=tag)
        return 0.0
    if y.shape != ref.shape or not torch.isfinite(y).all():
        raise AssertionError("%s: kernel gave %s, finite %s"
                             % (label, tuple(y.shape),
                                bool(torch.isfinite(y).all())))
    scale = BM.bell_block_sums(b, ps.abs())
    err = (y - ref).abs()
    worst = (err / scale.clamp(min=1e-30)).max().item()
    if not (err <= MMA_SCATTER_BOUND * scale).all():
        raise AssertionError("%s: mma scatter off by %.3e of a row's sum of "
                             "|group sums|, past %.3e"
                             % (label, worst, MMA_SCATTER_BOUND))
    log("[%s] %-44s max |kernel - plain| %.3e, %.3e of the row's sum of "
        "|group sums| (bound %.3e)"
        % (tag, label, err.max().item(), worst, MMA_SCATTER_BOUND))
    return err.max().item()


def phase_probes(pt, A_dia, A_bell, coo_bell, rates):
    """23: the TPU probes' kernels (``pykrylov_tpu_torch.probes``; swept in
    full by ``chip_probes.py``), on objects earlier phases built.

    a. The probes' path, with every launch count set to 0 just before and
       read just after: ``stream_fold`` over PROBE_BYTES in one and in two
       streams, direct and through the TMA ring (4 launches);
       ``dia_matvec_ring`` on phase 4's Poisson container (1);
       ``sell_matvec_ablated``, every variant, on phase 5's card form (7);
       no solver kernel.  Each output bit for bit its plain version, and
       ``full`` bit for bit ``sell_matvec``.
    b. Edge cases at small size (:func:`_probe_edges`).
    c. One timed point of each kernel (the direct fold on one stream, the
       ring fold beside it; the DIA ring beside ``dia_matvec``; ``full``
       beside ``sell_matvec``) against its plain version, its bound and
       one torch call of the same function (``a.view(-1, 1024).sum(0)``,
       torch's CSR product).

    The tensor-core probes ride on the same path: a. also runs
    ``bell_step_mma``'s nine configurations and two controls on
    ``probe_ablate_r3b.py``'s matrix (:func:`probe_mma_matrix`; 11
    launches) and ``onehot_select`` in both modes at PROBE_SELECT (2);
    b. every f32 pattern through both selects, and a short x; c. the
    baseline configuration and its control against the plain version, the
    bound and torch's CSR product, the selects against ``w[base]`` and
    ``oh.float() @ w``."""
    from pykrylov_tpu_torch import probes
    from pykrylov_tpu_torch.probes import bell_mma as BM
    from pykrylov_tpu_torch.probes import dia_ring as DR
    from pykrylov_tpu_torch.probes import onehot_mma as OM
    from pykrylov_tpu_torch.probes import sell_ablation as SA
    from pykrylov_tpu_torch.probes import stream_floor as SF
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S

    tag = "23 probes"
    t0 = time.perf_counter()
    mma_forms, mma_coo, x_mma = probe_mma_matrix()
    b32 = mma_forms["f32"]
    nsteps, gs, _ = b32.data.shape
    log("[%s] probe_ablate_r3b.py's matrix: %d x %d, %d nonzeros; window-1 "
        "BELL of %d steps of %d rows, nb %d, nblk %d, fill %.3f, %d in the "
        "remainder (packed in %.1f s)"
        % (tag, mma_coo[3][0], mma_coo[3][1], len(mma_coo[0]), nsteps, gs,
           b32.nb, b32.nblk, B.bell_fill(b32), b32.nnz_spill,
           time.perf_counter() - t0))
    mma_cfgs = BM.PROBE_CONFIGS + BM.CONTROLS[:2]
    oh, w_sel = probe_select_inputs(*PROBE_SELECT)
    data, offsets = A_dia.container.data, A_dia.container.offsets
    card = A_bell.card
    g = torch.Generator(device=DEVICE).manual_seed(23)
    x_dia = torch.randn(data.shape[1], generator=g, device=DEVICE)
    x_sell = torch.randn(card.n, generator=g, device=DEVICE)
    streams = {k: SF.probe_streams(k, PROBE_BYTES, seed=k, device=DEVICE)
               for k in (1, 2)}
    modes = {"direct": dict(mode="direct", unroll=PROBE_UNROLL),
             "ring": dict(mode="ring", chunk=PROBE_RING[0],
                          depth=PROBE_RING[1])}
    torch.cuda.synchronize()

    # a. the path
    _reset_counts()
    probes.reset_counts()
    folds = {(k, mode): SF.stream_fold(streams[k], **kw)
             for k in streams for mode, kw in modes.items()}
    y_ring = DR.dia_matvec_ring(data, offsets, x_dia, *PROBE_DIA)
    ys = {v: SA.sell_matvec_ablated(card, x_sell, v) for v in SA.VARIANTS}
    ys_mma = {cfg[0]: BM.bell_step_mma(mma_forms[cfg[1]], x_mma, *cfg[2:])
              for cfg in mma_cfgs}
    sel = {mode: OM.onehot_select(oh, w_sel, mode) for mode in OM.MODES}
    torch.cuda.synchronize()
    launches, solver = probes.counts(), _counts()
    log("[%s] the path's launches: %s; solver kernels %s"
        % (tag, launches, solver))
    expect = {"probe_stream": 2 * len(modes), "probe_dia_ring": 1,
              "probe_sell_ablation": len(SA.VARIANTS),
              "probe_onehot_mma": len(OM.MODES),
              "probe_bell_mma": len(mma_cfgs)}
    if launches != expect or any(solver.values()):
        raise AssertionError("%s: launches %s and %s, not %s"
                             % (tag, launches, solver, expect))
    for (k, mode), y in folds.items():
        _exact("fold, %d stream(s) of %d MB, %s" % (
            k, PROBE_BYTES >> 20, mode), y, SF.stream_fold_plain(streams[k]),
            tag=tag)
    _exact("DIA ring on phase 4's Poisson (tile %d, depth %d)" % PROBE_DIA,
           y_ring, K.dia_matvec_plain(data, offsets, x_dia), tag=tag)
    for v, y in ys.items():
        _exact("SELL %s on phase 5's card form" % v, y,
               SA.sell_matvec_ablated_plain(card, x_sell, v), tag=tag)
    _exact("SELL full = sell_matvec", ys["full"],
           S.sell_matvec(card, x_sell), tag=tag)
    sums, mma_err = {}, 0.0
    for cfg in mma_cfgs:
        mma_err = max(mma_err, hold_bell_mma(
            tag, "BELL mma " + cfg[0], mma_forms[cfg[1]], x_mma,
            ys_mma[cfg[0]], cfg, sums))
    # the container's own product, whose index_add_ has no fixed order on
    # the card
    rel = relerr(ys_mma[BM.CONTROLS[0][0]], B.bell_matvec_plain(b32, x_mma))
    if rel > REL_BOUND[torch.float32]:
        raise AssertionError("%s: load/tile/add off bell_matvec_plain by "
                             "%.3e" % (tag, rel))
    log("[%s] BELL mma control load/tile/add within %.3e of "
        "bell_matvec_plain (bound %.0e)" % (tag, rel,
                                             REL_BOUND[torch.float32]))
    for mode, y in sel.items():
        _hold_select("select %s at (%d, %d, %d)" % ((mode,) + PROBE_SELECT),
                     y, OM.onehot_select_plain(oh, w_sel, mode), tag)
    del folds, y_ring, ys, streams[2], ys_mma, sel, sums

    # b. edge cases
    _probe_edges(tag)

    # c. one timed point each
    out = {"launches": launches}
    a = streams[1]
    nbytes = SF.stream_bytes(a)
    best = _best_ms([("direct", lambda: SF.stream_fold(a, **modes["direct"])),
                     ("ring", lambda: SF.stream_fold(a, **modes["ring"])),
                     ("plain", lambda: SF.stream_fold_plain(a)),
                     ("torch sum", lambda: a[0].view(-1, SF.BINS).sum(0))],
                    PROBE_ITERS)
    b = _bound(nbytes, nbytes // 4, rates)
    rate = max(nbytes / best[k] / 1e6 for k in ("direct", "ring"))
    out["stream"] = {"ms": best["direct"], "ring_ms": best["ring"],
                     "plain_ms": best["plain"],
                     "library_ms": best["torch sum"], "read_gbps": rate, **b}
    log("[%s] fold of %d MB: direct %.4f ms, ring %.4f, plain %.4f, torch "
        "sum %.4f; bound %.4f ms; best read rate %.1f GB/s (copy rate %.1f "
        "GB/s)" % (tag, nbytes >> 20, best["direct"], best["ring"],
                   best["plain"], best["torch sum"], b["bound_ms"], rate,
                   rates["copy"] / 1e9))
    del a, streams
    csr = _dia_csr(A_dia.container)
    m, ndiag = data.shape[1], len(offsets)
    best = _best_ms([("ring", lambda: DR.dia_matvec_ring(data, offsets, x_dia,
                                                         *PROBE_DIA)),
                     ("dia_matvec", lambda: K.dia_matvec(data, offsets,
                                                         x_dia)),
                     ("plain", lambda: K.dia_matvec_plain(data, offsets,
                                                          x_dia)),
                     ("torch CSR", lambda: csr @ x_dia)], PROBE_ITERS)
    b = _bound(DR.dia_ring_bytes(ndiag, m, m), 2 * ndiag * m, rates)
    out["dia"] = {"ms": best["ring"], "dia_matvec_ms": best["dia_matvec"],
                  "plain_ms": best["plain"], "library_ms": best["torch CSR"],
                  **b}
    log("[%s] DIA ring, Poisson n=%d: %.4f ms (dia_matvec %.4f), plain "
        "%.4f, torch CSR %.4f; bound %.4f ms, ring at %.1f%% of it"
        % (tag, N, best["ring"], best["dia_matvec"], best["plain"],
           best["torch CSR"], b["bound_ms"],
           100 * b["bound_ms"] / best["ring"]))
    del csr
    csr = _torch_csr(coo_bell, DEVICE)
    nnz = int(card.row_len.sum())
    best = _best_ms([("full", lambda: SA.sell_matvec_ablated(card, x_sell)),
                     ("sell_matvec", lambda: S.sell_matvec(card, x_sell)),
                     ("plain", lambda: SA.sell_matvec_ablated_plain(
                         card, x_sell)),
                     ("torch CSR", lambda: csr @ x_sell)], 100,
                    host_waits=("plain",))
    b = _bound(SA.ablation_bytes(card, card.n, "full"), 2 * nnz, rates)
    out["sell"] = {"ms": best["full"], "sell_matvec_ms": best["sell_matvec"],
                   "plain_ms": best["plain"], "library_ms": best["torch CSR"],
                   **b}
    log("[%s] SELL full, tiled 1138bus: %.4f ms (sell_matvec %.4f, ratio "
        "%.4f), plain %.4f, torch CSR %.4f; bound %.4f ms"
        % (tag, best["full"], best["sell_matvec"],
           best["full"] / best["sell_matvec"], best["plain"],
           best["torch CSR"], b["bound_ms"]))
    del csr
    base_cfg, control = BM.PROBE_CONFIGS[0], BM.CONTROLS[0]
    csr = _torch_csr(mma_coo, DEVICE)
    best = _best_ms([("mma", lambda: BM.bell_step_mma(b32, x_mma,
                                                      *base_cfg[2:])),
                     ("control", lambda: BM.bell_step_mma(b32, x_mma,
                                                          *control[2:])),
                     ("torch CSR", lambda: csr @ x_mma)], PROBE_ITERS)
    # once: section a ran the same plain product, so this one is warm
    plain = events_ms(lambda: BM.bell_step_mma_plain(
        b32, x_mma, *base_cfg[2:]), 1)
    nbytes = BM.bell_mma_bytes(b32, x_mma.shape[0])
    b = _bound(nbytes, BM.bell_mma_flops(b32, base_cfg[2], base_cfg[4]),
               rates)
    b_bf16 = _bound(BM.bell_mma_bytes(mma_forms["bf16"], x_mma.shape[0]),
                    BM.bell_mma_flops(b32, "f32", "f32"), rates)
    out["bell_mma"] = {"ms": best["mma"], "control_ms": best["control"],
                       "plain_ms": plain, "library_ms": best["torch CSR"],
                       "max_abs_err": mma_err,
                       "bf16_values_bound_ms": b_bf16["bound_ms"], **b}
    log("[%s] BELL mma %s: %.4f ms, control load/tile/add %.4f, plain %.4f, "
        "torch CSR %.4f; bound %.4f ms (%s; %.1f MB), kernel at %.1f%% of "
        "it; bf16 values, tf32 stage and scatter: bound %.4f ms; largest "
        "mma scatter error %.3e"
        % (tag, base_cfg[0], best["mma"], best["control"], plain,
           best["torch CSR"], b["bound_ms"], b["bound_by"], nbytes / 1e6,
           100 * b["bound_ms"] / best["mma"], b_bf16["bound_ms"], mma_err))
    del csr
    base = oh.to(torch.uint8).argmax(1)
    ohf = oh.float()
    best = _best_ms([("int8", lambda: OM.onehot_select(oh, w_sel, "int8")),
                     ("bf16x3", lambda: OM.onehot_select(oh, w_sel,
                                                         "bf16x3")),
                     ("plain", lambda: OM.onehot_select_plain(oh, w_sel)),
                     ("plain bf16x3", lambda: OM.onehot_select_plain(
                         oh, w_sel, "bf16x3")),
                     ("w[base]", lambda: w_sel[base]),
                     ("oh.float() @ w", lambda: ohf @ w_sel)], PROBE_ITERS)
    gs_, nb_, l_ = PROBE_SELECT
    b = _bound(OM.onehot_select_bytes(*PROBE_SELECT),
               {"int8": 4 * 2 * gs_ * nb_ * l_}, rates)
    out["onehot"] = {"ms": best["int8"], "bf16x3_ms": best["bf16x3"],
                     "plain_ms": best["plain"],
                     "plain_bf16x3_ms": best["plain bf16x3"],
                     "library_ms": best["w[base]"],
                     "matmul_ms": best["oh.float() @ w"], **b}
    log("[%s] select at (%d, %d, %d): int8 %.4f ms, bf16x3 %.4f, plain "
        "%.4f / %.4f, w[base] %.4f, oh.float() @ w (f32) %.4f; bound %.4f ms"
        % ((tag,) + PROBE_SELECT + (best["int8"], best["bf16x3"],
                                    best["plain"], best["plain bf16x3"],
                                    best["w[base]"], best["oh.float() @ w"],
                                    b["bound_ms"])))
    return out


# --------------------------------------------------------------------------
# 24. block CG's passes
# --------------------------------------------------------------------------

# (dtype, K) of phase 24's cases on (N^3, K) card blocks: 16-byte loads of
# 4 and of 2 values, and a 12-byte row (one value a load)
BCG_CASES = ((torch.float32, KB), (torch.float32, 3), (torch.float64, KB))
# a pass's outputs against its plain torch version on the same inputs, the
# largest difference in a column over the column's largest |value|: the
# kernels sum in float64 in another order than torch's and round
# r - alpha ap once (FMA); a column summed wrong, or a block's rows left
# out, is off by 1e-4 or more
BCG_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
BCG_ITERS = 20      # back-to-back calls a timing
# the columns' roles, in turn: running on, frozen (inactive), negative
# curvature (AP = -P d), stopping on its threshold in the step
BCG_ROLES = ("run", "frozen", "bad", "stop")


def _bcg_beta(prev, act, ry2, thresh):
    """The plain version of the scalar step after R'R or R'Y (the torch
    loop's rules), from the state ``prev`` before it."""
    resid = torch.where(act, torch.sqrt(torch.clamp(ry2, min=0)),
                        prev["resid"])
    done = act & ((resid <= thresh) | ~torch.isfinite(resid))
    active = act & ~done
    return {"resid": resid,
            "beta": torch.where(act, ry2 / torch.where(prev["ry"] == 0, 1,
                                                       prev["ry"]), 0),
            "ry": torch.where(act, ry2, prev["ry"]),
            "iters": prev["iters"] + prev["active"].to(torch.int32),
            "active": active,
            "flags": torch.stack([active.any(), active.all()])}


def phase_block_cg(pt, rates):
    """24: block CG's three passes (``csrc/block_cg.cu``, through
    ``solvers.block_cg.BlockCG``) on (N^3, K) card blocks of BCG_CASES,
    with the launches counted from 0.

    a. Each pass against its plain torch version on the same inputs
       (BCG_TOL), the columns in the roles of BCG_ROLES under the curvature
       test: ``coldot(P, AP)`` (the act mask, alpha, the curvature
       verdicts), ``update_r(AP)`` (R, then R'R's step: the residuals,
       beta, ry, the counts, the mask, the poll's flags), ``update_xp(R)``
       (X and P); then an iteration with M: ``coldot(P, AP)``,
       ``update_r(AP)`` without sums (the state left as it was),
       ``coldot(R, Y)`` with the history row, ``update_xp(Y)``.  A column
       the mask leaves off keeps its values bit for bit; 7 launches a case.
    b. Each pass timed alone (:func:`device_ms`; every column running,
       alpha and beta 0, so that the blocks hold still over the calls),
       and the iteration's three passes, 10 of the block, against their
       bound and against the torch loop's block work of an iteration with
       every column active (two column dots and three ``addcmul``, 17
       passes of the block)."""
    from pykrylov_tpu_torch.solvers import block_cg as BC
    from pykrylov_tpu_torch.solvers.common import col_vdots_real

    tag = "24 block CG"
    n = N ** 3
    out = {"cases": {}, "max_rel_err": 0.0}
    _reset_counts()
    for dtype, k in BCG_CASES:
        label = "%s K=%d" % (str(dtype).split(".")[-1], k)
        tol = BCG_TOL[dtype]
        gen = torch.Generator(device=DEVICE).manual_seed(24)
        errs = []

        def randn():
            return torch.randn(n, k, dtype=dtype, device=DEVICE,
                               generator=gen)

        def role(r):
            return torch.tensor([BCG_ROLES[c % len(BCG_ROLES)] == r
                                 for c in range(k)], device=DEVICE)

        def near(what, got, ref, off=None):
            """``got`` within tol of ``ref`` column by column, the columns
            of the mask ``off`` bit for bit."""
            g, r = got.double(), ref.double()
            if g.dim() == 1:
                g, r = g[None], r[None]
            both = torch.isnan(g) & torch.isnan(r)
            diff = (g - r).abs().masked_fill(both, 0).nan_to_num(
                nan=float("inf"))
            err = float((diff.amax(0) / r.abs().nan_to_num().amax(0).clamp(
                min=1e-300)).max())
            errs.append(err)
            if not err <= tol:
                raise AssertionError("%s %s: %s off its plain version by "
                                     "%.3e (bound %.0e)"
                                     % (tag, label, what, err, tol))
            if off is not None and not torch.equal(got[..., off],
                                                   ref[..., off]):
                raise AssertionError("%s %s: %s changed a column the mask "
                                     "leaves off" % (tag, label, what))

        def same(what, got, ref):
            if not torch.equal(got, ref):
                raise AssertionError("%s %s: %s %s, its plain version %s"
                                     % (tag, label, what, got.tolist(),
                                        ref.tolist()))

        def state():
            return {name: getattr(st, name).clone() for name in (
                "ry", "resid", "active", "iters", "definite", "flags")}

        def check_alpha(prev, A, B):
            pAp = (A.double() * B.double()).sum(0).to(dtype)
            bad = prev["active"] & (pAp <= 0)
            act = prev["active"] & ~bad
            same("coldot's act mask", st.act, act)
            same("coldot's curvature verdicts", st.definite,
                 prev["definite"] & ~bad)
            near("coldot's alpha", st.alpha, torch.where(
                act, prev["ry"] / torch.where(pAp == 0, 1, pAp), 0))

        def check_beta(prev, ry2, hist=None):
            want = _bcg_beta(prev, st.act, ry2, thresh)
            for name in ("resid", "beta", "ry"):
                near("the %s of the step" % name, getattr(st, name),
                     want[name])
            for name in ("iters", "active", "flags"):
                same("the %s of the step" % name, getattr(st, name),
                     want[name])
            if hist is not None:
                near("the history row", hist, torch.where(
                    prev["active"], want["resid"], float("nan")))

        X, R, P = randn(), randn(), randn()
        d = 1 + torch.rand(n, 1, dtype=dtype, device=DEVICE, generator=gen)
        AP = P * d
        AP[:, role("bad")] *= -1
        ry = (R.double() ** 2).sum(0).to(dtype)
        thresh = torch.where(role("stop"), 10 * ry.sqrt(), 1e-3 * ry.sqrt())
        st = BC.BlockCG(X, R, P, ry, ry.sqrt(), thresh, ~role("frozen"),
                        True)
        before = BC.BLOCK_CG_LAUNCHES

        # a. the iteration without M, then with M
        prev = state()
        P0, AP0 = P.clone(), AP.clone()
        st.coldot(P, AP)
        check_alpha(prev, P, AP)
        same("coldot's P", P, P0)
        same("coldot's AP", AP, AP0)
        R0 = R.clone()
        st.update_r(AP)
        near("update_r's R", R, torch.where(st.act, R0 - st.alpha * AP, R0),
             ~st.act)
        check_beta(prev, (R.double() ** 2).sum(0).to(dtype))
        X0 = X.clone()
        st.update_xp(R)
        near("update_xp's X", X, torch.where(st.act, X0 + st.alpha * P0, X0),
             ~st.act)
        near("update_xp's P", P, torch.where(st.act, R + st.beta * P0, P0),
             ~st.act)

        Y = randn()
        prev = state()
        st.coldot(P, AP)
        check_alpha(prev, P, AP)
        R0 = R.clone()
        st.update_r(AP, sums=False)
        near("update_r's R (M)", R, torch.where(st.act, R0 - st.alpha * AP,
                                                R0), ~st.act)
        for name, v in state().items():
            same("update_r's %s without sums" % name, v, prev[name])
        row = torch.zeros(k, dtype=dtype, device=DEVICE)
        st.coldot(R, Y, beta=True, hist_row=row)
        check_beta(prev, (R.double() * Y.double()).sum(0).to(dtype), row)
        X0, P0 = X.clone(), P.clone()
        st.update_xp(Y)
        near("update_xp's X (M)", X, torch.where(st.act, X0 + st.alpha * P0,
                                                 X0), ~st.act)
        near("update_xp's P (M)", P, torch.where(st.act, Y + st.beta * P0,
                                                 P0), ~st.act)
        torch.cuda.synchronize()
        launches = BC.BLOCK_CG_LAUNCHES - before
        if launches != 7:
            raise AssertionError("%s %s: %d launches for 7 passes"
                                 % (tag, label, launches))
        if any(v for kk, v in _counts().items() if kk != "block_cg"):
            raise AssertionError("%s %s: other kernels launched: %s"
                                 % (tag, label, _counts()))
        log("[%s] %s (V=%d, %d blocks): every pass within %.3e of its plain "
            "version (bound %.0e), frozen columns bit for bit, %d launches"
            % (tag, label, st.plan.v, st.plan.blocks, max(errs), tol,
               launches))
        del X0, P0, R0, AP0, Y

        # b. the passes timed, every column running and the blocks still
        def hold():
            st.check = False
            thresh.zero_()
            st.act.fill_(True)
            st.active.fill_(True)
            st.alpha.zero_()
            st.beta.zero_()

        a = torch.zeros(k, dtype=dtype, device=DEVICE)

        def torch_iteration():
            col_vdots_real(P, AP)
            torch.addcmul(X, a, P)
            R2 = torch.addcmul(R, a, AP, value=-1)
            col_vdots_real(R2, R2)
            torch.addcmul(R2, a, P)

        best = {}
        for _ in range(3):
            for name, fn in (("coldot", lambda: st.coldot(P, AP)),
                             ("update_r", lambda: st.update_r(AP)),
                             ("update_xp", lambda: st.update_xp(R)),
                             ("torch", torch_iteration)):
                hold()
                best[name] = min(best.get(name, float("inf")),
                                 device_ms(fn, BCG_ITERS))
        if not bool(st.active.all()):
            raise AssertionError("%s %s: a column stopped while timed"
                                 % (tag, label))
        block = n * k * X.element_size()
        elems = n * k
        flops = ({"f64": 10 * elems} if dtype == torch.float64
                 else {"f32": 6 * elems, "f64": 4 * elems})
        b = _bound(10 * block, flops, rates)
        ms = best["coldot"] + best["update_r"] + best["update_xp"]
        out["cases"][label] = {
            "ms": ms, "coldot_ms": best["coldot"],
            "update_r_ms": best["update_r"],
            "update_xp_ms": best["update_xp"],
            "library_ms": best["torch"], "v": st.plan.v,
            "blocks": st.plan.blocks, "max_rel_err": max(errs), **b}
        out["max_rel_err"] = max(out["max_rel_err"], max(errs))
        log("[%s] %s: coldot %.4f ms (bound %.4f), update_r %.4f (%.4f), "
            "update_xp %.4f (%.4f); an iteration %.4f ms, %.1f%% of its "
            "bound %.4f (10 passes of %.1f MB; achievable %.4f); the torch "
            "loop's block work %.4f ms (17 passes)"
            % (tag, label, best["coldot"], 0.2 * b["bound_ms"],
               best["update_r"], 0.3 * b["bound_ms"], best["update_xp"],
               0.5 * b["bound_ms"], ms, 100 * b["bound_ms"] / ms,
               b["bound_ms"], block / 1e6, b["achievable_ms"],
               best["torch"]))
        del X, R, P, AP, st, d
        torch.cuda.empty_cache()
    out["launches"] = _counts()["block_cg"]
    return out


# --------------------------------------------------------------------------
# 6. timing
# --------------------------------------------------------------------------

def device_ms(fn, iters):
    """ms per call of ``fn`` as the device runs ``iters`` calls back to
    back.  A kernel of some tens of microseconds takes less time on the
    card than its wrapper's host work, so calls timed as the host enqueues
    them would time the host.  Here a sleep kernel holds the stream while
    the host enqueues the calls; the timing counts if the device had not
    reached the first of them when the last was enqueued.  A call that
    launches many kernels (a plain version) can fill CUDA's launch
    queue, which then holds the host back until the device drains it: the
    device is busy throughout, and the calls are timed as enqueued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0     # at most, if ``fn`` waits
    torch.cuda.synchronize()
    cycles = int(2 * iters * enqueue * SLEEP_HZ) + 1000000
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / iters
        torch.cuda.synchronize()
        cycles *= 4
    return events_ms(fn, iters)


def _best_ms(variants, iters, host_waits=()):
    """Best of 3 device times (:func:`device_ms`) of ``iters`` calls for
    each variant, the runs in turns (forward, backward, forward), after a
    warm-up.  The variants named in ``host_waits`` wait for the device
    inside a call (a plain version that reads sizes back), so no sleep can
    put the host ahead: they are timed as enqueued (:func:`events_ms`),
    their host work included."""
    for _, fn in variants:
        events_ms(fn, 3)
    best = {}
    for rep in range(3):
        for label, fn in (variants if rep % 2 == 0 else variants[::-1]):
            timer = events_ms if label in host_waits else device_ms
            best[label] = min(best.get(label, float("inf")),
                              timer(fn, iters))
    return best


def _torch_csr(coo, device):
    """torch's CSR tensor of the triples (f32 values, int32 indices), built
    on the card: its matvec is a cuSPARSE call, timed as a yardstick and
    used nowhere in the port."""
    vals, rows, cols, shape = coo
    idx = torch.stack([torch.from_numpy(rows).to(device, torch.int64),
                       torch.from_numpy(cols).to(device, torch.int64)])
    a = torch.sparse_coo_tensor(
        idx, torch.from_numpy(vals).to(device, torch.float32),
        shape).coalesce().to_sparse_csr()
    return torch.sparse_csr_tensor(a.crow_indices().int(),
                                   a.col_indices().int(), a.values(),
                                   size=shape)


def _csr_bytes(nnz, m, n):
    """f32 values and int32 column indices, int32 row pointers, x read
    once, y written once."""
    return nnz * 8 + (m + 1) * 4 + n * 4 + m * 4


def _bound(nbytes, flops, rates, ops="f32"):
    """The least time for work that must move ``nbytes`` and do ``flops``
    operations of type ``ops`` ("f32" or "f64"; or ``flops`` a dict of
    {type: operations}, the tensor cores' "bf16", "tf32" and "int8" among
    them): the larger of the bytes at the card's published memory rate and
    the operations at its rate for each type; beside it, as
    ``achievable_ms``, the bytes at the copy rate measured in phase 2."""
    work = flops if isinstance(flops, dict) else {ops: flops}
    t_bytes = nbytes / rates["bytes"] * 1e3
    t_ops = sum(f / rates[k] for k, f in work.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achievable_ms": nbytes / rates["copy"] * 1e3}


def phase_dia_timing(A, coo, rates):
    from pykrylov_tpu_torch.sparse import kernels as K

    offsets = A.container.offsets
    m = A.shape[0]
    ndiag = len(offsets)
    # scaled by 1/12 (spectral radius just under 1, as in bench.py) so a
    # chain of matvecs neither overflows nor underflows
    d32 = A.container.data / 12.0
    d16 = d32.to(torch.bfloat16)
    csr = _torch_csr((coo[0] / 12.0,) + coo[1:], DEVICE)
    state = {}

    def chain(label, fn):
        def step():
            state[label] = fn(state[label])
        return label, step

    variants = [chain("kernel f32", lambda x: K.dia_matvec(d32, offsets, x)),
                chain("plain f32",
                      lambda x: K.dia_matvec_plain(d32, offsets, x)),
                chain("kernel bf16", lambda x: K.dia_matvec(d16, offsets, x)),
                chain("plain bf16",
                      lambda x: K.dia_matvec_plain(d16, offsets, x)),
                # the mixed pair: f32 storage with an f64 x (f32f64 entry)
                chain("kernel f32/f64",
                      lambda x: K.dia_matvec(d32, offsets, x)),
                chain("plain f32/f64",
                      lambda x: K.dia_matvec_plain(d32, offsets, x)),
                chain("torch CSR f32", lambda x: csr @ x)]
    g = torch.Generator(device=DEVICE).manual_seed(1000)
    x0 = torch.randn(m, device=DEVICE, generator=g)
    # torch's CSR product with bf16 values and x, where torch takes it
    csr16 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                    csr.values().to(torch.bfloat16),
                                    size=csr.shape)
    try:
        csr16 @ x0.to(torch.bfloat16)
        bf16_error = None
        variants.append(chain("torch CSR bf16", lambda x: csr16 @ x))
    except RuntimeError as exc:
        bf16_error = str(exc).strip().splitlines()[0]
    log("[6 timing] DIA n=%d torch CSR with bf16 values and x: %s"
        % (N, "timed below" if bf16_error is None
           else "refused (%s)" % bf16_error))
    for label, _ in variants:
        state[label] = (x0.double() if "/f64" in label
                        else x0.to(torch.bfloat16) if label.endswith("bf16")
                        and "CSR" in label else x0.clone())
    best = _best_ms(variants, 100)
    for label, x in state.items():
        if not torch.isfinite(x).all():
            raise AssertionError("%s: timing chain went non-finite" % label)
    nnz = len(coo[0])
    own = {"f32": (ndiag * 4 + 2 * 4) * m, "bf16": (ndiag * 2 + 2 * 4) * m,
           "f32/f64": (ndiag * 4 + 2 * 8) * m}
    csr_b = _csr_bytes(nnz, m, m)
    for label, _ in variants:
        nbytes = csr_b if "CSR" in label else own[label.split()[-1]]
        log("[6 timing] DIA n=%d %-13s %.4f ms per matvec, %.1f GB/s of "
            "its own %d bytes" % (N, label, best[label],
                                  nbytes / (best[label] * 1e-3) / 1e9,
                                  nbytes))
    b = _bound(min(own["f32"], csr_b), 2 * nnz, rates)
    log("[6 timing] DIA n=%d bound %.4f ms (%s): %d own bytes, %d CSR "
        "bytes; kernel at %.1f%% of it; achievable %.4f ms at the copy rate"
        % (N, b["bound_ms"], b["bound_by"], own["f32"], csr_b,
           100 * b["bound_ms"] / best["kernel f32"], b["achievable_ms"]))
    # the mixed pair's bound: f32 data (or f32 CSR values) with f64 x and
    # y, 2 nnz operations at the f64 rate
    bm = _bound(min(own["f32/f64"], csr_b + 4 * 2 * m), 2 * nnz, rates,
                "f64")
    log("[6 timing] DIA n=%d f32 storage with f64 x: kernel %.4f ms, plain "
        "%.4f; bound %.4f ms (%s), kernel at %.1f%% of it; achievable "
        "%.4f ms" % (N, best["kernel f32/f64"], best["plain f32/f64"],
                     bm["bound_ms"], bm["bound_by"],
                     100 * bm["bound_ms"] / best["kernel f32/f64"],
                     bm["achievable_ms"]))
    b["mixed"] = bm
    # bf16 storage: its own bytes (2 a stored value), f32 x and y
    b["bf16"] = _bound(min(own["bf16"], csr_b), 2 * nnz, rates)
    log("[6 timing] DIA n=%d bf16 storage: kernel %.4f ms; bound %.4f ms "
        "(%s), kernel at %.1f%% of it" % (
            N, best["kernel bf16"], b["bf16"]["bound_ms"],
            b["bf16"]["bound_by"],
            100 * b["bf16"]["bound_ms"] / best["kernel bf16"]))
    b["bf16_library_error"] = bf16_error
    del csr, csr16, d32, d16, state
    return best, b


def phase_bell_timing(A, coo, classes, rates):
    from pykrylov_tpu_torch.sparse import bell as B
    from pykrylov_tpu_torch.sparse import operator_from_coo
    from pykrylov_tpu_torch.sparse import sell as S

    out = {}
    cases = [("tiled_1138bus", A, coo)] + [(n, a, t) for n, (a, t)
                                           in classes.items()]
    for name, op, t in cases:
        m, n = t[3]
        nnz = len(t[0])
        levels, rows_out = op.levels, op.level_rows
        cards, _ = _card_forms(levels, rows_out)
        csr = _torch_csr(t, DEVICE)
        ell = operator_from_coo(*t, fmt="ell", device=DEVICE)
        g = torch.Generator(device=DEVICE).manual_seed(2000)
        x = torch.randn(n, device=DEVICE, generator=g)
        # one matvec over the card form at each sorting window, its plain
        # version, the BELL container's own product, and the operator's
        # whole product, which adds the row split's fold or the
        # permutation's gathers
        variants = [("kernel sigma %d" % sg,
                     (lambda c: lambda: S.sell_matvec(c, x))(c))
                    for sg, c in sorted(cards.items())]
        if name == "tiled_1138bus":
            # the mixed pair: f32 values with an f64 x (f32f64 entry)
            x64 = x.double()
            variants += [
                ("kernel f32/f64", lambda: S.sell_matvec(cards[S.SIGMA],
                                                         x64)),
                ("plain f32/f64",
                 lambda: S.sell_matvec_plain(cards[S.SIGMA], x64))]
        variants += [
            ("plain", lambda: S.sell_matvec_plain(cards[S.SIGMA], x)),
            ("BELL plain", lambda: B.bell_levels_matvec(levels, x, rows_out)),
            ("operator", lambda: op * x),
            ("plain ELL", lambda: ell * x),
            ("torch CSR", lambda: csr @ x)]
        best = _best_ms(variants, 50, host_waits=("plain", "plain f32/f64"))
        best["kernel"] = best["kernel sigma %d" % S.SIGMA]
        # a call's time with its host work: back-to-back calls timed with
        # events, which the host's enqueue rate bounds for a kernel this short
        wall = {label: min(events_ms(fn, 200) for _ in range(3))
                for label, fn in variants
                if label in ("kernel sigma %d" % S.SIGMA, "torch CSR")}
        log("[6 timing] BELL %-18s per call with its host work (events): "
            "kernel %.4f ms, torch CSR %.4f ms"
            % (name, wall["kernel sigma %d" % S.SIGMA], wall["torch CSR"]))
        best["kernel_call"] = wall["kernel sigma %d" % S.SIGMA]
        io = 4 * (n + rows_out)          # x read once and y written once
        own = {sg: S.sell_bytes(c) + io for sg, c in cards.items()}
        bell_b = sum(B.bell_stream_bytes(b) + B.bell_map_bytes(b)
                     for b in levels) + io
        csr_b = _csr_bytes(nnz, m, n)
        b = _bound(min(own[S.SIGMA], csr_b), 2 * nnz, rates)
        for label, _ in variants:
            ms = best[label]
            if label.endswith("f32/f64"):
                continue
            mine = (own[int(label.split()[-1])] if label.startswith("kernel")
                    else bell_b if label == "BELL plain" else own[S.SIGMA])
            log("[6 timing] BELL %-18s %-16s %.4f ms per matvec: %.1f GB/s "
                "of its own %d bytes, %.1f GB/s of %d CSR bytes"
                % (name, label, ms, mine / (ms * 1e-3) / 1e9, mine,
                   csr_b / (ms * 1e-3) / 1e9, csr_b))
        log("[6 timing] BELL %-18s bound %.4f ms (%s; card form %d bytes "
            "with x and y, CSR %d, BELL container %d); kernel at %.1f%% of "
            "it, %.2fx torch CSR's time; achievable %.4f ms"
            % (name, b["bound_ms"], b["bound_by"], own[S.SIGMA], csr_b,
               bell_b, 100 * b["bound_ms"] / best["kernel"],
               best["kernel"] / best["torch CSR"], b["achievable_ms"]))
        if name == "tiled_1138bus":
            # f32 values and f64 x and y; CSR with f64 x and y likewise
            bm = _bound(min(own[S.SIGMA] + io, csr_b + 4 * (n + rows_out)),
                        2 * nnz, rates, "f64")
            log("[6 timing] BELL %-18s f32 values with f64 x: kernel %.4f "
                "ms, plain %.4f; bound %.4f ms (%s), kernel at %.1f%% of "
                "it; achievable %.4f ms"
                % (name, best["kernel f32/f64"], best["plain f32/f64"],
                   bm["bound_ms"], bm["bound_by"],
                   100 * bm["bound_ms"] / best["kernel f32/f64"],
                   bm["achievable_ms"]))
            b["mixed"] = bm
        out[name] = (best, b)
        del csr, ell, cards
    return out


def phase_spmm_timing(name, mm, plain_mm, coo, own_matrix, spmv_ms, rates,
                      iters, extra=(), host_waits=(), plan=None):
    """6b: the K-curve of one SpMM kernel: per block and per column at each
    K of CURVE_K, beside K times its SpMV kernel's time, its plain version,
    the bound, torch's CSR SpMM (cuSPARSE, a yardstick only) and the
    ``extra`` (label, block product) variants; ``plan(X)``, where given,
    records the host plan the kernel took for the timed block."""
    vals, _, _, (m, n) = coo
    nnz = len(vals)
    csr = _torch_csr(coo, DEVICE)
    csr_matrix = nnz * 8 + (m + 1) * 4
    g = torch.Generator(device=DEVICE).manual_seed(3000)
    curve = {}
    for kb in CURVE_K:
        X = torch.randn((n, kb), device=DEVICE, generator=g)
        variants = [("kernel", lambda: mm(X)),
                    ("plain", lambda: plain_mm(X)),
                    ("torch CSR SpMM", lambda: torch.sparse.mm(csr, X))]
        variants += [(label, (lambda f: lambda: f(X))(f))
                     for label, f in extra]
        if kb == KB:
            # the f32f64 entry: f32 storage with an f64 block, which the
            # mixed solves run (no library call takes that pair)
            X64 = X.double()
            variants += [("kernel f32/f64", lambda: mm(X64)),
                         ("plain f32/f64", lambda: plain_mm(X64))]
        best = _best_ms(variants, iters, tuple(host_waits) + tuple(
            label + " f32/f64" for label in host_waits))
        # the matrix once (the smaller of its own and its CSR bytes) plus
        # K columns of X read and of Y written, f32
        b = _bound(min(own_matrix, csr_matrix) + kb * (n + m) * 4,
                   2 * nnz * kb, rates)
        point = {"ms": best["kernel"], "ms_per_column": best["kernel"] / kb,
                 "spmv_x_k_ms": spmv_ms * kb, "plain_ms": best["plain"],
                 **b, "library_ms": best["torch CSR SpMM"]}
        point.update((label + "_ms", best[label]) for label, _ in extra)
        if kb == KB:
            bm = _bound(min(own_matrix, csr_matrix) + kb * (n + m) * 8,
                        2 * nnz * kb, rates, "f64")
            point.update(mixed_ms=best["kernel f32/f64"],
                         mixed_plain_ms=best["plain f32/f64"],
                         mixed_bound_ms=bm["bound_ms"],
                         mixed_bound_by=bm["bound_by"])
            log("[6b K-curve] %s K=%2d, f32 storage with an f64 block: "
                "kernel %.4f ms, plain %.4f; bound %.4f ms (%s), kernel at "
                "%.1f%% of it" % (name, kb, best["kernel f32/f64"],
                                  best["plain f32/f64"], bm["bound_ms"],
                                  bm["bound_by"],
                                  100 * bm["bound_ms"]
                                  / best["kernel f32/f64"]))
            del X64
        if plan is not None:
            point["plan"] = plan(X)
        curve[kb] = point
        log("[6b K-curve] %s K=%2d: kernel %.4f ms per block, %.5f per "
            "column; K x SpMV %.4f; plain %.4f; torch CSR SpMM %.4f; bound "
            "%.4f ms (%s), kernel at %.1f%% of it, achievable %.4f%s"
            % (name, kb, point["ms"], point["ms_per_column"],
               point["spmv_x_k_ms"], point["plain_ms"], point["library_ms"],
               b["bound_ms"], b["bound_by"], 100 * b["bound_ms"] / point["ms"],
               b["achievable_ms"],
               "".join("; %s %.4f" % (label, best[label])
                       for label, _ in extra)))
        del X, variants
    del csr
    return curve


def main_nccl(pt):
    """``python3 chip_smoke.py --nccl``: phases 1, 2 and 4, then NCCL
    worlds on this machine's cards.  With two cards or more, a world of
    one rank a card runs 21a's and 21d's legs (:func:`_rank_paths`, held
    to phase 21's checks beside unsharded references built here,
    :func:`_nccl_references`) and the dry run's twelve legs (21c), after
    21e's probe (:func:`phase_nccl_probe`); on one card, a world of two NCCL
    ranks on it must be refused (NCCL takes one rank a card), and the
    refusal is logged."""
    import tempfile
    from pykrylov_tpu_torch.parallel.launch import RankFailure, spawn_ranks
    tag = "21 NCCL"
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    A_dia, _, dia = phase_dia_path(pt)
    cards = torch.cuda.device_count()
    if cards >= 2:
        probe = phase_nccl_probe(tag, cards)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
        try:
            coo_bell, bell, se, mtx_path, ms = _nccl_references(pt, tmp)
            dia_ms = 1e3 * dia["solve_s"] / dia["n_iter"]
            earlier = {leg: (None, v) for leg, v in (
                ("halo", dia_ms), ("lbfgs", dia_ms), ("ckpt", dia_ms),
                ("gather", ms["gather"]), ("lsqr", ms["lsqr"]),
                ("show", ms["lsqr"]))}
            worlds, ckpt_path, legs_s = _spawn_legs(
                tag, "nccl", cards, "nccl", se, mtx_path, bell, tmp)
            out = _check_legs(pt, tag, worlds, A_dia, dia, coo_bell, bell,
                              se, ckpt_path, earlier)
            out["legs_s"] = legs_s
            del worlds
            out["21c"], out["21c_s"] = _dryrun_legs(tag, cards, "nccl",
                                                    "nccl")
            out["21e"] = probe
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log("[%s] %s" % (tag, json.dumps(out)))
    else:
        try:
            spawn_ranks(_rank_nccl, 2, backend="nccl", timeout=60.0,
                        deadline=RANK_DEADLINE)
        except RankFailure as exc:
            why = str(exc)
            if "Duplicate GPU" not in why:
                raise
            log("[%s] two NCCL ranks on the one card: refused (%s)"
                % (tag, why.strip().splitlines()[-1]))
        else:
            raise AssertionError("%s: two NCCL ranks shared one card" % tag)
    log("[%s] %s, %d card(s), %.1f s" % (tag, card, cards,
                                        time.perf_counter() - t0))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import pykrylov_tpu_torch as pt
    except ImportError as exc:
        print("chip_smoke: pykrylov_tpu_torch not found beside this "
              "script (%s)" % exc, file=sys.stderr)
        return 2
    if os.path.dirname(os.path.abspath(pt.__file__)) != os.path.join(
            HERE, "pykrylov_tpu_torch"):
        print("chip_smoke: imported %s, not this checkout's package"
              % pt.__file__, file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--nccl"]:
        return main_nccl(pt)

    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log("[time] phase %s: %.1f s (%.1f s since the start)"
            % (label, time.perf_counter() - t0,
               time.perf_counter() - t_start))
        return out

    card = timed("1", phase_device)
    regs = timed("2", phase_build)
    rates = timed("2 rates", phase_rates)
    dia_cases = timed("3 DIA", phase_dia_kernel, pt)
    classes, bell_cases = timed("3 BELL", phase_bell_kernel, pt)
    timed("3b", phase_spmm_kernels, dia_cases, bell_cases, classes)
    timed("3c", phase_mixed_pairs, dia_cases, bell_cases)
    del dia_cases, bell_cases
    A_dia, coo_dia, dia = timed("4", phase_dia_path, pt)
    dia_mm = timed("4b", phase_dia_block, pt, A_dia, dia)
    A_bell, coo_bell, bell = timed("5", phase_bell_path, pt)
    bell_mm = timed("5b", phase_bell_block, pt, A_bell, coo_bell, bell)
    new_s = {}
    keep = {}      # operators and b of phases 8-10 for 10b-15

    def kept(name, phase):
        def run():
            out, keep[name] = phase()
            return out
        return run

    for key, run in (("8", kept("helm", lambda: phase_indefinite(pt,
                                                                 coo_dia))),
                     ("8b", kept("bus", lambda: phase_minres_golden(
                         pt, A_bell, coo_bell))),
                     ("9", kept("cd", lambda: phase_nonsym(pt))),
                     ("9b", lambda: phase_bmark(pt)),
                     ("10", kept("se", lambda: phase_lls_sell(pt, rates))),
                     ("10b", lambda: phase_lls_dia(pt, *keep["cd"][:2],
                                                   rates)),
                     ("11", lambda: phase_block_nonsym(
                         pt, *keep["cd"], new_s["9"][0])),
                     ("12", lambda: phase_block_indefinite(
                         pt, *keep["helm"], new_s["8"][0])),
                     ("13", lambda: phase_block_lls(
                         pt, keep["se"], keep["cd"], new_s["10"][0],
                         new_s["10b"][0], rates)),
                     ("14", lambda: phase_verified_single(
                         pt, dia, A_dia, A_bell, keep["bus"], keep["cd"],
                         keep["se"], {k: new_s[k][0]
                                      for k in ("8b", "9", "10")})),
                     ("15", lambda: phase_verified_blocks(
                         pt, dia, A_dia, A_bell, keep["bus"], keep["cd"],
                         {"11": new_s["11"][0]}, rates, coo_bell,
                         keep["cd"][1],
                         new_s["14"][0]["f32_floor"] is not None)),
                     ("16a", lambda: phase_pipelined(
                         pt, A_dia, dia, A_bell, keep["bus"], bell)),
                     ("16b", lambda: phase_pipelined_block(
                         pt, A_dia, dia, new_s["16a"][0])),
                     ("16c", lambda: phase_diff(pt, A_dia, dia, keep["cd"],
                                                keep["se"])),
                     ("17a", lambda: phase_chebyshev(pt, A_dia, dia)),
                     ("17b", lambda: phase_complex(pt)),
                     ("17c", lambda: phase_operators(pt, A_dia, dia, A_bell,
                                                     bell)),
                     ("18a", lambda: phase_checkpoint(pt, A_dia, dia)),
                     ("18b", lambda: phase_trace(pt, A_bell, bell)),
                     ("19a", lambda: phase_halo(pt, A_dia, dia)),
                     ("19b", lambda: phase_gather_bell(
                         pt, A_bell, coo_bell, bell, keep["se"])),
                     ("19c", lambda: phase_stencils(pt, A_dia, dia)),
                     ("20a", lambda: phase_native(
                         pt, A_bell, coo_bell, bell, keep["se"],
                         new_s["10"][0]["build_s"])),
                     ("20b", lambda: phase_examples(pt)),
                     ("21", lambda: phase_ranks(
                         pt, A_dia, dia, coo_bell, bell, keep["se"],
                         new_s["20a"][0]["mtx_path"], _earlier(new_s, dia,
                                                               bell))),
                     ("22", lambda: phase_wide(pt, rates)),
                     ("23", lambda: phase_probes(pt, A_dia, A_bell, coo_bell,
                                                 rates)),
                     ("24", lambda: phase_block_cg(pt, rates))):
        t0 = time.perf_counter()
        new_s[key] = (run(), time.perf_counter() - t0)
        log("[time] phase %s: %.1f s (%.1f s since the start)"
            % (key, new_s[key][1], time.perf_counter() - t_start))
        if key == "21":
            shutil.rmtree(os.path.dirname(new_s["20a"][0]["mtx_path"]))
            keep.clear()
    dia_best, dia_b = timed("6 DIA", phase_dia_timing, A_dia, coo_dia,
                            rates)

    from pykrylov_tpu_torch.sparse import kernels as K
    from pykrylov_tpu_torch.sparse import sell as S
    data, offsets = A_dia.container.data, A_dia.container.offsets
    # the SpMV plans of the timed entries at n = N
    x0 = torch.zeros(data.shape[1], device=DEVICE)
    dia_plans = {name: K.dia_matvec_plan(data.to(storage), offsets,
                                         x0.to(xdt))._asdict()
                 for name, storage, xdt in (
                     ("f32", torch.float32, torch.float32),
                     ("bf16", torch.bfloat16, torch.float32),
                     ("f32/f64", torch.float32, torch.float64))}
    del x0
    dia_curve = timed(
        "6b DIA", phase_spmm_timing, "DIA n=%d" % N,
        lambda X: K.dia_matmat(data, offsets, X),
        lambda X: K.dia_matmat_plain(data, offsets, X), coo_dia,
        data.shape[0] * data.shape[1] * 4, dia_best["kernel f32"], rates, 10,
        (), (), lambda X: K.dia_matmat_plan(data, offsets, X)._asdict())
    del A_dia, coo_dia, data
    bell_times = timed("6 BELL", phase_bell_timing, A_bell, coo_bell,
                       classes, rates)
    bt, bell_b = bell_times["tiled_1138bus"]
    sell = A_bell.card
    extra = [("kernel sigma %d" % sg, (lambda c: lambda X: S.sell_matmat(
        c, X))(S.sell_from_levels(A_bell.levels, A_bell.level_rows,
                                  sigma=sg)))
             for sg in SIGMAS if sg != S.SIGMA]
    bell_curve = timed(
        "6b BELL", phase_spmm_timing, "BELL tiled_1138bus",
        lambda X: S.sell_matmat(sell, X),
        lambda X: S.sell_matmat_plain(sell, X), coo_bell,
        S.sell_bytes(sell), bt["kernel"], rates, 20, extra, ("plain",))
    if any(m.split(".")[0] in ("jax", "jaxlib", "pykrylov_tpu")
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    kernels = [{
        "name": "dia_spmv",
        "route": "cuda",
        "source": "pykrylov_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "pykrylov_tpu/sparse/kernels.py:211",
        "launches": dia["launches"],
        "max_abs_err": dia["max_abs_err"],
        "ms": dia_best["kernel f32"],
        "plain_ms": dia_best["plain f32"],
        "bound_ms": dia_b["bound_ms"],
        "bound_by": dia_b["bound_by"],
        "achievable_ms": dia_b["achievable_ms"],
        "library_ms": dia_best["torch CSR f32"],
        "bf16_ms": dia_best["kernel bf16"],
        "bf16_plain_ms": dia_best["plain bf16"],
        "bf16_library_ms": dia_best.get("torch CSR bf16"),
        "bf16_library_error": dia_b["bf16_library_error"],
    }, {
        "name": "sell_spmv",
        "route": "cuda",
        "source": "pykrylov_tpu_torch/csrc/sell_spmv.cu",
        "replaces": "pykrylov_tpu/sparse/bell.py:1021",
        "launches": bell["launches"],
        "max_abs_err": bell["max_abs_err"],
        "ms": bt["kernel"],
        "plain_ms": bt["plain"],
        "bound_ms": bell_b["bound_ms"],
        "bound_by": bell_b["bound_by"],
        "achievable_ms": bell_b["achievable_ms"],
        "library_ms": bt["torch CSR"],
        "sigma": S.SIGMA,
        "classes_ms": {name: {"kernel": t[0]["kernel"],
                              "library": t[0]["torch CSR"],
                              "bound": t[1]["bound_ms"],
                              **{"sigma_%d" % sg: t[0]["kernel sigma %d" % sg]
                                 for sg in SIGMAS}}
                       for name, t in bell_times.items()},
        "card_form_s": bell["card_s"],
        "operator_build_s": bell["build_s"],
        "plain_ell_ms": bt["plain ELL"],
        "solve_ms_per_iter": bell["ms_per_iter"],
    }]
    for name, src, replaces, path, curve in (
            ("dia_spmm", "dia_spmm.cu", "pykrylov_tpu/sparse/kernels.py:355",
             dia_mm, dia_curve),
            ("sell_spmm", "sell_spmm.cu", "pykrylov_tpu/sparse/bell.py:1405",
             bell_mm, bell_curve)):
        at = curve[KB]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pykrylov_tpu_torch/csrc/" + src,
            "replaces": replaces,
            "launches": path["launches"],
            "max_abs_err": path["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "achievable_ms": at["achievable_ms"],
            "library_ms": at["library_ms"],
            "k": KB,
            "k_curve": {str(k): v for k, v in curve.items()},
            "solve_ms_per_block_iter": path["ms_per_iter"],
        })
    kernels[0].update(plan=dia_plans, registers=regs["dia_spmv"])
    kernels[2].update(plan=dia_curve[KB]["plan"], registers=regs["dia_spmm"])
    # past 64 diagonals (22): the B-spline Laplacian's SpMV, CG and K = KB
    # SpMM
    wide = new_s["22"][0]
    kernels[0]["wide"] = dict(wide["spmv"], n=BS_N, ndiag=125,
                              cg=wide["cg"], host_us=wide["host_us"])
    kernels[2]["wide"] = dict(wide["spmm"], n=BS_N, ndiag=125)
    # each kernel's launches in the runs of phases 8-10b, counted from 0
    runs = {"8": new_s["8"][0]["launches"],
            "8b": {k: v["launches"] for k, v in new_s["8b"][0].items()},
            **{key: {k: v["launches"] for k, v in new_s[key][0].items()
                     if isinstance(v, dict) and "launches" in v}
               for key in ("9", "9b", "10", "10b", "11", "12", "13", "14",
                           "15", "16a", "16b", "16c", "17a", "17b", "17c",
                           "18a", "18b", "19a", "19b", "19c", "20a",
                           "20b", "21", "22")}}
    for entry in kernels:
        entry["launches_by_phase"] = {
            phase: {run: counts[entry["name"]]
                    for run, counts in by_run.items()}
            for phase, by_run in runs.items()}
    kernels[0].update(
        mixed_ms=dia_best["kernel f32/f64"],
        mixed_plain_ms=dia_best["plain f32/f64"],
        mixed_bound_ms=dia_b["mixed"]["bound_ms"],
        mixed_bound_by=dia_b["mixed"]["bound_by"],
        bf16_bound_ms=dia_b["bf16"]["bound_ms"])
    kernels[1].update(
        mixed_ms=bt["kernel f32/f64"], mixed_plain_ms=bt["plain f32/f64"],
        mixed_bound_ms=bell_b["mixed"]["bound_ms"],
        mixed_bound_by=bell_b["mixed"]["bound_by"])
    ind, gold, nonsym, bmark, se, lls, blk11, blk12, blk13, ver14, ver15 = (
        new_s[k][0] for k in ("8", "8b", "9", "9b", "10", "10b", "11", "12",
                              "13", "14", "15"))
    # the verified solves of phases 14-15 through each kernel: launches an
    # iteration and the profiled window's split
    verified = {"%s %s" % (key, label): {
        k: v[k] for k in ("n_iter", "n_matvec", "ms_per_iter", "solve_s",
                          "unverified_s", "istop")}
        | {"launches": v["launches"][v["kernel"]], "kernel": v["kernel"],
           "profile": v["profile"]}
        for key, out in (("14", ver14), ("15", ver15))
        for label, v in out.items() if isinstance(v, dict) and "profile" in v}
    for entry in kernels:
        entry["verified_solves"] = {k: v for k, v in verified.items()
                                    if v["kernel"] == entry["name"]}
    kernels[2]["k16_f64_block"] = ver15.get("dia_spmm_k16")
    kernels[3]["k16_f64_block"] = ver15["sell_spmm_k16"]
    # both directions of the least-squares path: state estimation A and
    # A^T through the SELL kernel (10), convection-diffusion A and A^T
    # through the DIA kernel (10b); 2 launches an iteration, one each
    kernels[0]["lls_directions"] = lls["timing"]
    kernels[0]["convdiff_ms"] = {
        direction: {k: v[k] for k in ("ms", "mixed_ms", "bound_ms",
                                      "mixed_bound_ms", "library_ms")}
        for direction, v in lls["timing"].items()}
    kernels[1]["lls_directions"] = se["timing"]
    # the SpMM kernels on A^T at K = KB (13), and the block solves of
    # phases 11-13 through them
    kernels[2]["transpose"] = blk13["dia_transpose"]
    kernels[3]["transpose"] = blk13["sell_transpose"]
    blocks = {"%s %s" % (key, label): {
        k: v[k] for k in ("kernel", "n_iter", "ms_per_iter",
                          "ms_per_column_iter", "single_ms_per_iter",
                          "columns", "single")}
        | {"idle": v["profile"]["idle"]}
        for key, out in (("11", blk11), ("12", blk12), ("13", blk13))
        for label, v in out.items() if isinstance(v, dict) and "profile" in v}
    for entry in kernels[2:]:
        entry["block_solves"] = {k: v for k, v in blocks.items()
                                 if v["kernel"] == entry["name"]}
    log("[7 result] card: %s; DIA n=%d: %d iterations in %.3f s, K=%d "
        "block %d in %.3f s; BELL tiled 1138bus: %d iterations in %.3f s, "
        "K=%d block %d in %.3f s; smoke took %.1f s"
        % (card, N, dia["n_iter"], dia["solve_s"], KB, dia_mm["n_iter"],
           dia_mm["solve_s"], bell["n_iter"], bell["solve_s"], KB,
           bell_mm["n_iter"], bell_mm["solve_s"],
           time.perf_counter() - t_start))
    log("[7 result] phase 8 (%.1f s): CG %d + MINRES %d iterations in "
        "%.3f s, idle %.1f%%; SYMMLQ %d in %.3f s, idle %.1f%%; phase 8b "
        "(%.1f s): MINRES %d and %d iterations; phase 9 (%.1f s): %s, "
        "BiCGSTAB idle %.1f%%; phase 9b (%.1f s, fmt=auto gave %r): %s"
        % (new_s["8"][1], ind["cg_iter"], ind["minres_iter"],
           ind["solve_s"], 100 * ind["profile"]["idle"],
           ind["symmlq_iter"], ind["symmlq_s"],
           100 * ind["symmlq_profile"]["idle"], new_s["8b"][1],
           gold["1e-06"]["n_iter"], gold["1e-08"]["n_iter"], new_s["9"][1],
           ", ".join("%s %d it. in %.3f s" % (k, v["n_iter"], v["solve_s"])
                     for k, v in nonsym.items()
                     if isinstance(v, dict) and "n_iter" in v),
           100 * nonsym["profile"]["idle"], new_s["9b"][1],
           bmark["auto_fmt"],
           ", ".join("%s %d (ref %d)" % (k, v["n_matvec"], v["ref"])
                     for k, v in bmark.items() if isinstance(v, dict))))
    log("[7 result] phase 10 (%.1f s, %d x %d built in %.1f s): %s; phase "
        "10b (%.1f s): %s"
        % (new_s["10"][1], se["shape"][0], se["shape"][1], se["build_s"],
           ", ".join("%s %d it. in %.3f s, idle %.1f%%"
                     % (k, se[k]["n_iter"], se[k]["solve_s"],
                        100 * se[k]["profile"]["idle"])
                     for k in ("solve (LSMR)", "lsqr")),
           new_s["10b"][1],
           ", ".join("%s %d it. (ref %d) in %.3f s, idle %.1f%%"
                     % (k, v["n_iter"], v["ref"], v["solve_s"],
                        100 * v["profile"]["idle"])
                     for k, v in lls.items() if "ref" in v)))
    log("[7 result] phase 11 (%.1f s), 12 (%.1f s), 13 (%.1f s), K=%d: %s"
        % (new_s["11"][1], new_s["12"][1], new_s["13"][1], KB_CUT,
           "; ".join("%s: %d block it. (column 0 %d, single %d), %.4f ms per "
                     "block it., %.4f per column-it. (single %.4f), idle "
                     "%.1f%%" % (k, v["n_iter"], v["columns"][0], v["single"],
                                 v["ms_per_iter"], v["ms_per_column_iter"],
                                 v["single_ms_per_iter"], 100 * v["idle"])
                     for k, v in blocks.items())))
    log("[7 result] phase 14 (%.1f s), 15 (%.1f s), verified: %s"
        % (new_s["14"][1], new_s["15"][1],
           "; ".join("%s: %d it., %.3f s (unverified %.3f s), %.4f ms per "
                     "it., %.1f launches per it., idle %.1f%%"
                     % (k, v["n_iter"], v["solve_s"], v["unverified_s"],
                        v["ms_per_iter"], v["profile"]["launches_per_iter"],
                        100 * v["profile"]["idle"])
                     for k, v in verified.items())))
    p16 = {key: new_s[key] for key in ("16a", "16b", "16c", "17a", "17b",
                                        "17c")}
    log("[7 result] phases 16-17 (%s): %s; 16c: %s; 17b: fmt=%s"
        % (", ".join("%s %.1f s" % (k, v[1]) for k, v in p16.items()),
           "; ".join("%s %s: %d it., %.4f ms per it., idle %.1f%%"
                     % (key, label, v["n_iter"], v["ms_per_iter"],
                        100 * v["profile"]["idle"])
                     for key, (out, _) in p16.items()
                     for label, v in out.items()
                     if isinstance(v, dict) and "profile" in v),
           "; ".join("%s: forward %d launches in %.3f s, backward %d in "
                     "%.3f s" % (label, v["forward_launches"],
                                 v["forward_s"], v["adjoint_launches"],
                                 v["backward_s"])
                     for label, v in p16["16c"][0].items()),
           p16["17b"][0]["fmt"]))
    p18 = {key: new_s[key] for key in ("18a", "18b", "19a", "19b", "19c")}
    log("[7 result] phases 18-19 (%s): %s"
        % (", ".join("%s %.1f s" % (k, v[1]) for k, v in p18.items()),
           "; ".join("%s %s: %d it., %.4f ms per it., idle %.1f%%, %s"
                     % (key, label, v["n_iter"], v["ms_per_iter"],
                        100 * v["profile"]["idle"],
                        {k: c for k, c in v["launches"].items() if c})
                     for key, (out, _) in p18.items()
                     for label, v in out.items()
                     if isinstance(v, dict) and "profile" in v)))
    nat, ex = new_s["20a"][0], new_s["20b"][0]
    log("[7 result] phases 20a (%.1f s), 20b (%.1f s): planners native / "
        "NumPy: %s; MatrixMarket parse %.3f / %.3f s; DIA fill %.3f / %.3f "
        "s; bmark %s, with --precon %s; demo_chebyshev %s in %.2f s, "
        "demo_general %s in %.2f s; other builds: 5 %.2f s, 10 %.2f s, 19b "
        "%.2f and %.2f s"
        % (new_s["20a"][1], new_s["20b"][1],
           ", ".join("%s %s (window %d) %.3f / %.3f s, NumPy pack %.2f s"
                     % (k, key, d["window"], d["plan_native_s"],
                        d["plan_numpy_s"], d["numpy_pack_s"])
                     for k, v in nat.items() if "operator_build_s" in v
                     for key, d in v.items()
                     if isinstance(d, dict) and "window" in d),
           nat["matrix_market"]["parse_native_s"],
           nat["matrix_market"]["parse_numpy_s"],
           nat["dia_fill"]["fill_native_s"], nat["dia_fill"]["fill_numpy_s"],
           ex["bmark"]["n_matvec"], ex["bmark --precon"]["n_matvec"],
           ex["demo_chebyshev"]["fmt"], ex["demo_chebyshev"]["seconds"],
           ex["demo_general"]["fmt"], ex["demo_general"]["seconds"],
           bell["build_s"], se["build_s"], new_s["19b"][0]["build_s"],
           new_s["19b"][0]["se_build_s"]))
    p21 = new_s["21"][0]
    log("[7 result] phase 21 (%.1f s; 21a and 21d %.1f s, 21c %.1f s), %d "
        "ranks: %s"
        % (new_s["21"][1], p21["21a_s"], p21["21c_s"], RANKS,
           "; ".join("%s: %d it., %.4f ms per it. (slots %s, unsharded "
                     "%.4f), %.2f all-reduces per it. (%.1f%% of the "
                     "wall), idle %s"
                     % (k, v["n_iter"], v["ms_per_iter"],
                        "-" if v["slot_mesh_ms"] is None
                        else "%.4f" % v["slot_mesh_ms"],
                        v["unsharded_ms"], v["all_reduces_per_iter"],
                        100 * v["comm_share"],
                        "-" if v["idle"] is None
                        else "%.1f%%" % (100 * v["idle"]))
                     for k, v in p21.items()
                     if k.startswith(("21a ", "21d ")) and k.endswith(
                         "rank 0"))))
    log("[7 result] phase 22 (%.1f s), B-spline Laplacian n=%d, 125 "
        "diagonals: CG %d it., %.4f ms per it., true residual %.3e; SpMV "
        "%.4f ms (bound %.4f, torch CSR %.4f); SpMM K=%d %.4f ms (bound "
        "%.4f, torch CSR %.4f); route n=%d fmt=%s"
        % (new_s["22"][1], BS_N, wide["cg"]["n_iter"],
           wide["cg"]["ms_per_iter"], wide["cg"]["true_rel"],
           wide["spmv"]["ms"], wide["spmv"]["bound_ms"],
           wide["spmv"]["library_ms"], KB, wide["spmm"]["ms"],
           wide["spmm"]["bound_ms"], wide["spmm"]["library_ms"], BS_ROUTE_N,
           wide["route"]["fmt"]))
    p23 = new_s["23"][0]
    for name, src, replaces, extra, key in (
            ("probe_stream", "probe_stream.cu",
             "tools/probes/probe_stream_floor.py:59",
             ["tools/probes/probe_stream_floor.py:111"], "stream"),
            ("probe_dia_ring", "probe_dia_ring.cu",
             "tools/probes/probe_dia_manual_dma.py:137", [], "dia"),
            ("probe_sell_ablation", "probe_sell_ablation.cu",
             "tools/probes/probe_bell_ablation.py:111",
             ["tools/probes/probe_bell_ablation_w1.py:129",
              "tools/probes/probe_ablate_r3.py:149",
              "tools/probes/probe_skew.py:169"], "sell"),
            ("probe_bell_mma", "probe_bell_mma.cu",
             "tools/probes/probe_ablate_r3b.py:172", [], "bell_mma"),
            ("probe_onehot_mma", "probe_onehot_mma.cu",
             "tools/probes/probe_int8_mxu.py:57", [], "onehot")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "pykrylov_tpu_torch/csrc/" + src,
                        "replaces": replaces, "also_replaces": extra,
                        "launches": p23["launches"][name],
                        "max_abs_err": 0.0, **p23[key],
                        "registers": regs.get(name)})
    log("[7 result] phase 23 (%.1f s): fold %.4f ms (%.1f GB/s read), DIA "
        "ring %.4f ms (dia_matvec %.4f), SELL full %.4f ms (sell_matvec "
        "%.4f), BELL mma %.4f ms (control %.4f, bound %.4f), select int8 "
        "%.4f ms, bf16x3 %.4f"
        % (new_s["23"][1], p23["stream"]["ms"], p23["stream"]["read_gbps"],
           p23["dia"]["ms"], p23["dia"]["dia_matvec_ms"], p23["sell"]["ms"],
           p23["sell"]["sell_matvec_ms"], p23["bell_mma"]["ms"],
           p23["bell_mma"]["control_ms"], p23["bell_mma"]["bound_ms"],
           p23["onehot"]["ms"], p23["onehot"]["bf16x3_ms"]))
    bcg = new_s["24"][0]
    at = bcg["cases"]["float32 K=%d" % KB]
    kernels.append({
        "name": "block_cg", "route": "cuda",
        "source": "pykrylov_tpu_torch/csrc/block_cg.cu", "replaces": None,
        "fuses": "cg_batched's vector passes, "
                 "pykrylov_tpu_torch/solvers/batched.py",
        "launches": {
            "4b": dia_mm["block_cg_launches"],
            "5b": bell_mm["block_cg_launches"],
            "17a": sum(v["launches"].get("block_cg", 0)
                       for v in new_s["17a"][0].values()
                       if isinstance(v, dict) and "launches" in v),
            "24": bcg["launches"]},
        "max_rel_err": bcg["max_rel_err"], "k": KB,
        **{key: at[key] for key in (
            "ms", "coldot_ms", "update_r_ms", "update_xp_ms", "bound_ms",
            "bound_by", "achievable_ms", "library_ms")},
        "cases": bcg["cases"], "registers": regs.get("block_cg")})
    log("[7 result] phase 24 (%.1f s), block CG's passes: %s"
        % (new_s["24"][1], "; ".join(
            "%s %.4f ms an iteration (bound %.4f, torch %.4f)"
            % (label, v["ms"], v["bound_ms"], v["library_ms"])
            for label, v in bcg["cases"].items())))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
