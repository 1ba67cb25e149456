"""The port's dry run and flagship entry point (``pykrylov_tpu_torch/
dryrun.py``), the counterpart of ``__graft_entry__.py``.

``dryrun_multichip(8, device="cpu")`` on a mesh of 8 slots runs the twelve
legs at the JAX sizes; each leg's iteration count is held to the JAX
``dryrun_multichip(8)`` lines recorded in ``MULTICHIP_r05.json`` (read,
not changed), within 1 (the legs run f32).  Two legs differ by design and
are held to the JAX asserts only (converged, the error bounds, which the
dry run asserts itself): MINRES, whose port keeps its Givens scalars as
host f64 floats where the JAX package rounds them to f32, and pipelined
CG, whose f32 recurrences part from classic CG's in both packages (the
JAX package's own count moves from 26 sharded to 91 unsharded).
``dryrun_multichip(4)`` across four spawned gloo ranks runs every leg,
every rank printing the same lines, with the slot mesh's counts at 4 to
within 1.  ``entry()``'s ff-CG on 1138bus certifies rtol 1e-6 against an
f64 oracle of its f32 matrix.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from pykrylov_tpu_torch import dryrun
from pykrylov_tpu_torch.parallel.launch import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dryrun_multichip's lines, in order, and the leg each reports
LEGS = ["halo_cg", "block_cg", "mesh2d_cg", "tall_lsqr", "gather_lsqr",
        "bell_bicgstab_batched", "bell_transpose_lsqr", "stencil_cg",
        "chebyshev_cg", "indefinite_minres", "pipelined_cg", "verified_cg"]
BY_DESIGN = {"indefinite_minres", "pipelined_cg"}


def _jax_counts():
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
        rec = json.load(f)
    assert rec["n_devices"] == 8 and rec["ok"]
    lines = [ln for ln in rec["tail"].splitlines() if ln.strip()]
    assert len(lines) == len(LEGS)
    return {leg: int(re.search(r"(\d+) iters", ln).group(1))
            for leg, ln in zip(LEGS, lines)}


@pytest.fixture(scope="module")
def slots8():
    lines = []
    torch.set_num_threads(1)
    return dryrun.dryrun_multichip(8, device="cpu", log=lines.append), lines


@pytest.mark.parametrize("leg", LEGS)
def test_slot_mesh_legs_match_the_jax_dry_run(slots8, leg):
    out, lines = slots8
    assert len(lines) == len(LEGS) and set(out) == set(LEGS)
    n_iter, _ = out[leg]
    if leg not in BY_DESIGN:
        assert abs(n_iter - _jax_counts()[leg]) <= 1, (leg, n_iter)
    line = lines[LEGS.index(leg)]
    assert line.startswith("dryrun_multichip") and " OK" in line
    assert "%d iters" % n_iter in line


def test_dry_run_across_four_ranks():
    results = spawn_ranks(dryrun._rank_run, 4, 4, "cpu", None,
                          deadline=180.0)
    outs = [r[0] for r in results]
    lines = [r[1] for r in results]
    # lockstep: the same counts, errors and lines on every rank
    assert all(o == outs[0] for o in outs[1:])
    assert all(ln == lines[0] for ln in lines[1:])
    assert len(lines[0]) == len(LEGS) and "4 devices" in lines[0][0]
    torch.set_num_threads(1)
    ref = dryrun.dryrun_multichip(4, device="cpu", log=lambda s: None)
    for leg in LEGS:
        assert abs(outs[0][leg][0] - ref[leg][0]) <= 1, leg


def test_entry_certifies_1138bus():
    from pykrylov_tpu_torch.io.datasets import load_bundled
    fn, args = dryrun.entry(device="cpu")
    op, M, b = args
    assert b.dtype == torch.float32 and b.device.type == "cpu"
    x, resid, n_iter = fn(*args)
    vals, rows, cols, shape = load_bundled("1138bus")
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals.astype(np.float32).astype(np.float64))
    b64 = b.numpy().astype(np.float64)
    rel = np.linalg.norm(b64 - a @ x.numpy().astype(np.float64)) \
        / np.linalg.norm(b64)
    assert rel <= 1e-6, rel
    assert 0 < int(n_iter) < 20000
