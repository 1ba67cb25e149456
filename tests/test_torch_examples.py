"""The port's examples (``pykrylov_tpu_torch/examples``), each run
in-process on the CPU at a small size, held to what it prints: bmark's
matvec counts against the JAX package's protocol in float64, and every
demo's result lines reporting convergence."""

import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu import compat as jcompat
from pykrylov_tpu.sparse import jacobi_preconditioner as jax_jacobi
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's published bmark matvecs (BASELINE.md), unpreconditioned
# and with the diagonal preconditioner, and the bound phase 9b holds
PUBLISHED = {"CGS": (82, 70), "TFQMR": (84, 70), "Bi-CGSTAB": (84, 64)}
BMARK_BOUND = 4


@pytest.fixture(autouse=True)
def _one_thread():
    # thousands of small ops: one thread a worker avoids oversubscription
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(out, names):
    """{name: (matvec, resid0, resid, error)} of the reference's table."""
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if (len(parts) == 5 and parts[0] in names
                and parts[1].isdigit()):
            rows[parts[0]] = (int(parts[1]), *map(float, parts[2:]))
    assert sorted(rows) == sorted(names), out
    return rows


def _jax_bmark_counts():
    """The JAX package's bmark protocol (``examples/bmark.py``) through
    its ``compat`` classes, in float64, with the JAX package's operator in
    each of its storage formats: {(solver, precon): set of matvecs}."""
    n = 991
    counts = {}
    for fmt in ("auto", "ell", "csr", "coo"):
        op = jax_sparse_operator("jpwh_991", fmt=fmt)
        rhs = op * jnp.ones(n, dtype=jnp.float64)
        for precon in (False, True):
            dp = jax_jacobi("jpwh_991", floor=1.0) if precon else None
            for K in (jcompat.CGS, jcompat.TFQMR, jcompat.BiCGSTAB):
                ks = K(op, precon=dp, reltol=1.0e-8)
                ks.solve(rhs, guess=1.0 + jnp.arange(n, dtype=jnp.float64),
                         matvec_max=2 * n)
                counts.setdefault((ks.acronym, precon), {})[fmt] = \
                    int(ks.nMatvec)
    return counts


def check_bmark(outs):
    jax = _jax_bmark_counts()
    for precon, out in zip((False, True), outs):
        for name, (mv, r0, r, err) in _rows(out, PUBLISHED).items():
            by_fmt = jax[(name, precon)]
            # the JAX package's own count moves with its storage format's
            # summation order where the solve is that sensitive (TFQMR
            # unpreconditioned: 85 in its ELL, 87 in CSR and COO); the
            # port's equals one of them, and equals the auto format's
            # wherever the JAX formats agree
            assert mv in by_fmt.values(), (name, precon, mv, by_fmt)
            if len(set(by_fmt.values())) == 1:
                assert mv == by_fmt["auto"], (name, precon, mv, by_fmt)
            assert abs(mv - PUBLISHED[name][precon]) <= BMARK_BOUND
            assert r <= 1e-8 * r0 and err < 3e-5


def check_table(name, rtol):
    def check(outs):
        (mv, r0, r, err), = _rows(outs[0], [name]).values()
        assert r <= rtol * r0 and err < 1e-2, outs[0]
    return check


def converged_lines(pattern, count):
    """``count`` lines match ``pattern`` and each says converged=True."""
    def check(outs):
        lines = [l for l in outs[0].splitlines() if re.search(pattern, l)]
        assert len(lines) == count, outs[0]
        for line in lines:
            assert "converged=True" in line, line
    return check


def check_minres(outs):
    converged_lines(r"MINRES: +converged=", 1)(outs)
    (mv, r0, r, err), = _rows(outs[0], ["MINRES"]).values()
    assert err < 1e-2


def check_cg_log(outs):
    assert re.search(r"^CG +INFO", outs[0], re.M), outs[0]
    converged_lines(r"CG: +converged=", 1)(outs)
    check_table("CG", 1e-8)(outs)


def check_batched(outs):
    rows = [l.split() for l in outs[0].splitlines()
            if l.split()[:1] in (["CGS"], ["TFQMR"], ["Bi-CGSTAB"])]
    assert len(rows) == 3 and all(r[-1] == "True" for r in rows), outs[0]


def check_multichip(outs):
    rows = [l.split() for l in outs[0].splitlines()
            if re.match(r"^ +\d+ +\d+ +\d+ +\d+ +(True|False)", l)]
    assert [int(r[0]) for r in rows] == [1, 2, 4], outs[0]
    assert all(r[4] == "True" for r in rows), outs[0]


def check_partitioned(outs):
    converged_lines(r"^verified sharded CG", 1)(outs)
    rel = float(re.search(r"rel resid=(\S+)", outs[0]).group(1))
    assert rel <= 1e-6


def check_verified_block(outs):
    converged_lines(r"^  col \d", 5)(outs)
    for rel in re.findall(r"TRUE relres=(\S+)", outs[0]):
        assert float(rel) <= 1e-6 * (1 + 1e-2)


# name -> (argument lists, one run each, with --device cpu; the check of
# their printed outputs)
CASES = {
    "bmark": ([[], ["--precon"]], check_bmark),
    "demo_common": ([["--solver", "CG"]], check_table("CG", 1e-8)),
    "demo_cg": ([[]], check_cg_log),
    "demo_minres": ([[]], check_minres),
    "demo_batched": ([["3"]], check_batched),
    "demo_chebyshev": ([["10"]], converged_lines(r"converged=", 4)),
    "demo_complex": ([["32"]], converged_lines(r"converged=", 2)),
    "demo_general": ([["4096"]], converged_lines(
        r"^BiCGSTAB|verified\+compensated", 2)),
    "demo_general_sharded": ([["--shards", "4"]],
                             converged_lines(r"^CG:", 1)),
    "demo_multichip": ([["6", "--shards", "4", "--repeats", "1"]],
                       check_multichip),
    "demo_partitioned_io": ([["--shards", "4", "--n", "600"]],
                            check_partitioned),
    "demo_pde": ([["32"]], converged_lines(r"^CG converged=", 1)),
    "demo_refined": ([["--n", "120"]],
                     converged_lines(r"^\[(spd|indefinite|hard)\]", 3)),
    "demo_verified_block": ([["2"]], check_verified_block),
}


def test_every_example_script_has_its_port():
    scripts = sorted(f[:-3] for f in os.listdir(os.path.join(REPO,
                                                             "examples"))
                     if f.endswith(".py"))
    assert scripts == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module("pykrylov_tpu_torch.examples." + name)
    capsys.readouterr()
    runs, check = CASES[name]
    outs = []
    for argv in runs:
        mod.main(argv + ["--device", "cpu"])
        outs.append(capsys.readouterr().out)
    check(outs)
