"""The port's observability helpers (``utils/observe.py``) against the JAX
package's: ``trace`` and ``profiled`` write a Chrome trace that holds the
``annotate`` spans, ``assert_replicated`` checks per-shard copies bit for
bit (or to ``atol``) and returns the host value as the JAX one does for a
replicated array on its 8 virtual CPU devices, and ``solve_stats`` gives
the JAX dict for the same solve."""

import glob
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import pykrylov_tpu.ops as jops
import pykrylov_tpu.parallel as jpar
import pykrylov_tpu.solvers as jsol
from pykrylov_tpu.utils import observe as jobs

import pykrylov_tpu_torch.parallel as par
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.utils import (annotate, assert_replicated, profiled,
                                      solve_stats, trace)

DEV = "cpu"  # the port's entry points default to the card


def spd(rng, n=40):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.linspace(1.0, 10.0, n)) @ q.T
    return 0.5 * (a + a.T), rng.standard_normal(n)


def events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_holds_the_spans(tmp_path, rng):
    a, b = spd(rng)
    A = MatrixOperator(a, symmetric=True, device=DEV)
    with trace(tmp_path / "tr") as prof:
        with annotate("outer_span"):
            with annotate("inner_span"):
                res = cg(A, torch.from_numpy(b), rtol=1e-8)
    assert bool(res.converged)
    files = glob.glob(str(tmp_path / "tr" / "*.json"))
    assert files == [prof.trace_file]
    names = {e.get("name") for e in events(prof.trace_file)}
    assert {"outer_span", "inner_span"} <= names
    keys = {e.key for e in prof.key_averages()}
    assert "outer_span" in keys


def test_two_traces_do_not_overwrite(tmp_path):
    for _ in range(2):
        with trace(tmp_path):
            torch.ones(3).sum()
    assert len(glob.glob(str(tmp_path / "*.json"))) == 2


def test_profiled_returns_the_result(tmp_path, rng):
    a, b = spd(rng)
    A = MatrixOperator(a, symmetric=True, device=DEV)
    run = profiled(cg, tmp_path)
    res = run(A, torch.from_numpy(b), rtol=1e-8)
    ref = cg(A, torch.from_numpy(b), rtol=1e-8)
    assert torch.equal(res.x, ref.x)
    assert len(glob.glob(str(tmp_path / "*.json"))) == 1


def test_annotate_outside_a_trace_is_a_noop():
    with annotate("alone"):
        x = torch.arange(3.0)
    assert float(x.sum()) == 3.0


def test_assert_replicated_matches_jax(rng):
    v = rng.standard_normal(16)
    mesh = jpar.make_mesh(8)
    rep = jax.device_put(jnp.asarray(v),
                         NamedSharding(mesh, PartitionSpec()))
    ref = jobs.assert_replicated(rep)
    np.testing.assert_array_equal(assert_replicated(torch.from_numpy(v)),
                                  ref)
    tm = par.make_mesh(8, device=DEV)
    shards = [torch.from_numpy(v).to(s) for s in tm.slots]
    np.testing.assert_array_equal(assert_replicated(shards), ref)


def test_assert_replicated_finds_divergence(rng):
    v = torch.from_numpy(rng.standard_normal(16))
    w = v.clone()
    w[3] += 1e-12
    with pytest.raises(AssertionError, match="diverges on shard 2"):
        assert_replicated([v, v, w])
    np.testing.assert_array_equal(assert_replicated([v, w], atol=1e-9),
                                  v.numpy())
    with pytest.raises(AssertionError, match="shapes differ"):
        assert_replicated([v, v[:4]])
    with pytest.raises(ValueError):
        assert_replicated([])


@pytest.mark.parametrize("wall", [None, 0.25])
def test_solve_stats_match_jax(wall, rng):
    a, b = spd(rng)
    rt = cg(MatrixOperator(a, symmetric=True, device=DEV),
            torch.from_numpy(b), rtol=1e-10)
    rj = jsol.cg(jops.MatrixOperator(jnp.asarray(a), symmetric=True),
                 jnp.asarray(b), rtol=1e-10)
    st, sj = solve_stats(rt, wall), jobs.solve_stats(rj, wall)
    assert set(st) == set(sj)
    for k in ("converged", "istop", "n_iter", "n_matvec"):
        assert st[k] == sj[k]
    for k in st:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-8, atol=1e-14)
