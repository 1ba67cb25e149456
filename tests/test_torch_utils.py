"""The port's numerics utilities against the JAX package's.

``machine_epsilon`` and ``roots_quadratic`` are host arithmetic in both
packages: equal results on the same inputs (roots to 1e-15 relative).  The
randomized probes draw different random numbers (a seeded
``torch.Generator`` against ``jax.random.PRNGKey(1)``), so they are held to
the same verdicts on symmetric, unsymmetric, positive definite and
indefinite operators, dense and sparse.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pykrylov_tpu.ops import MatrixOperator as JMatrix
from pykrylov_tpu.sparse import sparse_operator as jax_sparse_operator
from pykrylov_tpu.utils import check_positive_definite as jax_check_pd
from pykrylov_tpu.utils import check_symmetric as jax_check_symmetric
from pykrylov_tpu.utils import machine_epsilon as jax_machine_epsilon
from pykrylov_tpu.utils import roots_quadratic as jax_roots_quadratic

import pykrylov_tpu_torch as pt
from pykrylov_tpu_torch.gallery import poisson3d_coo
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.sparse import kernels as K
from pykrylov_tpu_torch.sparse import operator_from_coo, sparse_operator
from pykrylov_tpu_torch.utils import (check_positive_definite,
                                      check_symmetric, machine_epsilon,
                                      roots_quadratic)

DEV = "cpu"  # the port's entry points default to the card


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.float64, jnp.float64),
                                     (torch.bfloat16, jnp.bfloat16),
                                     ("float32", "float32")])
def test_machine_epsilon(tdt, jdt):
    assert machine_epsilon(tdt) == jax_machine_epsilon(jdt)


def test_machine_epsilon_default_is_torch_default():
    assert machine_epsilon() == float(torch.finfo(
        torch.get_default_dtype()).eps)


@pytest.mark.parametrize("q", [
    (1.0, -3.0, 2.0),          # two roots
    (1.0, 2.0, 1.0),           # a double root
    (0.0, 2.0, -4.0),          # q2 = 0: linear
    (0.0, 0.0, 0.0),           # the zero polynomial
    (0.0, 0.0, 3.0),           # constant, no root
    (1.0, 0.0, 1.0),           # complex roots: none real
    (1e-30, 1.0, 1.0),         # q2 negligible against q1
    (2.0, -1e8, 1.0),          # cancellation in the small root
    (-3.0, 0.5, 7.0),
    (4.0, 4.0, 1.0),           # a double root at -1/2
])
@pytest.mark.parametrize("nitref", [0, 1, 3])
def test_roots_quadratic_matches_jax(q, nitref):
    got = roots_quadratic(*q, nitref=nitref)
    ref = jax_roots_quadratic(*q, nitref=nitref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, [float(r) for r in ref], rtol=1e-15,
                               atol=0)
    for r in got:   # each a root, to the polynomial's scale
        val = (q[0] * r + q[1]) * r + q[2]
        assert abs(val) <= 1e-8 * max(1.0, *map(abs, q), abs(r) ** 2)


def _dense_cases():
    rng = np.random.default_rng(4)
    n = 30
    B = rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(B)
    spd = (Q * np.linspace(1.0, 9.0, n)) @ Q.T
    # mostly negative: a random probe finds x'Ax < 0
    indef = (Q * np.linspace(-9.0, 4.0, n)) @ Q.T
    return {"spd": 0.5 * (spd + spd.T), "indefinite": 0.5 * (indef + indef.T),
            # x'Ax = 0: semidefinite, not definite
            "zero": np.zeros((n, n)),
            "unsymmetric": B + n * np.eye(n), "rectangular": B[:, :20]}


CASES = _dense_cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_probe_verdicts_match_jax(name, dtype):
    A = CASES[name].astype(dtype)
    sym = name not in ("unsymmetric", "rectangular")
    op = MatrixOperator(torch.from_numpy(A), symmetric=sym, device=DEV)
    jop = JMatrix(jnp.asarray(A), symmetric=sym)
    verdicts = (check_symmetric(op), check_positive_definite(op),
                check_positive_definite(op, semi=True))
    assert verdicts == (jax_check_symmetric(jop), jax_check_pd(jop),
                        jax_check_pd(jop, semi=True))
    expected = {"spd": (True, True, True),
                "indefinite": (True, False, False),
                "zero": (True, False, True),
                "unsymmetric": (False, True, True),
                "rectangular": (False, False, False)}[name]
    assert verdicts == expected


def test_probes_count_matvecs_and_use_the_block_rule():
    """The probes go through the operator's native block rule: one SpMM on
    a ``cuda-dia`` operator for the whole (n, nprobe) block (on the CPU,
    the kernel's plain version), not 2 nprobe SpMVs; ``nMatvec`` counts 2
    per probe for the symmetry test and 1 for definiteness, as the
    reference does."""
    vals, rows, cols, shape = poisson3d_coo(6)
    op = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                           fmt="cuda-dia", device=DEV)
    calls = []
    real = K.dia_matmat_plain
    try:
        K.dia_matmat_plain = lambda *a: calls.append(a[2].shape) or real(*a)
        assert check_symmetric(op, nprobe=7)
        assert check_positive_definite(op, nprobe=5)
    finally:
        K.dia_matmat_plain = real
    assert calls == [(shape[0], 7), (shape[0], 7), (shape[0], 5)]
    assert op.nMatvec == 2 * 7 + 5


def test_sparse_verdicts_and_generator():
    sym = sparse_operator("1138bus", symmetric=True, device=DEV)
    gen = sparse_operator("jpwh_991", device=DEV)
    assert check_symmetric(sym) == jax_check_symmetric(
        jax_sparse_operator("1138bus", symmetric=True)) is True
    assert check_symmetric(gen) == jax_check_symmetric(
        jax_sparse_operator("jpwh_991")) is False
    assert check_positive_definite(sym)
    # an explicit generator gives reproducible probes
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    assert check_symmetric(sym, generator=g1) == check_symmetric(
        sym, generator=g2)
    assert pt.check_symmetric is check_symmetric
