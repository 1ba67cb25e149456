"""The port's ``show`` tables and the compat logger lines against the JAX
package's, as text.

Each solve runs in both packages in float64 on the same inputs and the
captured standard output must be equal, line for line: the tables print
five significant digits at most, which the two packages' solves (equal to
1e-10 relative, ``tests/test_torch_lls.py``) share.  The cases mirror
``tests/test_show.py``.
"""

import logging
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pykrylov_tpu.compat as jax_compat
from pykrylov_tpu.solvers import craig as jax_craig
from pykrylov_tpu.solvers import craigmr as jax_craigmr
from pykrylov_tpu.solvers import lsmr as jax_lsmr
from pykrylov_tpu.solvers import lsqr as jax_lsqr
from pykrylov_tpu.solvers import minres as jax_minres

import pykrylov_tpu_torch.compat as compat
from pykrylov_tpu_torch.ops import MatrixOperator
from pykrylov_tpu_torch.solvers import craig, craigmr, lsmr, lsqr, minres
from pykrylov_tpu_torch.solvers.craig import ISTOP_MSG as CRAIG_MSG
from pykrylov_tpu_torch.solvers.lsmr import ISTOP_MSG as LSMR_MSG
from pykrylov_tpu_torch.solvers.lsqr import ISTOP_MSG as LSQR_MSG
from pykrylov_tpu_torch.solvers.minres import ISTOP_MSG as MINRES_MSG

from test_torch_lls import rect

DEV = "cpu"  # the port's entry points default to the card


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the tensors here are small: torch's intra-op threads would only
    # contend with the other test workers' processes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    return a @ a.T + np.eye(n) * 3


def _texts(capsys, port, jax, a, b, sym=False, **opts):
    """(port result, port text, JAX text) of one solve with show=True."""
    capsys.readouterr()
    res = port(MatrixOperator(torch.from_numpy(a), symmetric=sym,
                              device=DEV), torch.from_numpy(b), show=True,
               **opts)
    mine = capsys.readouterr().out
    jax(a, jnp.asarray(b), show=True, **opts)
    return res, mine, capsys.readouterr().out


def test_minres_show_table(capsys):
    n = 24
    res, out, ref = _texts(capsys, minres, jax_minres, _spd(n, 1),
                           np.ones(n), sym=True, rtol=1e-10)
    assert out == ref
    assert "Itn     x[0]     Compatible    LS" in out
    assert "norm(A)  cond(A) gbar/|A|" in out
    rows = [line for line in out.splitlines()
            if re.match(r"\s+\d+ [ -]\d\.\d{5}e[+-]\d+", line)]
    assert len(rows) == int(res.n_iter)     # n <= 40: every iteration
    assert "istop   =" in out and "Arnorm  =" in out
    assert MINRES_MSG[int(res.istop)] in out


def test_minres_show_matches_info(capsys):
    n = 30
    res, out, ref = _texts(capsys, minres, jax_minres, _spd(n, 2),
                           np.ones(n), sym=True, rtol=1e-8)
    assert out == ref
    assert ("%12.4e" % float(res.info["Anorm"])) in out
    assert ("%12.4e" % float(res.info["Acond"])) in out


def test_minres_show_gates_rows_past_40(capsys):
    # n > 40: the reference prints the first ten rows, every tenth and the
    # rows its tests flag
    n = 120
    res, out, ref = _texts(capsys, minres, jax_minres, _spd(n, 3),
                           np.ones(n), sym=True, rtol=1e-12)
    assert out == ref
    assert int(res.n_iter) > 10


def test_lsqr_show_table(capsys):
    rng = np.random.default_rng(3)
    b = rng.standard_normal(40)
    res, out, ref = _texts(capsys, lsqr, jax_lsqr, rect(40, 20, seed=3), b)
    assert out == ref
    assert "LSQR            Least-squares solution of  Ax = b" in out
    assert "The matrix A has       40 rows and       20 cols" in out
    assert "LSQR finished" in out and "xnorm  =" in out
    assert LSQR_MSG[int(res.istop)] in out
    # row 0 prints the pre-loop state (itn=0, x=0)
    assert re.search(r"^\s+0\s+0\.00000e\+00", out, re.M)


def test_lsqr_show_damped_wantvar(capsys):
    rng = np.random.default_rng(4)
    b = rng.standard_normal(90)
    _, out, ref = _texts(capsys, lsqr, jax_lsqr, rect(90, 60, seed=4), b,
                         damp=0.2, wantvar=True, atol=1e-10, btol=1e-10)
    assert out == ref
    assert "wantvar = True" in out


def test_lsmr_show_table(capsys):
    rng = np.random.default_rng(6)
    b = rng.standard_normal(36)
    res, out, ref = _texts(capsys, lsmr, jax_lsmr, rect(36, 18, seed=6), b)
    assert out == ref
    assert "LSMR            Least-squares solution of  Ax = b" in out
    assert "norm r    norm Ar" in out and "LSMR finished" in out
    assert LSMR_MSG[int(res.istop)] in out
    assert "Estimated energy norm of x:" in out
    assert re.search(r"^\s+0\s+0\.00000e\+00", out, re.M)


def test_lsmr_show_repeats_heading(capsys):
    # past 20 printed rows the reference repeats the heading: n > 40
    # prints the first ten rows and the last ten before itnlim
    rng = np.random.default_rng(7)
    b = rng.standard_normal(200)
    res, out, ref = _texts(capsys, lsmr, jax_lsmr, rect(200, 60, seed=7), b,
                           atol=1e-14, btol=1e-14, etol=0.0, itnlim=25)
    assert out == ref
    assert int(res.istop) == 7
    assert out.count("norm r    norm Ar") >= 2


def test_craig_show_final_block(capsys):
    rng = np.random.default_rng(8)
    a = rect(20, 30, seed=8)
    b = a @ rng.standard_normal(30)
    res, out, ref = _texts(capsys, craig, jax_craig, a, b)
    assert out == ref
    assert "CRAIG           Least-squares solution of  Ax = b" in out
    assert "CRAIG finished" in out
    assert CRAIG_MSG[int(res.istop)] in out
    assert "r1norm =" in out and "r2norm =" in out


def test_craigmr_show_final_block(capsys):
    rng = np.random.default_rng(9)
    a = rect(20, 30, seed=9)
    b = a @ rng.standard_normal(30)
    _, out, ref = _texts(capsys, craigmr, jax_craigmr, a, b, etol=1e-12)
    assert out == ref
    assert "CRAIG-MR finished" in out and "xNrgNorm2 =" in out


def _records(name):
    rec = []

    class Keep(logging.Handler):
        def emit(self, r):
            rec.append(r.getMessage())

    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.addHandler(Keep())
    return lg, rec


def test_cg_compat_logger_lines():
    n = 32
    a = _spd(n, 4)
    lg, rec = _records("test-torch-cg-show")
    solver = compat.CG(MatrixOperator(torch.from_numpy(a), symmetric=True,
                                      device=DEV), logger=lg)
    solver.solve(np.ones(n))
    jlg, jrec = _records("test-torch-cg-show-jax")
    import pykrylov_tpu as pk
    jax_compat.CG(pk.linop_from_ndarray(a, symmetric=True),
                  logger=jlg).solve(np.ones(n))
    # the summary line's prefix differs by nothing; every line is equal
    assert rec == jrec
    rows = [line for line in rec if re.match(
        r"\s+\d+\s+\d\.\de[+-]\d\d\s+[ -]\d\.\de[+-]\d\d", line)]
    assert len(rows) == solver.nIter
    assert all(float(line.split()[2]) > 0 for line in rows)


def test_cg_null_logger_skips_replay():
    n = 16
    solver = compat.CG(MatrixOperator(torch.from_numpy(_spd(n, 5)),
                                      symmetric=True, device=DEV))
    res = solver.solve(np.ones(n))
    curv = res.info["curvatures"].numpy()
    nit = int(res.n_iter)
    assert np.all(np.isfinite(curv[1:nit + 1]))
    assert np.isnan(curv[0])


@pytest.mark.parametrize("solver", ["minres", "lsqr", "lsmr"])
def test_table_rows_follow_the_iteration(solver, capsys):
    # each recorded row holds its own iteration's values: x[0] is the
    # iterate's first entry (MINRES, with store_iterates), and the
    # residual column is the residual history (LSQR's r2norm, LSMR's normr)
    rng = np.random.default_rng(11)
    if solver == "minres":
        res = minres(MatrixOperator(torch.from_numpy(_spd(50, 11)),
                                    symmetric=True, device=DEV),
                     torch.from_numpy(np.ones(50)), rtol=1e-10,
                     store_iterates=True, show=True)
        k = int(res.n_iter)
        tab = res.info["show_table"].numpy()
        np.testing.assert_array_equal(tab[1:k + 1, 0],
                                      res.info["iterates"].numpy()[1:k + 1, 0])
        assert np.isnan(tab[0]).all() and np.isnan(tab[k + 1:]).all()
    else:
        fn, col = (lsqr, 2) if solver == "lsqr" else (lsmr, 1)
        res = fn(MatrixOperator(torch.from_numpy(rect(80, 40, seed=11)),
                                device=DEV),
                 torch.from_numpy(rng.standard_normal(80)),
                 store_history=True, show=True)
        k = int(res.n_iter)
        tab = res.info["show_table"].numpy()
        np.testing.assert_array_equal(tab[:k + 1, col],
                                      res.resid_history.numpy()[:k + 1])
        assert tab[0, 0] == 0.0 and np.isnan(tab[k + 1:]).all()
    capsys.readouterr()
    plain = (minres if solver == "minres" else lsqr)
    assert "show_table" not in plain(
        MatrixOperator(torch.eye(3, dtype=torch.float64), symmetric=True,
                       device=DEV), torch.ones(3, dtype=torch.float64)).info


@pytest.mark.parametrize("name", ["ISTOP_MSG_MINRES", "ISTOP_MSG_LSQR"])
def test_module_level_message_tables(name):
    # the JAX package's lazy tables: ``get`` reads the solver's ISTOP_MSG
    import pykrylov_tpu.solvers.show as jshow
    import pykrylov_tpu_torch.solvers.show as tshow
    from pykrylov_tpu_torch.solvers.lsqr import ISTOP_MSG as LM
    from pykrylov_tpu_torch.solvers.minres import ISTOP_MSG as MM
    ours, ref = getattr(tshow, name), getattr(jshow, name)
    table = MM if name.endswith("MINRES") else LM
    for code in list(table) + [99]:
        assert ours.get(code) == ref.get(code) == table.get(code, "")
    assert ours.get(99, "none") == "none"
    assert dict(ours.items()) == table and len(ours) == len(table)
