"""Checkpoint and resume of long solves.

Counterpart of ``pykrylov_tpu/utils/checkpoint.py``.  The reference has no
checkpointing; its nearest feature is the warm start (``guess``).  A solve
runs in bounded chunks, the result is saved after each, and a resumed
solve warm-starts from the saved iterate.  Each chunk boundary is a
restart of the solver (short-recurrence methods lose at most a few
iterations of superlinear convergence).

Checkpoints are plain ``.npz`` files of host arrays, written atomically,
portable across machines and meshes: a checkpoint's ``x`` is the whole
(padded) iterate, and on resume it goes back to the right-hand side's
device and dtype, its first rows fitted to the new solve's length (rows
past it must be zero padding; missing rows are padded with zeros), so a
checkpoint written by one mesh resumes on a mesh of another size or
unsharded.  On a mesh of slots a sharded vector is one padded tensor.  On
a mesh of ranks every rank calls :func:`save_result` with its own rows:
they are all-gathered, rank 0 writes the one file, and a barrier follows,
so on resume every rank reads the whole iterate (the path must name the
same file on every rank) and keeps its own rows.
"""

from __future__ import annotations

import inspect
import os
import tempfile
import time

import numpy as np
import torch

from . import ranks

__all__ = ["save_result", "load_result", "checkpointed_solve"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_result(path, result, extra=None):
    """Persist a :class:`SolveResult`'s arrays and scalars to ``.npz``
    (atomic: a temporary file beside ``path``, then a rename).  With a
    rank-sharded ``x`` every rank of the mesh must call it: the ranks'
    rows are all-gathered into the whole ``x``, rank 0 writes, and every
    rank returns after the file is in place."""
    x = result.x
    on_ranks = ranks.sharded(x)
    if on_ranks:
        x = ranks.gather_ranks(ranks.plain(x)).flatten(0, 1)
        if ranks.world().rank != 0:
            ranks.world().barrier()
            return
    payload = {k: _host(getattr(result, k))
               for k in ("converged", "istop", "n_iter", "n_matvec",
                         "resid_norm", "resid_norm0")}
    payload["x"] = _host(x)
    if result.resid_history is not None:
        payload["resid_history"] = _host(result.resid_history)
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = _host(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if on_ranks:
        ranks.world().barrier()


def load_result(path):
    """A checkpoint as a dict of NumPy arrays, or None if there is none."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _resume_x0(x, b):
    """The checkpoint's whole iterate ``x`` as this solve's guess: its
    first ``rows(b)`` rows (zero rows past them, else ValueError), padded
    with zeros to that length, on ``b``'s device and dtype; on a mesh of
    ranks this rank's rows of it."""
    n = ranks.rows(b)
    if x.shape[0] > n and np.any(x[n:]):
        raise ValueError("the checkpoint's x has nonzero rows past this "
                         "solve's %d: it belongs to another system" % n)
    fit = np.zeros((n,) + x.shape[1:], dtype=x.dtype)
    fit[:min(n, x.shape[0])] = x[:n]
    if ranks.sharded(b):
        L = b.shape[0]
        r = ranks.world().rank
        fit = fit[r * L:(r + 1) * L]
    x0 = torch.from_numpy(fit).to(device=b.device, dtype=b.dtype)
    return ranks.shard(x0) if ranks.sharded(b) else x0


def checkpointed_solve(solve_fn, A, b, path, chunk_iters=500,
                       max_chunks=1000, keep_going=None, **solve_kwargs):
    """Run ``solve_fn(A, b, ...)`` in bounded chunks with a checkpoint
    after each.

    Parameters
    ----------
    solve_fn : a solver taking ``x0`` and an iteration cap, ``maxiter``
        or else ``matvec_max`` (found from its signature).
    path : checkpoint file; if it exists the solve resumes from it.
    chunk_iters : the cap of each chunk.
    keep_going : optional ``(chunk_index, result) -> bool``; False stops
        after that chunk (an external preemption signal, say).  On a mesh
        of ranks every rank runs the solve and must answer alike.

    The stopping threshold ``max(atol, rtol * resid0)`` of the first
    chunk is frozen as an absolute one for the later chunks (and a
    resumed solve inherits it from the checkpoint), so restarts do not
    loosen the overall stopping rule.  Returns the last chunk's
    :class:`SolveResult`, with the matvecs of every chunk, those before a
    resume included, in ``info["total_matvec"]``.
    """
    state = load_result(path)
    x0 = solve_kwargs.pop("x0", None)
    total_mv = 0
    if state is not None:
        x0 = _resume_x0(state["x"], b if isinstance(b, torch.Tensor)
                        else torch.as_tensor(b))
        total_mv = int(state.get("extra_total_matvec", 0))

    params = inspect.signature(solve_fn).parameters
    cap_kw = "maxiter" if "maxiter" in params else "matvec_max"
    can_freeze = "rtol" in params and "atol" in params
    if can_freeze:
        # resolve the solver's defaults, so that the freeze below also
        # happens when the caller relied on them
        solve_kwargs.setdefault("rtol", params["rtol"].default)
        solve_kwargs.setdefault("atol", params["atol"].default)
    if state is not None and can_freeze \
            and "extra_abs_threshold" in state:
        solve_kwargs["atol"] = float(state["extra_abs_threshold"])
        solve_kwargs["rtol"] = 0.0
    abs_threshold = solve_kwargs.get("atol", 0.0)

    res = None
    for chunk in range(max_chunks):
        t0 = time.perf_counter()
        res = solve_fn(A, b, x0=x0, **{cap_kw: chunk_iters},
                       **solve_kwargs)
        total_mv += int(res.n_matvec)
        if chunk == 0 and can_freeze and solve_kwargs.get("rtol", 0.0):
            abs_threshold = max(
                solve_kwargs.get("atol", 0.0),
                solve_kwargs["rtol"] * float(res.resid_norm0))
            solve_kwargs["atol"] = abs_threshold
            solve_kwargs["rtol"] = 0.0
        save_result(path, res, extra={"total_matvec": total_mv,
                                      "chunk": chunk,
                                      "abs_threshold": abs_threshold,
                                      "chunk_time": time.perf_counter() - t0})
        if bool(res.converged):
            break
        if keep_going is not None and not keep_going(chunk, res):
            break
        x0 = res.x
    res.info["total_matvec"] = total_mv
    return res
