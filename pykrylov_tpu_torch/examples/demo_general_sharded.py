"""Sharded general sparsity: the partition-time gather schedule and one
SELL kernel launch a shard (``parallel.GatherBellOperator``).

The rows of a banded SPD matrix with a scattered band are sharded over a
mesh of shard slots; each product exchanges only the x entries a shard
references and runs each shard's local block on its own card form.
Prints the scheduled exchange against an all-gather's, and a CG solve.
The slots share the one card (or the CPU): the demo shows the exchange
and the shard products, not a scaling across cards.

    python -m pykrylov_tpu_torch.examples.demo_general_sharded
        [--shards 8] [--device cuda]
"""

import argparse

import numpy as np
import torch

from pykrylov_tpu_torch.parallel import (GatherBellOperator, make_mesh,
                                         shard_vector)
from pykrylov_tpu_torch.solvers import cg
from pykrylov_tpu_torch.sparse import formats as F


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    n, per_row, bw = 4096, 6, 220
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=len(rows)),
                   0, n - 1)
    vals = rng.standard_normal(len(rows)) * 0.05
    # symmetrize + diagonal dominance -> SPD for CG
    rows_s = np.concatenate([rows, cols, np.arange(n)])
    cols_s = np.concatenate([cols, rows, np.arange(n)])
    vals_s = np.concatenate([vals, vals,
                             np.full(n, 4.0)]).astype(np.float32)
    coo = F.coo_from_arrays(vals_s, rows_s, cols_s, (n, n), device=None)

    mesh = make_mesh(args.shards, device=args.device)
    op = GatherBellOperator(coo, mesh, symmetric=True)
    print("mesh: %d shard slots on %s | scheduled comm %d entries/mv "
          "(true %d) vs all-gather %d  [%.1fx less]"
          % (mesh.size, args.device, op.comm_entries_per_matvec,
             op.comm_entries_true, op.allgather_entries_per_matvec,
             op.allgather_entries_per_matvec
             / max(1, op.comm_entries_per_matvec)))

    e = torch.ones(op.shape[1], dtype=torch.float32)
    b = op @ shard_vector(e, mesh)
    res = cg(op, b, rtol=1e-10, maxiter=4 * n)
    err = float((res.x[:n].cpu() - 1.0).abs().max())
    print("CG: istop=%d iters=%d converged=%s relres=%.2e err=%.2e"
          % (int(res.istop), int(res.n_iter), bool(res.converged),
             float(res.resid_norm / res.resid_norm0), err))
    return op, res


if __name__ == "__main__":
    main()
