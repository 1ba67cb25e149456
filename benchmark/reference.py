"""The plain reference: the matrix's product from its COO triples, true
residuals, and plain CG.

Plain PyTorch and NumPy.  It imports nothing of pykrylov_tpu_torch or of
the JAX package and takes nothing the port built: it works from the
triples the configuration's generator made.  The benchmark uses it to
make the right-hand sides (``b = A x_true`` in float64, rounded to the
cell's dtype) and to judge what the port returns; ``plain_cg`` in a
lower precision is the control that the comparison must reject.
"""

import torch

# nonzeros per index_add_ call: bounds the gathered (chunk, K) block
CHUNK = 1 << 23


class Coo:
    """The triples on a device: values in ``dtype``, int64 indices."""

    def __init__(self, coo, device, dtype=torch.float64):
        vals, rows, cols, shape = coo
        self.shape = tuple(int(s) for s in shape)
        self.vals = torch.as_tensor(vals).to(device, dtype)
        self.rows = torch.as_tensor(rows).to(device, torch.int64)
        self.cols = torch.as_tensor(cols).to(device, torch.int64)
        self.dtype = dtype

    def matmul(self, x):
        """``A @ x`` for an (n,) vector or an (n, K) block, in the
        triples' dtype, summed with ``index_add_``."""
        x = x.to(self.dtype)
        y = torch.zeros((self.shape[0],) + tuple(x.shape[1:]),
                        dtype=self.dtype, device=x.device)
        for lo in range(0, self.vals.numel(), CHUNK):
            hi = lo + CHUNK
            v = self.vals[lo:hi]
            if x.dim() == 2:
                v = v[:, None]
            y.index_add_(0, self.rows[lo:hi], v * x[self.cols[lo:hi]])
        return y


def max_rel_err(y, ref):
    """``max |y - ref| / max |ref|`` in float64."""
    y, ref = y.double(), ref.double()
    scale = ref.abs().max().item()
    return (y - ref).abs().max().item() / (scale if scale else 1.0)


def rel_residuals(A64, b, x):
    """The true relative residual ``||b - A x|| / ||b||`` of each column
    in float64, as a list (one entry for a vector)."""
    b64 = b.double()
    r = b64 - A64.matmul(x.double())
    num = torch.linalg.vector_norm(r, dim=0)
    den = torch.linalg.vector_norm(b64, dim=0)
    return (num / den).reshape(-1).tolist()


def plain_cg(A, b, rtol, maxiter, dtype):
    """Unpreconditioned CG from x0 = 0 on each column of ``b`` (a vector
    or an (n, K) block) in ``dtype``: products through ``A.matmul`` (a
    :class:`Coo` in that dtype), scalars per column, a column frozen once
    its recurrence residual is at most ``rtol`` times its first.  Returns
    ``x`` in ``dtype``."""
    one = b.dim() == 1
    B = (b[:, None] if one else b).to(dtype)
    x = torch.zeros_like(B)
    r = B.clone()
    p = r.clone()
    rr = (r * r).sum(0)
    stop = rr.double().sqrt() * rtol
    active = torch.ones_like(rr, dtype=torch.bool)
    for _ in range(maxiter):
        active &= rr.double().sqrt() > stop
        if not bool(active.any()):
            break
        q = A.matmul(p)
        pq = (p * q).sum(0)
        alpha = torch.where(active, rr / pq, torch.zeros_like(rr))
        x += alpha * p
        r -= alpha * q
        rr_new = (r * r).sum(0)
        beta = torch.where(active, rr_new / rr, torch.zeros_like(rr))
        p = r + beta * p
        rr = torch.where(active, rr_new, rr)
    return x[:, 0] if one else x
