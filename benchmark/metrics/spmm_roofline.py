"""The operator's block product ``A @ X`` on an (n, k) block (the call
``cg_batched`` makes) against its roofline, as ``spmv_roofline``.  Block
cells only."""

from benchmark import roofline


def read(run):
    k = int(run.cell["k"])
    if k == 1 or not run.product_ms:
        return None
    bound = roofline.bound_ms(run.cfg, k, run.device_name)
    return None if bound is None else 100.0 * bound / run.product_ms
