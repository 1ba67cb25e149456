"""The operator's product ``A.matvec(v)`` against its roofline: the
least time (the configuration's bytes at the card's published bandwidth,
``roofline.product_bytes``) over the mean device time of back-to-back
products, the L2 flushed before each, in percent.  Single right-hand
side cells only."""

from benchmark import roofline


def read(run):
    if int(run.cell["k"]) != 1 or not run.product_ms:
        return None
    bound = roofline.bound_ms(run.cfg, 1, run.device_name)
    return None if bound is None else 100.0 * bound / run.product_ms
