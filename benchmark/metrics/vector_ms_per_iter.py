"""Device ms per iteration of every kernel in the traced window that is
not an operator product: the solvers' elementwise passes and reductions.
A product kernel is one whose name holds one of ``PRODUCTS``."""

PRODUCTS = ("spmv", "spmm")


def read(run):
    if run.traced is None or not run.traced["iterations"]:
        return None
    kernels = run.traced["timeline"].kernels()
    if not kernels:
        return None
    secs = sum(s for name, s in kernels
               if not any(p in name.lower() for p in PRODUCTS))
    return 1e3 * secs / run.traced["iterations"]
