"""The reference's CG demo (``examples/demo_cg.py``).

Solves A x = A·e in float64 on a symmetric matrix (default the bundled
1138bus) with the demo protocol of :mod:`.demo_common`, logging every
iteration to stdout.

    python -m pykrylov_tpu_torch.examples.demo_cg [matrix] [--device cuda]
"""

import argparse
import logging
import sys

from pykrylov_tpu_torch.compat import CG

from .demo_common import demo


def stdout_logger(name):
    """The named logger, printing the solver's lines to the current
    stdout (a handler an earlier call added is replaced)."""
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    for old in list(log.handlers):
        log.removeHandler(old)
    hndlr = logging.StreamHandler(sys.stdout)
    hndlr.setFormatter(logging.Formatter(
        "%(name)-2s %(levelname)-8s %(message)s"))
    log.addHandler(hndlr)
    return log


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("matrix", nargs="?", default="1138bus",
                   help="bundled matrix name or .mtx path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return demo(CG, args.matrix, symmetric=True, device=args.device,
                logger=stdout_logger("CG"))


if __name__ == "__main__":
    main()
