"""Seconds from the process's first clock reading to the first timed
solve: imports, the configuration's triples, ``operator_from_coo``, the
pool of right-hand sides and the warm-up (kernels loaded, or built in a
checkout's first run)."""


def read(run):
    return run.setup_s
