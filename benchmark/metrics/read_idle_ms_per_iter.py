"""Device idle ms an iteration in the traced window's gaps whose midpoint
lies in a ``read`` span (``solvers.common.host_read``): the round trip of
the solvers' host reads."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    if s is None or not s.named(lambda n: n == spans.READ):
        return None
    return spans.per_iteration(run, 1e3 * s.read_idle_s)
