"""Host reads an iteration: the port's ``host_syncs`` counter
(``solvers.common.host_read``) over the traced solves, per traced
iteration."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    if s is None or not s.solves:
        return None
    return spans.per_iteration(run, float(s.host_syncs))
