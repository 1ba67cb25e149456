"""Host ms an iteration: the host time inside the solvers' iteration
spans (``cg.iter``, ``cg_batched.iter``) of the traced solves, their
``read`` spans taken out, over the traced iterations: the host's cost to
issue one iteration."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    host = None if s is None else s.host_iter_s()
    return spans.per_iteration(run, None if host is None else 1e3 * host)
