"""Device idle ms an iteration in the traced window's gaps whose midpoint
lies in a solver iteration's span outside its ``read`` spans: the card
waiting for the host to enqueue the iteration's work."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    if s is None or not s.named(lambda n: n.endswith(spans.ITER)):
        return None
    return spans.per_iteration(run, 1e3 * s.issue_idle_s)
