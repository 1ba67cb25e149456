"""Host us a product launch: the mean length of the ``launch.*`` spans
around the kernel wrappers' host work (``sparse/kernels.py`` ``_launch``,
``_launch_mm``; ``sparse/sell.py`` ``_launch``) in the traced solves."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    launches = [] if s is None else s.named(
        lambda n: n.startswith(spans.LAUNCH))
    if not launches:
        return None
    return 1e6 * sum(x.end - x.start for x in launches) / len(launches)
