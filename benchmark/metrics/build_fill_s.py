"""Seconds of the operator build's ``build.fill`` span
(``sparse/linop.py``): the host DIA fill, or the BELL packing and its
planners, of the run's ``operator_from_coo``."""

from benchmark import spans


def read(run):
    s = spans.load(run)
    return None if s is None else s.build_fill_s
