"""The 95th percentile (nearest rank) of the window's solve times, each
from the call to the synchronised return, over every solve."""

import math


def read(run):
    walls = sorted(s.wall_s for s in run.solves)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1]
