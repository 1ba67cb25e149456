"""Right-hand sides solved a second: the columns of the window's solves
that the comparison accepts, over the window's seconds (from the first
solve's call to the synchronised return of the last one started inside
``--seconds``)."""


def read(run):
    if not run.window_s:
        return None
    return (run.attempted - run.failed) / run.window_s
