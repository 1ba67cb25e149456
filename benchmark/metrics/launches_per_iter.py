"""Product kernel launches per iteration over the traced solves: the
port's four launch counters (DIA SpMV and SpMM, SELL SpMV and SpMM)."""


def read(run):
    if run.traced is None or not run.traced["iterations"]:
        return None
    return sum(run.traced["launches"].values()) / run.traced["iterations"]
