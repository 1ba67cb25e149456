"""``SolveResult.n_iter`` averaged over the window's solves (block
iterations for a block solve)."""


def read(run):
    if not run.solves:
        return None
    return sum(s.n_iter for s in run.solves) / len(run.solves)
