"""Faults planted underneath a run's window, to show that the comparison
which decides ``correct`` catches each.

A solve fault wraps the port's ``solve``: a solve that returns its state
(x0 = 0) unchanged, half of a block left unsolved, the answer written one
row off (a block's answers one column off), a solve that reports no
convergence.  The product fault writes the port's product one row off.
One chip: no exchange between chips to leave out.

``benchmark/tests/test_bench_faults.py`` plants them on the CPU at a
small size (the product fault inside the operator, under the solves too);
``control.py --faults`` plants them on the card at the cells' own size,
the product fault in the product that the comparison reads (under the
solves, a product one row off leaves CG to grind to its cap of 2n
iterations).
"""

import contextlib
import dataclasses

PRODUCT = "product"


def unchanged(solve):
    def fault(A, b, **kw):
        res = solve(A, b, **kw)
        return dataclasses.replace(res, x=res.x.new_zeros(res.x.shape))
    return fault


def half_block(solve):
    def fault(A, b, **kw):
        if b.dim() == 1:
            return solve(A, b, **kw)
        half = b.shape[1] // 2
        res = solve(A, b[:, :half].contiguous(), **kw)
        x = b.new_zeros(b.shape)
        x[:, :half] = res.x
        k = b.shape[1]
        return dataclasses.replace(
            res, x=x, converged=res.converged.new_ones(k),
            istop=res.istop.new_zeros(k))
    return fault


def altered(solve):
    # off by one where the answer is written: a vector's entries shifted
    # by a row, a block's answers handed to the next column
    def fault(A, b, **kw):
        res = solve(A, b, **kw)
        return dataclasses.replace(res, x=res.x.roll(1, dims=-1))
    return fault


def unconverged(solve):
    def fault(A, b, **kw):
        res = solve(A, b, **kw)
        return dataclasses.replace(res, converged=res.converged.new_zeros(
            res.converged.shape))
    return fault


SOLVE_FAULTS = {"unchanged": unchanged, "half_block": half_block,
                "altered": altered, "unconverged": unconverged}
NAMES = sorted(SOLVE_FAULTS) + [PRODUCT]


def applies(name, k):
    """Whether the fault ``name`` can happen in a cell of block width
    ``k``: a single right-hand side has no half to leave out."""
    return not (name == "half_block" and k == 1)


def off_by_row(y):
    """A product's rows written one row off."""
    return y.roll(1, dims=0)


@contextlib.contextmanager
def planted(bench, name):
    """The fault ``name`` planted under ``bench`` (a ``harness.Bench``)
    while the block runs; nothing with ``name`` None."""
    if name is None:
        yield
        return
    if name == PRODUCT:
        real = bench.program_product
        bench.program_product = lambda: off_by_row(real())
        try:
            yield
        finally:
            del bench.program_product
        return
    pt = bench.pt
    real = pt.solve
    pt.solve = SOLVE_FAULTS[name](real)
    try:
        yield
    finally:
        pt.solve = real
