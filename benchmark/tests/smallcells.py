"""Cells of the benchmark cut to sizes the CPU runs in seconds."""

from conftest import ROOT


def small(name, root=ROOT, **cell_over):
    """The cell ``name`` at a size the CPU runs in seconds: Poisson on a
    12^3 grid, the bus matrix tiled twice; a pool of 3."""
    from benchmark import harness
    entry, cell, cfg = harness.find_cell(name, root)
    cell = dict(cell, chips=entry["chips"], pool=3, **cell_over)
    if cfg["generator"] == "poisson3d":
        n = 12
        cfg = dict(cfg, n=n, rows=n ** 3, nnz=n ** 3 + 6 * n * n * (n - 1))
    else:
        cfg = dict(cfg, tiles=2, rows=2 * 1138, nnz=2 * 4054)
    return cell, cfg
