"""A cell through the CUDA kernels at a size a test can hold: the
Poisson matrix on a 48^3 grid (110,592 rows, past the DIA kernel's row
threshold) and the bus matrix tiled 64 times, traced, with the roofline
timing.  Marked ``cuda``; skips without a card."""

import pytest

from benchmark import harness
from smallcells import small

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name, over", [
    ("poisson3d-n240.cg", {"n": 48, "rows": 48 ** 3,
                           "nnz": 48 ** 3 + 6 * 48 * 48 * 47}),
    ("bus1138-x1024.cg-k8", {"tiles": 64, "rows": 64 * 1138,
                             "nnz": 64 * 4054}),
])
def test_traced_cell_on_card(card, name, over, tmp_path):
    cell, cfg = small(name, trace_solves=1)
    cfg = dict(cfg, **over)
    out = harness.run_cell(name, 2 ** 31 + 17, 1.0, True, 0.0,
                           device="cuda", cell=cell, cfg=cfg,
                           trace_dir=str(tmp_path))
    assert out["correct"] is True
    m = {k.split(".")[0]: v["value"] for k, v in out["metrics"].items()}
    roof = m.get("spmv_roofline", m.get("spmm_roofline"))
    assert 0 < roof <= 105
    assert 0 <= m["device_idle_pct"] < 100
    assert m["launches_per_iter"] == 1.0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
