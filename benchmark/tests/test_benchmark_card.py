"""A small cell run on the card, traced: the replayed step against the reference,
and the trace's readers.  Marked ``gpu``: it skips without a card."""

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(cells.SMALL))
def test_a_small_cell_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = cells.copy_root(tmp_path)
    result, checks = run.run_cell(spec.load_cell(cell, root), 11, 0.5, True,
                                  torch.device("cuda"), root)
    assert result["correct"], checks
    metrics = result["metrics"]
    for name in ("kernel_ms", "dense_ms", "device_idle_pct", "mfu_pct", "agg_roofline",
                 "capture_s"):
        assert name in metrics, name
    assert 0 < metrics["agg_roofline"]["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
