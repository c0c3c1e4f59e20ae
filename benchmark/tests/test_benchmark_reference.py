"""The model modules' written-out backward passes, and the port's step against the reference."""

import pytest
import torch

from benchmark import reference, run, spec
from benchmark.tests import cells


def _graph():
    rows = [0, 0, 1, 2, 2, 2, 3, 4, 4]
    cols = [1, 3, 0, 0, 1, 4, 2, 2, 3]
    ptr = [0, 2, 3, 6, 7, 9]
    import numpy as np
    g = reference.Graph(np.array(ptr), np.array(cols), "cpu")
    dense = torch.zeros(5, 5, dtype=torch.float64)
    dense[rows, cols] = 1.0
    return g, dense


@pytest.mark.parametrize("block", [1 << 23, 2])
def test_aggregate_gradient(block, monkeypatch):
    monkeypatch.setattr(reference, "EDGE_BLOCK", block)
    g, a = _graph()
    x = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    aggregate = spec.model("gcn")._Aggregate
    torch.autograd.gradcheck(lambda t: aggregate.apply(t, g), (x,))
    torch.testing.assert_close(aggregate.apply(x, g), a @ x)


@pytest.mark.parametrize("block", [1 << 23, 4])
def test_attention_gradient(block, monkeypatch):
    monkeypatch.setattr(reference, "EDGE_BLOCK", block)
    g, a = _graph()
    x = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
    c = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    attention = spec.model("agnn")._Attention
    torch.autograd.gradcheck(lambda t, s: attention.apply(t, s, g), (x, c))
    torch.testing.assert_close(attention.apply(x, c, g), c * (a * (x @ x.T)) @ x)


@pytest.mark.parametrize("cell", sorted(cells.SMALL))
def test_the_port_agrees_with_the_reference(cell, tmp_path):
    root = cells.copy_root(tmp_path)
    result, checks = run.run_cell(spec.load_cell(cell, root), 2**31 + 9, 0.2, False,
                                  torch.device("cpu"), root)
    assert result["correct"], checks
    assert all(c["value"] < c["limit"] for c in checks.values())
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"epoch_ms", "epoch_ms_p95", "peak_mem_gib", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
