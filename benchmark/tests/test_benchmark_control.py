"""The check that decides ``correct`` fails what it must: the lower-precision
control, and the timed path broken underneath, at a size a test run holds."""

import contextlib

import pytest
import torch

from benchmark import calibrate, correct, run, spec
from benchmark.tests import cells
from tcgnn_tpu_torch import graph as port_graph


@pytest.mark.parametrize("cell", sorted(cells.SMALL))
def test_the_control_is_not_correct(cell, tmp_path):
    root = cells.copy_root(tmp_path)
    limits = spec.load_cell(cell, root).limits
    lines = calibrate.main(["--workload", cell, "--seeds", "21-23", "--control", "3",
                            "--fault", "3", "--device", "cpu", "--root", str(root)])
    for line in lines:
        ok = all(correct.passes(line["gaps"][k], limits[k]) for k in correct.NAMES)
        assert ok == (line["kind"] == "program"), line


def _no_update(self, closure=None):
    return None


def _altered(method):
    def wrapper(self, *args):
        out = method(self, *args)
        return out * 1.01
    return wrapper


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", sorted(cells.SMALL))
def test_a_broken_step_is_not_correct(cell, fault, tmp_path, monkeypatch):
    root = cells.copy_root(tmp_path)
    broken = contextlib.nullcontext()
    if fault == "unchanged_state":
        monkeypatch.setattr(torch.optim.Adam, "step", _no_update)
    elif fault == "half_batch":
        broken = calibrate.half_batch()
    else:
        for name in ("_spmm_f", "_agnn_f", "_spmm_w"):
            monkeypatch.setattr(port_graph.TiledGraph, name,
                                _altered(getattr(port_graph.TiledGraph, name)))
    with broken:
        result, checks = run.run_cell(spec.load_cell(cell, root), 5, 0.1, False,
                                      torch.device("cpu"), root)
    assert result["correct"] is False, checks
