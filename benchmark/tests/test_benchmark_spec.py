"""Every file the harness finds by name loads, and new cells and metrics are found
without an edit."""

import json

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import cells

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert set(cell.limits) == {"loss", "grad", "change"}
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "epoch_ms"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_states_its_cut(entry):
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    assert config["reduced"] == entry["reduced"]
    assert config["name"] == entry["name"]
    for key in entry["reduced"]:
        assert key in config.get("published", {})


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric["name"]))


def test_every_file_is_used():
    names = {p.stem for p in (spec.BENCH_DIR / "workloads").glob("*.json")}
    assert names == {w["name"] for w in BENCH["workloads"]}
    names = {p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.json")}
    assert names == {w["traffic"] for w in BENCH["workloads"]}
    names = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert names == {m["name"] for m in BENCH["per_layer"]}
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    names = {p.stem for p in (spec.BENCH_DIR / "models").glob("*.py")}
    assert names == {json.loads((spec.ROOT / c["file"]).read_text())["model"]
                     for c in BENCH["configs"]}


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = cells.copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "epochs_in_window", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "trainer", "moves": "epoch_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "metrics" / "epochs_in_window.py").write_text(
        "def read(run):\n    return run.epoch_ms * 0 + 7\n")
    cell = spec.load_cell("gcn-tiny", root)
    assert cell.traffic["nodes"] == 3000
    result, _ = run.run_cell(cell, 3, 0.2, True, torch.device("cpu"), root)
    assert result["metrics"]["epochs_in_window"] == {"value": 7, "unit": "1"}
    # Off the card nothing is traced: the device metrics are left out, not 0.
    assert "kernel_ms" not in result["metrics"] and "mfu_pct" not in result["metrics"]
    assert "prep_host_ms" in result["metrics"]


def test_an_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_a_model_without_a_module_raises(tmp_path):
    root = cells.copy_root(tmp_path)
    config = json.loads((root / "benchmark" / "configs" / "gcn-2l-h16.json").read_text())
    (root / "benchmark" / "configs" / "gcn-2l-h16.json").write_text(
        json.dumps({**config, "model": "no-such-model"}))
    with pytest.raises(FileNotFoundError) as raised:
        spec.load_cell("gcn-tiny", root)
    assert str(root / "benchmark" / "models" / "no-such-model.py") in str(raised.value)
