"""The readers of the program's spans and counters (``spans.py`` and its
metrics): on the CPU the device ones find nothing and the host spans are
read; against a program without them, every one finds nothing."""

import json
import types

import torch

from benchmark import run, spans, spec
from benchmark.tests import cells

DEVICE = ("agg_fwd_ms", "agg_bwd_ms", "dense_fwd_ms", "dense_bwd_ms", "loss_ms", "optimizer_ms",
          "step_nodes")
HOST = ("graph_upload_s", "optimizer_build_s")


def test_the_spans_are_metrics_of_every_cell():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in DEVICE + HOST:
        assert "workloads" not in entries[name] and entries[name]["source"] == "program_counter"


def test_a_cpu_run_reads_the_host_spans_alone(tmp_path):
    root = cells.copy_root(tmp_path)
    result, _ = run.run_cell(spec.load_cell("gcn-tiny", root), 5, 0.2, True,
                             torch.device("cpu"), root)
    metrics = result["metrics"]
    assert not set(DEVICE) & set(metrics)
    for name in HOST:
        assert metrics[name]["value"] > 0, name
    assert metrics["graph_upload_s"]["unit"] == "s"


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from tcgnn_tpu_torch import profiling

    old_program = types.SimpleNamespace(step=types.SimpleNamespace(), on_card=True,
                                        epoch_ms=4.0)
    monkeypatch.delattr(profiling, "RECORDER")
    for name in DEVICE + HOST:
        assert spec.reader(name)(old_program) is None, name
    assert spans.phases(old_program) is None


def test_the_phases_are_read_once_a_run():
    calls = []

    def span_ms(epochs):
        calls.append(epochs)
        return {"forward": 1.0, "agg.fwd": 2.0, "loss.fwd": 0.25, "loss.bwd": 0.5,
                "backward": 1.5, "agg.bwd": 3.0, "optimizer": 0.75}

    card = types.SimpleNamespace(step=types.SimpleNamespace(span_ms=span_ms), on_card=True,
                                 epoch_ms=4.0)
    got = {name: spec.reader(name)(card) for name in DEVICE[:-1]}
    assert got == {"agg_fwd_ms": 2.0, "agg_bwd_ms": 3.0, "dense_fwd_ms": 1.0,
                   "dense_bwd_ms": 1.5, "loss_ms": 0.75, "optimizer_ms": 0.75}
    assert calls == [250]  # 1 s of 4 ms epochs, once
    card.epoch_ms, card.__dict__["phase_ms"] = 200.0, None
    assert spans.phases(card) is None
    slow = types.SimpleNamespace(step=types.SimpleNamespace(span_ms=span_ms), on_card=True,
                                 epoch_ms=200.0)
    spans.phases(slow)
    assert calls[-1] == spans.MIN_REPLAYS
