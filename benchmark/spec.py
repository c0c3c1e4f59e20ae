"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness reads, all under ``benchmark/``:

* ``configs/<config>.json``: the model's sizes and training settings (the
  file ``BENCHMARK.json`` gives for the configuration);
* ``traffic/<traffic>.json``: the graph the generator makes (sizes,
  generator, graph seed);
* ``workloads/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns the metric's value or None where it finds nothing to read.

So a cell, a configuration, a traffic mix or a metric is added with files
and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    bench_dir = root / "benchmark"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(bench_dir / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
