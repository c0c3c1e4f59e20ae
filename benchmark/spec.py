"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness reads, all under ``benchmark/``:

* ``configs/<config>.json``: the model's sizes and training settings (the
  file ``BENCHMARK.json`` gives for the configuration), with the model's
  name under ``model`` and optional ``optimizer`` settings, keyword
  arguments of the port's ``train.make_optimizer`` that the reference's
  Adam applies too (``weight_decay``);
* ``models/<model>.py``: everything of the benchmark that depends on the
  model, a module that imports nothing of the program:

  - ``layer_dims(config, traffic)``: the layer widths;
  - ``make_weights(config, dims, seed, device)``: the initial parameters
    by the port's parameter names, drawn from the seed;
  - ``prepare(config, x, graph)``, ``dropout_masks(config, num_nodes,
    generator, device)`` and ``forward(config, params, x, graph, masks,
    prepared)``: the float64 reference's fixed inputs, one step's dropout
    masks drawn in the port's order, and its log-probabilities
    (``reference.train`` drives them);
  - ``epoch_counts(config, dims, nodes, edges)``: the epoch's ``flops``,
    ``agg_flops`` and ``agg_bytes``;
  - ``WEIGHTED_TRAFFIC`` (whether the port's graph keeps the weighted
    SpMM's traffic) and ``NET_ARGS`` (the configuration keys passed to the
    port's ``nets.GNN``), plain data for ``program``;
* ``traffic/<traffic>.json``: the graph the generator makes (sizes,
  generator, graph seed);
* ``workloads/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns the metric's value or None where it finds nothing to read.

So a cell, a configuration, a traffic mix, a metric, and a model that the
port runs, are added with files and entries alone.
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
    model: object      # the configuration's module, ``model``


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
        model=model(config["model"], root),
    )


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def model(name: str, root: Path = ROOT):
    """The module ``benchmark/models/<name>.py``."""
    path = root / "benchmark" / "models" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no module for model {name!r}: looked for {path}")
    return _module(path, f"benchmark_model_{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return _module(root / "benchmark" / "metrics" / f"{metric}.py",
                   f"benchmark_metric_{metric}").read
