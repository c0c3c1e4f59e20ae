"""Small cells for the benchmark's CPU tests, in a copy of the benchmark."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

# A small cell of each kind, and the cell whose limits it is held to.
SMALL = {
    "gcn-tiny": ("gcn-2l-h16", "powerlaw", "gcn-amazon0505"),
    "gcn-tiny-bd": ("gcn-2l-h16", "components", "gcn-yeast"),
    "gcn-tiny-nohoist": ("gcn-2l-h16-nohoist", "powerlaw", "gcn-amazon0505"),
    "agnn-tiny": ("agnn-2l-h32", "powerlaw", "agnn-amazon0505"),
}

# Configurations of the small cells that the benchmark has no cell of: each
# made from one of its configurations with the keys given.
DERIVED = {"gcn-2l-h16-nohoist": ("gcn-2l-h16", {"hoist": False})}


def small_traffic(generator: str) -> dict:
    return {"graph": f"tiny-{generator}", "why": "a CPU test", "generator": generator,
            "nodes": 3000, "edges": 24000, "features": 40, "classes": 5,
            "member_graphs": 300, "graph_seed": 0}


def copy_root(tmp: Path) -> Path:
    """A copy of the checkout's ``BENCHMARK.json`` and ``benchmark/`` with the
    small cells, and the configurations in ``DERIVED``, added as files and
    entries."""
    root = tmp / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for name, (base, keys) in DERIVED.items():
        entry = next(c for c in bench["configs"] if c["name"] == base)
        config = json.loads((spec.ROOT / entry["file"]).read_text())
        file = f"benchmark/configs/{name}.json"
        (root / file).write_text(json.dumps({**config, **keys, "name": name}))
        bench["configs"].append({**entry, "name": name, "file": file})
    for name, (config, generator, like) in SMALL.items():
        (root / "benchmark" / "traffic" / f"tiny-{generator}.json").write_text(
            json.dumps(small_traffic(generator)))
        limits = json.loads((spec.BENCH_DIR / "workloads" / f"{like}.json").read_text())
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": f"tiny-{generator}", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
