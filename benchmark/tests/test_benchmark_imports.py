"""No run loads JAX or the JAX package, and the reference and the model modules load
nothing of the port."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import run, spec
from benchmark.tests import cells

ENV = {**os.environ, "PYTHONPATH": str(spec.ROOT)}


def _python(code: str, cwd=spec.ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=600)


def test_the_reference_imports_nothing_of_the_port():
    p = _python("import sys, benchmark.reference, benchmark.correct, benchmark.counts, "
                "benchmark.synthetic, benchmark.trace, benchmark.spec; "
                "[benchmark.spec.model(p.stem) for p in "
                "(benchmark.spec.BENCH_DIR / 'models').glob('*.py')]; "
                "print(sorted({m.partition('.')[0] for m in sys.modules} & "
                "{'tcgnn_tpu_torch', 'tcgnn_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_run_loads_no_jax(tmp_path):
    root = cells.copy_root(tmp_path)
    p = _python(
        "import sys, torch; from pathlib import Path; from benchmark import run, spec; "
        f"root = Path({str(root)!r}); "
        "run.run_cell(spec.load_cell('agnn-tiny', root), 1, 0.1, True, torch.device('cpu'), root); "
        "print(run.forbidden_modules(), 'tcgnn_tpu_torch' in sys.modules)")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tcgnn_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tcgnn_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "tcgnn_tpu"]


def _cli(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "gcn-amazon0505", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=600)


def test_without_a_card_the_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _cli(spec.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_the_command_names_only_the_benchmark():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "-m", "benchmark.run"]
    assert bench["paths"] == ["benchmark"]
