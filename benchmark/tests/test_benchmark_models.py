"""The model modules: held to the readings and work counts recorded before the harness
took its models from them (``frozen.json``), a model added as files alone, and the shared
Adam loop's weight decay."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import calibrate, correct, program, reference, run, spec, synthetic
from benchmark.tests import cells

HERE = Path(__file__).parent
FROZEN = json.loads((HERE / "frozen.json").read_text())
CPU = torch.device("cpu")


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().double().contiguous().numpy().tobytes()).hexdigest()


@pytest.fixture
def one_thread():
    """The recorded readings were taken with one torch thread: a float64 GEMM's
    blocking, and so its last bits, follows the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cell, seed: int):
    data = synthetic.make_dataset(cell.traffic, seed)
    x = torch.from_numpy(data.x)
    y = torch.from_numpy(data.y.astype(np.int64))
    return data, x, y, reference.Graph(data.row_pointers, data.column_index, CPU)


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
@pytest.mark.parametrize("cell", ["gcn-tiny", "gcn-tiny-bd", "agnn-tiny"])
def test_the_reference_reads_as_recorded(cell, seed, tmp_path, one_thread):
    want = FROZEN["readings"][f"{cell}/{seed}"]
    c = spec.load_cell(cell, cells.copy_root(tmp_path))
    _, x, y, graph = _inputs(c, seed)
    dims = c.model.layer_dims(c.config, c.traffic)
    weights = c.model.make_weights(c.config, dims, seed + 2, CPU)
    got = reference.train(c.config, c.model, weights, x, y, graph, seed + 3, 3)
    assert {k: _digest(v) for k, v in weights.items()} == want["weights"]
    assert [v.hex() for v in got.losses] == want["losses"]
    assert {k: _digest(v) for k, v in got.grad.items()} == want["grad"]
    assert {k: _digest(v) for k, v in got.change.items()} == want["change"]


@pytest.mark.parametrize("cell", sorted(FROZEN["counts"]))
def test_the_work_counts_read_as_recorded(cell):
    want = FROZEN["counts"][cell]
    c = spec.load_cell(cell)
    dims = c.model.layer_dims(c.config, c.traffic)
    assert dims == want["dims"]
    got = c.model.epoch_counts(c.config, dims, want["nodes"], want["edges"])
    assert got == {k: want[k] for k in ("flops", "agg_flops", "agg_bytes")}


GIN_CONFIG = {"name": "gin-2l-h16", "model": "gin", "num_layers": 2, "hidden": 16,
              "dropout": 0.5, "lr": 0.01, "dtype": "float32", "hoist": True, "reduced": []}


def _files(directory: Path) -> dict:
    return {p.relative_to(directory): p.read_bytes() for p in directory.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_model_added_as_files_alone_is_correct(tmp_path):
    root = cells.copy_root(tmp_path)
    bench_dir = root / "benchmark"
    before = _files(bench_dir)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = {Path("models/gin.py"): (HERE / "gin_model.py").read_text(),
           Path("configs/gin-2l-h16.json"): json.dumps(GIN_CONFIG),
           Path("traffic/tiny-gin.json"): json.dumps(cells.small_traffic("powerlaw")),
           Path("workloads/gin-tiny.json"): (bench_dir / "workloads/gcn-amazon0505.json")
           .read_text()}
    for path, text in new.items():
        (bench_dir / path).write_text(text)
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({"name": "gin-2l-h16", "source": "test",
                             "file": "benchmark/configs/gin-2l-h16.json", "reduced": [],
                             "why": "test"})
    grown["workloads"].append({"name": "gin-tiny", "config": "gin-2l-h16",
                               "traffic": "tiny-gin", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(grown))

    cell = spec.load_cell("gin-tiny", root)
    assert not cell.model.WEIGHTED_TRAFFIC
    result, checks = run.run_cell(cell, 7, 0.2, True, CPU, root)
    assert result["correct"], checks
    assert "prep_host_ms" in result["metrics"]
    lines = calibrate.main(["--workload", "gin-tiny", "--seeds", "21-21", "--control", "1",
                            "--fault", "1", "--device", "cpu", "--root", str(root)])
    for line in lines:
        ok = all(correct.passes(line["gaps"][k], cell.limits[k]) for k in correct.NAMES)
        assert ok == (line["kind"] == "program"), line

    after = _files(bench_dir)
    assert set(after) - set(before) == set(new)
    assert {k: after[k] for k in before} == before
    final = json.loads((root / "BENCHMARK.json").read_text())
    for key, value in bench.items():
        if isinstance(value, list):
            assert final[key][:len(value)] == value, key
        else:
            assert final[key] == value, key


def _torch_adam(cell, config, weights, x, y, graph, dropout_seed: int, decay: float):
    """Three float64 steps of ``torch.optim.Adam(weight_decay=decay)`` over the model's
    forward pass and dropout masks: the losses, the first gradient as Adam got it, and
    each leaf's change."""
    model = cell.model
    p = {k: v.double().clone().requires_grad_(True) for k, v in weights.items()}
    opt = torch.optim.Adam(list(p.values()), lr=float(config["lr"]),
                           betas=reference.ADAM_BETAS, eps=reference.ADAM_EPS,
                           weight_decay=decay)
    gen = torch.Generator(device=CPU).manual_seed(dropout_seed)
    x = x.double()
    fixed = model.prepare(config, x, graph)
    losses, grad = [], {}
    for t in range(3):
        masks = model.dropout_masks(config, graph.num_nodes, gen, CPU)
        opt.zero_grad()
        loss = F.nll_loss(model.forward(config, p, x, graph, masks, fixed), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if t == 0:
            beta1 = reference.ADAM_BETAS[0]
            grad = {k: opt.state[v]["exp_avg"] / (1 - beta1) for k, v in p.items()}
    change = {k: p[k].detach() - weights[k].double() for k in p}
    return losses, grad, change


@pytest.mark.parametrize("cell", ["gcn-tiny", "agnn-tiny"])
def test_weight_decay_follows_torch_adam(cell, tmp_path):
    c = spec.load_cell(cell, cells.copy_root(tmp_path))
    decay = 0.05
    config = {**c.config, "optimizer": {"weight_decay": decay}}
    _, x, y, graph = _inputs(c, 9)
    weights = c.model.make_weights(config, c.model.layer_dims(config, c.traffic), 11, CPU)
    got = reference.train(config, c.model, weights, x, y, graph, 12, 3)
    losses, grad, change = _torch_adam(c, config, weights, x, y, graph, 12, decay)
    plain = reference.train(c.config, c.model, weights, x, y, graph, 12, 3)
    close = {"rtol": 1e-10, "atol": 1e-13}
    torch.testing.assert_close(got.losses, losses, **close)
    for k in weights:
        torch.testing.assert_close(got.grad[k], grad[k], **close)
        torch.testing.assert_close(got.change[k], change[k], **close)
    # The decay moves the parameters by far more than the two loops differ.
    moved = max(float((plain.change[k] - change[k]).abs().max()) for k in weights)
    apart = max(float((got.change[k] - change[k]).abs().max()) for k in weights)
    assert moved > 1e4 * max(apart, 1e-16), (moved, apart)


def test_the_program_passes_optimizer_settings_only_where_stated(tmp_path, monkeypatch):
    from tcgnn_tpu_torch import train

    calls, make = [], train.make_optimizer

    def recording(params, lr, device, **settings):
        calls.append(settings)
        return make(params, lr, device)

    monkeypatch.setattr(train, "make_optimizer", recording)
    c = spec.load_cell("gcn-tiny", cells.copy_root(tmp_path))
    data, x, y, _ = _inputs(c, 1)
    dims = c.model.layer_dims(c.config, c.traffic)
    graph, _ = program.build_graph(c.config, c.model, data, CPU)
    weights = c.model.make_weights(c.config, dims, 3, CPU)
    for config in (c.config, {**c.config, "optimizer": {"weight_decay": 5e-4}}):
        program.build(config, c.model, dims, graph, x, y, weights, 4)
    assert calls == [{}, {"weight_decay": 5e-4}]
