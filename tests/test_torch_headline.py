"""The port's headline bench (``tcgnn_tpu_torch.bench.headline``) against the
repository's ``bench.py`` and the JAX package.

``bench.py`` is read with ``ast``, never imported or run: the port's line
has its keys in its order, plus ``dtype``.  A cut CPU run prints that line
last.  The headline's training step on the full pubmed graph (JAX's
parameters carried across, dropout off) follows JAX's ``make_train_step``
for 3 Adam steps, with and without the hoist, in f32 at ``rtol=1e-4`` (as
``test_torch_train.py``) and in bf16 at ``rtol=1e-3`` (the bf16 tiles and
GEMMs round alike on both sides; only the order of summation differs).
"""

import ast
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.synthetic import synthesize as jax_synthesize
from tcgnn_tpu.graph import tiled_graph_from_dataset as jax_tiled_graph_from_dataset
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.train import make_train_step as jax_make_train_step
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.bench import headline
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import synthesize
from tcgnn_tpu_torch.graph import tiled_graph_from_dataset
from tcgnn_tpu_torch.models import GNN, init_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ["--device", "cpu", "--epochs", "3", "--reps", "1", "--warmup", "1"]
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-4), "bf16": (torch.bfloat16, jnp.bfloat16, 1e-3)}


def bench_py_keys() -> list:
    """The keys, in order, of the dict literal inside ``bench.py``'s
    ``json.dumps`` call."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    (keys,) = [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
               if isinstance(node, ast.Call) and ast.unparse(node.func) == "json.dumps"]
    return keys


@pytest.fixture(scope="module")
def datasets():
    return synthesize("pubmed", seed=0), jax_synthesize("pubmed", seed=0)


@pytest.fixture(scope="module")
def graphs(datasets):
    """The port's and JAX's pubmed graph at a compute dtype, built once."""
    ds, jds = datasets
    built = {}

    def get(name):
        if name not in built:
            tdt, jdt, _ = DTYPES[name]
            built[name] = (tiled_graph_from_dataset(ds, TileConfig(compute_dtype=tdt),
                                                    device="cpu"),
                           jax_tiled_graph_from_dataset(jds, JaxTileConfig(compute_dtype=jdt)))
        return built[name]

    return get


@pytest.fixture(scope="module")
def cut_run():
    """The cut CPU run's line and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = headline.main(CUT)
    return line, out.getvalue().strip().splitlines()


def test_line_has_bench_py_keys_then_dtype(cut_run):
    keys = bench_py_keys()
    assert len(keys) == 11 and keys[:2] == ["metric", "value"]
    assert list(cut_run[0]) == keys + ["dtype"]


def test_line_is_last_output(cut_run):
    line, out = cut_run
    assert json.loads(out[-1]) == line
    assert all(ln.startswith("# ") for ln in out[:-1])
    assert sum("1 reps of 3 epochs, ms an epoch: [" in ln for ln in out) == 2


def test_cut_cpu_run(cut_run, datasets, graphs):
    line = cut_run[0]
    assert line["backend"] == "cpu" and line["dtype"] == "float32"
    assert line["metric"] == "gcn_pubmed_epoch_ms" and line["unit"] == "ms"
    assert line["agnn_pubmed_epoch_ms"] is None
    assert line["value"] > 0 and line["value_hoisted_default"] > 0
    assert line["prep_ms"] > 0 and line["prep_warm_ms"] > 0
    assert line["vs_baseline"] == round(line["vs_baseline"], 3)
    assert abs(line["vs_baseline"] - 2.793 / line["value"]) <= 5.01e-4
    assert line["tc_blocks"] == graphs("f32")[1].tc_blocks == 334

    # The first loss of the same schedule: the same parameters and dropout
    # masks, one step.
    ds, _ = datasets
    g = graphs("f32")[0]
    net = init_net(torch.Generator().manual_seed(0), "gcn", ds.num_features, 16,
                   ds.num_classes, 2)
    step = port_train.make_train_step(
        g, net, torch.from_numpy(ds.x), torch.from_numpy(ds.y.astype(np.int64)),
        torch.optim.Adam(net.parameters(), lr=0.01), 0.5, hoist=False,
        generator=torch.Generator().manual_seed(1))
    first_loss = float(step())
    assert np.isfinite(line["final_loss"]) and line["final_loss"] < first_loss


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hoist", [False, True])
def test_headline_step_matches_jax(datasets, graphs, dtype, hoist):
    """JAX's ``init_net(PRNGKey(0))`` carried across, dropout 0, 3 Adam
    steps at 0.01: the headline's model on the full pubmed graph."""
    (ds, jds), (g, jg) = datasets, graphs(dtype)
    rtol = DTYPES[dtype][2]
    params = jax_nets.init_net(jax.random.PRNGKey(0), "gcn", 500, 16, 3, 2)
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jg, "gcn", jnp.asarray(jds.x),
                                jnp.asarray(jds.y.astype(np.int32)), opt, dropout_rate=0.0,
                                hoist=hoist)
    state, key, want = opt.init(params), jax.random.PRNGKey(0), []
    net = GNN("gcn", [500, 16, 3], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    for _ in range(3):
        params, state, key, loss = jstep(params, state, key)
        want.append(float(loss))

    step = port_train.make_train_step(
        g, net, torch.from_numpy(ds.x), torch.from_numpy(ds.y.astype(np.int64)),
        torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.0, hoist=hoist)
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]


def test_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main(["--device", "cuda"])


@pytest.mark.parametrize("argv", [["--epochs", "0"], ["--reps", "0"], ["--warmup", "-1"]])
def test_schedule_must_be_positive(argv):
    with pytest.raises(SystemExit):
        headline.main(["--device", "cpu", *argv])
