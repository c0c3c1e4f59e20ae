"""The port's distributed training step, trainer and route gates.

* With JAX's parameters (``GNN.params_from_jax``), the same features and
  labels and no dropout, the port's 4x2 training step gives the JAX
  ``make_distributed_train_step``'s losses over 5 Adam steps (GCN, GIN,
  AGNN), at ``rtol=1e-4`` (as the single-device trajectory test: Adam
  divides by the root of the second moment, which magnifies last-bit
  differences of the gradients);
* the port's mesh, from ``init_distributed_net``, trains the same model as
  one device from the same generator: the same 5 losses at ``rtol=1e-4``;
* ``num_valid_classes`` masks padded classes out of the log-softmax;
* a graph headed for a route not ported yet raises ``NotImplementedError``
  naming its ROADMAP entry: block-diagonal (8a), streamed and the chunk
  fallback (8b); so do a mesh over several cards and, without a card,
  ``--mesh`` on ``--device cuda`` (``RuntimeError``).
"""

import types

import jax
import numpy as np
import optax
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import init_distributed_net as jax_init_distributed_net
from tcgnn_tpu.parallel import make_distributed_train_step as jax_make_step
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, init_net
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
)

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
JCFG = JaxTileConfig(blk_h=16, blk_w=16, edge_chunk=16)
N, CLASSES, HIDDEN, STEPS = 240, 5, 8, 5


@pytest.fixture(scope="module")
def graphs():
    src, dst = powerlaw_graph(N, 1500, seed=8)  # symmetric: AGNN takes the fused path
    ptr, idx = coo_to_csr(src, dst, N)
    jg = JaxDistributedTiledGraph(ptr, idx, N, jax_make_mesh(4, 2), JCFG)
    pg = DistributedTiledGraph(ptr, idx, N, make_mesh(4, 2, "cpu"), CFG)
    assert pg.agnn_aggregate is not None and jg.agnn_aggregate is not None
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, 20)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    return ptr, idx, jg, pg, x, y


@pytest.mark.parametrize("kind", ["gcn", "gin", "agnn"])
def test_train_step_matches_jax(graphs, kind):
    _, _, jg, pg, x, y = graphs
    xs, ys = jg.shard_features(x), jg.shard_nodes(y)
    params, hidden_p, classes_p = jax_init_distributed_net(
        jax.random.PRNGKey(3), kind, xs.shape[1], HIDDEN, CLASSES, 2, jg)
    opt = optax.adam(0.01)
    step = jax_make_step(jg, kind, xs, ys, opt, dropout_rate=0.0, num_valid_classes=CLASSES)
    state, key, want = opt.init(params), jax.random.PRNGKey(1), []
    net = GNN(kind, [xs.shape[1], hidden_p, classes_p], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    for _ in range(STEPS):
        params, state, key, loss = step(params, state, key)
        want.append(float(loss))

    pstep = make_distributed_train_step(
        pg, net, pg.shard_features(x), pg.shard_nodes(y.astype(np.int64)),
        torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.0,
        num_valid_classes=CLASSES)
    got = [float(pstep()) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_mesh_trains_the_single_device_model(graphs, kind):
    ptr, idx, _, pg, x, y = graphs
    net_d, _, classes_p = init_distributed_net(torch.Generator().manual_seed(7), kind, 20, 7,
                                               CLASSES, 2, pg)
    assert classes_p == 6 and net_d.weights[0].shape == (256, 8)
    step_d = make_distributed_train_step(
        pg, net_d, pg.shard_features(x), pg.shard_nodes(y.astype(np.int64)),
        torch.optim.Adam(net_d.parameters(), lr=0.01), dropout_rate=0.0,
        num_valid_classes=CLASSES)
    g = TiledGraph(ptr, idx, N, CFG, device="cpu")
    net_s = init_net(torch.Generator().manual_seed(7), kind, 20, 7, CLASSES, 2)
    step_s = port_train.make_train_step(
        g, net_s, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.optim.Adam(net_s.parameters(), lr=0.01), dropout_rate=0.0)
    got = [float(step_d()) for _ in range(STEPS)]
    want = [float(step_s()) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_num_valid_classes_masks_padded_classes(graphs):
    *_, pg, x, _ = graphs
    net = init_net(torch.Generator().manual_seed(2), "gcn", 256, 8, 6, 2)
    xs = pg.shard_features(x)
    with torch.no_grad():
        padded = net(xs, pg, num_valid_classes=5)
        net.weights[1].data = net.weights[1][:, :5].clone()
        plain = net(xs, pg)
    assert torch.all(padded[:, 5] < -1e29)
    torch.testing.assert_close(padded[:, :5], plain, rtol=1e-6, atol=1e-6)


# ---- route gates ---------------------------------------------------------------

def banded_csr(n=1000, half_band=40, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 6 * n)
    dst = np.clip(src + rng.integers(-half_band, half_band + 1, len(src)), 0, n - 1)
    return coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)


def test_block_diagonal_graph_raises():
    ptr, idx = banded_csr()
    with pytest.raises(NotImplementedError, match=r"block-diagonal.*ROADMAP.md, Queue 1 item 8a"):
        DistributedTiledGraph(ptr, idx, 1000, make_mesh(2, 1, "cpu"), TileConfig())
    # The dataset entry point leaves a BD-bound graph unbalanced, then raises.
    ds = types.SimpleNamespace(row_pointers=ptr, column_index=idx.copy(), num_nodes=1000)
    with pytest.raises(NotImplementedError, match="item 8a"):
        distributed_graph_from_dataset(ds, make_mesh(2, 1, "cpu"), TileConfig())
    np.testing.assert_array_equal(ds.column_index, idx)


def test_streamed_graph_raises(graphs, monkeypatch):
    from tcgnn_tpu_torch.sgt import stream

    ptr, idx, *_ = graphs
    monkeypatch.setattr(stream, "MAX_PREFETCH_CHUNKS", 4)
    with pytest.raises(NotImplementedError, match=r"streamed.*ROADMAP.md, Queue 1 item 8b"):
        DistributedTiledGraph(ptr, idx, N, make_mesh(4, 2, "cpu"), CFG)


def test_chunk_fallback_raises(graphs):
    ptr, idx, *_ = graphs
    with pytest.raises(NotImplementedError, match=r"chunk fallback.*ROADMAP.md, Queue 1 item 8b"):
        DistributedTiledGraph(ptr, idx, N, make_mesh(4, 2, "cpu"), CFG, dense_tiles=False)


def test_mesh_over_several_cards_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 8"):
        make_mesh(2, 1, ["cuda:0", "cuda:1"])


def test_cli_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--dataset", "rand_600_3000", "--mesh", "4x2", "--device", "cuda"])


@pytest.mark.parametrize("mesh,model", [("4x2", "gcn"), ("4x2", "agnn"), ("8x1", "agnn")])
def test_cli_mesh_prints_contract(capsys, mesh, model):
    r = port_train.main([
        "--dataset", "rand_600_3000", "--dim", "12", "--classes", "3", "--epochs", "3",
        "--blk_h", "16", "--blk_w", "16", "--device", "cpu", "--mesh", mesh, "--model", model,
        "--hidden", "8", "--eval",
    ])
    out = capsys.readouterr().out
    for line in ("TC_Blocks:", "Exp_Edges:", "Prep. (ms):", "Route:", "Final loss:",
                 "Train (ms):", "Acc train:"):
        assert line in out
    assert f"mesh={mesh}" in r["route"] and np.isfinite(r["final_loss"])
    assert r["tc_blocks"] > 0 and r["final_loss"] < r["first_loss"]


def test_cli_mesh_no_balance_keeps_the_order(capsys):
    """``--no_balance`` partitions the graph in its own order; the balance
    moves whole windows, so TC_Blocks stays and the heaviest shard's block
    count does not grow."""
    args = ["--dataset", "rand_600_3000", "--dim", "12", "--classes", "3", "--epochs", "1",
            "--blk_h", "16", "--blk_w", "16", "--device", "cpu", "--mesh", "4x1"]
    balanced = port_train.main(args)["graph"]
    kept = port_train.main(args + ["--no_balance"])["graph"]
    ptr = np.asarray(synthesize("rand_600_3000", 12, 3, seed=0).row_pointers)
    rows = np.minimum(np.arange(5) * kept.rows_per_shard, 600)
    np.testing.assert_array_equal(kept.host_fwd.edge_start, ptr[rows])
    assert not np.array_equal(balanced.host_fwd.edge_start, ptr[rows])
    assert balanced.tc_blocks == kept.tc_blocks

    def heaviest(g):
        return int(np.bincount(np.repeat(np.arange(4), np.diff(g.host_fwd.edge_start))).max())

    assert heaviest(balanced) <= heaviest(kept)
