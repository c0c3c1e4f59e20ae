"""The device-side epoch chain (``train.TrainStep.many``) against the JAX
package's ``step.many`` and against one step a call.

JAX's ``make_train_step(...).many(params, opt_state, key, n)`` runs n
epochs in one compiled program (``lax.fori_loop``); the port's ``many(n)``
replays one CUDA graph of the step on the card and is n calls of the step
on the CPU.  Here, on the CPU (Pallas in interpret mode): chunks of 9 then
11 epochs, dropout off, from JAX's parameters, match JAX's chunks at
``rtol=1e-4`` (the tolerance of ``test_adam_trajectory_matches_jax``: Adam
divides by the root of the second moment, which magnifies last-bit
differences of the gradients), for GCN and GIN with and without the hoist
and a 2-layer AGNN (score-fused and per-edge); ``many(n)`` equals n calls
bit for bit with dropout 0.5 and runs n steps' plain versions; the
trainer's loop (``timed_epochs``) takes JAX's shape, and a run resumed from
a checkpoint still ends bit-equal to an uninterrupted one.

The mesh's step (``parallel.make_distributed_train_step``) is a
``TrainStep`` too, JAX's one compiled step a call: in one process on the
CPU its ``many(n)`` is n calls bit for bit (dropout 0.5, GCN and AGNN, 4x1
and 2x2), and chained epochs from JAX's parameters match JAX's mesh step
called as many times, on its 8 virtual CPU devices, at ``rtol=1e-4`` (the
tolerance of ``tests/test_torch_dist_train.py``'s mesh steps).  The epoch
ledger times its epochs through ``many``.  The capture and the replays
themselves run only on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import init_distributed_net as jax_init_distributed_net
from tcgnn_tpu.parallel import make_distributed_train_step as jax_make_mesh_step
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu.train import make_train_step as jax_make_train_step
from tcgnn_tpu_torch import train
from tcgnn_tpu_torch.bench import epoch_ledger
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, init_net
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
)

N, CLASSES, HIDDEN, DIM = 150, 4, 16, 24
CHUNKS = (9, 11)


def edges(symmetric):
    src, dst = powerlaw_graph(N, 800, seed=3)
    if not symmetric:  # directed: the backward needs A^T
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    return coo_to_csr(src, dst, N)


@pytest.fixture(scope="module", params=[False, True], ids=["directed", "symmetric"])
def graph_pair(request):
    """The port's and JAX's graphs of one edge set on the condensed route."""
    rp, ci = edges(request.param)
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=16), device="cpu",
                   weighted_traffic=True, block_diag=False)
    jg = JaxTiledGraph(rp, ci, N, JaxTileConfig(blk_h=16, blk_w=16), dense_tiles=True,
                       block_diag=False)
    assert g.symmetric == request.param
    return g, jg


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((N, DIM)) * 0.3).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    return x, y


def port_step(g, kind, x, y, params=None, dropout=0.0, hoist=True, seed=4):
    """The port's step from JAX's parameters (or a seeded draw)."""
    net = GNN(kind, [DIM, HIDDEN, CLASSES])
    if params is None:
        params = jax_nets.init_net(jax.random.PRNGKey(seed), kind, DIM, HIDDEN, CLASSES, 2,
                                   init="uniform")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    return train.make_train_step(
        g, net, torch.from_numpy(x), torch.from_numpy(y).long(),
        train.make_optimizer(net.parameters(), 0.01, "cpu"), dropout_rate=dropout,
        hoist=hoist, generator=torch.Generator().manual_seed(5)), net


@pytest.mark.parametrize("kind,hoist", [("gcn", False), ("gcn", True), ("gin", False),
                                        ("gin", True), ("agnn", True)])
def test_many_matches_jax_many(graph_pair, data, kind, hoist):
    """Chunks of 9 then 11 epochs: the loss each chunk returns (its last
    epoch's) against JAX's ``step.many`` over the same chunks."""
    g, jg = graph_pair
    x, y = data
    params = jax_nets.init_net(jax.random.PRNGKey(4), kind, DIM, HIDDEN, CLASSES, 2,
                               init="uniform")
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jg, kind, jnp.asarray(x), jnp.asarray(y), opt,
                                dropout_rate=0.0, hoist=hoist)
    state, key, want = opt.init(params), jax.random.PRNGKey(0), []
    for n in CHUNKS:
        params_n, state, key, loss = jstep.many(params, state, key, n)
        params = params_n
        want.append(float(loss))

    step, _ = port_step(g, kind, x, y, jax_nets.init_net(
        jax.random.PRNGKey(4), kind, DIM, HIDDEN, CLASSES, 2, init="uniform"), hoist=hoist)
    got = [float(step.many(n)) for n in CHUNKS]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and step.captures == 0


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
@pytest.mark.parametrize("n", [1, 7])
def test_many_is_n_steps_bit_for_bit(graph_pair, data, kind, n):
    """On the CPU ``many(n)`` is n calls: with dropout 0.5 the same loss and
    parameters bit for bit, and n steps' plain versions."""
    g, _ = graph_pair
    x, y = data
    one, net_one = port_step(g, kind, x, y, dropout=0.5, hoist=False)
    chained, net_chained = port_step(g, kind, x, y, dropout=0.5, hoist=False)
    plain = {w: w.plain_calls for w in _kernels.COUNTED}
    want = one()
    per_step = {w: w.plain_calls - plain[w] for w in _kernels.COUNTED}
    for _ in range(n - 1):
        want = one()
    plain = {w: w.plain_calls for w in _kernels.COUNTED}
    got = chained.many(n)
    assert torch.equal(got, want)
    for a, b in zip(net_chained.parameters(), net_one.parameters()):
        assert torch.equal(a, b)
    assert any(per_step.values())
    assert {w: w.plain_calls - plain[w] for w in _kernels.COUNTED} == {
        w: n * c for w, c in per_step.items()}
    assert chained.eager_steps == n and chained.captures == 0


def test_many_takes_at_least_one_epoch(graph_pair, data):
    step, _ = port_step(graph_pair[0], "gcn", *data)
    with pytest.raises(ValueError, match="at least 1"):
        step.many(0)


def test_step_takes_any_adam_on_the_cpu(graph_pair, data):
    """Every one-device step is a ``TrainStep``; on the CPU, and for an
    ``eager`` step, ``many`` is calls of the step, so the CPU's Adam (not
    capturable) and a plain Adam both serve, and nothing is captured."""
    g, _ = graph_pair
    x, y = data
    net = init_net(torch.Generator().manual_seed(4), "gcn", DIM, HIDDEN, CLASSES, 2)
    opt = train.make_optimizer(net.parameters(), 0.01, "cpu")
    assert not opt.param_groups[0]["capturable"]
    args = (g, net, torch.from_numpy(x), torch.from_numpy(y).long())
    for optimizer in (opt, torch.optim.Adam(net.parameters(), lr=0.01)):
        for eager in (False, True):
            step = train.make_train_step(*args, optimizer, 0.0, eager=eager)
            assert isinstance(step, train.TrainStep) and not step.replays
            assert torch.isfinite(step.many(2)) and torch.isfinite(step())
            assert (step.eager_steps, step.captures) == (3, 0)


class FakeStep(train.TrainStep):
    """Records the calls ``timed_epochs`` makes of a ``TrainStep``."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self):
        self.calls.append("step")
        return torch.tensor(float(len(self.calls)))

    def many(self, n):
        self.calls.append(n)
        return torch.tensor(float(len(self.calls)))


def eager_step(calls):
    """An ``eager`` ``TrainStep`` (as a mesh step over processes is) whose
    epoch records itself."""
    def epoch():
        calls.append("step")
        return torch.tensor(float(len(calls)))

    return train.TrainStep(epoch, [], None, None, torch.device("cpu"), eager=True)


@pytest.mark.parametrize("epochs,every,resumed_at,calls", [
    (21, None, None, ["step", 8, 21]),
    (12, 5, None, ["step", 8, 5, 5, 2]),
    (12, 5, 6, ["step", 3, 2]),
    (12, 5, 9, ["step", 2]),
    (12, 1, 10, ["step", 1]),
])
def test_timed_epochs_takes_jax_loop_shape(epochs, every, resumed_at, calls):
    """The first epoch is one call, the other warm-up epochs one ``many``,
    every checkpoint piece one ``many``; a resumed run's first piece starts
    with its first epoch's call.  An ``eager`` step (a mesh step over
    processes) runs the same epochs, one call each."""
    args = argparse.Namespace(epochs=epochs, checkpoint_every=every or 50, profile_dir=None)
    written = []
    ckpt = None if every is None else written.append
    for chained in (True, False):
        got = []
        step = FakeStep(got) if chained else eager_step(got)
        first, _, _, _ = train.timed_epochs(step, args, torch.device("cpu"), lambda: None,
                                            ckpt, resumed_at)
        epochs_run = epochs - (resumed_at or 0) + (0 if resumed_at else train.WARMUP_EPOCHS)
        if chained:
            assert got == calls
        else:
            assert got == ["step"] * epochs_run
        assert first == 1.0
    if every is not None:
        assert written == 2 * ([e for e in range((resumed_at or 0) + 1, epochs + 1)
                                if e % every == 0] + ([epochs] if epochs % every else []))


RUN = ["--dataset", "rand_600_3000", "--dim", "8", "--classes", "3", "--hidden", "8",
       "--model", "gcn", "--blk_h", "32", "--blk_w", "32", "--device", "cpu"]


@pytest.mark.parametrize("every,stop", [(1, 3), (3, 7), (4, 4)])
def test_resumed_run_is_bit_equal(tmp_path, every, stop):
    """``--checkpoint_every`` pieces through ``many``: a run stopped at
    ``stop`` epochs and resumed to 11 ends with the uninterrupted run's
    loss and parameters bit for bit (dropout on)."""
    ck = str(tmp_path / "ck")
    args = [*RUN, "--checkpoint_dir", ck, "--checkpoint_every", str(every)]
    train.main([*args, "--epochs", str(stop)])
    resumed = train.main([*args, "--epochs", "11", "--resume",
                          "--save_params", str(tmp_path / "resumed.pt")])
    whole = train.main([*RUN, "--epochs", "11", "--save_params", str(tmp_path / "whole.pt")])
    assert resumed["resumed_at"] == stop
    assert resumed["final_loss"] == whole["final_loss"]
    pa = torch.load(tmp_path / "resumed.pt", weights_only=True)["params"]
    pb = torch.load(tmp_path / "whole.pt", weights_only=True)["params"]
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert whole["captures"] == 0


# ---- the mesh's step (``parallel.make_distributed_train_step``) ---------------------

MESH_N, MESH_DIM, MESH_CLASSES = 240, 20, 5
MESH_CFG = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)
MESH_CHUNKS = (3, 2)


@pytest.fixture(scope="module")
def mesh_data():
    """A symmetric graph of a few hundred nodes (AGNN takes the fused
    path), its features and labels."""
    src, dst = powerlaw_graph(MESH_N, 1500, seed=8)
    ptr, idx = coo_to_csr(src, dst, MESH_N)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((MESH_N, MESH_DIM)).astype(np.float32)
    y = rng.integers(0, MESH_CLASSES, MESH_N).astype(np.int64)
    return ptr, idx, x, y


@pytest.fixture(scope="module", params=[(4, 1), (2, 2)], ids=["4x1", "2x2"])
def mesh_graph(request, mesh_data):
    ptr, idx, x, y = mesh_data
    return DistributedTiledGraph(ptr, idx, MESH_N, make_mesh(*request.param, "cpu"), MESH_CFG)


def mesh_step(g, kind, x, y, dropout=0.5, params=None):
    """The port's mesh step on ``g``: ``init_distributed_net``'s draws, or
    JAX's parameters (numpy)."""
    if params is None:
        net, _, _ = init_distributed_net(torch.Generator().manual_seed(7), kind, MESH_DIM, 8,
                                         MESH_CLASSES, 2, g)
    else:
        net = GNN(kind, [g.feature_width(MESH_DIM)] + [p["weights"].shape[1] for p in params])
        net.params_from_jax(params)
    step = make_distributed_train_step(
        g, net, g.shard_features(x), g.shard_nodes(y),
        train.make_optimizer(net.parameters(), 0.01, "cpu"), dropout_rate=dropout,
        num_valid_classes=MESH_CLASSES, generator=torch.Generator().manual_seed(11))
    return step, net


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_mesh_many_is_n_steps_bit_for_bit(mesh_graph, mesh_data, kind):
    """The one-process mesh's step is a ``TrainStep`` that would capture on
    the card; on the CPU its ``many(n)`` is n calls: with dropout 0.5 the
    same loss and parameters bit for bit, and n steps' plain versions."""
    _, _, x, y = mesh_data
    n = 3
    one, net_one = mesh_step(mesh_graph, kind, x, y)
    chained, net_chained = mesh_step(mesh_graph, kind, x, y)
    assert isinstance(chained, train.TrainStep) and not chained.eager
    plain = {w: w.plain_calls for w in _kernels.COUNTED}
    want = one()
    per_step = {w: w.plain_calls - plain[w] for w in _kernels.COUNTED}
    for _ in range(n - 1):
        want = one()
    plain = {w: w.plain_calls for w in _kernels.COUNTED}
    got = chained.many(n)
    assert torch.equal(got, want)
    for a, b in zip(net_chained.parameters(), net_one.parameters()):
        assert torch.equal(a, b)
    assert any(per_step.values())
    assert {w: w.plain_calls - plain[w] for w in _kernels.COUNTED} == {
        w: n * c for w, c in per_step.items()}
    assert (chained.eager_steps, chained.captures) == (n, 0)


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_mesh_many_matches_jax_steps(mesh_data, kind):
    """Chunks of 3 then 2 epochs of the port's 2x2 mesh step (``many``) from
    JAX's parameters, no dropout: the loss each chunk returns against JAX's
    mesh step (one compiled program a call) after as many calls."""
    ptr, idx, x, y = mesh_data
    jg = JaxDistributedTiledGraph(ptr, idx, MESH_N, jax_make_mesh(2, 2),
                                  JaxTileConfig(blk_h=32, blk_w=32, edge_chunk=32))
    xs = jg.shard_features(x)
    params, _, _ = jax_init_distributed_net(jax.random.PRNGKey(3), kind, xs.shape[1], 8,
                                            MESH_CLASSES, 2, jg)
    numpy_params = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    opt = optax.adam(0.01)
    jstep = jax_make_mesh_step(jg, kind, xs, jg.shard_nodes(y.astype(np.int32)), opt,
                               dropout_rate=0.0, num_valid_classes=MESH_CLASSES)
    state, key, want = opt.init(params), jax.random.PRNGKey(1), []
    for n in MESH_CHUNKS:
        for _ in range(n):
            params, state, key, loss = jstep(params, state, key)
        want.append(float(loss))

    g = DistributedTiledGraph(ptr, idx, MESH_N, make_mesh(2, 2, "cpu"), MESH_CFG)
    step, _ = mesh_step(g, kind, x, y, dropout=0.0, params=numpy_params)
    got = [float(step.many(n)) for n in MESH_CHUNKS]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and step.captures == 0


def test_ledger_times_epochs_through_many(monkeypatch):
    """The epoch ledger's epoch stages (the real graph's and
    ``dense_rest``'s) run ``step.many``: ``WARMUP`` epochs, then
    ``--epochs``, as the JAX ledger times ``step.many`` chains."""
    calls = []
    many = train.TrainStep.many

    def recorded(self, n):
        calls.append(n)
        return many(self, n)

    monkeypatch.setattr(train.TrainStep, "many", recorded)
    rows = epoch_ledger.main(["--datasets", "rand_300_1500", "--epochs", "3", "--reorder",
                              "none", "--blk_h", "32", "--blk_w", "32", "--out",
                              os.devnull, "--device", "cpu"])
    assert calls == [epoch_ledger.WARMUP, 3] * 2
    assert rows[0]["epoch_ms"] > 0 and rows[0]["dense_rest_ms"] > 0
