"""The cases of ``test_torch_dist_procs.py``, run in every rank of a
process group and, for the one-process references, in the test's own
process.  This module imports no JAX: the ranks start from it.

``run_rank`` is a rank's whole run: it joins the group over a ``file://``
store, runs every case on its graph shards and writes a dict of numpy
results to ``out_dir/rank<r>.pt``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from tcgnn_tpu_torch import train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.models import GNN
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
    make_mesh_two_level,
    step_collective_bytes,
)
from tcgnn_tpu_torch.parallel import collectives
from tcgnn_tpu_torch.parallel.comm_stats import Recorder
from tcgnn_tpu_torch.parallel.mesh import init_process_group

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
# rows_per_shard a multiple of the block-diagonal graph's 128-row bins.
BD_CFG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)
COMM_CFG = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)
D = 16
OPS = ("spmm", "spmm_weighted", "sddmm", "agnn_aggregate")
# Train cases: the graph of tests/test_torch_dist_train.py.
TRAIN_N, TRAIN_DIM, CLASSES, HIDDEN, STEPS = 240, 20, 5, 8, 3
# Count cases: tests/test_torch_comm_stats.py's graph and widths.
COMM_DIM, COMM_CLASSES, COMM_HIDDEN = 16, 4, 8


def mega_csr(n=400, seed=11):
    """A symmetric sparse graph with one dense row window at the front:
    the split stream in both directions on a 4-shard mesh."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    rows = np.repeat(np.arange(n), [len(c) for c in cols])
    cols = np.concatenate(cols)
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return coo_to_csr(rows, cols, n)


def random_csr(n=430, avg_deg=6, seed=3):
    """A directed random graph: its transpose has a layout of its own."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


def powerlaw_csr(n, e, seed):
    return coo_to_csr(*powerlaw_graph(n, e, seed=seed), n)


# route: (graph, nodes, tiles, graph options, route token)
ROUTES = {
    "dense": (mega_csr, 400, CFG, {}, "split bwd=split"),
    "bd": (lambda: coo_to_csr(*component_union_graph(2048, 5200, 64, seed=7), 2048), 2048,
           BD_CFG, {}, "block_diag=True"),
    "streamed": (lambda: powerlaw_csr(430, 2600, 7), 430, CFG,
                 dict(streamed=True, _stream_limits=(8, 384)), "streamed=True"),
    "chunk": (random_csr, 430, CFG, dict(dense_tiles=False), "streamed=False block_diag=False"),
}
OP_CASES = [(route, f) for route in ROUTES for f in (1, 2)]


def op_graph(route: str, f: int) -> DistributedTiledGraph:
    make, n, cfg, kw, _ = ROUTES[route]
    ptr, idx = make()
    return DistributedTiledGraph(ptr, idx, n, make_mesh(4, f, "cpu"), cfg, **kw)


def op_inputs(route: str, f: int, e: int):
    """The ops' inputs and cotangents, over every node and edge."""
    n = ROUTES[route][1]
    rng = np.random.default_rng(10 * len(route) + f)
    x = (0.5 * rng.standard_normal((n, D))).astype(np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    wv = (np.arange(e) % 7 - 3).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    return x, w, wv, att


def run_ops(g: DistributedTiledGraph, x, w, wv, att) -> dict:
    """Each op's forward on this process's rows and every gradient of a
    scalar summed over its real rows (or its edges): node arrays as this
    process's ``[local_nodes, ...]`` rows, edge arrays in CSR order (its
    shards' edges), the attention gradient as this process's part."""
    xs = g.shard_nodes(x)
    ws, wvs = g.edge_weights_to_sharded(w), g.edge_weights_to_sharded(wv)
    real = g.valid_node_mask()[:, None]
    out = {}

    def edge(t):
        return g.gather_edge_vector(t.float())

    def run(name, fn, *args):
        leaves = [a.clone().requires_grad_(True) for a in args]
        value, fwd = fn(*leaves)
        value.backward()
        grads = [edge(t.grad) if t.dim() == 1 else t.grad.float().numpy() for t in leaves]
        out[name] = (edge(fwd) if name == "sddmm" else fwd.detach().float().numpy(), grads)

    run("spmm", lambda xx: ((torch.sin(g.spmm(xx)) * real).sum(), g.spmm(xx)), xs)
    run("spmm_weighted", lambda xx, ww: ((torch.cos(g.spmm_weighted(xx, ww)) * real).sum(),
                                         g.spmm_weighted(xx, ww)), xs, ws)
    run("sddmm", lambda xx: ((g.sddmm(xx) * wvs).sum(), g.sddmm(xx)), xs)
    if g.agnn_aggregate is not None:
        run("agnn_aggregate", lambda xx, aa: ((torch.sin(g.agnn_aggregate(xx, aa)) * real).sum(),
                                              g.agnn_aggregate(xx, aa)), xs, torch.tensor(att))
    return out


def run_collectives(mesh) -> tuple:
    """Every collective over a hand-built 4x2 grid of ``[8, 3]`` members
    (this process's graph rows of it), along both axes: the outputs (numpy,
    this process's rows) and the recorder's counts."""
    rng = np.random.default_rng(5)
    full = [[torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)) for _ in range(2)]
            for _ in range(4)]
    rows = mesh.graph_shards if mesh is not None else range(4)
    grid = [full[g] for g in rows]
    calls = {
        "all_gather graph": lambda: collectives.all_gather(grid, "graph", mesh),
        "all_gather feature": lambda: collectives.all_gather(grid, "feature", mesh),
        # 0 -> 1 stays on a rank of two shards, 1 -> 2 and 3 -> 0 cross.
        "ppermute graph": lambda: collectives.ppermute(grid, [(0, 1), (1, 2), (3, 0)], "graph",
                                                       mesh),
        "ppermute feature": lambda: collectives.ppermute(grid, [(1, 0)], "feature", mesh),
        "all_to_all graph": lambda: collectives.all_to_all(grid, "graph", mesh),
        "psum graph": lambda: collectives.psum(grid, "graph", mesh),
        "psum feature": lambda: collectives.psum(grid, "feature", mesh),
    }
    out = {}
    with collectives.recording(Recorder(num_devices=8)) as rec:
        for name, call in calls.items():
            out[name] = [[t.numpy().copy() for t in row] for row in call()]
    return out, rec.stats


def train_inputs() -> tuple:
    """The training cases' graph (symmetric: AGNN takes the fused path), its
    features and labels: ``(ptr, idx, x, y)``."""
    ptr, idx = powerlaw_csr(TRAIN_N, 1500, 8)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((TRAIN_N, TRAIN_DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, TRAIN_N).astype(np.int64)
    return ptr, idx, x, y


def train_graph(f: int) -> tuple:
    """The training cases' graph on a 4 x f mesh, its features and labels."""
    ptr, idx, x, y = train_inputs()
    return DistributedTiledGraph(ptr, idx, TRAIN_N, make_mesh(4, f, "cpu"), CFG), x, y


def train_steps(kind: str, f: int, params=None, dropout: float = 0.0) -> dict:
    """``STEPS`` Adam steps of the mesh step: from ``params`` (JAX's, numpy)
    or, without them, ``init_distributed_net``'s draws; returns the losses
    and the parameters after the steps."""
    g, x, y = train_graph(f)
    xs = g.shard_features(x)
    if params is None:
        net, _, _ = init_distributed_net(torch.Generator().manual_seed(7), kind, TRAIN_DIM,
                                         HIDDEN, CLASSES, 2, g)
    else:
        net = GNN(kind, [xs.shape[1]] + [p["weights"].shape[1] for p in params], device="cpu")
        net.params_from_jax(params)
    step = make_distributed_train_step(
        g, net, xs, g.shard_nodes(y), torch.optim.Adam(net.parameters(), lr=0.01),
        dropout_rate=dropout, num_valid_classes=CLASSES,
        generator=torch.Generator().manual_seed(11))
    losses = [float(step()) for _ in range(STEPS)]
    return {"losses": losses, "params": [p.detach().numpy().copy() for p in net.parameters()]}


def comm_counts(kind: str) -> dict:
    """The collective traffic of one hoist=False GCN or AGNN step on
    ``rand_4000_32000`` over 4x1 (``tests/test_torch_comm_stats.py``'s row)."""
    ds = synthesize("rand_4000_32000", COMM_DIM, COMM_CLASSES)
    n = ds.num_nodes
    g = DistributedTiledGraph(ds.row_pointers, ds.column_index, n, make_mesh(4, 1, "cpu"),
                              COMM_CFG)
    rng = np.random.default_rng(0)
    x = g.shard_features(rng.standard_normal((n, COMM_DIM)).astype(np.float32))
    y = g.shard_nodes(rng.integers(0, COMM_CLASSES, n).astype(np.int64))
    net, _, _ = init_distributed_net(torch.Generator().manual_seed(0), kind, COMM_DIM,
                                     COMM_HIDDEN, COMM_CLASSES, 2, g)
    step = make_distributed_train_step(g, net, x, y, torch.optim.Adam(net.parameters(), lr=0.01),
                                       0.0, num_valid_classes=COMM_CLASSES, hoist=False)
    stats = step_collective_bytes(step, num_devices=4)
    stats["grad_bytes"] = sum(p.numel() * 4 for p in net.parameters())
    return stats


def run_rank(rank: int, world: int, store: str, out_dir: str, jax_params: dict) -> None:
    """One rank: join the group, run every case, write the results."""
    torch.set_num_threads(1)
    init_process_group("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    res = {"rank": rank}
    res["collectives"] = run_collectives(make_mesh(4, 2, "cpu"))
    for route, f in OP_CASES:
        g = op_graph(route, f)
        res[("route", route, f)] = g.route
        res[("rows", route, f)] = (g.node_rows.start, g.node_rows.stop)
        res[("edges", route, f)] = (int(g.host_fwd.edge_start[g.shards.start]),
                                    int(g.host_fwd.edge_start[g.shards.stop]))
        res[("ops", route, f)] = run_ops(g, *op_inputs(route, f, g.num_edges))
    for kind, params in jax_params.items():
        res[("jax_train", kind)] = train_steps(kind, 2, params)
    res["dropout"] = train_steps("gcn", 2, dropout=0.5)
    for kind in ("gcn", "agnn"):
        res[("comm", kind)] = comm_counts(kind)
    try:
        make_mesh(3 * world // 2, 1, "cpu")
    except ValueError as e:
        res["indivisible"] = str(e)
    small = ["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3", "--device", "cpu"]
    for name, argv in (("no_mesh", small), ("single_kernel", [*small, "--mesh", "4x1",
                                                              "--single_kernel"])):
        try:
            train.main(argv)
        except (ValueError, NotImplementedError) as e:
            res[name] = f"{type(e).__name__}: {e}"
    two = make_mesh_two_level(2, 2, device="cpu")
    res["two_level"] = (two.host, [g // 2 for g in two.graph_shards])
    res["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "tcgnn_tpu"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
