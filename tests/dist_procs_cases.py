"""The cases of ``test_torch_dist_procs.py``, run in every rank of a
process group and, for the one-process references, in the test's own
process.  This module imports no JAX: the ranks start from it.

``run_rank`` is a rank's whole run: it joins the group over a ``file://``
store, runs every case on its shards and writes a dict of numpy results to
``out_dir/rank<r>.pt``.  Two layouts: the graph axis split over the ranks
(``--mesh 4xF``), and one feature shard a rank (``SPLIT``: W = 2 takes
``1x2``, W = 4 takes ``2x2``).  The halo-overlap split's classes run over
the ranks on an unsplit graph of two graph shards (``OVERLAP``: W = 2 takes
``2x1``, one shard a rank; W = 4 takes ``2x2``, one feature shard a rank).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from tcgnn_tpu_torch import train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.bench import measure_comm
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
# The feature-split layout's mesh a world size (W = Wg * F, Wg divides G,
# W does not), and the hand-built grid of its collectives case: its shape
# (W = 4: two graph blocks of 3 shards), its members' rows, its graph-axis
# ppermute pairs (within a rank's block and across).
SPLIT = {2: (1, 2), 4: (2, 2)}
SPLIT_GRID = {2: ((3, 2), 12, [(0, 1), (1, 2), (2, 0)]),
              4: ((6, 2), 12, [(0, 1), (2, 3), (1, 4), (5, 0)])}
GRID_4X2 = ((4, 2), 8, [(0, 1), (1, 2), (3, 0)])
# The overlap cases' mesh a world size: two graph shards, so the halo
# crosses ranks in either layout.
OVERLAP = {2: (2, 1), 4: (2, 2)}
# --single_kernel's chained rounds in these cases.
SAG_ROUNDS = 4
SMALL = ["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3", "--device", "cpu"]
MEASURE_COMM = ["--datasets", "rand_4000_32000", "--shards", "4", "--device", "cpu"]


def mega_csr(n=400, seed=11, hub_rows=16, hub_deg=160, avg_deg=4):
    """A symmetric sparse graph with dense row windows at the front (one by
    default): the split stream in both directions on a 4-shard mesh; with
    three windows of rows of 400 draws and degree 1 elsewhere, on a 2-shard
    mesh too."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    deg[:hub_rows] = hub_deg
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
# One feature shard a rank: the dense route's graph splits its stream over
# 2 graph shards (2x2).
SPLIT_ROUTES = dict(ROUTES, dense=(lambda: mega_csr(hub_rows=48, hub_deg=400, avg_deg=1), 400,
                                   CFG, {}, "split bwd=split"))


def op_graph(route: str, f: int, shape=None) -> DistributedTiledGraph:
    """The route's graph on a 4 x f mesh, or its ``SPLIT_ROUTES`` graph on a
    mesh of ``shape``."""
    make, n, cfg, kw, _ = (ROUTES if shape is None else SPLIT_ROUTES)[route]
    ptr, idx = make()
    return DistributedTiledGraph(ptr, idx, n, make_mesh(*(shape or (4, f)), "cpu"), cfg, **kw)


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
    """Each op's forward on this process's block and every gradient of a
    scalar summed over its real rows (or its edges): node arrays as this
    process's ``[local_nodes, ...]`` rows and its columns (``node_cols``),
    edge arrays in CSR order (its shards' edges), the attention gradient as
    this process's part."""
    _, cols = g.node_cols(x.shape[1] * g.lf // g.pf)
    xs = g.shard_nodes(x)[:, cols].contiguous()
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


def overlap_graph(shape) -> DistributedTiledGraph:
    """``random_csr``'s directed graph without the split stream on a mesh
    of ``shape``: every SpMM and SDDMM takes the overlap classes."""
    ptr, idx = random_csr()
    return DistributedTiledGraph(ptr, idx, len(ptr) - 1, make_mesh(*shape, "cpu"), CFG,
                                 split=False)


def class_waits(g: DistributedTiledGraph, x) -> dict:
    """For one SpMM a direction and one SDDMM on ``g``: K1's and K4's plain
    calls each time an exchange is waited on (``collectives.Started.wait``),
    and after the op."""
    from tcgnn_tpu_torch.ops import reset_counts, sddmm_tc_dense, spmm_tc_dense

    _, cols = g.node_cols(x.shape[1] * g.lf // g.pf)
    xs = g.shard_nodes(x)[:, cols].contiguous()
    seen = []
    wait = collectives.Started.wait

    def recorded(self):
        seen.append((spmm_tc_dense.plain_calls, sddmm_tc_dense.plain_calls))
        return wait(self)

    out = {}
    collectives.Started.wait = recorded
    try:
        for name, op in (("spmm", lambda: g._spmm(xs, g._fwd)),
                         ("transpose", lambda: g._spmm(xs, g._bwd)),
                         ("sddmm", lambda: g.sddmm(xs))):
            reset_counts()
            seen.clear()
            op()
            out[name] = (list(seen), (spmm_tc_dense.plain_calls, sddmm_tc_dense.plain_calls))
    finally:
        collectives.Started.wait = wait
    return out


def run_collectives(mesh, grid_case=GRID_4X2) -> tuple:
    """Every collective over a hand-built grid (``grid_case``: its shape,
    its members' rows of 3 columns, its graph-axis ppermute pairs; this
    process's block of it), along both axes: the outputs (numpy, this
    process's block) and the recorder's counts."""
    (ng, nf), rows, pairs = grid_case
    rng = np.random.default_rng(5)
    full = [[torch.from_numpy(rng.standard_normal((rows, 3)).astype(np.float32))
             for _ in range(nf)] for _ in range(ng)]
    gs = mesh.graph_shards if mesh is not None else range(ng)
    fs = mesh.feature_shards if mesh is not None else range(nf)
    grid = [[full[g][f] for f in fs] for g in gs]
    calls = {
        "all_gather graph": lambda: collectives.all_gather(grid, "graph", mesh),
        "all_gather feature": lambda: collectives.all_gather(grid, "feature", mesh),
        # 4x2 over 2 ranks: 0 -> 1 stays on a rank of two shards, 1 -> 2 and
        # 3 -> 0 cross.
        "ppermute graph": lambda: collectives.ppermute(grid, pairs, "graph", mesh),
        "ppermute feature": lambda: collectives.ppermute(grid, [(1, 0)], "feature", mesh),
        "all_to_all graph": lambda: collectives.all_to_all(grid, "graph", mesh),
        "all_to_all feature": lambda: collectives.all_to_all(grid, "feature", mesh),
        "psum graph": lambda: collectives.psum(grid, "graph", mesh),
        "psum feature": lambda: collectives.psum(grid, "feature", mesh),
        "psum_scatter graph": lambda: collectives.psum_scatter(grid, "graph", mesh),
        "psum_scatter feature": lambda: collectives.psum_scatter(grid, "feature", mesh),
    }
    out = {}
    with collectives.recording(Recorder(num_devices=ng * nf)) as rec:
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


def train_graph(shape) -> tuple:
    """The training cases' graph on a mesh of ``shape``, its features and
    labels."""
    ptr, idx, x, y = train_inputs()
    return DistributedTiledGraph(ptr, idx, TRAIN_N, make_mesh(*shape, "cpu"), CFG), x, y


def train_steps(kind: str, shape, params=None, dropout: float = 0.0) -> dict:
    """``STEPS`` Adam steps of the mesh step on a mesh of ``shape``: from
    ``params`` (JAX's, numpy) or, without them, ``init_distributed_net``'s
    draws; returns the losses and the parameters after the steps."""
    g, x, y = train_graph(shape)
    xs = g.shard_features(x)
    if params is None:
        net, _, _ = init_distributed_net(torch.Generator().manual_seed(7), kind, TRAIN_DIM,
                                         HIDDEN, CLASSES, 2, g)
    else:
        net = GNN(kind, [g.feature_width(TRAIN_DIM)] + [p["weights"].shape[1] for p in params],
                  device="cpu")
        net.params_from_jax(params)
    step = make_distributed_train_step(
        g, net, xs, g.shard_nodes(y), torch.optim.Adam(net.parameters(), lr=0.01),
        dropout_rate=dropout, num_valid_classes=CLASSES,
        generator=torch.Generator().manual_seed(11))
    losses = [float(step()) for _ in range(STEPS)]
    return {"losses": losses, "params": [p.detach().numpy().copy() for p in net.parameters()],
            "eager": step.eager}


class GradRecorder:
    """An optimizer that steps nothing: it keeps the gradients each step
    leaves (the training step's, all-reduced over the ranks)."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        self.grads = [p.grad.detach().numpy().copy() for p in self.params]


# Gradient cases: (model, graph). The training graph takes the fused AGNN;
# the directed one the per-edge AGNN, whose attention weights meet the
# all-reduced edge scores (``count_once``).
GRAD_CASES = [("gcn", "train"), ("agnn", "train"), ("agnn", "directed")]


def step_grads(kind: str, graph: str, shape) -> dict:
    """One training step's loss and gradients (dropout on, every parameter
    drawn by ``init_distributed_net``) on a mesh of ``shape``: the
    training graph, or ``random_csr``'s directed one with the training
    widths."""
    if graph == "train":
        g, x, y = train_graph(shape)
    else:
        ptr, idx = random_csr()
        n = len(ptr) - 1
        g = DistributedTiledGraph(ptr, idx, n, make_mesh(*shape, "cpu"), CFG)
        rng = np.random.default_rng(6)
        x = rng.standard_normal((n, TRAIN_DIM)).astype(np.float32)
        y = rng.integers(0, CLASSES, n).astype(np.int64)
    net, _, _ = init_distributed_net(torch.Generator().manual_seed(7), kind, TRAIN_DIM, HIDDEN,
                                     CLASSES, 2, g)
    opt = GradRecorder(net.parameters())
    step = make_distributed_train_step(g, net, g.shard_features(x), g.shard_nodes(y), opt,
                                       dropout_rate=0.5, num_valid_classes=CLASSES,
                                       generator=torch.Generator().manual_seed(11))
    loss = float(step())
    return {"loss": loss, "grads": opt.grads, "agnn": g.agnn_aggregate is not None}


def comm_counts(kind: str, shape=(4, 1)) -> dict:
    """The collective traffic of one hoist=False GCN or AGNN step on
    ``rand_4000_32000`` over 4x1 (``tests/test_torch_comm_stats.py``'s row)
    or a mesh of ``shape``, with the padded widths and the rows a shard."""
    ds = synthesize("rand_4000_32000", COMM_DIM, COMM_CLASSES)
    n = ds.num_nodes
    g = DistributedTiledGraph(ds.row_pointers, ds.column_index, n, make_mesh(*shape, "cpu"),
                              COMM_CFG)
    rng = np.random.default_rng(0)
    x = g.shard_features(rng.standard_normal((n, COMM_DIM)).astype(np.float32))
    y = g.shard_nodes(rng.integers(0, COMM_CLASSES, n).astype(np.int64))
    net, _, _ = init_distributed_net(torch.Generator().manual_seed(0), kind, COMM_DIM,
                                     COMM_HIDDEN, COMM_CLASSES, 2, g)
    step = make_distributed_train_step(g, net, x, y, torch.optim.Adam(net.parameters(), lr=0.01),
                                       0.0, num_valid_classes=COMM_CLASSES, hoist=False)
    stats = step_collective_bytes(step, num_devices=shape[0] * shape[1])
    stats["grad_bytes"] = sum(p.numel() * 4 for p in net.parameters())
    stats["widths"] = [w.shape[0] for w in net.weights] + [net.weights[-1].shape[1]]
    stats["rows_per_shard"] = g.rows_per_shard
    return stats


def single_kernel(mesh_arg: str) -> dict:
    """``train.main --single_kernel`` on ``SMALL`` over ``--mesh mesh_arg``,
    ``SAG_ROUNDS`` rounds."""
    rounds, train.SAG_ROUNDS = train.SAG_ROUNDS, SAG_ROUNDS
    try:
        return train.main([*SMALL, "--mesh", mesh_arg, "--single_kernel"])
    finally:
        train.SAG_ROUNDS = rounds


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
        res[("jax_train", kind)] = train_steps(kind, (4, 2), params)
    res["dropout"] = train_steps("gcn", (4, 2), dropout=0.5)
    for kind in ("gcn", "agnn"):
        res[("comm", kind)] = comm_counts(kind)
    # One feature shard a rank.
    shape = SPLIT[world]
    mesh = make_mesh(*shape, "cpu")
    res["split mesh"] = (tuple(mesh.graph_shards), tuple(mesh.feature_shards),
                         mesh.graph_world, mesh.feature_world)
    res["split collectives"] = run_collectives(make_mesh(*SPLIT_GRID[world][0], "cpu"),
                                               SPLIT_GRID[world])
    for route in ROUTES:
        g = op_graph(route, 2, shape)
        res[("split route", route)] = g.route
        res[("split rows", route)] = (g.node_rows.start, g.node_rows.stop)
        res[("split cols", route)] = g.node_cols(D // 2)
        res[("split edges", route)] = (int(g.host_fwd.edge_start[g.shards.start]),
                                       int(g.host_fwd.edge_start[g.shards.stop]))
        res[("split ops", route)] = run_ops(g, *op_inputs(route, 2, g.num_edges))
    for kind, params in jax_params.items():
        res[("split jax_train", kind)] = train_steps(kind, shape, params)
    res["split dropout"] = train_steps("gcn", shape, dropout=0.5)
    for kind, graph in GRAD_CASES:
        res[("split grads", kind, graph)] = step_grads(kind, graph, shape)
    for kind in ("gcn", "agnn"):
        res[("split comm", kind)] = comm_counts(kind, shape)
    # The overlap classes over the ranks.
    g = overlap_graph(OVERLAP[world])
    x = op_inputs("chunk", 1, g.num_edges)  # the chunk route's graph is this one
    res["overlap"] = {"route": g.route, "use_overlap": g.use_overlap,
                      "rows": (g.node_rows.start, g.node_rows.stop),
                      "cols": g.node_cols(D * g.lf // g.pf),
                      "edges": (int(g.host_fwd.edge_start[g.shards.start]),
                                int(g.host_fwd.edge_start[g.shards.stop])),
                      "ops": run_ops(g, *x), "waits": class_waits(g, x[0]),
                      "shards": g.lg * g.lf}
    # --single_kernel (each layout) and measure_comm over the ranks.
    for mesh_arg in ("4x1", f"{shape[0]}x{shape[1]}"):
        r = single_kernel(mesh_arg)
        res[("single_kernel", mesh_arg)] = {k: v for k, v in r.items()
                                            if isinstance(v, float)}
    out_csv = os.path.join(out_dir, f"comm_rank{rank}.csv")
    rows = measure_comm.main([*MEASURE_COMM, "--out", out_csv])
    res["measure_comm"] = (rows, open(out_csv).read() if os.path.exists(out_csv) else None)
    # Refusals.
    refusals = {"indivisible": lambda: make_mesh(3 * world // 2, 1, "cpu"),
                "feature indivisible": lambda: make_mesh(1, 3, "cpu"),
                "cli indivisible": lambda: train.main([*SMALL, "--mesh", "1x3"])}
    if world == 4:  # 2 hosts of 2 ranks cannot hold feature groups of 4
        refusals["two_level features"] = lambda: make_mesh_two_level(2, 1, 4, "cpu")
    for name, call in refusals.items():
        try:
            call()
        except ValueError as e:
            res[name] = str(e)
    for name, argv in (("no_mesh", SMALL),):
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
