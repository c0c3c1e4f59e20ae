"""Full-graph GNN trainer CLI (PyTorch port of ``tcgnn_tpu.train``).

Single device: SGT preprocessing timed as ``Prep. (ms)`` with the
``TC_Blocks`` / ``Exp_Edges`` statistics, then full-batch training with Adam
(lr 0.01) and NLL over all nodes: 9 warm-up epochs, as the JAX CLI runs
(``tcgnn_tpu/train.py`` ``step.many(..., 9)``), then ``--epochs`` timed
epochs reported as ``Train (ms)``.  The timed loop reads no value from the
device; it is bracketed by ``torch.cuda.synchronize()``.

The device is explicit (``--device``, default ``cuda``) and the trainer never
moves to another one: without a card, ``--device cuda`` raises.

``--mesh GxF`` trains over a ``('graph','feature')`` mesh of G x F shards
(``tcgnn_tpu_torch.parallel``), all on the one ``--device``: the graph is
balanced over the shards (``--no_balance`` keeps its order), partitioned,
and trained with the same output lines and a ``Route:`` line naming the
block streams; ``block_group`` is 1, as the mesh's split needs.

Run:  python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --model gcn
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --mesh 4x2
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --model agnn \
          --hidden 32 --mesh 8x1
      python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --model agnn --hidden 32
      python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --reorder rcm
      python -m tcgnn_tpu_torch.train --dataset reddit --dim 602 --classes 41 --model gcn
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import dataset as data_lib
from tcgnn_tpu_torch.data import synthetic
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch import profiling
from tcgnn_tpu_torch.models import nets
from tcgnn_tpu_torch.sgt import reorder

# Warm-up steps before the timed epochs, the first one's loss included: the
# JAX CLI's 9, on one device and on the mesh.
WARMUP_EPOCHS = 9


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TC-GNN trainer (PyTorch/CUDA port)")
    p.add_argument("--dataset", type=str, default="amazon0601")
    p.add_argument("--dim", type=int, default=96, help="input embedding dimension")
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=22)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--model", type=str, default="gcn", choices=["gcn", "gin", "agnn"])
    p.add_argument(
        "--n_heads", type=int, default=1,
        help="AGNN attention heads (head-averaged)",
    )
    p.add_argument("--data_dir", type=str, default="tcgnn-ae-graphs/")
    p.add_argument("--blk_h", type=int, default=512)
    p.add_argument("--blk_w", type=int, default=128)
    p.add_argument("--edge_chunk", type=int, default=128,
                   help="edge slots per chunk of the chunk and streamed routes")
    p.add_argument(
        "--block_group", type=int, default=0,
        help="SGT block-count padding granule (0 = auto, which is 1 here)",
    )
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--symmetric", action="store_true",
                   help="declare A symmetric (skip the transpose tiling)")
    p.add_argument(
        "--reorder", default="none", choices=list(reorder.REORDER_METHODS),
        help="node reordering before tiling: rcm narrows the band so banded "
        "graphs reach the block-diagonal route (community: not ported yet)",
    )
    p.add_argument("--gcn_norm", action="store_true",
                   help="symmetric D^-1/2 A D^-1/2 normalization")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument(
        "--no_hoist", action="store_true",
        help="recompute the loop-invariant layer-1 aggregate every epoch "
        "instead of hoisting it out of the training loop (exact either way)",
    )
    p.add_argument("--eval", action="store_true", help="report train/test accuracy")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace the timed epochs with torch.profiler into this directory "
                   "and print the device's busy time, idle share and largest items")
    p.add_argument("--mesh", type=str, default=None, metavar="GxF",
                   help="train over a ('graph','feature') mesh of G x F shards, e.g. --mesh 4x2; "
                   "every shard lives on --device")
    p.add_argument("--no_balance", action="store_true",
                   help="(--mesh only) disable the window-granular LPT shard balance")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_dataset(args) -> data_lib.GraphDataset:
    npz = os.path.join(args.data_dir, args.dataset + ".npz")
    if os.path.exists(npz):
        return data_lib.load_npz(npz, args.dim, args.classes, seed=args.seed)
    txt = os.path.join(args.data_dir, args.dataset + ".txt")
    if os.path.exists(txt):
        return data_lib.load_txt(txt, args.dim, args.classes, seed=args.seed)
    print(f"# dataset {args.dataset}: synthetic (no file in {args.data_dir})")
    return synthetic.synthesize(args.dataset, args.dim, args.classes, seed=args.seed)


def make_config(args) -> TileConfig:
    return TileConfig(
        blk_h=args.blk_h,
        blk_w=args.blk_w,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        block_group=args.block_group,
        edge_chunk=args.edge_chunk,
    )


def make_train_step(
    graph: TiledGraph, net: nets.GNN, x, y, optimizer, dropout_rate, norm=None,
    hoist: bool = True, generator: torch.Generator | None = None,
):
    """One full-batch epoch per call: forward, NLL over all nodes, Adam
    update.  Returns the epoch's loss (before the update) as a device tensor.

    ``hoist`` computes the loop-invariant layer-1 aggregate once
    (``nets.hoist_l1_aggregate``), removing that SpMM and its transpose
    from every epoch; exact for GCN and GIN, and no change for AGNN.  ``generator`` draws the
    dropout masks (no dropout without one, or at rate 0).
    """
    l1_agg = nets.hoist_l1_aggregate(net.kind, x, graph, norm=norm) if hoist else None
    gen = generator if dropout_rate > 0 else None

    def step() -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        logp = net(x, graph, dropout_generator=gen, dropout_rate=dropout_rate,
                   norm=norm, l1_agg=l1_agg)
        loss = F.nll_loss(logp, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def timed_epochs(step, args, device, sync) -> tuple:
    """Warm-up epochs, then ``--epochs`` timed ones (profiled with
    ``--profile_dir``): ``(first_loss, final_loss, train_s, profile)``."""
    first_loss = loss = step()
    for _ in range(WARMUP_EPOCHS - 1):
        loss = step()
    sync()
    epochs_run = max(args.epochs, 1)
    with profiling.trace(args.profile_dir, device, epochs_run) as prof:
        start_train = time.perf_counter()
        for _ in range(args.epochs):
            loss = step()
        sync()
        train_time = time.perf_counter() - start_train
    final_loss = float(loss)
    print("Final loss:\t{:.6f}".format(final_loss))
    print("Train (ms):\t{:6.3f}".format(train_time * 1e3 / epochs_run))
    return float(first_loss), final_loss, train_time * 1e3 / epochs_run, prof or None


def train_distributed(args, ds, cfg, device, sync) -> dict:
    """Full-batch training over a ``('graph','feature')`` mesh (``--mesh
    GxF``), every shard on ``device``."""
    from tcgnn_tpu_torch.parallel import (
        distributed_graph_from_dataset,
        init_distributed_net,
        make_distributed_train_step,
        make_mesh,
    )

    ng, nf = (int(v) for v in args.mesh.lower().split("x"))
    mesh = make_mesh(ng, nf, device)
    start = time.perf_counter()
    graph = distributed_graph_from_dataset(ds, mesh, cfg, balance=not args.no_balance)
    sync()
    prep = time.perf_counter() - start
    print("TC_Blocks:\t{}\nExp_Edges:\t{}".format(graph.tc_blocks, graph.exp_edges))
    print("Prep. (ms):\t{:.3f}".format(prep * 1e3))
    print("Route:\t" + graph.route)

    x = graph.shard_features(ds.x)
    y = graph.shard_nodes(ds.y.astype(np.int64))
    net, _, _ = init_distributed_net(
        torch.Generator().manual_seed(args.seed), args.model, ds.num_features, args.hidden,
        ds.num_classes, args.num_layers, graph, n_heads=args.n_heads,
    )
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr)
    norm = (graph.shard_nodes((1.0 / ds.norm_degrees()).astype(np.float32))
            if args.gcn_norm else None)
    step = make_distributed_train_step(
        graph, net, x, y, optimizer, 0.0 if args.no_dropout else args.dropout,
        num_valid_classes=ds.num_classes, norm=norm, hoist=not args.no_hoist,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
    )
    first_loss, final_loss, train_ms, prof = timed_epochs(step, args, device, sync)

    if args.eval:
        with torch.no_grad():
            pred = net(x, graph, norm=norm, num_valid_classes=ds.num_classes).argmax(dim=1)
        for split, m_host in (("train", ds.train_mask), ("test", ds.test_mask)):
            if m_host.any():
                m = graph.shard_nodes(m_host).bool()
                acc = float((pred[m] == y[m]).float().mean())
                print("Acc {}:\t{:.4f}".format(split, acc))
    return {
        "dense_tiles": graph.dense_tiles, "streamed": graph.streamed,
        "block_diag": graph.block_diag, "mesh": (ng, nf), "route": graph.route,
        "split": (graph.host_fwd.split is not None, graph.host_bwd.split is not None),
        "tc_blocks": graph.tc_blocks, "exp_edges": graph.exp_edges, "prep_ms": prep * 1e3,
        "first_loss": first_loss, "final_loss": final_loss, "train_ms": train_ms,
        "profile": prof, "graph": graph,
    }


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    print(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    # f32 means f32: no TF32 in the dense products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ds = load_dataset(args)
    cfg = make_config(args)
    if args.mesh:
        if args.reorder != "none":
            reorder.reorder_dataset(ds, args.reorder)
        return train_distributed(args, ds, cfg, device, sync)
    if args.reorder != "none":
        start = time.perf_counter()
        reorder.reorder_dataset(ds, args.reorder)
        print("Reorder (ms):\t{:.3f}".format((time.perf_counter() - start) * 1e3))

    # ---- SGT preprocessing and upload (the "Prep." stage) ----------------
    start = time.perf_counter()
    graph = TiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes, cfg,
        symmetric=args.symmetric, device=device, weighted_traffic=args.model == "agnn",
    )
    sync()
    prep = time.perf_counter() - start
    print("TC_Blocks:\t{}\nExp_Edges:\t{}".format(graph.tc_blocks, graph.exp_edges))
    print("Prep. (ms):\t{:.3f}".format(prep * 1e3))
    print("Prep host (ms):\t{:.3f}".format(graph.prep_host_s * 1e3))
    print("Route:\tdense_tiles={} streamed={} block_diag={}".format(
        graph.dense_tiles, graph.streamed, graph.block_diag))

    x = torch.from_numpy(ds.x).to(device)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(device)

    # ---- model + optimizer -------------------------------------------------
    net = nets.init_net(
        torch.Generator().manual_seed(args.seed), args.model, ds.num_features,
        args.hidden, ds.num_classes, args.num_layers, device=device, n_heads=args.n_heads,
    )
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr)
    dropout = 0.0 if args.no_dropout else args.dropout
    norm = (
        torch.from_numpy(1.0 / ds.norm_degrees()).to(device) if args.gcn_norm else None
    )
    step = make_train_step(
        graph, net, x, y, optimizer, dropout, norm=norm, hoist=not args.no_hoist,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
    )

    # ---- warm-up epochs, then timed epochs ----------------------------------
    first_loss, final_loss, train_ms, prof = timed_epochs(step, args, device, sync)

    if args.eval:
        with torch.no_grad():
            pred = net(x, graph, norm=norm).argmax(dim=1)
        for split, mask in (("train", ds.train_mask), ("test", ds.test_mask)):
            if mask.any():
                m = torch.from_numpy(mask).to(device)
                acc = float((pred[m] == y[m]).float().mean())
                print("Acc {}:\t{:.4f}".format(split, acc))

    return {
        "dense_tiles": graph.dense_tiles,
        "streamed": graph.streamed,
        "block_diag": graph.block_diag,
        "tc_blocks": graph.tc_blocks,
        "exp_edges": graph.exp_edges,
        "prep_ms": prep * 1e3,
        "prep_host_ms": graph.prep_host_s * 1e3,
        "first_loss": first_loss,
        "final_loss": final_loss,
        "train_ms": train_ms,
        "profile": prof,
        "graph": graph,
    }


if __name__ == "__main__":
    main()
