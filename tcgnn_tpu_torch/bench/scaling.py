"""Scaling efficiency, edges/s against mesh size (port of
``tcgnn_tpu.bench.scaling``).

The distributed north-star metric (BASELINE.md: at least 80% edges/s
scaling efficiency from 1 device to N): the same full-graph training step
on ``('graph', 'feature')`` meshes of growing size, its edges/s, and the
efficiency against the 1-shard mesh.  Every shard of the port's mesh lives
on one device, so on one card the curve measures the one-card mesh's
device work (shards run in turn, collectives are copies, the step replayed
from one CUDA graph), not NVLink scaling; the JAX tool says the same of
its virtual CPU mesh.

Run:
  python -m tcgnn_tpu_torch.bench.scaling --dataset rand_20000_100000 [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig

# Graph-axis sizes of the curve: the ones the JAX tool takes on its 8 test
# devices (times --n_feature).
SIZES = (1, 2, 4, 8)


def measure(mesh_shape, ds, cfg, model, hidden, epochs, seed=0, device="cuda"):
    """``(seconds an epoch, edges/s)`` of ``step.many(epochs)`` after a
    ``step.many(3)`` warm-up on a ``mesh_shape`` mesh: on the card the
    warm-up holds the capture, and the timed epochs are replays of one CUDA
    graph of the step, as the JAX tool times jitted steps; on the CPU,
    eager steps."""
    from tcgnn_tpu_torch.parallel import (
        distributed_graph_from_dataset,
        init_distributed_net,
        make_distributed_train_step,
        make_mesh,
    )
    from tcgnn_tpu_torch.train import make_optimizer

    device = torch.device(device)
    ng, nf = mesh_shape
    graph = distributed_graph_from_dataset(ds, make_mesh(ng, nf, device), cfg)
    x = graph.shard_features(ds.x)
    y = graph.shard_nodes(ds.y.astype(np.int64))
    net, _, _ = init_distributed_net(torch.Generator(device).manual_seed(seed), model,
                                     ds.x.shape[1], hidden, ds.num_classes, 2, graph)
    step = make_distributed_train_step(graph, net, x, y,
                                       make_optimizer(net.parameters(), 0.01, device),
                                       dropout_rate=0.0, num_valid_classes=ds.num_classes)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step.many(3)
    sync()
    t0 = time.perf_counter()
    step.many(epochs)
    sync()
    dt = (time.perf_counter() - t0) / epochs
    return dt, ds.num_edges / dt


def main(argv=None):
    from tcgnn_tpu_torch.train import load_dataset

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="rand_20000_100000")
    p.add_argument("--model", default="gcn", choices=["gcn", "gin", "agnn"])
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--n_feature", type=int, default=1)
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = load_dataset(args)
    # The JAX tool's tiles: the default on the card, 32x32 elsewhere.
    cfg = (DEFAULT_CONFIG if torch.device(args.device).type == "cuda"
           else TileConfig(blk_h=32, blk_w=32, edge_chunk=32))
    base, rows = None, []
    print("devices,epoch_ms,edges_per_s,efficiency")
    for s in SIZES:
        # The shard balance permutes ds in place, as in the JAX tool.
        dt, eps = measure((s, args.n_feature), ds, cfg, args.model, args.hidden, args.epochs,
                          args.seed, args.device)
        if base is None:
            base = eps
        eff = eps / (base * s)
        rows.append((s * args.n_feature, dt * 1e3, eps, eff))
        print(f"{s * args.n_feature},{dt * 1e3:.3f},{eps:.3e},{eff:.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
