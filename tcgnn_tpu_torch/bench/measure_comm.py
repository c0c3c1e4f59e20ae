"""Measured collective bytes of the distributed step against the partition
model, per dataset (port of ``tcgnn_tpu.bench.measure_comm``).

For each graph and mesh size this runs one real training step of the
distributed layer (2-layer GCN, hidden 16, no layer-1 hoist) with every
shard on ``--device``, counts its collectives
(``parallel.comm_stats.step_collective_bytes``), and writes the measured
per-step bytes beside the program model's halo volume, the ideal boundary
volume and the two-level mesh's cross-host fraction.  The bytes depend on
the partition and the widths, not on the device, so the rows equal the JAX
package's (``results/comm_measured.csv``).  Mesh sizes are not bounded by a
device count: every shard lives on the one device.

    python -m tcgnn_tpu_torch.bench.measure_comm [--datasets pubmed ppi] \\
        [--device cuda] [--out results_h100/comm/comm_measured.csv]

The model covers the routes a GCN step takes, each pass at its width in
the trainer's schedule: halo rounds and the split's partial-tile returns
(dense tiles), one all-gather of the features a pass (streamed, chunk
fallback) and two rim shifts a pass (block-diagonal).
``ratio_measured_vs_model`` compares the route's own kinds.  Each row is printed with the counted step's wall time on the
device (host work included), which the CSV, JAX's 12 columns, leaves out.

Under ``torchrun`` (or in a process group the caller formed) the mesh
spans the ranks (``parallel.make_mesh``): each rank counts its step's
collectives, which are the one-process counts (a call is one instance,
whatever the process count; the gradient all-reduce is not among the CSV's
kinds), and rank 0 writes the CSV with each row's wall ms the slowest
rank's:

    torchrun --nproc_per_node 2 -m tcgnn_tpu_torch.bench.measure_comm \
        --datasets pubmed --device cuda [--dist_backend gloo]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from tcgnn_tpu_torch.config import TileConfig

HEADER = ("dataset,shards,measured_a2a_bytes,measured_a2a_count,measured_ag_bytes,"
          "measured_ppermute_bytes,boundary_rows,modeled_halo_bytes,ratio_measured_vs_model,"
          "ideal_boundary_bytes,padding_overhead,dcn_frac_cph4")
HIDDEN = 16
# The JAX tool's tiles, so both count the same partition.
CONFIG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)


def _pass_bytes(dg, dn, width: int) -> float:
    """The program model, per device and pass: the bytes of one SpMM pass
    of direction ``dn`` at feature width ``width`` (f32)."""
    g = dg.pg
    if not dg.dense_tiles:
        # Streamed and chunk routes: one all-gather of the sharded features
        # a pass (its result, the whole matrix, on every device).
        return dg.padded_nodes * width * 4
    if dg.block_diag:
        # Two rim shifts (partial pairs over G) a pass, of -kmin and kmax
        # bins.
        (kmin, kmax), bn = dn.rim, dn.bin_rows
        return ((-kmin if kmin < 0 else 0) + max(kmax, 0)) * bn * width * 4 * (g - 1) / g
    host, b = dn.host, 0.0
    if host.halo is not None:
        # The quantized partial-pair rounds: each ppermute moves its
        # sub-segment on len(pairs) of the G links.
        b += sum(sz * width * 4 * len(pairs) / g for _, sz, pairs in host.halo["rounds"])
    if host.split is not None:
        # The split's partial-tile return: one all_to_all of G * pair_cap
        # tiles of blk_h rows.
        b += g * int(host.split["pair_cap"]) * dg.config.blk_h * width * 4
    return b


def measure(ds, name: str, shards: int, classes: int, device, cfg=CONFIG, **graph_kw) -> dict:
    """One row: build the graph of ``ds`` over a ``shards`` x 1 mesh on
    ``device`` (``graph_kw``: ``DistributedTiledGraph``'s route options),
    run a warm-up step and one counted step, and model it.  Returns ``row``
    (the CSV line), ``stats`` (``step_collective_bytes``'), ``step_ms`` (the
    counted step's wall time, host work included) and ``graph``."""
    import numpy as np
    import torch

    from tcgnn_tpu_torch.bench.epoch_ledger import _agg_stages
    from tcgnn_tpu_torch.bench.partition_stats import shard_stats
    from tcgnn_tpu_torch.parallel import (
        DistributedTiledGraph,
        dcn_halo_fraction,
        init_distributed_net,
        make_distributed_train_step,
        make_mesh,
        step_collective_bytes,
    )
    from tcgnn_tpu_torch.parallel.graph import _round_up
    from tcgnn_tpu_torch.train import make_optimizer

    device, g = torch.device(device), shards
    dg = DistributedTiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                               make_mesh(g, 1, device), cfg, **graph_kw)
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((ds.num_nodes, ds.x.shape[1])).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, classes, ds.num_nodes).astype(np.int64))
    net, _, _ = init_distributed_net(torch.Generator(device).manual_seed(0), "gcn", x.shape[1],
                                     HIDDEN, classes, 2, dg)
    # hoist=False: the layer-1 SpMM stays in the step, so the counted step
    # holds the whole per-epoch schedule.  Both steps are eager calls: a
    # replay runs no Python, so no recorder could count it.
    step = make_distributed_train_step(
        dg, net, x, y, make_optimizer(net.parameters(), 0.01, device), 0.5,
        num_valid_classes=classes, hoist=False,
        generator=torch.Generator(device).manual_seed(1))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step()  # warm-up, uncounted: the first step loads the kernels and cuBLAS
    sync()
    t0 = time.perf_counter()
    stats = step_collective_bytes(step, num_devices=g)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    if dg.mesh.world > 1:
        from tcgnn_tpu_torch.parallel.collectives import all_reduce_max

        step_ms = all_reduce_max([step_ms], dg.mesh)[0]  # the slowest rank's
    _, per_shard = shard_stats(ds.row_pointers, ds.column_index, ds.num_nodes, g, config=cfg)
    halo_rows = sum(s["boundary"] for s in per_shard)
    # The step's SpMM passes, the trainer's schedule (``aggregate_first``):
    # on the dense-tile and streamed routes layer 1 forward at the input
    # width and layer 2 forward and its dx at the hidden width (layer 1 needs
    # no dx: x is constant); on the block-diagonal route both layers project
    # first, so both run forward and dx at their output widths.  Each width
    # as the ops pad it.
    model_bytes = int(round(sum(
        _pass_bytes(dg, dg._bwd if transpose else dg._fwd, _round_up(w, 8))
        for _, w, transpose in _agg_stages(dg, "gcn", x.shape[1], HIDDEN, classes, 2))))
    # The ideal boundary volume of the dense-tile route's passes, per
    # device: what a perfectly packed exchange would move.
    ideal_bytes = halo_rows * (x.shape[1] + 2 * HIDDEN) * 4 // g
    halo = dg.host_fwd.halo
    dcn = dcn_halo_fraction(halo["pair_counts"], 4) if halo is not None else float("nan")
    a2a, ag, cp = stats["all_to_all"], stats["all_gather"], stats["collective_permute"]
    # Each route's own kinds: the streamed and chunk routes all-gather, the
    # others permute (and return split tiles by all_to_all).
    meas = ag["bytes"] if not dg.dense_tiles else a2a["bytes"] + cp["bytes"]
    row = (f"{name},{g},{a2a['bytes']},{a2a['count']},{ag['bytes']},{cp['bytes']},{halo_rows},"
           f"{model_bytes},{meas / model_bytes if model_bytes else float('nan'):.3f},"
           f"{ideal_bytes},{model_bytes / ideal_bytes if ideal_bytes else float('nan'):.3f},"
           f"{dcn:.4f}")
    return dict(row=row, stats=stats, step_ms=step_ms, graph=dg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datasets", nargs="*", default=[
        "pubmed", "ppi", "artist", "amazon0505", "amazon0601", "com-amazon",
        "soc-BlogCatalog", "reddit"])
    p.add_argument("--shards", nargs="*", type=int, default=[4, 8])
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="(under torchrun) the process group's backend: nccl on a card, gloo on "
                   "the CPU by default")
    p.add_argument("--out", default="comm_measured.csv")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from tcgnn_tpu_torch.data import synthetic

    device = args.device
    join = (not (dist.is_available() and dist.is_initialized())
            and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if join:
        from tcgnn_tpu_torch.parallel.mesh import init_process_group

        device = init_process_group(device, backend=args.dist_backend)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    rows = []
    try:
        with open(args.out, "w") if rank == 0 else contextlib.nullcontext() as f:
            if f is not None:
                f.write(HEADER + "\n")
            for name in args.datasets:
                ds = synthetic.synthesize(name, args.dim, args.classes)
                for g in args.shards:
                    r = measure(ds, name, g, args.classes, device)
                    if f is not None:
                        f.write(r["row"] + "\n")
                        f.flush()
                        print(f"{r['row']}  # step {r['step_ms']:.3f} ms", flush=True)
                    rows.append(r["row"])
                    del r
        if rank == 0:
            print(f"wrote {args.out}")
    finally:
        if join:
            dist.destroy_process_group()
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
