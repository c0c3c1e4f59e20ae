"""Measured partition statistics and an analytic NVLink roofline for the
distributed layer (port of ``tcgnn_tpu.bench.partition_stats``).

Every shard of the port's mesh lives on one card, so a run cannot show
multi-card scaling (``bench/scaling.py`` shows the one-card mesh's
overhead).  This tool grounds the scaling argument in what the partition
measures plus the card's data-sheet rates:

* **measured** per-shard boundary sizes (the rows the boundary-only halo
  exchange moves, ``parallel/partition.build_halo``'s semantics);
* **measured** per-shard SGT block counts (compute balance), from the
  port's block count (``sgt.translate.window_blocks``: the native pass
  where its library loads) padded as the partition pads them;
* an **analytic** per-op time model on NVIDIA H100 80GB HBM3 (SXM5, 700 W):
  the SpMM is memory-bound (structural tiles, gathered input rows, output
  writes) against the HBM rate, or bound by the bf16 tensor-core rate; the
  halo rides NVLink, overlapped with the shard's own work, so the
  predicted efficiency of an op is

      eff(G) = T_local(G) / max(T_local(G), T_nvlink(G)) x balance(G)

  with T_local the largest shard's roofline time and T_nvlink the per-device
  average halo bytes over one GPU's NVLink rate each way.

The model takes the true feature width (the JAX model pads it to the TPU's
128 lanes, a TPU rule the port leaves out) and JAX's bf16 element size.
The CSV keeps the JAX column names so rows compare: ``t_ici_us`` is the
NVLink term here.  The tool is host-only: it builds no graph on a device.

Run:
  python -m tcgnn_tpu_torch.bench.partition_stats --datasets amazon0601 reddit \\
      --shards 2 4 8 --dim 16 --csv results_h100/comm/partition_stats.csv
"""

from __future__ import annotations

import argparse
import copy
import csv
import sys

import numpy as np

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.parallel.partition import plan_halo_rounds
from tcgnn_tpu_torch.sgt.translate import _cdiv, _pad_blocks, window_blocks

# NVIDIA H100 80GB HBM3 (SXM5) data-sheet figures at its 700 W limit, not
# measurements (NVIDIA H100 Tensor Core GPU data sheet): HBM3 3.35 TB/s;
# NVLink 4 at 900 GB/s a GPU both ways together through NVSwitch, 450 GB/s
# each way; 989.4 TFLOP/s dense bf16 (``profiling.PEAK_BF16_TFLOPS``).
HBM_BPS = 3.35e12
NVLINK_BPS = 450e9
TENSOR_FLOPS = 989.4e12
BF16 = 2  # bytes


def shard_stats(row_pointers, column_index, num_nodes, num_shards,
                config: TileConfig = DEFAULT_CONFIG):
    """Measured per-shard stats of a window-aligned 1-D row partition (the
    shard geometry of ``parallel/partition.partition_csr``: no window
    crosses a shard).  Returns ``(rows_per_shard, shards)``, each shard a
    dict of ``edges``, ``boundary`` (distinct remote columns), ``blocks``
    (padded SGT blocks) and ``pair_row`` (remote columns by owner)."""
    blk_h = config.blk_h
    ptr = np.asarray(row_pointers, np.int64)
    cols = np.asarray(column_index, np.int64)
    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    wd = _cdiv(num_windows, num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard
    ptr = np.concatenate([ptr, np.full(n_pad + 1 - len(ptr), ptr[-1], np.int64)])

    shards = []
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        local_ptr = np.ascontiguousarray(ptr[r0:r1 + 1] - ptr[r0])
        local_cols = cols[ptr[r0]:ptr[r1]]
        uniq = np.unique(local_cols)
        remote = uniq[(uniq < r0) | (uniq >= r1)]
        # Remote columns by owner: the halo plan's pair counts
        # (partition.build_halo), from which the roofline derives the wire.
        pair_row = np.bincount(remote // rows_per_shard, minlength=num_shards).astype(np.int64)
        per_win = window_blocks(local_ptr, np.ascontiguousarray(local_cols, np.int32),
                                rows_per_shard, config)
        blocks = int(_pad_blocks(np.asarray(per_win, np.int64), config).sum())
        shards.append(dict(edges=int(len(local_cols)), boundary=int(len(remote)),
                           blocks=blocks, pair_row=pair_row))
    return rows_per_shard, shards


def roofline(shards, rows_per_shard, dim, config: TileConfig = DEFAULT_CONFIG):
    """The analytic per-SpMM time model (microseconds) and the predicted
    efficiency, on the H100's data-sheet rates."""
    t_local = []
    for s in shards:
        # HBM a shard: int8 structural tiles, the gathered input rows and
        # the output rows.  The gathers dominate.
        tile_bytes = s["blocks"] * config.blk_h * config.blk_w
        gather_bytes = s["blocks"] * config.blk_w * dim * BF16
        out_bytes = rows_per_shard * dim * BF16
        t_hbm = (tile_bytes + gather_bytes + out_bytes) / HBM_BPS
        t_tc = s["blocks"] * config.blk_h * config.blk_w * dim * 2 / TENSOR_FLOPS
        t_local.append(max(t_hbm, t_tc))
    # NVLink: the quantized partial-pair rounds (partition.plan_halo_rounds)
    # move the scheduled rows over G devices, the per-device average wire
    # that bench/measure_comm.py reconciles against the step's collectives.
    g = len(shards)
    _, rounds, _ = plan_halo_rounds([list(map(int, s["pair_row"])) for s in shards])
    wire_rows = sum(sz * len(pairs) for _, sz, pairs in rounds) / max(g, 1)
    t_link = wire_rows * dim * BF16 / NVLINK_BPS
    t_local_max = max(t_local)
    total_blocks = sum(x["blocks"] for x in shards)
    balance = (total_blocks / g) / max(max(x["blocks"] for x in shards), 1)
    comm = t_local_max / max(t_local_max, t_link)
    eff = comm * balance
    # The block-stream split (partition.build_split) brings the heaviest
    # shard to about the ideal plus 5% slack; it gates on measured
    # imbalance, so it never makes things worse.
    ideal = -(-total_blocks // g)
    balance_split = (total_blocks / g) / (ideal + max(ideal // 20, 1))
    return dict(
        t_local_us=t_local_max * 1e6,
        t_ici_us=t_link * 1e6,
        balance=balance,
        efficiency=eff,
        efficiency_split=max(eff, comm * balance_split),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datasets", nargs="+", default=["amazon0601"])
    p.add_argument("--shards", nargs="+", type=int, default=[2, 4, 8])
    p.add_argument("--dim", type=int, default=16,
                   help="feature width of the hot SpMM (GCN hidden=16)")
    p.add_argument("--reorder", default="rcm", choices=["none", "rcm", "community"])
    p.add_argument("--balance", action="store_true",
                   help="apply the window-granular LPT shard balance (what --mesh "
                   "training does on graphs off the block-diagonal route) first")
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)

    from tcgnn_tpu_torch import train as train_lib
    from tcgnn_tpu_torch.sgt.reorder import balance_dataset, reorder_dataset

    rows_out = []
    for name in args.datasets:
        targs = train_lib.build_argparser().parse_args(
            ["--dataset", name, "--dim", str(args.dim), "--classes", "2",
             "--data_dir", args.data_dir])
        ds = train_lib.load_dataset(targs)
        reorder_dataset(ds, args.reorder)
        for g in args.shards:
            dsg = ds
            if args.balance:
                dsg = copy.copy(ds)  # the balance is G-specific; ds stays as it is
                balance_dataset(dsg, g)
            rps, shards = shard_stats(dsg.row_pointers, dsg.column_index, dsg.num_nodes, g)
            if sum(s["edges"] for s in shards) != ds.num_edges:
                raise AssertionError(f"{name} over {g} shards: the shards' edges do not sum "
                                     f"to the graph's {ds.num_edges}")
            r = roofline(shards, rps, args.dim)
            bmax = max(s["boundary"] for s in shards)
            row = dict(
                dataset=name, shards=g, nodes=ds.num_nodes, edges=ds.num_edges,
                rows_per_shard=rps, boundary_max=bmax,
                boundary_frac=round(bmax / max(ds.num_nodes, 1), 4),
                halo_kb=round(bmax * args.dim * BF16 / 1024, 1),
                blocks_balance=round(r["balance"], 3),
                t_local_us=round(r["t_local_us"], 1),
                t_ici_us=round(r["t_ici_us"], 1),
                pred_efficiency=round(r["efficiency"], 3),
                pred_efficiency_split=round(r["efficiency_split"], 3),
            )
            rows_out.append(row)
            print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows_out[0]))
            w.writeheader()
            w.writerows(rows_out)
        print(f"# wrote {args.csv}")
    return rows_out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
