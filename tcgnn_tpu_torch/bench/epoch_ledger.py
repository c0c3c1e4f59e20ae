"""Measured per-stage epoch ledger (port of ``tcgnn_tpu.bench.epoch_ledger``).

Decomposes one training epoch into stages and measures each stage on its
own, so that the stages can be set against the measured epoch: the
residual column shows what composing them costs or saves.

Stages of a GCN/GIN no-hoist epoch (the headline configuration, reference
``main_tcgnn.py:146-151``), from ``_agg_stages``:

  * ``spmm@L<i>``   — layer i's aggregation ``A @ x`` at the width its
                      schedule aggregates (``models.layers.aggregate_first``,
                      the rule the port's trainer runs);
  * ``spmm_t@L<i>`` — the backward pass's transpose aggregation ``A^T @ dy``
                      where the layer has one;
  * ``dense_rest``  — everything else: dense GEMMs, ReLU, dropout,
                      log-softmax, NLL and Adam, measured by running the
                      full epoch with every aggregation stubbed to identity
                      (``_IdentityGraph``: the same shapes, the same dense
                      ops).

Timing: warm-up epochs (or rounds), then ``--epochs`` rounds between two
CUDA events around a ``torch.cuda.synchronize()``, over the rounds, as the
trainer brackets its own ``Train (ms)``: each stage's number includes its
dispatch, as the epoch's does (the host clock on the CPU).  The JAX
package's in-program chain differencing (``_timed_scan_rounds``) and its
narrow/128-lane carry pair are TPU workarounds and are left out; an
aggregation round takes the previous round's output at its true width.

Run:  python -m tcgnn_tpu_torch.bench.epoch_ledger [--datasets DD amazon0601]
Writes ``epoch_ledger.csv`` (one row per dataset) and prints the table.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

from tcgnn_tpu_torch import train as T
from tcgnn_tpu_torch.bench.datasets import AE_TABLE, GCN_CONFIG
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import nets
from tcgnn_tpu_torch.models.layers import aggregate_first

WARMUP = 5


class _IdentityGraph:
    """Duck-typed ``TiledGraph`` whose aggregation is identity.

    The real GCN/GIN epoch step over this stub runs exactly the dense
    remainder of the epoch (GEMMs at the true shapes, ReLU, the dropout
    mask, log-softmax, NLL, Adam) with no aggregation: identity's backward
    is identity, so the backward's dense ops run at true shapes too.  It
    carries the real graph's compute dtype and route, so the layers take
    the same schedule.
    """

    def __init__(self, real: TiledGraph):
        self.config = real.config
        self.block_diag = real.block_diag

    def spmm(self, x):
        return x


def timed_rounds_ms(fn, rounds, device, warmup=WARMUP) -> float:
    """ms a round of ``rounds`` calls of ``fn`` after ``warmup`` calls: CUDA
    events around the rounds, synchronized before and after, on the card;
    the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(rounds):
            fn()
        return (time.perf_counter() - start) * 1e3 / rounds
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / rounds


def _spmm_round_ms(graph, width, rounds, transpose=False) -> float:
    """ms of one aggregation pass at ``width`` (``A @ x``, or ``A^T @ dy``
    with ``transpose``), each round taking the previous round's output."""
    ct = graph.config.compute_dtype
    op = graph._spmm_b if transpose else graph._spmm_f
    carry = {"x": torch.full((graph.num_nodes, width), 0.01, dtype=ct, device=graph.device)}

    def round_():
        carry["x"] = op(carry["x"]).to(ct)

    with torch.no_grad():
        return timed_rounds_ms(round_, rounds, graph.device)


def _agg_stages(graph, kind, din, hidden, classes, num_layers):
    """The epoch's aggregation passes as (label, width, transpose) tuples.

    Per layer (in -> out): aggregate-first runs A at the IN width and the
    backward transpose at the same width; project-first runs A at the OUT
    width (and its transpose).  Layer 1's input carries no gradient, so its
    backward transpose exists only on the project-first schedule.  GIN
    always aggregates first.
    """
    dims = [din] + [hidden] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes]
    block_diag = getattr(graph, "block_diag", False)
    stages = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        first = True if kind == "gin" else aggregate_first(d_in, d_out, block_diag)
        w = d_in if first else d_out
        stages.append((f"spmm@L{i + 1}", w, False))
        if i > 0 or not first:
            stages.append((f"spmm_t@L{i + 1}", w, True))
    return stages


def ledger_for(ds, args):
    device = torch.device(args.device)
    cfg = TileConfig(
        blk_h=args.blk_h, blk_w=args.blk_w,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        block_group=0,
    )
    graph = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, cfg, device=device,
                       weighted_traffic=False)
    x = torch.from_numpy(ds.x).to(device)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(device)

    def epoch_ms(g):
        net = nets.init_net(torch.Generator().manual_seed(0), args.model, ds.num_features,
                            args.hidden, ds.num_classes, args.num_layers, device=device)
        optimizer = torch.optim.Adam(net.parameters(), lr=0.01)
        step = T.make_train_step(g, net, x, y, optimizer, 0.5, hoist=False,
                                 generator=torch.Generator(device=device).manual_seed(1))
        return timed_rounds_ms(step, args.epochs, device)

    row = {"dataset": args.dataset}
    row["epoch_ms"] = epoch_ms(graph)
    row["dense_rest_ms"] = epoch_ms(_IdentityGraph(graph))
    stages = _agg_stages(graph, args.model, ds.num_features, args.hidden, ds.num_classes,
                         args.num_layers)
    # Each (width, transpose) signature is measured once: identical passes
    # cost the same.
    cache = {}
    details = []
    for label, width, transpose in stages:
        sig = (width, transpose)
        if sig not in cache:
            cache[sig] = _spmm_round_ms(graph, width, args.epochs, transpose)
        details.append((label, width, cache[sig]))
    row["route"] = (graph.dense_tiles, graph.streamed, graph.block_diag)
    row["agg_stages"] = details
    row["agg_ms"] = sum(ms for _, _, ms in details)
    row["stage_sum_ms"] = row["dense_rest_ms"] + row["agg_ms"]
    row["residual_ms"] = row["epoch_ms"] - row["stage_sum_ms"]
    row["residual_pct"] = 100.0 * row["residual_ms"] / row["epoch_ms"]
    return row


COLUMNS = (
    "dataset", "epoch_ms", "agg_ms", "dense_rest_ms", "stage_sum_ms",
    "residual_ms", "residual_pct", "agg_stages",
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="*", default=["DD", "amazon0601"])
    p.add_argument("--model", default="gcn", choices=["gcn", "gin"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=GCN_CONFIG["hidden"])
    p.add_argument("--num_layers", type=int, default=GCN_CONFIG["num_layers"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--reorder", default="rcm")
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--blk_h", type=int, default=512)
    p.add_argument("--blk_w", type=int, default=128)
    p.add_argument("--out", default="epoch_ledger.csv")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dims = {n: (d, c) for n, d, c in AE_TABLE}
    rows = []
    with open(args.out, "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for name in args.datasets:
            dim, classes = dims.get(name, (96, 10))
            largs = argparse.Namespace(dataset=name, data_dir=args.data_dir, dim=dim,
                                       classes=classes, seed=0)
            ds = T.load_dataset(largs)
            if args.reorder != "none":
                from tcgnn_tpu_torch.sgt.reorder import reorder_dataset

                reorder_dataset(ds, args.reorder)
            args.dataset = name
            print(f"=== {name} ===", flush=True)
            t0 = time.perf_counter()
            row = ledger_for(ds, args)
            rows.append(row)
            agg_str = " + ".join(f"{lbl}[w{w}]={ms:.3f}" for lbl, w, ms in row["agg_stages"])
            f.write(",".join(
                row[c] if c == "dataset"
                else (agg_str.replace(",", ";") if c == "agg_stages" else f"{row[c]:.3f}")
                for c in COLUMNS
            ) + "\n")
            f.flush()
            print(
                "  epoch {epoch_ms:8.3f} = [{agg}] + dense_rest {dense_rest_ms:.3f}  "
                "(residual {residual_ms:+.3f} ms / {residual_pct:+.1f}%)  route "
                "dense_tiles={r[0]} streamed={r[1]} block_diag={r[2]}  [{t:.0f}s]".format(
                    t=time.perf_counter() - t0, agg=agg_str, r=row["route"], **row),
                flush=True,
            )
            del ds
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
