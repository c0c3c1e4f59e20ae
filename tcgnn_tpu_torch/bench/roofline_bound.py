"""The card's floor: the least time an SpMM, and a GCN epoch, could take on
each AE graph (port of ``tcgnn_tpu.bench.roofline_bound``).

This module holds the port's one definition of a bound (``bound``,
``csr_bound``); ``chip_smoke.py`` imports it.  A bound is the larger of two
times: the bytes the function must move (each input read once, each output
written once) over the card's memory rate, and its f32 operations over the
card's f32 rate (every kernel of the port multiplies in f32 on the CUDA
cores).  The constants are NVIDIA's H100 SXM data-sheet figures at 700 W,
not measurements: a card set to a lower power limit runs below them.

Over a CSR adjacency of E edges on N rows, what a function must read of the
graph is the int32 column indices and the N+1 int32 row pointers (and an
f32 weight an edge where it is weighted), whatever layout a kernel reads:

  * per-graph SpMM floor: ``csr_bound`` for one ``A @ x`` at d=96 (the
    single-kernel width), x read and the output written once in f32,
    2 E d operations; ``path`` names the route the graph takes in the
    sweep's node order (no reordering; the JAX module took RCM's);
  * GCN no-hoist epoch floor: the sum over the epoch's aggregations
    (``epoch_ledger._agg_stages``, the trainer's schedule: an SpMM at each
    stage's width) plus the dense traffic and operations: the input
    features read twice (the layer-1 GEMM and its weight gradient), the
    hidden-width activations touched 8 times (ReLU, dropout, the GEMMs,
    forward and backward), the class-width ones 4 times (logits,
    log-softmax, NLL, forward and backward), every GEMM's forward and
    weight-gradient products and the input gradients past layer 1.

The JAX model's constants (the v5e's HBM rate, XLA gather rows/s, the
Pallas grid-step launch floor) and byte counts (the TPU's tile and slab
layouts) do not carry over: the CSV drops its ``gather_ms`` and
``steps_ms`` columns, since no kernel of the port has those terms.
``hbm_ms`` is the SpMM floor's bytes term.

Run (reads the sweep's CSVs where they exist):
    python -m tcgnn_tpu_torch.bench.roofline_bound \
        [--single_kernel_csv results_h100/single_kernel/2_tcgnn_single_kernel.csv] \
        [--gcn_csv results_h100/gcn_gather/1_bench_gcn.csv] \
        [--out results_h100/roofline/roofline.csv]
"""

from __future__ import annotations

import argparse
import csv
import gc
import os
import sys

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): memory rate and
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SAG_DIM = 96
F32 = 4


def bound(n_bytes, flops) -> tuple[float, str]:
    """The least time the card could take (ms): each input read once and
    each output written once at the memory rate, or the f32 operations at
    the f32 rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bound(nnz, n, dense_bytes, flops, weighted=False) -> tuple[float, str]:
    """``bound`` for a function over a CSR adjacency of ``nnz`` edges on
    ``n`` rows: what it must read of the graph is the int32 column indices,
    the n+1 int32 row pointers and, weighted, an f32 weight an edge; the
    dense operands read once and outputs written once are ``dense_bytes``.
    The same for every kernel, whatever layout it reads."""
    return bound(4 * nnz + 4 * (n + 1) + (4 * nnz if weighted else 0) + dense_bytes, flops)


def spmm_floor(num_nodes, num_edges, d) -> tuple[float, str, float]:
    """``(ms, bound_by, bytes ms)`` of one f32 ``A @ x`` at width ``d``."""
    dense = 2 * F32 * num_nodes * d
    ms, by = csr_bound(num_edges, num_nodes, dense, 2 * num_edges * d)
    return ms, by, (4 * num_edges + 4 * (num_nodes + 1) + dense) / HBM_BYTES_PER_S * 1e3


def epoch_floor(stages, num_nodes, num_edges, dims) -> float:
    """ms of a no-hoist GCN epoch over layer widths ``dims`` (input,
    hidden..., classes): its aggregation ``stages`` (``(label, width,
    transpose)``) at their ``spmm_floor`` and the dense traffic and GEMMs
    at ``bound``."""
    agg = sum(spmm_floor(num_nodes, num_edges, w)[0] for _, w, _ in stages)
    n, d_in, hidden, classes = num_nodes, dims[0], dims[1:-1], dims[-1]
    dense_bytes = F32 * n * (2 * d_in + 8 * sum(hidden) + 4 * classes)
    flops = sum(2 * n * a * b * (2 if i == 0 else 3)
                for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
    return agg + bound(dense_bytes, flops)[0]


def route_name(graph) -> str:
    if not graph.dense_tiles:
        return "streamed" if graph.streamed else "chunk"
    return "bd" if graph.block_diag else "condensed"


def read_csv(path, key_col, val_col) -> dict:
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.DictReader(f):
                try:
                    out[row[key_col]] = float(row[val_col])
                except (KeyError, ValueError):
                    pass
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--single_kernel_csv",
                   default="results_h100/single_kernel/2_tcgnn_single_kernel.csv")
    p.add_argument("--gcn_csv", default="results_h100/gcn_gather/1_bench_gcn.csv")
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--out", default="results_h100/roofline/roofline.csv")
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from tcgnn_tpu_torch.bench.datasets import AE_TABLE, GCN_CONFIG
    from tcgnn_tpu_torch.bench.epoch_ledger import _agg_stages
    from tcgnn_tpu_torch.graph import TiledGraph
    from tcgnn_tpu_torch.train import load_dataset

    sag = read_csv(args.single_kernel_csv, "dataset", "SAG avg (ms)")
    gcn = read_csv(args.gcn_csv, "dataset", "Avg.Epoch (ms)")
    hidden, layers = GCN_CONFIG["hidden"], GCN_CONFIG["num_layers"]
    table = [(n, d, c) for n, d, c in AE_TABLE if args.datasets is None or n in args.datasets]
    rows = []
    with open(args.out, "w") as f:
        f.write(
            "dataset,path,spmm_floor_ms_d96,hbm_ms,"
            "sag_measured_ms,sag_vs_floor,epoch_floor_ms,"
            "epoch_measured_ms,epoch_vs_floor\n"
        )
        for name, dim, classes in table:
            ds = load_dataset(argparse.Namespace(dataset=name, data_dir=args.data_dir,
                                                 dim=dim, classes=classes, seed=0))
            g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, device=args.device)
            path = route_name(g)
            stages = _agg_stages(g, "gcn", dim, hidden, classes, layers)
            del g
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            n, e = ds.num_nodes, ds.num_edges
            floor96, _, hbm = spmm_floor(n, e, SAG_DIM)
            ef = epoch_floor(stages, n, e, [dim] + [hidden] * (layers - 1) + [classes])
            sm, em = sag.get(name), gcn.get(name)
            f.write(
                f"{name},{path},{floor96:.5f},{hbm:.5f},"
                f"{'' if sm is None else f'{sm:.3f}'},"
                f"{'' if sm is None else f'{sm / floor96:.2f}'},"
                f"{ef:.5f},"
                f"{'' if em is None else f'{em:.3f}'},"
                f"{'' if em is None else f'{em / ef:.2f}'}\n"
            )
            f.flush()
            rows.append((name, path, floor96, ef, sm, em))
            print(f"{name}: {path}, SpMM floor d={SAG_DIM} {floor96:.5f} ms, "
                  f"GCN epoch floor {ef:.5f} ms", flush=True)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
