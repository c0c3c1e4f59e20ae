"""AE benchmark sweep: the port against the torch incumbents, graph by graph
(port of ``tcgnn_tpu.bench.sweep``).

The reference's harness layers (``1_bench_gcn.py``, ``1_log2csv.py``,
``dgl_baseline/2_combine_results.py``) folded into one in-process runner
over the 14 ``AE_TABLE`` graphs:

  python -m tcgnn_tpu_torch.bench.sweep --model gcn [--datasets cora pubmed]
      [--epochs 200] [--baseline_epochs 50] [--baseline_impl {gather,sparse}]
      [--dtype float32] [--device cuda]
  python -m tcgnn_tpu_torch.bench.sweep --single_kernel

Outputs, written in the working directory, a flushed row a graph (the JAX
package's contracts):
  * ``1_bench_<model>.csv`` — ``dataset,Avg.Epoch (ms)``, the no-hoist epoch;
  * ``Fig_6a_torch_<model>.csv`` — ``dataset,torch_baseline,tcgnn_torch,
    speedup,tcgnn_torch_hoisted,speedup_hoisted,tcgnn_epochs,
    baseline_epochs`` (JAX: ``Fig_6a_xla_<model>.csv``);
  * ``--single_kernel``: ``2_tcgnn_single_kernel.csv`` with the keys
    ``train.profile_sag`` returns, at d=96 (``2_tcgnn_single_kernel.py``).

The no-hoist run is the primary column (the reference recomputes every
aggregate each epoch, ``main_tcgnn.py:146-151``) and the hoisted run has
its own; AGNN has nothing to hoist, so its second run is skipped.  A run
that raises prints its traceback and writes no row.  After every run the
result (which holds the graph and the dataset) is dropped, then
``gc.collect()`` and ``torch.cuda.empty_cache()``, so no graph's device
memory outlives its run (JAX: ``jax.clear_caches()``).

Differences from the JAX sweep: ``--device`` (passed down to the trainer and
the baseline), ``--dtype`` defaults to the port trainer's float32 (JAX's
bfloat16 default is the TPU's), ``--baseline_impl`` takes ``gather`` or
``sparse`` (``bench/baseline.py``).  The summary lines give each graph's
route (``dense_tiles``, ``streamed``, ``block_diag``).
"""

from __future__ import annotations

import argparse
import copy
import gc
import sys
import traceback

import torch

from tcgnn_tpu_torch.bench.datasets import AE_TABLE, AGNN_CONFIG, GCN_CONFIG

ROUTE_KEYS = ("dense_tiles", "streamed", "block_diag")


def run_one(module_main, name, dim, classes, args, extra=()):
    """``module_main`` on one graph: the epoch ms (``train_ms``) of a
    training run and its route (None for the baseline), or the statistics
    dict of a ``--single_kernel`` run; None where the run raised."""
    is_trainer = module_main.__module__ == "tcgnn_tpu_torch.train"
    argv = [
        "--dataset", name,
        "--dim", str(dim),
        "--classes", str(classes),
        "--epochs", str(args.epochs),
        "--model", args.model,
        "--num_layers", str(args.num_layers),
        "--hidden", str(args.hidden),
        "--data_dir", args.data_dir,
        "--dtype", args.dtype,
        "--device", args.device,
        *(("--reorder", args.reorder) if args.reorder != "none" and is_trainer else ()),
        *extra,
    ]
    r = None
    try:
        r = module_main(argv)
        if "train_ms" not in r:
            return r
        route = tuple(r[k] for k in ROUTE_KEYS) if is_trainer else None
        return r["train_ms"], route
    except Exception:
        traceback.print_exc()
        return None
    finally:
        # The trainer's result holds the graph and the dataset: drop them
        # after every run, so the next graph starts on an empty card.
        del r
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _ms(res):
    return None if res is None else res[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="gcn", choices=["gcn", "gin", "agnn"])
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument(
        "--baseline_epochs", type=int, default=50,
        help="epoch count for the baseline runs: both sides report an AVERAGE epoch, so "
        "the baseline needs fewer epochs for the same average",
    )
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--skip_baseline", action="store_true")
    p.add_argument(
        "--baseline_impl", default="gather", choices=["gather", "sparse"],
        help="incumbent: a row gather and index_add_, or torch.sparse (bench/baseline.py)",
    )
    p.add_argument(
        "--eval", action="store_true",
        help="report train/test accuracy per dataset (real-label parity check once real "
        ".npz graphs are present in --data_dir)",
    )
    p.add_argument("--reorder", default="none", choices=["none", "rcm", "community"])
    p.add_argument(
        "--single_kernel", action="store_true",
        help="profile one SAG SpMM and SDDMM per dataset instead of training "
        "(the reference's 2_tcgnn_single_kernel.py sweep)",
    )
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = AGNN_CONFIG if args.model == "agnn" else GCN_CONFIG
    if args.num_layers is None:
        args.num_layers = cfg["num_layers"]
    if args.hidden is None:
        args.hidden = cfg["hidden"]

    table = [
        (n, d, c) for n, d, c in AE_TABLE if args.datasets is None or n in args.datasets
    ]

    from tcgnn_tpu_torch import train as tcgnn_train
    from tcgnn_tpu_torch.bench import baseline as torch_baseline

    if args.single_kernel:
        # d=96, as 2_tcgnn_single_kernel.py:27-33, with the per-kernel rate
        # columns of train.profile_sag (edges/s, TFLOP/s, MFU).
        out = "2_tcgnn_single_kernel.csv"
        rows = []
        with open(out, "w") as f:
            f.write(
                "dataset,SAG avg (ms),edges_per_s,useful_TFLOPs,"
                "tile_TFLOPs,MFU (%),SDDMM avg (ms),sddmm_edges_per_s\n"
            )
            for name, _, classes in table:
                print(f"=== {name} (single kernel) ===", flush=True)
                r = run_one(tcgnn_train.main, name, 96, classes, args,
                            extra=("--single_kernel",))
                if r is not None:
                    rows.append((name, r))
                    f.write(
                        f"{name},{r['ms']:.3f},{r['edges_per_s']:.4g},"
                        f"{r['useful_tflops']:.4f},{r['tile_tflops']:.3f},"
                        f"{r['mfu_pct']:.2f},{r['sddmm_ms']:.3f},"
                        f"{r['sddmm_edges_per_s']:.4g}\n"
                    )
                    f.flush()
        print(f"wrote {out}")
        return rows

    rows = []
    bench_csv = f"1_bench_{args.model}.csv"
    fig_csv = f"Fig_6a_torch_{args.model}.csv"
    f_bench = open(bench_csv, "w")
    f_bench.write("dataset,Avg.Epoch (ms)\n")
    f_fig = None
    if not args.skip_baseline:
        f_fig = open(fig_csv, "w")
        # The epoch counts ride in the CSV: a per-epoch average depends on
        # the run's length.
        f_fig.write(
            "dataset,torch_baseline,tcgnn_torch,speedup,"
            "tcgnn_torch_hoisted,speedup_hoisted,"
            "tcgnn_epochs,baseline_epochs\n"
        )
    hoistable = args.model in ("gcn", "gin")
    for name, dim, classes in table:
        print(f"=== {name} (dim={dim}, classes={classes}) ===", flush=True)
        eval_extra = ("--eval",) if args.eval else ()
        res = run_one(tcgnn_train.main, name, dim, classes, args,
                      extra=("--no_hoist",) + eval_extra)
        res_hoisted = (
            run_one(tcgnn_train.main, name, dim, classes, args, extra=eval_extra)
            if hoistable else res
        )
        ours, ours_hoisted = _ms(res), _ms(res_hoisted)
        base = None
        if not args.skip_baseline:
            bargs = copy.copy(args)
            bargs.epochs = args.baseline_epochs
            base = _ms(run_one(torch_baseline.main, name, dim, classes, bargs,
                               extra=("--impl", args.baseline_impl)))
        route = None if res is None else res[1]
        rows.append((name, base, ours, ours_hoisted, route))
        if ours is not None:
            f_bench.write(f"{name},{ours:.3f}\n")
            f_bench.flush()
        if f_fig is not None and base is not None and ours is not None:
            oh = f"{ours_hoisted:.3f}" if ours_hoisted is not None else ""
            sph = f"{base / ours_hoisted:.3f}" if ours_hoisted is not None else ""
            f_fig.write(
                f"{name},{base:.3f},{ours:.3f},{base / ours:.3f},{oh},{sph},"
                f"{args.epochs},{args.baseline_epochs}\n"
            )
            f_fig.flush()
    f_bench.close()
    print(f"wrote {bench_csv}")
    if f_fig is not None:
        f_fig.close()
        print(f"wrote {fig_csv}")

    for name, base, ours, ours_h, route in rows:
        b = f"{base:8.3f}" if base is not None else "    FAIL"
        o = f"{ours:8.3f}" if ours is not None else "    FAIL"
        oh = f"{ours_h:8.3f}" if ours_h is not None else "    FAIL"
        sp = f"{base / ours:6.2f}x" if base and ours else "      -"
        rt = " ".join(f"{k}={v}" for k, v in zip(ROUTE_KEYS, route)) if route else "-"
        print(
            f"{name:20s} baseline {b} ms   tcgnn_torch {o} ms "
            f"(hoisted {oh})   speedup {sp}   route {rt}"
        )
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
