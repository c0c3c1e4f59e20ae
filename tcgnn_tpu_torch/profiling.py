"""Where an epoch's time goes, from one ``torch.profiler`` trace (the port's
counterpart of ``tcgnn_tpu.utils.profiling.trace``).

``trace(log_dir, device, epochs)`` traces the epochs run inside it, writes
the trace to ``log_dir/trace.json`` (Chrome trace format) and prints, per
epoch: the device's busy time (the union of its kernel and copy intervals,
so overlapping work counts once), the idle share of the device window (the
first device operation's start to the last one's end), the device
operations, and the largest device items.  The trainer wraps its timed
epochs in it under ``--profile_dir``.  ``device_ms`` is the device time per
call of one function (a kernel or its plain version).  ``op_stats`` and
``kernel_report`` turn a time a round of ``--single_kernel`` into edges/s
and TFLOP/s, with the keys of ``tcgnn_tpu.utils.profiling``.

Run on the card from the repository root:
    python -m tcgnn_tpu_torch.profiling [OUT_DIR [GROUP ...]]
    # groups: pubmed, bd (and K5-K7), edges (and K4), reddit, bd_mesh, reddit_mesh, mesh
    python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --profile_dir prof/
"""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

TOP_ITEMS = 8

# The card's nominal dense BF16 tensor-core peak: NVIDIA H100 80GB HBM3 (the
# SXM5 part) at its 700 W power limit, NVIDIA's data sheet figure (989.4
# TFLOP/s without sparsity), not a measurement.  ``mfu_pct`` is quoted
# against it, as the JAX package quotes its chip's nominal peak.
PEAK_BF16_TFLOPS = 989.4


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _device_events(prof):
    """The trace's device operations (kernels, copies, sets).  Annotations
    on the device timeline, such as the optimizer step's, span other
    operations and are left out."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(prof, epochs: int) -> dict:
    """Per-epoch device figures of a finished trace; ``None`` where the
    trace holds no device operation (off the card)."""
    events = _device_events(prof)
    if not events:
        return {"epochs": epochs, "busy_ms": None, "idle_share": None, "device_ops": 0, "top": []}
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    busy = union_us(spans)
    window = max(s[1] for s in spans) - min(s[0] for s in spans)
    per_key = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per_key[e.key][0] += e.time_range.end - e.time_range.start
        per_key[e.key][1] += 1
    top = sorted(per_key.items(), key=lambda kv: -kv[1][0])[:TOP_ITEMS]
    return {
        "epochs": epochs,
        "busy_ms": busy / 1e3 / epochs,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "device_ops": len(events) / epochs,
        "top": [(key, us / 1e3 / epochs, calls / epochs) for key, (us, calls) in top],
    }


def print_summary(s: dict) -> None:
    if s["busy_ms"] is None:
        print("Profile: device time not measured (the trace holds no CUDA operation)")
        return
    print("Profile: device busy {:.4f} ms/epoch, idle share {:.4f} of the device window, "
          "{:.0f} device ops/epoch, over {} epochs"
          .format(s["busy_ms"], s["idle_share"], s["device_ops"], s["epochs"]))
    for key, ms, calls in s["top"]:
        print("  {:.4f} ms/epoch  {:.0f} calls  {}".format(ms, calls, key[:110]))


@contextlib.contextmanager
def trace(log_dir: str | None, device: torch.device, epochs: int):
    """Traces the block under ``torch.profiler`` when ``log_dir`` is set;
    yields a dict that holds the summary once the block has ended.  The
    block must synchronize the device before it ends."""
    summary: dict = {}
    if not log_dir:
        yield summary
        return
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield summary
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}")
    summary.update(summarize(prof, max(epochs, 1)))
    print_summary(summary)


def op_stats(num_edges: int, feature_dim: int, seconds: float) -> dict:
    """Throughput of one aggregation pass over the whole graph: edges/s and
    the useful TFLOP/s, 2 operations (a multiply and an add) an edge and
    feature."""
    edges_per_s = num_edges / seconds if seconds > 0 else float("inf")
    tflops = 2.0 * num_edges * feature_dim / seconds / 1e12 if seconds > 0 else 0.0
    return {"edges_per_s": edges_per_s, "useful_tflops": tflops}


def kernel_report(num_edges: int, exp_edges: int, feature_dim: int, seconds: float,
                  peak_tflops: float = PEAK_BF16_TFLOPS) -> dict:
    """``op_stats`` plus the tile work: ``tile_tflops`` = 2 * Exp_Edges * d
    / t (Exp_Edges = TC_Blocks * blk_h * blk_w, the dense tile work a
    tensor-core kernel would issue) and ``mfu_pct`` against ``peak_tflops``.
    ``d`` is the true width: the JAX package rounds it up to its lane width,
    a TPU layout rule."""
    stats = op_stats(num_edges, feature_dim, seconds)
    tile_tflops = 2.0 * exp_edges * feature_dim / seconds / 1e12 if seconds > 0 else 0.0
    stats["tile_tflops"] = tile_tflops
    stats["mfu_pct"] = 100.0 * tile_tflops / peak_tflops
    return stats


def is_fill(event) -> bool:
    """A device operation that sets memory (a memset, or PyTorch's fill
    kernel behind ``torch.zeros``), such as the zeroing of K4's score tiles."""
    key = event.key.lower()
    return "memset" in key or "fillfunctor" in key


def device_ms(fn, calls: int = 25, fills: bool = True) -> float:
    """Device time per call of ``fn`` (the sum of its device operations),
    after 3 warm-up calls; ``fills=False`` leaves out the operations that
    set memory (``is_fill``), so a kernel's own time stands apart from the
    zeroing of its output."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in _device_events(prof)
               if fills or not is_fill(e)) / calls / 1e3


# Where the ``edges`` group's graphs are written, under ``main``'s out_dir.
EDGE_DATA = "<out_dir>/data"
# Configurations of ``main``, by group: pubmed's (the condensed route), the
# BD route's, reddit's (the streamed route), the per-edge AGNN route's (the
# two directed graphs of ``data/edge_graphs.py``, as chip_smoke.py trains
# them), the one-card mesh's, its block-diagonal route's (Yeast) and its
# streamed route's (reddit).  Each runs with the profiler off and then on.
CONFIGS = {
    "bd": (
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "gcn"],
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "gcn", "--no_hoist"],
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "agnn", "--hidden", "32"],
        ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn"],
    ),
    "pubmed": (  # K1, and K2/K3 (AGNN); host-bound epochs
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "gcn",
         "--no_hoist"],
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2"],
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "agnn",
         "--hidden", "32", "--num_layers", "4"],
    ),
    "edges": (  # K4 and weighted K1 (asymmetric), K4, weighted K5 and K1 (banded)
        ["--data_dir", EDGE_DATA, "--dataset", "asymmetric", "--dim", "64", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2"],
        ["--data_dir", EDGE_DATA, "--dataset", "banded", "--dim", "64", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2"],
    ),
    "reddit": (
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "gcn"],
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2"],
    ),
    "bd_mesh": (  # the distributed block-diagonal route, every shard on this one card
        ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn", "--mesh",
         "4x1"],
        ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "agnn", "--hidden",
         "32", "--num_layers", "2", "--mesh", "2x2"],
    ),
    "reddit_mesh": (  # the distributed streamed route, every shard on this one card
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "gcn", "--mesh",
         "4x1"],
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2", "--mesh", "2x2"],
    ),
    "mesh": (  # every shard of the mesh on this one card
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "gcn",
         "--mesh", "4x2"],
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2", "--mesh", "4x2"],
        ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2", "--mesh", "8x1"],
    ),
}


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(out_dir: str = "prof_traces", *groups: str) -> None:
    """The epochs of the given groups of ``CONFIGS`` (all by default), each
    run with the profiler off and then on (traces under ``out_dir``); with
    the ``pubmed`` group K2/K3 against their plain versions at pubmed's
    shapes, with the ``bd`` group K5-K7 at DD's and K2/K3 on its
    residual, with the ``edges`` group K4 on its two graphs (their
    datasets written to ``out_dir/data`` first)."""
    from tcgnn_tpu_torch import TileConfig, TiledGraph, train  # train imports this module
    from tcgnn_tpu_torch.data import edge_graphs, synthesize
    from tcgnn_tpu_torch.ops import (
        bd_sfused, bd_sfused_bwd, bd_sfused_bwd_torch, bd_sfused_torch, sddmm_tc_dense,
        sddmm_tc_dense_torch, spmm_block_diag, spmm_block_diag_torch, spmm_sfused,
        spmm_sfused_bwd, spmm_sfused_bwd_torch, spmm_sfused_torch,
    )

    def sfused_lines(name, meta, tiles, index, gen):
        """K2 and K3 over ``index`` and their plain versions, device time at
        d=32 and 3 (AGNN's hidden and pubmed's class width)."""
        for d in (32, 3):
            x = torch.randn(meta.num_rows, d, device=dev, generator=gen) * 0.3
            dy = torch.randn(meta.num_rows, d, device=dev, generator=gen)
            print("device K2 {} d={}: kernel {:.4f} ms, plain {:.4f} ms".format(
                name, d, device_ms(lambda: spmm_sfused(x, x, x, meta, tiles, index=index)),
                device_ms(lambda: spmm_sfused_torch(x, x, x, meta, tiles))))
            print("device K3 {} d={}: kernel {:.4f} ms, plain {:.4f} ms".format(
                name, d, device_ms(lambda: spmm_sfused_bwd(x, dy, meta, tiles, index=index)),
                device_ms(lambda: spmm_sfused_bwd_torch(x, dy, meta, tiles))))

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    groups = groups or tuple(CONFIGS)
    print(card_line())
    data_dir = os.path.join(out_dir, "data")
    if "edges" in groups:
        os.makedirs(data_dir, exist_ok=True)
        graphs = {"asymmetric": edge_graphs.asymmetric_graph, "banded": edge_graphs.banded_graph}
        for name, graph in graphs.items():
            edge_graphs.write_npz(data_dir, name, graph)
    for group in groups:
        for i, argv in enumerate(CONFIGS[group]):
            argv = [data_dir if a == EDGE_DATA else a for a in argv]
            for extra in ([], ["--profile_dir", os.path.join(out_dir, f"{group}{i}")]):
                print("---", " ".join(argv + extra))
                train.main([*argv, "--epochs", "50", *extra])
                torch.cuda.empty_cache()
    dev = torch.device("cuda")
    if "edges" in groups:
        gen = torch.Generator(device=dev).manual_seed(0)
        for name, graph in graphs.items():
            n, rp, ci = graph()
            g = TiledGraph(rp, ci, n, TileConfig(), device=dev)
            meta = g._sddmm_meta
            for d in (32, 22):  # AGNN's hidden and class widths (the trainer's 22)
                x = torch.randn(n, d, device=dev, generator=gen) * 0.3
                print("device K4 {} d={} ({} edges): kernel {:.4f} ms, plain {:.4f} ms".format(
                    name, d, meta.num_edges, device_ms(lambda: sddmm_tc_dense(x, meta)),
                    device_ms(lambda: sddmm_tc_dense_torch(x, meta))))
    if "pubmed" in groups:
        ds = synthesize("pubmed", seed=0)
        g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, TileConfig(), device=dev)
        sfused_lines("pubmed", g.meta, g.a_struct, g.sfused_index,
                     torch.Generator(device=dev).manual_seed(0))
    if "bd" not in groups:
        return

    ds = synthesize("DD", 89, 2)
    g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, TileConfig(), device=dev)
    p, offs, cfg, n = g.bd.pack, g.bd_offsets, TileConfig(), ds.num_nodes
    index = g.bd.row_index
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (2, 16, 89):
        x = torch.randn(n, d, device=dev, generator=gen)
        print("device K5 DD d={}: kernel {:.4f} ms, plain {:.4f} ms".format(
            d, device_ms(lambda: spmm_block_diag(x, p, offsets=offs, cfg=cfg)),
            device_ms(lambda: spmm_block_diag_torch(x, p, offsets=offs, cfg=cfg))))
    for d in (32, 2):
        x = torch.randn(n, d, device=dev, generator=gen) * 0.3
        dy = torch.randn(n, d, device=dev, generator=gen)
        print("device K6 DD d={}: kernel {:.4f} ms, plain {:.4f} ms".format(
            d, device_ms(lambda: bd_sfused(x, x, x, p, offsets=offs, cfg=cfg, index=index)),
            device_ms(lambda: bd_sfused_torch(x, x, x, p, offsets=offs, cfg=cfg))))
        print("device K7 DD d={}: kernel {:.4f} ms, plain {:.4f} ms".format(
            d, device_ms(lambda: bd_sfused_bwd(x, dy, p, offsets=offs, cfg=cfg, index=index)),
            device_ms(lambda: bd_sfused_bwd_torch(x, dy, p, offsets=offs, cfg=cfg))))
    sfused_lines("DD residual", g.bd.res_meta, g.bd.res_a, g.bd.res_index, gen)


if __name__ == "__main__":
    main(*sys.argv[1:])
