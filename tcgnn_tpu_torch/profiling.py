"""Where an epoch's time goes, from one ``torch.profiler`` trace (the port's
counterpart of ``tcgnn_tpu.utils.profiling.trace``).

``trace(log_dir, device, epochs)`` traces the epochs run inside it, writes
the trace to ``log_dir/trace.json`` (Chrome trace format) and prints, per
epoch: the device's busy time (the union of its kernel and copy intervals,
so overlapping work counts once), the idle share of the device window (the
first device operation's start to the last one's end), the device
operations, and the largest device items.  The trainer wraps its timed
epochs in it under ``--profile_dir``.  ``device_ms`` is the device time per
call of one function (a kernel or its plain version).

Run on the card from the repository root:
    python -m tcgnn_tpu_torch.profiling [OUT_DIR [GROUP ...]]  # groups: bd (and K5-K7), reddit, mesh
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


def device_ms(fn, calls: int = 25) -> float:
    """Device time per call of ``fn`` (the sum of its device operations),
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in _device_events(prof)) / calls / 1e3


# Configurations of ``main``, by group: the BD route's epochs and reddit's
# (the streamed route).  Each runs with the profiler off and then on.
CONFIGS = {
    "bd": (
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "gcn"],
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "gcn", "--no_hoist"],
        ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "agnn", "--hidden", "32"],
        ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn"],
    ),
    "reddit": (
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "gcn"],
        ["--dataset", "reddit", "--dim", "602", "--classes", "41", "--model", "agnn",
         "--hidden", "32", "--num_layers", "2"],
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


def main(out_dir: str = "prof_traces", *groups: str) -> None:
    """The epochs of the given groups of ``CONFIGS`` (all by default), each
    run with the profiler off and then on (traces under ``out_dir``), and
    with the ``bd`` group K5-K7 against their plain versions at DD's
    shapes."""
    from tcgnn_tpu_torch import TileConfig, TiledGraph, train  # train imports this module
    from tcgnn_tpu_torch.data import synthesize
    from tcgnn_tpu_torch.ops import (
        bd_sfused, bd_sfused_bwd, bd_sfused_bwd_torch, bd_sfused_torch, spmm_block_diag,
        spmm_block_diag_torch,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    groups = groups or tuple(CONFIGS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for group in groups:
        for i, argv in enumerate(CONFIGS[group]):
            for extra in ([], ["--profile_dir", os.path.join(out_dir, f"{group}{i}")]):
                print("---", " ".join(argv + extra))
                train.main([*argv, "--epochs", "50", *extra])
                torch.cuda.empty_cache()
    if "bd" not in groups:
        return

    ds = synthesize("DD", 89, 2)
    dev = torch.device("cuda")
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


if __name__ == "__main__":
    main(*sys.argv[1:])
