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

``RECORDER`` is the port's one recorder of spans.  Host spans
(``span(name)``) hold a name, start, end and parent, are kept in memory and
open a ``torch.profiler.record_function`` range of the same name, so a
trace shows them on its own clock: the host passes' stages (``prep.*``,
summed into ``TiledGraph.prep_stages``), ``graph.upload`` and
``graph.row_index`` (closed by one synchronize on the card),
``step.optimizer_build`` and ``step.hoist``.  Device stamps mark the phases
inside the training step (``PHASES``): a replay of the step's CUDA graph
runs no Python, so only a one-thread kernel captured into the graph, which
writes ``%globaltimer`` into a ring on the card (``DeviceStamps``,
``csrc/stamp.cu``), can mark them.  Stamps are recorded only while a step
is captured (or run eagerly) inside ``RECORDER.stamps_into``: the
instrumented twin of ``TrainStep.span_ms``, which ``many`` never replays.
``phase_ms`` turns a twin's stamps into device ms an epoch by phase.

Run on the card from the repository root:
    python -m tcgnn_tpu_torch.profiling [OUT_DIR [GROUP ...]]
    # groups: pubmed, bd (and K5-K7), edges (and K4), reddit, bd_mesh, reddit_mesh, mesh
    python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --profile_dir prof/
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tcgnn_tpu_torch.ops import _kernels

TOP_ITEMS = 8

# The card's nominal dense BF16 tensor-core peak: NVIDIA H100 80GB HBM3 (the
# SXM5 part) at its 700 W power limit, NVIDIA's data sheet figure (989.4
# TFLOP/s without sparsity), not a measurement.  ``mfu_pct`` is quoted
# against it, as the JAX package quotes its chip's nominal peak.
PEAK_BF16_TFLOPS = 989.4

# The leaf phases of a training step, in the order a step runs them: a
# stamp opens each top-level phase and closes the one before, and the
# aggregations' own stamps open and close ``agg.fwd`` inside ``forward``
# and ``agg.bwd`` inside ``backward`` (``graph.py``'s four autograd
# Functions).  ``forward`` and ``backward`` keep what their aggregations
# leave: the dense layers, the dropout, the log-softmax.
PHASES = ("forward", "agg.fwd", "loss.fwd", "loss.bwd", "backward", "agg.bwd", "optimizer")
_TOP = ("forward", "loss.fwd", "loss.bwd", "backward", "optimizer", "end")
_NESTED = {"agg.fwd": "forward", "agg.bwd": "backward"}
# Stamps a step may hold, replays a ring holds between two reads, and host
# spans the recorder keeps.
MAX_STAMPS = 256
RING_ROWS = 64
KEEP_SPANS = 4096


@dataclasses.dataclass
class Span:
    """A host span: ``start`` and ``end`` in ``time.perf_counter`` seconds;
    ``parent`` is the span that was open when it opened."""

    name: str
    start: float
    end: float | None = None
    parent: "Span | None" = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """Host spans, kept in memory (the latest ``KEEP_SPANS``), and the sink
    of the device stamps while a step is recorded with them."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=KEEP_SPANS)
        self._open: list = []
        self._stamps = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around the block, and a profiler range of its name."""
        s = Span(name, time.perf_counter(), parent=self._open[-1] if self._open else None)
        self._open.append(s)
        try:
            with record_function(name):
                yield s
        finally:
            s.end = time.perf_counter()
            self._open.pop()
            self.spans.append(s)

    def last(self, name: str) -> Span | None:
        """The latest closed span of ``name``."""
        return next((s for s in reversed(self.spans) if s.name == name), None)

    @property
    def stamping(self) -> bool:
        return self._stamps is not None

    @contextlib.contextmanager
    def stamps_into(self, sink):
        """Records the stamps of the block into ``sink``: a ``DeviceStamps``
        on the card, or any object with ``stamp(label, last)``."""
        if self._stamps is not None:
            raise RuntimeError("stamps are already being recorded")
        self._stamps = sink
        try:
            yield sink
        finally:
            self._stamps = None

    def stamp(self, label: str, last: bool = False) -> None:
        """A stamp of ``label`` while stamps are recorded (``last``: the
        step's final stamp, which moves the ring to its next row); nothing
        otherwise."""
        if self._stamps is not None:
            self._stamps.stamp(label, last)


RECORDER = Recorder()
span = RECORDER.span


class _Mark(torch.autograd.Function):
    """The identity, whose backward stamps ``label``: the point where the
    gradient reaches the tensor."""

    @staticmethod
    def forward(ctx, x, label):
        ctx.label = label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        RECORDER.stamp(ctx.label)
        return grad, None


def mark(x: torch.Tensor, label: str) -> torch.Tensor:
    """``x`` with a stamp of ``label`` where its gradient arrives, while
    stamps are recorded; ``x`` itself, and no Function, otherwise."""
    return _Mark.apply(x, label) if RECORDER.stamping else x


class DeviceStamps:
    """Stamps on the card: a ring of ``RING_ROWS`` x ``MAX_STAMPS`` int64
    ``%globaltimer`` readings (ns), one row a replay, at the row a counter
    on the card selects; the step's last stamp advances the counter.  Each
    stamp's slot and label are fixed when it is launched, in launch order,
    which is the order of the stream the step runs on.  The library is
    built at the first ``DeviceStamps``, and its kernel runs once here,
    outside any capture."""

    def __init__(self, device: torch.device):
        self.device, self.rows = device, RING_ROWS
        self.ring = torch.zeros(RING_ROWS, MAX_STAMPS, dtype=torch.int64, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)
        self.labels: list = []
        self._launch(0, False)
        torch.cuda.synchronize(device)

    def _launch(self, slot: int, last: bool) -> None:
        _kernels.call("stamp", "tcgnn_stamp", self.device, self.ring.data_ptr(),
                      self.counter.data_ptr(), slot, MAX_STAMPS, self.rows, int(last),
                      _kernels.stream_of(self.ring))

    def stamp(self, label: str, last: bool) -> None:
        if len(self.labels) == MAX_STAMPS:
            raise RuntimeError(f"a step holds at most {MAX_STAMPS} stamps")
        self._launch(len(self.labels), last)
        self.labels.append(label)

    def rewind(self) -> None:
        """The next replay writes row 0."""
        self.counter.zero_()

    def read(self, replays: int) -> np.ndarray:
        """The first ``replays`` rows since ``rewind``, ``[replays, stamps]``
        ns (synchronizes)."""
        return self.ring[:replays, :len(self.labels)].cpu().numpy()


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> dict:
    """The kernel, memset and copy nodes of a CUDA graph captured with
    ``keep_graph=True``, child graphs' nodes included, read from the graph
    itself (``cudaGraphGetNodes``, ``cudaGraphNodeGetType``)."""
    counts = (ctypes.c_int * 4)()
    lib = _kernels.load("stamp")
    _kernels.check(lib, lib.tcgnn_graph_nodes(graph.raw_cuda_graph(), ctypes.addressof(counts)),
                   "stamp")
    return {"kernel": counts[0], "memset": counts[1], "memcpy": counts[2]}


def leaf_phases(labels) -> list:
    """The leaf phase (of ``PHASES``) of each interval between consecutive
    stamps; raises where the labels do not nest and follow each other as a
    step's phases do: ``forward`` first and ``end`` last, the top-level
    phases in the order of ``_TOP``, each aggregation opened and closed
    inside its phase."""
    labels = list(labels)
    if not labels or labels[0] != "forward" or labels[-1] != "end":
        raise ValueError(f"a step's stamps run from 'forward' to 'end', got {labels}")
    stack, top, leaves = [], -1, []
    for i, label in enumerate(labels):
        if label.startswith("/"):
            if stack[-1] != label[1:] or len(stack) < 2:
                raise ValueError(f"stamp {i}: {label} closes {stack[-1]}")
            stack.pop()
        elif label in _NESTED:
            if stack != [_NESTED[label]]:
                raise ValueError(f"stamp {i}: {label} opens inside {stack}")
            stack.append(label)
        elif label in _TOP and _TOP.index(label) > top and len(stack) <= 1:
            top, stack = _TOP.index(label), [label]
        else:
            raise ValueError(f"stamp {i}: {label} out of order after {stack}")
        if i < len(labels) - 1:
            leaves.append(stack[-1])
    return leaves


def phase_ms(labels, stamps_ns: np.ndarray) -> dict:
    """Device ms an epoch of each leaf phase, the median over the replays
    (the rows of ``stamps_ns``), with ``epoch`` (first stamp to last),
    ``replays`` and ``tick_ns``, the greatest common divisor of the
    intervals read: the timer's resolution as the card shows it."""
    leaves = leaf_phases(labels)
    ns = np.asarray(stamps_ns, dtype=np.int64)
    gaps = np.diff(ns, axis=1)
    out = {}
    for phase in PHASES:
        cols = [i for i, leaf in enumerate(leaves) if leaf == phase]
        out[phase] = float(np.median(gaps[:, cols].sum(axis=1))) / 1e6
    out["epoch"] = float(np.median(ns[:, -1] - ns[:, 0])) / 1e6
    out["replays"] = int(ns.shape[0])
    positive = gaps[gaps > 0]
    out["tick_ns"] = int(np.gcd.reduce(positive)) if positive.size else 0
    return out


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


def summarize(prof, epochs: int, before: float | None = None) -> dict:
    """Per-epoch device figures of a finished trace, over the device
    operations that start before ``before`` (the trace's µs; all of them
    by default); ``None`` where the trace holds no device operation (off
    the card)."""
    events = [e for e in _device_events(prof) if before is None or e.time_range.start < before]
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


# The profiler range around ``trace``'s tail.
TAIL_RANGE = "spans.twin"


@contextlib.contextmanager
def trace(log_dir: str | None, device: torch.device, epochs: int, tail=None):
    """Traces the block under ``torch.profiler`` when ``log_dir`` is set;
    yields a dict that holds the summary once the block has ended.  The
    block must synchronize the device before it ends.  ``tail``, a
    function, runs after the block inside the trace, in a range named
    ``TAIL_RANGE`` (the trainer replays the stamped twin of its step there,
    so the trace shows the stamps between their phases); the summary leaves
    its device operations out."""
    summary: dict = {}
    if not log_dir:
        yield summary
        return
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield summary
        if tail is not None:
            with record_function(TAIL_RANGE):
                tail()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}")
    before = next((e.time_range.start for e in prof.events() if e.name == TAIL_RANGE), None)
    summary.update(summarize(prof, max(epochs, 1), before))
    print_summary(summary)


# The set-up spans ``print_phases`` shows.
SETUP_SPANS = ("graph.upload", "graph.row_index", "step.optimizer_build", "step.hoist")


def print_phases(phases: dict | None, nodes: dict | None, summary: dict) -> None:
    """The trainer's ``--profile_dir`` table: the step's phases from its
    stamped twin (``TrainStep.span_ms``), its graph's nodes beside the
    device operations an epoch the trace counted, and the set-up spans."""
    if phases is None:
        print("Phases: device time not measured (no stamped CUDA graph of the step)")
    else:
        print("Phases (device ms an epoch, median of {} replays of the stamped step; "
              "timer tick {} ns):".format(phases["replays"], phases["tick_ns"]))
        for phase in PHASES:
            print("  {:<10} {:.4f}".format(phase, phases[phase]))
        print("  {:<10} {:.4f} (sum {:.4f})".format(
            "epoch", phases["epoch"], sum(phases[p] for p in PHASES)))
    if nodes is not None:
        print("Step graph: {} nodes a replay (kernel {}, memset {}, copy {}); the trace: {} "
              "device ops an epoch".format(sum(nodes.values()), nodes["kernel"], nodes["memset"],
                                           nodes["memcpy"], summary.get("device_ops")))
    spans = [(n, RECORDER.last(n)) for n in SETUP_SPANS]
    print("Set-up spans (s):\t" + "  ".join(
        "{} {:.4f}".format(n, s.seconds) for n, s in spans if s is not None))


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
