"""The device trace of a run: busy time, idle share, the port's kernels' time.

A ``torch.profiler`` trace of CPU and CUDA activity around the traced
epochs.  Its arithmetic is copied from the port's ``profiling.union_us`` and
``profiling.summarize`` (busy time is the union of the device operations'
intervals, idle the rest of the window), and its guard from
``chip_smoke.py``'s ``device_launches`` and ``pad_trace`` (each end of the
trace holds ``TRACE_PADS`` spin kernels and ``TRACE_MARGIN_S`` of idle card,
and a trace whose first or last device operation is not a pad raises,
since it may have lost operations of the block), both at commit
195b8b7aa21a1e60ca085967e6c41ad999d11eea.

The port's own kernels are found by name at run time (``port_kernels``):
every ``__global__`` function in the package's ``csrc/`` and every
``@triton.jit`` function in its Python files, so a kernel added or renamed
later needs no change here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_PADS = 1024
TRACE_MARGIN_S = 0.1
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
TOP = 10

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)\s*\(")
_IDENT = re.compile(r"\w+")


def port_kernels(package_dir) -> frozenset:
    """The names of the port's own kernels: the ``__global__`` functions of
    its CUDA sources and the ``@triton.jit`` functions of its Python files."""
    root = Path(package_dir)
    names = set()
    for path in sorted(root.rglob("*.cu")) + sorted(root.rglob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        if "triton.jit" in text:
            names.update(_TRITON.findall(text))
    return frozenset(names)


def is_port_kernel(name: str, kernels: frozenset) -> bool:
    """Whether a device operation's (demangled) name is one of ``kernels``."""
    return any(tok in kernels for tok in _IDENT.findall(name))


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals (copied from
    ``tcgnn_tpu_torch.profiling.union_us``)."""
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


def _gaps(intervals):
    """``(start, end)`` of the idle stretches between merged intervals."""
    out, cur_end = [], None
    for start, end in sorted(intervals):
        if cur_end is not None and start > cur_end:
            out.append((cur_end, start))
        cur_end = end if cur_end is None else max(cur_end, end)
    return out


@dataclasses.dataclass
class Trace:
    """What the trace of ``epochs`` epochs holds (seconds)."""

    epochs: int
    window_s: float     # first device operation's start to the last one's end
    busy_s: float       # union of the device operations
    kernel_s: float     # the port's kernels, summed
    other_s: float      # every other device operation, summed
    device_ops: list    # [[name, seconds], ...] the largest, summed by name
    idle_gaps: list     # [[what the host was doing, seconds], ...] the longest

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0


def pad() -> None:
    """``TRACE_PADS`` spin kernels, then ``TRACE_MARGIN_S`` of idle card."""
    for _ in range(TRACE_PADS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(TRACE_MARGIN_S)


@contextlib.contextmanager
def traced(kernels: frozenset, epochs: int):
    """Traces the block, which runs ``epochs`` epochs, padded at both ends;
    yields a dict that holds the ``Trace`` under ``"trace"`` once the block
    has ended.  The block must synchronize the device before it ends."""
    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad()
        yield out
        pad()
    out["trace"] = read(prof, kernels, epochs)


def read(prof, kernels: frozenset, epochs: int) -> Trace:
    """The ``Trace`` of a finished, padded profile.  Raises where the trace's
    first or last device operation is not a pad."""
    dev, host = [], []
    # The raw events: ``prof.events()`` would build the whole event tree first.
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        span = (start, start + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(span)
    dev.sort()
    pads = sum(PAD_KERNEL in name for _, _, name in dev)
    if not (dev and PAD_KERNEL in dev[0][2] and PAD_KERNEL in dev[-1][2]):
        raise RuntimeError(f"the trace's first or last device operation is not a pad kernel "
                           f"(it kept {pads} of its {2 * TRACE_PADS}), so it may have lost "
                           "operations of the traced epochs")
    ops = [d for d in dev if PAD_KERNEL not in d[2]]
    if not ops:
        raise RuntimeError("the trace holds no device operation between its pads")
    spans = [(s, e) for s, e, _ in ops]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    per_name = collections.defaultdict(float)
    kernel_ns = other_ns = 0
    for s, e, name in ops:
        per_name[name] += e - s
        if is_port_kernel(name, kernels):
            kernel_ns += e - s
        else:
            other_ns += e - s
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(_gaps(spans), key=lambda g: g[0] - g[1])[:TOP]
    return Trace(
        epochs=epochs,
        window_s=window / 1e9,
        busy_s=union_us(spans) / 1e9,
        kernel_s=kernel_ns / 1e9,
        other_s=other_ns / 1e9,
        device_ops=[[name, ns / 1e9] for name, ns in top],
        idle_gaps=[[_host_at((s + e) / 2, host), (e - s) / 1e9] for s, e in gaps],
    )


def _host_at(t: float, host) -> str:
    """The innermost host operation under way at ``t`` (the latest-starting
    one that covers it), or ``"no traced host operation"``."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best is not None else "no traced host operation"
