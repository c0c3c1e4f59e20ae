"""Runs one cell of the benchmark once and prints its result as one JSON line.

    python3 -m benchmark.run --workload gcn-amazon0505 --seed 1 --seconds 20 --trace 0

From the root of a checkout, on a machine with an NVIDIA GPU.  The run makes
the cell's inputs from ``--seed`` (``synthetic``), builds the port's
training step (``program``), drives it through its first steps, warms it up,
then runs full-batch epochs back to back for ``--seconds`` (a closed loop:
each epoch is one ``step.many(1)``, a replay of the step's CUDA graph,
dispatched ahead of the card), and checks the first steps against the
plain reference (``reference``, ``correct``).  With ``--trace 0`` the
result holds the end-to-end metrics; with ``--trace 1`` the per-layer ones,
read from a ``torch.profiler`` trace of further epochs (``trace``) and from
the program's counters by the readers in ``metrics/``.

The end-to-end metrics: ``epoch_ms`` (the window's host-clock time over its
epochs, closed by a synchronize), ``epoch_ms_p95`` (the 95th percentile of
the window's epochs, each timed by CUDA events recorded between replays),
``peak_mem_gib`` (``max_memory_allocated`` over set-up and window, read
before the reference runs) and ``setup_s`` (process start to the window,
less the seconds spent making the inputs).

It exits with 1 and prints no result without a card, or with fewer cards
than the cell asks for, or where JAX or the JAX package was loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tcgnn_tpu"})
CHUNK_S = 0.1   # epochs queued between the window's looks at the clock
TRACE_S = 1.0   # length of the traced epochs
GIB = 1 << 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """What the per-layer readers in ``metrics/`` read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def epochs_timed(step, n: int, device) -> tuple:
    """Runs ``n`` epochs: ``(marks, last loss)``, the marks CUDA events
    recorded between the replays on the card, host times on the CPU."""
    import torch

    on_card = device.type == "cuda"

    def mark():
        if not on_card:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    marks, loss = [mark()], None
    for _ in range(n):
        loss = step.many(1)
        marks.append(mark())
    return marks, loss


def window(step, seconds: float, epoch_s: float, device):
    """Epochs back to back for ``seconds``: ``(epochs, wall seconds, each
    epoch's ms, last loss)``.  Chunks of about ``CHUNK_S`` are queued, and
    the clock is read once the chunk before the last has finished, so the
    card always has a chunk queued."""
    from benchmark.program import sync

    chunk = max(1, int(CHUNK_S / max(epoch_s, 1e-6)))
    on_card = device.type == "cuda"
    sync(device)
    start = time.perf_counter()
    marks, pending = [], None
    while True:
        part, loss = epochs_timed(step, chunk, device)
        marks += part if not marks else part[1:]  # chunks meet where they abut
        if on_card:
            if pending is not None:
                pending.synchronize()
            pending = marks[-1]
        if time.perf_counter() - start >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - start
    if on_card:
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks[:-1], marks[1:])]
    return len(ms), wall, ms, loss


def p95(values: list) -> float:
    """The 95th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, root: Path | None = None):
    """One run of ``cell`` (``spec.Cell``) on ``device``: ``(result, checks)``,
    the result line's dict and the compared numbers with their limits."""
    import numpy as np
    import torch

    from benchmark import correct, program, reference, spec, synthetic
    from benchmark import trace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    config, traffic, model = cell.config, cell.traffic, cell.model
    weight_seed, dropout_seed = seed + 2, seed + 3

    marks = [("imports", time.perf_counter())]

    # ---- inputs (left out of setup_s) ----------------------------------
    data = synthetic.make_dataset(traffic, seed)
    marks.append(("inputs", time.perf_counter()))
    input_s = marks[-1][1] - marks[-2][1]

    # ---- set-up: the graph, the step, its first steps, warm-up ----------
    dims = model.layer_dims(config, traffic)
    graph, build_s = program.build_graph(config, model, data, device)
    marks.append(("graph", time.perf_counter()))
    x = torch.from_numpy(data.x).to(device)
    y = torch.from_numpy(data.y.astype(np.int64)).to(device)
    weights = model.make_weights(config, dims, weight_seed, device)
    program.sync(device)
    marks.append(("upload_and_weights", time.perf_counter()))
    prog = program.build(config, model, dims, graph, x, y, weights, dropout_seed)
    program.sync(device)
    marks.append(("step", time.perf_counter()))
    readings = program.first_steps(prog, weights, correct.FIRST_STEPS)
    program.sync(device)
    marks.append(("first_steps", time.perf_counter()))
    t0 = time.perf_counter()
    epochs_timed(prog.step, 3, device)
    program.sync(device)
    guess = (time.perf_counter() - t0) / 3
    n = max(1, math.ceil(0.2 / max(guess, 1e-6)))
    t0 = time.perf_counter()
    epochs_timed(prog.step, n, device)
    program.sync(device)
    epoch_s = (time.perf_counter() - t0) / n
    marks.append(("warm_up", time.perf_counter()))
    setup_s = time.perf_counter() - _START - input_s
    print("set-up stages (s): " + "  ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in zip(marks, [_START] + [t for _, t in marks])),
        file=sys.stderr)

    # ---- the window ------------------------------------------------------
    epochs, wall, ms, last_loss = window(prog.step, seconds, epoch_s, device)
    epoch_ms = wall * 1e3 / epochs
    traced = None
    if trace and on_card:
        n_traced = max(3, math.ceil(TRACE_S / (epoch_ms / 1e3)))
        kernels = tr.port_kernels(Path(sys.modules["tcgnn_tpu_torch"].__file__).parent)
        with tr.traced(kernels, n_traced) as out:
            epochs_timed(prog.step, n_traced, device)
            program.sync(device)
        traced = out["trace"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    final_loss = float(last_loss)

    metrics = {}
    if trace:
        run = Run(config=config, traffic=traffic, dims=dims, num_nodes=data.num_nodes,
                  num_edges=data.num_edges, graph=graph, step=prog.step, graph_build_s=build_s,
                  epoch_ms=epoch_ms, trace=traced, on_card=on_card,
                  counts=model.epoch_counts(config, dims, data.num_nodes, data.num_edges))
        for m in cell.per_layer:
            value = spec.reader(m["name"], root or spec.ROOT)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del run
    else:
        e2e = {"epoch_ms": epoch_ms, "epoch_ms_p95": p95(ms), "peak_mem_gib": peak / GIB,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # ---- the reference, once the program's state is freed ----------------
    del prog, graph, x, y
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref_graph = reference.Graph(data.row_pointers, data.column_index, device)
    ref = reference.train(config, model, model.make_weights(config, dims, weight_seed, device),
                          torch.from_numpy(data.x).to(device),
                          torch.from_numpy(data.y.astype(np.int64)).to(device),
                          ref_graph, dropout_seed, correct.FIRST_STEPS)
    values = correct.gaps(readings, ref)
    moving = correct.moving_elements(ref)
    print("readings: " + json.dumps({"program": correct.norms(readings, moving),
                                     "reference": correct.norms(ref, moving)}), file=sys.stderr)
    checks = {k: {"value": values[k] if math.isfinite(values[k]) else None,
                  "limit": float(cell.limits[k])} for k in correct.NAMES}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {
        "correct": all(correct.passes(values[k], c["limit"]) for k, c in checks.items()),
        "attempted": epochs,
        "failed": 0 if math.isfinite(final_loss) else epochs,
        "metrics": metrics,
        "device": dev,
    }
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"))
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}, which it may not", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
