"""The readings a cell's limits are set from, at the cell's own size, on the card.

    python3 -m benchmark.calibrate --workload gcn-amazon0505 --seeds 101-112 \\
        --control 3 --fault 3 [--out readings.jsonl]

For each seed it drives the program's first steps as a run does
(``program.first_steps``) and compares them with the reference's
(``correct.gaps``):

* ``program``: the configuration as stated, every seed: the lower readings;
* ``control``: the program in the nearest lower precision, its own
  bfloat16 path (``TileConfig.compute_dtype``), the first ``--control``
  seeds: the upper readings;
* ``half_batch``: the program with its loss taken over half the nodes (the
  trainer's ``F.nll_loss`` replaced for the build and the steps), the first
  ``--fault`` seeds: a fault the check must catch.

A step that leaves its state unchanged reads 1 on ``change`` by the
measure, and needs no run.  One JSON line a reading goes to standard output
and to ``--out``.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import correct, program, reference, spec, synthetic
from tcgnn_tpu_torch import train


class _HalfBatch:
    """``torch.nn.functional`` with ``nll_loss`` over the first half of the
    rows alone."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def nll_loss(logp, y):
        n = y.shape[0] // 2
        return F.nll_loss(logp[:n], y[:n])


@contextlib.contextmanager
def half_batch():
    saved = train.F
    train.F = _HalfBatch()
    try:
        yield
    finally:
        train.F = saved


def seeds_of(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> list:
    """The readings, each as its JSON line has it."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="first-last, inclusive")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cpu for the tests' small cells")
    p.add_argument("--root", default=None, help="the checkout whose BENCHMARK.json to read")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate: --device cuda, but torch finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload, *([Path(args.root)] if args.root else []))
    lines = []
    config, traffic, model = cell.config, cell.traffic, cell.model
    seeds = seeds_of(args.seeds)
    out = open(args.out, "a") if args.out else None

    def emit(**kw):
        line = json.dumps({"workload": cell.name, **kw})
        lines.append(kw)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    csr = synthetic.make_graph(traffic)
    dims = model.layer_dims(config, traffic)
    data = synthetic.make_dataset(traffic, seeds[0], csr)
    graphs = {"float32": program.build_graph(config, model, data, device)[0]}
    if args.control:
        graphs["bfloat16"] = program.build_graph(config, model, data, device,
                                                 dtype="bfloat16")[0]
    ref_graph = reference.Graph(*csr, device)
    for i, seed in enumerate(seeds):
        x_np, y_np = synthetic.make_features(traffic, seed)
        x = torch.from_numpy(x_np).to(device)
        y = torch.from_numpy(y_np.astype(np.int64)).to(device)
        weights = model.make_weights(config, dims, seed + 2, device)
        program.sync(device)
        t0 = time.perf_counter()
        ref = reference.train(config, model, weights, x, y, ref_graph, seed + 3,
                              correct.FIRST_STEPS)
        program.sync(device)
        ref_s = time.perf_counter() - t0
        runs = [("program", "float32", contextlib.nullcontext)]
        if i < args.control:
            runs.append(("control", "bfloat16", contextlib.nullcontext))
        if i < args.fault:
            runs.append(("half_batch", "float32", half_batch))
        for kind, dtype, ctx in runs:
            with ctx():
                prog = program.build(config, model, dims, graphs[dtype], x, y, weights,
                                     seed + 3)
                got = program.first_steps(prog, weights, correct.FIRST_STEPS)
            del prog
            if device.type == "cuda":
                torch.cuda.empty_cache()
            moving = correct.moving_elements(ref)
            emit(kind=kind, seed=seed, gaps=correct.gaps(got, ref), reference_s=ref_s,
                 program=correct.norms(got, moving), reference=correct.norms(ref, moving))
    if out:
        out.close()
    return lines


if __name__ == "__main__":
    main()
