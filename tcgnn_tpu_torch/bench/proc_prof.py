"""Average numeric metrics across benchmark CSV runs (a copy of
``tcgnn_tpu.bench.proc_prof``).

Analogue of the reference's ``proc_prof.py`` (which averages Nsight-Compute
metrics out of ``ncu --csv`` dumps): given one or more CSVs with a
``dataset`` column and numeric metric columns (the sweep's and log2csv's
outputs), print the per-column mean, and with several files the
per-dataset mean across runs.

Run:  python -m tcgnn_tpu_torch.bench.proc_prof 1_bench_gcn.csv [more.csv ...]
"""

from __future__ import annotations

import csv
import sys
from collections import defaultdict


def reduce_csvs(paths):
    by_key = defaultdict(list)  # (dataset, column) -> values
    columns = []
    for path in paths:
        with open(path) as f:
            reader = csv.DictReader(f)
            for row in reader:
                name = row.get("dataset", "<all>")
                for col, val in row.items():
                    if col == "dataset":
                        continue
                    try:
                        v = float(val)
                    except (TypeError, ValueError):
                        continue
                    if col not in columns:
                        columns.append(col)
                    by_key[(name, col)].append(v)
    return columns, by_key


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m tcgnn_tpu_torch.bench.proc_prof <csv> [...]", file=sys.stderr)
        return 1
    columns, by_key = reduce_csvs(argv)
    datasets = sorted({k[0] for k in by_key})
    print("dataset," + ",".join(f"avg {c}" for c in columns))
    for name in datasets:
        vals = []
        for c in columns:
            v = by_key.get((name, c))
            vals.append(f"{sum(v)/len(v):.3f}" if v else "")
        print(f"{name}," + ",".join(vals))
    # global averages (the reference prints just these)
    overall = []
    for c in columns:
        allv = [v for (n, cc), vs in by_key.items() if cc == c for v in vs]
        overall.append(f"{sum(allv)/len(allv):.3f}" if allv else "")
    print("<overall>," + ",".join(overall))
    return 0


if __name__ == "__main__":
    sys.exit(main())
