"""Log -> CSV scraper (a copy of ``tcgnn_tpu.bench.log2csv``; the
reference's ``1_log2csv.py`` contract).

Scrapes ``dataset=<name>`` (or ``dataset='<name>'``, as the trainer's and
the baseline's ``print(args)`` give it) and ``Train (ms):`` lines from a
tee'd log into ``<log>.csv`` with header ``dataset,Avg.Epoch (ms)``;
``Prep.`` lines are skipped like the original.

Run:  python -m tcgnn_tpu_torch.bench.log2csv <logfile>
"""

from __future__ import annotations

import re
import sys


def scrape(lines):
    rows = []
    dataset = None
    for line in lines:
        m = re.search(r"dataset='?([\w.\-]+)'?", line)
        if m:
            dataset = m.group(1)
        if "Prep." in line:
            continue
        m = re.search(r"Train \(ms\):\s*([0-9.]+)", line)
        if m and dataset is not None:
            rows.append((dataset, float(m.group(1))))
            dataset = None
    return rows


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m tcgnn_tpu_torch.bench.log2csv <logfile>", file=sys.stderr)
        return 1
    path = argv[0]
    out = path.rsplit(".", 1)[0] + ".csv"
    with open(path) as f:
        rows = scrape(f)
    with open(out, "w") as f:
        f.write("dataset,Avg.Epoch (ms)\n")
        for name, ms in rows:
            f.write(f"{name},{ms:.3f}\n")
    print(f"wrote {out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
