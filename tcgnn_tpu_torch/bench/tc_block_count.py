"""SGT tile-reduction counters (the reference's Fig. 7; port of
``tcgnn_tpu.bench.tc_block_count``).

Per row window, the TC-block count after column condensation
(``ceil(unique / blk_w)``) against a naive sliding-window tiling of the
uncondensed sorted columns, counted by the port's native host pass
(``sgt/native``: ``count_blocks``, ``naive_count``) where its library
loads, else in Python.  The CSV keeps the reference contract
``dataset,origin,reduced,reduction (%)`` and the JAX package's three
geometries and file names: tile counts do not depend on the chip, so both
packages' outputs compare file for file.

Run:  python -m tcgnn_tpu_torch.bench.tc_block_count [--datasets cora pubmed ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tcgnn_tpu_torch.bench.datasets import AE_TABLE
from tcgnn_tpu_torch.sgt import native


def _window_unique_counts_py(ptr, cols, blk_h):
    n = len(ptr) - 1
    out = []
    for start in range(0, n, blk_h):
        end = min(start + blk_h, n)
        seg = cols[ptr[start] : ptr[end]]
        out.append(np.unique(seg))
    return out


def count_tiles(ptr, cols, blk_h, blk_w):
    """(naive_tiles, sgt_tiles) totals for one geometry."""
    ptr = np.ascontiguousarray(ptr, np.int64)
    cols32 = np.ascontiguousarray(cols, np.int32)
    if native.available():
        opt = native.count_blocks(ptr, cols32, blk_h, blk_w)
        naive = native.naive_count(ptr, cols32, blk_h, blk_w)
        return int(naive.sum()), int(opt.sum())
    naive_cnt = opt_cnt = 0
    for uniq in _window_unique_counts_py(ptr, cols, blk_h):
        opt_cnt += -(-len(uniq) // blk_w)
        i = 0
        while i < len(uniq):
            i = int(np.searchsorted(uniq, uniq[i] + blk_w))
            naive_cnt += 1
    return naive_cnt, opt_cnt


GEOMETRIES = {
    "SpMM_16x8": (16, 8),       # 3_cnt_TC_blk_SpMM.py
    "SDDMM_16x16": (16, 16),    # 3_cnt_TC_blk_SDDMM.py
    "TPU_128x128": (128, 128),  # the JAX package's MXU geometry, kept for comparison
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="*", default=[d for d, _, _ in AE_TABLE])
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--out_prefix", default="cnt_TC_blk")
    args = p.parse_args(argv)

    from tcgnn_tpu_torch.train import load_dataset

    for geom_name, (bh, bw) in GEOMETRIES.items():
        path = f"{args.out_prefix}_{geom_name}.csv"
        with open(path, "w") as f:
            f.write("dataset,origin,reduced,reduction (%)\n")
            for name in args.datasets:
                a = argparse.Namespace(dataset=name, data_dir=args.data_dir, dim=16,
                                       classes=2, seed=0)
                try:
                    ds = load_dataset(a)
                except ValueError as e:
                    print(f"{name}: skipped ({e})", file=sys.stderr)
                    continue
                naive, opt = count_tiles(ds.row_pointers, ds.column_index, bh, bw)
                red = 100.0 * (naive - opt) / max(naive, 1)
                line = f"{name},{naive},{opt},{red:.2f}"
                print(f"[{geom_name}] {line}")
                f.write(line + "\n")
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
