"""Block-diagonal (BD) decomposition of a CSR adjacency (PyTorch port).

Counterpart of ``tcgnn_tpu.sgt.blockdiag``: its NumPy path, carried over
(the port has no native pass), with the same output field by field
(``tests/test_torch_blockdiag.py`` holds the two packages to it).

With 128-row bins, an edge ``(i, j)`` lies on the block diagonal at offset
``j // 128 - i // 128``.  On graphs that are unions of small components
with contiguous node ids (the biomolecule collections: DD, Yeast,
OVCAR-8H, ...), or banded graphs after RCM, a handful of offsets carries
nearly every edge.  Those offsets are kept as dense ``[bin, bin]`` tiles,
one per (offset, bin), and the SpMM over them is

    y[b] = sum_k  D_k[b] @ x[b + k]          (k in the selected offsets)

with no gather table.  The edges on other offsets form a *residual* CSR,
served by the condensed dense-tile route.  Below a coverage gate the
decomposition is refused (``None``) and power-law graphs keep the
condensed route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# A diagonal offset is kept, for an explicitly supplied candidate set, only
# when it carries at least this share of the edges.
MIN_OFFSET_SHARE = 0.02
# The BD route is taken only when the kept offsets cover at least this
# fraction of the edges.
MIN_COVERAGE = 0.85
# Never materialize more than this many bytes of int8 diagonal tiles.
BD_TILE_BUDGET_BYTES = 6 << 30
# Auto offset selection: a diagonal is worth its own tile stream when it
# carries at least this many edges per bin (the JAX package's break-even
# between streaming a mostly-zero tile and gathering its edges; kept so
# both packages select the same offsets).
PAYOFF_EDGES_PER_BIN = 8
# Cap on kept diagonals.
MAX_BD_OFFSETS = 8


def _cdiv(a, b):
    return -(-a // b)


def packed_index(flat_idx, num_bins: int, k: int, bn: int):
    """Flat indices of the ``[K, B, bn, bn]`` tile layout re-addressed into
    the kernels' packed ``[B, bn, K*bn]`` layout, row-major in
    ``(b, r, k, c)``: row ``b * bn + r`` of the pack is node row
    ``b * bn + r``'s stripe of K bins.  Works on NumPy arrays and torch
    tensors (int64)."""
    bnbn = bn * bn
    ki, rem = flat_idx // (num_bins * bnbn), flat_idx % (num_bins * bnbn)
    b, rc = rem // bnbn, rem % bnbn
    r, c = rc // bn, rc % bn
    return (b * bn + r) * (k * bn) + ki * bn + c


@dataclasses.dataclass
class BDMeta:
    """Host-side block-diagonal decomposition of a CSR adjacency."""

    bin_rows: int                 # bin size
    num_bins: int                 # B = ceil(N / bin_rows)
    offsets: tuple                # kept diagonal offsets, sorted
    # Sparse tile contents: sorted unique flat indices into the
    # [K * B * bin * bin] tile array and their duplicate-edge counts.
    tile_idx: np.ndarray          # [nnz] int64
    tile_cnt: np.ndarray          # [nnz] int8 (int16 when a count passes 127)
    coverage: float               # edge fraction on the kept offsets
    # Residual edges (off the kept offsets) as a CSR over the same nodes;
    # None when fully covered.
    res_ptr: Optional[np.ndarray]
    res_idx: Optional[np.ndarray]
    res_edge_ids: Optional[np.ndarray]  # positions of residual edges in CSR order
    # Covered edges: their positions in CSR order and their flat indices
    # into the [K, B, bin, bin] tiles (the weighted ops' scatter targets).
    cov_edge_ids: np.ndarray
    cov_flat_idx: np.ndarray

    def packed_cov_idx(self) -> np.ndarray:
        """``cov_flat_idx`` re-addressed into the packed ``[Bp, bin, K*bin]``
        layout (``packed_index``), so per-edge weights scatter straight into
        the pack; independent of the bin padding."""
        return packed_index(self.cov_flat_idx, self.num_bins, len(self.offsets), self.bin_rows)

    def dense_tiles(self) -> np.ndarray:
        """The ``[K, B, bin, bin]`` tile array (tests and analysis)."""
        k = len(self.offsets)
        t = np.zeros(k * self.num_bins * self.bin_rows * self.bin_rows, self.tile_cnt.dtype)
        t[self.tile_idx] = self.tile_cnt
        return t.reshape(k, self.num_bins, self.bin_rows, self.bin_rows)


def bd_edge_offsets(row_pointers, column_index, bin_rows: int = 128):
    """Per-edge row, column and block offset ``col_bin - row_bin``."""
    ptr = np.asarray(row_pointers, dtype=np.int64)
    cols = np.asarray(column_index, dtype=np.int64)
    n = len(ptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    return rows, cols, (cols // bin_rows) - (rows // bin_rows)


def bd_coverage(row_pointers, column_index, bin_rows: int = 128,
                candidate_offsets=(0, -1, 1)) -> float:
    """Edge fraction within the candidate diagonals."""
    cols = np.asarray(column_index)
    if len(cols) == 0:
        return 1.0
    _, _, off = bd_edge_offsets(row_pointers, column_index, bin_rows)
    return float(np.isin(off, candidate_offsets).mean())


def extract_block_diag(
    row_pointers,
    column_index,
    num_nodes: int,
    bin_rows: int = 128,
    candidate_offsets=None,
    min_offset_share: float = MIN_OFFSET_SHARE,
    min_coverage: float = MIN_COVERAGE,
) -> Optional[BDMeta]:
    """Decompose A into dense diagonal-block tiles plus a residual CSR.

    ``candidate_offsets=None`` selects diagonals from the edge-offset
    histogram: all of them when there are at most ``MAX_BD_OFFSETS``
    distinct offsets, otherwise the most populated offsets that carry at
    least ``max(64, PAYOFF_EDGES_PER_BIN * B)`` edges each.

    Returns None when the kept offsets cover less than ``min_coverage`` of
    the edges or the tiles would pass ``BD_TILE_BUDGET_BYTES``.
    """
    ptr = np.ascontiguousarray(row_pointers, dtype=np.int64)
    cols_i32 = np.ascontiguousarray(column_index, dtype=np.int32)
    n = int(num_nodes)
    e = len(cols_i32)
    nbins = max(_cdiv(n, bin_rows), 1)
    if e == 0:
        return None

    rows, cols, off = bd_edge_offsets(ptr, cols_i32, bin_rows)
    vals, cnts = np.unique(off, return_counts=True)
    cnt_of = dict(zip(vals.tolist(), cnts.tolist()))

    if candidate_offsets is None:
        if len(vals) <= MAX_BD_OFFSETS:
            candidate_offsets = tuple(int(v) for v in vals)
        else:
            pay = cnts >= max(64, PAYOFF_EDGES_PER_BIN * nbins)
            order = np.argsort(-cnts[pay], kind="stable")
            candidate_offsets = tuple(int(v) for v in vals[pay][order][:MAX_BD_OFFSETS])
        # The count gate above already priced each stream.
        min_offset_share = 0.0
        if not candidate_offsets:
            return None

    # Offset 0 needs no special case: without it coverage fails the gate.
    counts = {k: cnt_of.get(k, 0) for k in candidate_offsets}
    if sum(counts.values()) == e:
        # Every edge covered: keep every non-empty candidate, no residual.
        offsets = tuple(k for k in candidate_offsets if counts[k] > 0)
    else:
        offsets = tuple(
            k for k in candidate_offsets if counts[k] >= max(1, int(min_offset_share * e))
        )
    if not offsets:
        return None
    offsets = tuple(sorted(offsets))
    coverage = sum(counts[k] for k in offsets) / e
    if coverage < min_coverage:
        return None
    if len(offsets) * nbins * bin_rows * bin_rows > BD_TILE_BUDGET_BYTES:
        return None

    covered = np.isin(off, offsets)
    coverage = float(covered.mean())

    # Duplicate-edge counts by sorted-run lengths of the flat indices.
    k_of = np.full(len(off), -1, dtype=np.int64)
    for i, k in enumerate(offsets):
        k_of[off == k] = i
    bi = rows // bin_rows
    flat = (
        (k_of * nbins + bi) * (bin_rows * bin_rows)
        + (rows % bin_rows) * bin_rows
        + (cols - (bi + np.where(covered, off, 0)) * bin_rows)
    )[covered]
    uniq, cnt = np.unique(flat, return_counts=True)
    dtype = np.int8 if (len(cnt) == 0 or cnt.max() <= 127) else np.int16

    edge_ids = np.arange(e, dtype=np.int64)
    if coverage < 1.0:
        res_rows = rows[~covered]
        res_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(res_rows, minlength=n), out=res_ptr[1:])
        res = (res_ptr.astype(np.int32), cols[~covered].astype(np.int32), edge_ids[~covered])
    else:
        res = (None, None, None)

    return BDMeta(
        bin_rows=bin_rows,
        num_bins=nbins,
        offsets=offsets,
        tile_idx=uniq,
        tile_cnt=cnt.astype(dtype),
        coverage=coverage,
        res_ptr=res[0],
        res_idx=res[1],
        res_edge_ids=res[2],
        cov_edge_ids=edge_ids[covered],
        cov_flat_idx=flat,
    )
