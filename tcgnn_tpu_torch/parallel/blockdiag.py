"""The distributed block-diagonal (BD) route's per-shard packs and their rim
(PyTorch port of ``tcgnn_tpu.parallel.blockdiag``).

Diagonals are locality: a shard that owns a contiguous range of ``bn``-row
bins touches at most ``max|k| * bn`` rows past either end of its range.
The halo is therefore a fixed-width rim from the two neighbour shards, two
nearest-neighbour ``ppermute`` shifts an op (``parallel/graph.py``), and
shards at either end of the mesh receive zeros: the zero padding of the
single-device kernels.  The route applies where the adjacency is fully
covered by its diagonals in both directions (the biomolecule collections:
Yeast, OVCAR-8H, DD's fully covered kin) and the bins align with the
shards (``parallel/graph.py::probe_block_diag``).

``BDShardMeta`` and ``build_bd_shard_meta`` are the JAX host pass, carried
over array for array (``tests/test_torch_parallel_bd.py`` holds them to
``np.array_equal``).

The upload (``upload_bd``) lays each shard's pack over an **extended
slab** of ``b_loc + kmax - kmin`` bins (``kmin = min(0, min(offsets))``,
``kmax = max(0, max(offsets))``): ``-kmin`` empty rim bins, the shard's
``b_loc`` bins, ``kmax`` empty rim bins, then the ``BD_BIN_GROUP``
padding.  The feature operand of the same shard is its rim stack ``x_ext =
[rim of shard g-1 ; x_loc ; rim of shard g+1]``, so K5, K6 and K7 run on
``(x_ext, ext pack)`` exactly as on one device, and rows ``[lead, lead +
rows_per_shard)`` (``lead = -kmin * bn``) of their output are the shard's.
JAX contracts the pack against a stack of the rim and the shard's bins
with an XLA einsum instead; the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops.blockdiag import bd_row_index, padded_bins
from tcgnn_tpu_torch.ops.row_index import RowIndex
from tcgnn_tpu_torch.ops.sddmm import EdgeList


@dataclasses.dataclass
class BDShardMeta:
    """Host-side per-shard arrays of the sharded packed-diagonal ops.

    ``pack_idx``/``pack_cnt`` are the shard-local sparse tile entries (flat
    indices into the shard's ``[K, B_loc, bn, bn]`` tile space; padding
    entries carry the one-past-the-end sentinel).  ``cov_slot`` maps each
    shard edge slot (the padded CSR-slice layout of every distributed
    per-edge vector) to its cell in the shard's packed ``[B_loc, bn,
    K*bn]`` layout, sentinel ``B_loc*bn*K*bn``.
    """

    offsets: tuple
    bin_rows: int
    bins_per_shard: int
    pack_idx: np.ndarray   # [G, cap] int32 (sentinel = K*B_loc*bn*bn)
    pack_cnt: np.ndarray   # [G, cap] tile count dtype
    cov_slot: np.ndarray   # [G, edge_capacity] int32 (sentinel = B_loc*bn*K*bn)


def build_bd_shard_meta(bdm, edge_start: np.ndarray, rows_per_shard: int, num_shards: int,
                        edge_capacity: int) -> BDShardMeta:
    """Shard a fully covered ``sgt.blockdiag.BDMeta`` by contiguous bin
    ranges aligned with the row partition."""
    bn, k = bdm.bin_rows, len(bdm.offsets)
    assert rows_per_shard % bn == 0, (rows_per_shard, bn)
    b_loc = rows_per_shard // bn
    bnbn = bn * bn
    local_size = k * b_loc * bnbn
    assert local_size + 1 < 2**31, (k, b_loc, bn)

    # ---- sparse pack entries, re-addressed into shard-local tile space ----
    ki, rem = np.divmod(bdm.tile_idx, bdm.num_bins * bnbn)
    b, rc = np.divmod(rem, bnbn)
    shard = b // b_loc  # bins align with shards by construction
    local_idx = (ki * b_loc + (b - shard * b_loc)) * bnbn + rc
    counts = np.bincount(shard, minlength=num_shards)
    cap = max(int(counts.max(initial=0)), 1)
    pack_idx = np.full((num_shards, cap), local_size, dtype=np.int32)
    pack_cnt = np.zeros((num_shards, cap), dtype=bdm.tile_cnt.dtype)
    order = np.argsort(shard, kind="stable")
    pos = np.concatenate([[0], np.cumsum(counts)])
    for s in range(num_shards):
        sel = order[pos[s]: pos[s + 1]]
        pack_idx[s, : len(sel)] = local_idx[sel].astype(np.int32)
        pack_cnt[s, : len(sel)] = bdm.tile_cnt[sel]

    # ---- per-edge cov addresses in the shard slot layout -------------------
    packed = bdm.packed_cov_idx()  # (b*bn + r) * (K*bn) + ki*bn + c
    cov_sentinel = b_loc * bn * k * bn
    eb = packed // (bn * k * bn) // b_loc  # edge's shard via its row bin
    local_packed = packed - eb * cov_sentinel
    cov_slot = np.full((num_shards, edge_capacity), cov_sentinel, np.int32)
    slot = bdm.cov_edge_ids - edge_start[eb]
    cov_slot[eb, slot] = local_packed.astype(np.int32)

    return BDShardMeta(offsets=bdm.offsets, bin_rows=bn, bins_per_shard=b_loc,
                       pack_idx=pack_idx, pack_cnt=pack_cnt, cov_slot=cov_slot)


def rim(offsets) -> tuple:
    """``(kmin, kmax)``: the rim bins before and after a shard's own,
    0-inclusive so a one-signed offset set makes no negative rim."""
    return min(0, min(offsets)), max(0, max(offsets))


@dataclasses.dataclass
class BDShard:
    """One shard of one direction on the device, in its extended slab."""

    pack: torch.Tensor           # [Bp_ext, bn, K*bn] duplicate counts
    cov_pos: torch.Tensor        # [E_g] int64: each real edge's cell in the ext pack ...
    w_src: torch.Tensor          # ... and where its weight is read: the shard's own edge
    #                              slot (forward), the all-gathered forward slot (transpose)
    index: Optional[RowIndex] = None    # the ext pack's per-row index (K6/K7)
    cells: Optional[EdgeList] = None    # the ext pack's cells as K4's edges (F > 1 AGNN) ...
    cell_pos: Optional[torch.Tensor] = None  # ... their positions in the flat ext pack ...
    cell_cnt: Optional[torch.Tensor] = None  # ... and their counts
    edges: Optional[EdgeList] = None    # the shard's edges: own rows, ext columns (SDDMM)


@dataclasses.dataclass
class BDDirection:
    """One direction (forward, or transpose for the backward) on the device."""

    offsets: tuple
    bin_rows: int
    bins_per_shard: int
    shards: list  # [BDShard], one a graph shard

    @property
    def rim(self) -> tuple:
        return rim(self.offsets)

    @property
    def lead(self) -> int:
        """Rows of the rim in front of the shard's own in ``x_ext``."""
        return -self.rim[0] * self.bin_rows


def _ext_cells(idx: torch.Tensor, offsets, b_loc: int, bn: int) -> tuple:
    """A shard's ``[K, B_loc, bn, bn]`` flat tile indices -> each entry's
    flat position in the ext pack, its ext row and its ext column (int64)."""
    k, kmin = len(offsets), rim(offsets)[0]
    bnbn = bn * bn
    ki, rem = idx // (b_loc * bnbn), idx % (b_loc * bnbn)
    b, r, c = rem // bnbn, rem % bnbn // bn, rem % bn
    row = (b - kmin) * bn + r
    col = (b + torch.tensor(offsets, device=idx.device)[ki] - kmin) * bn + c
    return row * (k * bn) + ki * bn + c, row, col


def upload_bd(m: BDShardMeta, config: TileConfig, device, edge_counts, shards: range,
              w_src=None, packs: Optional[list] = None, row_index: bool = False,
              cells: bool = False, edges: Optional[list] = None) -> BDDirection:
    """The direction's ``shards`` (the graph shards this process holds) on
    ``device``; ``packs`` and ``edges`` list them in that order.

    ``edge_counts[g]``: shard g's real edges.  ``w_src``: per shard, the
    all-gathered forward slot of each edge slot (the transpose's
    ``edge_fwd_slot``); None reads the shard's own slots.  ``packs``: the
    forward direction's ext packs, shared by a symmetric graph's transpose.
    ``row_index``: build the ext pack's per-row index (K6/K7 at one
    feature shard); ``cells``: its cells (K4 scores + K5 at several).
    ``edges``: per shard, ``(rows, ext columns)`` host arrays of its edges
    (the forward direction's SDDMM)."""
    k, bn, b_loc = len(m.offsets), m.bin_rows, m.bins_per_shard
    kmin, kmax = rim(m.offsets)
    n_ext = (b_loc + kmax - kmin) * bn
    size = k * b_loc * bn * bn  # the shard's pack entries: both sentinels
    lead_cells = -kmin * bn * k * bn

    def dev64(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def dev32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    direction = []
    for i, g in enumerate(shards):
        keep = m.pack_idx[g] < size
        pos, row, col = _ext_cells(dev64(m.pack_idx[g][keep]), m.offsets, b_loc, bn)
        cnt = torch.from_numpy(np.ascontiguousarray(m.pack_cnt[g][keep])).to(device)
        if packs is not None:
            pack = packs[i]
        else:
            flat = torch.zeros(padded_bins(n_ext // bn) * bn * k * bn, dtype=cnt.dtype,
                               device=device)
            flat[pos] = cnt
            pack = flat.view(-1, bn, k * bn)
        slots = np.flatnonzero(m.cov_slot[g][: edge_counts[g]] < size)
        sh = BDShard(
            pack=pack,
            cov_pos=dev64(m.cov_slot[g][slots].astype(np.int64) + lead_cells),
            w_src=dev64(slots if w_src is None else w_src[g][slots]),
            index=bd_row_index(pack, m.offsets, n_ext) if row_index else None,
        )
        if cells:  # in pack order
            order = torch.argsort(pos)
            sh.cells = EdgeList(config, n_ext, n_ext, int(pos.numel()),
                                row[order].to(torch.int32), col[order].to(torch.int32))
            sh.cell_pos, sh.cell_cnt = pos[order], cnt[order]
        if edges is not None:
            rows, cols = edges[i]
            sh.edges = EdgeList(config, b_loc * bn, n_ext, len(rows), dev32(rows), dev32(cols))
        direction.append(sh)
    return BDDirection(offsets=m.offsets, bin_rows=bn, bins_per_shard=b_loc, shards=direction)
