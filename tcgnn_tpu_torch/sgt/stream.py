"""Window segments of the chunk layout: the streamed route (counterpart of
``tcgnn_tpu.sgt.stream``).

``segment_chunks`` re-lays a graph's chunk layout as S segments of ``wseg``
consecutive windows each, every segment padded to the largest one's chunk
and block counts (``C_max``, ``B_max``): the JAX NumPy host pass, carried
over with the same arrays (``tests/test_torch_stream.py``).  Padding chunks
revisit the segment's last window with ``first = 0``, their slots have row
``blk_h`` and edge ``num_edges``, so they add nothing.

The two per-segment ceilings are a TPU's: the chunk kernels there prefetch
their per-chunk scalars into SMEM (``MAX_PREFETCH_CHUNKS``) and gather a
segment's condensed slab ``x[col_ids]`` into HBM (``MAX_SLAB_ROWS``).  They
are kept at the JAX values so that both packages stream the same graphs
(reddit) and report the same ``streamed``.  On the card the segments are a
grid axis of one kernel launch (``ops/chunk.py``), not a loop of S launches,
and no slab is formed: the kernels gather rows of x themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.sgt.translate import SGTMeta, TorchChunkMeta

MAX_PREFETCH_CHUNKS = 49_152  # the TPU's SMEM budget for three int32 arrays
MAX_SLAB_ROWS = 1 << 20  # the TPU's condensed-slab rows per segment


def needs_streaming(meta: SGTMeta) -> bool:
    """True when a TPU's one-shot chunk kernels would overflow SMEM or HBM:
    the JAX package's rule for the streamed route."""
    num_blocks = meta.col_ids.shape[0] // meta.config.blk_w
    return (
        meta.num_chunks > MAX_PREFETCH_CHUNKS
        or num_blocks * meta.config.blk_w > MAX_SLAB_ROWS
    )


@dataclasses.dataclass
class StreamedMeta:
    """Host (NumPy) stacked-segment layout; the JAX ``StreamedJaxMeta``'s
    fields (``to_device=False``) plus ``seg_chunks``, each segment's count
    of real chunks."""

    config: TileConfig
    num_nodes: int
    num_edges: int
    num_windows: int  # real windows (before padding)
    wseg: int  # windows per segment
    num_segments: int
    seg_col_ids: np.ndarray  # [S, B_max * blk_w] int32
    seg_r: np.ndarray  # [S, C_max, EC] int32
    seg_c: np.ndarray  # [S, C_max, EC] int32
    seg_edge_id: np.ndarray  # [S, C_max, EC] int32
    seg_block: np.ndarray  # [S, C_max] int32 (segment-relative)
    seg_window: np.ndarray  # [S, C_max] int32 (segment-relative)
    seg_first: np.ndarray  # [S, C_max] int32
    edge_perm: np.ndarray  # [E] each edge's slot in the stacked layout
    seg_chunks: np.ndarray  # [S] int32

    def to(self, device) -> TorchChunkMeta:
        """Upload what the chunk kernels read (``seg_first`` and
        ``edge_perm`` stay on the host: the kernels need neither)."""
        return TorchChunkMeta.upload(
            self.config, self.num_nodes, self.num_edges, self.num_windows, self.wseg,
            self.seg_col_ids, self.seg_r, self.seg_c, self.seg_edge_id, self.seg_block,
            self.seg_window, self.seg_chunks, device,
        )


def segment_chunks(
    meta: SGTMeta,
    *,
    max_chunks: int = MAX_PREFETCH_CHUNKS,
    max_slab_rows: int = MAX_SLAB_ROWS,
    num_segments: Optional[int] = None,
    pad_chunks_to: Optional[int] = None,
    pad_slab_blocks_to: Optional[int] = None,
    plan_only: bool = False,
):
    """Re-lay ``meta``'s chunk layout as uniform window segments.

    Chooses the smallest S (unless ``num_segments`` forces one) such that
    every segment's chunk count fits ``max_chunks`` and its condensed-slab
    rows fit ``max_slab_rows``; cuts fall on window boundaries.
    ``pad_chunks_to`` / ``pad_slab_blocks_to`` raise the per-segment chunk
    and block capacities past the natural maxima (for stacking several
    shards' segments alike).  ``plan_only=True`` returns just
    ``(S, wseg, c_max, b_max)`` without building the arrays.
    """
    cfg = meta.config
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    W = len(meta.block_partition)
    ec = meta.chunk_r.shape[1]
    block_start = np.zeros(W + 1, dtype=np.int64)
    np.cumsum(meta.block_partition, out=block_start[1:])
    chunk_block = np.asarray(meta.chunk_block, np.int64)

    def cuts_for(S):
        wseg = -(-W // S)
        S_eff = -(-W // wseg)
        w_cuts = np.minimum(np.arange(S_eff + 1) * wseg, W)
        b_cuts = block_start[w_cuts]
        c_cuts = np.searchsorted(chunk_block, b_cuts, side="left")
        return wseg, S_eff, w_cuts, b_cuts, c_cuts

    if num_segments is not None:
        wseg, S, w_cuts, b_cuts, c_cuts = cuts_for(num_segments)
    else:
        for S in range(1, W + 1):
            wseg, S, w_cuts, b_cuts, c_cuts = cuts_for(S)
            b_max = int(np.max(np.diff(b_cuts)))
            c_max = int(np.max(np.diff(c_cuts)))
            if b_max * blk_w <= max_slab_rows and c_max <= max_chunks:
                break
    b_max = int(np.max(np.diff(b_cuts)))
    c_max = max(int(np.max(np.diff(c_cuts))), 1)
    if pad_slab_blocks_to is not None:
        if pad_slab_blocks_to < b_max:
            raise ValueError(f"pad_slab_blocks_to={pad_slab_blocks_to} < {b_max} blocks")
        b_max = pad_slab_blocks_to
    if pad_chunks_to is not None:
        if pad_chunks_to < c_max:
            raise ValueError(f"pad_chunks_to={pad_chunks_to} < {c_max} chunks")
        c_max = pad_chunks_to
    if plan_only:
        return S, wseg, c_max, b_max

    # np.empty and explicit writes of the padding tails: the copies fill
    # [:nc], so np.full would write the (reddit: GB-sized) arrays twice.
    seg_r = np.empty((S, c_max, ec), np.int32)
    seg_c = np.empty((S, c_max, ec), np.int32)
    seg_eid = np.empty((S, c_max, ec), np.int32)
    seg_block = np.zeros((S, c_max), np.int32)
    seg_window = np.zeros((S, c_max), np.int32)
    seg_first = np.zeros((S, c_max), np.int32)
    seg_col_ids = np.zeros((S, b_max * blk_w), np.int32)

    for s in range(S):
        c0, c1 = int(c_cuts[s]), int(c_cuts[s + 1])
        b0, b1 = int(b_cuts[s]), int(b_cuts[s + 1])
        w0 = int(w_cuts[s])
        nc = c1 - c0
        if nc:
            seg_r[s, :nc] = meta.chunk_r[c0:c1]
            seg_c[s, :nc] = meta.chunk_c[c0:c1]
            seg_eid[s, :nc] = meta.chunk_edge_id[c0:c1]
            seg_block[s, :nc] = meta.chunk_block[c0:c1] - b0
            seg_window[s, :nc] = meta.chunk_window[c0:c1] - w0
            # Padding chunks revisit the last real window with first=0.
            seg_window[s, nc:] = int(meta.chunk_window[c1 - 1]) - w0
            seg_first[s, :nc] = meta.chunk_first_in_window[c0:c1]
        seg_r[s, nc:] = blk_h  # row sentinel
        seg_c[s, nc:] = 0
        seg_eid[s, nc:] = meta.num_edges
        seg_col_ids[s, : (b1 - b0) * blk_w] = meta.col_ids[b0 * blk_w : b1 * blk_w]

    # Each edge's slot moves from [Cn, EC] to [S, C_max, EC].
    ep = np.asarray(meta.edge_perm, np.int64)
    gc, k = ep // ec, ep % ec
    seg_id = np.searchsorted(c_cuts, gc, side="right") - 1
    new_perm = (seg_id * np.int64(c_max) + (gc - c_cuts[seg_id])) * ec + k
    perm_dtype = np.int32 if S * c_max * ec < 2**31 else np.int64

    return StreamedMeta(
        config=cfg,
        num_nodes=meta.num_nodes,
        num_edges=meta.num_edges,
        num_windows=W,
        wseg=wseg,
        num_segments=S,
        seg_col_ids=seg_col_ids,
        seg_r=seg_r,
        seg_c=seg_c,
        seg_edge_id=seg_eid,
        seg_block=seg_block,
        seg_window=seg_window,
        seg_first=seg_first,
        edge_perm=new_perm.astype(perm_dtype),
        seg_chunks=np.diff(c_cuts).astype(np.int32),
    )
