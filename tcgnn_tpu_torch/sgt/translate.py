"""Sparse Graph Translation (SGT): condense CSR adjacency into dense tiles.

Counterpart of ``tcgnn_tpu.sgt.translate``: its vectorized NumPy pass,
carried over with the same output, field by field (``tests/test_torch_sgt.py``
and ``tests/test_torch_chunk.py`` hold the two packages to it).  Per
``blk_h``-row window, the distinct neighbour column ids are ranked in sorted
order; edge ``e`` with neighbour ``c`` in window ``w`` lands at condensed
column ``rank_w(c)``, i.e. TC block ``rank // blk_w``, in-block column
``rank % blk_w``, in-window row ``row(e) % blk_h``.

``emit_chunks=True`` also lays out the chunk route's uniform edge chunks:
each TC block's edges, in CSR order, padded to a multiple of
``config.edge_chunk`` slots (``chunk_r`` / ``chunk_c`` / ``chunk_edge_id``
per slot, the owning block and window per chunk, and ``edge_perm``, each
edge's slot).  ``SGTMeta.to_chunks(device)`` uploads the layout as a stack
of one segment (``TorchChunkMeta``; the streamed route's segments,
``sgt/stream.py``, are the same layout with more), with the CSR row index
derived from it that the chunk kernels (K8, K9) read.

The JAX package's native C++ pass is not carried over: the NumPy pass gives
the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig


def _cdiv(a, b):
    return -(-a // b)


def _pad_blocks(real_blocks_per_window: np.ndarray, config: TileConfig) -> np.ndarray:
    """Blocks per window, padded as the JAX package pads them.

    Empty windows get one padding block so every output row is written, and
    counts round up to ``config.block_group``.  Padding blocks have all-zero
    tiles and padding columns 0, so they contribute nothing.
    """
    g = max(int(config.block_group), 1)
    return (_cdiv(np.maximum(real_blocks_per_window, 1), g) * g).astype(
        real_blocks_per_window.dtype
    )


# TC blocks one thread block of the CUDA SpMM walks: a window of more blocks
# is split into runs of this many (see csrc/spmm_dense.cu).
KERNEL_RUN_BLOCKS = 8


@dataclasses.dataclass(frozen=True)
class TorchSGTMeta:
    """Device-side metadata the SpMM kernel and its plain version read.

    ``win_start[w]`` is window ``w``'s first block (the cumulative sum of
    ``block_partition``): the CUDA kernel walks a window's blocks itself
    instead of following the TPU grid's per-block first/last flags.  It
    walks them in runs of at most ``KERNEL_RUN_BLOCKS``, one thread block a
    run: run ``t`` belongs to window ``run_window[t]`` and starts at block
    ``run_block[t]``.

    Per CSR edge ``e``: ``edge_pos[e]`` is its flat dense-tile position
    (where the weighted tiles and the tile-space SDDMM put it), and
    ``edge_rows[e]`` / ``edge_cols[e]`` its row and column, read back from
    that position, which the per-edge SDDMM kernel reads.

    Two row counts: ``num_rows``, the rows of the output and of the
    window-side operand (row ``w * blk_h + r`` is window w's row r), and
    ``num_src``, the rows of the gathered operand (``col_ids`` index it).
    On one device both are the node count N.  A shard of the distributed
    layer (``shard_meta``) writes ``num_windows * blk_h`` rows (its own
    windows, then its guest windows) and gathers from its extended halo
    slab.  ``num_blocks`` is the tile array's block count; the windows'
    blocks (``win_start``) may end before it, and blocks past
    ``win_start[-1]`` are padding the kernels never visit.
    """

    config: TileConfig
    num_rows: int
    num_src: int
    num_edges: int
    num_windows: int
    num_blocks: int
    max_window_blocks: int  # most TC blocks in one window (padding included)
    col_ids: torch.Tensor  # [B * blk_w] int32
    block_window: torch.Tensor  # [B] int32
    win_start: torch.Tensor  # [W + 1] int32
    run_window: torch.Tensor  # [R] int32
    run_block: torch.Tensor  # [R] int32
    edge_pos: torch.Tensor  # [E] int32
    edge_rows: torch.Tensor  # [E] int32
    edge_cols: torch.Tensor  # [E] int32
    # The device of the window arrays the tile kernels read (col_ids,
    # win_start, run_window, run_block) when all four lie there, int32 and
    # contiguous, else None: checked once here, not on every launch.
    kernel_device: Optional[torch.device] = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    KERNEL_INDEX = ("col_ids", "win_start", "run_window", "run_block")

    def __post_init__(self):
        arrays = [getattr(self, name) for name in self.KERNEL_INDEX]
        dev = arrays[0].device
        ok = all(a.device == dev and a.dtype == torch.int32 and a.is_contiguous() for a in arrays)
        object.__setattr__(self, "kernel_device", dev if ok else None)


# Slots a slab of ``TorchChunkMeta.slot_slabs`` holds at most: the index
# build and the plain versions form no array of all of reddit's 131 M slots.
SLAB_SLOTS = 1 << 22


@dataclasses.dataclass(frozen=True)
class TorchChunkMeta:
    """Device-side chunk layout that the plain versions of the chunk kernels
    (K8, K9) read, and the CSR row index the kernels read: S window segments
    of ``wseg`` windows each, every segment padded to ``max_chunks`` chunks
    of EC = ``config.edge_chunk`` slots.  The chunk route's flat layout is
    one segment (``wseg`` = W).

    Chunk ``i`` of segment ``s`` belongs to TC block ``seg_block[s, i]`` and
    window ``seg_window[s, i]``, both segment-relative; slot ``k`` holds the
    edge ``seg_edge_id[s, i, k]`` (CSR order), whose output row is
    ``(s * wseg + seg_window[s, i]) * blk_h + seg_r[s, i, k]`` and whose
    source row is ``seg_col_ids[s, seg_block[s, i] * blk_w + seg_c[s, i, k]]``.
    A padding slot has row ``blk_h`` and edge ``num_edges``; chunks from
    ``seg_chunks[s]`` on are padding chunks, all of padding slots.

    ``row_ptr`` and ``row_src`` are the same edges in CSR order, derived from
    the slots by ``upload``: row ``r``'s edges are ``[row_ptr[r],
    row_ptr[r + 1])`` and edge ``e``'s source row is ``row_src[e]``, the CSR
    the layout was built from, bit for bit.
    """

    config: TileConfig
    num_nodes: int
    num_edges: int
    num_windows: int
    wseg: int
    num_segments: int
    max_chunks: int
    num_real_chunks: int
    seg_col_ids: torch.Tensor  # [S, B_max * blk_w] int32
    seg_r: torch.Tensor  # [S, C_max, EC] int32
    seg_c: torch.Tensor  # [S, C_max, EC] int32
    seg_edge_id: torch.Tensor  # [S, C_max, EC] int32
    seg_block: torch.Tensor  # [S, C_max] int32
    seg_window: torch.Tensor  # [S, C_max] int32
    seg_chunks: torch.Tensor  # [S] int32
    row_ptr: Optional[torch.Tensor] = None  # [N + 1] int64
    row_src: Optional[torch.Tensor] = None  # [E] int32

    @classmethod
    def upload(cls, config, num_nodes, num_edges, num_windows, wseg, seg_col_ids, seg_r, seg_c,
               seg_edge_id, seg_block, seg_window, seg_chunks, device) -> "TorchChunkMeta":
        """From host arrays of the stacked layout; the row index is derived
        on ``device``."""

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        meta = cls(
            config=config, num_nodes=int(num_nodes), num_edges=int(num_edges),
            num_windows=int(num_windows), wseg=int(wseg), num_segments=int(seg_r.shape[0]),
            max_chunks=int(seg_r.shape[1]), num_real_chunks=int(np.sum(seg_chunks)),
            seg_col_ids=dev(seg_col_ids), seg_r=dev(seg_r), seg_c=dev(seg_c),
            seg_edge_id=dev(seg_edge_id), seg_block=dev(seg_block),
            seg_window=dev(seg_window), seg_chunks=dev(seg_chunks),
        )
        return dataclasses.replace(meta, **meta.row_index())

    def slot_slabs(self):
        """Each slab of real slots, segment by segment: their output rows,
        source rows and edge ids (int64), at most ``SLAB_SLOTS`` slots a
        slab."""
        cfg = self.config
        blk_h, blk_w = cfg.blk_h, cfg.blk_w
        per = max(1, SLAB_SLOTS // cfg.edge_chunk)
        for s, nc in enumerate(self.seg_chunks.tolist()):
            col_ids = self.seg_col_ids[s].long()
            for c0 in range(0, nc, per):
                c1 = min(c0 + per, nc)
                r = self.seg_r[s, c0:c1].long()
                real = r < blk_h
                win = self.seg_window[s, c0:c1, None].long().expand_as(r)[real]
                blk = self.seg_block[s, c0:c1, None].long().expand_as(r)[real]
                rows = (s * self.wseg + win) * blk_h + r[real]
                src = col_ids[blk * blk_w + self.seg_c[s, c0:c1].long()[real]]
                yield rows, src, self.seg_edge_id[s, c0:c1].long()[real]

    def row_index(self) -> dict:
        """``row_ptr`` and ``row_src`` from the slots, on their device: the
        real slots counted by output row, and each edge's source row
        scattered to its edge id, a slab at a time."""
        dev = self.seg_r.device
        counts = torch.zeros(self.num_nodes, dtype=torch.int64, device=dev)
        row_src = torch.empty(self.num_edges, dtype=torch.int32, device=dev)
        for rows, src, eid in self.slot_slabs():
            counts += torch.bincount(rows, minlength=self.num_nodes)
            row_src[eid] = src.to(torch.int32)
        row_ptr = torch.zeros(self.num_nodes + 1, dtype=torch.int64, device=dev)
        row_ptr[1:] = torch.cumsum(counts, 0)
        if int(row_ptr[-1]) != self.num_edges:
            raise ValueError(f"chunk layout holds {int(row_ptr[-1])} edges, "
                             f"expected {self.num_edges}")
        return {"row_ptr": row_ptr, "row_src": row_src}


@dataclasses.dataclass
class SGTMeta:
    """Host (NumPy) tiling metadata produced by :func:`sparse_graph_translate`.

    Shapes use W = num_windows, B = num_blocks.
    """

    config: TileConfig
    num_nodes: int
    num_edges: int
    # TC blocks per row window, padded (empty windows get 1 padding block).
    block_partition: np.ndarray  # [W] int32
    # Count of real blocks: the printed `TC_Blocks` statistic.
    num_real_blocks: int
    # Global source-node id of each condensed column; padding columns -> 0.
    col_ids: np.ndarray  # [B * blk_w] int32
    block_window: np.ndarray  # [B] int32
    block_first_in_window: np.ndarray  # [B] int32 (0/1)
    # Flat dense-tile position of each CSR edge:
    # block * blk_h * blk_w + r * blk_w + c.
    edge_pos: np.ndarray  # [num_edges] int64
    # Structural tiles (build_tiles=True): int8 counts, f32 when a count
    # exceeds 127.
    a_tiles: Optional[np.ndarray] = None  # [B, blk_h, blk_w]
    # Uniform chunk layout (emit_chunks=True); Cn chunks of EC slots.
    chunk_r: Optional[np.ndarray] = None  # [Cn, EC] int32; blk_h marks a padding slot
    chunk_c: Optional[np.ndarray] = None  # [Cn, EC] int32, column in the block
    chunk_edge_id: Optional[np.ndarray] = None  # [Cn, EC] int32; num_edges marks padding
    chunk_block: Optional[np.ndarray] = None  # [Cn] int32, owning block
    chunk_window: Optional[np.ndarray] = None  # [Cn] int32, owning window
    chunk_first_in_window: Optional[np.ndarray] = None  # [Cn] int32 (0/1)
    chunk_first_in_block: Optional[np.ndarray] = None  # [Cn] int32 (0/1)
    # Each CSR edge's slot in the layout (chunk * EC + lane).
    edge_perm: Optional[np.ndarray] = None  # [E] int32

    @property
    def num_windows(self) -> int:
        return int(self.block_partition.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.col_ids.shape[0] // self.config.blk_w)

    @property
    def num_chunks(self) -> int:
        return 0 if self.chunk_block is None else int(self.chunk_block.shape[0])

    def to_chunks(self, device) -> TorchChunkMeta:
        """Upload the chunk layout (``emit_chunks=True``) to ``device`` as a
        stack of one segment spanning every window."""
        if self.chunk_r is None:
            raise ValueError("to_chunks needs the chunk layout: translate with emit_chunks=True")
        return TorchChunkMeta.upload(
            self.config, self.num_nodes, self.num_edges, self.num_windows, self.num_windows,
            self.col_ids[None], self.chunk_r[None], self.chunk_c[None],
            self.chunk_edge_id[None], self.chunk_block[None], self.chunk_window[None],
            np.array([self.num_chunks], np.int32), device,
        )

    @property
    def exp_edges(self) -> int:
        """`Exp_Edges` = TC_Blocks * blk_h * blk_w."""
        return self.num_real_blocks * self.config.blk_h * self.config.blk_w

    def to(self, device) -> TorchSGTMeta:
        """Upload what the dense-tile ops read to ``device``."""
        return _upload_meta(self.config, self.block_partition, self.block_window, self.col_ids,
                            self.edge_pos, self.num_nodes, self.num_nodes, device)


def _upload_meta(config, block_partition, block_window, col_ids, edge_pos, num_rows, num_src,
                 device) -> TorchSGTMeta:
    """A ``TorchSGTMeta`` on ``device``: window w's blocks are the
    ``block_partition[w]`` blocks from ``win_start[w]``; ``block_window``
    and ``col_ids`` may run past them (padding blocks)."""
    num_windows = len(block_partition)
    win_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(block_partition, out=win_start[1:])
    blk_h, blk_w = config.blk_h, config.blk_w
    num_blocks = len(block_window)
    if num_blocks * blk_h * blk_w >= 2**31:
        raise ValueError("dense-tile index space overflows int32")
    runs = _cdiv(np.asarray(block_partition, np.int64), KERNEL_RUN_BLOCKS)
    run_window = np.repeat(np.arange(num_windows, dtype=np.int64), runs)
    first_run = np.cumsum(runs) - runs
    run_block = win_start[run_window] + KERNEL_RUN_BLOCKS * (
        np.arange(len(run_window), dtype=np.int64) - first_run[run_window]
    )

    edge_pos = np.asarray(edge_pos, np.int64)
    edge_block, in_tile = np.divmod(edge_pos, blk_h * blk_w)
    edge_rows = np.asarray(block_window)[edge_block].astype(np.int64) * blk_h + in_tile // blk_w
    edge_cols = np.asarray(col_ids)[edge_block * blk_w + in_tile % blk_w]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return TorchSGTMeta(
        config=config,
        num_rows=int(num_rows),
        num_src=int(num_src),
        num_edges=len(edge_pos),
        num_windows=num_windows,
        num_blocks=num_blocks,
        max_window_blocks=int(np.max(block_partition)),
        col_ids=dev(col_ids),
        block_window=dev(block_window),
        win_start=dev(win_start),
        run_window=dev(run_window),
        run_block=dev(run_block),
        edge_pos=dev(edge_pos),
        edge_rows=dev(edge_rows),
        edge_cols=dev(edge_cols),
    )


def shard_meta(config: TileConfig, a_tiles, block_window, block_first, col_ids, edge_pos,
               num_windows: int, num_src: int, device) -> TorchSGTMeta:
    """One shard's block stream of the distributed layer as a
    ``TorchSGTMeta``, from its slice of the stacked host arrays:
    ``a_tiles [B, blk_h, blk_w]``, ``block_window`` and ``block_first``
    ``[B]``, ``col_ids [B * blk_w]`` (indices into the gather source of
    ``num_src`` rows) and ``edge_pos``, the tile positions of the shard's
    real edges.  It writes ``num_windows * blk_h`` rows.

    The stacking pads every shard to the largest block count with blocks
    of zero tiles that revisit the last window without starting it; this
    shard's windows end at its last block that holds an entry or starts a
    window, so the kernels never visit the padding."""
    a = np.asarray(a_tiles).reshape(len(block_window), -1)
    live = np.flatnonzero(a.any(axis=1) | (np.asarray(block_first) == 1))
    nb = int(live[-1]) + 1 if len(live) else 0
    bw = np.asarray(block_window[:nb], np.int64)
    if np.any(np.diff(bw) < 0):
        raise ValueError("shard_meta: blocks out of window order")
    counts = np.bincount(bw, minlength=num_windows)
    if len(counts) != num_windows or counts.min(initial=1) < 1:
        raise ValueError("shard_meta: every window needs at least one block")
    return _upload_meta(config, counts, block_window, col_ids, edge_pos,
                        num_windows * config.blk_h, num_src, device)


def _window_pairs(row_pointers, column_index, num_nodes, num_cols, blk_h):
    """The sort+dedup of the SGT pass: each edge's row, the unique
    ``window * num_cols + column`` keys in sorted order, and each edge's key
    id."""
    degrees = np.diff(row_pointers)
    edge_row = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
    key = (edge_row // blk_h) * np.int64(num_cols) + column_index
    uniq_key, edge_pair = np.unique(key, return_inverse=True)
    return edge_row, uniq_key, edge_pair


def _num_cols(column_index, num_nodes, num_cols):
    num_edges = int(column_index.shape[0])
    if num_cols is None:
        num_cols = num_nodes
    return max(int(num_cols), int(column_index.max()) + 1 if num_edges else 1)


def sparse_graph_translate(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: Optional[int] = None,
    config: TileConfig = DEFAULT_CONFIG,
    num_cols: Optional[int] = None,
    build_tiles: bool = False,
    emit_chunks: bool = False,
) -> SGTMeta:
    """Run the SGT tiling pass over a CSR adjacency.

    Args:
      row_pointers: CSR indptr, shape [N+1], int.
      column_index: CSR indices, shape [nnz], int.
      num_nodes: N (row count); defaults to len(row_pointers) - 1.
      config: tile geometry.
      num_cols: column-space size; defaults to num_nodes.
      build_tiles: also build the structural dense tiles (``meta.a_tiles``).
      emit_chunks: also lay out the uniform edge chunks of the chunk route
        (the ``chunk_*`` fields and ``edge_perm``).
    """
    blk_h, blk_w = config.blk_h, config.blk_w
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    if num_nodes is None:
        num_nodes = len(row_pointers) - 1
    num_edges = int(column_index.shape[0])
    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    num_cols = _num_cols(column_index, num_nodes, num_cols)
    tile = blk_h * blk_w

    # ---- condensed-column ranking: a pair's rank within its window is its
    # condensed column.
    edge_row, uniq_key, edge_pair = _window_pairs(
        row_pointers, column_index, num_nodes, num_cols, blk_h
    )
    pair_window = (uniq_key // num_cols).astype(np.int64)
    pair_col = (uniq_key % num_cols).astype(np.int64)
    uniques_per_window = np.bincount(pair_window, minlength=num_windows)
    window_pair_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(uniques_per_window, out=window_pair_start[1:])
    pair_rank = (
        np.arange(len(uniq_key), dtype=np.int64) - window_pair_start[pair_window]
    )

    # ---- block partition -------------------------------------------------
    real_blocks_per_window = _cdiv(uniques_per_window, blk_w)
    num_real_blocks = int(real_blocks_per_window.sum())
    blocks_per_window = _pad_blocks(real_blocks_per_window, config)
    block_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(blocks_per_window, out=block_start[1:])
    num_blocks = int(block_start[-1])

    # ---- per-block condensed-column gather table -------------------------
    pair_block = block_start[pair_window] + pair_rank // blk_w
    col_ids = np.zeros(num_blocks * blk_w, dtype=np.int32)
    col_ids[pair_block * blk_w + pair_rank % blk_w] = pair_col

    # ---- edge -> (block, row, col) ---------------------------------------
    edge_rank = pair_rank[edge_pair]
    edge_block = pair_block[edge_pair]
    edge_c = (edge_rank % blk_w).astype(np.int32)
    edge_r = (edge_row % blk_h).astype(np.int32)
    edge_pos = (
        edge_block * np.int64(tile)
        + edge_r.astype(np.int64) * blk_w
        + edge_c.astype(np.int64)
    )
    a_tiles = None
    if build_tiles:
        # Counts per slot; scattered from the O(E) unique positions so no
        # tile-sized int64 intermediate is made.
        pos, cnt = np.unique(edge_pos, return_counts=True)
        a_tiles = np.zeros(
            num_blocks * tile, np.int8 if cnt.max(initial=0) <= 127 else np.float32
        )
        a_tiles[pos] = cnt
        a_tiles = a_tiles.reshape(num_blocks, blk_h, blk_w)

    window_of_block = np.repeat(
        np.arange(num_windows, dtype=np.int32), blocks_per_window
    )
    block_first_in_window = np.zeros(num_blocks, dtype=np.int32)
    block_first_in_window[block_start[:-1]] = 1

    meta = SGTMeta(
        config=config,
        num_nodes=int(num_nodes),
        num_edges=num_edges,
        block_partition=blocks_per_window.astype(np.int32),
        num_real_blocks=num_real_blocks,
        col_ids=col_ids,
        block_window=window_of_block,
        block_first_in_window=block_first_in_window,
        edge_pos=edge_pos,
        a_tiles=a_tiles,
    )
    if emit_chunks:
        _chunk_layout(meta, block_start)
    return meta


def _chunk_layout(meta: SGTMeta, block_start: np.ndarray) -> None:
    """Fill ``meta``'s uniform chunk layout (the JAX NumPy path).  Edges
    sorted by owning block, CSR order kept within a block; each block's run
    padded to a multiple of EC; a window's blocks stay adjacent."""
    config = meta.config
    blk_w, ec, tile = config.blk_w, config.edge_chunk, config.blk_h * config.blk_w
    num_blocks, num_edges = meta.num_blocks, meta.num_edges
    edge_block = meta.edge_pos // tile
    rem = meta.edge_pos % tile
    edge_r = (rem // blk_w).astype(np.int32)
    edge_c = (rem % blk_w).astype(np.int32)
    order = np.argsort(edge_block, kind="stable")
    edges_per_block = np.bincount(edge_block, minlength=num_blocks)
    chunks_per_block = np.maximum(_cdiv(edges_per_block, ec), 1)
    block_chunk_start = np.zeros(num_blocks + 1, dtype=np.int64)
    np.cumsum(chunks_per_block, out=block_chunk_start[1:])
    num_chunks = int(block_chunk_start[-1])

    # Slot of each (sorted) edge within its block.
    block_edge_start = np.zeros(num_blocks + 1, dtype=np.int64)
    np.cumsum(edges_per_block, out=block_edge_start[1:])
    sorted_block = edge_block[order]
    slot_in_block = np.arange(num_edges, dtype=np.int64) - block_edge_start[sorted_block]
    flat_slot = (block_chunk_start[sorted_block] + slot_in_block // ec) * ec + slot_in_block % ec

    meta.chunk_r = np.full((num_chunks, ec), config.row_sentinel, dtype=np.int32)
    meta.chunk_c = np.zeros((num_chunks, ec), dtype=np.int32)
    meta.chunk_edge_id = np.full((num_chunks, ec), num_edges, dtype=np.int32)
    meta.chunk_r.reshape(-1)[flat_slot] = edge_r[order]
    meta.chunk_c.reshape(-1)[flat_slot] = edge_c[order]
    meta.chunk_edge_id.reshape(-1)[flat_slot] = order.astype(np.int32)
    meta.edge_perm = np.empty(num_edges, dtype=np.int32)
    meta.edge_perm[order] = flat_slot.astype(np.int32)

    # Per-chunk scalars.
    meta.chunk_block = np.repeat(np.arange(num_blocks, dtype=np.int32), chunks_per_block)
    meta.chunk_window = meta.block_window[meta.chunk_block]
    meta.chunk_first_in_block = np.zeros(num_chunks, dtype=np.int32)
    meta.chunk_first_in_block[block_chunk_start[:-1]] = 1
    meta.chunk_first_in_window = np.zeros(num_chunks, dtype=np.int32)
    meta.chunk_first_in_window[block_chunk_start[block_start[:-1]]] = 1


def build_a_tiles_host(meta: SGTMeta, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side dense A-tile build (f32 NumPy, bincount scatter)."""
    if weights is None and meta.a_tiles is not None:
        return meta.a_tiles
    cfg = meta.config
    size = meta.num_blocks * cfg.blk_h * cfg.blk_w
    if weights is None:
        # Simple graphs have one edge per slot: assign, then check the sum
        # and redo with the exact bincount if a duplicate collapsed.
        flat = np.zeros(size, np.float32)
        flat[meta.edge_pos] = 1.0
        if int(flat.sum(dtype=np.int64)) == meta.num_edges:
            return flat.reshape(meta.num_blocks, cfg.blk_h, cfg.blk_w)
    flat = np.bincount(
        meta.edge_pos,
        weights=None if weights is None else weights.astype(np.float64),
        minlength=size,
    ).astype(np.float32)
    return flat.reshape(meta.num_blocks, cfg.blk_h, cfg.blk_w)


def count_blocks(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    config: TileConfig = DEFAULT_CONFIG,
) -> int:
    """Total block count (padding blocks included) without the full pass:
    sizes the dense tiles before they are built."""
    num_windows = max(_cdiv(num_nodes, config.blk_h), 1)
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    num_cols = _num_cols(column_index, num_nodes, None)
    _, uniq_key, _ = _window_pairs(
        row_pointers, column_index, num_nodes, num_cols, config.blk_h
    )
    real = _cdiv(np.bincount(uniq_key // num_cols, minlength=num_windows), config.blk_w)
    return int(_pad_blocks(real, config).sum())


def is_symmetric(row_pointers, column_index, t_ptr, t_idx) -> bool:
    """A == A^T, given A's CSR and its transpose's (``transpose_csr``)."""
    return bool(
        len(t_ptr) == len(row_pointers)
        and np.array_equal(np.asarray(t_ptr, np.int64), np.asarray(row_pointers, np.int64))
        and np.array_equal(np.asarray(t_idx, np.int64), np.asarray(column_index, np.int64))
    )


def transpose_csr(row_pointers: np.ndarray, column_index: np.ndarray, num_nodes: int):
    """CSR of the transposed adjacency, for the backward on directed graphs.

    Returns:
      (t_row_pointers, t_column_index, t_edge_src): transpose CSR plus, per
      transpose edge k, the id of the corresponding forward edge.
    """
    degrees = np.diff(np.asarray(row_pointers, dtype=np.int64))
    src = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
    dst = np.asarray(column_index, dtype=np.int64)
    # Stable sort by dst: within a transpose row the src columns come out
    # ascending, i.e. CSR-sorted.
    order = np.argsort(dst, kind="stable")
    t_cols = src[order].astype(np.int32)
    t_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=t_ptr[1:])
    return t_ptr.astype(np.int32), t_cols, order.astype(np.int32)
