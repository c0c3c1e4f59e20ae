"""DistributedTiledGraph: the SGT-tiled graph over a ``('graph',
'feature')`` shard grid (PyTorch port of ``tcgnn_tpu.parallel.graph``: the
dense-tile, block-diagonal, streamed and chunk routes).

In one process every shard of the grid lives on the mesh's one device
(``parallel/mesh.py``); the shards run in turn, and the collectives between
them are copies on that device (``parallel/collectives.py``).  Over
processes each rank holds its graph shards (``shards``, ``lg`` of them) and,
of each, every feature shard or one (``fshards``, ``lf`` of them); a
collective over an axis the rank does not hold whole crosses ranks.  Every
rank runs the whole host pass (deterministic: every rank gets the same
partition) and uploads its own shards' metadata.  Inputs and outputs of the
ops are the process's block of the globally shaped tensors: node features
``[local_nodes, D * lf / pf]``, rows ``node_rows`` and columns
``node_cols`` of ``[padded_nodes, D]`` (shard ``(g, f)`` is rows ``g *
rows_per_shard ...`` and the f-th of ``pf`` equal column slices), per-edge
vectors ``[lg * edge_capacity]`` of ``[padded_edges]`` (shard g's edges, the
CSR slice of its rows, padded to ``edge_capacity``), the same on every
feature rank.  In one process the block is the whole tensor.

Where a rank holds one feature shard of several, the dense side reshards as
JAX's partitioner does for it, with the JAX layout kept for every node
tensor: each product ``x @ W`` is column-parallel (``feature_dot``: ``x``
all-gathered over ``feature``, times the rank's columns of ``W``; its
backward reduce-scatters), the logits are all-gathered before the
log-softmax (``gather_features``; every feature rank then holds the same
loss, which the training step counts once), and the per-edge AGNN's
attention weights, which meet the all-reduced edge scores, have their
gradient counted on one feature rank (``count_once``).  Elsewhere these
hooks are None.

What a shard does, as in JAX:

* **halo exchange** — the shard aggregates the rows it owns from columns
  any shard owns.  It gathers from an extended slab ``[rows_per_shard +
  halo_rows, d]``: its own rows, then the boundary rows the partition's
  request lists name, delivered by quantized partial-pair ``ppermute``
  rounds (``partition.plan_halo_rounds``).  The plan travels with each
  direction's metadata;
* **the block-stream split** (``partition.build_split``) — underloaded
  shards compute tail slices of overloaded windows as guest windows and
  return the partial ``[blk_h, d]`` tiles to their owners by one
  ``all_to_all``.  Both SpMM flavours ride it (the weighted one rebuilds its
  tiles from the all-gathered edge vector through ``w_src``), and so does
  the fused AGNN, whose guest score tiles get the owners' window rows by a
  second ``all_to_all`` (``xa_fetch``).  Per-edge outputs (the SDDMM) take
  the overlap classes below;
* **the halo-overlap split** (``partition.split_local_remote``) — each
  shard's blocks in two classes: the *local* blocks, whose columns are all
  the shard's own rows, and the *remote* ones.  An unsplit SpMM (the split
  stream takes a direction's SpMMs wherever the partition built one) and
  every SDDMM start the halo exchange, run the local class against the
  resident rows, wait, run the remote class against the halo slab, and add
  the two outputs, each stored in the compute dtype (the SDDMM's f32 scores
  into ``edge_capacity`` zeros a class).  Over processes the local class's
  kernels are enqueued while the transfers are in flight.  Each class has
  its own edges: the weighted SpMM builds a class's tiles from them, K4
  scores them;
* **the fused AGNN** (symmetric graphs) — ``pf == 1``: K2 forward and K3
  backward (with the window-side overrides on the split stream); ``pf >
  1``: a score needs every feature, so each feature shard forms partial
  score tiles (K4's tile mode), rounds them to the compute dtype, sums them
  in f32 over ``feature`` and rounds the sum; K10 multiplies them in.

The block-diagonal route (``parallel/blockdiag.py``), where the JAX gate
``probe_block_diag`` takes a graph (fully covered by its diagonals in both
directions, bins aligned with the shards, the rim within one neighbour
shard): the light partition (layout only, no condensed tile), each shard's
pack over an extended slab with an empty rim, and its features as the rim
stack ``x_ext``, built by two ``ppermute`` shifts.  ``spmm`` is K5 over the
count pack (transpose pack backward); ``spmm_weighted`` K5 over a weighted
pack (``bd_scatter_weights``; the transpose reads the all-gathered forward
weights); ``sddmm`` K4 an edge, summed over ``feature``; the fused AGNN K6
forward and K7 backward over the ext pack's row index at ``pf == 1``, and
at ``pf > 1`` one score a pack cell (K4's partial dots summed over
``feature`` in f32 and rounded once, the JAX order), multiplied by the
cell's count and scattered into a weighted pack for K5.

The streamed route, where a shard's chunk layout passes the streamed
limits (``_shards_need_streaming``, the JAX gate; reddit), and the chunk
fallback (``dense_tiles=False``, or a shard's tile index space past int32):
every op all-gathers the sharded features over ``graph`` and runs K8 (the
SpMMs) or K9 (the SDDMM) on each shard's chunk layout, its own rows against
the all-gathered ``[padded_nodes, d]`` matrix.  The streamed route's layout
is ``partition.partition_streamed``'s window segments (both directions,
each from the light partition's offsets), the fallback's the partition's
stacked chunk arrays, one segment a shard.  The weighted SpMM's forward
reads the shard's own slice of the edge vector, its transpose the
all-gathered forward vector through ``edge_fwd_slot``; the SDDMM writes each
shard's scores into ``edge_capacity`` zeros, summed over ``feature``.
Outputs are f32, as the JAX chunk routes store them, and there is no fused
AGNN (``agnn_aggregate`` is None): AGNN runs K9 and the weighted K8.

The port differs from the JAX route on purpose, changing no value:

* JAX leaves the overlap of the local class with the exchange to XLA's
  async collectives; the port issues the exchange's transfers, enqueues
  the local class's kernels and then waits (``collectives.ppermute_start``);
  in one process the exchange is a set of copies, made before the local
  class runs;
* the block-diagonal route contracts each shard's ext pack against its rim
  stack with K5-K7, where JAX contracts the shard's pack against a stack of
  rim and bins with XLA einsums; at ``pf > 1`` the AGNN backward's
  transpose term is K5 over ``C ⊙ U`` (``U_ij = <x_i, dy_j>``), the same
  value on a symmetric pack, where JAX spills rim bins back to the
  neighbours;
* on the streamed route and the chunk fallback, K8 and K9 walk each
  shard's CSR row index (derived from its layout at upload), one launch for
  all its segments, where JAX scans a chunk kernel over the segments; a
  symmetric graph's transpose shares the forward layout (the two
  partitions' arrays are equal); each shard's layout takes its own edge
  count, so its padding slots are the segment layout's own (row ``blk_h``),
  and outputs are padded to ``edge_capacity`` afterwards;
* the attention gradient's partial dots ``dc`` are summed over the
  rank's shards only (``_dc_sum``, both axes): the training step's gradient
  all-reduce finishes the sum, as XLA folds JAX's ``psum`` into its gradient
  all-reduce;
* one feature shard a rank, the op pads its own slice to a multiple of 8
  columns, where JAX pads the whole width to ``8 * pf`` and cuts it (so a
  narrow width's padding falls in JAX's last shards, in every shard here):
  the values a column are the same;
* one process holds every shard on one card, so no time it gives is a
  multi-card figure; nor is one of several processes on one card (gloo).

Within a training step (``shared_exchanges``), an exchange the step repeats
on the same tensor (an AGNN backward's halo of its input, an SDDMM's and a
weighted SpMM's all-gather of the same features) returns the first one's
result, as XLA merges the repeats in the compiled JAX step, so both move
the same bytes; ``comm_stats.step_collective_bytes`` counts them.

What is left of the JAX layer (ROADMAP.md, Queue 1 item 8c-iv): a
multi-card run over NCCL.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.graph import StageClock
from tcgnn_tpu_torch.ops.blockdiag import (
    bd_scatter_weights,
    bd_sfused,
    bd_sfused_bwd,
    spmm_block_diag,
)
from tcgnn_tpu_torch.ops.chunk import sddmm_tc, spmm_tc
from tcgnn_tpu_torch.ops.fused import spmm_fused
from tcgnn_tpu_torch.ops.sddmm import sddmm_tc_dense, sddmm_tc_tiles
from tcgnn_tpu_torch.ops.row_index import RowIndex
from tcgnn_tpu_torch.ops.sfused import sgt_row_index, spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense
from tcgnn_tpu_torch.parallel import collectives as C
from tcgnn_tpu_torch.parallel.blockdiag import BDDirection, build_bd_shard_meta, rim, upload_bd
from tcgnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from tcgnn_tpu_torch.parallel.partition import (
    ShardedSGTMeta,
    partition_graph,
    partition_streamed,
)
from tcgnn_tpu_torch.sgt import native
from tcgnn_tpu_torch.sgt.translate import (
    TorchChunkMeta,
    TorchSGTMeta,
    is_symmetric,
    shard_meta,
    transpose_csr,
    window_blocks,
)

# Input features are padded to a multiple of this many columns a feature
# shard (JAX's ``d_tile``), so both packages build the same first layer.
FEATURE_TILE = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def probe_block_diag(row_pointers, column_index, num_nodes: int, num_shards: int,
                     config: TileConfig = DEFAULT_CONFIG):
    """The JAX gate of the distributed block-diagonal route: both
    directions fully covered by diagonals, bins aligned with the shards,
    the rim halo within one neighbour shard, pack slots within int32.

    Returns ``(ok, bdm, bdm_t, symmetric, (t_ptr, t_idx, t_src))``."""
    from tcgnn_tpu_torch.sgt.blockdiag import extract_block_diag

    n = int(num_nodes)
    wd = _round_up(max(-(-n // config.blk_h), 1), num_shards) // num_shards
    rows_per_shard = wd * config.blk_h
    t_ptr, t_idx, t_src = transpose_csr(np.asarray(row_pointers), np.asarray(column_index), n)
    symmetric = is_symmetric(row_pointers, column_index, t_ptr, t_idx)
    bdm = extract_block_diag(row_pointers, column_index, n)
    bdm_t = bdm if (symmetric or bdm is None) else extract_block_diag(t_ptr, t_idx, n)

    def ok(m):
        if m is None or m.coverage < 1.0 or rows_per_shard % m.bin_rows:
            return False
        b_loc = rows_per_shard // m.bin_rows
        return (max(abs(k) for k in m.offsets) <= b_loc
                and len(m.offsets) * b_loc * m.bin_rows**2 + 1 < 2**31)

    return ok(bdm) and ok(bdm_t), bdm, bdm_t, symmetric, (t_ptr, t_idx, t_src)


def _shards_need_streaming(row_pointers, column_index, num_nodes, num_shards, config) -> bool:
    """Would a shard's chunk layout pass the streamed route's limits
    (``sgt.stream``'s, per shard)?  The JAX probe; the real blocks are
    counted (``window_blocks``, as JAX's native count, without the padding
    blocks of empty windows) where the bound does not settle it."""
    from tcgnn_tpu_torch.sgt import stream

    blk_h = config.blk_h
    ptr = np.asarray(row_pointers, np.int64)
    wd = -(-max(-(-num_nodes // blk_h), 1) // num_shards)
    rows_per_shard = wd * blk_h
    ptr = np.concatenate([ptr, np.full(num_shards * rows_per_shard + 1 - len(ptr), ptr[-1],
                                       np.int64)])
    cols = np.asarray(column_index)
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        e_s = int(ptr[r1] - ptr[r0])
        if e_s // config.edge_chunk + wd > stream.MAX_PREFETCH_CHUNKS:
            return True
        if (-(-e_s // config.blk_w) + wd) * config.blk_w <= stream.MAX_SLAB_ROWS:
            continue
        blocks = int(window_blocks(ptr[r0:r1 + 1] - ptr[r0], cols[ptr[r0]:ptr[r1]],
                                   rows_per_shard, config).sum())
        if blocks * config.blk_w > stream.MAX_SLAB_ROWS:
            return True
    return False


@dataclasses.dataclass
class _Stream:
    """One shard's block stream on the device: its metadata and tiles, and
    where K2/K3 run over it, the tiles' per-row index.  A class of the
    halo-overlap split also holds its edges' slots among the shard's edges
    (``edges``, in CSR order: ``meta``'s edges are these)."""

    meta: TorchSGTMeta
    tiles: torch.Tensor  # [B, blk_h, blk_w] structural
    index: Optional[RowIndex] = None
    edges: Optional[torch.Tensor] = None  # [E_class] int64

    @classmethod
    def make(cls, meta, tiles, with_index: bool) -> "_Stream":
        return cls(meta, tiles, sgt_row_index(meta, tiles) if with_index else None)


@dataclasses.dataclass
class _Split:
    """One direction's split stream on the device, per shard g."""

    guest_cap: int
    pair_cap: int
    streams: list  # [_Stream]
    w_src: list  # [es_g] int64: each real edge's slot in the all-gathered edge vector
    guest_slot: list  # guest slots j with a destination ...
    guest_dest: list  # ... and their position in the [G * qcap] send stack
    recv_src: list  # incoming partial rows that land ...
    recv_dst: list  # ... on these own rows
    fetch_rows: list  # owner rows sent for guest score tiles (recv_row_idx, clamped)
    fetch_valid: list
    xa_fetch: list  # guest slot rows in the received stack (clamped)
    xa_valid: list


@dataclasses.dataclass
class _Direction:
    """One direction (forward, or transpose for the backward) on the device."""

    host: ShardedSGTMeta
    rounds: tuple  # the halo plan: (pos, size, pairs), ...
    send_idx: list  # per shard g: [halo_rows] int64 local rows to send
    streams: list  # per shard g: the unsplit _Stream where the fused AGNN reads it, else []
    edge_fwd_slot: Optional[list]  # transpose: per g, [e_g] int64 forward slots
    split: Optional[_Split]
    local: list  # per shard g: the local class, gathering the shard's own rows
    remote: list  # per shard g: the remote class, gathering the halo slab


@dataclasses.dataclass
class _ChunkDirection:
    """One direction of the streamed route or the chunk fallback on the
    device: per shard g, its chunk layout (``num_rows = rows_per_shard``,
    ``num_src = padded_nodes``) with the row index K8/K9 walk, and on the
    transpose each of its edges' forward slot."""

    metas: list  # per shard g: TorchChunkMeta
    edge_fwd_slot: Optional[list] = None  # transpose: per g, [e_g] int64


class DistributedTiledGraph:
    """SGT-tiled graph partitioned over a ``('graph', 'feature')`` mesh.

    ``dense_tiles``, ``block_diag``, ``split`` and ``streamed`` as in JAX:
    ``None`` decides by the JAX rules.  The block-diagonal route wins over
    the others; ``streamed=None`` streams where a shard's chunk layout
    passes the streamed limits (``_shards_need_streaming``), ``True``
    streams any graph off the block-diagonal route; ``dense_tiles=False``
    (or ``None`` and a shard's tile index space past int32) takes the chunk
    fallback.  ``block_diag=True`` on a graph the block-diagonal gate
    refuses raises ``ValueError``.  ``_stream_limits``: ``(max_chunks,
    max_slab_rows)`` of a segment in place of ``sgt.stream``'s (tests force
    many segments on small graphs).

    ``prep_stages`` holds the seconds of the host passes by stage (with
    ``distributed_graph_from_dataset``, its probe and balance too) and
    ``prep_host_s`` their sum.
    """

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        config: TileConfig = DEFAULT_CONFIG,
        dense_tiles: Optional[bool] = None,
        block_diag: Optional[bool] = None,
        split: Optional[bool] = None,
        streamed: Optional[bool] = None,
        _probe=None,
        _symmetric: Optional[bool] = None,
        _stream_limits: Optional[tuple] = None,
        _clock: Optional[StageClock] = None,
    ):
        if mesh is None:
            mesh = make_mesh()
        row_pointers = np.asarray(row_pointers)
        column_index = np.asarray(column_index)
        if num_nodes is None:
            num_nodes = len(row_pointers) - 1
        if config.block_group == 0:
            config = dataclasses.replace(config, block_group=1)
        self.mesh = mesh
        self.device = mesh.device
        self.pg, self.pf = mesh.n_graph, mesh.n_feature
        # The graph shards this process holds (all of them in one process),
        # and their count: shard grids and device metadata are over these;
        # and of each, the feature shards it holds (every one, or one where
        # the ranks split the feature axis) and their count.
        self.shards = mesh.graph_shards
        self.lg = len(self.shards)
        self.fshards = mesh.feature_shards
        self.lf = len(self.fshards)
        # The dense side's resharding hooks (``models/layers.py``,
        # ``models/nets.py``), where the process holds one feature shard of
        # several; None where it holds the whole width.
        one_of_several = self.lf < self.pf
        self.feature_dot = self._feature_dot if one_of_several else None
        self.gather_features = self._gather_features if one_of_several else None
        self.count_once = self._count_once if one_of_several else None
        self.config = config
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))
        self.block_diag = self.streamed = False
        self._memo = None  # shared_exchanges' memo, while one is open
        # The partition's host passes (transpose, SGT, BD probe) take
        # impl="auto": the native pass where its library loads.
        self.host_pass = native.pass_name("auto")
        clock = _clock if _clock is not None else StageClock()
        self.prep_stages = clock.seconds

        # ---- route gates, the JAX rules: block-diagonal, streamed, dense or
        # chunk tiles.
        t_csr = None
        if dense_tiles is not False and block_diag is not False:
            # ``_probe``: distributed_graph_from_dataset ran the gate on this
            # exact CSR; its transpose serves the partition too.
            if _probe is None:
                with clock("bd_probe"):
                    _probe = probe_block_diag(row_pointers, column_index, self.num_nodes,
                                              self.pg, config)
            ok, bdm, bdm_t, self.symmetric, t_csr = _probe
            if block_diag and not ok:
                raise ValueError("block_diag requested but the graph is not fully covered "
                                 "by shard-compatible diagonals")
            if ok:
                self._init_bd(row_pointers, column_index, bdm, bdm_t, t_csr, clock)
                return
        elif _symmetric is not None:
            self.symmetric = _symmetric
        else:
            with clock("transpose"):
                t_csr = transpose_csr(row_pointers, column_index, self.num_nodes)
            with clock("symmetry"):
                self.symmetric = is_symmetric(row_pointers, column_index, *t_csr[:2])
        if streamed is None:
            with clock("stream_gate"):
                streamed = _shards_need_streaming(row_pointers, column_index, self.num_nodes,
                                                  self.pg, config)
        if streamed:
            self._init_streamed(row_pointers, column_index, t_csr, _stream_limits, clock)
            return

        want_split = (split is not False and dense_tiles is not False and self.pg > 1
                      and config.block_group == 1)
        with clock("partition"):
            fwd, bwd = partition_graph(row_pointers, column_index, self.num_nodes, self.pg,
                                       config, split=want_split, transpose=t_csr)
        if dense_tiles is None:
            dense_tiles = (max(fwd.a_tiles.shape[1], bwd.a_tiles.shape[1])
                           * config.blk_h * config.blk_w < 2**31)
        if not dense_tiles:
            self._init_chunk_fallback(fwd, bwd)
            return
        self.dense_tiles = True
        self._set_layout(fwd, bwd)
        # The fused AGNN rides the forward split stream where there is one,
        # else the forward's unsplit stream (the one op that still reads
        # it); on a mesh of one feature shard it is K2/K3, over the stream's
        # row index.
        self._fwd = self._upload(fwd, with_fwd_slot=False,
                                 sfused=self.symmetric and self.pf == 1,
                                 unsplit=self.symmetric and fwd.split is None)
        self._bwd = self._upload(bwd, with_fwd_slot=True)
        self.agnn_split = self.symmetric and fwd.split is not None
        self.agnn_aggregate = self._agnn_aggregate if self.symmetric else None

    # ---- statistics and placement ------------------------------------------
    @property
    def tc_blocks(self) -> int:
        return self.host_fwd.num_real_blocks

    @property
    def exp_edges(self) -> int:
        return self.host_fwd.num_real_blocks * self.config.blk_h * self.config.blk_w

    @property
    def prep_host_s(self) -> float:
        return sum(self.prep_stages.values())

    def _set_layout(self, fwd: ShardedSGTMeta, bwd: ShardedSGTMeta) -> None:
        """The partition's shapes and edge offsets."""
        self.host_fwd, self.host_bwd = fwd, bwd
        self.rows_per_shard = fwd.rows_per_shard
        self.windows_per_shard = fwd.windows_per_shard
        self.padded_nodes, self.padded_edges = fwd.padded_nodes, fwd.padded_edges
        self.edge_capacity = fwd.edge_capacity
        # This process's rows of the padded node order, and its count of
        # them: the ops take and give these rows (all of them in one
        # process), and the per-edge vectors ``lg * edge_capacity`` slots.
        rps, g0 = self.rows_per_shard, self.shards.start
        self.node_rows = slice(g0 * rps, (g0 + self.lg) * rps)
        self.local_nodes = self.lg * rps

    def _init_streamed(self, row_pointers, column_index, t_csr, stream_limits, clock) -> None:
        """Finish construction on the streamed route: the light partition
        (offsets, capacities, ``edge_fwd_slot``), each direction's window
        segments stacked over the shards (``partition_streamed``; a
        symmetric graph's transpose shares the forward's, whose arrays it
        equals), and each shard's layout on the device with its row index."""
        cfg, pg, n = self.config, self.pg, self.num_nodes
        self.streamed, self.dense_tiles = True, False
        if t_csr is None:
            with clock("transpose"):
                t_csr = transpose_csr(row_pointers, column_index, n)
        with clock("partition"):
            fwd, bwd = partition_graph(row_pointers, column_index, n, pg, cfg,
                                       build_tiles=False, transpose=t_csr)
        self._set_layout(fwd, bwd)
        mc, msr = stream_limits if stream_limits is not None else (None, None)
        with clock("segments"):
            sp_f = partition_streamed(row_pointers, column_index, n, pg, cfg,
                                      edge_capacity=fwd.edge_capacity, max_chunks=mc,
                                      max_slab_rows=msr)
            sp_b = sp_f if self.symmetric else partition_streamed(
                t_csr[0], t_csr[1], n, pg, cfg, edge_capacity=bwd.edge_capacity, max_chunks=mc,
                max_slab_rows=msr)
        a = sp_f["arrays"]
        self.num_segments, self.wseg = sp_f["num_segments"], sp_f["wseg"]
        self.chunk_cap = int(a["seg_r"].shape[2])
        self.slab_blocks = int(a["seg_col_ids"].shape[2]) // cfg.blk_w

        def upload(sp, m: ShardedSGTMeta):
            a, counts = sp["arrays"], np.diff(m.edge_start)
            return [TorchChunkMeta.upload(
                cfg, self.rows_per_shard, self.padded_nodes, counts[g], self.windows_per_shard,
                sp["wseg"], *(a[k][g] for k in (
                    "seg_col_ids", "seg_r", "seg_c", "seg_edge_id", "seg_block", "seg_window",
                    "seg_chunks")), self.device) for g in self.shards]

        metas_f = upload(sp_f, fwd)
        metas_b = metas_f if self.symmetric else upload(sp_b, bwd)
        self._set_chunk_directions(metas_f, metas_b, bwd)

    def _init_chunk_fallback(self, fwd: ShardedSGTMeta, bwd: ShardedSGTMeta) -> None:
        """Finish construction on the chunk fallback: each shard's stacked
        chunk arrays as a layout of one segment (its padding chunks are
        padding slots alike), on the device with its row index; no split."""
        cfg = self.config
        self.dense_tiles = False
        fwd.split = bwd.split = None
        self._set_layout(fwd, bwd)
        self.num_segments, self.wseg = 1, self.windows_per_shard
        self.chunk_cap = int(fwd.chunk_r.shape[1])

        def upload(m: ShardedSGTMeta):
            counts, cn = np.diff(m.edge_start), m.chunk_r.shape[1]
            return [TorchChunkMeta.upload(
                cfg, self.rows_per_shard, self.padded_nodes, counts[g], self.windows_per_shard,
                self.windows_per_shard, m.col_ids[g][None], m.chunk_r[g][None],
                m.chunk_c[g][None], m.chunk_edge_id[g][None], m.chunk_block[g][None],
                m.chunk_window[g][None], np.array([cn], np.int32), self.device)
                for g in self.shards]

        self._set_chunk_directions(upload(fwd), upload(bwd), bwd)

    def _set_chunk_directions(self, metas_f, metas_b, bwd: ShardedSGTMeta) -> None:
        counts = np.diff(bwd.edge_start)
        slots = [torch.from_numpy(bwd.edge_fwd_slot[g][: counts[g]].astype(np.int64))
                 .to(self.device) for g in self.shards]
        self._fwd = _ChunkDirection(metas_f)
        self._bwd = _ChunkDirection(metas_b, edge_fwd_slot=slots)
        self.agnn_split = False
        self.agnn_aggregate = None

    def _init_bd(self, row_pointers, column_index, bdm, bdm_t, t_csr, clock) -> None:
        """Finish construction on the block-diagonal route: the light
        partition (layout and ``TC_Blocks`` only), each direction's shard
        metadata (``build_bd_shard_meta``) and its ext packs on the device
        (the transpose's only where the graph is not symmetric), and the
        forward shards' edges for the SDDMM."""
        cfg, pg, dev = self.config, self.pg, self.device
        self.block_diag = self.dense_tiles = True
        with clock("partition"):
            fwd, bwd = partition_graph(row_pointers, column_index, self.num_nodes, pg, cfg,
                                       build_tiles=False, transpose=t_csr)
        self._set_layout(fwd, bwd)
        rps = self.rows_per_shard
        with clock("bd_shard_meta"):
            mf = build_bd_shard_meta(bdm, fwd.edge_start, rps, pg, fwd.edge_capacity)
            mt = build_bd_shard_meta(bdm_t, bwd.edge_start, rps, pg, bwd.edge_capacity)

        # Shard g's edges: its own rows, columns in its ext slab.
        ptr = np.asarray(row_pointers, np.int64)
        ptr = np.concatenate([ptr, np.full(self.padded_nodes + 1 - len(ptr), ptr[-1])])
        cols = np.asarray(column_index, np.int64)
        lead = -rim(mf.offsets)[0] * mf.bin_rows
        edges = []
        for g in self.shards:
            local = ptr[g * rps:(g + 1) * rps + 1] - ptr[g * rps]
            edges.append((np.repeat(np.arange(rps), np.diff(local)),
                          cols[ptr[g * rps]:ptr[(g + 1) * rps]] - g * rps + lead))
        sym = self.symmetric
        self._fwd = upload_bd(mf, cfg, dev, np.diff(fwd.edge_start), self.shards,
                              row_index=sym and self.pf == 1, cells=sym and self.pf > 1,
                              edges=edges)
        self._bwd = upload_bd(mt, cfg, dev, np.diff(bwd.edge_start), self.shards,
                              w_src=bwd.edge_fwd_slot,
                              packs=[sh.pack for sh in self._fwd.shards] if sym else None)
        self.agnn_split = False
        self.agnn_aggregate = self._agnn_aggregate if sym else None

    @property
    def route(self) -> str:
        """The trainer's route line; where the ranks split the feature axis,
        its layout (``ranks=WgxF``) at the end."""
        if self.lf == self.pf:
            return self._route
        return f"{self._route} ranks={self.mesh.graph_world}x{self.mesh.feature_world}"

    @property
    def _route(self) -> str:
        if self.block_diag:
            f, t = self._fwd, self._bwd
            agnn = ("none" if self.agnn_aggregate is None
                    else "K6/K7" if self.pf == 1 else "K4 scores + K5")
            bwd = ("" if t.offsets == f.offsets
                   else f" transpose offsets={t.offsets} rim={t.rim}")
            return (f"dense_tiles=True streamed=False block_diag=True mesh={self.pg}x{self.pf} "
                    f"offsets={f.offsets} rim={f.rim}{bwd} agnn={agnn}")
        if not self.dense_tiles:
            layout = (f"segments={self.num_segments} wseg={self.wseg} "
                      f"chunk_cap={self.chunk_cap} slab_blocks={self.slab_blocks}"
                      if self.streamed else f"chunks={self.chunk_cap}")
            shared = "shared" if self._bwd.metas is self._fwd.metas else "own"
            return (f"dense_tiles=False streamed={self.streamed} block_diag=False "
                    f"mesh={self.pg}x{self.pf} {layout} transpose_layout={shared} agnn=none")
        sp = lambda m: "split" if m.split is not None else "unsplit"  # noqa: E731
        agnn = ("none" if self.agnn_aggregate is None
                else ("K2/K3" if self.pf == 1 else "K4 tiles + K10")
                + (" on the split stream" if self.agnn_split else ""))
        return (f"dense_tiles=True streamed=False block_diag=False mesh={self.pg}x{self.pf} "
                f"stream fwd={sp(self.host_fwd)} bwd={sp(self.host_bwd)} overlap=True "
                f"halo_rounds={len(self.host_fwd.halo['rounds'])} agnn={agnn}")

    @property
    def use_overlap(self) -> bool:
        """Do the ops take the halo-overlap split's classes (JAX's
        ``_use_overlap``)?  On the dense-tile route, always: the SDDMM, and
        each direction's SpMMs where it has no split stream."""
        return self.dense_tiles and not self.block_diag

    def feature_width(self, d: int) -> int:
        """The width ``shard_features`` pads ``d`` input features to: a
        multiple of ``FEATURE_TILE * pf`` (JAX's ``d_tile``)."""
        return _round_up(max(d, 1), FEATURE_TILE * self.pf)

    def node_cols(self, d: int) -> tuple:
        """For a node tensor of ``d`` columns on this process: the width of
        the global tensor it is a block of, and its columns there (every
        column where the process holds every feature shard)."""
        width = d * self.pf // self.lf
        return width, slice(self.fshards.start * d // self.lf, self.fshards.stop * d // self.lf)

    def _rows(self, v) -> torch.Tensor:
        """This process's rows (``node_rows``) of a per-node array of up to
        ``padded_nodes`` rows, zero padded, on the mesh's device."""
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        rows = self.node_rows
        own = v[rows.start: min(rows.stop, v.shape[0])]
        pad = torch.zeros((self.local_nodes - own.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype)
        return torch.cat([own.cpu(), pad]).to(self.device)

    def shard_features(self, x) -> torch.Tensor:
        """``[N, D]`` features padded to ``[padded_nodes,
        feature_width(D)]``: this process's rows (``node_rows``) and columns
        (its feature shards' slices), on the mesh's device."""
        x = self._rows(x)
        d = x.shape[1]
        width = self.feature_width(d)
        x = torch.nn.functional.pad(x, (0, width - d))
        if self.lf == self.pf:
            return x
        dl = width // self.pf
        return x[:, self.fshards.start * dl:self.fshards.stop * dl].contiguous()

    def shard_nodes(self, v) -> torch.Tensor:
        """A per-node vector (labels, masks, norms) padded with zeros to
        ``padded_nodes`` rows: this process's rows."""
        return self._rows(v)

    def valid_node_mask(self) -> torch.Tensor:
        """1 on this process's rows that are real nodes, 0 on padding."""
        rows = torch.arange(self.node_rows.start, self.node_rows.stop, device=self.device)
        return (rows < self.num_nodes).float()

    def edge_weights_to_sharded(self, w_csr) -> torch.Tensor:
        """A ``[num_edges]`` CSR-ordered vector in the padded edge layout
        ``[padded_edges]``: this process's shards' slots, ``[lg *
        edge_capacity]``."""
        w = torch.as_tensor(np.asarray(w_csr) if not torch.is_tensor(w_csr) else w_csr)
        out = torch.zeros((self.lg, self.edge_capacity), dtype=w.dtype)
        es = self.host_fwd.edge_start
        for i, s in enumerate(self.shards):
            lo, hi = int(es[s]), int(es[s + 1])
            out[i, : hi - lo] = w[lo:hi].cpu()
        return out.reshape(-1).to(self.device)

    def gather_edge_vector(self, v) -> np.ndarray:
        """This process's ``[lg * edge_capacity]`` slots -> host, in CSR
        order: its shards' edges (``[num_edges]`` in one process)."""
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        v = v.reshape(self.lg, self.edge_capacity)
        es = self.host_fwd.edge_start
        return np.concatenate([v[i, : int(es[s + 1] - es[s])] for i, s in enumerate(self.shards)])

    # ---- device metadata ---------------------------------------------------
    def _upload(self, m: ShardedSGTMeta, with_fwd_slot: bool, sfused: bool = False,
                unsplit: bool = False) -> _Direction:
        """One direction's overlap classes, halo tables and split on the
        device, and with ``unsplit`` its unsplit streams; ``sfused``: with
        the row index of the streams K2/K3 run over (the split streams where
        there are, else the unsplit ones)."""
        dev, cfg, pg, shards = self.device, self.config, self.pg, self.shards
        own = slice(shards.start, shards.stop)
        halo = m.halo
        num_src = m.rows_per_shard + halo["halo_rows"]
        counts = np.diff(m.edge_start)

        def ids(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        def tiles(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return t if t.dtype == torch.int8 else t.to(cfg.compute_dtype)

        streams = []
        if unsplit:
            a_dev = tiles(m.a_tiles[own])
            streams = [
                _Stream.make(shard_meta(cfg, m.a_tiles[g], m.block_window[g],
                                        m.block_first_in_window[g], halo["col_ids_ext"][g],
                                        m.edge_pos[g][: counts[g]], m.windows_per_shard,
                                        num_src, dev), a_dev[i], sfused and m.split is None)
                for i, g in enumerate(shards)
            ]
        sp = None
        if m.split is not None:
            s = m.split
            gcap, qcap = int(s["guest_cap"]), int(s["pair_cap"])
            sentinel = s["a_tiles"].shape[1] * cfg.blk_h * cfg.blk_w
            es = (s["edge_pos"] < sentinel).sum(axis=1)
            sa_dev = tiles(s["a_tiles"][own])
            rows = m.rows_per_shard
            stack = pg * qcap * cfg.blk_h
            sp = _Split(
                guest_cap=gcap, pair_cap=qcap,
                streams=[
                    _Stream.make(shard_meta(cfg, s["a_tiles"][g], s["block_window"][g],
                                            s["block_first"][g], s["col_ids_ext"][g],
                                            s["edge_pos"][g][: es[g]],
                                            m.windows_per_shard + gcap, num_src, dev),
                                 sa_dev[i], sfused)
                    for i, g in enumerate(shards)
                ],
                w_src=[ids(s["w_src"][g][: es[g]]) for g in shards],
                guest_slot=[ids(np.flatnonzero(s["send_pos"][g] < pg * qcap)) for g in shards],
                guest_dest=[ids(s["send_pos"][g][s["send_pos"][g] < pg * qcap]) for g in shards],
                recv_src=[ids(np.flatnonzero(s["recv_row_idx"][g] < rows)) for g in shards],
                recv_dst=[ids(s["recv_row_idx"][g][s["recv_row_idx"][g] < rows]) for g in shards],
                fetch_rows=[ids(np.minimum(s["recv_row_idx"][g], rows - 1)) for g in shards],
                fetch_valid=[torch.from_numpy(s["recv_row_idx"][g] < rows).to(dev)
                             for g in shards],
                xa_fetch=[ids(np.minimum(s["xa_fetch"][g], stack - 1)) for g in shards],
                xa_valid=[torch.from_numpy(s["xa_fetch"][g] < stack).to(dev) for g in shards],
            )
        # The overlap classes: the local one gathers the shard's own rows,
        # the remote one the halo slab; each with its own edges.
        tile = cfg.blk_h * cfg.blk_w

        def classes(name, col_ids, rows):
            c = m.overlap[name]
            sentinel = c["a_tiles"].shape[1] * tile
            c_dev = tiles(c["a_tiles"][own])
            out = []
            for i, g in enumerate(shards):
                epos = c["edge_pos"][g][: counts[g]]
                edges = np.flatnonzero(epos < sentinel)
                meta = shard_meta(cfg, c["a_tiles"][g], c["block_window"][g],
                                  c["block_first_in_window"][g], col_ids[g], epos[edges],
                                  m.windows_per_shard, rows, dev)
                out.append(_Stream(meta, c_dev[i], edges=ids(edges)))
            return out

        return _Direction(
            host=m,
            rounds=tuple(halo["rounds"]),
            send_idx=[ids(halo["send_idx"][g]) for g in shards],
            streams=streams,
            edge_fwd_slot=([ids(m.edge_fwd_slot[g][: counts[g]]) for g in shards]
                           if with_fwd_slot else None),
            split=sp,
            local=classes("local", m.overlap["local"]["col_ids"], m.rows_per_shard),
            remote=classes("remote", halo["overlap_remote_col_ids_ext"], num_src),
        )

    # ---- shard grids --------------------------------------------------------
    @contextlib.contextmanager
    def shared_exchanges(self):
        """Within this context (one training step's forward and backward),
        an exchange of a tensor the step has already exchanged the same way
        returns that result and moves nothing, as XLA merges the JAX step's
        repeats (an AGNN backward's halo of its input, a weighted SpMM's and
        an SDDMM's all-gather of the same features).  The results live until
        the context closes."""
        self._memo = {}
        try:
            yield
        finally:
            self._memo = None

    def _shared(self, key, src: torch.Tensor, make):
        """``make()``, or inside ``shared_exchanges`` the result of the
        first ``make`` under ``key`` for the tensor ``src`` (held, so its
        memory stays its own)."""
        k = self._memo_key(key, src)
        if k is None:
            return make()
        if k not in self._memo:
            self._memo[k] = (src, make())
        return self._memo[k][1]

    def _memo_key(self, key, src: torch.Tensor):
        """The memo's key of ``key`` for ``src``; None outside
        ``shared_exchanges``."""
        if self._memo is None:
            return None
        return (key, src.data_ptr(), tuple(src.shape), src.stride(), src.dtype, src._version)

    def _pad_d(self, x: torch.Tensor) -> torch.Tensor:
        """Pad the feature dim to a multiple of ``8 * lf``: every feature
        shard of the process gets an equal slice.  Where the process holds
        one feature shard, its own slice is padded to a multiple of 8 (in
        one process the padding of the whole width falls in the last
        shards): the values a column are the same."""
        d = x.shape[1]
        d_pad = _round_up(max(d, 1), 8 * self.lf)
        if d_pad == d:
            return x
        return self._shared("pad", x, lambda: torch.nn.functional.pad(x, (0, d_pad - d)))

    def _grid(self, x: torch.Tensor):
        """This process's ``[local_nodes, D]`` block -> shard views
        ``grid[g][f]``, ``g`` over its graph shards, ``f`` over its feature
        shards."""
        if x.shape[0] != self.local_nodes:
            raise ValueError(f"node features of {x.shape[0]} rows, expected {self.local_nodes}")
        rps, dl = self.rows_per_shard, x.shape[1] // self.lf
        return [[x[g * rps:(g + 1) * rps, f * dl:(f + 1) * dl] for f in range(self.lf)]
                for g in range(self.lg)]

    def _edge_grid(self, w: torch.Tensor):
        """``[lg * edge_capacity]`` -> shard g's slice, the same for every f."""
        e = self.edge_capacity
        return [[w[g * e:(g + 1) * e]] * self.lf for g in range(self.lg)]

    @staticmethod
    def _assemble(grid) -> torch.Tensor:
        return torch.cat([torch.cat(row, dim=1) if len(row) > 1 else row[0] for row in grid])

    def _map(self, fn, *grids):
        """``fn(g, *shard_tensors)`` on every shard."""
        return [[fn(g, *(gr[g][f] for gr in grids)) for f in range(self.lf)]
                for g in range(self.lg)]

    # ---- collective steps ---------------------------------------------------
    def _halo(self, x: torch.Tensor, dn: _Direction):
        """Each shard's extended slab ``[rows_per_shard + halo_rows, d]`` of
        ``x``: its rows, then one segment per round of the partial-pair
        ``ppermute`` plan (receivers no pair lists get zeros)."""
        return self._halo_start(x, dn).wait()

    def _halo_start(self, x: torch.Tensor, dn: _Direction) -> C.Started:
        """``_halo``, started: every round of the plan is issued, and
        ``wait()`` waits on them and gives the slabs.  Within
        ``shared_exchanges`` a finished slab is kept, and an exchange of the
        same tensor returns it and moves nothing."""
        key = self._memo_key(("halo", id(dn)), x)
        if key is not None and key in self._memo:
            return C.Started.done(self._memo[key][1])
        started = self._halo_grid_start(self._grid(x), dn)

        def finish():
            out = started.wait()
            if key is not None and self._memo is not None:
                self._memo[key] = (x, out)
            return out

        return C.Started(finish)

    def _halo_grid_start(self, grid, dn: _Direction) -> C.Started:
        if self.pg == 1:
            return C.Started.done(grid)
        rounds = []
        for k, (pos, size, pairs) in enumerate(dn.rounds):
            send = self._map(lambda g, x: x.index_select(0, dn.send_idx[g][pos:pos + size]), grid)
            rounds.append(C.ppermute_start(send, pairs, "graph", self.mesh, tag=k))

        def finish():
            segs = self._map(lambda g, x: [x], grid)
            for r in rounds:
                recv = r.wait()
                for g in range(self.lg):
                    for f in range(self.lf):
                        segs[g][f].append(recv[g][f])
            return self._map(lambda g, s: torch.cat(s), segs)

        return C.Started(finish)

    def _w_all(self, w: torch.Tensor):
        """The all-gathered forward edge vector plus an appended zero (the
        sentinel slot), per shard."""
        def make():
            full = C.all_gather(self._edge_grid(w), "graph", self.mesh)
            return [torch.cat([full[g][0], full[g][0].new_zeros(1)]) for g in range(self.lg)]

        return self._shared("w_all", w, make)

    def _all_gather(self, x: torch.Tensor):
        """``x``'s shard grid all-gathered over ``graph``."""
        return self._shared("all_gather", x,
                            lambda: C.all_gather(self._grid(x), "graph", self.mesh))

    def _guest_return(self, out, sp: _Split):
        """Split stream: guest windows' partial tiles ride one all_to_all to
        their owners and add into the owners' rows; returns the own rows."""
        rows, bh = self.rows_per_shard, self.config.blk_h
        stack = self.pg * sp.pair_cap

        def pack(g, y):
            guests = y[rows: rows + sp.guest_cap * bh].reshape(sp.guest_cap, bh, -1)
            send = y.new_zeros((stack, bh, y.shape[1]))
            send[sp.guest_dest[g]] = guests[sp.guest_slot[g]]
            return send

        recv = C.all_to_all(self._map(pack, out), "graph", self.mesh)

        def add(g, y, r):
            own = y[:rows].clone()
            own.index_add_(0, sp.recv_dst[g], r.reshape(-1, y.shape[1])[sp.recv_src[g]])
            return own

        return self._map(add, out, recv)

    def _guest_rows(self, x: torch.Tensor, sp: _Split):
        """The owners' window rows of each shard's guest slots
        ``[guest_cap * blk_h, d]`` of ``x``, by one all_to_all (zeros for
        unused slots)."""
        def send(g, x):
            rows = x.index_select(0, sp.fetch_rows[g])
            return torch.where(sp.fetch_valid[g][:, None], rows, 0)

        def pick(g, r):
            rows = r.index_select(0, sp.xa_fetch[g])
            return torch.where(sp.xa_valid[g][:, None], rows, 0)

        return self._shared(("guest", id(sp)), x, lambda: self._map(
            pick, C.all_to_all(self._map(send, self._grid(x)), "graph", self.mesh)))

    # ---- the SpMMs and the SDDMM --------------------------------------------
    def _spmm_grid(self, x, dn: _Direction, w: Optional[torch.Tensor] = None):
        """``A @ x`` (or ``(A ⊙ w) @ x``) of one direction as a shard grid:
        the split stream where the partition built one, else the overlap
        classes: the halo exchange started, K1 over the local class against
        the shard's own rows, the exchange waited, K1 over the remote class
        against the halo slab, the two outputs added in the compute
        dtype."""
        if dn.split is None:
            vals = None if w is None else self._edge_vals(w, dn)

            def run(g, xs, cls):
                tiles = (cls.tiles if vals is None
                         else build_a_tiles(cls.meta, vals[g].index_select(0, cls.edges)))
                return spmm_tc_dense(xs, cls.meta, tiles)

            started = self._halo_start(x, dn)
            local = self._map(lambda g, xs: run(g, xs, dn.local[g]), self._grid(x))
            remote = self._map(lambda g, xe: run(g, xe, dn.remote[g]), started.wait())
            return self._map(lambda g, a, b: a + b, local, remote)
        x_ext = self._halo(x, dn)
        sp = dn.split
        if w is not None:
            w_all = self._w_all(w)
            vals = [w_all[g][sp.w_src[g]].float() for g in range(self.lg)]
        tiles = [s.tiles if w is None else build_a_tiles(s.meta, vals[g])
                 for g, s in enumerate(sp.streams)]
        out = self._map(lambda g, x: spmm_tc_dense(x, sp.streams[g].meta, tiles[g]), x_ext)
        return self._guest_return(out, sp)

    def _edge_vals(self, w: torch.Tensor, dn) -> list:
        """Each shard's per-edge weights, f32, its edges in CSR order: the
        forward's from the shard's own slice of ``w``, the transpose's from
        the all-gathered forward vector through ``edge_fwd_slot``."""
        if dn.edge_fwd_slot is not None:  # forward-ordered weights
            w_all = self._w_all(w)
            return [w_all[g][dn.edge_fwd_slot[g]].float() for g in range(self.lg)]
        e, counts = self.edge_capacity, np.diff(dn.host.edge_start)
        return [w[g * e: g * e + int(counts[s])].float() for g, s in enumerate(self.shards)]

    def _chunk_spmm_grid(self, x, dn: _ChunkDirection, w: Optional[torch.Tensor] = None):
        """``A @ x`` (or ``(A ⊙ w) @ x``) of one direction on the streamed
        route or the chunk fallback: K8 a shard over its layout against the
        all-gathered features, f32.  The forward reads the shard's own edge
        slice, the transpose the all-gathered forward vector through
        ``edge_fwd_slot``."""
        x_all = self._all_gather(x)
        vals = [None] * self.lg
        if w is not None:
            if dn.edge_fwd_slot is not None:
                w_all = self._w_all(w)
                vals = [w_all[g][dn.edge_fwd_slot[g]] for g in range(self.lg)]
            else:
                e = self.edge_capacity
                vals = [w[g * e: g * e + dn.metas[g].num_edges] for g in range(self.lg)]
        return self._map(lambda g, xa: spmm_tc(xa, dn.metas[g], vals[g]), x_all)

    def _spmm(self, x, dn, w=None) -> torch.Tensor:
        d = x.shape[1]
        xp = self._pad_d(x)
        if self.block_diag:
            out = self._bd_spmm_grid(xp, dn, w)
        elif not self.dense_tiles:
            out = self._chunk_spmm_grid(xp, dn, w)
        else:
            out = self._spmm_grid(xp, dn, w)
        return self._assemble(out)[:, :d]

    def _edge_scores(self, op, metas, xa_grid, xb_ext, edges=None):
        """``op`` (K4 or K9) a shard: its rows of ``xa`` against the gather
        side ``xb_ext``, written into ``edge_capacity`` zeros at the shard's
        first ``num_edges`` slots, or at ``edges[g]`` (an overlap class's
        edges); a shard grid of ``[edge_capacity]`` f32."""
        def scores(g, a, b):
            s = torch.zeros(self.edge_capacity, dtype=torch.float32, device=a.device)
            s[slice(metas[g].num_edges) if edges is None else edges[g]] = op(a, metas[g], b)
            return s

        return self._map(scores, xa_grid, xb_ext)

    def _feature_sum(self, s) -> torch.Tensor:
        """A shard grid of per-edge scores summed over ``feature``:
        ``[lg * edge_capacity]``."""
        if self.pf > 1:
            s = C.psum(s, "feature", self.mesh)
        return torch.cat([s[g][0] for g in range(self.lg)])

    def _sddmm(self, xa, xb) -> torch.Tensor:
        """Per-edge ``<xa[row_e], xb[col_e]>``, summed over the feature
        shards: ``[padded_edges]`` f32.  On the dense-tile route K4 over the
        forward overlap classes: the halo exchange started, the local
        class's edges against the shard's own rows, the exchange waited, the
        remote class's against the halo slab, each class's scores written
        into ``edge_capacity`` zeros and the two added.  K4 an edge on the
        block-diagonal route, K9 against the all-gathered features on the
        streamed and chunk routes."""
        dn = self._fwd
        if self.block_diag:
            return self._bd_sddmm(xa, xb)
        xa_grid, xb = self._grid(self._pad_d(xa)), self._pad_d(xb)
        if not self.dense_tiles:
            return self._feature_sum(
                self._edge_scores(sddmm_tc, dn.metas, xa_grid, self._all_gather(xb)))

        def scores(classes, xb_grid):
            return self._edge_scores(sddmm_tc_dense, [c.meta for c in classes], xa_grid, xb_grid,
                                     [c.edges for c in classes])

        started = self._halo_start(xb, dn)
        local = scores(dn.local, self._grid(xb))
        remote = scores(dn.remote, started.wait())
        return self._feature_sum(self._map(lambda g, a, b: a + b, local, remote))

    # ---- the fused AGNN ------------------------------------------------------
    def _score_tiles(self, xa, xb, streams):
        """Score tiles (K4's tile mode) for K10, in the compute dtype: each
        feature shard's partial tile is rounded to it, the partials are
        summed in f32 over ``feature`` and the sum is rounded, the JAX
        order.  Past 128 features a shard, JAX sums its d-tiles in f32 tiles
        and K10 rounds them as it reads them: here the partials stay f32 and
        the sum is rounded once, the same values."""
        ct = self.config.compute_dtype
        wide = xa[0][0].shape[1] > 128
        s = self._map(lambda g, a, b: sddmm_tc_tiles(
            a, streams[g].meta, b, out_dtype=torch.float32 if wide else ct), xa, xb)
        s = C.psum(self._map(lambda g, t: t.float(), s), "feature", self.mesh)
        return self._map(lambda g, t: t.to(ct), s)

    def _fused(self, x_ext, s, streams):
        return self._map(lambda g, x, t: spmm_fused(x, streams[g].meta, streams[g].tiles, t),
                         x_ext, s)

    def _agnn_streams(self):
        dn = self._fwd
        return (dn.split.streams if self.agnn_split else dn.streams), dn

    def _agnn_f(self, x):
        """``(A ⊙ x x^T) @ x`` on the shard grid, f32 (the compute dtype on
        the block-diagonal route)."""
        if self.block_diag:
            return self._bd_agnn_f(x)
        grid = self._grid(x)
        streams, dn = self._agnn_streams()
        x_ext = self._halo(x, dn)
        if self.agnn_split:
            g_rows = self._guest_rows(x, dn.split)
            x_win = self._map(lambda g, a, b: torch.cat([a, b]), grid, g_rows)
        else:
            x_win = grid
        if self.pf == 1:
            y = self._map(lambda g, xl, xe: spmm_sfused(xl, xe, xe, streams[g].meta,
                                                        streams[g].tiles,
                                                        index=streams[g].index), x_win, x_ext)
        else:
            y = self._fused(x_ext, self._score_tiles(x_win, x_ext, streams), streams)
        return self._guest_return(y, dn.split) if self.agnn_split else y

    def _agnn_b(self, x, dy):
        """``(dx3, dc)``: the three dx terms of the AGNN backward on the shard
        grid, and ``dc = <dy, (A ⊙ S) x>`` summed over every shard."""
        if self.block_diag:
            return self._bd_agnn_b(x, dy)
        grid, dgrid = self._grid(x), self._grid(dy)
        streams, dn = self._agnn_streams()
        x_ext, dy_ext = self._halo(x, dn), self._halo(dy, dn)
        if self.agnn_split:
            x_guest = self._guest_rows(x, dn.split)
            dy_guest = self._guest_rows(dy, dn.split)
            x_win = self._map(lambda g, a, b: torch.cat([a, b]), grid, x_guest)
            dy_win = self._map(lambda g, a, b: torch.cat([a, b]), dgrid, dy_guest)
        else:
            x_win, dy_win = grid, dgrid
        if self.pf == 1:
            both = self._map(lambda g, xe, de, xw, dw: spmm_sfused_bwd(
                xe, de, streams[g].meta, streams[g].tiles, xw=xw, dyw=dw,
                index=streams[g].index),
                x_ext, dy_ext, x_win, dy_win)
            y123 = self._map(lambda g, p: p[0], both)
            u = self._map(lambda g, p: p[1], both)
        else:
            # Symmetry turns the column-space term into a row-space pass:
            # (A ⊙ T)^T x = (A ⊙ T^T) x, T^T_ij = <x_i, dy_j>.
            s = self._score_tiles(x_win, x_ext, streams)   # S_ij = <x_i, x_j>
            t = self._score_tiles(dy_win, x_ext, streams)  # T_ij = <dy_i, x_j>
            u_t = self._score_tiles(x_win, dy_ext, streams)
            t1, t2a = self._fused(dy_ext, s, streams), self._fused(x_ext, t, streams)
            t2b = self._fused(x_ext, u_t, streams)
            y123 = self._map(lambda g, a, b, c: a + b + c, t1, t2a, t2b)
            u = self._fused(x_ext, s, streams)
        dx = self._guest_return(y123, dn.split) if self.agnn_split else y123
        # Each partial output tile counts once: own rows against the own dy
        # rows, guest rows against their owners' dy rows.
        dc = self._map(lambda g, dw, uu: torch.dot(dw.float().reshape(-1),
                                                   uu[: dw.shape[0]].reshape(-1)),
                       dy_win, u)
        dc = self._dc_sum(dc)
        return self._assemble(dx), dc[0][0]

    def _dc_sum(self, dc):
        """The attention gradient's partial dots summed over ``graph`` and
        ``feature``.  Over processes both sums stay within the rank (its
        graph and feature shards): the training step's gradient all-reduce
        finishes them, as XLA folds JAX's into that all-reduce, so no rank
        sums another's part twice.  Each counts as one ``all_reduce``, as in
        one process."""
        dc = C.psum(dc, "graph")
        return C.psum(dc, "feature") if self.pf > 1 else dc

    # ---- the block-diagonal route --------------------------------------------
    def _rim_ext(self, x: torch.Tensor, dn: BDDirection):
        """Each shard's rim stack of ``x``, ``x_ext = [rim of g-1 ; x_loc ;
        rim of g+1]``, ``[(b_loc + kmax - kmin) * bn, d]``: the last
        ``-kmin`` bins of the shard below and the first ``kmax`` bins of the
        shard above, by two ``ppermute`` shifts (zeros at either end of the
        mesh).  Directions of one rim share it."""
        return self._shared(("rim", dn.rim, dn.bin_rows), x,
                            lambda: self._rim_grid(self._grid(x), dn))

    def _rim_grid(self, grid, dn: BDDirection):
        (kmin, kmax), bn, pg = dn.rim, dn.bin_rows, self.pg
        parts = self._map(lambda g, x: [x], grid)
        if kmin < 0:
            lo = C.ppermute(self._map(lambda g, x: x[x.shape[0] + kmin * bn:], grid),
                            [(i, i + 1) for i in range(pg - 1)], "graph", self.mesh)
            parts = self._map(lambda g, p, r: [r] + p, parts, lo)
        if kmax > 0:
            hi = C.ppermute(self._map(lambda g, x: x[:kmax * bn], grid),
                            [(i, i - 1) for i in range(1, pg)], "graph", self.mesh)
            parts = self._map(lambda g, p, r: p + [r], parts, hi)
        return self._map(lambda g, p: torch.cat(p), parts)

    def _own(self, y, dn: BDDirection):
        """The shard's own rows of an output over its ext slab."""
        return y[dn.lead: dn.lead + self.rows_per_shard]

    def _bd_spmm_grid(self, x, dn: BDDirection, w=None):
        """``A @ x`` (or ``(A ⊙ w) @ x``) of one direction: K5 a shard over
        its ext pack (or a weighted one) and its rim stack."""
        cfg, e = self.config, self.edge_capacity
        x_ext = self._rim_ext(x, dn)
        if w is not None:
            # The transpose reads the forward-ordered weights after one
            # all-gather; the forward, its own edge slots.
            src = (self._w_all(w) if dn is self._bwd
                   else [w[g * e:(g + 1) * e] for g in range(self.lg)])
        out = []
        for g, sh in enumerate(dn.shards):
            pack = sh.pack
            if w is not None:
                pack = bd_scatter_weights(src[g][sh.w_src], sh.cov_pos, bp=pack.shape[0],
                                          bn=pack.shape[1], k=len(dn.offsets),
                                          dtype=cfg.compute_dtype)
            out.append([self._k5(xe, pack, dn) for xe in x_ext[g]])
        return out

    def _bd_sddmm(self, xa, xb) -> torch.Tensor:
        """K4 an edge of each shard: its own rows of ``xa`` against its rim
        stack of ``xb``, summed over ``feature``; ``[padded_edges]`` f32."""
        dn = self._fwd
        xb_ext = self._rim_ext(self._pad_d(xb), dn)
        return self._feature_sum(self._edge_scores(sddmm_tc_dense, [sh.edges for sh in dn.shards],
                                                   self._grid(self._pad_d(xa)), xb_ext))

    def _cell_scores(self, a_ext, b_ext):
        """One score a cell of each shard's ext pack: K4's partial dots on
        each feature slice, summed over ``feature`` in f32, rounded to the
        compute dtype and multiplied by the cell's count in it (the JAX
        order); per shard g, ``[cells_g]``."""
        dn, ct = self._fwd, self.config.compute_dtype
        part = self._map(lambda g, a, b: sddmm_tc_dense(a, dn.shards[g].cells, b), a_ext, b_ext)
        total = C.psum(part, "feature", self.mesh)
        return [dn.shards[g].cell_cnt.to(ct) * total[g][0].to(ct) for g in range(self.lg)]

    def _cell_pack(self, g, vals):
        """Shard g's weighted ext pack from its cells' values."""
        sh, ct = self._fwd.shards[g], self.config.compute_dtype
        flat = torch.zeros(sh.pack.numel(), dtype=ct, device=vals.device)
        flat[sh.cell_pos] = vals
        return flat.view(sh.pack.shape)

    def _k5(self, x_ext, pack, dn: BDDirection):
        """K5 over a shard's ext pack (counts or weights): its own rows."""
        return self._own(spmm_block_diag(x_ext, pack, offsets=dn.offsets, cfg=self.config), dn)

    def _bd_agnn_f(self, x):
        """``(A ⊙ x x^T) @ x`` a shard: K6 over the ext pack's row index at
        one feature shard; else K5 over ``C ⊙ S``."""
        dn, cfg = self._fwd, self.config
        x_ext = self._rim_ext(x, dn)
        if self.pf == 1:
            return self._map(lambda g, xe: self._own(bd_sfused(
                xe, xe, xe, dn.shards[g].pack, offsets=dn.offsets, cfg=cfg,
                index=dn.shards[g].index), dn), x_ext)
        s = self._cell_scores(x_ext, x_ext)
        out = []
        for g in range(self.lg):
            pack = self._cell_pack(g, s[g])
            out.append([self._k5(xe, pack, dn) for xe in x_ext[g]])
        return out

    def _bd_agnn_b(self, x, dy):
        """``(dx3, dc)`` a shard: K7 at one feature shard; else K5 over ``C ⊙
        S`` (against dy and x), ``C ⊙ T`` and ``C ⊙ U`` (``T_ij = <dy_i,
        x_j>``, ``U_ij = <x_i, dy_j>``: ``(C ⊙ T)^T = C ⊙ U`` on a symmetric
        pack, so the transpose term needs no spill-back)."""
        dn, cfg = self._fwd, self.config
        dgrid = self._grid(dy)
        x_ext, dy_ext = self._rim_ext(x, dn), self._rim_ext(dy, dn)
        if self.pf == 1:
            both = self._map(lambda g, xe, de: [self._own(t, dn) for t in bd_sfused_bwd(
                xe, de, dn.shards[g].pack, offsets=dn.offsets, cfg=cfg,
                index=dn.shards[g].index)], x_ext, dy_ext)
            dx = self._map(lambda g, p: p[0], both)
            u = self._map(lambda g, p: p[1], both)
        else:
            s = self._cell_scores(x_ext, x_ext)
            t = self._cell_scores(dy_ext, x_ext)
            ut = self._cell_scores(x_ext, dy_ext)
            dx, u = [], []
            for g in range(self.lg):
                cs = self._cell_pack(g, s[g])
                u.append([self._k5(xe, cs, dn) for xe in x_ext[g]])
                dx_g = [self._k5(de, cs, dn).float() for de in dy_ext[g]]
                del cs
                for vals in (t[g], ut[g]):
                    pack = self._cell_pack(g, vals)
                    dx_g = [a + self._k5(xe, pack, dn).float() for a, xe in zip(dx_g, x_ext[g])]
                dx.append(dx_g)
        dc = self._map(lambda g, dw, uu: torch.dot(dw.float().reshape(-1),
                                                   uu.float().reshape(-1)), dgrid, u)
        dc = self._dc_sum(dc)
        return self._assemble(dx), dc[0][0]

    # ---- the dense side over feature ranks -------------------------------------
    def _cols_grid(self, x: torch.Tensor):
        """``[local_nodes, d]`` -> one member a graph shard, ``[rps, d]``."""
        rps = self.rows_per_shard
        return [[x[g * rps:(g + 1) * rps]] for g in range(self.lg)]

    def _all_gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """This process's ``[local_nodes, d / pf]`` columns -> the whole
        ``[local_nodes, d]``, by one all-gather over ``feature``."""
        rps, dl, pf = self.rows_per_shard, x.shape[1], self.pf
        full = C.all_gather(self._cols_grid(x), "feature", self.mesh)
        return torch.cat([full[g][0].view(pf, rps, dl).transpose(0, 1).reshape(rps, pf * dl)
                          for g in range(self.lg)])

    def _reduce_scatter_cols(self, y: torch.Tensor) -> torch.Tensor:
        """Partial ``[local_nodes, d]`` sums, one a feature rank -> this
        process's columns of their sum, ``[local_nodes, d / pf]``, by one
        reduce-scatter over ``feature``."""
        rps, pf = self.rows_per_shard, self.pf
        dl = y.shape[1] // pf
        grid = [[m.reshape(rps, pf, dl).transpose(0, 1).reshape(pf * rps, dl)]
                for (m,) in self._cols_grid(y)]
        out = C.psum_scatter(grid, "feature", self.mesh)
        return torch.cat([out[g][0] for g in range(self.lg)])

    def _feature_dot(self, x: torch.Tensor, w: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
        """The column-parallel ``x @ w`` of a feature-sharded ``x``: ``x``
        all-gathered over ``feature`` (its backward a reduce-scatter of the
        partial ``dy @ w_f^T``) times this rank's columns of ``w``, in the
        compute dtype; ``w``'s gradient is nonzero in those columns only, and
        the training step's all-reduce sums it over the ranks."""
        _, cols = self.node_cols(w.shape[1] // self.pf)
        return torch.matmul(_DGatherCols.apply(x, self, True).to(ct), w[:, cols].to(ct))

    def _gather_features(self, x: torch.Tensor) -> torch.Tensor:
        """A feature-sharded ``x`` (the logits) all-gathered over
        ``feature``: every feature rank then computes the same values from
        it, so its backward keeps this rank's columns of the (equal)
        gradients and sums nothing."""
        return _DGatherCols.apply(x, self, False)

    def _count_once(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` (a parameter) as used in work every feature rank repeats
        whole (the attention weights over all-reduced edge scores): its
        gradient counts on feature rank 0 only, so the training step's
        all-reduce sums it once."""
        return _DCountOnce.apply(p, self.mesh.feature_rank == 0)

    # ---- the public ops (autograd) ------------------------------------------
    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable ``A @ x`` over ``[padded_nodes, d]``, in the compute
        dtype."""
        return _DSpMM.apply(x, self)

    def spmm_weighted(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``(A ⊙ w) @ x``, ``w`` in the padded edge layout."""
        return _DSpMMWeighted.apply(x, w, self)

    def sddmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable per-edge scores ``<x_i, x_j>``, ``[padded_edges]``
        f32."""
        return _DSDDMM.apply(x, self)

    def _agnn_aggregate(self, x: torch.Tensor, att_w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``mean(att_w) * (A ⊙ x x^T) @ x`` (symmetric graphs;
        ``agnn_aggregate`` is None otherwise), f32."""
        return _DAGNNAggregate.apply(x, att_w, self)


class _DSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph, ctx.x_dtype = graph, x.dtype
        return graph._spmm(x, graph._fwd)

    @staticmethod
    def backward(ctx, dy):
        return ctx.graph._spmm(dy, ctx.graph._bwd).to(ctx.x_dtype), None


class _DSpMMWeighted(torch.autograd.Function):
    """Backward: ``dx`` over the transpose with the forward-ordered weights,
    ``dw = <dy[row_e], x[col_e]>``."""

    @staticmethod
    def forward(ctx, x, w, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, w)
        return graph._spmm(x, graph._fwd, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = ctx.graph
        dx = g._spmm(dy, g._bwd, w).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = g._sddmm(dy, x).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class _DSDDMM(torch.autograd.Function):
    """Backward: the weighted SpMM forward and over the transpose."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        ctx.save_for_backward(x)
        return graph._sddmm(x, x)

    @staticmethod
    def backward(ctx, de):
        (x,) = ctx.saved_tensors
        g = ctx.graph
        return (g._spmm(x, g._fwd, de) + g._spmm(x, g._bwd, de)).to(x.dtype), None


class _DAGNNAggregate(torch.autograd.Function):
    """``mean(att_w) * (A ⊙ S) @ x``; backward ``dx = mean(att_w) * dx3`` and
    ``d att_w = dc / H`` for each of the H heads."""

    @staticmethod
    def forward(ctx, x, att_w, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, att_w)
        d = x.shape[1]
        out = graph._assemble(graph._agnn_f(graph._pad_d(x)))
        return out[:, :d] * att_w.mean().to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, att_w = ctx.saved_tensors
        g = ctx.graph
        d = x.shape[1]
        dx, dc = g._agnn_b(g._pad_d(x), g._pad_d(dy.contiguous()))
        dx = (att_w.mean().to(dx.dtype) * dx[:, :d]).to(x.dtype)
        datt = (dc / att_w.numel()).to(att_w.dtype).expand(att_w.shape).clone()
        return dx, datt, None


class _DGatherCols(torch.autograd.Function):
    """All-gather of a feature-sharded ``x`` over ``feature``.  Backward,
    ``reduce``: the gradients are partial sums (each rank's product took
    its own columns), reduce-scattered; else they are equal on every
    feature rank, and each keeps its own columns."""

    @staticmethod
    def forward(ctx, x, graph, reduce):
        ctx.graph, ctx.reduce = graph, reduce
        return graph._all_gather_cols(x)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.graph
        if ctx.reduce:
            return g._reduce_scatter_cols(dy.contiguous()), None, None
        _, cols = g.node_cols(dy.shape[1] // g.pf)
        return dy[:, cols].contiguous(), None, None


class _DCountOnce(torch.autograd.Function):
    """Identity; backward keeps the gradient where ``keep``, else zeros."""

    @staticmethod
    def forward(ctx, p, keep):
        ctx.keep = keep
        return p.view_as(p)

    @staticmethod
    def backward(ctx, dp):
        return (dp if ctx.keep else torch.zeros_like(dp)), None


def distributed_graph_from_dataset(ds, mesh=None, config: TileConfig = DEFAULT_CONFIG,
                                   balance=True, **kw) -> DistributedTiledGraph:
    """A ``DistributedTiledGraph`` of a ``GraphDataset``.

    ``balance`` (on unless False): the window-granular LPT shard balance
    (``sgt.reorder.shard_balance_permutation``) on a graph not headed for the
    block-diagonal route.  It permutes ``ds`` in place (graph, features,
    labels, masks), as ``reorder_dataset`` does.  The probe and the balance
    are stages of the graph's ``prep_stages``.
    """
    if mesh is None:
        mesh = make_mesh()
    pg = mesh.n_graph
    clock = StageClock()
    if balance and pg > 1 and kw.get("block_diag") is not True:
        bd_possible = kw.get("dense_tiles") is not False and kw.get("block_diag") is not False
        probe = None
        if bd_possible:
            with clock("bd_probe"):
                probe = probe_block_diag(ds.row_pointers, ds.column_index, ds.num_nodes, pg,
                                         config)
        if probe is not None and probe[0]:
            kw.setdefault("_probe", probe)  # unchanged CSR: the constructor reuses the gate
        else:
            from tcgnn_tpu_torch.sgt.reorder import balance_dataset

            with clock("balance"):
                balance_dataset(ds, pg, config)
            kw.setdefault("block_diag", False)
            if probe is not None:
                kw.setdefault("_symmetric", probe[3])  # invariant under relabelling
    return DistributedTiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, mesh, config,
                                 _clock=clock, **kw)
