"""DistributedTiledGraph: the SGT-tiled graph over a ``('graph',
'feature')`` shard grid (PyTorch port of the dense-tile route of
``tcgnn_tpu.parallel.graph``).

Every shard of the grid lives on the mesh's one device (``parallel/mesh.py``);
the shards run in turn, and the collectives between them are copies on that
device (``parallel/collectives.py``).  Inputs and outputs of the ops are
globally shaped tensors: node features ``[padded_nodes, D]`` (shard
``(g, f)`` is rows ``g * rows_per_shard ...`` and the f-th of ``pf`` equal
column slices), per-edge vectors ``[padded_edges]`` (shard g's edges, the
CSR slice of its rows, padded to ``edge_capacity``).

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
  second ``all_to_all`` (``xa_fetch``).  Per-edge outputs (the SDDMM) keep
  the unsplit stream;
* **the fused AGNN** (symmetric graphs) — ``pf == 1``: K2 forward and K3
  backward (with the window-side overrides on the split stream); ``pf >
  1``: a score needs every feature, so each feature shard forms partial
  score tiles (K4's tile mode), rounds them to the compute dtype, sums them
  in f32 over ``feature`` and rounds the sum; K10 multiplies them in.

The port differs from the JAX route on purpose, changing no value:

* the halo-overlap split (local and remote block classes, run against the
  resident slab while the exchange is in flight) is not run: it only hides
  collective latency behind XLA's async collectives.  Each op takes JAX's
  no-overlap branch, which JAX runs itself when a partition has no overlap
  classes: one pass over the shard's whole block stream against its halo
  slab.  The partition builds no classes (``parallel/partition.py``);
* every shard lives on one card, so no time this route gives is a
  multi-card figure.

Routes not ported yet raise ``NotImplementedError`` naming their ROADMAP
entry and never fall back to another route: the block-diagonal route (item
8a), the streamed route and the chunk fallback (item 8b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.ops.fused import spmm_fused
from tcgnn_tpu_torch.ops.sddmm import sddmm_tc_dense, sddmm_tc_tiles
from tcgnn_tpu_torch.ops.row_index import RowIndex
from tcgnn_tpu_torch.ops.sfused import sgt_row_index, spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense
from tcgnn_tpu_torch.parallel import collectives as C
from tcgnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from tcgnn_tpu_torch.parallel.partition import ShardedSGTMeta, partition_graph
from tcgnn_tpu_torch.sgt.translate import (
    TorchSGTMeta,
    count_blocks,
    is_symmetric,
    shard_meta,
    transpose_csr,
)

BD_ROUTE = ("the distributed block-diagonal route is not ported yet "
            "(ROADMAP.md, Queue 1 item 8a)")
STREAMED_ROUTE = ("the distributed streamed route is not ported yet "
                  "(ROADMAP.md, Queue 1 item 8b)")
CHUNK_ROUTE = ("the distributed chunk fallback (dense_tiles=False) is not ported yet "
               "(ROADMAP.md, Queue 1 item 8b)")
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
    (``sgt.stream``'s, per shard)?  The JAX probe; the block count is
    counted exactly where the bound does not settle it."""
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
        blocks = count_blocks(ptr[r0:r1 + 1] - ptr[r0], cols[ptr[r0]:ptr[r1]], rows_per_shard,
                              config)
        if blocks * config.blk_w > stream.MAX_SLAB_ROWS:
            return True
    return False


@dataclasses.dataclass
class _Stream:
    """One shard's block stream on the device: its metadata and tiles, and
    where K2/K3 run over it, the tiles' per-row index."""

    meta: TorchSGTMeta
    tiles: torch.Tensor  # [B, blk_h, blk_w] structural
    index: Optional[RowIndex] = None

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
    streams: list  # per shard g: the unsplit _Stream
    edge_fwd_slot: Optional[list]  # transpose: per g, [e_g] int64 forward slots
    split: Optional[_Split]


class DistributedTiledGraph:
    """SGT-tiled graph partitioned over a ``('graph', 'feature')`` mesh.

    ``dense_tiles``, ``block_diag`` and ``split`` as in JAX: ``None``
    decides by the JAX rules; a graph those rules send to a route not
    ported yet (block-diagonal, streamed, chunk) raises
    ``NotImplementedError``.
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
        _probe=None,
        _symmetric: Optional[bool] = None,
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
        self.config = config
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))
        self.block_diag = self.streamed = False

        # ---- route gates: every route but the dense-tile one raises ------
        if dense_tiles is False:
            raise NotImplementedError(CHUNK_ROUTE)
        t_csr = None
        if block_diag is not False:
            ok, _, _, self.symmetric, t_csr = (
                _probe if _probe is not None
                else probe_block_diag(row_pointers, column_index, self.num_nodes, self.pg, config)
            )
            if ok:
                raise NotImplementedError(BD_ROUTE)
            if block_diag:
                raise ValueError("block_diag requested but the graph is not fully covered "
                                 "by shard-compatible diagonals")
        elif _symmetric is not None:
            self.symmetric = _symmetric
        else:
            t_ptr, t_idx, _ = transpose_csr(row_pointers, column_index, self.num_nodes)
            self.symmetric = is_symmetric(row_pointers, column_index, t_ptr, t_idx)
        if _shards_need_streaming(row_pointers, column_index, self.num_nodes, self.pg, config):
            raise NotImplementedError(STREAMED_ROUTE)

        want_split = split is not False and self.pg > 1 and config.block_group == 1
        fwd, bwd = partition_graph(row_pointers, column_index, self.num_nodes, self.pg, config,
                                   split=want_split, transpose=t_csr)
        if dense_tiles is None:
            dense_tiles = (max(fwd.a_tiles.shape[1], bwd.a_tiles.shape[1])
                           * config.blk_h * config.blk_w < 2**31)
        if not dense_tiles:
            raise NotImplementedError(CHUNK_ROUTE)
        self.dense_tiles = True
        self.host_fwd, self.host_bwd = fwd, bwd
        self.rows_per_shard = fwd.rows_per_shard
        self.windows_per_shard = fwd.windows_per_shard
        self.padded_nodes = fwd.padded_nodes
        self.padded_edges = fwd.padded_edges
        self.edge_capacity = fwd.edge_capacity
        # The fused AGNN rides the forward split stream where there is one;
        # on a mesh of one feature shard it is K2/K3, over the stream's row
        # index.
        self._fwd = self._upload(fwd, with_fwd_slot=False,
                                 sfused=self.symmetric and self.pf == 1)
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
    def route(self) -> str:
        """The trainer's route line."""
        sp = lambda m: "split" if m.split is not None else "unsplit"  # noqa: E731
        agnn = ("none" if self.agnn_aggregate is None
                else ("K2/K3" if self.pf == 1 else "K4 tiles + K10")
                + (" on the split stream" if self.agnn_split else ""))
        return (f"dense_tiles=True streamed=False block_diag=False mesh={self.pg}x{self.pf} "
                f"stream fwd={sp(self.host_fwd)} bwd={sp(self.host_bwd)} "
                f"halo_rounds={len(self.host_fwd.halo['rounds'])} agnn={agnn}")

    def feature_width(self, d: int) -> int:
        """The width ``shard_features`` pads ``d`` input features to: a
        multiple of ``FEATURE_TILE * pf`` (JAX's ``d_tile``)."""
        return _round_up(max(d, 1), FEATURE_TILE * self.pf)

    def shard_features(self, x) -> torch.Tensor:
        """``[N, D]`` features padded to ``[padded_nodes,
        feature_width(D)]`` on the mesh's device."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device)
        n, d = x.shape
        return torch.nn.functional.pad(x, (0, self.feature_width(d) - d, 0, self.padded_nodes - n))

    def shard_nodes(self, v) -> torch.Tensor:
        """A per-node vector (labels, masks, norms) padded with zeros to
        ``padded_nodes`` rows."""
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(self.device)
        pad = torch.zeros((self.padded_nodes - v.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=self.device)
        return torch.cat([v, pad])

    def valid_node_mask(self) -> torch.Tensor:
        mask = torch.zeros(self.padded_nodes, dtype=torch.float32, device=self.device)
        mask[: self.num_nodes] = 1.0
        return mask

    def edge_weights_to_sharded(self, w_csr) -> torch.Tensor:
        """A ``[num_edges]`` CSR-ordered vector in the padded edge layout
        ``[padded_edges]``."""
        w = torch.as_tensor(np.asarray(w_csr) if not torch.is_tensor(w_csr) else w_csr)
        out = torch.zeros((self.pg, self.edge_capacity), dtype=w.dtype)
        es = self.host_fwd.edge_start
        for s in range(self.pg):
            lo, hi = int(es[s]), int(es[s + 1])
            out[s, : hi - lo] = w[lo:hi].cpu()
        return out.reshape(-1).to(self.device)

    def gather_edge_vector(self, v) -> np.ndarray:
        """``[padded_edges]`` -> host ``[num_edges]`` in CSR order."""
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        v = v.reshape(self.pg, self.edge_capacity)
        es = self.host_fwd.edge_start
        return np.concatenate([v[s, : int(es[s + 1] - es[s])] for s in range(self.pg)])

    # ---- device metadata ---------------------------------------------------
    def _upload(self, m: ShardedSGTMeta, with_fwd_slot: bool, sfused: bool = False) -> _Direction:
        """One direction's streams, halo tables and split on the device;
        ``sfused``: with the row index of the streams K2/K3 run over (the
        split streams where there are, else the plain ones)."""
        dev, cfg, pg = self.device, self.config, self.pg
        halo = m.halo
        num_src = m.rows_per_shard + halo["halo_rows"]
        counts = np.diff(m.edge_start)

        def ids(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        def tiles(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return t if t.dtype == torch.int8 else t.to(cfg.compute_dtype)

        a_dev = tiles(m.a_tiles)
        streams = [
            _Stream.make(shard_meta(cfg, m.a_tiles[g], m.block_window[g],
                                    m.block_first_in_window[g], halo["col_ids_ext"][g],
                                    m.edge_pos[g][: counts[g]], m.windows_per_shard, num_src,
                                    dev), a_dev[g], sfused and m.split is None)
            for g in range(pg)
        ]
        sp = None
        if m.split is not None:
            s = m.split
            gcap, qcap = int(s["guest_cap"]), int(s["pair_cap"])
            sentinel = s["a_tiles"].shape[1] * cfg.blk_h * cfg.blk_w
            es = (s["edge_pos"] < sentinel).sum(axis=1)
            sa_dev = tiles(s["a_tiles"])
            rows = m.rows_per_shard
            stack = pg * qcap * cfg.blk_h
            sp = _Split(
                guest_cap=gcap, pair_cap=qcap,
                streams=[
                    _Stream.make(shard_meta(cfg, s["a_tiles"][g], s["block_window"][g],
                                            s["block_first"][g], s["col_ids_ext"][g],
                                            s["edge_pos"][g][: es[g]],
                                            m.windows_per_shard + gcap, num_src, dev),
                                 sa_dev[g], sfused)
                    for g in range(pg)
                ],
                w_src=[ids(s["w_src"][g][: es[g]]) for g in range(pg)],
                guest_slot=[ids(np.flatnonzero(s["send_pos"][g] < pg * qcap)) for g in range(pg)],
                guest_dest=[ids(s["send_pos"][g][s["send_pos"][g] < pg * qcap])
                            for g in range(pg)],
                recv_src=[ids(np.flatnonzero(s["recv_row_idx"][g] < rows)) for g in range(pg)],
                recv_dst=[ids(s["recv_row_idx"][g][s["recv_row_idx"][g] < rows])
                          for g in range(pg)],
                fetch_rows=[ids(np.minimum(s["recv_row_idx"][g], rows - 1)) for g in range(pg)],
                fetch_valid=[torch.from_numpy(s["recv_row_idx"][g] < rows).to(dev)
                             for g in range(pg)],
                xa_fetch=[ids(np.minimum(s["xa_fetch"][g], stack - 1)) for g in range(pg)],
                xa_valid=[torch.from_numpy(s["xa_fetch"][g] < stack).to(dev) for g in range(pg)],
            )
        return _Direction(
            host=m,
            rounds=tuple(halo["rounds"]),
            send_idx=[ids(halo["send_idx"][g]) for g in range(pg)],
            streams=streams,
            edge_fwd_slot=([ids(m.edge_fwd_slot[g][: counts[g]]) for g in range(pg)]
                           if with_fwd_slot else None),
            split=sp,
        )

    # ---- shard grids --------------------------------------------------------
    def _pad_d(self, x: torch.Tensor) -> torch.Tensor:
        """Pad the feature dim to a multiple of ``8 * pf``: every feature
        shard gets an equal slice."""
        d = x.shape[1]
        d_pad = _round_up(max(d, 1), 8 * self.pf)
        return torch.nn.functional.pad(x, (0, d_pad - d)) if d_pad != d else x

    def _grid(self, x: torch.Tensor):
        """``[padded_nodes, D]`` -> shard views ``grid[g][f]``."""
        if x.shape[0] != self.padded_nodes:
            raise ValueError(f"node features of {x.shape[0]} rows, expected {self.padded_nodes}")
        rps, dl = self.rows_per_shard, x.shape[1] // self.pf
        return [[x[g * rps:(g + 1) * rps, f * dl:(f + 1) * dl] for f in range(self.pf)]
                for g in range(self.pg)]

    def _edge_grid(self, w: torch.Tensor):
        """``[padded_edges]`` -> shard g's slice, the same for every f."""
        e = self.edge_capacity
        return [[w[g * e:(g + 1) * e]] * self.pf for g in range(self.pg)]

    @staticmethod
    def _assemble(grid) -> torch.Tensor:
        return torch.cat([torch.cat(row, dim=1) if len(row) > 1 else row[0] for row in grid])

    def _map(self, fn, *grids):
        """``fn(g, *shard_tensors)`` on every shard."""
        return [[fn(g, *(gr[g][f] for gr in grids)) for f in range(self.pf)]
                for g in range(self.pg)]

    # ---- collective steps ---------------------------------------------------
    def _halo(self, grid, dn: _Direction):
        """Each shard's extended slab ``[rows_per_shard + halo_rows, d]``: its
        rows, then one segment per round of the partial-pair ``ppermute``
        plan (receivers no pair lists get zeros)."""
        if self.pg == 1:
            return grid
        segs = self._map(lambda g, x: [x], grid)
        for pos, size, pairs in dn.rounds:
            send = self._map(lambda g, x: x.index_select(0, dn.send_idx[g][pos:pos + size]), grid)
            recv = C.ppermute(send, pairs, "graph")
            for g in range(self.pg):
                for f in range(self.pf):
                    segs[g][f].append(recv[g][f])
        return self._map(lambda g, s: torch.cat(s), segs)

    def _w_all(self, w: torch.Tensor):
        """The all-gathered forward edge vector plus an appended zero (the
        sentinel slot), per shard."""
        full = C.all_gather(self._edge_grid(w), "graph")
        return [torch.cat([full[g][0], full[g][0].new_zeros(1)]) for g in range(self.pg)]

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

        recv = C.all_to_all(self._map(pack, out), "graph")

        def add(g, y, r):
            own = y[:rows].clone()
            own.index_add_(0, sp.recv_dst[g], r.reshape(-1, y.shape[1])[sp.recv_src[g]])
            return own

        return self._map(add, out, recv)

    def _guest_rows(self, grid, sp: _Split):
        """The owners' window rows of each shard's guest slots
        ``[guest_cap * blk_h, d]``, by one all_to_all (zeros for unused
        slots)."""
        def send(g, x):
            rows = x.index_select(0, sp.fetch_rows[g])
            return torch.where(sp.fetch_valid[g][:, None], rows, 0)

        recv = C.all_to_all(self._map(send, grid), "graph")

        def pick(g, r):
            rows = r.index_select(0, sp.xa_fetch[g])
            return torch.where(sp.xa_valid[g][:, None], rows, 0)

        return self._map(pick, recv)

    # ---- the SpMMs and the SDDMM --------------------------------------------
    def _spmm_grid(self, grid, dn: _Direction, w: Optional[torch.Tensor] = None):
        """``A @ x`` (or ``(A ⊙ w) @ x``) of one direction on a shard grid:
        the split stream where the partition built one, else the shard's
        whole block stream against its halo slab."""
        x_ext = self._halo(grid, dn)
        if dn.split is not None:
            sp = dn.split
            streams = sp.streams
            if w is not None:
                w_all = self._w_all(w)
                vals = [w_all[g][sp.w_src[g]].float() for g in range(self.pg)]
        else:
            streams = dn.streams
            if w is not None:
                if dn.edge_fwd_slot is not None:  # forward-ordered weights
                    w_all = self._w_all(w)
                    vals = [w_all[g][dn.edge_fwd_slot[g]].float() for g in range(self.pg)]
                else:
                    e = self.edge_capacity
                    vals = [w[g * e: g * e + streams[g].meta.num_edges].float()
                            for g in range(self.pg)]
        tiles = [s.tiles if w is None else build_a_tiles(s.meta, vals[g])
                 for g, s in enumerate(streams)]
        out = self._map(lambda g, x: spmm_tc_dense(x, streams[g].meta, tiles[g]), x_ext)
        return self._guest_return(out, dn.split) if dn.split is not None else out

    def _spmm(self, x, dn: _Direction, w=None) -> torch.Tensor:
        d = x.shape[1]
        return self._assemble(self._spmm_grid(self._grid(self._pad_d(x)), dn, w))[:, :d]

    def _sddmm(self, xa, xb) -> torch.Tensor:
        """Per-edge ``<xa[row_e], xb[col_e]>`` over the unsplit forward
        stream, summed over the feature shards: ``[padded_edges]`` f32."""
        dn = self._fwd
        xb_ext = self._halo(self._grid(self._pad_d(xb)), dn)

        def scores(g, a, b):
            s = torch.zeros(self.edge_capacity, dtype=torch.float32, device=a.device)
            m = dn.streams[g].meta
            s[: m.num_edges] = sddmm_tc_dense(a, m, b)
            return s

        s = self._map(scores, self._grid(self._pad_d(xa)), xb_ext)
        if self.pf > 1:
            s = C.psum(s, "feature")
        return torch.cat([s[g][0] for g in range(self.pg)])

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
        s = C.psum(self._map(lambda g, t: t.float(), s), "feature")
        return self._map(lambda g, t: t.to(ct), s)

    def _fused(self, x_ext, s, streams):
        return self._map(lambda g, x, t: spmm_fused(x, streams[g].meta, streams[g].tiles, t),
                         x_ext, s)

    def _agnn_streams(self):
        dn = self._fwd
        return (dn.split.streams if self.agnn_split else dn.streams), dn

    def _agnn_f(self, x):
        """``(A ⊙ x x^T) @ x`` on the shard grid, f32."""
        grid = self._grid(x)
        streams, dn = self._agnn_streams()
        x_ext = self._halo(grid, dn)
        if self.agnn_split:
            g_rows = self._guest_rows(grid, dn.split)
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
        grid, dgrid = self._grid(x), self._grid(dy)
        streams, dn = self._agnn_streams()
        x_ext, dy_ext = self._halo(grid, dn), self._halo(dgrid, dn)
        if self.agnn_split:
            x_guest = self._guest_rows(grid, dn.split)
            dy_guest = self._guest_rows(dgrid, dn.split)
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
        dc = C.psum(dc, "graph")
        if self.pf > 1:
            dc = C.psum(dc, "feature")
        return self._assemble(dx), dc[0][0]

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


def distributed_graph_from_dataset(ds, mesh=None, config: TileConfig = DEFAULT_CONFIG,
                                   balance=True, **kw) -> DistributedTiledGraph:
    """A ``DistributedTiledGraph`` of a ``GraphDataset``.

    ``balance`` (on unless False): the window-granular LPT shard balance
    (``sgt.reorder.shard_balance_permutation``) on a graph not headed for the
    block-diagonal route.  It permutes ``ds`` in place (graph, features,
    labels, masks), as ``reorder_dataset`` does.
    """
    if mesh is None:
        mesh = make_mesh()
    pg = mesh.n_graph
    if balance and pg > 1 and kw.get("block_diag") is not True:
        bd_possible = kw.get("dense_tiles") is not False and kw.get("block_diag") is not False
        probe = (probe_block_diag(ds.row_pointers, ds.column_index, ds.num_nodes, pg, config)
                 if bd_possible else None)
        if probe is not None and probe[0]:
            kw.setdefault("_probe", probe)  # unchanged CSR: the constructor reuses the gate
        else:
            from tcgnn_tpu_torch.sgt.reorder import balance_dataset

            balance_dataset(ds, pg, config)
            kw.setdefault("block_diag", False)
            if probe is not None:
                kw.setdefault("_symmetric", probe[3])  # invariant under relabelling
    return DistributedTiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, mesh, config,
                                 **kw)
