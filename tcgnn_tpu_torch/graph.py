"""TiledGraph: an SGT-tiled graph with differentiable graph ops (PyTorch port).

Counterpart of ``tcgnn_tpu.graph.TiledGraph``, with its four routes: the
condensed dense-tile route, the block-diagonal (BD) route, and, for graphs
over the dense-tile budget, the chunk route and the streamed route.  It picks
the route by the JAX package's rules, so both packages send every graph the
same way; builds the tiles or chunks on the host and uploads what the route
reads once; and exposes its ops as ``torch.autograd.Function``s with exact
backwards, on directed graphs too:

* ``spmm(x)`` — ``A @ x``.  Condensed: K1 forward, K1 over the transpose
  tiles backward.  BD: K5 over the pack (the transpose pack backward) plus
  K1 over the residual's condensed tiles;
* ``spmm_weighted(x, w)`` — ``(A ⊙ w) @ x`` with per-edge weights.
  Condensed: K1 over weighted tiles (``build_a_tiles``).  BD: K5 over a
  weighted pack (``bd_scatter_weights``) plus K1 over the residual's
  weighted tiles.  Backward ``dx`` the same over the transpose, ``dw`` by
  K4 (``sddmm(dy, x)``);
* ``sddmm(x)`` — per-edge ``<x_i, x_j>``: K4 (over every edge's row and
  column on the BD route); backward by the two weighted SpMMs;
* ``agnn_aggregate(x, att_w)`` — ``mean(att_w) * (A ⊙ x x^T) @ x``, AGNN's
  head-averaged aggregation on symmetric graphs (``None`` otherwise, as in
  the JAX package).  Condensed: K2 forward, K3 backward.  BD: K6 forward
  and K7 backward over the pack's per-row index (``BDPack.row_index``,
  derived on the device at upload), plus K2/K3 over the residual.

What the port does differently from the JAX BD route, changing no value:

* the residual's SpMM is always K1.  JAX sometimes takes an XLA block-output
  product there (``spmm_tc_blockout``) to dodge Pallas per-grid-step
  latency, and pads the residual to 8 blocks for it: TPU workarounds;
* the BD SDDMM is K4 over every edge's (row, col), covered and residual
  alike, in place of ``bd_sddmm_edges`` (whose 10 MB bin-chunk slabs are a
  TPU gather-locality workaround) and the residual dots with their scatter.
  Every score is still an f32 dot of compute-dtype rows;
* K5 takes any offset set (JAX's einsum fallback for offsets past its
  3-panel halo is a Pallas limit).  The AGNN gate (``bd_ok``) and the
  int32-addressable pack rule stay as they are, so the routes agree; index
  arithmetic is 64-bit regardless.

The chunk route (``dense_tiles`` False; the JAX rule: the int8 tiles of
both directions, plus AGNN's weighted tiles on an asymmetric graph, over
``DENSE_TILE_BUDGET_BYTES``, or an index space past int32) lays each TC
block's edges out in uniform chunks of ``edge_chunk`` slots; past the TPU's
one-shot limits (``sgt/stream.py``: reddit) the chunks are cut into window
segments, the streamed route (``streamed``).  Every op is K8 (``spmm``,
``spmm_weighted``, forward and over the transpose's chunks backward, with
``w[t_edge_src]``) or K9 (``sddmm``, and ``dw``); ``agnn_aggregate`` is
``None``, so AGNN takes the per-edge ops, as in JAX.  The ops return f32
whatever the compute dtype, as the JAX chunk kernels store it.  Only the
chunk or segment metadata is uploaded, with the CSR row index derived from
it on the device (``TorchChunkMeta.row_ptr``, ``row_src``): no tiles, no
per-edge arrays but ``t_edge_src``; the host layout is dropped once uploaded
(``host_meta`` is None), keeping ``tc_blocks`` and ``exp_edges``.  Where the
port differs from the JAX chunk routes, changing no value:

* the kernels walk the row index, the edges in CSR order, not the chunk
  slots (on reddit a chunk keeps a row's edges together for 2.44 slots on
  average); the chunk arrays stay on the device for the plain versions;
* the kernels gather rows of x themselves: no condensed slab ``x[col_ids]``
  (the TPU's DMA layout) is formed;
* every segment is served by one launch, not a scan of S launches;
* K9 writes the scores in CSR order: no scores in chunk order, no
  ``edge_perm`` gather (``edge_perm`` stays on the host).

``block_group`` 0 (auto) resolves to 1 here; the JAX CLI's auto resolves to
2 on block-dense graphs (reddit) when its native pass is present.  That
changes only padding blocks, hence padding chunks: TC_Blocks and every op
value stay the same.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.ops.blockdiag import (
    BD_BIN_GROUP,
    bd_row_index,
    bd_scatter_weights,
    bd_sfused,
    bd_sfused_bwd,
    build_bd_pack,
    padded_bins,
    spmm_block_diag,
)
from tcgnn_tpu_torch.ops.chunk import sddmm_tc, spmm_tc
from tcgnn_tpu_torch.ops.row_index import RowIndex
from tcgnn_tpu_torch.ops.sddmm import EdgeList, sddmm_tc_dense
from tcgnn_tpu_torch.ops.sfused import sgt_row_index, spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense
from tcgnn_tpu_torch.sgt.blockdiag import BDMeta, extract_block_diag
from tcgnn_tpu_torch.sgt.stream import needs_streaming, segment_chunks
from tcgnn_tpu_torch.sgt.translate import (
    TorchSGTMeta,
    build_a_tiles_host,
    count_blocks,
    is_symmetric,
    sparse_graph_translate,
    transpose_csr,
)

# Dense-tile bytes (int8 structural tiles, forward + transpose) above which
# the graph takes the chunk route.  Kept at the JAX value so both packages
# route the same graphs; re-deriving it for 80 GB is queued.
DENSE_TILE_BUDGET_BYTES = 8 << 30


class _SpMM(torch.autograd.Function):
    """``A @ x`` forward, ``A^T @ dy`` backward."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        ctx.x_dtype = x.dtype
        return graph._spmm_f(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.graph._spmm_b(dy.contiguous()).to(ctx.x_dtype), None


class _SpMMWeighted(torch.autograd.Function):
    """``(A ⊙ w) @ x`` (TC-GNN's ``forward_AGNN``).

    Backward: ``dx[j] = sum_{e=(i,j)} w_e dy[i]``, the weighted SpMM over
    the transpose with ``w[t_edge_src]``; ``dw_e = <dy[row_e], x[col_e]>``,
    K4."""

    @staticmethod
    def forward(ctx, x, w, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, w)
        return graph._spmm_w(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = ctx.graph
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = g._spmm_w_t(dy, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = g._sddmm(dy, x).to(w.dtype)
        return dx, dw, None


class _SDDMM(torch.autograd.Function):
    """Per-edge scores ``e = <x[row_e], x[col_e]>`` (K4).

    Backward: ``dx[i] += sum_{e row=i} de_e x[col_e]`` and
    ``dx[j] += sum_{e col=j} de_e x[row_e]``: the two weighted SpMMs."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        ctx.save_for_backward(x)
        return graph._sddmm(x, x)

    @staticmethod
    def backward(ctx, de):
        (x,) = ctx.saved_tensors
        g = ctx.graph
        d_rows = g._spmm_w(x, de)
        d_cols = g._spmm_w_t(x, de)
        return (d_rows + d_cols).to(x.dtype), None


class _AGNNAggregate(torch.autograd.Function):
    """AGNN's head-averaged aggregation on a symmetric graph:
    ``mean(att_w) * (A ⊙ S) @ x`` with ``S = x x^T`` (K2, or K6 on BD).

    Every head's attention is a scalar gate on the same edge score
    (``att_e^h = c_h e_e``), so the mean of the H weighted aggregations is
    one score-fused pass.  Backward (K3, or K7 on BD, one pass):
    ``dx = mean(c) * dx3`` and ``d c_h = <dy, u> / H`` with ``(dx3, u)`` as
    in ``ops.sfused.spmm_sfused_bwd``; ``A`` symmetric turns the
    column-space term into a row-space one."""

    @staticmethod
    def forward(ctx, x, att_w, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, att_w)
        out = graph._agnn_f(x)
        # The gate in the aggregate's own dtype, as in JAX.
        return out * att_w.mean().to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, att_w = ctx.saved_tensors
        dx3, u = ctx.graph._agnn_b(x, dy.contiguous())
        dx = (att_w.mean().to(dx3.dtype) * dx3).to(x.dtype)
        d_cbar = torch.dot(dy.float().reshape(-1), u.float().reshape(-1))
        datt = (d_cbar / att_w.numel()).to(att_w.dtype).expand(att_w.shape).clone()
        return dx, datt, None


@dataclasses.dataclass
class BDPack:
    """One direction of the BD route on the device: the pack, the
    residual's condensed tiles, and the covered and residual edges'
    addresses for the weighted ops (CSR order of that direction)."""

    offsets: tuple
    pack: torch.Tensor                   # [Bp, bn, K*bn] int8 / int16 counts
    res_meta: Optional[TorchSGTMeta]     # residual tiling, None when fully covered
    res_a: Optional[torch.Tensor]        # its structural tiles
    cov_pack: Optional[torch.Tensor]     # [E_cov] int64 pack positions; None unless addressable
    cov_ids: torch.Tensor                # [E_cov] int64 covered edges
    res_ids: Optional[torch.Tensor]      # [E_res] int64 residual edges
    row_index: Optional[RowIndex] = None  # the pack's per-row index (K6/K7)
    res_index: Optional[RowIndex] = None  # the residual tiles' per-row index (K2/K3)


def _pack_elems(m: BDMeta) -> int:
    return padded_bins(m.num_bins) * m.bin_rows * len(m.offsets) * m.bin_rows


def _bd_addressable(m: BDMeta) -> bool:
    """The JAX package's rule: per-edge BD ops only on packs whose flat
    index space fits int32 (its indices are int32).  Kept so both packages
    route the same ops; the port's indices are int64."""
    return _pack_elems(m) + 1 < 2**31


class TiledGraph:
    """Device-resident SGT-tiled graph.  Build once per graph (the
    ``Prep. (ms)`` stage); reuse across layers and epochs.

    ``dense_tiles``: ``None`` decides by the budget, as the JAX package
    does; ``False`` takes the chunk route; ``True`` keeps the dense tiles
    (raises if their index space overflows int32).  ``streamed``: ``None``
    streams a chunk-route graph past the TPU's one-shot limits; ``True``
    forces it (raises with dense tiles).  ``block_diag`` (dense tiles only):
    ``None`` takes the BD route where the JAX package takes it; ``False``
    keeps the condensed route; ``True`` raises below the BD coverage gate."""

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: Optional[int] = None,
        config: TileConfig = DEFAULT_CONFIG,
        symmetric: bool = False,
        device: torch.device | str = "cuda",
        weighted_traffic: bool = False,
        block_diag: Optional[bool] = None,
        dense_tiles: Optional[bool] = None,
        streamed: Optional[bool] = None,
    ):
        row_pointers = np.asarray(row_pointers)
        column_index = np.asarray(column_index)
        if num_nodes is None:
            num_nodes = len(row_pointers) - 1
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))
        self.device = torch.device(device)
        if config.block_group == 0:
            # The kernel walks a window's blocks itself: no grouping needed.
            config = dataclasses.replace(config, block_group=1)
        self.config = config

        # ---- host passes (transpose, symmetry, routing, BD extraction, SGT,
        # tile builds): everything before the uploads, timed as prep_host_s.
        t0 = time.perf_counter()
        t_ptr, t_idx, t_src = transpose_csr(row_pointers, column_index, num_nodes)
        symmetric = symmetric or is_symmetric(row_pointers, column_index, t_ptr, t_idx)
        self.symmetric = symmetric

        def extract_bd():
            """Both directions' BD decompositions, or None below the gate."""
            bdm = extract_block_diag(row_pointers, column_index, num_nodes)
            if bdm is None:
                return None
            bdm_t = bdm if symmetric else extract_block_diag(t_ptr, t_idx, num_nodes)
            return None if bdm_t is None else (bdm, bdm_t)

        tile_elems = config.blk_h * config.blk_w
        nb_f = count_blocks(row_pointers, column_index, num_nodes, config)
        nb_t = nb_f if symmetric else count_blocks(t_ptr, t_idx, num_nodes, config)
        fits_int32 = max(nb_f, nb_t) * tile_elems < 2**31
        dense_bytes = (nb_f if symmetric else nb_f + nb_t) * tile_elems
        bd_pair, bd_probed = None, False
        if weighted_traffic and not symmetric:
            # Attention on an asymmetric graph builds weighted tiles per
            # call, several alive at once across forward and backward:
            # budget 4 such arrays at the compute dtype's width.  A BD graph
            # builds transient weighted packs instead (3 at the widest
            # offset count), so probe the BD decomposition before sending a
            # banded graph past the budget.  Symmetric graphs take the
            # score-fused kernels, which build none.
            itemsize = config.compute_dtype.itemsize
            weighted_extra = 4 * nb_f * tile_elems * itemsize
            if (dense_tiles is not False and block_diag is not False and fits_int32
                    and dense_bytes <= DENSE_TILE_BUDGET_BYTES
                    < dense_bytes + weighted_extra):
                bd_pair, bd_probed = extract_bd(), True
                if bd_pair is not None:
                    bdm, bdm_t = bd_pair
                    kmax = max(len(bdm.offsets), len(bdm_t.offsets))
                    weighted_extra = 3 * kmax * bdm.num_bins * bdm.bin_rows**2 * itemsize
            dense_bytes += weighted_extra
        if dense_tiles is None:
            dense_tiles = fits_int32 and dense_bytes <= DENSE_TILE_BUDGET_BYTES
        elif dense_tiles and not fits_int32:
            raise ValueError("dense-tile index space overflows int32 for this graph")
        if streamed and dense_tiles:
            raise ValueError("streamed chunk path requires dense_tiles=False")
        self.dense_tiles = dense_tiles

        if not dense_tiles:
            self._init_chunk_route(row_pointers, column_index, t_ptr, t_idx, t_src, streamed, t0)
            return

        self.streamed = False
        if block_diag is not False and not bd_probed:
            bd_pair = extract_bd()
        if block_diag and bd_pair is None:
            raise ValueError(
                "block_diag requested but coverage is below the gate for this graph/ordering"
            )
        self.block_diag = bd_pair is not None
        self.bd_offsets = self.bd_offsets_t = None
        self.bd_full_coverage = self.bd_addressable = False
        if self.block_diag:
            bdm, bdm_t = bd_pair
            self.bd_offsets, self.bd_offsets_t = bdm.offsets, bdm_t.offsets
            self.bd_full_coverage = bdm.coverage == 1.0 and bdm_t.coverage == 1.0
            self.bd_addressable = _bd_addressable(bdm) and _bd_addressable(bdm_t)
        # A fully covered, addressable BD graph reads no condensed tiles; the
        # SGT pass still runs, for the TC_Blocks statistic.
        needs_condensed = not (
            self.block_diag and self.bd_full_coverage and self.bd_addressable
        )
        self.host_meta = sparse_graph_translate(
            row_pointers, column_index, num_nodes, config, build_tiles=needs_condensed
        )
        self.host_meta_t = (
            self.host_meta
            if symmetric
            else sparse_graph_translate(t_ptr, t_idx, num_nodes, config,
                                        build_tiles=needs_condensed)
        )
        self.tc_blocks, self.exp_edges = self.host_meta.num_real_blocks, self.host_meta.exp_edges
        def residual_sgt(m):
            """The SGT tiling of a BD decomposition's residual, if any."""
            if m.res_ptr is None:
                return None
            return sparse_graph_translate(m.res_ptr, m.res_idx, self.num_nodes, config,
                                          build_tiles=True)

        if self.block_diag:
            res_host = residual_sgt(bdm)
            res_host_t = res_host if symmetric else residual_sgt(bdm_t)
        # K4 reads each edge's row and column: from the condensed meta where
        # it is uploaded, else from an edge list.
        edge_rows = None if needs_condensed else np.repeat(
            np.arange(self.num_nodes, dtype=np.int32), np.diff(row_pointers))
        self.prep_host_s = time.perf_counter() - t0

        # ---- uploads --------------------------------------------------------
        self.meta = self.meta_t = self.a_struct = self.a_struct_t = None
        if needs_condensed:
            self.meta = self.host_meta.to(self.device)
            self.a_struct = self._upload_tiles(self.host_meta)
            if symmetric:
                self.meta_t, self.a_struct_t = self.meta, self.a_struct
            else:
                self.meta_t = self.host_meta_t.to(self.device)
                self.a_struct_t = self._upload_tiles(self.host_meta_t)
        # Transpose edge k is forward edge t_edge_src[k]: per-edge weights in
        # CSR order, taken to the transpose's order.
        self.t_edge_src = torch.from_numpy(t_src.astype(np.int64)).to(self.device)

        # Score-fused AGNN on symmetric graphs.  BD takes K6/K7 where the
        # JAX kernel's 3-panel halo covers the offsets and the residual is
        # symmetric (a sign-symmetric offset set, A being symmetric); a
        # fully covered BD graph outside that gate has no condensed tiles
        # and takes the per-edge route, as in JAX.  K6/K7 read only the
        # forward direction (A is symmetric), through its row index.
        self._agnn_bd = self.block_diag and symmetric and (
            max(abs(o) for o in self.bd_offsets) <= BD_BIN_GROUP
            and (self.bd_full_coverage or set(self.bd_offsets) == {-o for o in self.bd_offsets})
        )
        self.bd = self.bd_t = None
        if self.block_diag:
            self.bd = self._bd_dev(bdm, res_host, row_index=self._agnn_bd)
            self.bd_t = self.bd if symmetric else self._bd_dev(bdm_t, res_host_t)
        self._sddmm_meta = self.meta if needs_condensed else EdgeList.from_rows(
            edge_rows, column_index, self.num_nodes, config, self.device)
        fused = symmetric and (self._agnn_bd or self.meta is not None)
        self.agnn_aggregate = self._agnn_aggregate if fused else None
        # K2/K3 walk the tiles' per-row index, built here where they run.
        self.sfused_index = (sgt_row_index(self.meta, self.a_struct)
                             if fused and not self._agnn_bd else None)

    def _init_chunk_route(self, row_pointers, column_index, t_ptr, t_idx, t_src, streamed, t0):
        """The chunk route: the chunk layouts of both directions (or their
        window segments), uploaded; no tiles.  ``t0`` starts the host-pass
        clock (``prep_host_s``)."""
        cfg, n = self.config, self.num_nodes
        self.block_diag = False
        self.bd = self.bd_t = self.bd_offsets = self.bd_offsets_t = None
        self.bd_full_coverage = self.bd_addressable = self._agnn_bd = False
        self.meta = self.meta_t = self.a_struct = self.a_struct_t = None
        self.agnn_aggregate = self.sfused_index = None
        host = sparse_graph_translate(row_pointers, column_index, n, cfg, emit_chunks=True)
        host_t = host if self.symmetric else sparse_graph_translate(
            t_ptr, t_idx, n, cfg, emit_chunks=True)
        self.tc_blocks, self.exp_edges = host.num_real_blocks, host.exp_edges
        if streamed is None:
            streamed = needs_streaming(host) or needs_streaming(host_t)
        self.streamed = streamed
        if streamed:
            host = segment_chunks(host)
            host_t = host if self.symmetric else segment_chunks(host_t)
        self.prep_host_s = time.perf_counter() - t0

        # The host arrays (several GB on reddit) go once uploaded.
        def upload(h):
            return h.to(self.device) if streamed else h.to_chunks(self.device)

        self.chunks = upload(host)
        self.chunks_t = self.chunks if self.symmetric else upload(host_t)
        self.host_meta = self.host_meta_t = None
        self.t_edge_src = torch.from_numpy(t_src.astype(np.int64)).to(self.device)

    def _upload_tiles(self, host_meta) -> torch.Tensor:
        """int8 structural tiles; the compute dtype when a duplicate count
        exceeds 127."""
        tiles = torch.from_numpy(build_a_tiles_host(host_meta))
        if tiles.dtype != torch.int8:
            tiles = tiles.to(self.config.compute_dtype)
        return tiles.to(self.device)

    def _bd_dev(self, m: BDMeta, res_host, row_index: bool = False) -> BDPack:
        """One direction's BD arrays on the device; with ``row_index``, the
        pack's per-row index (K6/K7) and the residual tiles' (K2/K3) too."""
        dev = self.device

        def ids(a):
            return None if a is None else torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        pack = build_bd_pack(ids(m.tile_idx), torch.from_numpy(m.tile_cnt).to(dev),
                             k=len(m.offsets), nbins=m.num_bins, bn=m.bin_rows)
        res_meta = None if res_host is None else res_host.to(dev)
        res_a = None if res_host is None else self._upload_tiles(res_host)
        return BDPack(
            offsets=m.offsets,
            pack=pack,
            res_meta=res_meta,
            res_a=res_a,
            cov_pack=ids(m.packed_cov_idx()) if _bd_addressable(m) else None,
            cov_ids=ids(m.cov_edge_ids),
            res_ids=ids(m.res_edge_ids),
            row_index=bd_row_index(pack, m.offsets, self.num_nodes) if row_index else None,
            res_index=(sgt_row_index(res_meta, res_a)
                       if row_index and res_host is not None else None),
        )

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable ``A @ x``, in the compute dtype (f32 on the chunk
        route)."""
        return _SpMM.apply(x, self)

    def spmm_weighted(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``(A ⊙ w) @ x`` for per-edge weights ``w`` [E] (CSR
        order), in the compute dtype (f32 on the chunk route)."""
        return _SpMMWeighted.apply(x, w, self)

    def sddmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable per-edge scores ``<x_i, x_j>``, [E] f32."""
        return _SDDMM.apply(x, self)

    def _agnn_aggregate(self, x: torch.Tensor, att_w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``mean(att_w) * (A ⊙ x x^T) @ x`` (symmetric graphs
        only; ``agnn_aggregate`` is ``None`` otherwise): f32 on the condensed
        route, the compute dtype on a fully covered BD graph."""
        return _AGNNAggregate.apply(x, att_w, self)

    # ---- the ops without autograd ------------------------------------------

    def _bd_spmm(self, x, bd: BDPack, pack: torch.Tensor, res_tiles):
        out = spmm_block_diag(x, pack, offsets=bd.offsets, cfg=self.config)
        if bd.res_meta is not None:
            out = out + spmm_tc_dense(x, bd.res_meta, res_tiles)
        return out

    def _spmm_f(self, x):
        """``A @ x``."""
        if not self.dense_tiles:
            return spmm_tc(x, self.chunks)
        if self.block_diag:
            return self._bd_spmm(x, self.bd, self.bd.pack, self.bd.res_a)
        return spmm_tc_dense(x, self.meta, self.a_struct)

    def _spmm_b(self, dy):
        """``A^T @ dy``."""
        if not self.dense_tiles:
            return spmm_tc(dy, self.chunks_t)
        if self.block_diag:
            return self._bd_spmm(dy, self.bd_t, self.bd_t.pack, self.bd_t.res_a)
        return spmm_tc_dense(dy, self.meta_t, self.a_struct_t)

    def _bd_weighted(self, x, w, bd: BDPack):
        """``(A ⊙ w) @ x`` on the BD route, ``w`` in ``bd``'s CSR order."""
        p = bd.pack
        wp = bd_scatter_weights(w[bd.cov_ids], bd.cov_pack, bp=p.shape[0], bn=p.shape[1],
                                k=len(bd.offsets), dtype=self.config.compute_dtype)
        res = None if bd.res_meta is None else build_a_tiles(bd.res_meta, w[bd.res_ids])
        return self._bd_spmm(x, bd, wp, res)

    def _spmm_w(self, x, w):
        """``(A ⊙ w) @ x``."""
        if not self.dense_tiles:
            return spmm_tc(x, self.chunks, w)
        if self.bd_addressable:
            return self._bd_weighted(x, w, self.bd)
        return spmm_tc_dense(x, self.meta, build_a_tiles(self.meta, w))

    def _spmm_w_t(self, dy, w):
        """``(A ⊙ w)^T @ dy``, over the transpose."""
        wt = w[self.t_edge_src]
        if not self.dense_tiles:
            return spmm_tc(dy, self.chunks_t, wt)
        if self.bd_addressable:
            return self._bd_weighted(dy, wt, self.bd_t)
        return spmm_tc_dense(dy, self.meta_t, build_a_tiles(self.meta_t, wt))

    def _sddmm(self, xa, xb):
        """Per-edge ``<xa[row_e], xb[col_e]>``, [E] f32 (K4, or K9 on the
        chunk route)."""
        if not self.dense_tiles:
            return sddmm_tc(xa, self.chunks, xb)
        return sddmm_tc_dense(xa, self._sddmm_meta, xb)

    def _agnn_f(self, x):
        """``(A ⊙ x x^T) @ x``."""
        if self._agnn_bd:
            bd = self.bd
            out = bd_sfused(x, x, x, bd.pack, offsets=bd.offsets, cfg=self.config,
                            index=bd.row_index)
            if bd.res_meta is not None:
                out = out + spmm_sfused(x, x, x, bd.res_meta, bd.res_a, index=bd.res_index)
            return out
        return spmm_sfused(x, x, x, self.meta, self.a_struct, index=self.sfused_index)

    def _agnn_b(self, x, dy):
        """``(dx3, u)`` of the one-pass AGNN backward."""
        if self._agnn_bd:
            bd = self.bd
            dx3, u = bd_sfused_bwd(x, dy, bd.pack, offsets=bd.offsets, cfg=self.config,
                                   index=bd.row_index)
            if bd.res_meta is not None:
                dx3_r, u_r = spmm_sfused_bwd(x, dy, bd.res_meta, bd.res_a, index=bd.res_index)
                dx3, u = dx3 + dx3_r, u + u_r
            return dx3, u
        return spmm_sfused_bwd(x, dy, self.meta, self.a_struct, index=self.sfused_index)


def tiled_graph_from_dataset(ds, config: TileConfig = DEFAULT_CONFIG, **kw) -> TiledGraph:
    return TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, config, **kw)
