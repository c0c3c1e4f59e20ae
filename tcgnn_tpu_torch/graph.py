"""TiledGraph: an SGT-tiled graph with differentiable graph ops (PyTorch port).

Counterpart of ``tcgnn_tpu.graph.TiledGraph`` for the condensed dense-tile
route only.  It owns the forward and the transpose tiling (shared when the
adjacency is symmetric), builds the int8 structural tiles on the host and
uploads them once, and exposes its ops as ``torch.autograd.Function``s with
exact backwards, on directed graphs too:

* ``spmm(x)`` — ``A @ x``: K1 forward, K1 over the transpose tiles backward;
* ``spmm_weighted(x, w)`` — ``(A ⊙ w) @ x`` with per-edge weights: K1 over
  weighted tiles (``build_a_tiles``); backward ``dx`` by K1 over the
  transpose's weighted tiles, ``dw`` by K4 (``sddmm(dy, x)``);
* ``sddmm(x)`` — per-edge ``<x_i, x_j>``: K4; backward by the two weighted
  SpMMs;
* ``agnn_aggregate(x, att_w)`` — ``mean(att_w) * (A ⊙ x x^T) @ x``, AGNN's
  head-averaged aggregation: K2 forward, K3 backward.  Only on symmetric
  graphs (``None`` otherwise), as in the JAX package.

Not carried over yet (``ROADMAP.md``): the block-diagonal route, and the
chunk and streamed routes for graphs over the dense-tile budget.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.ops.sddmm import sddmm_tc_dense
from tcgnn_tpu_torch.ops.sfused import spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense
from tcgnn_tpu_torch.sgt.translate import (
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)

# Dense-tile bytes (int8 structural tiles, forward + transpose) above which
# the JAX package switches to its chunk route.  Kept at the JAX value so
# both packages route the same graphs; re-deriving it for 80 GB is queued.
DENSE_TILE_BUDGET_BYTES = 8 << 30


class _SpMM(torch.autograd.Function):
    """``A @ x`` forward, ``A^T @ dy`` backward, both on K1."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        ctx.x_dtype = x.dtype
        return spmm_tc_dense(x, graph.meta, graph.a_struct)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.graph
        dx = spmm_tc_dense(dy.contiguous(), g.meta_t, g.a_struct_t)
        return dx.to(ctx.x_dtype), None


class _SpMMWeighted(torch.autograd.Function):
    """``(A ⊙ w) @ x`` (TC-GNN's ``forward_AGNN``): K1 over weighted tiles.

    Backward: ``dx[j] = sum_{e=(i,j)} w_e dy[i]``, K1 over the transpose
    tiles weighted by ``w[t_edge_src]``; ``dw_e = <dy[row_e], x[col_e]>``,
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
            dw = sddmm_tc_dense(dy, g.meta, x).to(w.dtype)
        return dx, dw, None


class _SDDMM(torch.autograd.Function):
    """Per-edge scores ``e = <x[row_e], x[col_e]>`` (K4).

    Backward: ``dx[i] += sum_{e row=i} de_e x[col_e]`` and
    ``dx[j] += sum_{e col=j} de_e x[row_e]``: the two weighted SpMMs."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        ctx.save_for_backward(x)
        return sddmm_tc_dense(x, graph.meta, x)

    @staticmethod
    def backward(ctx, de):
        (x,) = ctx.saved_tensors
        g = ctx.graph
        d_rows = g._spmm_w(x, de)
        d_cols = g._spmm_w_t(x, de)
        return (d_rows + d_cols).to(x.dtype), None


class _AGNNAggregate(torch.autograd.Function):
    """AGNN's head-averaged aggregation on a symmetric graph:
    ``mean(att_w) * (A ⊙ S) @ x`` with ``S = x x^T`` (K2).

    Every head's attention is a scalar gate on the same edge score
    (``att_e^h = c_h e_e``), so the mean of the H weighted aggregations is
    one score-fused pass.  Backward (K3, one pass): ``dx = mean(c) * dx3``
    and ``d c_h = <dy, u> / H`` with ``(dx3, u)`` as in
    ``ops.sfused.spmm_sfused_bwd``; ``A`` symmetric turns the column-space
    term into a row-space one."""

    @staticmethod
    def forward(ctx, x, att_w, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, att_w)
        out = spmm_sfused(x, x, x, graph.meta, graph.a_struct)
        # The gate in the aggregate's own dtype (f32), as in JAX.
        return out * att_w.mean().to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, att_w = ctx.saved_tensors
        g = ctx.graph
        dx3, u = spmm_sfused_bwd(x, dy.contiguous(), g.meta, g.a_struct)
        dx = (att_w.mean().to(dx3.dtype) * dx3).to(x.dtype)
        d_cbar = torch.dot(dy.float().reshape(-1), u.float().reshape(-1))
        datt = (d_cbar / att_w.numel()).to(att_w.dtype).expand(att_w.shape).clone()
        return dx, datt, None


class TiledGraph:
    """Device-resident SGT-tiled graph.  Build once per graph (the
    ``Prep. (ms)`` stage); reuse across layers and epochs."""

    block_diag = False
    dense_tiles = True

    def __init__(
        self,
        row_pointers: np.ndarray,
        column_index: np.ndarray,
        num_nodes: Optional[int] = None,
        config: TileConfig = DEFAULT_CONFIG,
        symmetric: bool = False,
        device: torch.device | str = "cuda",
        weighted_traffic: bool = False,
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

        # Host-pass seconds (transpose, symmetry check, SGT, tile build):
        # everything before the uploads.
        t0 = time.perf_counter()
        t_ptr, t_idx, t_src = transpose_csr(row_pointers, column_index, num_nodes)
        if not symmetric and len(t_ptr) == len(row_pointers):
            symmetric = bool(
                np.array_equal(np.asarray(t_ptr, np.int64), np.asarray(row_pointers, np.int64))
                and np.array_equal(np.asarray(t_idx, np.int64), np.asarray(column_index, np.int64))
            )
        self.symmetric = symmetric

        tile_elems = config.blk_h * config.blk_w
        nb_f = count_blocks(row_pointers, column_index, num_nodes, config)
        nb_t = nb_f if symmetric else count_blocks(t_ptr, t_idx, num_nodes, config)
        dense_bytes = (nb_f if symmetric else nb_f + nb_t) * tile_elems
        if weighted_traffic and not symmetric:
            # Attention on an asymmetric graph builds weighted tiles per
            # call, several alive at once across forward and backward:
            # budget 4 such arrays at the compute dtype's width (the JAX
            # rule, without its block-diagonal probe).  Symmetric graphs
            # take the score-fused kernels, which build none.
            dense_bytes += 4 * nb_f * tile_elems * config.compute_dtype.itemsize
        if max(nb_f, nb_t) * tile_elems >= 2**31 or dense_bytes > DENSE_TILE_BUDGET_BYTES:
            raise NotImplementedError(
                f"graph needs {dense_bytes} bytes of dense tiles, over the "
                f"dense-tile budget of {DENSE_TILE_BUDGET_BYTES}: the chunk and "
                "streamed routes (ROADMAP.md, Queue 1 item 5) are not ported yet"
            )

        self.host_meta = sparse_graph_translate(
            row_pointers, column_index, num_nodes, config, build_tiles=True
        )
        self.host_meta_t = (
            self.host_meta
            if symmetric
            else sparse_graph_translate(t_ptr, t_idx, num_nodes, config, build_tiles=True)
        )
        self.prep_host_s = time.perf_counter() - t0

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
        self.agnn_aggregate = self._agnn_aggregate if symmetric else None

    def _upload_tiles(self, host_meta) -> torch.Tensor:
        """int8 structural tiles; the compute dtype when a duplicate count
        exceeds 127."""
        tiles = torch.from_numpy(build_a_tiles_host(host_meta))
        if tiles.dtype != torch.int8:
            tiles = tiles.to(self.config.compute_dtype)
        return tiles.to(self.device)

    @property
    def tc_blocks(self) -> int:
        return self.host_meta.num_real_blocks

    @property
    def exp_edges(self) -> int:
        return self.host_meta.exp_edges

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable ``A @ x`` in the compute dtype."""
        return _SpMM.apply(x, self)

    def spmm_weighted(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``(A ⊙ w) @ x`` for per-edge weights ``w`` [E] (CSR
        order), in the compute dtype."""
        return _SpMMWeighted.apply(x, w, self)

    def sddmm(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable per-edge scores ``<x_i, x_j>``, [E] f32."""
        return _SDDMM.apply(x, self)

    def _agnn_aggregate(self, x: torch.Tensor, att_w: torch.Tensor) -> torch.Tensor:
        """Differentiable ``mean(att_w) * (A ⊙ x x^T) @ x``, f32 (symmetric
        graphs only; ``agnn_aggregate`` is ``None`` otherwise)."""
        return _AGNNAggregate.apply(x, att_w, self)

    def _spmm_w(self, x, w):
        """``(A ⊙ w) @ x``, no autograd."""
        return spmm_tc_dense(x, self.meta, build_a_tiles(self.meta, w))

    def _spmm_w_t(self, dy, w):
        """``(A ⊙ w)^T @ dy`` over the transpose tiling, no autograd."""
        return spmm_tc_dense(dy, self.meta_t, build_a_tiles(self.meta_t, w[self.t_edge_src]))


def tiled_graph_from_dataset(ds, config: TileConfig = DEFAULT_CONFIG, **kw) -> TiledGraph:
    return TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, config, **kw)
