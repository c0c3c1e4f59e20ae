"""TiledGraph: an SGT-tiled graph with a differentiable SpMM (PyTorch port).

Counterpart of ``tcgnn_tpu.graph.TiledGraph`` for the condensed dense-tile
route only.  It owns the forward and the transpose tiling (shared when the
adjacency is symmetric), builds the int8 structural tiles on the host and
uploads them once, and exposes ``spmm`` as a ``torch.autograd.Function``
whose forward and backward both run K1 (``ops.spmm.spmm_tc_dense``): the
backward is the same SpMM over the transpose tiles, so gradients are exact
on directed graphs too.

Not carried over yet (``ROADMAP.md``): the block-diagonal route, the chunk
and streamed routes for graphs over the dense-tile budget, and the
weighted SpMM, SDDMM and AGNN ops.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.ops.spmm import spmm_tc_dense
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
        t_ptr, t_idx, _ = transpose_csr(row_pointers, column_index, num_nodes)
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


def tiled_graph_from_dataset(ds, config: TileConfig = DEFAULT_CONFIG, **kw) -> TiledGraph:
    return TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, config, **kw)
