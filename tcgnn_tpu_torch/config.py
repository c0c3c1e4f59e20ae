"""Tiling configuration of the PyTorch port (counterpart of ``tcgnn_tpu.config``).

The geometry is the same as the JAX package's so that the SGT pass, the
``TC_Blocks`` statistic and every op output line up between the two
packages.  The default stays at the TPU's 512x128 for now; the H100's own
default is a later choice, made by measuring on the card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Geometry of the Sparse-Graph-Translation tiling.

    Attributes:
      blk_h: rows per row window (output tile height).
      blk_w: condensed columns per TC block (contraction width).
      compute_dtype: ``torch.float32`` (exact) or ``torch.bfloat16`` (bf16
        operands, f32 accumulation, bf16 stores).
      block_group: TC blocks per grid step of the TPU kernel.  SGT pads each
        window's block count to a multiple of it, so it is kept for padding
        parity with the JAX package.  The CUDA kernel walks a window's blocks
        itself and needs no grouping: 0 (auto) resolves to 1.
      edge_chunk: edge slots per uniform chunk of the chunk route's layout
        (``sparse_graph_translate(emit_chunks=True)``): each TC block's edge
        list is padded to a multiple of it.  Last here, so that the fields
        before it keep their positions.
    """

    blk_h: int = 512
    blk_w: int = 128
    compute_dtype: torch.dtype = torch.float32
    block_group: int = 1
    edge_chunk: int = 128

    @property
    def row_sentinel(self) -> int:
        """In-window row of a padding edge slot of the chunk layout: ``blk_h``,
        which no real row takes, so the chunk kernels skip the slot."""
        return self.blk_h


# The original CUDA system's 16x8 geometry (one WMMA fragment).
GPU_REFERENCE_CONFIG = TileConfig(blk_h=16, blk_w=8, edge_chunk=32)

DEFAULT_CONFIG = TileConfig()
