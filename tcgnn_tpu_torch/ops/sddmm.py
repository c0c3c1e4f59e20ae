"""Dense-tile SDDMM over SGT-tiled graphs (K4 of the port).

Counterpart of ``tcgnn_tpu.ops.sddmm.sddmm_tc_dense``: per-edge scores
``e = <xa[row_e], xb[col_e]>`` in CSR edge order, f32, from operands cast
to the compute dtype.

``sddmm_tc_dense`` launches the hand-written CUDA kernel
(``csrc/sddmm_dense.cu``: equal ranges of edges a warp, lane groups of
four columns a lane, four edges' dots in flight a group) for a CUDA
tensor, and runs the plain PyTorch version ``sddmm_tc_dense_torch`` for a
CPU tensor only.  The plain version is the JAX algorithm: score tiles
``xa[window] @ xb[col_ids]^T`` as a batched product, then each edge's entry
read out at ``meta.edge_pos``.  Counters: ``sddmm_tc_dense.launches`` and
``.plain_calls``.

``sddmm_tc_tiles`` is the same kernel in its tile mode: each edge's score,
in the compute dtype (or f32), written at its tile position in a zeroed
``[B, blk_h, blk_w]`` array, the score tiles that the distributed layer's
fused AGNN sums over the feature axis and feeds to K10 (``ops/fused.py``).
Its counters are its own; chip_smoke counts both wrappers as K4.

``xa`` has ``meta.num_rows`` rows and ``xb`` ``meta.num_src``: equal on one
device; a shard of the distributed layer reads its window rows from its own
(and guest) rows and its columns from its halo slab.

The kernel reads only each edge's row and column, in any order (a split
stream of the distributed layer holds its edges out of row order), so
``meta`` may also be an ``EdgeList``: the block-diagonal route's SDDMM is
K4 over every edge (the JAX package's ``bd_sddmm_edges`` and its residual
dots, whose bin-chunk slabs are a TPU gather-locality device).  Its plain
version is the per-edge dot.  What a launch checks of the edge arrays is
worked out once a metadata object (``edge_device``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND
from tcgnn_tpu_torch.sgt.translate import TorchSGTMeta, index_device

# Above this many f32 score-tile bytes the plain version computes each
# edge's dot directly instead of forming the tiles (the value is the same).
# The JAX package switches its device route at the same size
# (``tcgnn_tpu.graph.SDDMM_EDGE_DOT_BYTES``); the kernel is per-edge always.
SDDMM_EDGE_DOT_BYTES = 512 << 20


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Each CSR edge's row and column (int32, on the features' device):
    what K4 reads, for graphs without condensed tiles."""

    config: TileConfig
    num_rows: int  # rows of xa
    num_src: int  # rows of xb
    num_edges: int
    edge_rows: torch.Tensor  # [E] int32
    edge_cols: torch.Tensor  # [E] int32
    # What a launch checks, worked out once here (``index_device``).
    edge_device: Optional[torch.device] = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    EDGE_INDEX = ("edge_rows", "edge_cols")

    def __post_init__(self):
        object.__setattr__(self, "edge_device", index_device(
            [getattr(self, name) for name in self.EDGE_INDEX]))

    @classmethod
    def from_rows(cls, edge_rows, column_index, num_nodes, config, device) -> "EdgeList":
        """From each CSR edge's row (host array) and the column index."""

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        n = int(num_nodes)
        return cls(config, n, n, len(column_index), dev(edge_rows), dev(column_index))


def sddmm_tc_dense_torch(
    xa: torch.Tensor, meta: TorchSGTMeta | EdgeList, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K4: score tiles by a batched product, then
    the per-edge extraction by ``edge_pos``; for an ``EdgeList``, or tiles
    past ``SDDMM_EDGE_DOT_BYTES``, each edge's dot."""
    cfg = meta.config
    ct = cfg.compute_dtype
    a = xa.to(ct)
    b = a if xb is None else xb.to(ct)
    if (isinstance(meta, EdgeList)
            or meta.num_blocks * cfg.blk_h * cfg.blk_w * 4 > SDDMM_EDGE_DOT_BYTES):
        return (a.index_select(0, meta.edge_rows).float()
                * b.index_select(0, meta.edge_cols).float()).sum(1)
    return _score_tiles(a, b, meta).view(-1).index_select(0, meta.edge_pos)


def _score_tiles(a, b, meta):
    """The JAX algorithm's score tiles ``a[window] @ b[col_ids]^T``,
    ``[B, blk_h, blk_w]`` f32."""
    cfg = meta.config
    n, d = a.shape
    a_win = torch.nn.functional.pad(a, (0, 0, 0, meta.num_windows * cfg.blk_h - n))
    a_win = a_win.view(meta.num_windows, cfg.blk_h, d).index_select(0, meta.block_window)
    b_g = b.index_select(0, meta.col_ids).view(meta.num_blocks, cfg.blk_w, d)
    return torch.bmm(a_win.float(), b_g.float().transpose(1, 2))


def check_edge_operands(op: str, meta, device: torch.device, tiles: bool) -> None:
    """What K4 reads of ``meta``: its edge arrays (``edge_rows``,
    ``edge_cols`` and, for ``tiles``, ``edge_pos``) int32 and contiguous on
    ``device``.  Worked out once where the metadata was made
    (``meta.edge_device``); only where that check failed are the arrays
    looked at again, to name the fault."""
    if meta.edge_device != device:
        _kernels.check_operands(
            op, device, edge_rows=meta.edge_rows, edge_cols=meta.edge_cols,
            edge_pos=meta.edge_pos if tiles else None)


def _sddmm_cuda(op, xa, xb, meta, tiles, tile_dtype=None):
    """K4: per-edge f32 scores, or (``tiles``) score tiles of
    ``tile_dtype`` (the compute dtype or f32) holding each edge's score at
    its tile position."""
    ct = meta.config.compute_dtype
    if ct not in FEAT_KIND:
        raise TypeError(f"{op}: no kernel for compute dtype {ct}")
    check_edge_operands(op, meta, xa.device, tiles)
    d = xa.shape[1]
    if xa.numel() >= 2**31 or (xb is not None and xb.numel() >= 2**31):
        raise ValueError(f"{op}: an operand has 2**31 elements or more")
    cfg = meta.config
    if tiles:
        out = torch.zeros((meta.num_blocks, cfg.blk_h, cfg.blk_w), dtype=tile_dtype,
                          device=xa.device)
    else:
        out = torch.empty(meta.num_edges, dtype=torch.float32, device=xa.device)
    if meta.num_edges == 0 or d == 0:
        return out.zero_()
    if xa.dtype != ct or not xa.is_contiguous():
        xa = xa.to(ct).contiguous()
    if xb is None:
        xb = xa
    elif xb.dtype != ct or not xb.is_contiguous():
        xb = xb.to(ct).contiguous()
    _kernels.call(
        "sddmm_dense", "tcgnn_sddmm_dense", xa.device,
        xa.data_ptr(), xb.data_ptr(), meta.edge_rows.data_ptr(), meta.edge_cols.data_ptr(),
        meta.edge_pos.data_ptr() if tiles else None, out.data_ptr(), meta.num_edges, d,
        FEAT_KIND[ct], int(tiles and tile_dtype == torch.float32), _kernels.stream_of(xa),
    )
    return out


def _check_rows(op, xa, xb, meta):
    """``xa`` has ``meta.num_rows`` rows; ``xb`` (``None``: ``xa``)
    ``meta.num_src``, on xa's device, of xa's width."""
    if xa.dim() != 2 or xa.shape[0] != meta.num_rows:
        raise ValueError(f"{op}: xa of shape {tuple(xa.shape)}, expected [{meta.num_rows}, d]")
    if xb is None:
        if meta.num_src != meta.num_rows:
            raise ValueError(f"{op}: xb is needed: gathers read {meta.num_src} rows")
    elif (xb.dim() != 2 or xb.shape != (meta.num_src, xa.shape[1])
          or xb.device != xa.device):
        raise ValueError(f"{op}: xb {tuple(xb.shape)} on {xb.device}, expected "
                         f"[{meta.num_src}, {xa.shape[1]}] on {xa.device}")


@_kernels.counted
def sddmm_tc_dense(
    xa: torch.Tensor, meta: TorchSGTMeta | EdgeList, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-edge ``e = <xa[row_e], xb[col_e]>`` (CSR order), ``[E]`` f32;
    ``xb=None`` means ``xb = xa``.  A CUDA tensor runs the kernel (or
    raises); a CPU tensor runs the plain version."""
    _check_rows("sddmm_tc_dense", xa, xb, meta)
    if xa.device.type == "cuda":
        out = _sddmm_cuda("sddmm_tc_dense", xa, xb, meta, tiles=False)
        sddmm_tc_dense.launches += 1
        return out
    if xa.device.type != "cpu":
        raise ValueError(f"sddmm_tc_dense: no kernel for device {xa.device}")
    sddmm_tc_dense.plain_calls += 1
    return sddmm_tc_dense_torch(xa, meta, xb)


def sddmm_tc_tiles_torch(xa: torch.Tensor, meta: TorchSGTMeta, xb: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of K4's tile mode: the JAX algorithm's score
    tiles, kept at the edges' positions (zero elsewhere), in ``out_dtype``
    (default the compute dtype)."""
    ct = meta.config.compute_dtype
    scores = _score_tiles(xa.to(ct), xb.to(ct), meta).view(-1)
    out = torch.zeros_like(scores)
    out[meta.edge_pos] = scores[meta.edge_pos]
    return out.view(meta.num_blocks, meta.config.blk_h, meta.config.blk_w).to(out_dtype or ct)


@_kernels.counted
def sddmm_tc_tiles(xa: torch.Tensor, meta: TorchSGTMeta, xb: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """K4's tile mode: score tiles ``[B, blk_h, blk_w]`` holding
    ``<xa[row_e], xb[col_e]>`` at each edge's tile position
    ``meta.edge_pos`` and zero elsewhere: the JAX
    ``_sddmm_dense_padded(..., out_dtype=...)`` tiles, whose non-edge
    entries the fused SpMM's structural tile masks.  ``out_dtype``: the
    compute dtype (default) or f32.  A CUDA tensor runs the kernel (or
    raises); a CPU tensor runs the plain version."""
    _check_rows("sddmm_tc_tiles", xa, xb, meta)
    out_dtype = out_dtype or meta.config.compute_dtype
    if out_dtype not in (meta.config.compute_dtype, torch.float32):
        raise TypeError(f"sddmm_tc_tiles: tiles in {out_dtype}, expected the compute dtype "
                        "or float32")
    if xa.device.type == "cuda":
        out = _sddmm_cuda("sddmm_tc_tiles", xa, xb, meta, tiles=True, tile_dtype=out_dtype)
        sddmm_tc_tiles.launches += 1
        return out
    if xa.device.type != "cpu":
        raise ValueError(f"sddmm_tc_tiles: no kernel for device {xa.device}")
    sddmm_tc_tiles.plain_calls += 1
    return sddmm_tc_tiles_torch(xa, meta, xb, out_dtype)
