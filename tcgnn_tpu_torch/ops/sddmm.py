"""Dense-tile SDDMM over SGT-tiled graphs (K4 of the port).

Counterpart of ``tcgnn_tpu.ops.sddmm.sddmm_tc_dense``: per-edge scores
``e = <xa[row_e], xb[col_e]>`` in CSR edge order, f32, from operands cast
to the compute dtype.

``sddmm_tc_dense`` launches the hand-written CUDA kernel
(``csrc/sddmm_dense.cu``, one dot per edge, edges spread by index) for a
CUDA tensor, and runs the plain PyTorch version ``sddmm_tc_dense_torch``
for a CPU tensor only.  The plain version is the JAX algorithm: score tiles
``xa[window] @ xb[col_ids]^T`` as a batched product, then each edge's entry
read out at ``meta.edge_pos``.  Counters: ``sddmm_tc_dense.launches`` and
``.plain_calls``.

The kernel reads only each edge's row and column, so ``meta`` may also be
an ``EdgeList``: the block-diagonal route's SDDMM is K4 over every edge
(the JAX package's ``bd_sddmm_edges`` and its residual dots, whose bin-chunk
slabs are a TPU gather-locality device).  Its plain version is the per-edge
dot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND
from tcgnn_tpu_torch.sgt.translate import TorchSGTMeta

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
    num_nodes: int
    num_edges: int
    edge_rows: torch.Tensor  # [E] int32
    edge_cols: torch.Tensor  # [E] int32

    @classmethod
    def from_rows(cls, edge_rows, column_index, num_nodes, config, device) -> "EdgeList":
        """From each CSR edge's row (host array) and the column index."""

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        return cls(config, int(num_nodes), len(column_index), dev(edge_rows), dev(column_index))


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
    n, d = a.shape
    if (isinstance(meta, EdgeList)
            or meta.num_blocks * cfg.blk_h * cfg.blk_w * 4 > SDDMM_EDGE_DOT_BYTES):
        return (a.index_select(0, meta.edge_rows).float()
                * b.index_select(0, meta.edge_cols).float()).sum(1)
    a_win = torch.nn.functional.pad(a, (0, 0, 0, meta.num_windows * cfg.blk_h - n))
    a_win = a_win.view(meta.num_windows, cfg.blk_h, d).index_select(0, meta.block_window)
    b_g = b.index_select(0, meta.col_ids).view(meta.num_blocks, cfg.blk_w, d)
    scores = torch.bmm(a_win.float(), b_g.float().transpose(1, 2))  # [B, blk_h, blk_w]
    return scores.view(-1).index_select(0, meta.edge_pos)


def _sddmm_cuda(xa, xb, meta):
    ct = meta.config.compute_dtype
    if ct not in FEAT_KIND:
        raise TypeError(f"sddmm_tc_dense: no kernel for compute dtype {ct}")
    _kernels.check_operands(
        "sddmm_tc_dense", xa.device, edge_rows=meta.edge_rows, edge_cols=meta.edge_cols
    )
    n, d = xa.shape
    if xa.numel() >= 2**31:
        raise ValueError("sddmm_tc_dense: xa has 2**31 elements or more")
    if meta.num_edges == 0 or d == 0:
        return torch.zeros(meta.num_edges, dtype=torch.float32, device=xa.device)
    a = xa.to(ct).contiguous()
    b = a if xb is None else xb.to(ct).contiguous()
    out = torch.empty(meta.num_edges, dtype=torch.float32, device=xa.device)
    lib = _kernels.load("sddmm_dense")
    with torch.cuda.device(xa.device):
        err = lib.tcgnn_sddmm_dense(
            a.data_ptr(), b.data_ptr(), meta.edge_rows.data_ptr(), meta.edge_cols.data_ptr(),
            out.data_ptr(), meta.num_edges, d, FEAT_KIND[ct], _kernels.stream_of(xa),
        )
    _kernels.check(lib, err, "sddmm_dense")
    sddmm_tc_dense.launches += 1
    return out


@_kernels.counted
def sddmm_tc_dense(
    xa: torch.Tensor, meta: TorchSGTMeta | EdgeList, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-edge ``e = <xa[row_e], xb[col_e]>`` (CSR order), ``[E]`` f32;
    ``xb=None`` means ``xb = xa``.  A CUDA tensor runs the kernel (or
    raises); a CPU tensor runs the plain version."""
    if xa.dim() != 2 or xa.shape[0] != meta.num_nodes:
        raise ValueError(
            f"sddmm_tc_dense: xa of shape {tuple(xa.shape)}, expected [{meta.num_nodes}, d]"
        )
    if xb is not None and (xb.shape != xa.shape or xb.device != xa.device):
        raise ValueError(f"sddmm_tc_dense: xb {tuple(xb.shape)} on {xb.device}, "
                         f"xa {tuple(xa.shape)} on {xa.device}")
    if xa.device.type == "cuda":
        return _sddmm_cuda(xa, xb, meta)
    if xa.device.type != "cpu":
        raise ValueError(f"sddmm_tc_dense: no kernel for device {xa.device}")
    sddmm_tc_dense.plain_calls += 1
    return sddmm_tc_dense_torch(xa, meta, xb)
