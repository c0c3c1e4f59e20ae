"""Score-weighted SpMM over SGT tiles (K10 of the port).

Counterpart of ``tcgnn_tpu.ops.spmm._spmm_fused_padded``:

    out = (A ⊙ S) @ x,   [meta.num_rows, d] f32

with ``A`` the structural tiles ``[B, blk_h, blk_w]`` (int8 counts, or the
compute dtype past 127), ``S`` score tiles of the same shape in the compute
dtype, and ``x`` of ``meta.num_src`` rows gathered through
``meta.col_ids``.  The JAX contract, rounding included: the product is
formed in the compute dtype (``a.astype(ct) * s.astype(ct)``), x is cast
to it, the sums are f32 and the output is f32.

The distributed layer's fused AGNN runs it when the feature axis is split
(``parallel/graph.py``): a score needs every feature, so the scores come as
tiles from K4's tile mode, summed over the feature shards, and K10
multiplies them in.

``spmm_fused`` launches the hand-written CUDA kernel (``tcgnn_spmm_fused``
in ``csrc/spmm_dense.cu``: K1's kernel with a score operand, read only at
the nonzero tile entries) for a CUDA tensor and runs the plain PyTorch
version ``spmm_fused_torch`` (``index_select``, ``bmm``, ``index_add_``) for
a CPU tensor only.  Counters: ``spmm_fused.launches`` and
``.plain_calls``.  Its host work is K1's: the metadata checked once, the C
function looked up once.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND, TILE_KIND, check_tiled_operands
from tcgnn_tpu_torch.sgt.translate import KERNEL_RUN_BLOCKS, TorchSGTMeta


def spmm_fused_torch(x: torch.Tensor, meta: TorchSGTMeta, a_tiles: torch.Tensor,
                     s_tiles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10."""
    cfg = meta.config
    ct = cfg.compute_dtype
    d = x.shape[1]
    w = a_tiles.to(ct) * s_tiles.to(ct)
    xg = x.to(ct).index_select(0, meta.col_ids).view(meta.num_blocks, cfg.blk_w, d)
    part = torch.bmm(w.float(), xg.float())  # [B, blk_h, d]
    out = torch.zeros((meta.num_windows, cfg.blk_h, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, meta.block_window, part)
    return out.view(-1, d)[:meta.num_rows]


@_kernels.counted
def spmm_fused(x: torch.Tensor, meta: TorchSGTMeta, a_tiles: torch.Tensor,
               s_tiles: torch.Tensor) -> torch.Tensor:
    """``(A ⊙ S) @ x``, ``[meta.num_rows, d]`` f32.  A CUDA tensor runs K10
    (or raises); a CPU tensor runs the plain version."""
    cfg = meta.config
    if x.dim() != 2 or x.shape[0] != meta.num_src:
        raise ValueError(f"spmm_fused: x of shape {tuple(x.shape)}, expected "
                         f"[{meta.num_src}, d]")
    if s_tiles.shape != a_tiles.shape or s_tiles.device != x.device:
        raise ValueError(f"spmm_fused: score tiles {tuple(s_tiles.shape)} on {s_tiles.device}, "
                         f"structural tiles {tuple(a_tiles.shape)}, x on {x.device}")
    if x.device.type == "cpu":
        spmm_fused.plain_calls += 1
        return spmm_fused_torch(x, meta, a_tiles, s_tiles)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_fused: no kernel for device {x.device}")
    check_tiled_operands("spmm_fused", x, meta, a_tiles)
    ct = cfg.compute_dtype
    if s_tiles.dtype != ct or not s_tiles.is_contiguous():
        raise TypeError(f"spmm_fused: score tiles must be contiguous {ct}, got {s_tiles.dtype}")
    n, d = meta.num_rows, x.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out
    xc = x if x.dtype == ct and x.is_contiguous() else x.to(ct).contiguous()
    _kernels.call(
        "spmm_dense", "tcgnn_spmm_fused", x.device,
        xc.data_ptr(), a_tiles.data_ptr(), s_tiles.data_ptr(), meta.col_ids.data_ptr(),
        meta.win_start.data_ptr(), meta.run_window.data_ptr(), meta.run_block.data_ptr(),
        out.data_ptr(), n, d, meta.run_window.shape[0], KERNEL_RUN_BLOCKS,
        int(meta.max_window_blocks > KERNEL_RUN_BLOCKS), cfg.blk_h, cfg.blk_w,
        FEAT_KIND[ct], TILE_KIND[a_tiles.dtype], _kernels.stream_of(x),
    )
    spmm_fused.launches += 1
    return out
