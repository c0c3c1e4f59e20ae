from tcgnn_tpu_torch.ops._kernels import reset_counts
from tcgnn_tpu_torch.ops.blockdiag import (
    bd_scatter_weights,
    bd_sfused,
    bd_sfused_bwd,
    bd_sfused_bwd_torch,
    bd_sfused_torch,
    build_bd_pack,
    spmm_block_diag,
    spmm_block_diag_torch,
)
from tcgnn_tpu_torch.ops.chunk import (
    sddmm_tc,
    sddmm_tc_streamed,
    sddmm_tc_streamed_torch,
    sddmm_tc_torch,
    spmm_tc,
    spmm_tc_streamed,
    spmm_tc_streamed_torch,
    spmm_tc_torch,
)
from tcgnn_tpu_torch.ops.fused import spmm_fused, spmm_fused_torch
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.ops.sddmm import (
    EdgeList,
    sddmm_tc_dense,
    sddmm_tc_dense_torch,
    sddmm_tc_tiles,
    sddmm_tc_tiles_torch,
)
from tcgnn_tpu_torch.ops.sfused import (
    sgt_row_index,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
)
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense, spmm_tc_dense_torch

__all__ = [
    "reset_counts", "build_a_tiles", "spmm_tc_dense", "spmm_tc_dense_torch",
    "EdgeList", "sddmm_tc_dense", "sddmm_tc_dense_torch", "spmm_sfused", "spmm_sfused_torch",
    "spmm_sfused_bwd", "spmm_sfused_bwd_torch", "build_bd_pack", "bd_scatter_weights",
    "spmm_block_diag", "spmm_block_diag_torch", "bd_sfused", "bd_sfused_torch",
    "bd_sfused_bwd", "bd_sfused_bwd_torch", "spmm_ref", "sddmm_ref", "sfused_ref",
    "sfused_bwd_ref", "spmm_tc", "spmm_tc_torch", "spmm_tc_streamed", "spmm_tc_streamed_torch",
    "sddmm_tc", "sddmm_tc_torch", "sddmm_tc_streamed", "sddmm_tc_streamed_torch",
    "sddmm_tc_tiles", "sddmm_tc_tiles_torch", "spmm_fused", "spmm_fused_torch", "sgt_row_index",
]
