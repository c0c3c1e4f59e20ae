from tcgnn_tpu_torch.ops._kernels import reset_counts
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.ops.sddmm import sddmm_tc_dense, sddmm_tc_dense_torch
from tcgnn_tpu_torch.ops.sfused import (
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
)
from tcgnn_tpu_torch.ops.spmm import build_a_tiles, spmm_tc_dense, spmm_tc_dense_torch

__all__ = [
    "reset_counts", "build_a_tiles", "spmm_tc_dense", "spmm_tc_dense_torch",
    "sddmm_tc_dense", "sddmm_tc_dense_torch", "spmm_sfused", "spmm_sfused_torch",
    "spmm_sfused_bwd", "spmm_sfused_bwd_torch", "spmm_ref", "sddmm_ref", "sfused_ref",
    "sfused_bwd_ref",
]
