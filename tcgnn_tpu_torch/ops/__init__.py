from tcgnn_tpu_torch.ops.reference import sddmm_ref, spmm_ref
from tcgnn_tpu_torch.ops.spmm import reset_counts, spmm_tc_dense, spmm_tc_dense_torch

__all__ = [
    "reset_counts", "spmm_tc_dense", "spmm_tc_dense_torch", "spmm_ref", "sddmm_ref",
]
