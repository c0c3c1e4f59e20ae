from tcgnn_tpu_torch.sgt.translate import (
    KERNEL_RUN_BLOCKS,
    SGTMeta,
    TorchSGTMeta,
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)

__all__ = [
    "KERNEL_RUN_BLOCKS", "SGTMeta", "TorchSGTMeta", "build_a_tiles_host", "count_blocks",
    "sparse_graph_translate", "transpose_csr",
]
