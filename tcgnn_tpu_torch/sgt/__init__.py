from tcgnn_tpu_torch.sgt.blockdiag import BDMeta, bd_coverage, extract_block_diag
from tcgnn_tpu_torch.sgt.reorder import (
    apply_permutation,
    permute_csr,
    rcm_permutation,
    reorder_dataset,
)
from tcgnn_tpu_torch.sgt.stream import (
    MAX_PREFETCH_CHUNKS,
    MAX_SLAB_ROWS,
    StreamedMeta,
    needs_streaming,
    segment_chunks,
)
from tcgnn_tpu_torch.sgt.translate import (
    KERNEL_RUN_BLOCKS,
    SGTMeta,
    TorchChunkMeta,
    TorchSGTMeta,
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)

__all__ = [
    "BDMeta", "bd_coverage", "extract_block_diag", "apply_permutation", "permute_csr",
    "rcm_permutation", "reorder_dataset", "KERNEL_RUN_BLOCKS", "SGTMeta", "TorchSGTMeta",
    "build_a_tiles_host", "count_blocks", "sparse_graph_translate", "transpose_csr",
    "TorchChunkMeta", "MAX_PREFETCH_CHUNKS", "MAX_SLAB_ROWS", "StreamedMeta", "needs_streaming",
    "segment_chunks",
]
