"""PyTorch/CUDA port of the tcgnn_tpu GNN training framework.

Sparse Graph Translation condenses a CSR adjacency into dense tiles; a
hand-written CUDA kernel for Hopper (``csrc/spmm_dense.cu``) runs the SpMM
over them; GCN and GIN train full-graph on top.  The JAX package
``tcgnn_tpu`` is the reference this package is checked against; this
package imports neither it nor JAX.
"""

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, GPU_REFERENCE_CONFIG, TileConfig
from tcgnn_tpu_torch.graph import TiledGraph, tiled_graph_from_dataset

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "GPU_REFERENCE_CONFIG",
    "TileConfig",
    "TiledGraph",
    "tiled_graph_from_dataset",
]
