"""The distributed layer of the port: the ``('graph', 'feature')`` mesh,
the row-window partition with its halo and block-stream split, and the
dense-tile route's ops and training step, every shard on one device."""

from tcgnn_tpu_torch.parallel.graph import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    probe_block_diag,
)
from tcgnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from tcgnn_tpu_torch.parallel.partition import ShardedSGTMeta, partition_csr, partition_graph
from tcgnn_tpu_torch.parallel.train import init_distributed_net, make_distributed_train_step

__all__ = [
    "DistributedTiledGraph", "distributed_graph_from_dataset", "probe_block_diag", "Mesh",
    "make_mesh", "ShardedSGTMeta", "partition_csr", "partition_graph",
    "init_distributed_net", "make_distributed_train_step",
]
