"""The distributed layer of the port: the ``('graph', 'feature')`` mesh,
the row-window partition with its halo and block-stream split, the
block-diagonal route's shard packs and rim, the streamed route's window
segments, the dense-tile, block-diagonal, streamed and chunk routes' ops
and training step, every shard on one device or the grid over processes
(``mesh.init_process_group``, ``torchrun``: the graph axis split, or one
feature shard a rank), and the step's collective traffic (``comm_stats``)."""

from tcgnn_tpu_torch.parallel.comm_stats import dcn_halo_fraction, step_collective_bytes
from tcgnn_tpu_torch.parallel.graph import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    probe_block_diag,
)
from tcgnn_tpu_torch.parallel.mesh import (
    Mesh,
    init_process_group,
    make_mesh,
    make_mesh_two_level,
)
from tcgnn_tpu_torch.parallel.partition import (
    ShardedSGTMeta,
    partition_csr,
    partition_graph,
    partition_streamed,
)
from tcgnn_tpu_torch.parallel.train import init_distributed_net, make_distributed_train_step

__all__ = [
    "DistributedTiledGraph", "distributed_graph_from_dataset", "probe_block_diag", "Mesh",
    "init_process_group", "make_mesh", "make_mesh_two_level", "dcn_halo_fraction",
    "step_collective_bytes",
    "ShardedSGTMeta", "partition_csr", "partition_graph", "partition_streamed",
    "init_distributed_net", "make_distributed_train_step",
]
