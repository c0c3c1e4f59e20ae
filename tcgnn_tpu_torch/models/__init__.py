from tcgnn_tpu_torch.models.layers import (
    aggregate_first,
    agnn_conv,
    gcn_conv,
    gin_conv,
    init_agnn,
    sag,
)
from tcgnn_tpu_torch.models.nets import GNN, MODEL_KINDS, hoist_l1_aggregate, init_net

__all__ = [
    "aggregate_first", "agnn_conv", "gcn_conv", "gin_conv", "init_agnn", "sag",
    "GNN", "MODEL_KINDS", "hoist_l1_aggregate", "init_net",
]
