from tcgnn_tpu_torch.data.dataset import GraphDataset, coo_to_csr, load_npz, load_txt
from tcgnn_tpu_torch.data.synthetic import AE_DATASETS, powerlaw_graph, synthesize

__all__ = [
    "GraphDataset", "coo_to_csr", "load_npz", "load_txt",
    "AE_DATASETS", "powerlaw_graph", "synthesize",
]
