"""The artifact-evaluation dataset matrix (a copy of
``tcgnn_tpu.bench.datasets``, which sits inside the JAX package).

The fixed 14-graph sweep table of the reference's benchmark scripts (``1_bench_gcn.py``:
name, feature dim, classes).  Graphs load from ``--data_dir`` ``.npz``
files when present and are synthesized at matching scale otherwise.
"""

# (name, feature_dim, num_classes), in the order of 1_bench_gcn.py.
AE_TABLE = [
    ("citeseer", 3703, 6),
    ("cora", 1433, 7),
    ("pubmed", 500, 3),
    ("ppi", 50, 121),
    ("PROTEINS_full", 29, 2),
    ("OVCAR-8H", 66, 2),
    ("Yeast", 74, 2),
    ("DD", 89, 2),
    ("YeastH", 75, 2),
    ("amazon0505", 96, 22),
    ("artist", 100, 12),
    ("com-amazon", 96, 22),
    ("soc-BlogCatalog", 128, 39),
    ("amazon0601", 96, 22),
]

# Model configs of the reference's benchmark scripts.
GCN_CONFIG = dict(num_layers=2, hidden=16)    # 1_bench_gcn.py:5-7
AGNN_CONFIG = dict(num_layers=4, hidden=32)   # 1_bench_agnn.py:5-7
