"""The two directed graphs that AGNN trains on over its per-edge route
(scores by K4, then a weighted SpMM), which ``chip_smoke.py`` and
``tcgnn_tpu_torch.profiling`` run: a directed graph has no score-fused
kernel.  Each is made from a fixed seed and given to the trainer as a
``.npz`` file (``write_npz``).

* ``asymmetric_graph``: 5,000 nodes of a power-law graph with one direction
  of most pairs dropped, on the condensed dense-tile route (K4, K1 over
  weighted tiles).
* ``banded_graph``: 200,000 nodes, 1.2 M edges within +-100 of the diagonal
  and 2% random long-range edges: the block-diagonal route with a residual
  (K4 over every edge, K5 over weighted packs, K1 for the residual).
"""

from __future__ import annotations

import os

import numpy as np

from tcgnn_tpu_torch.data.dataset import coo_to_csr
from tcgnn_tpu_torch.data.synthetic import powerlaw_graph


def asymmetric_graph():
    """(num_nodes, row_pointers, column_index) of a directed power-law graph."""
    n = 5000
    src, dst = powerlaw_graph(n, 40000, seed=11)
    keep = (src < dst) | ((src + dst) % 3 == 0)  # drop one direction of most pairs
    rp, ci = coo_to_csr(src[keep], dst[keep], n)
    return n, rp, ci


def banded_graph():
    """(num_nodes, row_pointers, column_index) of a directed banded graph."""
    n = 200_000
    rng = np.random.default_rng(21)
    src = rng.integers(0, n, 1_200_000)
    dst = np.clip(src + rng.integers(-100, 101, len(src)), 0, n - 1)
    far = rng.integers(0, n, (2, 24_000))
    rp, ci = coo_to_csr(np.concatenate([src, far[0]]), np.concatenate([dst, far[1]]), n)
    return n, rp, ci


def write_npz(directory, name, graph) -> str:
    """``graph()`` as ``directory/name.npz`` in the trainer's format, with
    random labels of 4 classes (the trainer's ``--classes`` is the larger
    of its own value and 4); returns ``name``."""
    n, rp, ci = graph()
    rows = np.repeat(np.arange(n), np.diff(rp))
    y = np.random.default_rng(12).integers(0, 4, n).astype(np.int32)
    np.savez(os.path.join(directory, f"{name}.npz"), src_li=rows, dst_li=ci, num_nodes=n, y=y)
    return name
