"""The card's peaks and the least time a piece of work can take on it.

An epoch's work is counted by each model's module (``models/<model>.py``,
``epoch_counts``: ``flops``, ``agg_flops``, ``agg_bytes``), as a function of
the configuration and of the graph's node and edge counts only, never of
the port's tiles, chunks or padded blocks, so it reads the same work
whatever implements it.  Aggregation bytes follow ``csr_bytes``' rule: each
pass over the graph reads its int32 column indices and ``N + 1`` int32 row
pointers once, and its dense operands once and writes its outputs once, in
f32.  That is the least any schedule moves, so no schedule can read above
100% of the bound.

``bound`` and ``csr_bound`` are copied from the port's
``tcgnn_tpu_torch/bench/roofline_bound.py`` at commit
195b8b7aa21a1e60ca085967e6c41ad999d11eea, with NVIDIA's H100 SXM
data-sheet peaks at 700 W (f32 outside the tensor cores: the configurations
compute in f32 with TF32 off).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32 = 4


def bound_s(n_bytes: float, flops: float) -> float:
    """The least seconds the card could take: each input read once and each
    output written once at the memory rate, or the f32 operations at the
    f32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def csr_bytes(nnz: int, n: int) -> int:
    """What any pass over a CSR adjacency must read of the graph: the int32
    column indices and the ``n + 1`` int32 row pointers."""
    return 4 * nnz + 4 * (n + 1)
