"""The work of one training epoch, counted from the configuration and the graph's sizes.

Every count here is a function of the configuration (model, layer widths,
hoist) and of the graph's node and edge counts only, never of the port's
tiles, chunks or padded blocks, so it reads the same work whatever
implements it.

FLOPs of an epoch (``epoch_flops``): each GEMM ``m x k @ k x n`` at
``2 m k n`` forward and again for each gradient that flows (the weights'
always, the input's past layer 1); each aggregation over ``E`` edges at
``2 E w`` for width ``w``; for AGNN each score SDDMM at ``2 E w``.

* GCN layer ``a -> b``: the aggregation runs at the narrower width
  ``min(a, b)``, forward and, past layer 1, backward over the transpose.
  Layer 1's aggregate of the input features is hoisted (the configuration's
  ``hoist``), so it is set-up work and counts nothing in an epoch.
* AGNN layer ``a -> b`` (``x' = h W``, ``out_i = c sum_j <x'_i, x'_j> x'_j``):
  forward one SDDMM and one aggregation at ``b``; backward (``x'`` always
  needs its gradient, for ``W``) one aggregation over the transpose weighted
  by the scores, one SDDMM for the scores' gradient and two aggregations for
  the scores' two sides: ``4 E b`` forward and ``8 E b`` backward.

Aggregation bytes of an epoch (``agg_bytes``), by ``csr_bound``'s rule: each
pass over the graph reads its int32 column indices and ``N + 1`` int32 row
pointers once, and its dense operands once and writes its outputs once, in
f32.  A GCN aggregation at width ``w`` reads ``x`` and writes the output
(``2 * 4 N w``).  An AGNN layer's forward, with the scores fused, reads
``x'`` and writes the output (``2 * 4 N b``); its backward reads ``x'`` and
the output's gradient and writes ``x'``'s (``3 * 4 N b``).  That is the
least any schedule moves, so no schedule can read above 100% of the bound.

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


def layer_dims(config: dict, traffic: dict) -> list:
    """Layer widths: input features, ``num_layers - 1`` hidden, classes."""
    layers = int(config["num_layers"])
    return [int(traffic["features"])] + [int(config["hidden"])] * (layers - 1) + [
        int(traffic["classes"])]


def epoch_counts(config: dict, dims: list, n: int, e: int) -> dict:
    """``flops`` (every GEMM, aggregation and SDDMM of one epoch),
    ``agg_flops`` and ``agg_bytes`` (the aggregations and SDDMMs alone)."""
    model = config["model"]
    if model not in ("gcn", "agnn"):
        raise ValueError(f"no work count for model {model!r}")
    gemm = agg_flops = agg_bytes = 0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        first = i == 0
        gemm += 2 * n * a * b * (2 if first else 3)
        if model == "gcn":
            if first and config["hoist"]:
                continue
            w = min(a, b)
            passes = 1 if first else 2
            agg_flops += passes * 2 * e * w
            agg_bytes += passes * (csr_bytes(e, n) + 2 * F32 * n * w)
        else:
            agg_flops += 4 * e * b + 8 * e * b
            agg_bytes += 2 * csr_bytes(e, n) + 5 * F32 * n * b
    return {"flops": gemm + agg_flops, "agg_flops": agg_flops, "agg_bytes": agg_bytes}
