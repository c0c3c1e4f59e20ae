"""GCN as TC-GNN's reference trainer runs it (``main_tcgnn.py``, artifact ``1_bench_gcn.py``).

A layer ``a -> b`` is ``(A h) W`` or ``A (h W)``, aggregating at the
narrower width; no normalisation; plain randn ``[in, out]`` weights (the
reference's layers leave them so); TC-GNN's stack around the layers
(``reference.stack_forward``).  The layer-1 aggregate ``A x`` is worked out
once (``prepare``): the input features are constant, so ``(A x) W`` is
layer 1 whether or not the program hoists it.

The epoch's work (``epoch_counts``), a function of the configuration and
the graph's sizes only: each GEMM ``m x k @ k x n`` at ``2 m k n`` forward
and again for each gradient that flows (the weights' always, the input's
past layer 1); a pass of the aggregation at width ``w`` at ``2 E w``
FLOPs and, by ``counts.csr_bytes``' rule, the graph once, ``x`` read and
the output written (``2 * 4 N w`` bytes).  Past layer 1 a layer runs two
passes at the narrower width ``min(a, b)``, forward and backward over the
transpose.  Layer 1's aggregate of the input features is hoisted where the
configuration's ``hoist`` says so, and then counts nothing in an epoch;
otherwise layer 1 runs the cheaper of one pass at ``a`` (``(A x) W``: the
features need no gradient) and two at ``b`` (``A (x W)``, whose weight
gradient takes the pass over the transpose).
"""

from __future__ import annotations

import torch

from benchmark.counts import F32, csr_bytes
from benchmark.reference import stack_dims as layer_dims  # noqa: F401
from benchmark.reference import stack_forward
from benchmark.reference import stack_masks as dropout_masks  # noqa: F401

WEIGHTED_TRAFFIC = False   # the graph keeps no weighted-SpMM traffic
NET_ARGS = ("n_heads",)    # configuration keys passed to the port's ``nets.GNN``


def make_weights(config: dict, dims: list, seed: int, device) -> dict:
    """Plain randn ``[in, out]`` weights a layer, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {f"weights.{i}": torch.randn((a, b), generator=gen, device=device)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


class _Aggregate(torch.autograd.Function):
    """``A @ x``; backward ``A^T @ dy``."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return graph.spmm(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.graph.spmm(dy, transpose=True), None


def _layer(h, w, graph):
    """GCN at the narrower width: ``(A h) W`` or ``A (h W)``."""
    a, b = w.shape
    return _Aggregate.apply(h, graph) @ w if a <= b else _Aggregate.apply(h @ w, graph)


def prepare(config: dict, x, graph):
    """``A @ x``, layer 1's aggregate."""
    return graph.spmm(x)


def forward(config: dict, p: dict, x, graph, mask, agg_x):
    """Log-probabilities ``[N, classes]``; ``agg_x`` is ``prepare``'s."""

    def layer(i, h):
        w = p[f"weights.{i}"]
        return agg_x @ w if i == 0 else _layer(h, w, graph)

    return stack_forward(config, layer, x, mask)


def epoch_counts(config: dict, dims: list, n: int, e: int) -> dict:
    """``flops`` (every GEMM and aggregation of one epoch), ``agg_flops``
    and ``agg_bytes`` (the aggregations alone)."""
    def pass_bytes(w):
        return csr_bytes(e, n) + 2 * F32 * n * w

    gemm = agg_flops = agg_bytes = 0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        first = i == 0
        gemm += 2 * n * a * b * (2 if first else 3)
        if first and config["hoist"]:
            continue
        passes, w = 2, min(a, b)
        if first:
            passes, w = min((1, a), (2, b), key=lambda o: o[0] * pass_bytes(o[1]))
        agg_flops += passes * 2 * e * w
        agg_bytes += passes * pass_bytes(w)
    return {"flops": gemm + agg_flops, "agg_flops": agg_flops, "agg_bytes": agg_bytes}
