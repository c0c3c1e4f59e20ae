"""GIN as the port runs it (``models/layers.py::gin_conv``): ``(A h) W``, aggregate then one linear.

Not a model of the benchmark: ``test_benchmark_models.py`` copies this file to
``benchmark/models/gin.py`` in a copy of the checkout, beside a
configuration, a traffic file, a limits file and ``BENCHMARK.json``
entries, to show that a model is added with files and entries alone.
Plain randn ``[in, out]`` weights; TC-GNN's stack around the layers, with
the one dropout mask after layer 1.

The epoch's work: each GEMM at ``2 m k n`` forward and again for each
gradient that flows (the weights' always, the input's past layer 1); a layer
``a -> b`` aggregates at its input width ``a``, forward and, past layer 1,
backward over the transpose; layer 1's aggregate of the features runs once
an epoch, or never where it is hoisted.
"""

from __future__ import annotations

import torch

from benchmark.counts import F32, csr_bytes
from benchmark.reference import stack_dims as layer_dims  # noqa: F401
from benchmark.reference import stack_forward
from benchmark.reference import stack_masks as dropout_masks  # noqa: F401

WEIGHTED_TRAFFIC = False
NET_ARGS = ()


def make_weights(config: dict, dims: list, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return {f"weights.{i}": torch.randn((a, b), generator=gen, device=device)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


class _Aggregate(torch.autograd.Function):
    """``A @ h``; backward ``A^T @ dy``."""

    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return graph.spmm(h)

    @staticmethod
    def backward(ctx, dy):
        return ctx.graph.spmm(dy, transpose=True), None


def prepare(config: dict, x, graph):
    return graph.spmm(x)


def forward(config: dict, p: dict, x, graph, mask, agg_x):
    def layer(i, h):
        return (agg_x if i == 0 else _Aggregate.apply(h, graph)) @ p[f"weights.{i}"]

    return stack_forward(config, layer, x, mask)


def epoch_counts(config: dict, dims: list, n: int, e: int) -> dict:
    gemm = agg_flops = agg_bytes = 0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        first = i == 0
        gemm += 2 * n * a * b * (2 if first else 3)
        if first and config["hoist"]:
            continue
        passes = 1 if first else 2
        agg_flops += passes * 2 * e * a
        agg_bytes += passes * (csr_bytes(e, n) + 2 * F32 * n * a)
    return {"flops": gemm + agg_flops, "agg_flops": agg_flops, "agg_bytes": agg_bytes}
