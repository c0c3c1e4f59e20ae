"""AGNN as TC-GNN defines it (artifact ``1_bench_agnn.py``): unnormalised dot-product scores.

A layer ``a -> b`` projects ``x' = h W`` and aggregates
``out_i = c * sum_{e=(i,j)} <x'_i, x'_j> x'_j``, with ``c`` the mean of the
layer's ``[1, n_heads]`` attention weights (one score shared by every
head); weights and attention weights uniform on ``+-1/sqrt(out)``;
TC-GNN's stack around the layers (``reference.stack_forward``).  The
aggregation's backward pass is written out (``_Attention``) so that it runs
in the graph's edge blocks.

The epoch's work (``epoch_counts``), a function of the configuration and
the graph's sizes only: each GEMM ``m x k @ k x n`` at ``2 m k n`` forward
and again for each gradient that flows (the weights' always, the input's
past layer 1); a layer at width ``b``: forward one score SDDMM and one
aggregation (``4 E b``), backward (``x'`` always needs its gradient, for
``W``) one aggregation over the transpose weighted by the scores, one SDDMM
for the scores' gradient and two aggregations for the scores' two sides
(``8 E b``).  Aggregation bytes by ``counts.csr_bytes``' rule: the forward,
with the scores fused, reads ``x'`` and writes the output (``2 * 4 N b``);
the backward reads ``x'`` and the output's gradient and writes ``x'``'s
(``3 * 4 N b``); each of the two reads the graph once.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts import F32, csr_bytes
from benchmark.reference import stack_dims as layer_dims  # noqa: F401
from benchmark.reference import stack_forward
from benchmark.reference import stack_masks as dropout_masks  # noqa: F401

WEIGHTED_TRAFFIC = True    # the graph keeps the weighted SpMM's traffic
NET_ARGS = ("n_heads",)    # configuration keys passed to the port's ``nets.GNN``


def make_weights(config: dict, dims: list, seed: int, device) -> dict:
    """Uniform on ``+-1/sqrt(out)``, drawn on ``device`` from ``seed``: a
    layer's weights and then its ``[1, n_heads]`` attention weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        stdv = 1.0 / math.sqrt(b)
        for name, shape in ((f"weights.{i}", (a, b)),
                            (f"attention_w.{i}", (1, int(config["n_heads"])))):
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = u * (2 * stdv) - stdv
    return out


class _Attention(torch.autograd.Function):
    """AGNN's aggregation ``out_i = c * sum_{e=(i,j)} s_e x_j`` with the
    score ``s_e = <x_i, x_j>``.  With ``g`` the output's gradient and
    ``t_e = <g_i, x_j>``: ``dc = sum_e s_e t_e`` and
    ``dx = c * (sum_{e=(i,j)} s_e g_i + t_e x_i, into row j) + c * (sum_{e=(i,j)} t_e x_j, into row i)``."""

    @staticmethod
    def forward(ctx, x, c, graph):
        ctx.graph = graph
        ctx.save_for_backward(x, c)
        out = torch.zeros_like(x)
        for r, col in graph.blocks():
            xc = x.index_select(0, col)
            s = (x.index_select(0, r) * xc).sum(1, keepdim=True)
            out.index_add_(0, r, s * xc)
        return out * c

    @staticmethod
    def backward(ctx, g):
        x, c = ctx.saved_tensors
        dx = torch.zeros_like(x)
        dc = torch.zeros((), dtype=x.dtype, device=x.device)
        for r, col in ctx.graph.blocks():
            xr, xc, gr = x.index_select(0, r), x.index_select(0, col), g.index_select(0, r)
            s = (xr * xc).sum(1, keepdim=True)
            t = (gr * xc).sum(1, keepdim=True)
            dc += (s * t).sum()
            dx.index_add_(0, col, s * gr + t * xr)
            dx.index_add_(0, r, t * xc)
        return dx * c, dc.reshape(c.shape), None


def prepare(config: dict, x, graph):
    """Nothing: every aggregation depends on the weights."""
    return None


def forward(config: dict, p: dict, x, graph, mask, fixed):
    """Log-probabilities ``[N, classes]``."""

    def layer(i, h):
        return _Attention.apply(h @ p[f"weights.{i}"], p[f"attention_w.{i}"].mean(), graph)

    return stack_forward(config, layer, x, mask)


def epoch_counts(config: dict, dims: list, n: int, e: int) -> dict:
    """``flops`` (every GEMM, aggregation and SDDMM of one epoch),
    ``agg_flops`` and ``agg_bytes`` (the aggregations and SDDMMs alone)."""
    gemm = agg_flops = agg_bytes = 0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        gemm += 2 * n * a * b * (2 if i == 0 else 3)
        agg_flops += 4 * e * b + 8 * e * b
        agg_bytes += 2 * csr_bytes(e, n) + 5 * F32 * n * b
    return {"flops": gemm + agg_flops, "agg_flops": agg_flops, "agg_bytes": agg_bytes}
