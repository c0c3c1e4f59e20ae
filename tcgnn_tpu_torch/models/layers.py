"""GNN layers: GCN, GIN and AGNN convolutions and the SAG primitive (PyTorch port).

Counterpart of ``tcgnn_tpu.models.layers`` with the same schedule:

* ``gcn_conv``  — ``aggregate(X @ W)``, or ``aggregate(X) @ W`` when that
  is cheaper on the graph's route (``aggregate_first``);
* ``gin_conv``  — ``aggregate(X) @ W``;
* ``agnn_conv`` — ``X' = X @ W``, then attention-weighted aggregation:
  the score-fused ``TiledGraph.agnn_aggregate`` (K2/K3, or K6/K7 on the
  block-diagonal route) where the graph has it, else per-edge scores (K4)
  and one weighted SpMM (K1, or K5) per head;
* ``sag``       — pure aggregation.

Weights keep the JAX layout ``[in, out]``.  Dense products are plain torch
(cuBLAS on the card); aggregation runs the port's kernels through
``TiledGraph``.
"""

from __future__ import annotations

import math

import torch

from tcgnn_tpu_torch.graph import TiledGraph


def _ct(graph) -> torch.dtype:
    """The graph's compute dtype (f32 configs keep everything f32)."""
    cfg = getattr(graph, "config", None)
    return cfg.compute_dtype if cfg is not None else torch.float32


def _amp_dot(a: torch.Tensor, w: torch.Tensor, ct: torch.dtype) -> torch.Tensor:
    """Dense update product in the compute dtype: operands in ``ct``, f32
    accumulation (cuBLAS accumulates bf16 products in f32), output in ``ct``."""
    return torch.matmul(a.to(ct), w.to(ct))


def aggregate_first(in_dim: int, out_dim: int, block_diag: bool = False) -> bool:
    """GCN's schedule: aggregate before projecting when that is cheaper.
    ``A(XW) == (AX)W`` exactly.  On the condensed route the gather costs per
    row, so an input no wider than ``max(out_dim, 128)`` is aggregated
    first.  On the block-diagonal route the cost scales with the feature
    width, so the narrower side is aggregated (ties aggregate first).  Kept
    identical to the JAX package off the TPU (whose TPU rule compares
    widths padded to 128 lanes, which the GPU does not pad), so both run the
    same schedule."""
    if block_diag:
        return in_dim <= out_dim
    return in_dim <= max(out_dim, 128)


def gcn_conv(
    weights: torch.Tensor,
    x: torch.Tensor,
    graph: TiledGraph,
    norm: torch.Tensor | None = None,
) -> torch.Tensor:
    """GEMM node update and SpMM neighbour aggregation.

    ``norm`` is an optional per-node ``deg^-1/2`` vector: applied before and
    after aggregation it gives symmetric GCN normalization
    ``D^-1/2 A D^-1/2``.
    """
    in_dim, out_dim = weights.shape
    ct = _ct(graph)
    x = x.to(ct)
    nv = None if norm is None else norm.to(ct)
    if aggregate_first(in_dim, out_dim, getattr(graph, "block_diag", False)):
        h = x if nv is None else x * nv[: x.shape[0], None]
        agg = graph.spmm(h)
        if nv is not None:
            agg = agg * nv[: agg.shape[0], None].to(agg.dtype)
        return _amp_dot(agg, weights, ct)
    x_prime = _amp_dot(x, weights, ct)
    if nv is not None:
        x_prime = x_prime * nv[: x_prime.shape[0], None]
    out = graph.spmm(x_prime)
    if nv is not None:
        out = out * nv[: out.shape[0], None].to(out.dtype)
    return out


def gin_conv(weights: torch.Tensor, x: torch.Tensor, graph: TiledGraph) -> torch.Tensor:
    """SpMM aggregation first, then GEMM update."""
    ct = _ct(graph)
    return _amp_dot(graph.spmm(x.to(ct)), weights, ct)


def _uniform(generator: torch.Generator, shape, out_dim: int) -> torch.Tensor:
    """Uniform on ``±1/sqrt(out_dim)``, drawn from ``generator``."""
    stdv = 1.0 / math.sqrt(out_dim)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2 * stdv) - stdv


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                init: str = "reference") -> torch.Tensor:
    """A GCN or GIN layer's ``[in, out]`` weights (the JAX ``init_linear``):
    ``reference`` is plain randn, as the reference's layers leave them;
    ``uniform`` is uniform on ``±1/sqrt(out_dim)``, the reference's unused
    ``reset_parameters`` (accuracy parity trains from it)."""
    if init == "uniform":
        return _uniform(generator, (in_dim, out_dim), out_dim)
    return torch.randn((in_dim, out_dim), generator=generator, device=generator.device)


def init_agnn(generator: torch.Generator, in_dim: int, out_dim: int, n_heads: int = 1):
    """AGNN parameters, uniform on ``±1/sqrt(out_dim)`` (the JAX
    ``init_agnn``): ``weights [in, out]`` and ``attention_w [1, n_heads]``,
    drawn from ``generator`` in that order."""
    return {"weights": _uniform(generator, (in_dim, out_dim), out_dim),
            "attention_w": _uniform(generator, (1, n_heads), out_dim)}


def agnn_conv(
    weights: torch.Tensor, attention_w: torch.Tensor, x: torch.Tensor, graph: TiledGraph
) -> torch.Tensor:
    """Projection, edge scores, per-head attention, weighted aggregation.

    Attention is ``att_e^h = c_h * e_e`` with ``e = <x'_i, x'_j>``, so the
    head-averaged output is ``mean(c) * (A ⊙ S) x'``: on a graph with
    ``agnn_aggregate`` (symmetric) that is one score-fused pass for any head
    count.  Otherwise the reference schedule: scores once, one weighted SpMM
    per head, then the head average.
    """
    x_prime = _amp_dot(x, weights, _ct(graph))
    fused = getattr(graph, "agnn_aggregate", None)
    if fused is not None:
        return fused(x_prime, attention_w)
    n_heads = attention_w.shape[1]
    edge_feature = graph.sddmm(x_prime)  # [E] f32
    edge_attentions = edge_feature[:, None] * attention_w  # [E, n_heads]
    out = graph.spmm_weighted(x_prime, edge_attentions[:, 0])
    for h in range(1, n_heads):
        out = out + graph.spmm_weighted(x_prime, edge_attentions[:, h])
    return out / n_heads


def sag(x: torch.Tensor, graph: TiledGraph) -> torch.Tensor:
    """Pure scatter-and-gather aggregation."""
    return graph.spmm(x)
