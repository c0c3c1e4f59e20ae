"""Model stacks (PyTorch port of ``tcgnn_tpu.models.nets``).

For L = num_layers the stack is

    conv_in(features -> hidden) -> relu -> dropout
    (L-2) x [conv(hidden -> hidden) -> relu]
    conv_out(hidden -> classes) -> log_softmax (in f32)

``GNN.forward`` is the counterpart of ``apply_net``: the same order, with
the dropout mask drawn from a ``torch.Generator`` (dropout is active only
when one is given).  Each layer's weights are an ``[in, out]`` parameter,
the JAX layout, so ``params_from_jax`` can load JAX parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import layers as L

MODEL_KINDS = ("gcn", "gin")


class GNN(nn.Module):
    """A GCN or GIN stack; ``weights[i]`` is layer i's ``[in, out]`` matrix."""

    def __init__(self, kind: str, dims: List[int], device=None):
        super().__init__()
        if kind not in MODEL_KINDS:
            raise NotImplementedError(
                f"model {kind!r} is not ported yet (ROADMAP.md, Queue 1 item 3: AGNN)"
                if kind == "agnn"
                else f"model must be one of {MODEL_KINDS}, got {kind!r}"
            )
        self.kind = kind
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(d_in, d_out, device=device))
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )

    def _conv(self, weights, x, graph, norm):
        if self.kind == "gcn":
            return L.gcn_conv(weights, x, graph, norm=norm)
        return L.gin_conv(weights, x, graph)

    def forward(
        self,
        x: torch.Tensor,
        graph: TiledGraph,
        dropout_generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.5,
        norm: Optional[torch.Tensor] = None,
        l1_agg: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Log-probabilities ``[N, classes]`` in f32.

        ``l1_agg`` is the hoisted layer-1 aggregate (``hoist_l1_aggregate``):
        with constant input features and dropout after layer 1, GCN's
        ``A(XW) == (AX)W`` and GIN's ``(AX)W`` both factor through ``A X``,
        so computing it once is exact.
        """
        first = self.weights[0]
        if l1_agg is not None:
            h = torch.relu(L._amp_dot(l1_agg, first, L._ct(graph)))
        else:
            h = torch.relu(self._conv(first, x, graph, norm))
        if dropout_generator is not None:
            keep = 1.0 - dropout_rate
            mask = torch.rand(h.shape, generator=dropout_generator, device=h.device) < keep
            h = torch.where(mask, h * (1.0 / keep), 0.0)
        for w in self.weights[1:-1]:
            h = torch.relu(self._conv(w, h, graph, norm))
        h = self._conv(self.weights[-1], h, graph, norm)
        return torch.log_softmax(h.float(), dim=1)

    @torch.no_grad()
    def params_from_jax(self, params: List[Dict[str, np.ndarray]]) -> None:
        """Load JAX parameters (a list of ``{"weights": [in, out]}`` dicts,
        converted to numpy) into the module."""
        if len(params) != len(self.weights):
            raise ValueError(f"{len(params)} parameter sets for {len(self.weights)} layers")
        for weights, p in zip(self.weights, params):
            w = torch.tensor(np.asarray(p["weights"], np.float32))
            if w.shape != weights.shape:
                raise ValueError(f"weights {tuple(w.shape)}, expected {tuple(weights.shape)}")
            weights.copy_(w)


def init_net(
    generator: torch.Generator,
    kind: str,
    in_dim: int,
    hidden: int,
    classes: int,
    num_layers: int,
    device=None,
) -> GNN:
    """A GNN with plain randn weights (the reference init), drawn from
    ``generator`` on its own device and then moved to ``device``."""
    dims = [in_dim] + [hidden] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes]
    net = GNN(kind, dims, device=device)
    with torch.no_grad():
        for weights in net.weights:
            weights.copy_(torch.randn(weights.shape, generator=generator,
                                      device=generator.device))
    return net


def hoist_l1_aggregate(kind: str, x: torch.Tensor, graph: TiledGraph, norm=None):
    """The loop-invariant layer-1 aggregate ``A X`` (or its normalized form
    ``norm * A (norm * X)``) for GCN and GIN."""
    if kind not in MODEL_KINDS:
        return None
    ct = L._ct(graph)
    x = x.to(ct)
    use_norm = kind == "gcn" and norm is not None
    h = x * norm[: x.shape[0], None].to(ct) if use_norm else x
    agg = graph.spmm(h)
    if use_norm:
        agg = agg * norm[: agg.shape[0], None].to(agg.dtype)
    return agg
