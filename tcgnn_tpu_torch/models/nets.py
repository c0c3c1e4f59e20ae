"""Model stacks (PyTorch port of ``tcgnn_tpu.models.nets``).

For L = num_layers the stack is

    conv_in(features -> hidden) -> relu -> dropout
    (L-2) x [conv(hidden -> hidden) -> relu]
    conv_out(hidden -> classes) -> log_softmax (in f32)

``GNN.forward`` is the counterpart of ``apply_net``: the same order, with
the dropout mask drawn from a ``torch.Generator`` (dropout is active only
when one is given).  Each layer's weights are an ``[in, out]`` parameter,
the JAX layout, and an AGNN layer's attention weights ``[1, n_heads]``, so
``params_from_jax`` can load JAX parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import layers as L

MODEL_KINDS = ("gcn", "gin", "agnn")
INITS = ("reference", "uniform")


class GNN(nn.Module):
    """A GCN, GIN or AGNN stack; ``weights[i]`` is layer i's ``[in, out]``
    matrix, and for AGNN ``attention_w[i]`` its ``[1, n_heads]`` attention
    weights."""

    def __init__(self, kind: str, dims: List[int], device=None, n_heads: int = 1):
        super().__init__()
        if kind not in MODEL_KINDS:
            raise ValueError(f"model must be one of {MODEL_KINDS}, got {kind!r}")
        self.kind = kind
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(d_in, d_out, device=device))
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )
        self.attention_w = nn.ParameterList(
            nn.Parameter(torch.empty(1, n_heads, device=device))
            for _ in (self.weights if kind == "agnn" else ())
        )

    def _conv(self, i, x, graph, norm):
        if self.kind == "agnn":
            return L.agnn_conv(self.weights[i], self.attention_w[i], x, graph)
        if self.kind == "gcn":
            return L.gcn_conv(self.weights[i], x, graph, norm=norm)
        return L.gin_conv(self.weights[i], x, graph)

    def forward(
        self,
        x: torch.Tensor,
        graph: TiledGraph,
        dropout_generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.5,
        norm: Optional[torch.Tensor] = None,
        l1_agg: Optional[torch.Tensor] = None,
        num_valid_classes: Optional[int] = None,
    ) -> torch.Tensor:
        """Log-probabilities ``[N, classes]`` in f32.

        ``num_valid_classes`` sets the logit columns from it on to ``-1e30``
        before the log-softmax: the distributed trainer pads the class width
        to a multiple of the feature axis, and the padded classes must take
        no probability.

        ``l1_agg`` is the hoisted layer-1 aggregate (``hoist_l1_aggregate``):
        with constant input features and dropout after layer 1, GCN's
        ``A(XW) == (AX)W`` and GIN's ``(AX)W`` both factor through ``A X``,
        so computing it once is exact.  AGNN's attention depends on the
        weights, so it has none.
        """
        if l1_agg is not None and self.kind in ("gcn", "gin"):
            h = torch.relu(L._amp_dot(l1_agg, self.weights[0], L._ct(graph)))
        else:
            h = torch.relu(self._conv(0, x, graph, norm))
        if dropout_generator is not None:
            keep = 1.0 - dropout_rate
            mask = torch.rand(h.shape, generator=dropout_generator, device=h.device) < keep
            h = torch.where(mask, h * (1.0 / keep), 0.0)
        last = len(self.weights) - 1
        for i in range(1, last):
            h = torch.relu(self._conv(i, h, graph, norm))
        h = self._conv(last, h, graph, norm)
        if num_valid_classes is not None and num_valid_classes < h.shape[1]:
            col = torch.arange(h.shape[1], device=h.device)[None, :]
            h = torch.where(col < num_valid_classes, h, -1e30)
        return torch.log_softmax(h.float(), dim=1)

    @torch.no_grad()
    def params_from_jax(self, params: List[Dict[str, np.ndarray]]) -> None:
        """Load JAX parameters (a list of ``{"weights": [in, out]}`` dicts,
        with ``"attention_w": [1, n_heads]`` for AGNN, converted to numpy)
        into the module."""
        if len(params) != len(self.weights):
            raise ValueError(f"{len(params)} parameter sets for {len(self.weights)} layers")
        for i, p in enumerate(params):
            names = ["weights"] + (["attention_w"] if self.kind == "agnn" else [])
            for name in names:
                dst = getattr(self, name)[i]
                src = torch.tensor(np.asarray(p[name], np.float32))
                if src.shape != dst.shape:
                    raise ValueError(f"{name} {tuple(src.shape)}, expected {tuple(dst.shape)}")
                dst.copy_(src)


def init_net(
    generator: torch.Generator,
    kind: str,
    in_dim: int,
    hidden: int,
    classes: int,
    num_layers: int,
    device=None,
    n_heads: int = 1,
    init: str = "reference",
) -> GNN:
    """A GNN drawn from ``generator`` on its own device, then moved to
    ``device``, layer by layer: for GCN and GIN plain randn weights
    (``init="reference"``, the reference init) or ``init_linear``'s uniform
    ones (``init="uniform"``); for AGNN always ``init_agnn``'s uniform
    weights."""
    if init not in INITS:
        raise ValueError(f"init must be one of {INITS}, got {init!r}")
    dims = [in_dim] + [hidden] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes]
    net = GNN(kind, dims, device=device, n_heads=n_heads)
    with torch.no_grad():
        for i, weights in enumerate(net.weights):
            if kind == "agnn":
                p = L.init_agnn(generator, *weights.shape, n_heads)
                weights.copy_(p["weights"])
                net.attention_w[i].copy_(p["attention_w"])
            else:
                weights.copy_(L.init_linear(generator, *weights.shape, init))
    return net


def hoist_l1_aggregate(kind: str, x: torch.Tensor, graph: TiledGraph, norm=None):
    """The loop-invariant layer-1 aggregate ``A X`` (or its normalized form
    ``norm * A (norm * X)``) for GCN and GIN; ``None`` for AGNN, whose first
    aggregation depends on its parameters."""
    if kind not in ("gcn", "gin"):
        return None
    ct = L._ct(graph)
    x = x.to(ct)
    use_norm = kind == "gcn" and norm is not None
    h = x * norm[: x.shape[0], None].to(ct) if use_norm else x
    agg = graph.spmm(h)
    if use_norm:
        agg = agg * norm[: agg.shape[0], None].to(agg.dtype)
    return agg
