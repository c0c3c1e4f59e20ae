"""Full-graph training over the ``('graph', 'feature')`` mesh (PyTorch port
of ``tcgnn_tpu.parallel.train``).

Node features, labels and norms are globally shaped and padded to
``graph.padded_nodes``; the parameters are whole (one copy: every shard is
on one device, so no gradient all-reduce runs).  Padding conventions, as in
JAX:

* the NLL is summed over real nodes and divided by their count;
* hidden and class widths are rounded up to a multiple of the ``feature``
  axis; padded logit columns are set to ``-1e30`` before the log-softmax
  (``GNN.forward``'s ``num_valid_classes``), so the loss is the unpadded
  model's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tcgnn_tpu_torch.models import nets
from tcgnn_tpu_torch.parallel.graph import DistributedTiledGraph, _round_up


def init_distributed_net(
    generator: torch.Generator,
    kind: str,
    in_dim: int,
    hidden: int,
    classes: int,
    num_layers: int,
    graph: DistributedTiledGraph,
    n_heads: int = 1,
):
    """A ``GNN`` at the mesh's padded widths: input ``graph.shard_features``'
    width of ``in_dim`` features, hidden and classes rounded up to a
    multiple of ``pf``.  Returns ``(net, padded_hidden, padded_classes)``.

    The weights are ``nets.init_net``'s draws at the unpadded widths, zero
    padded, so the mesh trains the same model as one device from the same
    generator (the padded units stay zero: their inputs and gradients are
    zero).  JAX draws at the padded widths from its own generator; the
    parity tests load JAX's parameters instead (``GNN.params_from_jax``).
    """
    pf = graph.pf
    d_in = graph.feature_width(in_dim)
    hidden_p, classes_p = _round_up(hidden, pf), _round_up(classes, pf)
    base = nets.init_net(generator, kind, in_dim, hidden, classes, num_layers,
                         device=graph.device, n_heads=n_heads)
    dims = [d_in] + [hidden_p] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes_p]
    net = nets.GNN(kind, dims, device=graph.device, n_heads=n_heads)
    with torch.no_grad():
        for dst, src in zip(net.weights, base.weights):
            dst.zero_()
            dst[: src.shape[0], : src.shape[1]] = src
        for dst, src in zip(net.attention_w, base.attention_w):
            dst.copy_(src)
    return net, hidden_p, classes_p


def make_distributed_train_step(
    graph: DistributedTiledGraph,
    net: nets.GNN,
    x: torch.Tensor,
    y: torch.Tensor,
    optimizer: torch.optim.Optimizer,
    dropout_rate: float = 0.5,
    num_valid_classes: Optional[int] = None,
    norm: Optional[torch.Tensor] = None,
    hoist: bool = True,
    generator: Optional[torch.Generator] = None,
):
    """One full-batch epoch per call on the mesh: forward, the masked NLL,
    Adam.  Returns the epoch's loss (before the update) as a device tensor.

    ``x`` comes from ``graph.shard_features``, ``y`` (int labels, padded
    entries arbitrary) and ``norm`` (padded entries 0) from
    ``graph.shard_nodes``.  ``hoist`` computes the layer-1 aggregate once
    (exact for GCN and GIN); ``generator`` draws the dropout masks.
    """
    mask = graph.valid_node_mask()
    y = y.long()
    l1_agg = nets.hoist_l1_aggregate(net.kind, x, graph, norm=norm) if hoist else None
    gen = generator if dropout_rate > 0 else None

    def step() -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        logp = net(x, graph, dropout_generator=gen, dropout_rate=dropout_rate, norm=norm,
                   l1_agg=l1_agg, num_valid_classes=num_valid_classes)
        nll = F.nll_loss(logp, y, reduction="none")
        loss = torch.sum(nll * mask) / graph.num_nodes
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
