"""Full-graph training over the ``('graph', 'feature')`` mesh (PyTorch port
of ``tcgnn_tpu.parallel.train``).

Node features, labels and norms are padded to ``graph.padded_nodes`` rows
and cut to the rows this process holds (``graph.node_rows``: all of them in
one process).  Every process holds the whole parameters, drawn from the
same seed, as JAX replicates them.  In one process they have one copy and
no gradient all-reduce runs; over processes (``parallel/mesh.py``) each
rank's loss is its rows' NLL sum over the global node count, and after the
backward one ``all_reduce`` sums every parameter's gradient and the loss,
flattened into one bucket (``collectives.all_reduce_bucket``, JAX's one
gradient all-reduce, which also carries its loss), so every rank steps Adam
identically.  Where the ranks split the feature axis, the ranks of one
graph block hold the same rows' loss (the logits are all-gathered over
``feature`` first): feature rank 0 alone puts it in the bucket, so it
counts once, and every gradient a rank holds is its part (column-parallel
products, ``DistributedTiledGraph.feature_dot``).  Padding conventions, as
in JAX:

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

from tcgnn_tpu_torch import train as T
from tcgnn_tpu_torch.models import nets
from tcgnn_tpu_torch.parallel import collectives as C
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
) -> T.TrainStep:
    """The mesh's training step, a ``train.TrainStep``: each call is one
    full-batch epoch on the mesh (forward, the masked NLL, Adam) and returns
    the epoch's loss (before the update) as a device tensor; ``many(n)``
    runs n epochs.

    ``x`` comes from ``graph.shard_features``, ``y`` (int labels, padded
    entries arbitrary) and ``norm`` (padded entries 0) from
    ``graph.shard_nodes``.  ``hoist`` computes the layer-1 aggregate once
    (exact for GCN and GIN); ``generator`` draws the dropout masks (over
    the global rows: ``GNN.forward``).  The forward and backward run inside
    ``graph.shared_exchanges``, so the step moves what the compiled JAX step
    moves.  Over processes the returned loss is the all-reduced one.

    In one process on the card, ``many`` captures the whole step (the
    exchanges, every shard's kernels, the loss and Adam, which must be
    ``train.make_optimizer``'s) into one CUDA graph and replays it, as JAX
    runs its step as one compiled program.  Over processes the step is
    ``eager``: its transfers go through ``torch.distributed``, which gloo
    stages through host memory, and a capture cannot hold them (a captured
    step a rank over NCCL is ROADMAP item 8c-iv).
    """
    mask = graph.valid_node_mask()
    y = y.long()
    l1_agg = nets.hoist_l1_aggregate(net.kind, x, graph, norm=norm) if hoist else None
    gen = generator if dropout_rate > 0 else None
    mesh = graph.mesh
    params = list(net.parameters())

    def step() -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with graph.shared_exchanges():
            logp = net(x, graph, dropout_generator=gen, dropout_rate=dropout_rate, norm=norm,
                       l1_agg=l1_agg, num_valid_classes=num_valid_classes)
            nll = F.nll_loss(logp, y, reduction="none")
            loss = torch.sum(nll * mask) / graph.num_nodes
            loss.backward()
            loss = loss.detach()
            if mesh.world > 1:
                for p in params:  # the bucket holds every parameter
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                loss = loss.reshape(1)
                if mesh.feature_rank:  # the feature group's loss counts once
                    loss = torch.zeros_like(loss)
                C.all_reduce_bucket([p.grad for p in params] + [loss], mesh)
                loss = loss[0]
        optimizer.step()
        return loss

    return T.TrainStep(step, params, optimizer, gen, graph.device, eager=mesh.world > 1)
