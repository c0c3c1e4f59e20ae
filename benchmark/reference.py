"""The plain reference: full-graph training in plain PyTorch, the part every model shares.

A model's own reference lives in ``models/<model>.py`` (``spec.model``):
its weights, its forward pass and written-out backward passes, its dropout
masks.  This file holds what they share: the graph (``Graph``), TC-GNN's
layer stack (``stack_dims``, ``stack_masks``, ``stack_forward``: the
reference trainer ``main_tcgnn.py``'s ReLU and dropout after the first
layer and log-softmax at the end), and the training loop (``train``): NLL
over all nodes and Adam at the configuration's learning rate.

It computes in float64 (``DTYPE``), above the configurations' f32, so that
its own rounding stays far below the program's: an f32 reference summing a
hub row's thousands of neighbours in one accumulator, in atomics' order,
strays from the exact result by more than the port's tiled sums do.  It
works everything out from the CSR adjacency the benchmark made, edge by
edge, in blocks of ``EDGE_BLOCK`` edges so that the largest graph fits
beside its gathers: an aggregation gathers the source rows of a block and
adds them into the destination rows (``index_add_``).

It imports nothing of the program: the weights (the model's
``make_weights``) and the dropout masks (a ``torch.Generator`` seeded as the
program's) are drawn from the seed, and the benchmark hands the same CSR,
features and labels to both sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

EDGE_BLOCK = 1 << 23
DTYPE = torch.float64
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Graph:
    """The CSR adjacency as per-edge (row, column) ids on a device."""

    def __init__(self, row_pointers: np.ndarray, column_index: np.ndarray, device):
        ptr = torch.from_numpy(np.asarray(row_pointers, np.int64)).to(device)
        self.num_nodes = int(ptr.numel() - 1)
        self.cols = torch.from_numpy(np.asarray(column_index, np.int64)).to(device)
        self.rows = torch.repeat_interleave(
            torch.arange(self.num_nodes, device=device), ptr[1:] - ptr[:-1])

    def blocks(self):
        """``(rows, cols)`` of each block of edges."""
        for s in range(0, self.cols.numel(), EDGE_BLOCK):
            yield self.rows[s:s + EDGE_BLOCK], self.cols[s:s + EDGE_BLOCK]

    def spmm(self, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """``A @ x``, or ``A^T @ x``."""
        out = torch.zeros(self.num_nodes, x.shape[1], dtype=x.dtype, device=x.device)
        for r, c in self.blocks():
            src, dst = (r, c) if transpose else (c, r)
            out.index_add_(0, dst, x.index_select(0, src))
        return out


def stack_dims(config: dict, traffic: dict) -> list:
    """Layer widths: input features, ``num_layers - 1`` hidden, classes."""
    layers = int(config["num_layers"])
    return [int(traffic["features"])] + [int(config["hidden"])] * (layers - 1) + [
        int(traffic["classes"])]


def stack_masks(config: dict, num_nodes: int, generator: torch.Generator, device):
    """One step's dropout mask, the ``(N, hidden)`` elements the first
    layer's output keeps, drawn as the port's ``nets.GNN`` draws it."""
    return torch.rand((num_nodes, int(config["hidden"])), generator=generator,
                      device=device) < 1.0 - float(config["dropout"])


def stack_forward(config: dict, layer, x, mask):
    """Log-probabilities ``[N, classes]`` of TC-GNN's stack over
    ``layer(i, h)``, layer i's output before its activation; ``mask`` keeps
    the first layer's outputs (dropout), None without dropout."""
    layers = int(config["num_layers"])
    keep = 1.0 - float(config["dropout"])
    h = torch.relu(layer(0, x))
    if mask is not None:
        h = torch.where(mask, h * (1.0 / keep), 0.0)
    for i in range(1, layers - 1):
        h = torch.relu(layer(i, h))
    return torch.log_softmax(layer(layers - 1, h), dim=1)


@dataclasses.dataclass
class Readings:
    """What a run of the first steps gives: each step's loss, each leaf's
    first gradient and each leaf's change after the steps (float64 tensors
    on the host)."""

    losses: list
    grad: dict
    change: dict


def train(config: dict, model, params: dict, x, y, graph: Graph, dropout_seed: int,
          steps: int, dtype: torch.dtype = DTYPE) -> Readings:
    """``steps`` full-batch Adam steps of ``model`` (its module,
    ``spec.model``) from ``params`` (left unchanged), in ``dtype``.  The
    configuration's optional ``optimizer`` settings may state a
    ``weight_decay``, added to each gradient as ``torch.optim.Adam`` adds it
    (``g + wd * p``); the first gradient is read after the add, as the
    optimizer gets it."""
    device = x.device
    x = x.to(dtype)
    params = {k: v.detach().to(dtype) for k, v in params.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    names = list(p)
    rate = float(config["dropout"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed) if rate > 0 else None
    fixed = model.prepare(config, x, graph)
    lr, (b1, b2) = float(config["lr"]), ADAM_BETAS
    decay = float(config.get("optimizer", {}).get("weight_decay", 0))
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], {}
    for t in range(1, steps + 1):
        masks = None
        if gen is not None:
            masks = model.dropout_masks(config, graph.num_nodes, gen, device)
        loss = F.nll_loss(model.forward(config, p, x, graph, masks, fixed), y)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        if decay:
            grads = [g.add(p[k].detach(), alpha=decay) for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        if t == 1:
            grad1 = {k: g.detach().cpu() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                p[k] -= lr * m_hat / (v_hat.sqrt() + ADAM_EPS)
    change = {k: (p[k].detach() - params[k]).cpu() for k in names}
    return Readings(losses, grad1, change)
