"""The plain reference: full-graph GCN and AGNN training in plain PyTorch.

It follows the TC-GNN reference trainer (``main_tcgnn.py``): ReLU and
dropout after the first layer, NLL over all nodes, Adam at the
configuration's learning rate.  It computes in float64 (``DTYPE``), above
the configurations' f32, so that its own rounding stays far below the
program's: an f32 reference summing a hub row's thousands of neighbours in
one accumulator, in atomics' order, strays from the exact result by more
than the port's tiled sums do.  It works
everything out from the CSR adjacency the benchmark made, edge by edge, in
blocks of ``EDGE_BLOCK`` edges so that the largest graph fits beside its
gathers: an aggregation gathers the source rows of a block and adds them
into the destination rows (``index_add_``); AGNN's score of an edge is the
dot product of its two end rows.  Its backward passes are written out
(``_Aggregate``, ``_Attention``) so that each runs in the same blocks.

It imports nothing of the program: the weights (``make_weights``) and the
dropout masks (a ``torch.Generator`` seeded as the program's) are drawn
here from the seed, and the benchmark hands the same CSR, features and
labels to both sides.
"""

from __future__ import annotations

import dataclasses
import math

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


class _Aggregate(torch.autograd.Function):
    """``A @ x``; backward ``A^T @ dy``."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return graph.spmm(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.graph.spmm(dy, transpose=True), None


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


def make_weights(config: dict, dims: list, seed: int, device) -> dict:
    """The initial parameters, drawn on ``device`` from ``seed``: GCN's plain
    randn ``[in, out]`` weights (the reference's layers leave them so); AGNN's
    uniform on ``+-1/sqrt(out)``, weights and then the ``[1, n_heads]``
    attention weights a layer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        if config["model"] == "gcn":
            out[f"weights.{i}"] = torch.randn((a, b), generator=gen, device=device)
            continue
        stdv = 1.0 / math.sqrt(b)
        for name, shape in ((f"weights.{i}", (a, b)),
                            (f"attention_w.{i}", (1, int(config["n_heads"])))):
            u = torch.rand(shape, generator=gen, device=device)
            out[name] = u * (2 * stdv) - stdv
    return out


def _gcn_layer(h, w, graph):
    """GCN at the narrower width: ``(A h) W`` or ``A (h W)``."""
    a, b = w.shape
    return _Aggregate.apply(h, graph) @ w if a <= b else _Aggregate.apply(h @ w, graph)


def forward(config: dict, p: dict, x, graph: Graph, mask, agg_x=None):
    """Log-probabilities ``[N, classes]``; ``mask`` keeps the first layer's
    outputs (dropout), ``agg_x`` is ``A @ x`` for GCN."""
    layers = int(config["num_layers"])
    keep = 1.0 - float(config["dropout"])

    def layer(i, h):
        w = p[f"weights.{i}"]
        if config["model"] == "gcn":
            return agg_x @ w if i == 0 else _gcn_layer(h, w, graph)
        return _Attention.apply(h @ w, p[f"attention_w.{i}"].mean(), graph)

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


def train(config: dict, params: dict, x, y, graph: Graph, dropout_seed: int, steps: int,
          dtype: torch.dtype = DTYPE) -> Readings:
    """``steps`` full-batch Adam steps from ``params`` (left unchanged), in
    ``dtype``."""
    device = x.device
    x = x.to(dtype)
    params = {k: v.detach().to(dtype) for k, v in params.items()}
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    names = list(p)
    rate = float(config["dropout"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed) if rate > 0 else None
    agg_x = graph.spmm(x) if config["model"] == "gcn" else None
    lr, (b1, b2) = float(config["lr"]), ADAM_BETAS
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], {}
    hidden = int(config["hidden"])
    for t in range(1, steps + 1):
        mask = None
        if gen is not None:
            mask = torch.rand((graph.num_nodes, hidden), generator=gen,
                              device=device) < 1.0 - rate
        loss = F.nll_loss(forward(config, p, x, graph, mask, agg_x), y)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
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
