"""Incumbent GNN trainers: torch message passing with no SGT and no kernel
of this package (port of ``tcgnn_tpu.bench.baseline``).

They play the role of the reference's DGL and PyG baselines
(``dgl_baseline/``, ``pyg-baseline/``), which cannot be installed here:
independent implementations of the same models on the same graphs, timed
only as the comparison column of the sweep.  They are library code on
purpose: no kernel of this package stands behind them, and nothing on the
port's training path calls them.  Two incumbents, as in the JAX package:

* ``--impl gather`` (JAX: the XLA gather + ``segment_sum`` graph) —
  ``torch.autograd.Function``s over ``ops/reference.py``'s ``spmm_ref`` /
  ``sddmm_ref`` (a row gather and ``index_add_``), whose backwards walk the
  transposed CSR (``sgt.translate.transpose_csr``), as the JAX custom VJPs
  do;
* ``--impl sparse`` (JAX: ``jax.experimental.sparse`` BCOO) —
  ``torch.sparse.mm`` over a CSR adjacency (ones, or the edge weights as
  its values) and ``torch.sparse.sampled_addmm`` for the SDDMM (cuSPARSE on
  the card).  The SpMM goes through torch's own autograd.  The weighted
  SpMM and the SDDMM have ``torch.autograd.Function``s whose backwards are
  the same two library calls (the SDDMM for the weight gradient, the SpMM
  over the transposed CSR for the feature gradients): torch's own backward
  of ``torch.sparse.mm`` with respect to the CSR values forms a dense N x N
  gradient (DD: 418 GiB on the card).  Nothing takes the gather form.  On
  the CPU ``sampled_addmm`` itself forms the dense N x N product, so there
  this incumbent takes only small graphs.

Both graphs duck-type ``TiledGraph``'s ``spmm`` / ``spmm_weighted`` /
``sddmm`` with ``agnn_aggregate = None`` (AGNN takes the per-edge ops) and
no ``config`` (the layers compute in f32) under the port's own ``GNN``.  The
training loop is the trainer's: ``train.make_train_step`` without the hoist
(``torch.nn.functional.nll_loss`` over all nodes, the library's and not
the port's kernel pair, Adam), 9 warm-up steps, then ``--epochs``
timed under ``torch.cuda.synchronize()`` by ``train.timed_epochs``, on the
card as one CUDA graph of the step replayed an epoch (``step.many``), as
JAX compiles each incumbent's epoch into one program, with the
same output lines (``Prep. (ms)``, ``Final loss``, ``Train (ms)``).  The
first loss (no dropout) equals the trainer's: the same parameters from the
same seed.  The ``sparse`` incumbent's step cannot be captured
(``EAGER_IMPLS``), so it runs one eager step an epoch; ``main`` returns
which it was (``step``: ``replayed`` or ``eager``), and the sweep writes it
beside each row.

Run:  python -m tcgnn_tpu_torch.bench.baseline --dataset pubmed --dim 500 --classes 3 \
          --model gcn --impl sparse
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from tcgnn_tpu_torch import train
from tcgnn_tpu_torch.models import nets
from tcgnn_tpu_torch.ops.reference import edge_rows_from_csr, sddmm_ref, spmm_ref
from tcgnn_tpu_torch.sgt.translate import transpose_csr


class _GatherSpMM(torch.autograd.Function):
    """``A @ x``; backward ``A^T @ dy`` over the transposed CSR."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return spmm_ref(x, g.ptr, g.idx)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        return spmm_ref(dy, g.tptr, g.tidx), None


class _GatherSpMMWeighted(torch.autograd.Function):
    """``(A ⊙ w) @ x``; backward ``dx`` over the transposed CSR with
    ``w[tsrc]``, ``dw_e = <dy[row_e], x[col_e]>``."""

    @staticmethod
    def forward(ctx, x, w, g):
        ctx.g = g
        ctx.save_for_backward(x, w)
        return spmm_ref(x, g.ptr, g.idx, edge_weights=w)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        x, w = ctx.saved_tensors
        dx = spmm_ref(dy, g.tptr, g.tidx, edge_weights=w[g.tsrc])
        dw = torch.sum(dy[g.rows] * x[g.idx], dim=-1)
        return dx, dw, None


class _GatherSDDMM(torch.autograd.Function):
    """``e = <x[row_e], x[col_e]>``; backward the two weighted SpMMs, over
    the CSR and its transpose."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        ctx.save_for_backward(x)
        return sddmm_ref(x, g.ptr, g.idx)

    @staticmethod
    def backward(ctx, de):
        g = ctx.g
        (x,) = ctx.saved_tensors
        d_rows = spmm_ref(x, g.ptr, g.idx, edge_weights=de)
        d_cols = spmm_ref(x, g.tptr, g.tidx, edge_weights=de[g.tsrc])
        return d_rows + d_cols, None


class GatherBaselineGraph:
    """``TiledGraph``'s op surface over a row gather and ``index_add_``
    (JAX: ``XlaBaselineGraph``)."""

    agnn_aggregate = None

    def __init__(self, row_pointers, column_index, num_nodes, device="cuda"):
        self.num_nodes = int(num_nodes)
        self.num_edges = int(len(column_index))

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        t_ptr, t_idx, t_src = transpose_csr(
            np.asarray(row_pointers), np.asarray(column_index), self.num_nodes)
        self.ptr, self.idx = dev(row_pointers), dev(column_index)
        self.tptr, self.tidx, self.tsrc = dev(t_ptr), dev(t_idx), dev(t_src)
        self.rows = edge_rows_from_csr(self.ptr, self.num_edges)

    def spmm(self, x):
        return _GatherSpMM.apply(x, self)

    def spmm_weighted(self, x, w):
        return _GatherSpMMWeighted.apply(x, w, self)

    def sddmm(self, x):
        return _GatherSDDMM.apply(x, self)


class _SparseSpMMWeighted(torch.autograd.Function):
    """``(A ⊙ w) @ x`` by ``torch.sparse.mm``; backward ``dx`` by
    ``torch.sparse.mm`` over the transposed CSR with ``w[tsrc]``, ``dw`` by
    ``torch.sparse.sampled_addmm`` (``dw_e = <dy[row_e], x[col_e]>``).
    torch's own backward of ``torch.sparse.mm`` with respect to the CSR
    values forms the dense N x N gradient (DD: 418 GiB on the card)."""

    @staticmethod
    def forward(ctx, x, w, g):
        ctx.g = g
        ctx.save_for_backward(x, w)
        return torch.sparse.mm(g.csr(w), x)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        x, w = ctx.saved_tensors
        dx = torch.sparse.mm(g.csr_t(w[g.tsrc]), dy)
        return dx, g.sampled(dy, x), None


class _SparseSDDMM(torch.autograd.Function):
    """``e = <x[row_e], x[col_e]>`` by ``torch.sparse.sampled_addmm``;
    backward ``dx = (A ⊙ de) @ x + (A ⊙ de)^T @ x`` by ``torch.sparse.mm``
    over the CSR and its transpose."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        ctx.save_for_backward(x)
        return g.sampled(x, x)

    @staticmethod
    def backward(ctx, de):
        g = ctx.g
        (x,) = ctx.saved_tensors
        return torch.sparse.mm(g.csr(de), x) + torch.sparse.mm(g.csr_t(de[g.tsrc]), x), None


class SparseBaselineGraph:
    """``TiledGraph``'s op surface over ``torch.sparse`` CSR products
    (JAX: ``BcooBaselineGraph``)."""

    agnn_aggregate = None

    def __init__(self, row_pointers, column_index, num_nodes, device="cuda"):
        self.num_nodes = int(num_nodes)
        self.num_edges = e = int(len(column_index))

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        t_ptr, t_idx, t_src = transpose_csr(
            np.asarray(row_pointers), np.asarray(column_index), self.num_nodes)
        self.ptr, self.idx = dev(row_pointers), dev(column_index)
        self.tptr, self.tidx, self.tsrc = dev(t_ptr), dev(t_idx), dev(t_src)
        self._a = self.csr(torch.ones(e, device=device))
        self._pattern = self.csr(torch.zeros(e, device=device))

    def _sparse(self, ptr, idx, values):
        return torch.sparse_csr_tensor(ptr, idx, values, size=(self.num_nodes, self.num_nodes))

    def csr(self, values):
        """``A`` with ``values`` an edge, in CSR order."""
        return self._sparse(self.ptr, self.idx, values)

    def csr_t(self, values):
        """``A^T`` with ``values`` an edge, in the transpose's CSR order."""
        return self._sparse(self.tptr, self.tidx, values)

    def sampled(self, xa, xb):
        """Per-edge ``<xa[row_e], xb[col_e]>`` in CSR order."""
        return torch.sparse.sampled_addmm(self._pattern, xa, xb.t(), beta=0.0).values()

    def spmm(self, x):
        return torch.sparse.mm(self._a, x)

    def spmm_weighted(self, x, w):
        return _SparseSpMMWeighted.apply(x, w, self)

    def sddmm(self, x):
        return _SparseSDDMM.apply(x, self)


IMPLS = {"gather": GatherBaselineGraph, "sparse": SparseBaselineGraph}
# Incumbents whose step cannot be captured into a CUDA graph: the backward
# of ``torch.sparse.mm`` (torch's own, over the CSR adjacency) copies from
# an unpinned host tensor, which a capture refuses (on an H100 with torch
# 2.11: "Cannot copy between CPU and CUDA tensors during CUDA graph capture
# unless the CPU tensor is pinned").  Their epochs stay eager.
EAGER_IMPLS = ("sparse",)


def main(argv=None) -> dict:
    p = train.build_argparser()
    p.add_argument("--impl", default="gather", choices=sorted(IMPLS))
    args = p.parse_args(argv)
    print(args)
    if args.mesh or args.single_kernel or args.checkpoint_dir:
        raise ValueError("the incumbents train on one device: no --mesh, --single_kernel "
                         "or --checkpoint_dir")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ds = train.load_dataset(args)
    start = time.perf_counter()
    graph = IMPLS[args.impl](ds.row_pointers, ds.column_index, ds.num_nodes, device=device)
    sync()
    prep = time.perf_counter() - start
    print("Prep. (ms):\t{:.3f}".format(prep * 1e3))

    x = torch.from_numpy(ds.x).to(device)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(device)
    net = nets.init_net(
        torch.Generator().manual_seed(args.seed), args.model, ds.num_features,
        args.hidden, ds.num_classes, args.num_layers, device=device, n_heads=args.n_heads,
    )
    optimizer = train.make_optimizer(net.parameters(), args.lr, device)
    norm = torch.from_numpy(1.0 / ds.norm_degrees()).to(device) if args.gcn_norm else None
    step = train.make_train_step(
        graph, net, x, y, optimizer, 0.0 if args.no_dropout else args.dropout, norm=norm,
        hoist=False, generator=torch.Generator(device=device).manual_seed(args.seed + 1),
        eager=args.impl in EAGER_IMPLS, loss_fn=F.nll_loss,
    )
    first_loss, final_loss, train_ms, _ = train.timed_epochs(step, args, device, sync)
    return {"impl": args.impl, "prep_ms": prep * 1e3, "first_loss": first_loss,
            "final_loss": final_loss, "train_ms": train_ms,
            "step": "replayed" if step.captures else "eager"}


if __name__ == "__main__":
    main()
