"""Accuracy-parity harness: the tiled kernels against a dense oracle, end to
end (port of ``tcgnn_tpu.bench.accuracy_parity``).

No real Planetoid ``.npz`` ships in the repository, so the harness runs on
the checked-in golden fixture (``tests/fixtures/golden_tiny.npz``, the
reference's ``.npz`` contract plus labels and masks); a real ``cora.npz``,
``citeseer.npz`` or ``pubmed.npz`` in ``--data_dir`` is preferred the moment
it appears:

    python -m tcgnn_tpu_torch.bench.accuracy_parity [--npz path/to/graph.npz]
        [--models gcn agnn] [--device cuda]

For each model it:
  1. builds the SGT-tiled graph and a dense ``A @ X`` oracle graph
     (``DenseOracleGraph``, a dense torch ``A`` on the device);
  2. checks that the forward logits agree (allclose at 1e-3) on identical
     parameters (``init="uniform"``), covering every layer's aggregation
     composed;
  3. trains both with the same schedule (Adam 0.01, NLL masked to
     ``train_mask``, symmetric GCN normalization) and reports train and test
     accuracy side by side, which must agree within 0.05;
  4. returns the number of failures (the exit code).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


class DenseOracleGraph:
    """Duck-typed oracle: ``TiledGraph``'s op surface over a dense ``A``.

    Small graphs only (it materializes [N, N]); the ground truth the kernel
    paths are judged against.  ``agnn_aggregate`` is None, so AGNN takes the
    SDDMM and the weighted SpMM."""

    agnn_aggregate = None

    def __init__(self, row_pointers, column_index, num_nodes, device="cuda"):
        a = np.zeros((num_nodes, num_nodes), np.float32)
        rows = np.repeat(np.arange(num_nodes), np.diff(np.asarray(row_pointers)))
        np.add.at(a, (rows, np.asarray(column_index)), 1.0)
        self._a = torch.from_numpy(a).to(device)
        self._rows = torch.from_numpy(rows.astype(np.int64)).to(device)
        self._cols = torch.from_numpy(np.asarray(column_index, np.int64)).to(device)
        self.num_nodes = num_nodes
        self.num_edges = len(column_index)

    def spmm(self, x):
        return self._a @ x

    def spmm_weighted(self, x, w):
        aw = torch.zeros_like(self._a).index_put((self._rows, self._cols), w, accumulate=True)
        return aw @ x

    def sddmm(self, x):
        return torch.sum(x[self._rows] * x[self._cols], dim=1)


def init_params(kind, ds, hidden, seed, device):
    from tcgnn_tpu_torch.models import nets

    return nets.init_net(torch.Generator().manual_seed(seed), kind, ds.x.shape[1], hidden,
                         int(ds.y.max()) + 1, 2, device=device, init="uniform")


def run_model(kind, ds, graph, norm, epochs, hidden, device, seed=0):
    """Train ``epochs`` Adam steps on the masked NLL; returns the net, the
    final parameters' loss and the train and test accuracy."""
    net = init_params(kind, ds, hidden, seed, device)
    x = torch.from_numpy(ds.x).to(device)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(device)
    train_mask = torch.from_numpy(ds.train_mask).to(device).float()
    optimizer = torch.optim.Adam(net.parameters(), lr=0.01)

    def loss_fn():
        logp = net(x, graph, norm=norm)
        nll = -logp.gather(1, y[:, None])[:, 0]
        return torch.sum(nll * train_mask) / torch.sum(train_mask)

    for _ in range(epochs):
        optimizer.zero_grad(set_to_none=True)
        loss_fn().backward()
        optimizer.step()
    with torch.no_grad():
        # The loss of the final parameters, the state the accuracies use.
        loss = float(loss_fn())
        pred = net(x, graph, norm=norm).argmax(dim=1).cpu().numpy()
    yy = np.asarray(ds.y)

    def acc(mask):
        m = np.asarray(mask)
        return float((pred[m] == yy[m]).mean()) if m.any() else float("nan")

    return net, loss, acc(ds.train_mask), acc(ds.test_mask)


def main(argv=None):
    p = argparse.ArgumentParser()
    default_npz = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures",
                               "golden_tiny.npz")
    p.add_argument("--npz", default=None)
    p.add_argument(
        "--data_dir", default="tcgnn-ae-graphs/",
        help="scanned for real labeled graphs (cora/citeseer/pubmed .npz with x/y keys); "
        "the first hit is preferred over the golden fixture",
    )
    p.add_argument("--models", nargs="*", default=["gcn", "agnn"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.npz is None:
        for name in ("cora", "citeseer", "pubmed"):
            cand = os.path.join(args.data_dir, name + ".npz")
            if os.path.exists(cand):
                args.npz = cand
                break
        else:
            args.npz = default_npz

    from tcgnn_tpu_torch.data import dataset as data_lib
    from tcgnn_tpu_torch.graph import TiledGraph

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = data_lib.load_npz(args.npz, dim=16, num_classes=2)
    print(f"graph: {ds.num_nodes} nodes, {ds.num_edges} edges, "
          f"dim {ds.x.shape[1]}, classes {int(ds.y.max()) + 1}")
    tiled = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, device=device)
    oracle = DenseOracleGraph(ds.row_pointers, ds.column_index, ds.num_nodes, device=device)
    norm = torch.from_numpy(1.0 / ds.norm_degrees()).to(device)
    x = torch.from_numpy(ds.x).to(device)

    failures = 0
    for kind in args.models:
        # 1) forward logits on identical parameters (every layer composed)
        net = init_params(kind, ds, args.hidden, 7, device)
        use_norm = norm if kind == "gcn" else None
        with torch.no_grad():
            lt = net(x, tiled, norm=use_norm)
            lo = net(x, oracle, norm=use_norm)
        fwd_ok = bool(torch.allclose(lt, lo, rtol=1e-3, atol=1e-3))

        # 2) trained accuracy
        _, loss_t, tr_t, te_t = run_model(kind, ds, tiled, use_norm, args.epochs,
                                          args.hidden, device)
        _, loss_o, tr_o, te_o = run_model(kind, ds, oracle, use_norm, args.epochs,
                                          args.hidden, device)
        acc_ok = abs(te_t - te_o) <= 0.05
        ok = fwd_ok and acc_ok
        failures += 0 if ok else 1
        print(
            f"{kind:5s} fwd_allclose={fwd_ok}  "
            f"tiled: loss={loss_t:.4f} train_acc={tr_t:.3f} test_acc={te_t:.3f}  "
            f"oracle: loss={loss_o:.4f} train_acc={tr_o:.3f} test_acc={te_o:.3f}  "
            f"{'OK' if ok else 'FAIL'}"
        )
    return failures


if __name__ == "__main__":
    sys.exit(main())
