"""Graph dataset loading (NumPy host code, counterpart of ``tcgnn_tpu.data.dataset``).

Carried over from the JAX package with its semantics unchanged, because
importing that package loads JAX.  ``tests/test_torch_sgt.py`` holds the two
copies to identical output.

* ``.npz`` files with keys ``src_li``, ``dst_li``, ``num_nodes``;
* two-ints-per-line ``.txt`` edge lists;
* CSR built from the COO edge list, duplicate edges kept;
* synthetic features ``randn(N, dim)`` and all-ones labels unless real ones
  are supplied;
* masks: train = first 100%, val 30%, test 10% of nodes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Build CSR (indptr, indices) from a COO edge list.

    Row = src, col = dst, columns sorted within a row; duplicate edges are
    kept (their counts add up in the tiles).  The JAX package's two stable
    index sorts give the same arrays as one sort of the (row, column) keys:
    equal keys are the same edge.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    span = np.int64(max(num_nodes, int(dst.max()) + 1 if len(dst) else 1))
    indices = (np.sort(src * span + dst) % span).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=num_nodes), out=indptr[1:])
    return indptr.astype(np.int32), indices


@dataclasses.dataclass
class GraphDataset:
    """In-memory graph + features + labels (host NumPy)."""

    name: str
    num_nodes: int
    num_edges: int
    num_features: int
    num_classes: int
    row_pointers: np.ndarray  # [N+1] int32
    column_index: np.ndarray  # [nnz] int32
    x: np.ndarray  # [N, num_features] float32
    y: np.ndarray  # [N] int32
    train_mask: np.ndarray  # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    avg_degree: float = 0.0
    avg_edge_span: float = 0.0

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_pointers)

    def norm_degrees(self) -> np.ndarray:
        """sqrt(max(deg, 1)), for symmetric GCN normalization."""
        return np.sqrt(np.maximum(self.degrees, 1)).astype(np.float32)


def _finalize(
    name: str,
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    dim: int,
    num_classes: int,
    seed: int = 0,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    verbose: bool = False,
) -> GraphDataset:
    num_edges = len(src)
    avg_degree = num_edges / max(num_nodes, 1)
    avg_edge_span = float(np.mean(np.abs(src.astype(np.int64) - dst.astype(np.int64)))) if num_edges else 0.0

    start = time.perf_counter()
    indptr, indices = coo_to_csr(src, dst, num_nodes)
    if verbose:
        print(f"# Build CSR (s): {time.perf_counter() - start:.3f}")
        print(f"# nodes: {num_nodes}")
        print(f"# avg_degree: {avg_degree:.2f}")
        print(f"# avg_edgeSpan: {int(avg_edge_span)}")

    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.standard_normal((num_nodes, dim), dtype=np.float32)
    if y is None:
        y = np.ones(num_nodes, dtype=np.int32)

    n = num_nodes
    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[: int(n * 1.0)] = True
    val_mask[: int(n * 0.3)] = True
    test_mask[: int(n * 0.1)] = True

    return GraphDataset(
        name=name,
        num_nodes=num_nodes,
        num_edges=num_edges,
        num_features=x.shape[1],
        num_classes=num_classes,
        row_pointers=indptr,
        column_index=indices,
        x=x,
        y=y,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        avg_degree=avg_degree,
        avg_edge_span=avg_edge_span,
    )


def load_npz(path: str, dim: int, num_classes: int, seed: int = 0, verbose: bool = False) -> GraphDataset:
    """Load the ``.npz`` graph format: keys ``src_li``, ``dst_li``,
    ``num_nodes``, and optionally ``x``, ``y`` and the three masks."""
    if not path.endswith(".npz"):
        raise ValueError("graph file must be a .npz file")
    obj = np.load(path, allow_pickle=True)
    src, dst = np.asarray(obj["src_li"]), np.asarray(obj["dst_li"])
    num_nodes = int(obj["num_nodes"])
    name = path.rsplit("/", 1)[-1][: -len(".npz")]
    x = np.asarray(obj["x"], np.float32) if "x" in obj.files else None
    y = np.asarray(obj["y"], np.int32) if "y" in obj.files else None
    if y is not None:
        num_classes = max(num_classes, int(y.max()) + 1)
    ds = _finalize(
        name, src, dst, num_nodes, dim, num_classes, seed, x=x, y=y,
        verbose=verbose,
    )
    for mask in ("train_mask", "val_mask", "test_mask"):
        if mask in obj.files:
            setattr(ds, mask, np.asarray(obj[mask], bool))
    validate(ds, source=path, real_features="x" in obj.files,
             real_labels="y" in obj.files)
    return ds


def validate(ds: "GraphDataset", source: str = "", real_features=False,
             real_labels=False) -> dict:
    """Integrity check + one-line provenance report for a loaded graph.

    Raises on a malformed file (non-monotone row pointers, out-of-range
    columns, feature/label length mismatch) and prints one ``# dataset``
    line saying whether a real file is in use.
    """
    ptr = np.asarray(ds.row_pointers)
    cols = np.asarray(ds.column_index)
    n, e = ds.num_nodes, ds.num_edges
    if len(ptr) != n + 1 or int(ptr[0]) != 0 or int(ptr[-1]) != e:
        raise ValueError(f"{source}: malformed row_pointers "
                         f"(len {len(ptr)} vs N+1={n + 1}, nnz {ptr[-1]} vs {e})")
    if np.any(np.diff(ptr) < 0):
        raise ValueError(f"{source}: row_pointers not monotone")
    if e and (int(cols.min()) < 0 or int(cols.max()) >= n):
        raise ValueError(f"{source}: column index out of range "
                         f"[{cols.min()}, {cols.max()}] vs N={n}")
    if ds.x.shape[0] != n or len(ds.y) != n:
        raise ValueError(f"{source}: feature/label row count mismatch")
    # Symmetry probe on a bounded edge sample (full check is O(E log E)).
    sym = True
    if e:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        k = min(e, 10000)
        idx = np.linspace(0, e - 1, k).astype(np.int64)
        for r, c in zip(rows[idx], cols[idx]):
            lo, hi = ptr[c], ptr[c + 1]
            if not np.any(cols[lo:hi] == r):
                sym = False
                break
    report = dict(
        nodes=n, edges=e, features=int(ds.x.shape[1]),
        classes=int(ds.num_classes), symmetric_sampled=sym,
        real_features=bool(real_features), real_labels=bool(real_labels),
    )
    tag = "REAL" if source else "synthetic"
    print(
        f"# dataset {ds.name}: {tag}"
        + (f" {source}" if source else "")
        + f" | N={n} E={e} d={report['features']}"
        + f" classes={report['classes']}"
        + f" symmetric~{sym}"
        + f" features={'real' if real_features else 'synthesized'}"
        + f" labels={'real' if real_labels else 'synthesized'}"
    )
    return report


def load_txt(path: str, dim: int, num_classes: int, seed: int = 0, verbose: bool = False) -> GraphDataset:
    """Load a two-ints-per-line edge list."""
    arr = np.loadtxt(path, dtype=np.int64)
    arr = arr.reshape(-1, 2)
    src, dst = arr[:, 0], arr[:, 1]
    num_nodes = int(max(src.max(), dst.max())) + 1
    name = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    ds = _finalize(name, src, dst, num_nodes, dim, num_classes, seed, verbose=verbose)
    validate(ds, source=path)
    return ds
