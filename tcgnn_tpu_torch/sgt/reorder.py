"""Node reordering before tiling (PyTorch port of ``tcgnn_tpu.sgt.reorder``).

A reordering is a graph isomorphism: rows and columns of A, the features,
labels and masks are permuted alike, and full-graph training is unchanged.
Reverse Cuthill-McKee narrows the adjacency's band, so banded graphs reach
the block-diagonal route (``sgt/blockdiag.py``) and power-law graphs share
more neighbours per row window.

Carried over: ``rcm_permutation`` (scipy's ``reverse_cuthill_mckee``, the
JAX package's fallback without its native library), ``permute_csr``,
``apply_permutation`` and ``reorder_dataset``.  The community ordering
exists only as the JAX package's native C++ pass; here it raises, so the
port never trains on another ordering than the JAX package would.
"""

from __future__ import annotations

import numpy as np

REORDER_METHODS = ("none", "rcm", "community")


def _symmetrized(row_pointers, column_index, num_nodes: int):
    import scipy.sparse as sp

    indptr = np.asarray(row_pointers, dtype=np.int64)
    indices = np.asarray(column_index, dtype=np.int64)
    a = sp.csr_matrix(
        (np.ones(len(indices), dtype=np.int8), indices, indptr), shape=(num_nodes, num_nodes)
    )
    return (a + a.T).tocsr()


def rcm_permutation(row_pointers, column_index, num_nodes: int) -> np.ndarray:
    """``perm[new_id] = old_id`` by reverse Cuthill-McKee on ``A + A^T``."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s = _symmetrized(row_pointers, column_index, num_nodes)
    return np.asarray(reverse_cuthill_mckee(s, symmetric_mode=True), dtype=np.int64)


def permute_csr(row_pointers, column_index, perm: np.ndarray):
    """CSR of ``P A P^T`` where new node i is old node ``perm[i]``.

    Returns ``(new_ptr, new_cols, edge_map)`` with ``edge_map[new_edge] =
    old_edge``; each row's columns stay sorted.
    """
    ptr = np.asarray(row_pointers, dtype=np.int64)
    cols = np.asarray(column_index, dtype=np.int64)
    n = len(ptr) - 1
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    new_degrees = np.diff(ptr)[perm]
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_degrees, out=new_ptr[1:])

    # New row r copies old row perm[r]'s edge slice.
    idx_within = np.arange(len(cols), dtype=np.int64) - np.repeat(new_ptr[:-1], new_degrees)
    edge_map = np.repeat(ptr[perm], new_degrees) + idx_within
    new_cols_unsorted = inv[cols[edge_map]]

    row_of_new_edge = np.repeat(np.arange(n, dtype=np.int64), new_degrees)
    order = np.argsort(row_of_new_edge * np.int64(n) + new_cols_unsorted, kind="stable")
    return (
        new_ptr.astype(np.int32),
        new_cols_unsorted[order].astype(np.int32),
        edge_map[order],
    )


def apply_permutation(ds, perm: np.ndarray):
    """Permute a ``GraphDataset`` in place: graph, features, labels, masks."""
    new_ptr, new_cols, _ = permute_csr(ds.row_pointers, ds.column_index, perm)
    ds.row_pointers = new_ptr
    ds.column_index = new_cols
    ds.x = np.asarray(ds.x)[perm]
    ds.y = np.asarray(ds.y)[perm]
    for m in ("train_mask", "val_mask", "test_mask"):
        if getattr(ds, m, None) is not None:
            setattr(ds, m, np.asarray(getattr(ds, m))[perm])
    return perm


def reorder_dataset(ds, method: str = "rcm"):
    """Permute a ``GraphDataset`` in place by ``method``; returns the
    permutation (``perm[new] = old``), or None for ``"none"``."""
    if method in (None, "none"):
        return None
    if method == "rcm":
        return apply_permutation(ds, rcm_permutation(ds.row_pointers, ds.column_index,
                                                     ds.num_nodes))
    if method == "community":
        raise NotImplementedError(
            "--reorder community is the JAX package's native C++ pass "
            "(sgt.cpp:sgt_community), not ported yet (ROADMAP.md, Queue 1 item 2)"
        )
    raise ValueError(f"unknown reorder method {method!r}")
