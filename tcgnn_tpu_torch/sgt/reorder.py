"""Node reordering before tiling (PyTorch port of ``tcgnn_tpu.sgt.reorder``).

A reordering is a graph isomorphism: rows and columns of A, the features,
labels and masks are permuted alike, and full-graph training is unchanged.
Reverse Cuthill-McKee narrows the adjacency's band, so banded graphs reach
the block-diagonal route (``sgt/blockdiag.py``) and power-law graphs share
more neighbours per row window.

Carried over: ``rcm_permutation`` (scipy's ``reverse_cuthill_mckee``, the
JAX package's fallback without its native library), ``permute_csr``,
``apply_permutation``, ``reorder_dataset``, and the distributed layer's
window-granular shard balance (``shard_balance_permutation``,
``balance_dataset``).  The community ordering exists only as the JAX
package's native C++ pass; here it raises, so the port never trains on
another ordering than the JAX package would.
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


def shard_balance_permutation(
    row_pointers, column_index, num_nodes: int, num_shards: int, config=None
) -> np.ndarray:
    """``perm[new] = old``: window-granular load balance over the mesh's
    graph axis.

    The partition gives each shard a contiguous range of equally many row
    windows and pads every shard's block stream to the heaviest one, so each
    shard walks the heaviest shard's block count.  This pass assigns whole
    windows to shards by LPT (longest processing time first, equal window
    counts per shard), then relabels nodes so each shard's windows are
    contiguous.  Window contents are untouched: TC_Blocks and every
    window's tiling stay the same.  A partial last window stays the last
    slot, so every earlier window keeps ``blk_h`` rows.
    """
    from tcgnn_tpu_torch.config import DEFAULT_CONFIG
    from tcgnn_tpu_torch.sgt.translate import _cdiv, _pad_blocks, sparse_graph_translate

    cfg = DEFAULT_CONFIG if config is None else config
    blk_h = cfg.blk_h
    n = int(num_nodes)
    g = int(num_shards)
    w = max(_cdiv(n, blk_h), 1)
    identity = np.arange(n, dtype=np.int64)
    if g <= 1 or w <= g:
        return identity

    # Each window's padded block count: the load it adds to its shard.
    per = sparse_graph_translate(row_pointers, column_index, n, cfg).block_partition
    load = _pad_blocks(np.asarray(per, np.int64), cfg).astype(np.int64)

    wd = _cdiv(w, g)
    caps = np.full(g, wd, np.int64)
    caps[-1] = w - (g - 1) * wd  # the partition pads the tail shard
    if caps[-1] <= 0:  # tail shards own no real windows
        caps = np.minimum(np.maximum(w - np.arange(g) * wd, 0), wd)
    totals = np.zeros(g, np.float64)
    assign: list[list[int]] = [[] for _ in range(g)]

    partial = n % blk_h != 0
    windows = np.arange(w - 1 if partial else w)
    if partial:
        s_last = int(np.max(np.nonzero(caps > 0)[0]))
        assign[s_last].append(w - 1)
        totals[s_last] += load[w - 1]
        caps[s_last] -= 1

    for w_id in windows[np.argsort(-load[windows], kind="stable")]:
        open_ = caps > 0
        s = int(np.flatnonzero(open_)[np.argmin(totals[open_])])
        assign[s].append(int(w_id))
        totals[s] += load[w_id]
        caps[s] -= 1

    slots: list[int] = []
    for s in range(g):
        ws = sorted(assign[s])  # ascending keeps band locality per shard
        if partial and (w - 1) in ws:
            ws = [v for v in ws if v != w - 1] + [w - 1]
        slots.extend(ws)
    return np.concatenate(
        [np.arange(v * blk_h, min((v + 1) * blk_h, n), dtype=np.int64) for v in slots]
    )


def balance_dataset(ds, num_shards: int, config=None):
    """Apply ``shard_balance_permutation`` to a ``GraphDataset`` in place;
    returns the permutation, or None when it is the identity."""
    perm = shard_balance_permutation(
        ds.row_pointers, ds.column_index, ds.num_nodes, num_shards, config
    )
    if np.array_equal(perm, np.arange(ds.num_nodes, dtype=np.int64)):
        return None
    return apply_permutation(ds, perm)
