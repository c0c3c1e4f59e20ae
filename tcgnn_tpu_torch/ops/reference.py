"""CSR oracles of the graph ops (counterpart of ``tcgnn_tpu.ops.reference``).

Independent of the tiling: a row gather plus ``index_add_``.

* ``spmm_ref``  — ``out[i] = sum_{e=(i,j)} w_e * X[j]``;
* ``sddmm_ref`` — ``e_(i,j) = <X[i], X[j]>``.
"""

from __future__ import annotations

import torch


def edge_rows_from_csr(row_pointers: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Per-edge row id from the CSR indptr."""
    degrees = row_pointers[1:] - row_pointers[:-1]
    rows = torch.arange(
        row_pointers.shape[0] - 1, device=row_pointers.device, dtype=torch.int64
    )
    return torch.repeat_interleave(rows, degrees.long(), output_size=num_edges)


def spmm_ref(
    x: torch.Tensor,
    row_pointers: torch.Tensor,
    column_index: torch.Tensor,
    edge_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Oracle SpMM: ``out = A @ x`` with A given in CSR (optionally weighted)."""
    num_nodes = row_pointers.shape[0] - 1
    rows = edge_rows_from_csr(row_pointers, column_index.shape[0])
    gathered = x[column_index.long()]
    if edge_weights is not None:
        gathered = gathered * edge_weights[:, None]
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, gathered)


def sddmm_ref(
    x: torch.Tensor,
    row_pointers: torch.Tensor,
    column_index: torch.Tensor,
) -> torch.Tensor:
    """Oracle SDDMM: per-edge dot product ``e = <x[row_e], x[col_e]>``."""
    rows = edge_rows_from_csr(row_pointers, column_index.shape[0])
    return torch.sum(x[rows] * x[column_index.long()], dim=-1)
