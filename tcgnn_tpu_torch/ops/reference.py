"""CSR oracles of the graph ops (counterpart of ``tcgnn_tpu.ops.reference``).

Independent of the tiling: a row gather plus ``index_add_``.

* ``spmm_ref``  — ``out[i] = sum_{e=(i,j)} w_e * X[j]``;
* ``sddmm_ref`` — ``e_(i,j) = <Xa[i], Xb[j]>``;
* ``sfused_ref`` — the score-fused SpMM, ``out[i] = sum_{e=(i,j)}
  <Xl[i], Xr[j]> * Xv[j]``;
* ``sfused_bwd_ref`` — its one-pass backward terms ``(dx3, u)``.

Run them in f64 for an oracle of the f32 kernels.
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
    xb: torch.Tensor | None = None,
) -> torch.Tensor:
    """Oracle SDDMM: per-edge dot product ``e = <x[row_e], xb[col_e]>``
    (``xb`` defaults to ``x``)."""
    rows = edge_rows_from_csr(row_pointers, column_index.shape[0])
    xb = x if xb is None else xb
    return torch.sum(x[rows] * xb[column_index.long()], dim=-1)


def sfused_ref(
    xl: torch.Tensor,
    xr: torch.Tensor,
    xv: torch.Tensor,
    row_pointers: torch.Tensor,
    column_index: torch.Tensor,
) -> torch.Tensor:
    """Oracle score-fused SpMM: ``out = (A ⊙ (xl @ xr^T)) @ xv`` per edge."""
    scores = sddmm_ref(xl, row_pointers, column_index, xr)
    return spmm_ref(xv, row_pointers, column_index, scores)


def sfused_bwd_ref(
    x: torch.Tensor,
    dy: torch.Tensor,
    row_pointers: torch.Tensor,
    column_index: torch.Tensor,
):
    """Oracle of the one-pass AGNN backward: per edge (i, j),
    ``dx3[i] += s * dy[j] + (t + w) * x[j]`` and ``u[i] += s * x[j]`` with
    ``s = <x_i, x_j>``, ``t = <dy_i, x_j>``, ``w = <x_i, dy_j>``."""
    s = sddmm_ref(x, row_pointers, column_index)
    tw = sddmm_ref(dy, row_pointers, column_index, x) + sddmm_ref(
        x, row_pointers, column_index, dy)
    dx3 = spmm_ref(dy, row_pointers, column_index, s) + spmm_ref(
        x, row_pointers, column_index, tw)
    return dx3, spmm_ref(x, row_pointers, column_index, s)
