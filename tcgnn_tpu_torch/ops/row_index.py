"""The per-row index of a sparse operand, which the score-fused kernels walk.

A ``RowIndex`` holds a matrix's nonzeros by output row: row ``i``'s are
``[row_ptr[i], row_ptr[i + 1])``, each with its gathered row ``cols`` and
its value ``vals``, in the operand's own dtype.  Two operands give one:

* the block-diagonal pack (``ops/blockdiag.py::bd_row_index``), walked by
  K6 and K7 a row to a lane group;
* the SGT-condensed tiles (``ops/sfused.py::sgt_row_index``), walked by K2
  and K3 in equal ranges of nonzeros, which also read each nonzero's row
  (``rows``).

Both are derived on the operand's device at upload, ``INDEX_SLAB`` entries
of the operand at a time, and hold its nonzeros bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Flat operand entries an index build scans at once: under one ``nonzero``
# call's limit (YeastH's pack has 2.01e9 entries).
INDEX_SLAB = 1 << 28


@dataclasses.dataclass(frozen=True)
class RowIndex:
    """A matrix's nonzeros by row, in row order."""

    row_ptr: torch.Tensor  # [num_rows + 1] int64
    cols: torch.Tensor     # [nnz] int32, each nonzero's gathered row
    vals: torch.Tensor     # [nnz] the operand's dtype
    rows: Optional[torch.Tensor] = None  # [nnz] int32, each nonzero's row (K2/K3)
    # What a launch checks, worked out once here: the device a kernel can
    # read the arrays on (all there, contiguous, int64 row pointers, int32
    # columns and rows, a value and a row a column), else None.
    kernel_device: Optional[torch.device] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        arrays = [t for t in (self.row_ptr, self.cols, self.vals, self.rows) if t is not None]
        dev = self.row_ptr.device
        ok = (all(t.device == dev and t.is_contiguous() for t in arrays)
              and self.row_ptr.dtype == torch.int64 and self.cols.dtype == torch.int32
              and self.cols.numel() == self.vals.numel()
              and (self.rows is None or (self.rows.dtype == torch.int32
                                         and self.rows.numel() == self.cols.numel())))
        object.__setattr__(self, "kernel_device", dev if ok else None)

    @property
    def num_rows(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.cols.numel()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_ptr, self.cols, self.vals, self.rows) if t is not None)


def from_rows(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, num_rows: int,
              with_rows: bool) -> RowIndex:
    """A ``RowIndex`` from nonzeros already in row order: int64 ``rows``,
    int32 ``cols``; ``with_rows`` keeps each nonzero's row."""
    row_ptr = torch.zeros(num_rows + 1, dtype=torch.int64, device=rows.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=num_rows), 0)
    return RowIndex(row_ptr=row_ptr, cols=cols, vals=vals,
                    rows=rows.to(torch.int32) if with_rows else None)


def check_row_index(op: str, index, num_rows: int, max_nnz: int, dtype: torch.dtype,
                    device: torch.device, build: str, needs_rows: bool = False) -> None:
    """Raise unless ``index`` is a ``RowIndex`` of ``num_rows`` rows, at most
    ``max_nnz`` nonzeros of ``dtype``, arrays a kernel can read on
    ``device`` and, with ``needs_rows``, each nonzero's row.  ``build``
    names the call that makes one, for the message of a missing index."""
    if index is None:
        raise ValueError(f"{op}: the kernel walks a row index: pass index={build}")
    if index.num_rows != num_rows:
        raise ValueError(f"{op}: row index of {index.num_rows} rows for {num_rows}")
    if index.nnz > max_nnz:
        raise ValueError(f"{op}: row index nonzero count {index.nnz} over the operand's "
                         f"{max_nnz} entries")
    if index.vals.dtype != dtype:
        raise TypeError(f"{op}: row index values {index.vals.dtype}, operand {dtype}")
    if needs_rows and index.rows is None:
        raise ValueError(f"{op}: row index without each nonzero's row: pass index={build}")
    if index.kernel_device != device:
        raise ValueError(f"{op}: row index arrays on {index.row_ptr.device} must be contiguous "
                         f"int64 row_ptr, int32 cols (and rows) and a value a column, "
                         f"on {device}")
