"""Chunk-route SpMM and SDDMM (K8 and K9 of the port): the chunk route and
the streamed route.

Counterparts of ``tcgnn_tpu.ops.spmm.spmm_tc`` / ``spmm_tc_streamed`` and
``tcgnn_tpu.ops.sddmm.sddmm_tc`` / ``sddmm_tc_streamed``, with the JAX
signatures less ``interpret`` and ``d_tile``.  Every one of them reads a
``TorchChunkMeta``: ``SGTMeta.to_chunks`` gives the flat chunk layout as one
segment, ``StreamedMeta.to`` the streamed route's segments.  One wrapper
each, ``spmm_tc`` and ``sddmm_tc``, takes either layout (the ``*_streamed``
names are aliases): the kernels (``csrc/chunk.cu``) read the CSR row index
derived from the layout at upload (``row_ptr``, ``row_src``) and walk the
edges in row order, one launch for any number of segments; the plain
versions read the chunk slots.

* SpMM: ``out = (A ⊙ w) @ x`` (``w`` per CSR edge, or none), x ``[num_src,
  d]``, out ``[num_rows, d]`` **f32** whatever the compute dtype, as the JAX
  chunk kernels store it: x and w are rounded to the compute dtype and the
  products summed in f32.
* SDDMM: per-edge ``e = <xa[row_e], xb[col_e]>``, xa ``[num_rows, d]``, xb
  ``[num_src, d]``, ``[E]`` f32 in CSR order, of compute-dtype operands.
  The kernel writes the scores in CSR order directly, so the layout's
  ``edge_perm`` is not needed on the device.

On one device ``num_rows == num_src == N``; a shard of the distributed
layer writes its own rows and gathers from the all-gathered features.

A CUDA tensor runs the kernel (or raises); a CPU tensor runs the plain
version (``*_torch``: ``index_add_`` over the slots, and per-slot dots, in
slabs of at most ``SLAB_SLOTS`` slots so that no ``[E, d]`` array is
formed).  Each of the two wrappers counts its ``launches`` and
``plain_calls``.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND
from tcgnn_tpu_torch.sgt.translate import TorchChunkMeta


# The plain versions walk the layout's slots.
_slot_slabs = TorchChunkMeta.slot_slabs


def spmm_tc_torch(
    x: torch.Tensor, meta: TorchChunkMeta, edge_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K8: each slot's weighted source row added
    to its output row (``index_add_``)."""
    ct = meta.config.compute_dtype
    xc = x.to(ct)
    w = None if edge_weights is None else edge_weights.float().to(ct).float()
    out = torch.zeros((meta.num_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    for rows, src, eid in _slot_slabs(meta):
        vals = xc.index_select(0, src).float()
        if w is not None:
            vals = vals * w.index_select(0, eid)[:, None]
        out.index_add_(0, rows, vals)
    return out


def sddmm_tc_torch(
    xa: torch.Tensor, meta: TorchChunkMeta, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K9: each slot's dot, written to its edge."""
    ct = meta.config.compute_dtype
    a = xa.to(ct)
    b = a if xb is None else xb.to(ct)
    out = torch.zeros(meta.num_edges, dtype=torch.float32, device=xa.device)
    for rows, src, eid in _slot_slabs(meta):
        out[eid] = (a.index_select(0, rows).float() * b.index_select(0, src).float()).sum(1)
    return out


spmm_tc_streamed_torch = spmm_tc_torch
sddmm_tc_streamed_torch = sddmm_tc_torch


def _check_chunk_operands(op: str, x: torch.Tensor, meta: TorchChunkMeta) -> None:
    ct = meta.config.compute_dtype
    if ct not in FEAT_KIND:
        raise TypeError(f"{op}: no kernel for compute dtype {ct}")
    _kernels.check_operands(
        op, x.device, seg_col_ids=meta.seg_col_ids, seg_r=meta.seg_r, seg_c=meta.seg_c,
        seg_edge_id=meta.seg_edge_id, seg_block=meta.seg_block, seg_window=meta.seg_window,
        seg_chunks=meta.seg_chunks, row_src=meta.row_src,
    )
    rp = meta.row_ptr
    if rp.device != x.device or rp.dtype != torch.int64 or not rp.is_contiguous():
        raise ValueError(f"{op}: row_ptr must be contiguous int64 on {x.device}, "
                         f"got {rp.dtype} on {rp.device}")
    if x.numel() >= 2**31:
        raise ValueError(f"{op}: x has 2**31 elements or more")


def _spmm_cuda(x, meta, edge_weights):
    _check_chunk_operands("spmm_tc", x, meta)
    ct = meta.config.compute_dtype
    n, d = meta.num_rows, x.shape[1]
    # Zeroed: rows cut between the kernel's warps are added with atomics.
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0 or meta.num_edges == 0:
        return out
    if x.dtype != ct or not x.is_contiguous():
        x = x.to(ct).contiguous()
    w = None if edge_weights is None else edge_weights.float().contiguous()
    if w is not None and w.device != x.device:
        raise ValueError(f"spmm_tc: edge_weights on {w.device}, features on {x.device}")
    _kernels.call(
        "chunk", "tcgnn_spmm_chunk", x.device, x.data_ptr(),
        None if w is None else w.data_ptr(), meta.row_ptr.data_ptr(), meta.row_src.data_ptr(),
        out.data_ptr(), n, d, meta.num_edges, FEAT_KIND[ct], _kernels.stream_of(x),
    )
    spmm_tc.launches += 1
    return out


def _sddmm_cuda(xa, xb, meta):
    _check_chunk_operands("sddmm_tc", xa, meta)
    if xb is not None and xb.numel() >= 2**31:
        raise ValueError("sddmm_tc: xb has 2**31 elements or more")
    ct = meta.config.compute_dtype
    n, d = xa.shape
    if meta.num_edges == 0 or d == 0:
        return torch.zeros(meta.num_edges, dtype=torch.float32, device=xa.device)
    a = xa if xa.dtype == ct and xa.is_contiguous() else xa.to(ct).contiguous()
    b = a if xb is None else (xb if xb.dtype == ct and xb.is_contiguous()
                              else xb.to(ct).contiguous())
    out = torch.empty(meta.num_edges, dtype=torch.float32, device=xa.device)
    _kernels.call(
        "chunk", "tcgnn_sddmm_chunk", xa.device, a.data_ptr(), b.data_ptr(),
        meta.row_ptr.data_ptr(), meta.row_src.data_ptr(), out.data_ptr(), n, d, meta.num_edges,
        FEAT_KIND[ct], _kernels.stream_of(xa),
    )
    sddmm_tc.launches += 1
    return out


def _check_x(op, x, rows, meta, edge_weights=None):
    """``x`` of ``rows`` rows (``num_src`` for the SpMM's x, ``num_rows``
    for the SDDMM's xa) on a device with a kernel."""
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{op}: x of shape {tuple(x.shape)}, expected [{rows}, d]")
    if edge_weights is not None and edge_weights.shape != (meta.num_edges,):
        raise ValueError(f"{op}: weights of shape {tuple(edge_weights.shape)}, "
                         f"expected ({meta.num_edges},)")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: no kernel for device {x.device}")


@_kernels.counted
def spmm_tc(
    x: torch.Tensor, meta: TorchChunkMeta, edge_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Chunk-route SpMM ``(A ⊙ w) @ x`` (``edge_weights`` None: ``A @ x``),
    x ``[num_src, d]``, ``[num_rows, d]`` f32, over any chunk layout: the
    flat one (``SGTMeta.to_chunks``) or window segments (``StreamedMeta.to``),
    one launch for all of them."""
    _check_x("spmm_tc", x, meta.num_src, meta, edge_weights)
    if x.device.type == "cuda":
        return _spmm_cuda(x, meta, edge_weights)
    spmm_tc.plain_calls += 1
    return spmm_tc_torch(x, meta, edge_weights)


@_kernels.counted
def sddmm_tc(
    xa: torch.Tensor, meta: TorchChunkMeta, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Chunk-route SDDMM: per-edge ``<xa[row_e], xb[col_e]>``, xa
    ``[num_rows, d]``, xb ``[num_src, d]`` (``xb=None``: ``xb = xa``, where
    the two counts are equal), ``[E]`` f32 in CSR order, over any chunk
    layout."""
    _check_x("sddmm_tc", xa, meta.num_rows, meta)
    if xb is None and meta.num_src != meta.num_rows:
        raise ValueError(f"sddmm_tc: xb=None needs num_src == num_rows, got {meta.num_src} "
                         f"and {meta.num_rows}")
    if xb is not None and (xb.shape != (meta.num_src, xa.shape[1]) or xb.device != xa.device):
        raise ValueError(f"sddmm_tc: xb {tuple(xb.shape)} on {xb.device}, expected "
                         f"[{meta.num_src}, {xa.shape[1]}] on {xa.device}")
    if xa.device.type == "cuda":
        return _sddmm_cuda(xa, xb, meta)
    sddmm_tc.plain_calls += 1
    return sddmm_tc_torch(xa, meta, xb)


# The JAX package's streamed entry points, by name: the flat layout is the
# streamed layout with one segment, so one wrapper (and one count) serves both.
spmm_tc_streamed = spmm_tc
sddmm_tc_streamed = sddmm_tc
