"""Chunk-layout SpMM and SDDMM (K8 and K9 of the port): the chunk route and
the streamed route.

Counterparts of ``tcgnn_tpu.ops.spmm.spmm_tc`` / ``spmm_tc_streamed`` and
``tcgnn_tpu.ops.sddmm.sddmm_tc`` / ``sddmm_tc_streamed``, with the JAX
signatures less ``interpret`` and ``d_tile``.  Every one of them reads a
``TorchChunkMeta``: ``SGTMeta.to_chunks`` gives the flat chunk layout as one
segment, ``StreamedMeta.to`` the streamed route's segments, and one kernel
serves both (``csrc/chunk.cu``), through one wrapper each: ``spmm_tc`` and
``sddmm_tc`` take either layout, and the ``*_streamed`` names are aliases.

* SpMM: ``out = (A ⊙ w) @ x`` (``w`` per CSR edge, or none), ``[N, d]``
  **f32** whatever the compute dtype, as the JAX chunk kernels store it: x
  and w are rounded to the compute dtype and the products summed in f32.
* SDDMM: per-edge ``e = <xa[row_e], xb[col_e]>``, ``[E]`` f32 in CSR order,
  of compute-dtype operands.  The kernel writes each score to its edge
  directly, so the layout's ``edge_perm`` is not needed on the device.

A CUDA tensor runs the kernel (or raises); a CPU tensor runs the plain
version (``*_torch``: ``index_add_`` over the slots, and per-slot dots, in
slabs of at most ``PLAIN_SLAB_EDGES`` slots so that no ``[E, d]`` array is
formed).  Each of the two wrappers counts its ``launches`` and
``plain_calls``.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND
from tcgnn_tpu_torch.sgt.translate import TorchChunkMeta

PLAIN_SLAB_EDGES = 1 << 22


def _slot_slabs(meta: TorchChunkMeta):
    """Each slab of real slots: their output rows, source rows and edge ids
    (int64), at most ``PLAIN_SLAB_EDGES`` slots a slab."""
    cfg = meta.config
    blk_h, blk_w = cfg.blk_h, cfg.blk_w
    per = max(1, PLAIN_SLAB_EDGES // cfg.edge_chunk)
    for s, nc in enumerate(meta.seg_chunks.tolist()):
        col_ids = meta.seg_col_ids[s].long()
        for c0 in range(0, nc, per):
            c1 = min(c0 + per, nc)
            r = meta.seg_r[s, c0:c1].long()
            real = r < blk_h
            win = meta.seg_window[s, c0:c1, None].long().expand_as(r)[real]
            blk = meta.seg_block[s, c0:c1, None].long().expand_as(r)[real]
            rows = (s * meta.wseg + win) * blk_h + r[real]
            src = col_ids[blk * blk_w + meta.seg_c[s, c0:c1].long()[real]]
            yield rows, src, meta.seg_edge_id[s, c0:c1].long()[real]


def spmm_tc_torch(
    x: torch.Tensor, meta: TorchChunkMeta, edge_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K8: each slot's weighted source row added
    to its output row (``index_add_``)."""
    ct = meta.config.compute_dtype
    xc = x.to(ct)
    w = None if edge_weights is None else edge_weights.float().to(ct).float()
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
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
        seg_chunks=meta.seg_chunks,
    )
    if x.numel() >= 2**31 or meta.seg_col_ids.shape[1] >= 2**31:
        raise ValueError(f"{op}: x or a segment's col_ids has 2**31 elements or more")


def _layout_args(meta: TorchChunkMeta):
    """The kernels' layout arguments, after the pointers."""
    return (meta.num_segments, meta.max_chunks, meta.config.edge_chunk, meta.wseg,
            meta.config.blk_h, meta.config.blk_w, meta.seg_col_ids.shape[1])


def _layout_ptrs(meta: TorchChunkMeta):
    return (meta.seg_col_ids.data_ptr(), meta.seg_r.data_ptr(), meta.seg_c.data_ptr(),
            meta.seg_edge_id.data_ptr(), meta.seg_block.data_ptr(),
            meta.seg_window.data_ptr(), meta.seg_chunks.data_ptr())


def _spmm_cuda(x, meta, edge_weights):
    _check_chunk_operands("spmm_tc", x, meta)
    ct = meta.config.compute_dtype
    n, d = x.shape
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0 or meta.num_edges == 0:
        return out
    x = x.to(ct).contiguous()
    w = None if edge_weights is None else edge_weights.float().contiguous()
    if w is not None and w.device != x.device:
        raise ValueError(f"spmm_tc: edge_weights on {w.device}, features on {x.device}")
    lib = _kernels.load("chunk")
    with torch.cuda.device(x.device):
        err = lib.tcgnn_spmm_chunk(
            x.data_ptr(), None if w is None else w.data_ptr(), *_layout_ptrs(meta),
            out.data_ptr(), n, d, *_layout_args(meta), FEAT_KIND[ct], _kernels.stream_of(x),
        )
    _kernels.check(lib, err, "spmm_chunk")
    spmm_tc.launches += 1
    return out


def _sddmm_cuda(xa, xb, meta):
    _check_chunk_operands("sddmm_tc", xa, meta)
    ct = meta.config.compute_dtype
    d = xa.shape[1]
    if meta.num_edges == 0 or d == 0:
        return torch.zeros(meta.num_edges, dtype=torch.float32, device=xa.device)
    a = xa.to(ct).contiguous()
    b = a if xb is None else xb.to(ct).contiguous()
    out = torch.empty(meta.num_edges, dtype=torch.float32, device=xa.device)
    lib = _kernels.load("chunk")
    with torch.cuda.device(xa.device):
        err = lib.tcgnn_sddmm_chunk(
            a.data_ptr(), b.data_ptr(), *_layout_ptrs(meta), out.data_ptr(), d,
            *_layout_args(meta), FEAT_KIND[ct], _kernels.stream_of(xa),
        )
    _kernels.check(lib, err, "sddmm_chunk")
    sddmm_tc.launches += 1
    return out


def _check_x(op, x, meta, edge_weights=None):
    if x.dim() != 2 or x.shape[0] != meta.num_nodes:
        raise ValueError(f"{op}: x of shape {tuple(x.shape)}, expected [{meta.num_nodes}, d]")
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
    ``[N, d]`` f32, over any chunk layout: the flat one
    (``SGTMeta.to_chunks``) or window segments (``StreamedMeta.to``), one
    launch for all of them."""
    _check_x("spmm_tc", x, meta, edge_weights)
    if x.device.type == "cuda":
        return _spmm_cuda(x, meta, edge_weights)
    spmm_tc.plain_calls += 1
    return spmm_tc_torch(x, meta, edge_weights)


@_kernels.counted
def sddmm_tc(
    xa: torch.Tensor, meta: TorchChunkMeta, xb: torch.Tensor | None = None
) -> torch.Tensor:
    """Chunk-route SDDMM: per-edge ``<xa[row_e], xb[col_e]>`` (``xb=None``:
    ``xb = xa``), ``[E]`` f32 in CSR order, over any chunk layout."""
    _check_x("sddmm_tc", xa, meta)
    if xb is not None and (xb.shape != xa.shape or xb.device != xa.device):
        raise ValueError(f"sddmm_tc: xb {tuple(xb.shape)} on {xb.device}, "
                         f"xa {tuple(xa.shape)} on {xa.device}")
    if xa.device.type == "cuda":
        return _sddmm_cuda(xa, xb, meta)
    sddmm_tc.plain_calls += 1
    return sddmm_tc_torch(xa, meta, xb)


# The JAX package's streamed entry points, by name: the flat layout is the
# streamed layout with one segment, so one wrapper (and one count) serves both.
spmm_tc_streamed = spmm_tc
sddmm_tc_streamed = sddmm_tc
