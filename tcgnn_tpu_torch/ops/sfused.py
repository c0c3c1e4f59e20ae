"""Score-fused SpMM and its one-pass backward over SGT tiles (K2 and K3).

Counterparts of ``tcgnn_tpu.ops.spmm.spmm_sfused`` and
``spmm_sfused_bwd``, the AGNN aggregation on symmetric graphs:

* ``spmm_sfused(xl, xr, xv, meta, a_tiles, index=None)`` —
  ``out = (A ⊙ (xl @ xr^T)) @ xv``, f32 ``[N, d]``; ``xv is xr`` shares
  the gathered rows;
* ``spmm_sfused_bwd(x, dy, meta, a_tiles, xw=None, dyw=None, index=None)``
  — ``(dx3, u)``, both f32: ``dx3 = (A⊙S) @ dy + (A⊙(T+U)) @ x`` and
  ``u = (A⊙S) @ x`` with ``S = xw x^T``, ``T = dyw x^T``, ``U = xw dy^T``
  (window rows from ``xw``/``dyw``, which default to ``x``/``dy``);
* ``sgt_row_index(meta, a_tiles)``: the tiles' per-row index
  (``ops/row_index.py::RowIndex``), which K2 and K3 walk on the card in
  place of the tiles: ``row_ptr`` over the window rows, each nonzero's row,
  gathered row ``col_ids[b * blk_w + k]`` and tile value, within a row in
  block then column order, derived on the device from the tiles at upload.

The window side (``xl``, ``xw``, ``dyw``) has ``meta.num_rows`` rows and
the gathered side ``meta.num_src``: equal on one device, different for a
shard of the distributed layer, whose gathers read its halo slab.

The JAX contract, rounding included: operands cast to the compute dtype
before the gather, scores and products summed in f32, the score rounded to
the compute dtype before it multiplies the tile entry and that product
formed in the compute dtype (``a * s.astype(ct)``), ``t + u`` summed in f32
before its one cast.

Each wrapper launches its hand-written CUDA kernel
(``csrc/spmm_sfused.cu``) over ``index`` for a CUDA tensor (and raises
without one), and runs its plain PyTorch version (``*_torch``: the JAX
algorithm as batched tile products and a per-window ``index_add_``, over
the tiles, so an independent check of index and kernel) for a CPU tensor
only.  Counters: ``launches`` and ``plain_calls`` on each wrapper.  The
kernels take any d, as the JAX kernels pad d to lanes: up to 128 a lane
group forms each score from all of d, past it each 128-column tile of the
output gets its own (grid.y) and forms the full scores again.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops import row_index
from tcgnn_tpu_torch.ops.row_index import INDEX_SLAB, RowIndex, from_rows
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND, TILE_KIND
from tcgnn_tpu_torch.sgt.translate import TorchSGTMeta


def sgt_row_index(meta: TorchSGTMeta, a_tiles: torch.Tensor) -> RowIndex:
    """The per-row index of the condensed tiles ``a_tiles`` over
    ``meta.num_rows`` window rows, on the tiles' device: the nonzero entries
    of the blocks the windows hold (``win_start``; padding blocks past them
    are skipped), ``INDEX_SLAB`` tile entries at a time, each taken to its
    row ``block_window[b] * blk_h + r`` and gathered row ``col_ids[b * blk_w
    + k]``, then sorted by row, stably: a row's nonzeros by block, then
    column.  Entries outside the rows or the gathered side (none in a tiling
    the SGT pass builds) are dropped."""
    cfg = meta.config
    bh, bw = cfg.blk_h, cfg.blk_w
    dev = a_tiles.device
    tile = bh * bw
    flat = a_tiles.reshape(-1)[:int(meta.win_start[-1]) * tile]
    block_window = meta.block_window.to(dev).long()
    col_ids = meta.col_ids.to(dev).long()
    rows, cols, vals = [], [], []
    for s0 in range(0, flat.numel(), INDEX_SLAB):
        p = torch.nonzero(flat[s0:s0 + INDEX_SLAB]).squeeze(1) + s0
        b, q = p // tile, p % tile
        r = block_window[b] * bh + q // bw
        c = col_ids[b * bw + q % bw]
        keep = (r < meta.num_rows) & (c >= 0) & (c < meta.num_src)
        rows.append(r[keep])
        cols.append(c[keep].to(torch.int32))
        vals.append(flat[p[keep]])
    if not rows:
        rows = [torch.zeros(0, dtype=torch.int64, device=dev)]
        cols = [torch.zeros(0, dtype=torch.int32, device=dev)]
        vals = [torch.zeros(0, dtype=a_tiles.dtype, device=dev)]
    row = torch.cat(rows)
    order = torch.sort(row, stable=True).indices
    return from_rows(row[order], torch.cat(cols)[order], torch.cat(vals)[order], meta.num_rows,
                     with_rows=True)


def check_sgt_index(op: str, index, meta: TorchSGTMeta, a_tiles, device) -> None:
    """Raise unless ``index`` fits the tiles: ``sgt_row_index``'s, of
    ``meta.num_rows`` rows, each nonzero's row held, the tiles' dtype, its
    arrays readable on ``device``."""
    row_index.check_row_index(op, index, meta.num_rows, a_tiles.numel(), a_tiles.dtype, device,
                              "sgt_row_index(meta, a_tiles)", needs_rows=True)


def _windows(x, meta):
    """Each TC block's window rows of x: ``[B, blk_h, d]``, zero past
    x's rows."""
    cfg = meta.config
    n, d = x.shape
    xw = torch.nn.functional.pad(x, (0, 0, 0, meta.num_windows * cfg.blk_h - n))
    return xw.view(meta.num_windows, cfg.blk_h, d).index_select(0, meta.block_window).float()


def _gathered(x, meta):
    """Each TC block's gathered column rows of x: ``[B, blk_w, d]``."""
    return x.index_select(0, meta.col_ids).view(meta.num_blocks, meta.config.blk_w, -1).float()


def _window_sum(part, meta):
    """Per-block products ``[B, blk_h, d]`` summed per window:
    ``[num_rows, d]`` f32."""
    cfg = meta.config
    out = torch.zeros((meta.num_windows, cfg.blk_h, part.shape[-1]), dtype=torch.float32,
                      device=part.device)
    out.index_add_(0, meta.block_window, part)
    return out.view(-1, part.shape[-1])[:meta.num_rows]


def spmm_sfused_torch(xl, xr, xv, meta: TorchSGTMeta, a_tiles) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    ct = meta.config.compute_dtype
    xl_w = _windows(xl.to(ct), meta)
    xr_g = _gathered(xr.to(ct), meta)
    xv_g = xr_g if xv is xr else _gathered(xv.to(ct), meta)
    s = torch.bmm(xl_w, xr_g.transpose(1, 2))  # [B, blk_h, blk_w] f32
    w = a_tiles.to(ct) * s.to(ct)
    return _window_sum(torch.bmm(w.float(), xv_g), meta)


def spmm_sfused_bwd_torch(x, dy, meta: TorchSGTMeta, a_tiles, xw=None, dyw=None):
    """Plain PyTorch version of K3."""
    ct = meta.config.compute_dtype
    xw = x if xw is None else xw
    dyw = dy if dyw is None else dyw
    x_w, dy_w = _windows(xw.to(ct), meta), _windows(dyw.to(ct), meta)
    x_g, dy_g = _gathered(x.to(ct), meta), _gathered(dy.to(ct), meta)
    s = torch.bmm(x_w, x_g.transpose(1, 2))
    t = torch.bmm(dy_w, x_g.transpose(1, 2))
    w2 = torch.bmm(x_w, dy_g.transpose(1, 2))
    a = a_tiles.to(ct)
    cs = (a * s.to(ct)).float()
    g = (a * (t + w2).to(ct)).float()
    dx3 = _window_sum(torch.bmm(cs, dy_g) + torch.bmm(g, x_g), meta)
    return dx3, _window_sum(torch.bmm(cs, x_g), meta)


def _check_sides(op, meta, window, gathered):
    """The window-side operands have ``meta.num_rows`` rows, the gathered
    ones ``meta.num_src``; all 2-D, of one width and device."""
    for name, ts, rows in (("window-side", window, meta.num_rows),
                           ("gathered", gathered, meta.num_src)):
        for t in ts:
            if t.dim() != 2 or t.shape[0] != rows:
                raise ValueError(f"{op}: {name} operand of shape {tuple(t.shape)}, expected "
                                 f"[{rows}, d]")
    ref = window[0]
    for t in (*window, *gathered):
        if t.shape[1] != ref.shape[1] or t.device != ref.device:
            raise ValueError(f"{op}: operands {tuple(t.shape)} on {t.device} and "
                             f"{tuple(ref.shape)} on {ref.device}")


def _check_kernel(op, x, meta, a_tiles, index) -> None:
    """What K2/K3 take: a compute dtype and tile dtype they have a kernel
    for, and the tiles' row index on x's device."""
    if meta.config.compute_dtype not in FEAT_KIND:
        raise TypeError(f"{op}: no kernel for compute dtype {meta.config.compute_dtype}")
    if a_tiles.dtype not in TILE_KIND:
        raise TypeError(f"{op}: no kernel for tile dtype {a_tiles.dtype}")
    check_sgt_index(op, index, meta, a_tiles, x.device)


def _index_tail(x, meta, index):
    """K2/K3's index pointers, then their int arguments and stream."""
    return ((index.rows.data_ptr(), index.cols.data_ptr(), index.vals.data_ptr()),
            (meta.num_rows, x.shape[1], index.nnz, FEAT_KIND[meta.config.compute_dtype],
             TILE_KIND[index.vals.dtype], _kernels.stream_of(x)))


@_kernels.counted
def spmm_sfused(xl, xr, xv, meta: TorchSGTMeta, a_tiles, index=None) -> torch.Tensor:
    """``(A ⊙ (xl @ xr^T)) @ xv``, ``[meta.num_rows, d]`` f32; pass ``xv
    is xr`` to share the gathered rows.  The window side ``xl`` has
    ``meta.num_rows`` rows, the gathered ``xr`` and ``xv``
    ``meta.num_src``.  A CUDA tensor runs K2 over ``index`` (the tiles'
    ``sgt_row_index``; raises without one); a CPU tensor runs the plain
    version over the tiles."""
    _check_sides("spmm_sfused", meta, (xl,), (xr, xv))
    if xl.device.type == "cpu":
        if index is not None:
            check_sgt_index("spmm_sfused", index, meta, a_tiles, xl.device)
        spmm_sfused.plain_calls += 1
        return spmm_sfused_torch(xl, xr, xv, meta, a_tiles)
    if xl.device.type != "cuda":
        raise ValueError(f"spmm_sfused: no kernel for device {xl.device}")
    _check_kernel("spmm_sfused", xl, meta, a_tiles, index)
    ct = meta.config.compute_dtype
    n, d = meta.num_rows, xl.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=xl.device)
    if n == 0 or d == 0:
        return out
    l_ = xl.to(ct).contiguous()
    r = l_ if xr is xl else xr.to(ct).contiguous()
    v = None if xv is xr else (l_ if xv is xl else xv.to(ct).contiguous())
    ptrs, tail = _index_tail(xl, meta, index)
    _kernels.call("spmm_sfused", "tcgnn_spmm_sfused", xl.device, l_.data_ptr(), r.data_ptr(),
                  None if v is None else v.data_ptr(), *ptrs, out.data_ptr(), *tail)
    spmm_sfused.launches += 1
    return out


@_kernels.counted
def spmm_sfused_bwd(x, dy, meta: TorchSGTMeta, a_tiles, xw=None, dyw=None, index=None):
    """The AGNN backward in one pass: ``(dx3, u)``, both
    ``[meta.num_rows, d]`` f32.  The gathers read ``x`` and ``dy``
    (``meta.num_src`` rows); the window side reads ``xw`` and ``dyw``
    (``meta.num_rows`` rows), which default to ``x`` and ``dy``: a split
    stream's guest windows hold their owners' rows, so there the two sides
    differ.  A CUDA tensor runs K3 over ``index`` (raises without one); a
    CPU tensor runs the plain version over the tiles."""
    xw = x if xw is None else xw
    dyw = dy if dyw is None else dyw
    _check_sides("spmm_sfused_bwd", meta, (xw, dyw), (x, dy))
    if x.device.type == "cpu":
        if index is not None:
            check_sgt_index("spmm_sfused_bwd", index, meta, a_tiles, x.device)
        spmm_sfused_bwd.plain_calls += 1
        return spmm_sfused_bwd_torch(x, dy, meta, a_tiles, xw, dyw)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_sfused_bwd: no kernel for device {x.device}")
    _check_kernel("spmm_sfused_bwd", x, meta, a_tiles, index)
    ct = meta.config.compute_dtype
    n, d = meta.num_rows, x.shape[1]
    dx3 = torch.empty((n, d), dtype=torch.float32, device=x.device)
    u = torch.empty_like(dx3)
    if n == 0 or d == 0:
        return dx3, u
    xc, dyc = x.to(ct).contiguous(), dy.to(ct).contiguous()
    xwc = xc if xw is x else xw.to(ct).contiguous()
    dywc = dyc if dyw is dy else dyw.to(ct).contiguous()
    ptrs, tail = _index_tail(x, meta, index)
    _kernels.call("spmm_sfused", "tcgnn_spmm_sfused_bwd", x.device, xc.data_ptr(),
                  dyc.data_ptr(), xwc.data_ptr(), dywc.data_ptr(), *ptrs, dx3.data_ptr(),
                  u.data_ptr(), *tail)
    spmm_sfused_bwd.launches += 1
    return dx3, u
