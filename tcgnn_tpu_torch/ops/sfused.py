"""Score-fused SpMM and its one-pass backward over SGT tiles (K2 and K3).

Counterparts of ``tcgnn_tpu.ops.spmm.spmm_sfused`` and
``spmm_sfused_bwd``, the AGNN aggregation on symmetric graphs:

* ``spmm_sfused(xl, xr, xv, meta, a_tiles)`` —
  ``out = (A ⊙ (xl @ xr^T)) @ xv``, f32 ``[N, d]``; ``xv is xr`` shares
  the gathered rows;
* ``spmm_sfused_bwd(x, dy, meta, a_tiles, xw=None, dyw=None)`` —
  ``(dx3, u)``, both f32: ``dx3 = (A⊙S) @ dy + (A⊙(T+U)) @ x`` and
  ``u = (A⊙S) @ x`` with ``S = xw x^T``, ``T = dyw x^T``, ``U = xw dy^T``
  (window rows from ``xw``/``dyw``, which default to ``x``/``dy``).

The window side (``xl``, ``xw``, ``dyw``) has ``meta.num_rows`` rows and
the gathered side ``meta.num_src``: equal on one device, different for a
shard of the distributed layer, whose gathers read its halo slab.

The JAX contract, rounding included: operands cast to the compute dtype
before the gather, scores and products summed in f32, the score rounded to
the compute dtype before it multiplies the tile entry and that product
formed in the compute dtype (``a * s.astype(ct)``), ``t + u`` summed in f32
before its one cast.

Each wrapper launches its hand-written CUDA kernel
(``csrc/spmm_sfused.cu``) for a CUDA tensor, and runs its plain PyTorch
version (``*_torch``: the JAX algorithm as batched tile products and a
per-window ``index_add_``) for a CPU tensor only.  Counters: ``launches``
and ``plain_calls`` on each wrapper.  The kernels take d <= 128, as the
JAX kernel does no d-tiling either.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND, TILE_KIND, check_tiled_operands
from tcgnn_tpu_torch.sgt.translate import KERNEL_RUN_BLOCKS, TorchSGTMeta

KERNEL_MAX_D = 128  # a lane holds up to 4 feature columns


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


def _check(op, x, meta, a_tiles):
    check_tiled_operands(op, x, meta, a_tiles)
    if x.shape[1] > KERNEL_MAX_D:
        raise ValueError(f"{op}: the kernel takes d <= {KERNEL_MAX_D}, got {x.shape[1]}")


def _args(x, meta, a_tiles):
    """The C functions' int arguments and stream, after the pointers."""
    cfg = meta.config
    return (meta.num_rows, x.shape[1], meta.run_window.shape[0], KERNEL_RUN_BLOCKS,
            int(meta.max_window_blocks > KERNEL_RUN_BLOCKS), cfg.blk_h, cfg.blk_w,
            FEAT_KIND[cfg.compute_dtype], TILE_KIND[a_tiles.dtype], _kernels.stream_of(x))


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


def _meta_ptrs(meta, a_tiles):
    """The tiles' and the window metadata's pointers, in the C order."""
    return (a_tiles.data_ptr(), meta.col_ids.data_ptr(), meta.win_start.data_ptr(),
            meta.run_window.data_ptr(), meta.run_block.data_ptr())


@_kernels.counted
def spmm_sfused(xl, xr, xv, meta: TorchSGTMeta, a_tiles) -> torch.Tensor:
    """``(A ⊙ (xl @ xr^T)) @ xv``, ``[meta.num_rows, d]`` f32; pass ``xv
    is xr`` to share the gathered rows.  The window side ``xl`` has
    ``meta.num_rows`` rows, the gathered ``xr`` and ``xv``
    ``meta.num_src``.  A CUDA tensor runs K2 (or raises); a CPU tensor runs
    the plain version."""
    _check_sides("spmm_sfused", meta, (xl,), (xr, xv))
    if xl.device.type == "cpu":
        spmm_sfused.plain_calls += 1
        return spmm_sfused_torch(xl, xr, xv, meta, a_tiles)
    if xl.device.type != "cuda":
        raise ValueError(f"spmm_sfused: no kernel for device {xl.device}")
    _check("spmm_sfused", xr, meta, a_tiles)
    ct = meta.config.compute_dtype
    n, d = meta.num_rows, xl.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=xl.device)
    if n == 0 or d == 0:
        return out
    l_ = xl.to(ct).contiguous()
    r = l_ if xr is xl else xr.to(ct).contiguous()
    v = None if xv is xr else (l_ if xv is xl else xv.to(ct).contiguous())
    lib = _kernels.load("spmm_sfused")
    with torch.cuda.device(xl.device):
        err = lib.tcgnn_spmm_sfused(
            l_.data_ptr(), r.data_ptr(), None if v is None else v.data_ptr(),
            *_meta_ptrs(meta, a_tiles), out.data_ptr(), *_args(xl, meta, a_tiles),
        )
    _kernels.check(lib, err, "spmm_sfused")
    spmm_sfused.launches += 1
    return out


@_kernels.counted
def spmm_sfused_bwd(x, dy, meta: TorchSGTMeta, a_tiles, xw=None, dyw=None):
    """The AGNN backward in one pass: ``(dx3, u)``, both
    ``[meta.num_rows, d]`` f32.  The gathers read ``x`` and ``dy``
    (``meta.num_src`` rows); the window side reads ``xw`` and ``dyw``
    (``meta.num_rows`` rows), which default to ``x`` and ``dy``: a split
    stream's guest windows hold their owners' rows, so there the two sides
    differ.  A CUDA tensor runs K3 (or raises); a CPU tensor runs the plain
    version."""
    xw = x if xw is None else xw
    dyw = dy if dyw is None else dyw
    _check_sides("spmm_sfused_bwd", meta, (xw, dyw), (x, dy))
    if x.device.type == "cpu":
        spmm_sfused_bwd.plain_calls += 1
        return spmm_sfused_bwd_torch(x, dy, meta, a_tiles, xw, dyw)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_sfused_bwd: no kernel for device {x.device}")
    _check("spmm_sfused_bwd", x, meta, a_tiles)
    ct = meta.config.compute_dtype
    n, d = meta.num_rows, x.shape[1]
    dx3 = torch.empty((n, d), dtype=torch.float32, device=x.device)
    u = torch.empty_like(dx3)
    if n == 0 or d == 0:
        return dx3, u
    xc, dyc = x.to(ct).contiguous(), dy.to(ct).contiguous()
    xwc = xc if xw is x else xw.to(ct).contiguous()
    dywc = dyc if dyw is dy else dyw.to(ct).contiguous()
    lib = _kernels.load("spmm_sfused")
    with torch.cuda.device(x.device):
        err = lib.tcgnn_spmm_sfused_bwd(
            xc.data_ptr(), dyc.data_ptr(), xwc.data_ptr(), dywc.data_ptr(),
            *_meta_ptrs(meta, a_tiles), dx3.data_ptr(), u.data_ptr(), *_args(x, meta, a_tiles),
        )
    _kernels.check(lib, err, "spmm_sfused_bwd")
    spmm_sfused_bwd.launches += 1
    return dx3, u
