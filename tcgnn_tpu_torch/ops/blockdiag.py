"""Block-diagonal (BD) ops: making the packs, and K5, K6, K7 of the port.

Counterparts in ``tcgnn_tpu.ops.spmm``:

* ``build_bd_pack`` (``build_bd_pack``): the sparse tile contents of a
  ``BDMeta`` scattered into the kernels' pack ``[Bp, bn, K*bn]``: row
  ``b * bn + r`` holds node row ``b * bn + r``'s entries in the K diagonal
  bins ``b + offsets[k]``, side by side.  ``Bp`` is the bin count rounded up
  to ``BD_BIN_GROUP`` as in JAX (padding bins are zero).  The pack keeps
  the counts' dtype: int8, or int16 when a duplicate count passes 127;
* ``bd_scatter_weights`` (``bd_scatter_weights``): per-edge weights
  scattered into a pack of the compute dtype; duplicate edges sum in the
  compute dtype, as JAX casts before its scatter;
* ``spmm_block_diag`` (K5, ``_bd_plain_kernel``):
  ``out_bin[b] = pack[b] @ vstack(x_bin[b + k] for k in offsets)``;
* ``bd_sfused`` (K6, ``_bd_sfused_kernel``):
  ``out_bin[b] = sum_k (C_k[b] ⊙ (xl_bin[b] @ xr_bin[b+k]^T)) @ xv_bin[b+k]``;
* ``bd_sfused_bwd`` (K7, ``_bd_sfused_bwd_kernel``), one pass:
  ``dx3 = (C⊙S) @ dy + (C⊙(T+U)) @ x`` and ``u = (C⊙S) @ x`` with
  ``S = x x^T``, ``T = dy x^T``, ``U = x dy^T`` on the packed diagonals;
* ``bd_row_index``: the pack's per-row index (``BDRowIndex``), which K6 and
  K7 walk on the card in place of the pack: ``row_ptr`` over the node rows
  and each nonzero's node column and value, in the pack's order, derived
  on the device from the pack itself.

The JAX contract, rounding included: pack and features cast to the compute
dtype, every product summed in f32, the score rounded to the compute dtype
before it multiplies the pack entry and that product formed in it, ``t + u``
summed in f32 before its one cast, and every output **stored in the compute
dtype**.  Bins past the graph read zeros.

Each wrapper launches its hand-written CUDA kernel (``csrc/spmm_bd.cu``)
for a CUDA tensor, and runs its plain PyTorch version (``*_torch``: the JAX
halo-stack formulation, ``torch.bmm`` on the stacked ``[Bp, K*bn, d]``
operand) for a CPU tensor only.  K5 reads the pack; K6 and K7 read its
per-row index, which ``bd_sfused``/``bd_sfused_bwd`` take as ``index``
(required for a CUDA tensor; the plain versions read the pack).  Counters: ``launches`` and
``plain_calls`` on each wrapper.  A launch does little host work: the C
function looked up once (``_kernels.call``), an offset set's C array made
once, x cast or copied only when it is not contiguous in the compute dtype.

What the port does differently, changing no value: K5 takes any offset set
(JAX keeps an XLA einsum for offsets past its 3-panel halo, a Pallas
limit); K6's wrapper takes three tensors and needs no operand identity to
pick a DMA layout (JAX's ``xl is xr`` only chooses which panels to fetch);
K6 and K7 walk the index, not the pack.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

from typing import Optional

import torch
import torch.nn.functional as F

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.spmm import FEAT_KIND
from tcgnn_tpu_torch.sgt.blockdiag import packed_index

# Bin padding granule of the pack (the JAX kernels' grid step).
BD_BIN_GROUP = 8
PACK_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2, torch.int16: 3}
KERNEL_MAX_K = 8         # the kernels hold the offsets in a fixed array
KERNEL_MAX_STRIPE = 1024  # K * bn: 32 entries a lane (K5's mask)
# Flat pack entries ``bd_row_index`` scans at once: under one ``nonzero``
# call's limit (YeastH's pack has 2.01e9 entries).
INDEX_SLAB = 1 << 28


def padded_bins(num_bins: int) -> int:
    return -(-max(num_bins, 1) // BD_BIN_GROUP) * BD_BIN_GROUP


def build_bd_pack(tile_idx: torch.Tensor, tile_cnt: torch.Tensor, *, k: int, nbins: int,
                  bn: int) -> torch.Tensor:
    """``[K, B, bn, bn]`` flat tile indices and counts -> the pack
    ``[Bp, bn, K*bn]`` in ``tile_cnt``'s dtype, on their device."""
    bp = padded_bins(nbins)
    flat = torch.zeros(bp * bn * k * bn, dtype=tile_cnt.dtype, device=tile_cnt.device)
    flat[packed_index(tile_idx.long(), nbins, k, bn)] = tile_cnt
    return flat.view(bp, bn, k * bn)


def bd_scatter_weights(w_cov: torch.Tensor, cov_pack_idx: torch.Tensor, *, bp: int, bn: int,
                       k: int, dtype: torch.dtype) -> torch.Tensor:
    """Per-edge weights of the covered edges -> a weighted pack
    ``[bp, bn, K*bn]`` of ``dtype``; duplicate edges add up in ``dtype``."""
    flat = torch.zeros(bp * bn * k * bn, dtype=dtype, device=w_cov.device)
    flat.index_add_(0, cov_pack_idx, w_cov.to(dtype))
    return flat.view(bp, bn, k * bn)


@dataclasses.dataclass(frozen=True)
class BDRowIndex:
    """A pack's nonzeros by node row, which K6 and K7 walk: row ``i``'s are
    ``[row_ptr[i], row_ptr[i + 1])``, each with its node column ``cols``
    and its value ``vals`` (the pack's dtype), in the pack's order (offset,
    then column: ascending node column)."""

    row_ptr: torch.Tensor  # [n + 1] int64
    cols: torch.Tensor     # [nnz] int32
    vals: torch.Tensor     # [nnz] the pack's dtype
    # What a launch checks, worked out once here: the device a kernel can
    # read the arrays on (all three there, contiguous, int64 row pointers,
    # int32 columns, a value a column), else None.
    kernel_device: Optional[torch.device] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        arrays = (self.row_ptr, self.cols, self.vals)
        dev = self.row_ptr.device
        ok = (all(t.device == dev and t.is_contiguous() for t in arrays)
              and self.row_ptr.dtype == torch.int64 and self.cols.dtype == torch.int32
              and self.cols.numel() == self.vals.numel())
        object.__setattr__(self, "kernel_device", dev if ok else None)

    @property
    def num_rows(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.cols.numel()


def bd_row_index(pack: torch.Tensor, offsets, n: int) -> BDRowIndex:
    """The per-row index of ``pack`` over ``n`` node rows, on the pack's
    device: the flat pack's nonzero positions in order, ``INDEX_SLAB``
    entries at a time, each taken to its node row ``p // (K*bn)`` and column
    ``(b + offsets[j // bn]) * bn + j % bn`` (``b`` the row's bin, ``j``
    its place in the row).  Entries outside the graph (padding rows, or a
    column past either end) are dropped, as the kernels drop them."""
    bn, stripe = pack.shape[1], pack.shape[2]
    offs = torch.tensor(offsets, dtype=torch.int64, device=pack.device)
    flat = pack.reshape(-1)
    rows, cols, vals = [], [], []
    for s0 in range(0, n * stripe, INDEX_SLAB):
        p = torch.nonzero(flat[s0:min(s0 + INDEX_SLAB, n * stripe)]).squeeze(1) + s0
        r, j = p // stripe, p % stripe
        c = (r // bn + offs[j // bn]) * bn + j % bn
        keep = (c >= 0) & (c < n)
        rows.append(r[keep])
        cols.append(c[keep].to(torch.int32))
        vals.append(flat[p[keep]])
    row = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64, device=pack.device)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=pack.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    cols = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int32, device=pack.device)
    vals = torch.cat(vals) if vals else torch.zeros(0, dtype=pack.dtype, device=pack.device)
    return BDRowIndex(row_ptr=row_ptr, cols=cols, vals=vals)


def check_row_index(op: str, index, x: torch.Tensor, pack: torch.Tensor) -> None:
    """Raise unless ``index`` is a ``BDRowIndex`` that fits x and the pack:
    a row for each of x's rows, no more nonzeros than the pack's rows can
    hold, the pack's value dtype, and arrays a kernel can read on x's
    device."""
    if index is None:
        raise ValueError(f"{op}: the kernel walks the pack's row index: pass index="
                         f"bd_row_index(pack, offsets, n)")
    n = x.shape[0]
    if index.num_rows != n:
        raise ValueError(f"{op}: row index of {index.num_rows} rows for {n} nodes")
    if index.nnz > n * pack.shape[2]:
        raise ValueError(f"{op}: row index nonzero count {index.nnz} does not fit {n} pack rows "
                         f"of {pack.shape[2]}")
    if index.vals.dtype != pack.dtype:
        raise TypeError(f"{op}: row index values {index.vals.dtype}, pack {pack.dtype}")
    if index.kernel_device != x.device:
        raise ValueError(f"{op}: row index arrays on {index.row_ptr.device} must be contiguous "
                         f"int64 row_ptr, int32 cols and a value a column, on {x.device}")


# ---- plain versions ---------------------------------------------------------

def _bins(x: torch.Tensor, bp: int, bn: int) -> torch.Tensor:
    """``x`` as ``[bp, bn, d]`` bins, zero past N, in f32."""
    n, d = x.shape
    return F.pad(x, (0, 0, 0, bp * bn - n)).view(bp, bn, d).float()


def _bd_stack(x: torch.Tensor, bp: int, bn: int, offsets) -> torch.Tensor:
    """Halo stack ``xs[b] = vstack(x_bin[b + k] for k in offsets)``,
    ``[bp, K*bn, d]`` in f32; bins outside the graph are zero."""
    n, d = x.shape
    # The halo range includes 0 so one-signed offset sets stay in bounds.
    kmin, kmax = min(0, min(offsets)), max(0, max(offsets))
    xb = F.pad(x, (0, 0, -kmin * bn, (bp * bn - n) + kmax * bn)).view(bp + kmax - kmin, bn, d)
    return torch.stack([xb[o - kmin:o - kmin + bp] for o in offsets], dim=1).reshape(
        bp, len(offsets) * bn, d).float()


def spmm_block_diag_torch(x, pack, *, offsets, cfg: TileConfig) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    ct = cfg.compute_dtype
    bp, bn = pack.shape[0], pack.shape[1]
    n, d = x.shape
    out = torch.bmm(pack.to(ct).float(), _bd_stack(x.to(ct), bp, bn, offsets))
    return out.view(bp * bn, d)[:n].to(ct)


def bd_sfused_torch(xl, xr, xv, pack, *, offsets, cfg: TileConfig) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    ct = cfg.compute_dtype
    bp, bn = pack.shape[0], pack.shape[1]
    n, d = xl.shape
    xs = _bd_stack(xr.to(ct), bp, bn, offsets)
    vs = xs if xv is xr else _bd_stack(xv.to(ct), bp, bn, offsets)
    s = torch.bmm(_bins(xl.to(ct), bp, bn), xs.transpose(1, 2))  # [bp, bn, K*bn] f32
    w = pack.to(ct) * s.to(ct)
    return torch.bmm(w.float(), vs).view(bp * bn, d)[:n].to(ct)


def bd_sfused_bwd_torch(x, dy, pack, *, offsets, cfg: TileConfig):
    """Plain PyTorch version of K7."""
    ct = cfg.compute_dtype
    bp, bn = pack.shape[0], pack.shape[1]
    n, d = x.shape
    xw, dyw = _bins(x.to(ct), bp, bn), _bins(dy.to(ct), bp, bn)
    xs, dys = _bd_stack(x.to(ct), bp, bn, offsets), _bd_stack(dy.to(ct), bp, bn, offsets)
    s = torch.bmm(xw, xs.transpose(1, 2))
    t = torch.bmm(dyw, xs.transpose(1, 2))
    w2 = torch.bmm(xw, dys.transpose(1, 2))
    c = pack.to(ct)
    cs = (c * s.to(ct)).float()
    dx3 = torch.bmm(cs, dys) + torch.bmm((c * (t + w2).to(ct)).float(), xs)
    u = torch.bmm(cs, xs)
    return dx3.view(bp * bn, d)[:n].to(ct), u.view(bp * bn, d)[:n].to(ct)


# ---- kernel wrappers --------------------------------------------------------

def _check(op, x, pack, offsets, cfg):
    """What K5-K7 take: the compute dtype and pack dtype they have a kernel
    for, at most ``KERNEL_MAX_K`` offsets and a stripe of at most
    ``KERNEL_MAX_STRIPE``, and the pack on x's device, contiguous."""
    if cfg.compute_dtype not in FEAT_KIND:
        raise TypeError(f"{op}: no kernel for compute dtype {cfg.compute_dtype}")
    if pack.dtype not in PACK_KIND:
        raise TypeError(f"{op}: no kernel for pack dtype {pack.dtype}")
    k, bn = len(offsets), pack.shape[1]
    if not 1 <= k <= KERNEL_MAX_K or k * bn > KERNEL_MAX_STRIPE:
        raise ValueError(f"{op}: the kernel takes 1 to {KERNEL_MAX_K} offsets and "
                         f"K * bn <= {KERNEL_MAX_STRIPE}, got K={k}, bn={bn}")
    if pack.device != x.device or not pack.is_contiguous():
        _kernels.check_operands(op, x.device, pack)


def _check_shapes(op, x, pack, offsets, *others):
    """x ``[N, d]``, a pack ``[Bp, bn, K*bn]`` with a row for every node, and
    the other operands shaped and placed as x."""
    n = x.shape[0]
    if x.dim() != 2 or pack.dim() != 3 or pack.shape[2] != len(offsets) * pack.shape[1]:
        raise ValueError(f"{op}: x {tuple(x.shape)} and pack {tuple(pack.shape)} do not fit "
                         f"{len(offsets)} offsets")
    if pack.shape[0] * pack.shape[1] < n:
        raise ValueError(f"{op}: pack of {pack.shape[0]} bins of {pack.shape[1]} rows for "
                         f"{n} nodes")
    for t in others:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{op}: operands {tuple(t.shape)} on {t.device} and "
                             f"{tuple(x.shape)} on {x.device}")


@functools.lru_cache(maxsize=64)
def _offsets_array(offsets: tuple):
    """An offset set as a C int array, made once a set (kept alive here)."""
    return (ctypes.c_int * len(offsets))(*offsets)


def _offsets_arg(offsets) -> int:
    """The address of the offsets' C int array, for a launch."""
    return ctypes.addressof(_offsets_array(tuple(offsets)))


def _tail(x, pack, offsets, cfg):
    """The C functions' int arguments and stream."""
    n, d = x.shape
    return (n, d, len(offsets), pack.shape[1], FEAT_KIND[cfg.compute_dtype],
            PACK_KIND[pack.dtype], _kernels.stream_of(x))


@_kernels.counted
def spmm_block_diag(x, pack, *, offsets, cfg: TileConfig) -> torch.Tensor:
    """Block-diagonal SpMM ``out = A_bd @ x`` over the covered offsets,
    ``[N, d]`` in the compute dtype (the caller adds the residual).  A CUDA
    tensor runs K5 (or raises); a CPU tensor runs the plain version.  K5
    streams the pack in 16-byte units and gathers only the rows of x its
    nonzeros name (``csrc/spmm_bd.cu``)."""
    _check_shapes("spmm_block_diag", x, pack, offsets)
    if x.device.type == "cpu":
        spmm_block_diag.plain_calls += 1
        return spmm_block_diag_torch(x, pack, offsets=offsets, cfg=cfg)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_block_diag: no kernel for device {x.device}")
    _check("spmm_block_diag", x, pack, offsets, cfg)
    ct = cfg.compute_dtype
    n, d = x.shape
    out = torch.empty((n, d), dtype=ct, device=x.device)
    if n == 0 or d == 0:
        return out
    xc = x if x.dtype == ct and x.is_contiguous() else x.to(ct).contiguous()
    _kernels.call("spmm_bd", "tcgnn_spmm_bd", x.device, xc.data_ptr(), pack.data_ptr(),
                  _offsets_arg(offsets), out.data_ptr(), *_tail(x, pack, offsets, cfg))
    spmm_block_diag.launches += 1
    return out


def _index_tail(x, index, cfg):
    """K6/K7's index pointers, int arguments and stream."""
    n, d = x.shape
    return (index.row_ptr.data_ptr(), index.cols.data_ptr(), index.vals.data_ptr(), n, d,
            FEAT_KIND[cfg.compute_dtype], PACK_KIND[index.vals.dtype], _kernels.stream_of(x))


@_kernels.counted
def bd_sfused(xl, xr, xv, pack, *, offsets, cfg: TileConfig, index=None) -> torch.Tensor:
    """Score-fused BD SpMM ``(C ⊙ (xl @ xr^T)) @ xv`` on the packed
    diagonals, ``[N, d]`` in the compute dtype, any d; ``xv is xr`` reads
    the shared rows once.  A CUDA tensor runs K6 over ``index`` (the pack's
    ``bd_row_index``; raises without one); a CPU tensor runs the plain
    version over the pack."""
    _check_shapes("bd_sfused", xl, pack, offsets, xr, xv)
    if xl.device.type == "cpu":
        if index is not None:
            check_row_index("bd_sfused", index, xl, pack)
        bd_sfused.plain_calls += 1
        return bd_sfused_torch(xl, xr, xv, pack, offsets=offsets, cfg=cfg)
    if xl.device.type != "cuda":
        raise ValueError(f"bd_sfused: no kernel for device {xl.device}")
    _check("bd_sfused", xl, pack, offsets, cfg)
    check_row_index("bd_sfused", index, xl, pack)
    ct = cfg.compute_dtype
    n, d = xl.shape
    out = torch.empty((n, d), dtype=ct, device=xl.device)
    if n == 0 or d == 0:
        return out
    l_ = xl.to(ct).contiguous()
    r = l_ if xr is xl else xr.to(ct).contiguous()
    v = None if xv is xr else (l_ if xv is xl else xv.to(ct).contiguous())
    tail = _index_tail(xl, index, cfg)
    _kernels.call("spmm_bd", "tcgnn_bd_sfused", xl.device, l_.data_ptr(), r.data_ptr(),
                  None if v is None else v.data_ptr(), *tail[:3], out.data_ptr(), *tail[3:])
    bd_sfused.launches += 1
    return out


@_kernels.counted
def bd_sfused_bwd(x, dy, pack, *, offsets, cfg: TileConfig, index=None):
    """The BD AGNN backward in one pass: ``(dx3, u)``, both ``[N, d]`` in
    the compute dtype, any d.  A CUDA tensor runs K7 over ``index`` (raises
    without one); a CPU tensor runs the plain version over the pack."""
    _check_shapes("bd_sfused_bwd", x, pack, offsets, dy)
    if x.device.type == "cpu":
        if index is not None:
            check_row_index("bd_sfused_bwd", index, x, pack)
        bd_sfused_bwd.plain_calls += 1
        return bd_sfused_bwd_torch(x, dy, pack, offsets=offsets, cfg=cfg)
    if x.device.type != "cuda":
        raise ValueError(f"bd_sfused_bwd: no kernel for device {x.device}")
    _check("bd_sfused_bwd", x, pack, offsets, cfg)
    check_row_index("bd_sfused_bwd", index, x, pack)
    ct = cfg.compute_dtype
    n, d = x.shape
    dx3 = torch.empty((n, d), dtype=ct, device=x.device)
    u = torch.empty_like(dx3)
    if n == 0 or d == 0:
        return dx3, u
    xc, dyc = x.to(ct).contiguous(), dy.to(ct).contiguous()
    tail = _index_tail(x, index, cfg)
    _kernels.call("spmm_bd", "tcgnn_bd_sfused_bwd", x.device, xc.data_ptr(), dyc.data_ptr(),
                  *tail[:3], dx3.data_ptr(), u.data_ptr(), *tail[3:])
    bd_sfused_bwd.launches += 1
    return dx3, u
