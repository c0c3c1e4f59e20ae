"""Dense-tile SpMM over SGT-tiled graphs (K1 of the port).

Counterpart of ``tcgnn_tpu.ops.spmm.spmm_tc_dense``: ``out = A @ x`` where A
is given as SGT-condensed dense tiles ``a_tiles [B, blk_h, blk_w]`` (int8
counts, or the compute dtype when a count exceeds 127) plus per-block
gather columns ``meta.col_ids``.  The contract is the JAX op's: ``x`` is cast
to the compute dtype before the gather, products accumulate in f32, and the
output is stored once in the compute dtype.

``spmm_tc_dense`` launches the hand-written CUDA kernel
(``csrc/spmm_dense.cu``: a warp a tile row over a run of at most
``KERNEL_RUN_BLOCKS`` TC blocks, its nonzeros listed, then only their rows
of x gathered) for a CUDA tensor, and runs the plain PyTorch version
``spmm_tc_dense_torch`` for a CPU tensor only.  Its two counters,
``spmm_tc_dense.launches`` and ``spmm_tc_dense.plain_calls``, record which
path ran.  The wrapper's host work is kept small, since the kernel takes
about as long: the metadata's index arrays are checked once, when the
``TorchSGTMeta`` is made (``kernel_device``), the C function is looked up
once (``_kernels.call``), and x is cast or copied only when it is not
already contiguous in the compute dtype.

``build_a_tiles`` scatters per-edge weights into f32 tiles for the weighted
SpMM (AGNN's attention); the kernel rounds them to the compute dtype as it
reads them, as the JAX kernel does.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops._kernels import reset_counts  # noqa: F401  (re-export)
from tcgnn_tpu_torch.sgt.translate import KERNEL_RUN_BLOCKS, TorchSGTMeta

FEAT_KIND = {torch.float32: 0, torch.bfloat16: 1}
TILE_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# K1/K10: a row of a run of 8 blocks in a lane's 32-entry mask; K2/K3: a tile
# row in 4 registers a lane.
KERNEL_MAX_BLK_W = 128


def build_a_tiles(
    meta: TorchSGTMeta, edge_weights: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Weighted dense A-tiles ``[B, blk_h, blk_w]``: each edge's weight
    scattered to its tile position (``meta.edge_pos``); duplicate edges sum.

    Counterpart of ``tcgnn_tpu.ops.spmm.build_a_tiles``, an XLA scatter-add
    there and ``index_add_`` here (atomic on the card).
    """
    cfg = meta.config
    if edge_weights.shape != (meta.num_edges,):
        raise ValueError(
            f"build_a_tiles: weights of shape {tuple(edge_weights.shape)}, "
            f"expected ({meta.num_edges},)"
        )
    flat = torch.zeros(
        meta.num_blocks * cfg.blk_h * cfg.blk_w, dtype=dtype, device=edge_weights.device
    )
    flat.index_add_(0, meta.edge_pos, edge_weights.to(dtype))
    return flat.view(meta.num_blocks, cfg.blk_h, cfg.blk_w)


def spmm_tc_dense_torch(
    x: torch.Tensor, meta: TorchSGTMeta, a_tiles: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x[col_ids]``, a batched tile product,
    then a sum per window."""
    cfg = meta.config
    ct = cfg.compute_dtype
    d = x.shape[1]
    xg = x.to(ct).index_select(0, meta.col_ids).view(meta.num_blocks, cfg.blk_w, d)
    part = torch.bmm(a_tiles.to(ct).float(), xg.float())  # [B, blk_h, d]
    out = torch.zeros(
        (meta.num_windows, cfg.blk_h, d), dtype=torch.float32, device=x.device
    )
    out.index_add_(0, meta.block_window, part)
    return out.view(-1, d)[:meta.num_rows].to(ct)


def check_tiled_operands(op: str, x, meta, a_tiles) -> None:
    """What a kernel over the condensed tiles (K1, K2, K3, K10) takes: the
    compute dtype and the tiles it has a kernel for, blk_w <= 128, and the
    tiles and window metadata on x's device, contiguous.  The metadata's
    arrays were checked when it was made (``meta.kernel_device``); only
    where that check failed are they looked at again, to name the fault."""
    cfg = meta.config
    if cfg.compute_dtype not in FEAT_KIND:
        raise TypeError(f"{op}: no kernel for compute dtype {cfg.compute_dtype}")
    if cfg.blk_w > KERNEL_MAX_BLK_W:
        raise ValueError(f"{op}: the kernel takes blk_w <= {KERNEL_MAX_BLK_W}")
    if a_tiles.dtype not in TILE_KIND:
        raise TypeError(f"{op}: no kernel for tile dtype {a_tiles.dtype}")
    if a_tiles.shape != (meta.num_blocks, cfg.blk_h, cfg.blk_w):
        raise ValueError(
            f"{op}: tiles of shape {tuple(a_tiles.shape)}, expected "
            f"{(meta.num_blocks, cfg.blk_h, cfg.blk_w)}"
        )
    if (meta.kernel_device != x.device or a_tiles.device != x.device
            or not a_tiles.is_contiguous()):
        _kernels.check_operands(
            op, x.device, a_tiles, **{k: getattr(meta, k) for k in meta.KERNEL_INDEX})
    if x.numel() >= 2**31:
        raise ValueError(f"{op}: x has 2**31 elements or more")


def _spmm_dense_cuda(x, meta, a_tiles):
    check_tiled_operands("spmm_tc_dense", x, meta, a_tiles)
    cfg = meta.config
    ct = cfg.compute_dtype
    n, d = meta.num_rows, x.shape[1]
    if x.dtype != ct or not x.is_contiguous():
        x = x.to(ct).contiguous()
    out = torch.empty((n, d), dtype=ct, device=x.device)
    if n == 0 or d == 0:
        return out
    # Windows of more than KERNEL_RUN_BLOCKS TC blocks are split over thread
    # blocks that sum in f32: into `out` for f32, into this buffer for bf16.
    split = meta.max_window_blocks > KERNEL_RUN_BLOCKS
    accum = None
    if split and ct != torch.float32:
        accum = torch.empty((n, d), dtype=torch.float32, device=x.device)
    _kernels.call(
        "spmm_dense", "tcgnn_spmm_dense", x.device,
        x.data_ptr(), a_tiles.data_ptr(), meta.col_ids.data_ptr(),
        meta.win_start.data_ptr(), meta.run_window.data_ptr(),
        meta.run_block.data_ptr(), out.data_ptr(),
        None if accum is None else accum.data_ptr(),
        n, d, meta.num_windows, meta.run_window.shape[0], KERNEL_RUN_BLOCKS,
        int(split), cfg.blk_h, cfg.blk_w, FEAT_KIND[ct], TILE_KIND[a_tiles.dtype],
        _kernels.stream_of(x),
    )
    spmm_tc_dense.launches += 1
    return out


@_kernels.counted
def spmm_tc_dense(
    x: torch.Tensor, meta: TorchSGTMeta, a_tiles: torch.Tensor
) -> torch.Tensor:
    """Tensor-core-style SpMM via dense A-tiles: ``out = A @ x``,
    ``[meta.num_rows, d]`` in the compute dtype, from x of
    ``meta.num_src`` rows.  A CUDA tensor runs the kernel (or raises); a
    CPU tensor runs the plain version."""
    if x.dim() != 2 or x.shape[0] != meta.num_src:
        raise ValueError(
            f"spmm_tc_dense: x of shape {tuple(x.shape)}, expected "
            f"[{meta.num_src}, d]"
        )
    if x.device.type == "cuda":
        return _spmm_dense_cuda(x, meta, a_tiles)
    if x.device.type != "cpu":
        raise ValueError(f"spmm_tc_dense: no kernel for device {x.device}")
    spmm_tc_dense.plain_calls += 1
    return spmm_tc_dense_torch(x, meta, a_tiles)

