"""The CUDA kernels (K1 to K10) against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them; ``tests/conftest.py`` does import JAX, so run it there with

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

Tolerances: f32 ``atol 1e-4 + rtol 1e-5 x magnitude``, where the
magnitude is the same sum over absolute values (``|A| @ |x|`` for K1, the
CSR oracle on ``|x|`` for K2-K4), since the kernel and the plain version
differ only in summation order and an f32 sum's rounding error scales with
the magnitudes summed; bf16 ``2e-2`` on the same scale, for the one
rounding of the stored sums (K1, K5-K7) or of a score whose last f32 bit
the summation order moved (K2, K3, K6, K7).  For K5-K7 the magnitude is the
plain version's own output on absolute values (pack and features).  K8 and
K9 store f32 under bf16 too, so they take the f32 tolerance in both dtypes.
K10 and K3 on a distributed shard's stream (padding blocks, a gather source
longer than the windows, window-side operands apart) take K2/K3's
tolerances with the plain version on absolute values as the magnitude; K4's
tile mode stores each score rounded once, so f32 tiles take the f32
tolerance and bf16 tiles one bf16 unit (``rtol=8e-3``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.models import agnn_conv, gcn_conv
from tcgnn_tpu_torch.ops import (
    bd_sfused,
    bd_sfused_bwd,
    bd_sfused_bwd_torch,
    bd_sfused_torch,
    build_a_tiles,
    spmm_block_diag,
    spmm_block_diag_torch,
    sddmm_tc_dense,
    sddmm_tc_dense_torch,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
)
from tcgnn_tpu_torch.ops.blockdiag import bd_row_index
from tcgnn_tpu_torch.ops.chunk import (
    sddmm_tc,
    sddmm_tc_torch,
    spmm_tc,
    spmm_tc_torch,
)
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.ops.spmm import spmm_tc_dense, spmm_tc_dense_torch
from tcgnn_tpu_torch.sgt.stream import segment_chunks
from tcgnn_tpu_torch.ops.fused import spmm_fused, spmm_fused_torch
from tcgnn_tpu_torch.ops.sddmm import sddmm_tc_tiles, sddmm_tc_tiles_torch
from tcgnn_tpu_torch.parallel import DistributedTiledGraph, make_mesh
from tcgnn_tpu_torch.sgt.translate import shard_meta, sparse_graph_translate

pytestmark = pytest.mark.gpu
GEOMETRIES = [(16, 8), (16, 16), (512, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def graph(kind):
    if kind == "hub":  # one node linked to 600 others: windows split into runs
        n = 2000
        src, dst = powerlaw_graph(n, 9000, seed=1)
        hub = np.arange(1, 601)
        src, dst = np.concatenate([src, np.zeros(600, int), hub]), np.concatenate(
            [dst, hub, np.zeros(600, int)])
    elif kind == "empty_and_partial_windows":
        n = 260
        src, dst = powerlaw_graph(200, 1000, seed=9)
    elif kind == "duplicates_over_127":
        n = 200
        src, dst = powerlaw_graph(n, 900, seed=10)
        src, dst = np.concatenate([src, np.full(140, 4)]), np.concatenate([dst, np.full(140, 9)])
    else:  # directed
        n = 700
        src, dst = powerlaw_graph(n, 5000, seed=3)
        keep = (src < dst) | (src % 4 == 0)
        src, dst = src[keep], dst[keep]
    return (n, *coo_to_csr(src, dst, n))


def within(got, want, mag, rtol, atol):
    err = (got.double() - want.double()).abs()
    assert torch.isfinite(got.double()).all()
    assert bool(torch.all(err <= atol + rtol * mag)), float(err.max())


# The widths K1 and K10 branch on: unaligned rows (d % 4), one lane group
# of 4 columns to a whole warp (d <= 128), and several 128-column tiles.
DENSE_WIDTHS = [1, 5, 16, 17, 32, 70, 500]
# Tiles as the graph builds them (int8, or f32 past a count of 127), or
# cast to f32 or bf16 (the vector path's three unit widths).
TILE_CASTS = {"built": None, "f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DENSE_WIDTHS)
@pytest.mark.parametrize("tiles", list(TILE_CASTS))
def test_kernel_matches_plain(cuda, kind, geometry, dtype, d, tiles):
    """K1 (bf16 output of the hub's split windows included: their f32 sums
    converted once)."""
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda,
                   block_diag=False)
    a = g.a_struct if TILE_CASTS[tiles] is None else g.a_struct.to(TILE_CASTS[tiles])
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(d)).to(cuda)
    before = spmm_tc_dense.launches
    got = spmm_tc_dense(x, g.meta, a)
    torch.cuda.synchronize()
    assert spmm_tc_dense.launches == before + 1 and got.dtype == dtype
    mag = spmm_ref(x.double().abs(), torch.from_numpy(rp).to(cuda), torch.from_numpy(ci).to(cuda))
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    within(got, spmm_tc_dense_torch(x, g.meta, a), mag, **tol)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_autograd_on_card_matches_cpu(cuda, geometry):
    n, rp, ci = graph("directed")
    bh, bw = geometry
    cfg = TileConfig(blk_h=bh, blk_w=bw)
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(0))
    dy = torch.randn(n, 24, generator=torch.Generator().manual_seed(1))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = TiledGraph(rp, ci, n, cfg, device=dev, block_diag=False)
        assert not g.symmetric
        xd = x.to(dev).detach().requires_grad_(True)
        out = g.spmm(xd)
        out.backward(dy.to(dev))
        results.append((out.detach().cpu(), xd.grad.cpu()))
    (out_c, dx_c), (out_g, dx_g) = results
    torch.testing.assert_close(out_g, out_c, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-5, atol=1e-4)


def test_counts_and_device_checks(cuda):
    n, rp, ci = graph("directed")
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device=cuda, block_diag=False)
    cpu_meta = dataclasses.replace(g.meta, col_ids=g.meta.col_ids.cpu())
    with pytest.raises(ValueError, match="col_ids on cpu"):
        spmm_tc_dense(torch.zeros(n, 4, device=cuda), cpu_meta, g.a_struct)
    before = (spmm_tc_dense.launches, spmm_tc_dense.plain_calls)
    spmm_tc_dense(torch.zeros(n, 4, device=cuda), g.meta, g.a_struct)
    assert (spmm_tc_dense.launches, spmm_tc_dense.plain_calls) == (before[0] + 1, before[1])


F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def tol(dtype):
    return F32 if dtype == torch.float32 else BF16


def randn(shape, seed, dev, scale=1.0):
    return (torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale).to(dev)


def csr(rp, ci, dev):
    return torch.from_numpy(rp).to(dev), torch.from_numpy(ci).to(dev)


# K2/K3's widths: one lane group of up to 4 columns a lane (d <= 128), and
# past it the wide path's 128-column tiles of the output.
SFUSED_WIDTHS = [3, 32, 70, 129, 200, 500]


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SFUSED_WIDTHS)
@pytest.mark.parametrize("share", [True, False])
def test_sfused_kernel_matches_plain(cuda, kind, geometry, dtype, d, share):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda,
                   block_diag=False)
    xl, xr = randn((n, d), 1, cuda, 0.3), randn((n, d), 2, cuda, 0.3)
    xv = xr if share else randn((n, d), 3, cuda, 0.3)
    before = spmm_sfused.launches
    got = spmm_sfused(xl, xr, xv, g.meta, g.a_struct)
    torch.cuda.synchronize()
    assert spmm_sfused.launches == before + 1 and got.dtype == torch.float32
    mag = sfused_ref(xl.double().abs(), xr.double().abs(), xv.double().abs(), *csr(rp, ci, cuda))
    within(got, spmm_sfused_torch(xl, xr, xv, g.meta, g.a_struct), mag, **tol(dtype))
    if dtype == torch.float32:
        want = sfused_ref(xl.double(), xr.double(), xv.double(), *csr(rp, ci, cuda))
        within(got, want, mag, **F32)


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SFUSED_WIDTHS)
def test_sfused_bwd_kernel_matches_plain(cuda, kind, geometry, dtype, d):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda,
                   block_diag=False)
    x, dy = randn((n, d), 4, cuda, 0.3), randn((n, d), 5, cuda, 0.3)
    before = spmm_sfused_bwd.launches
    dx3, u = spmm_sfused_bwd(x, dy, g.meta, g.a_struct)
    torch.cuda.synchronize()
    assert spmm_sfused_bwd.launches == before + 1
    mag_dx3, mag_u = sfused_bwd_ref(x.double().abs(), dy.double().abs(), *csr(rp, ci, cuda))
    want_dx3, want_u = spmm_sfused_bwd_torch(x, dy, g.meta, g.a_struct)
    within(dx3, want_dx3, mag_dx3, **tol(dtype))
    within(u, want_u, mag_u, **tol(dtype))
    if dtype == torch.float32:
        o_dx3, o_u = sfused_bwd_ref(x.double(), dy.double(), *csr(rp, ci, cuda))
        within(dx3, o_dx3, mag_dx3, **F32)
        within(u, o_u, mag_u, **F32)


@pytest.mark.parametrize("kind", ["hub", "duplicates_over_127", "directed"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 5, 32, 70])
def test_sddmm_kernel_matches_plain(cuda, kind, geometry, dtype, d):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda,
                   block_diag=False)
    xa, xb = randn((n, d), 6, cuda), randn((n, d), 7, cuda)
    before = sddmm_tc_dense.launches
    got = sddmm_tc_dense(xa, g.meta, xb)
    torch.cuda.synchronize()
    assert sddmm_tc_dense.launches == before + 1 and got.shape == (len(ci),)
    mag = sddmm_ref(xa.double().abs(), *csr(rp, ci, cuda), xb.double().abs())
    # Both sides sum the same exact products of compute-dtype operands in f32.
    within(got, sddmm_tc_dense_torch(xa, g.meta, xb), mag, **F32)
    xa64, xb64 = xa.to(dtype).double(), xb.to(dtype).double()
    within(got, sddmm_ref(xa64, *csr(rp, ci, cuda), xb64), mag, **F32)


def test_weighted_tiles_round_to_bf16_in_k1(cuda):
    """Under bf16, K1 rounds f32 weighted tiles to bf16 as it reads them,
    as the JAX kernel casts its tiles: 100 edges of weight 1.005859375
    (bf16: 1.0078125) into one row sum to 100.78 and store as 101, where
    unrounded weights would store 100.5."""
    n = 101
    rp, ci = coo_to_csr(np.zeros(100, int), np.arange(1, 101), n)
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8, compute_dtype=torch.bfloat16),
                   device=cuda, block_diag=False)
    tiles = build_a_tiles(g.meta, torch.full((100,), 1.005859375, device=cuda))
    x = torch.ones(n, 1, device=cuda)
    got = spmm_tc_dense(x, g.meta, tiles)
    assert float(got[0, 0]) == 101.0
    assert float(spmm_tc_dense_torch(x, g.meta, tiles)[0, 0]) == 101.0


@pytest.mark.parametrize("d", [129, 200, 500])
def test_sfused_rejects_wide_features(cuda, d):
    """K2 and K3 once refused d > 128; they now take any d, as the JAX
    kernels do (the wide path), and agree with the plain versions there."""
    n, rp, ci = graph("directed")
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device=cuda, block_diag=False)
    x, y = randn((n, d), 6, cuda, 0.3), randn((n, d), 7, cuda, 0.3)
    got = spmm_sfused(x, y, y, g.meta, g.a_struct)
    mag = spmm_sfused_torch(x.abs(), y.abs(), y.abs(), g.meta, g.a_struct)
    within(got, spmm_sfused_torch(x, y, y, g.meta, g.a_struct), mag, **F32)
    dx3, u = spmm_sfused_bwd(x, y, g.meta, g.a_struct)
    mag_dx3, mag_u = spmm_sfused_bwd_torch(x.abs(), y.abs(), g.meta, g.a_struct)
    want_dx3, want_u = spmm_sfused_bwd_torch(x, y, g.meta, g.a_struct)
    within(dx3, want_dx3, mag_dx3, **F32)
    within(u, want_u, mag_u, **F32)


@pytest.mark.parametrize("kind", ["symmetric", "directed"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_agnn_autograd_on_card_matches_cpu(cuda, kind, geometry):
    """agnn_conv forward and every gradient: K2/K3 on a symmetric graph,
    K4 and weighted K1 on a directed one, against the plain versions on
    the CPU."""
    n = 700
    src, dst = powerlaw_graph(n, 5000, seed=3)
    if kind == "directed":
        keep = (src < dst) | (src % 4 == 0)
        src, dst = src[keep], dst[keep]
    rp, ci = coo_to_csr(src, dst, n)
    bh, bw = geometry
    x = torch.randn(n, 20, generator=torch.Generator().manual_seed(0)) * 0.3
    w = torch.randn(20, 16, generator=torch.Generator().manual_seed(1)) * 0.25
    att = torch.tensor([[0.6, -0.3]])
    r = torch.randn(n, 16, generator=torch.Generator().manual_seed(2))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev, block_diag=False)
        assert (g.agnn_aggregate is not None) == (kind == "symmetric")
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in (x, w, att)]
        out = agnn_conv(leaves[1], leaves[2], leaves[0], g)
        (out * r.to(dev)).sum().backward()
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0))


# ---- K5, K6, K7: the block-diagonal kernels ----------------------------------

BD_OFFSETS = {"diag": (0,), "tri": (-1, 0, 1), "hepta": (-3, -2, -1, 0, 1, 2, 3),
              "upper": (0, 1, 2), "octa": (-4, -3, -2, -1, 0, 1, 2, 3),
              "gaps": (-5, -1, 0, 3)}


def bd_pack(n, offsets, kind, dev, seed=0, bn=128, extreme_rows=False):
    """A random pack [Bp, bn, K*bn] of about 5 entries a row (DD's
    density): int8 counts 1-3; int16, with one entry in 500 a count of
    128-300; or float / bfloat16 normal weights.  ``extreme_rows``: row 5
    empty and the first row of the middle bin full across its stripe
    (1,024 entries for 8 offsets of 128)."""
    g = torch.Generator().manual_seed(seed)
    bp = -(-(-(-n // bn)) // 8) * 8
    shape = (bp, bn, len(offsets) * bn)
    mask = torch.rand(shape, generator=g) < 5 / shape[2]
    if kind in ("int8", "int16"):
        counts = torch.randint(1, 4, shape, generator=g)
        if kind == "int16":
            big = torch.rand(shape, generator=g) < 0.002
            counts = torch.where(big, torch.randint(128, 301, shape, generator=g), counts)
        pack = (mask * counts).to(torch.int8 if kind == "int8" else torch.int16)
    else:
        pack = (mask * torch.randn(shape, generator=g)).to(
            torch.float32 if kind == "float" else torch.bfloat16)
    if extreme_rows:
        rows = pack.view(-1, shape[2])
        rows[5] = 0
        rows[(-(-n // bn) // 2) * bn] = 1
    return pack.to(dev)


def bd_cfg(dtype):
    return TileConfig(compute_dtype=dtype)


@pytest.mark.parametrize("offsets", list(BD_OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16", "float", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# n is never a multiple of bn; bn=20 makes the int8, int16 and bf16 pack
# rows not 16-byte aligned (K5's path that reads an entry a lane).
@pytest.mark.parametrize("n,d,bn", [(1000, 3, 128), (1100, 16, 128), (1100, 17, 128),
                                    (1100, 89, 128), (1000, 200, 128), (1000, 16, 20)])
def test_bd_spmm_kernel_matches_plain(cuda, offsets, kind, dtype, n, d, bn):
    offs = BD_OFFSETS[offsets]
    pack = bd_pack(n, offs, kind, cuda, bn=bn)
    x = randn((n, d), 20, cuda)
    cfg = bd_cfg(dtype)
    before = spmm_block_diag.launches
    got = spmm_block_diag(x, pack, offsets=offs, cfg=cfg)
    torch.cuda.synchronize()
    assert spmm_block_diag.launches == before + 1 and got.dtype == dtype and got.shape == (n, d)
    mag = spmm_block_diag_torch(x.abs(), pack.float().abs(), offsets=offs,
                                cfg=bd_cfg(torch.float32))
    within(got, spmm_block_diag_torch(x, pack, offsets=offs, cfg=cfg), mag, **tol(dtype))


BD_SHARING = {"all_one": "xxx", "l_is_r": "xxv", "l_is_v": "xrx", "v_is_r": "lxx",
              "separate": "lrv"}


# K6/K7's widths: lane groups of 1 to 32 lanes (d <= 128; d % 4 != 0 reads
# a column at a time), and past 128 the wide path's output tiles.
BD_SFUSED_WIDTHS = [1, 2, 3, 4, 31, 32, 33, 64, 128, 129, 200]


@pytest.mark.parametrize("offsets", list(BD_OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", BD_SFUSED_WIDTHS)
@pytest.mark.parametrize("sharing", list(BD_SHARING))
def test_bd_sfused_kernel_matches_plain(cuda, offsets, kind, dtype, d, sharing):
    n, offs = 1100, BD_OFFSETS[offsets]
    pack = bd_pack(n, offs, kind, cuda, seed=1, extreme_rows=True)
    index = bd_row_index(pack, offs, n)
    ops = {k: randn((n, d), 21 + i, cuda, 0.3) for i, k in enumerate("xlrv")}
    args = [ops[k] for k in BD_SHARING[sharing]]
    cfg = bd_cfg(dtype)
    before = bd_sfused.launches
    got = bd_sfused(*args, pack, offsets=offs, cfg=cfg, index=index)
    torch.cuda.synchronize()
    assert bd_sfused.launches == before + 1 and got.dtype == dtype and got.shape == (n, d)
    mag = bd_sfused_torch(*(a.abs() for a in args), pack.float().abs(), offsets=offs,
                          cfg=bd_cfg(torch.float32))
    within(got, bd_sfused_torch(*args, pack, offsets=offs, cfg=cfg), mag, **tol(dtype))


@pytest.mark.parametrize("offsets", list(BD_OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1000 + 100 * (i % 2), d) for i, d in enumerate(BD_SFUSED_WIDTHS)])
def test_bd_sfused_bwd_kernel_matches_plain(cuda, offsets, kind, dtype, n, d):
    offs = BD_OFFSETS[offsets]
    pack = bd_pack(n, offs, kind, cuda, seed=2, extreme_rows=True)
    index = bd_row_index(pack, offs, n)
    x, dy = randn((n, d), 30, cuda, 0.3), randn((n, d), 31, cuda, 0.3)
    cfg = bd_cfg(dtype)
    before = bd_sfused_bwd.launches
    dx3, u = bd_sfused_bwd(x, dy, pack, offsets=offs, cfg=cfg, index=index)
    torch.cuda.synchronize()
    assert bd_sfused_bwd.launches == before + 1 and dx3.dtype == u.dtype == dtype
    mag_dx3, mag_u = bd_sfused_bwd_torch(x.abs(), dy.abs(), pack.float().abs(), offsets=offs,
                                         cfg=bd_cfg(torch.float32))
    want_dx3, want_u = bd_sfused_bwd_torch(x, dy, pack, offsets=offs, cfg=cfg)
    within(dx3, want_dx3, mag_dx3, **tol(dtype))
    within(u, want_u, mag_u, **tol(dtype))


@pytest.mark.parametrize("wide_d", [129, 200, 500])
def test_bd_kernels_reject_what_they_do_not_take(cuda, wide_d):
    """K6 and K7 once refused d > 128; they now take any d and agree with
    the plain versions there.  They still refuse a call without the pack's
    row index; K5 refuses more than 8 offsets and a pack off the card."""
    offs = BD_OFFSETS["tri"]
    pack = bd_pack(300, offs, "int8", cuda)
    index = bd_row_index(pack, offs, 300)
    x, y = randn((300, wide_d), 32, cuda, 0.3), randn((300, wide_d), 33, cuda, 0.3)
    cfg = bd_cfg(torch.float32)
    got = bd_sfused(x, y, y, pack, offsets=offs, cfg=cfg, index=index)
    mag = bd_sfused_torch(x.abs(), y.abs(), y.abs(), pack.float(), offsets=offs, cfg=cfg)
    within(got, bd_sfused_torch(x, y, y, pack, offsets=offs, cfg=cfg), mag, **F32)
    dx3, u = bd_sfused_bwd(x, y, pack, offsets=offs, cfg=cfg, index=index)
    mag_dx3, mag_u = bd_sfused_bwd_torch(x.abs(), y.abs(), pack.float(), offsets=offs, cfg=cfg)
    want_dx3, want_u = bd_sfused_bwd_torch(x, y, pack, offsets=offs, cfg=cfg)
    within(dx3, want_dx3, mag_dx3, **F32)
    within(u, want_u, mag_u, **F32)
    with pytest.raises(ValueError, match="row index"):
        bd_sfused(x, x, x, pack, offsets=offs, cfg=cfg)
    with pytest.raises(ValueError, match="row index"):
        bd_sfused_bwd(x, x, pack, offsets=offs, cfg=cfg)
    nine = tuple(range(-4, 5))
    with pytest.raises(ValueError, match="offsets"):
        spmm_block_diag(x, bd_pack(300, nine, "int8", cuda), offsets=nine, cfg=cfg)
    with pytest.raises(ValueError, match="on cpu"):
        spmm_block_diag(x, pack.cpu(), offsets=offs, cfg=cfg)


def bd_graph(kind):
    """A symmetric union graph with 3% random long-range edges (a residual),
    or a directed band with random edges."""
    rng = np.random.default_rng(7)
    if kind == "directed_band":
        n = 3000
        src = rng.integers(0, n, 9000)
        dst = np.clip(src + rng.integers(-100, 101, 9000), 0, n - 1)
        src, dst = np.concatenate([src, rng.integers(0, n, 300)]), np.concatenate(
            [dst, rng.integers(0, n, 300)])
    else:
        n = 3000
        src, dst = component_union_graph(n, 7000, 100, seed=2)
        e, far = rng.integers(0, n, (2, 100))
        src, dst = np.concatenate([src, e, far]), np.concatenate([dst, far, e])
    return (n, *coo_to_csr(src, dst, n))


@pytest.mark.parametrize("kind", ["union_with_residual", "directed_band"])
@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_bd_autograd_on_card_matches_cpu(cuda, kind, model):
    """A GCN or AGNN layer on the BD route, forward and every gradient: K5
    with K1 (and K6/K7 with K2/K3, or K4 and weighted K5), against the plain
    versions on the CPU."""
    n, rp, ci = bd_graph(kind)
    x = torch.randn(n, 20, generator=torch.Generator().manual_seed(0)) * 0.3
    w = torch.randn(20, 16, generator=torch.Generator().manual_seed(1)) * 0.25
    att = torch.tensor([[0.6, -0.3]])
    r = torch.randn(n, 16, generator=torch.Generator().manual_seed(2))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = TiledGraph(rp, ci, n, TileConfig(128, 128), device=dev, weighted_traffic=True)
        assert g.block_diag and not g.bd_full_coverage
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in (x, w, att)]
        if model == "agnn":
            out = agnn_conv(leaves[1], leaves[2], leaves[0], g)
        else:
            out = gcn_conv(leaves[1], leaves[0], g)
            leaves = leaves[:2]
        (out * r.to(dev)).sum().backward()
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0))


# ---- K8 and K9: the chunk and streamed routes ---------------------------------

CHUNK_GEOMETRIES = [(16, 8, 32), (32, 32, 32), (512, 128, 128)]
CHUNK_KINDS = ["hub", "empty_and_partial_windows", "duplicates_over_127", "directed",
               "empty_rows"]


def chunk_graph(kind):
    """``graph(kind)``, and two graphs for the kernels' edge ranges
    (``edges_per_warp`` in ``csrc/chunk.cu``: a few dozen edges a warp on
    small graphs, 512 from 4.3 M edges): two edges in every eighth row, so a
    warp's range spans more than 32 rows (row ends are read 32 at a time);
    and 4.5 M edges with node 0's 6,000 in a row that spans 12 ranges of 512
    (cut rows are added with atomics)."""
    rng = np.random.default_rng(17)
    if kind == "empty_rows":
        n = 3000
        src = np.repeat(np.arange(0, n, 8), 2)
        dst = rng.integers(0, n, len(src))
    elif kind == "long_hub":
        n = 100_000
        src, dst = rng.integers(0, n, (2, 4_500_000))
        src = np.concatenate([src, np.zeros(6000, np.int64)])
        dst = np.concatenate([dst, rng.integers(1, n, 6000)])
    else:
        return graph(kind)
    return (n, *coo_to_csr(src, dst, n))


@functools.lru_cache(maxsize=4)
def _chunk_layouts(kind, geometry, dev):
    n, rp, ci = chunk_graph(kind)
    bh, bw, ec = geometry
    host = sparse_graph_translate(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec),
                                  emit_chunks=True)
    segs = segment_chunks(host, max_chunks=max(host.num_chunks // 3, 1),
                          max_slab_rows=max(host.num_blocks * bw // 3, bw))
    return n, rp, ci, {"flat": host.to_chunks(dev), "segments": segs.to(dev)}


def chunk_layouts(kind, geometry, dtype, dev):
    """A graph's chunk layout, flat and cut into several window segments by
    small budgets (one wrapper each takes both), in compute dtype ``dtype``."""
    n, rp, ci, layouts = _chunk_layouts(kind, geometry, dev)
    return n, rp, ci, {name: dataclasses.replace(m, config=dataclasses.replace(
        m.config, compute_dtype=dtype)) for name, m in layouts.items()}


def check_chunk_spmm(kind, geometry, dtype, d, weighted, dev):
    """K8 on the flat layout and on window segments: f32 output under bf16
    too, so the f32 tolerance holds for both."""
    n, rp, ci, layouts = chunk_layouts(kind, geometry, dtype, dev)
    x = randn((n, d), d, dev)
    w = randn((len(ci),), 1, dev) if weighted else None
    wa = None if w is None else w.to(dtype).double().abs()
    mag = spmm_ref(x.to(dtype).double().abs(), *csr(rp, ci, dev), wa)
    for meta in layouts.values():
        before = spmm_tc.launches
        got = spmm_tc(x, meta, w)
        torch.cuda.synchronize()
        assert spmm_tc.launches == before + 1 and got.dtype == torch.float32
        within(got, spmm_tc_torch(x, meta, w), mag, **F32)


def check_chunk_sddmm(kind, geometry, dtype, d, two, dev):
    n, rp, ci, layouts = chunk_layouts(kind, geometry, dtype, dev)
    xa, xb = randn((n, d), d, dev), randn((n, d), d + 1, dev) if two else None
    a = xa.to(dtype).double()
    b = a if xb is None else xb.to(dtype).double()
    mag = sddmm_ref(a.abs(), *csr(rp, ci, dev), b.abs())
    for meta in layouts.values():
        before = sddmm_tc.launches
        got = sddmm_tc(xa, meta, xb)
        torch.cuda.synchronize()
        assert sddmm_tc.launches == before + 1 and got.shape == (len(ci),)
        within(got, sddmm_tc_torch(xa, meta, xb), mag, **F32)


# The widths the kernels branch on: lane groups of 4 to 32 lanes (d <= 128,
# aligned or not), K8's 128-column d-tiles and K9's passes of 512 columns
# (reddit's 602).
@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("geometry", CHUNK_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 16, 41, 70, 130, 200, 602])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_chunk_spmm_kernel_matches_plain(cuda, kind, geometry, dtype, d, weighted):
    check_chunk_spmm(kind, geometry, dtype, d, weighted, cuda)


@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("geometry", CHUNK_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 5, 16, 32, 41, 70, 130, 602])
@pytest.mark.parametrize("two", [False, True], ids=["one_matrix", "two_matrices"])
def test_chunk_sddmm_kernel_matches_plain(cuda, kind, geometry, dtype, d, two):
    check_chunk_sddmm(kind, geometry, dtype, d, two, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 16, 41, 130])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_chunk_spmm_kernel_on_a_long_hub(cuda, dtype, d, weighted):
    check_chunk_spmm("long_hub", (512, 128, 128), dtype, d, weighted, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 16, 41, 130])
@pytest.mark.parametrize("two", [False, True], ids=["one_matrix", "two_matrices"])
def test_chunk_sddmm_kernel_on_a_long_hub(cuda, dtype, d, two):
    check_chunk_sddmm("long_hub", (512, 128, 128), dtype, d, two, cuda)


@pytest.mark.parametrize("streamed", [False, True], ids=["chunk", "streamed"])
@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_chunk_autograd_on_card_matches_cpu(cuda, streamed, model):
    """A GCN or AGNN layer on the chunk or streamed route, forward and every
    gradient: K8 and K9 against the plain versions on the CPU."""
    n, rp, ci = graph("directed")
    x = torch.randn(n, 20, generator=torch.Generator().manual_seed(0)) * 0.3
    w = torch.randn(20, 16, generator=torch.Generator().manual_seed(1)) * 0.25
    att = torch.tensor([[0.6, -0.3]])
    r = torch.randn(n, 16, generator=torch.Generator().manual_seed(2))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = TiledGraph(rp, ci, n, TileConfig(16, 8, edge_chunk=32), device=dev,
                       weighted_traffic=True, dense_tiles=False, streamed=streamed)
        assert not g.dense_tiles and g.streamed == streamed
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in (x, w, att)]
        if model == "agnn":
            out = agnn_conv(leaves[1], leaves[2], leaves[0], g)
        else:
            out = gcn_conv(leaves[1], leaves[0], g)
            leaves = leaves[:2]
        (out * r.to(dev)).sum().backward()
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0))


def test_chunk_kernels_reject_what_they_do_not_take(cuda):
    n, rp, ci, layouts = chunk_layouts("directed", (16, 8, 32), torch.float32, cuda)
    meta = layouts["flat"]
    x = torch.zeros(n, 4, device=cuda)
    with pytest.raises(ValueError, match="seg_r on cpu"):
        spmm_tc(x, dataclasses.replace(meta, seg_r=meta.seg_r.cpu()))
    with pytest.raises(ValueError, match="weights of shape"):
        spmm_tc(x, meta, torch.zeros(3, device=cuda))
    with pytest.raises(TypeError, match="no kernel for compute dtype"):
        sddmm_tc(x, dataclasses.replace(meta, config=dataclasses.replace(
            meta.config, compute_dtype=torch.float16)))
    with pytest.raises(ValueError, match="row_ptr must be contiguous int64"):
        spmm_tc(x, dataclasses.replace(meta, row_ptr=meta.row_ptr.cpu()))
    with pytest.raises(ValueError, match="row_ptr must be contiguous int64"):
        sddmm_tc(x, dataclasses.replace(meta, row_ptr=meta.row_ptr.int()))
    with pytest.raises(TypeError, match="row_src must be int32"):
        spmm_tc(x, dataclasses.replace(meta, row_src=meta.row_src.long()))


# ---- the distributed dense-tile route: K10, K3's overrides, K4's tile mode ----

def shard_stream(kind, geometry, dtype, dev, pad_blocks=3, extra_src=5):
    """A graph's tiling as a distributed shard sees it: trailing padding
    blocks (zero tiles on the last window) and a gather source of
    ``extra_src`` rows past the windows'."""
    n, rp, ci = graph(kind)
    bh, bw = geometry
    cfg = TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype)
    host = sparse_graph_translate(rp, ci, n, cfg, build_tiles=True)
    w = host.num_windows
    tiles = np.concatenate([host.a_tiles, np.zeros((pad_blocks, bh, bw), host.a_tiles.dtype)])
    meta = shard_meta(
        cfg, tiles, np.concatenate([host.block_window, np.full(pad_blocks, w - 1, np.int32)]),
        np.concatenate([host.block_first_in_window, np.zeros(pad_blocks, np.int32)]),
        np.concatenate([host.col_ids, np.zeros(pad_blocks * bw, np.int32)]), host.edge_pos, w,
        w * bh + extra_src, dev)
    a = torch.from_numpy(tiles).to(dev)
    return meta, a if a.dtype == torch.int8 else a.to(dtype)


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DENSE_WIDTHS)
@pytest.mark.parametrize("tiles", list(TILE_CASTS))
def test_fused_kernel_matches_plain(cuda, kind, geometry, dtype, d, tiles):
    meta, a = shard_stream(kind, geometry, dtype, cuda)
    a = a if TILE_CASTS[tiles] is None else a.to(TILE_CASTS[tiles])
    x = randn((meta.num_src, d), 8, cuda)
    s = randn(tuple(a.shape), 9, cuda).to(dtype)  # scores off the edges are masked by A
    before = spmm_fused.launches
    got = spmm_fused(x, meta, a, s)
    torch.cuda.synchronize()
    assert spmm_fused.launches == before + 1 and got.dtype == torch.float32
    assert got.shape == (meta.num_rows, d)
    mag = spmm_fused_torch(x.abs(), meta, a, s.abs())
    within(got, spmm_fused_torch(x, meta, a, s), mag, **tol(dtype))


@pytest.mark.parametrize("kind", ["hub", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 32, 70])
def test_sfused_bwd_window_overrides_match_plain(cuda, kind, geometry, dtype, d):
    meta, a = shard_stream(kind, geometry, dtype, cuda)
    x, dy = randn((meta.num_src, d), 10, cuda, 0.3), randn((meta.num_src, d), 11, cuda, 0.3)
    xw, dyw = randn((meta.num_rows, d), 12, cuda, 0.3), randn((meta.num_rows, d), 13, cuda, 0.3)
    before = spmm_sfused_bwd.launches
    dx3, u = spmm_sfused_bwd(x, dy, meta, a, xw=xw, dyw=dyw)
    torch.cuda.synchronize()
    assert spmm_sfused_bwd.launches == before + 1
    want = spmm_sfused_bwd_torch(x, dy, meta, a, xw, dyw)
    mags = spmm_sfused_bwd_torch(x.abs(), dy.abs(), meta, a.abs(), xw.abs(), dyw.abs())
    for got, w, mag in zip((dx3, u), want, mags):
        within(got, w, mag, **tol(dtype))


@pytest.mark.parametrize("kind", ["hub", "duplicates_over_127", "directed"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f32_tiles", [(5, False), (32, False), (136, True)])
def test_sddmm_tile_mode_matches_plain(cuda, kind, geometry, dtype, d, f32_tiles):
    meta, _ = shard_stream(kind, geometry, dtype, cuda)
    xa, xb = randn((meta.num_rows, d), 14, cuda), randn((meta.num_src, d), 15, cuda)
    out_dtype = torch.float32 if f32_tiles else dtype
    before = sddmm_tc_tiles.launches
    got = sddmm_tc_tiles(xa, meta, xb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert sddmm_tc_tiles.launches == before + 1 and got.dtype == out_dtype
    want = sddmm_tc_tiles_torch(xa, meta, xb, out_dtype)
    mag = sddmm_tc_tiles_torch(xa.abs(), meta, xb.abs(), torch.float32)
    t = F32 if out_dtype == torch.float32 else dict(rtol=8e-3, atol=1e-4)
    within(got.float(), want.float(), mag, **t)


@pytest.mark.parametrize("mesh", [(4, 2), (8, 1)])
def test_distributed_route_on_card_matches_cpu(cuda, mesh):
    """spmm and agnn_aggregate on a mesh, forward and every gradient: the
    card's kernels (K1, and K4 tiles + K10 at 4x2, K2/K3 at 8x1) against the
    plain versions on the CPU, on a graph whose split stream engages."""
    n, rp, ci = graph("hub")
    src = np.repeat(np.arange(n), np.diff(rp))
    rp, ci = coo_to_csr(np.concatenate([src, ci]), np.concatenate([ci, src]), n)
    keep = np.ones(len(ci), bool)
    rows = np.repeat(np.arange(n), np.diff(rp))
    keep[1:] = (rows[1:] != rows[:-1]) | (ci[1:] != ci[:-1])
    rp, ci = coo_to_csr(rows[keep], ci[keep], n)
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(0)) * 0.3
    att = torch.tensor([[0.6, -0.3]])
    r = torch.randn(n, 24, generator=torch.Generator().manual_seed(2))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = DistributedTiledGraph(rp, ci, n, make_mesh(*mesh, dev), TileConfig(16, 8))
        assert g.host_fwd.split is not None and g.agnn_aggregate is not None
        xs = g.shard_features(x)[:, :24].contiguous().requires_grad_(True)
        a = att.to(dev, copy=True).requires_grad_(True)
        out = g.spmm(xs)[:n] + g.agnn_aggregate(xs, a)[:n]
        (out * r.to(dev)).sum().backward()
        results.append([out.detach().cpu(), xs.grad[:n].cpu(), a.grad.cpu()])
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0))
