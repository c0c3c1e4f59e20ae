"""The CUDA kernels (K1 to K4) against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them; ``tests/conftest.py`` does import JAX, so run it there with

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

Tolerances: f32 ``atol 1e-4 + rtol 1e-5 x magnitude``, where the
magnitude is the same sum over absolute values (``|A| @ |x|`` for K1, the
CSR oracle on ``|x|`` for K2-K4), since the kernel and the plain version
differ only in summation order and an f32 sum's rounding error scales with
the magnitudes summed; bf16 ``2e-2`` on the same scale, for the one
rounding of the stored sums (K1) or of a score whose last f32 bit the
summation order moved (K2, K3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.models import agnn_conv
from tcgnn_tpu_torch.ops import (
    build_a_tiles,
    sddmm_tc_dense,
    sddmm_tc_dense_torch,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
)
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.ops.spmm import spmm_tc_dense, spmm_tc_dense_torch

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


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [5, 32, 70])
def test_kernel_matches_plain(cuda, kind, geometry, dtype, d):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(d)).to(cuda)
    before = spmm_tc_dense.launches
    got = spmm_tc_dense(x, g.meta, g.a_struct)
    torch.cuda.synchronize()
    assert spmm_tc_dense.launches == before + 1 and got.dtype == dtype
    mag = spmm_ref(x.double().abs(), torch.from_numpy(rp).to(cuda), torch.from_numpy(ci).to(cuda))
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    within(got, spmm_tc_dense_torch(x, g.meta, g.a_struct), mag, **tol)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_autograd_on_card_matches_cpu(cuda, geometry):
    n, rp, ci = graph("directed")
    bh, bw = geometry
    cfg = TileConfig(blk_h=bh, blk_w=bw)
    x = torch.randn(n, 24, generator=torch.Generator().manual_seed(0))
    dy = torch.randn(n, 24, generator=torch.Generator().manual_seed(1))
    results = []
    for dev in (torch.device("cpu"), cuda):
        g = TiledGraph(rp, ci, n, cfg, device=dev)
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
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device=cuda)
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


@pytest.mark.parametrize("kind", ["hub", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 32, 70])
@pytest.mark.parametrize("share", [True, False])
def test_sfused_kernel_matches_plain(cuda, kind, geometry, dtype, d, share):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda)
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
@pytest.mark.parametrize("d", [3, 32, 70])
def test_sfused_bwd_kernel_matches_plain(cuda, kind, geometry, dtype, d):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda)
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
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), device=cuda)
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
                   device=cuda)
    tiles = build_a_tiles(g.meta, torch.full((100,), 1.005859375, device=cuda))
    x = torch.ones(n, 1, device=cuda)
    got = spmm_tc_dense(x, g.meta, tiles)
    assert float(got[0, 0]) == 101.0
    assert float(spmm_tc_dense_torch(x, g.meta, tiles)[0, 0]) == 101.0


def test_sfused_rejects_wide_features(cuda):
    n, rp, ci = graph("directed")
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device=cuda)
    x = torch.zeros(n, 130, device=cuda)
    with pytest.raises(ValueError, match="d <= 128"):
        spmm_sfused(x, x, x, g.meta, g.a_struct)
    with pytest.raises(ValueError, match="d <= 128"):
        spmm_sfused_bwd(x, x, g.meta, g.a_struct)


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
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev)
        assert (g.agnn_aggregate is not None) == (kind == "symmetric")
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in (x, w, att)]
        out = agnn_conv(leaves[1], leaves[2], leaves[0], g)
        (out * r.to(dev)).sum().backward()
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0))
