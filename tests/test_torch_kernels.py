"""K1's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them; ``tests/conftest.py`` does import JAX, so run it there with

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

Tolerances: f32 ``atol 1e-4 + rtol 1e-5 x (|A| @ |x|)``, since the kernel
and the plain version differ only in summation order and an f32 sum's
rounding error scales with the magnitudes summed; bf16 ``2e-2`` on the same
scale, for the one rounding of the stored sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops.reference import spmm_ref
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
