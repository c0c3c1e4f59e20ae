"""``TiledGraph.spmm`` of the port, forward and autograd backward, against
``jax.vjp`` of the JAX ``TiledGraph.spmm`` on the condensed dense-tile route.

f32 at ``rtol=atol=1e-5`` (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcgnn_tpu_torch.graph as port_graph
from tcgnn_tpu import graph as jax_graph
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph

F32 = dict(rtol=1e-5, atol=1e-5)


def make_csr(directed, n=240, seed=5):
    src, dst = powerlaw_graph(n, 1400, seed=seed)
    if directed:
        keep = (src < dst) | (src % 5 == 0)
        src, dst = src[keep], dst[keep]
    return coo_to_csr(src, dst, n)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("geometry", [(16, 8), (16, 16), (512, 128)])
def test_spmm_and_grad_match_jax_vjp(directed, geometry):
    n = 240
    rp, ci = make_csr(directed, n)
    bh, bw = geometry
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device="cpu", block_diag=False)
    jg = JaxTiledGraph(rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw),
                       dense_tiles=True, block_diag=False)
    assert g.symmetric == jg.symmetric == (not directed)
    assert (g.tc_blocks, g.exp_edges) == (jg.tc_blocks, jg.exp_edges)

    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, 20), dtype=np.float32)
    dy = rng.standard_normal((n, 20), dtype=np.float32)
    want_out, vjp = jax.vjp(jg.spmm, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = g.spmm(xt)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **F32)


def test_symmetric_graph_shares_its_tiling():
    rp, ci = make_csr(directed=False)
    g = TiledGraph(rp, ci, 240, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    assert g.symmetric and g.meta_t is g.meta and g.a_struct_t is g.a_struct
    assert g.a_struct.dtype == torch.int8 and not g.block_diag and g.dense_tiles
    d = TiledGraph(*make_csr(directed=True), 240, TileConfig(blk_h=16, blk_w=8), device="cpu",
                   block_diag=False)
    assert not d.symmetric and d.meta_t is not d.meta


def test_duplicate_counts_over_127_use_compute_dtype_tiles():
    n = 120
    src, dst = powerlaw_graph(n, 600, seed=2)
    rp, ci = coo_to_csr(np.concatenate([src, np.full(150, 1)]),
                        np.concatenate([dst, np.full(150, 2)]), n)
    for dtype in (torch.float32, torch.bfloat16):
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8, compute_dtype=dtype),
                       device="cpu", block_diag=False)
        assert g.a_struct.dtype == dtype
    jg = JaxTiledGraph(rp, ci, n, JaxTileConfig(blk_h=16, blk_w=8), dense_tiles=True,
                       block_diag=False)
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    x = np.random.default_rng(0).standard_normal((n, 9), dtype=np.float32)
    np.testing.assert_allclose(g.spmm(torch.from_numpy(x)).numpy(),
                               np.asarray(jg.spmm(jnp.asarray(x))), **F32)


def test_bf16_config_stores_bf16_and_casts_grad_to_primal():
    rp, ci = make_csr(directed=True)
    g = TiledGraph(rp, ci, 240, TileConfig(blk_h=16, blk_w=8, compute_dtype=torch.bfloat16),
                   device="cpu", block_diag=False)
    x = torch.randn(240, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
    out = g.spmm(x)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.float32


def test_block_group_auto_resolves_to_one():
    rp, ci = make_csr(directed=False)
    g = TiledGraph(rp, ci, 240, TileConfig(blk_h=16, blk_w=8, block_group=0), device="cpu",
                   block_diag=False)
    assert g.config.block_group == 1


def test_over_budget_graph_takes_the_chunk_route(monkeypatch):
    """Over the dense-tile budget both packages take the chunk route (no
    dense tiles, no BD route) and give the same SpMM."""
    monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", 1024)
    monkeypatch.setattr(jax_graph, "DENSE_TILE_BUDGET_BYTES", 1024)
    rp, ci = make_csr(directed=False)
    g = TiledGraph(rp, ci, 240, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    jg = JaxTiledGraph(rp, ci, 240, JaxTileConfig(blk_h=16, blk_w=8), block_diag=False)
    assert not g.dense_tiles and not jg.dense_tiles
    assert not g.block_diag and not jg.block_diag and g.a_struct is None
    x = np.random.default_rng(3).standard_normal((240, 6)).astype(np.float32)
    np.testing.assert_allclose(g.spmm(torch.from_numpy(x)).numpy(),
                               np.asarray(jg.spmm(jnp.asarray(x))), **F32)
