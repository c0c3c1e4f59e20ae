"""K10's plain version, K3's with window-side overrides and K4's tile mode
against the JAX launchers in interpret mode.

* ``spmm_fused_torch`` (K10) against ``_spmm_fused_padded``: f32 and bf16,
  int8 tiles with duplicate counts, a window of several TC blocks, an empty
  window's padding block, and trailing padding blocks as the stacked shard
  metadata has them (zero tiles revisiting the last window, not starting
  it), from a gather source longer than the windows (a halo slab);
* ``spmm_sfused_bwd_torch`` (K3) with ``xw``/``dyw`` against
  ``_spmm_sfused_bwd_padded(..., xw=, dyw=)``;
* ``sddmm_tc_tiles_torch`` (K4's tile mode) against
  ``_sddmm_dense_padded(..., out_dtype=...)`` at every edge position (zero
  elsewhere).

Tolerances: f32 ``rtol=atol=1e-5`` (summation order only); bf16 products
and operands are rounded alike, so bf16 takes ``rtol=atol=1e-4`` on f32
outputs and one bf16 unit (``rtol=8e-3``) on bf16 tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops.sddmm import _sddmm_dense_padded
from tcgnn_tpu.ops.spmm import _spmm_fused_padded, _spmm_sfused_bwd_padded
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import (
    spmm_fused,
    spmm_fused_torch,
    sddmm_tc_tiles,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
)
from tcgnn_tpu_torch.sgt.translate import shard_meta, sparse_graph_translate

BH, BW = 16, 8
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-4, atol=1e-4)}
PAD_BLOCKS = 3
EXTRA_SRC = 7  # gather-source rows past the windows' rows


@pytest.fixture(scope="module")
def stream():
    """A 120-node graph at 16x8: a hub row (one window of many blocks),
    duplicate edges (counts up to 3), an empty window (rows 48-63), then
    trailing padding blocks."""
    n = 120
    src, dst = powerlaw_graph(n, 700, seed=5)
    keep = (src // BH != 3) & (dst // BH != 3)  # window 3 has no edge
    src, dst = src[keep], dst[keep]
    hub = np.arange(0, n, 2)
    dup = np.array([10, 10, 10, 70, 70])
    src = np.concatenate([src, np.full(len(hub), 5), dup])
    dst = np.concatenate([dst, hub, np.array([11, 11, 11, 71, 71])])
    keep = (src // BH != 3)
    ptr, idx = coo_to_csr(src[keep], dst[keep], n)
    host = sparse_graph_translate(ptr, idx, n, TileConfig(blk_h=BH, blk_w=BW), build_tiles=True)
    assert host.a_tiles.max() >= 3 and host.block_partition.max() > 4
    assert host.block_partition[3] == 1  # the empty window's padding block
    w = host.num_windows
    tiles = np.concatenate([host.a_tiles, np.zeros((PAD_BLOCKS, BH, BW), np.int8)])
    block_window = np.concatenate([host.block_window, np.full(PAD_BLOCKS, w - 1, np.int32)])
    block_first = np.concatenate([host.block_first_in_window, np.zeros(PAD_BLOCKS, np.int32)])
    col_ids = np.concatenate([host.col_ids, np.zeros(PAD_BLOCKS * BW, np.int32)])
    return dict(tiles=tiles, block_window=block_window, block_first=block_first,
                col_ids=col_ids, edge_pos=host.edge_pos, num_windows=w,
                num_src=w * BH + EXTRA_SRC)


def port_meta(s, dtype):
    cfg = TileConfig(blk_h=BH, blk_w=BW, compute_dtype=dtype)
    return shard_meta(cfg, s["tiles"], s["block_window"], s["block_first"], s["col_ids"],
                      s["edge_pos"], s["num_windows"], s["num_src"], "cpu")


def jax_cfg(jdt):
    return JaxTileConfig(blk_h=BH, blk_w=BW, compute_dtype=jdt)


def rand(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def j(t):
    """A torch tensor as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def test_shard_meta_never_visits_padding(stream):
    meta = port_meta(stream, torch.float32)
    real = len(stream["block_window"]) - PAD_BLOCKS
    assert meta.num_blocks == len(stream["block_window"])
    assert int(meta.win_start[-1]) == real
    assert meta.num_rows == stream["num_windows"] * BH and meta.num_src == stream["num_src"]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", [8, 24])
def test_spmm_fused_plain_matches_jax(stream, dt, d):
    tdt, jdt = DTYPES[dt]
    meta = port_meta(stream, tdt)
    x = rand((stream["num_src"], d), 1)
    s_tiles = rand(stream["tiles"].shape, 2, tdt)  # garbage off the edges, as in JAX
    a = torch.from_numpy(stream["tiles"])
    got = spmm_fused(x, meta, a, s_tiles)  # the wrapper: plain on a CPU tensor
    assert spmm_fused.plain_calls > 0 and got.dtype == torch.float32
    want = _spmm_fused_padded(
        j(x), jnp.asarray(stream["tiles"]), j(s_tiles), jnp.asarray(stream["col_ids"]),
        jnp.asarray(stream["block_window"]), jnp.asarray(stream["block_first"]),
        cfg=jax_cfg(jdt), num_windows=stream["num_windows"], interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :d], **TOL[dt])
    np.testing.assert_array_equal(got.numpy(), spmm_fused_torch(x, meta, a, s_tiles).numpy())


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sfused_bwd_window_overrides_match_jax(stream, dt):
    tdt, jdt = DTYPES[dt]
    meta = port_meta(stream, tdt)
    d, rows = 16, stream["num_windows"] * BH
    x, dy = rand((stream["num_src"], d), 3) * 0.5, rand((stream["num_src"], d), 4)
    xw, dyw = rand((rows, d), 5) * 0.5, rand((rows, d), 6)
    a = torch.from_numpy(stream["tiles"])
    dx3, u = spmm_sfused_bwd(x, dy, meta, a, xw=xw, dyw=dyw)
    want_dx3, want_u = _spmm_sfused_bwd_padded(
        j(x), j(dy), jnp.asarray(stream["tiles"]), jnp.asarray(stream["col_ids"]),
        jnp.asarray(stream["block_window"]), jnp.asarray(stream["block_first"]),
        cfg=jax_cfg(jdt), num_windows=stream["num_windows"], interpret=True, xw=j(xw), dyw=j(dyw),
    )
    np.testing.assert_allclose(dx3.numpy(), np.asarray(want_dx3)[:, :d], **TOL[dt])
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u)[:, :d], **TOL[dt])
    # Without overrides the window side is x itself (its first rows).
    base = spmm_sfused_bwd_torch(x[:rows], dy[:rows], port_meta(
        dict(stream, num_src=rows), tdt), a)
    over = spmm_sfused_bwd_torch(x[:rows], dy[:rows], port_meta(dict(stream, num_src=rows), tdt),
                                 a, xw=x[:rows], dyw=dy[:rows])
    for p, q in zip(base, over):
        np.testing.assert_array_equal(p.numpy(), q.numpy())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d,tile_f32", [(16, False), (136, True)])
def test_sddmm_tile_mode_matches_jax_at_edges(stream, dt, d, tile_f32):
    """JAX keeps f32 tiles past one 128-wide d-tile; the port asks for them."""
    tdt, jdt = DTYPES[dt]
    meta = port_meta(stream, tdt)
    rows = stream["num_windows"] * BH
    xa, xb = rand((rows, d), 7), rand((stream["num_src"], d), 8)
    out = torch.float32 if tile_f32 else tdt
    got = sddmm_tc_tiles(xa, meta, xb, out_dtype=out)
    assert got.dtype == out
    want = np.asarray(_sddmm_dense_padded(
        j(xa), j(xb), jnp.asarray(stream["col_ids"]), jnp.asarray(stream["block_window"]),
        cfg=jax_cfg(jdt), num_windows=stream["num_windows"], interpret=True,
        out_dtype=jdt).astype(jnp.float32))
    pos = stream["edge_pos"]
    flat = got.float().numpy().reshape(-1)
    tol = TOL["f32"] if out == torch.float32 else dict(rtol=8e-3, atol=1e-5)
    np.testing.assert_allclose(flat[pos], want.reshape(-1)[pos], **tol)
    off = np.ones(flat.size, bool)
    off[pos] = False
    assert not flat[off].any()
