"""The per-row index of SGT-condensed tiles, which K2 and K3 walk on the card.

* ``sgt_row_index`` holds the tiles' nonzeros bit for bit: each entry of a
  block the windows hold, at its window row ``block_window[b] * blk_h + r``
  and gathered row ``col_ids[b * blk_w + k]``, with its value in the tiles'
  dtype, a row's entries in block then column order, rows ascending, and
  each nonzero's row beside it.  Checked on int8, f32 and bf16 tiles at
  512x128 and 16x8: a power-law graph, a star whose hub row (3,000 leaves)
  is longer than many of the kernels' ranges of nonzeros, and a graph with
  empty rows and partial windows; the same in slabs smaller than the
  tiles; padding blocks past the windows (nonzero garbage in them) are
  skipped.
* Rectangular shard streams (``num_src != num_rows``): the index every
  stream of an 8x1 mesh (the split stream, guest windows included) and of
  an unsplit 8x1 mesh carries, against the stream's own tiles.
* Against the JAX package: the index ``TiledGraph`` builds at upload (the
  condensed route, and the block-diagonal route's residual) holds the
  (row, gathered row, value) triples of the JAX SGT pass's tiles, from the
  same numpy graph.
* The wrappers with ``index=`` on CPU tensors run the plain versions,
  against the JAX kernels (Pallas in interpret mode) at ``rtol=atol=1e-5``,
  the tolerance of ``test_torch_sfused.py`` (the same rounding points, f32
  sums in another order); ``check_sgt_index``, what a CUDA launch runs
  first, rejects a missing index and one that does not fit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops.spmm import spmm_sfused as jax_spmm_sfused
from tcgnn_tpu.ops.spmm import spmm_sfused_bwd as jax_spmm_sfused_bwd
from tcgnn_tpu.sgt import blockdiag as jax_bd
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.ops import build_a_tiles, reset_counts, spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.ops import sfused as port_sfused
from tcgnn_tpu_torch.parallel import DistributedTiledGraph, make_mesh
from tcgnn_tpu_torch.sgt import translate as port_sgt

TOL = dict(rtol=1e-5, atol=1e-5)
GEOMETRIES = {"512x128": (512, 128), "16x8": (16, 8)}
HUB_LEAVES = 3000


def graph(kind):
    """Symmetric graphs: power-law; a star of ``HUB_LEAVES`` leaves over a
    power-law graph; power-law edges on the first 200 of 260 nodes (empty
    rows, partial windows)."""
    if kind == "powerlaw":
        n = 600
        src, dst = powerlaw_graph(n, 4000, seed=8)
    elif kind == "star":
        n = HUB_LEAVES + 1
        src, dst = powerlaw_graph(n, 6000, seed=2)
        leaves = np.arange(1, n)
        src, dst = np.concatenate([src, np.zeros(n - 1, int), leaves]), np.concatenate(
            [dst, leaves, np.zeros(n - 1, int)])
    else:
        n = 260
        src, dst = powerlaw_graph(200, 1000, seed=9)
    return (n, *coo_to_csr(src, dst, n))


def expected_index(meta, tiles):
    """The index read straight off the tiles in numpy: the nonzeros of the
    blocks the windows hold, by (row, block, column)."""
    cfg = meta.config
    nb = int(meta.win_start[-1])
    b, r, k = (t.numpy() for t in torch.nonzero(tiles[:nb], as_tuple=True))
    rows = meta.block_window.numpy()[b].astype(np.int64) * cfg.blk_h + r
    cols = meta.col_ids.numpy()[b * cfg.blk_w + k].astype(np.int64)
    keep = (rows < meta.num_rows) & (cols >= 0) & (cols < meta.num_src)
    b, r, k, rows, cols = b[keep], r[keep], k[keep], rows[keep], cols[keep]
    order = np.lexsort((k, b, rows))
    ptr = np.zeros(meta.num_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=meta.num_rows), out=ptr[1:])
    vals = tiles[torch.from_numpy(b[order]), torch.from_numpy(r[order]),
                 torch.from_numpy(k[order])]
    return ptr, rows[order], cols[order], vals


def assert_index(idx, ptr, rows, cols, vals):
    assert idx.row_ptr.dtype == torch.int64
    assert idx.cols.dtype == idx.rows.dtype == torch.int32
    np.testing.assert_array_equal(idx.row_ptr.numpy(), ptr)
    np.testing.assert_array_equal(idx.rows.numpy(), rows)
    np.testing.assert_array_equal(idx.cols.numpy(), cols)
    assert idx.vals.dtype == vals.dtype and torch.equal(idx.vals, vals)
    assert idx.nnz == ptr[-1] and idx.num_rows == len(ptr) - 1
    assert idx.kernel_device == torch.device("cpu")


def tiled(kind, geometry, tile_kind="int8"):
    """The graph's condensed tiling on the CPU, and its tiles: as built
    (int8), or per-edge normal weights in f32 or bf16."""
    n, rp, ci = graph(kind)
    g = TiledGraph(rp, ci, n, TileConfig(*GEOMETRIES[geometry]), device="cpu", block_diag=False)
    tiles = g.a_struct
    if tile_kind != "int8":
        w = torch.from_numpy(np.random.default_rng(3).standard_normal(g.num_edges)
                             .astype(np.float32))
        tiles = build_a_tiles(g.meta, w).to(getattr(torch, tile_kind))
    return n, rp, ci, g, tiles


@pytest.mark.parametrize("kind", ["powerlaw", "star", "empty_rows"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("tile_kind", ["int8", "float32", "bfloat16"])
def test_index_is_the_tiles_nonzeros(kind, geometry, tile_kind):
    n, _, _, g, tiles = tiled(kind, geometry, tile_kind)
    idx = port_sfused.sgt_row_index(g.meta, tiles)
    ptr, rows, cols, vals = expected_index(g.meta, tiles)
    assert_index(idx, ptr, rows, cols, vals)
    assert idx.nnz == int((tiles != 0).sum())
    deg = np.diff(ptr)
    if kind == "star":
        # The hub row spans over a hundred of the kernels' ranges of 16.
        assert deg[0] >= HUB_LEAVES > 16 * 100
    if kind == "empty_rows":
        assert np.all(deg[200:] == 0) and np.sum(deg[:200] == 0) > 0


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_index_in_slabs_is_the_same(monkeypatch, geometry):
    """Slabs of 1,000 tile entries, cut inside tiles, give the one-slab
    index."""
    _, _, _, g, tiles = tiled("star", geometry)
    whole = port_sfused.sgt_row_index(g.meta, tiles)
    monkeypatch.setattr(port_sfused, "INDEX_SLAB", 1000)
    assert_index(port_sfused.sgt_row_index(g.meta, tiles), whole.row_ptr.numpy(),
                 whole.rows.numpy(), whole.cols.numpy(), whole.vals)


def test_padding_blocks_are_skipped():
    """Blocks past the windows' last (``win_start[-1]``) are padding: an
    index skips them, whatever they hold."""
    _, _, _, g, tiles = tiled("powerlaw", "16x8")
    m, pad = g.meta, 5
    padded = dataclasses.replace(
        m, num_blocks=m.num_blocks + pad,
        col_ids=torch.cat([m.col_ids, torch.zeros(pad * 8, dtype=torch.int32)]),
        block_window=torch.cat([m.block_window, m.block_window[-1:].repeat(pad)]))
    garbage = torch.cat([tiles, torch.ones((pad, 16, 8), dtype=tiles.dtype)])
    want = port_sfused.sgt_row_index(m, tiles)
    assert_index(port_sfused.sgt_row_index(padded, garbage), want.row_ptr.numpy(),
                 want.rows.numpy(), want.cols.numpy(), want.vals)


def mega_graph(n=400, seed=11):
    """A symmetric sparse graph with one dense row window at the front: the
    split stream engages on an 8x1 mesh."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    rows = np.repeat(np.arange(n), [len(c) for c in cols])
    cols = np.concatenate(cols)
    return (n, *coo_to_csr(np.concatenate([rows, cols]), np.concatenate([cols, rows]), n))


@pytest.mark.parametrize("split", [None, False])
def test_shard_streams_carry_their_index(split):
    """The streams K2/K3 run over on an 8x1 mesh (the split streams, whose
    guest windows write rows past the shard's own; else the unsplit
    streams) carry the index of their own tiles, over a gather source
    longer than their windows."""
    n, rp, ci = mega_graph()
    dg = DistributedTiledGraph(rp, ci, n, make_mesh(8, 1, "cpu"),
                               TileConfig(blk_h=16, blk_w=16, edge_chunk=16), split=split)
    assert dg.agnn_split == (split is None) and dg.agnn_aggregate is not None
    streams, _ = dg._agnn_streams()
    guest_rows = 0
    for st in streams:
        m = st.meta
        assert m.num_src != m.num_rows
        ptr, rows, cols, vals = expected_index(m, st.tiles)
        assert_index(st.index, ptr, rows, cols, vals)
        guest_rows += int(np.sum(rows >= dg.windows_per_shard * 16))
    assert (guest_rows > 0) == (split is None)
    # The streams K2/K3 do not run over carry none.
    other = dg._fwd.streams if split is None else []
    assert all(st.index is None for st in other + dg._bwd.streams)


def jax_triples(rp, ci, n, geometry):
    """The JAX SGT pass's tiles as (row, gathered row, value) triples,
    sorted by row, then block, then column."""
    bh, bw = GEOMETRIES[geometry]
    m = jax_sgt.sparse_graph_translate(rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw),
                                       emit_chunks=False, build_tiles=True)
    nb = int(np.sum(m.block_partition))
    b, r, k = np.nonzero(m.a_tiles[:nb])
    rows = m.block_window[b].astype(np.int64) * bh + r
    cols = m.col_ids[b * bw + k]
    keep = rows < n
    order = np.lexsort((k[keep], b[keep], rows[keep]))
    return rows[keep][order], cols[keep][order], m.a_tiles[:nb][b, r, k][keep][order]


@pytest.mark.parametrize("kind", ["powerlaw", "star"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_graph_index_matches_the_jax_tiles(kind, geometry):
    n, rp, ci = graph(kind)
    g = TiledGraph(rp, ci, n, TileConfig(*GEOMETRIES[geometry]), device="cpu", block_diag=False)
    assert g.symmetric and g.sfused_index is not None
    rows, cols, vals = jax_triples(rp, ci, n, geometry)
    idx = g.sfused_index
    np.testing.assert_array_equal(idx.rows.numpy(), rows)
    np.testing.assert_array_equal(idx.cols.numpy(), cols)
    np.testing.assert_array_equal(idx.vals.numpy(), vals)


def test_bd_residual_index_matches_the_jax_tiles():
    """On the block-diagonal route, K2/K3 run over the residual: its index
    holds the triples of the JAX SGT pass over the JAX decomposition's
    residual."""
    n = 1600
    src, dst = component_union_graph(n, 2 * n + 200, n // 25, seed=2)
    e, far = np.random.default_rng(7).integers(0, n, (2, int(0.03 * len(src))))
    rp, ci = coo_to_csr(np.concatenate([src, e, far]), np.concatenate([dst, far, e]), n)
    g = TiledGraph(rp, ci, n, TileConfig(), device="cpu")
    assert g.block_diag and g._agnn_bd and g.bd.res_index is not None and g.sfused_index is None
    m = jax_bd.extract_block_diag(rp, ci, n)
    rows, cols, vals = jax_triples(m.res_ptr, m.res_idx, n, "512x128")
    idx = g.bd.res_index
    assert idx.nnz > 0
    np.testing.assert_array_equal(idx.rows.numpy(), rows)
    np.testing.assert_array_equal(idx.cols.numpy(), cols)
    np.testing.assert_array_equal(idx.vals.numpy(), vals)


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def jax_setup(request):
    """The star graph tiled in both packages, at each geometry."""
    n, rp, ci = graph("star")
    bh, bw = GEOMETRIES[request.param]
    host = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(bh, bw), build_tiles=True)
    meta, tiles = host.to("cpu"), torch.from_numpy(host.a_tiles)
    jmeta = jax_sgt.sparse_graph_translate(rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw),
                                           emit_chunks=False).as_jax(lite=True)
    return n, meta, tiles, port_sfused.sgt_row_index(meta, tiles), jmeta, jnp.asarray(host.a_tiles)


@pytest.mark.parametrize("d", [3, 32])
@pytest.mark.parametrize("share", [True, False])
def test_forward_with_index_matches_jax(jax_setup, d, share):
    n, meta, tiles, idx, jmeta, jtiles = jax_setup
    xl, xr = features(n, d, 1), features(n, d, 2)
    xv = xr if share else features(n, d, 3)
    xr_t = torch.from_numpy(xr)
    xv_t = xr_t if share else torch.from_numpy(xv)
    reset_counts()
    got = spmm_sfused(torch.from_numpy(xl), xr_t, xv_t, meta, tiles, index=idx)
    assert (spmm_sfused.plain_calls, spmm_sfused.launches) == (1, 0)
    want = jax_spmm_sfused(jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(xv), jmeta, jtiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [3, 32])
def test_backward_with_index_matches_jax(jax_setup, d):
    n, meta, tiles, idx, jmeta, jtiles = jax_setup
    x, dy = features(n, d, 4), features(n, d, 5)
    reset_counts()
    dx3, u = spmm_sfused_bwd(torch.from_numpy(x), torch.from_numpy(dy), meta, tiles, index=idx)
    assert (spmm_sfused_bwd.plain_calls, spmm_sfused_bwd.launches) == (1, 0)
    want_dx3, want_u = jax_spmm_sfused_bwd(jnp.asarray(x), jnp.asarray(dy), jmeta, jtiles)
    np.testing.assert_allclose(dx3.numpy(), np.asarray(want_dx3), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), **TOL)


BAD_INDEX = {
    "missing": (lambda idx: None, ValueError, "row index"),
    "rows": (lambda idx: dataclasses.replace(idx, row_ptr=idx.row_ptr[:-1]), ValueError,
             "rows for"),
    "nnz_arrays": (lambda idx: dataclasses.replace(idx, cols=idx.cols[:-1]), ValueError,
                   "a value a column"),
    "nnz_tiles": (lambda idx: dataclasses.replace(
        idx, cols=torch.zeros(10**6, dtype=torch.int32), vals=torch.ones(10**6, dtype=torch.int8),
        rows=torch.zeros(10**6, dtype=torch.int32)), ValueError, "nonzero count"),
    "dtype": (lambda idx: dataclasses.replace(idx, vals=idx.vals.float()), TypeError, "values"),
    "no_rows": (lambda idx: dataclasses.replace(idx, rows=None), ValueError, "each nonzero's row"),
    "layout": (lambda idx: dataclasses.replace(idx, rows=idx.rows.repeat_interleave(2)[::2]),
               ValueError, "contiguous"),
}


@pytest.mark.parametrize("case", list(BAD_INDEX))
def test_index_check_rejects_what_does_not_fit(case):
    n, _, _, g, tiles = tiled("powerlaw", "16x8")
    idx = g.sfused_index
    port_sfused.check_sgt_index("op", idx, g.meta, tiles, torch.device("cpu"))
    make, err, match = BAD_INDEX[case]
    with pytest.raises(err, match=match):
        port_sfused.check_sgt_index("op", make(idx), g.meta, tiles, torch.device("cpu"))
    if case != "missing":  # a CPU call with an index checks it too
        x = torch.zeros(n, 4)
        with pytest.raises(err, match=match):
            spmm_sfused(x, x, x, g.meta, tiles, index=make(idx))
        with pytest.raises(err, match=match):
            spmm_sfused_bwd(x, x, g.meta, tiles, index=make(idx))
