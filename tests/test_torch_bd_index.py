"""The per-row index of a block-diagonal pack, which K6 and K7 walk on the card,
and the score-fused plain versions at the widths past 128 that K2, K3, K6
and K7 take.

* ``bd_row_index`` holds the pack's nonzeros bit for bit, in
  ``pack.nonzero()`` order, each at its node row and column with its value,
  entries outside the graph dropped: int8 and int16 counts at DD's density
  (about 5 a row), with an empty row and a row filled across its stripe
  (1,024 entries for 8 offsets of 128), for every offset set of the card
  tests, bins of 20 and 128 rows; the same in slabs smaller than the pack;
  float and bf16 packs too.
* On small BD graphs, the index ``TiledGraph`` builds at upload equals the
  one read from the JAX ``BDMeta``: its ``tile_idx`` through
  ``packed_index``, sorted, with ``tile_cnt`` (what ``build_bd_pack``
  scatters).
* The wrappers run the plain versions on CPU tensors, index or not, and
  count them; ``check_row_index`` (what a CUDA launch runs first) rejects a
  missing index and one whose rows, nonzero count, dtypes or layout do not
  fit.
* The plain versions of K2, K3, K6 and K7 match the JAX package (Pallas in
  interpret mode, d padded to lanes) at d = 129 and 200, f32, tolerance
  ``rtol=atol=1e-5`` as in ``test_torch_sfused.py`` and
  ``test_torch_bd_ops.py``: the same rounding points, f32 sums in another
  order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops import spmm as jax_spmm
from tcgnn_tpu.sgt import blockdiag as jax_bd
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.ops import (
    bd_sfused,
    bd_sfused_bwd,
    reset_counts,
    spmm_sfused,
    spmm_sfused_bwd,
)
from tcgnn_tpu_torch.ops import blockdiag as port_bd
from tcgnn_tpu_torch.sgt import translate as port_sgt
from tcgnn_tpu_torch.sgt.blockdiag import packed_index

# The offset sets of the card tests (tests/test_torch_kernels.py).
BD_OFFSETS = {"diag": (0,), "tri": (-1, 0, 1), "hepta": (-3, -2, -1, 0, 1, 2, 3),
              "upper": (0, 1, 2), "octa": (-4, -3, -2, -1, 0, 1, 2, 3),
              "gaps": (-5, -1, 0, 3)}
N = 1100  # a partial last bin, padding bins past it
EMPTY_ROW = 5
TOL = dict(rtol=1e-5, atol=1e-5)


def make_pack(n, offsets, kind, bn, seed=0):
    """A random pack ``[Bp, bn, K*bn]`` of about 5 entries a row (DD's
    density), random entries in the padding rows too, row ``EMPTY_ROW``
    empty and the first row of the middle bin filled across its stripe:
    int8 counts 1-3; int16, one entry in 500 a count of 128-300; float or
    bf16 normal weights."""
    rng = np.random.default_rng(seed)
    bp = -(-(-(-n // bn)) // 8) * 8
    stripe = len(offsets) * bn
    shape = (bp * bn, stripe)
    mask = rng.random(shape) < 5 / stripe
    if kind in ("int8", "int16"):
        vals = rng.integers(1, 4, shape)
        if kind == "int16":
            vals = np.where(rng.random(shape) < 0.002, rng.integers(128, 301, shape), vals)
        pack = torch.from_numpy((mask * vals).astype(np.int8 if kind == "int8" else np.int16))
    else:
        pack = torch.from_numpy((mask * rng.standard_normal(shape)).astype(np.float32))
        pack = pack.to(torch.bfloat16 if kind == "bfloat16" else torch.float32)
    pack[EMPTY_ROW] = 0
    pack[(-(-n // bn) // 2) * bn] = 1
    return pack.view(bp, bn, stripe)


def expected_index(pack, offsets, n):
    """The index read straight off the pack in numpy: nonzeros in row-major
    order, their node columns, those inside the graph."""
    bp, bn, stripe = pack.shape
    flat = pack.reshape(bp * bn, stripe)
    r, j = (t.numpy() for t in torch.nonzero(flat, as_tuple=True))
    cols = (r // bn + np.asarray(offsets)[j // bn]) * bn + j % bn
    keep = (r < n) & (cols >= 0) & (cols < n)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r[keep], minlength=n), out=ptr[1:])
    return ptr, cols[keep], flat[torch.from_numpy(r[keep]), torch.from_numpy(j[keep])]


def assert_index(idx, ptr, cols, vals):
    assert idx.row_ptr.dtype == torch.int64 and idx.cols.dtype == torch.int32
    np.testing.assert_array_equal(idx.row_ptr.numpy(), ptr)
    np.testing.assert_array_equal(idx.cols.numpy(), cols)
    assert idx.vals.dtype == vals.dtype and torch.equal(idx.vals, vals)
    assert idx.nnz == ptr[-1] and idx.num_rows == len(ptr) - 1


@pytest.mark.parametrize("offsets", list(BD_OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("bn", [20, 128])
def test_row_index_is_the_packs_nonzeros(offsets, kind, bn):
    offs = BD_OFFSETS[offsets]
    pack = make_pack(N, offs, kind, bn)
    idx = port_bd.bd_row_index(pack, offs, N)
    ptr, cols, vals = expected_index(pack, offs, N)
    assert_index(idx, ptr, cols, vals)
    assert ptr[EMPTY_ROW + 1] == ptr[EMPTY_ROW]
    row = (-(-N // bn) // 2) * bn
    full = sum(0 <= (row // bn + o) * bn and (row // bn + o + 1) * bn <= N for o in offs) * bn
    assert ptr[row + 1] - ptr[row] == full
    if offsets == "octa" and bn == 128:
        assert full == 1024


@pytest.mark.parametrize("bn", [20, 128])
def test_row_index_in_slabs_is_the_same(monkeypatch, bn):
    """Slabs of 1,000 entries, cut inside rows, give the one-slab index."""
    offs = BD_OFFSETS["hepta"]
    pack = make_pack(N, offs, "int8", bn, seed=3)
    whole = port_bd.bd_row_index(pack, offs, N)
    monkeypatch.setattr(port_bd, "INDEX_SLAB", 1000)
    assert_index(port_bd.bd_row_index(pack, offs, N), whole.row_ptr.numpy(), whole.cols.numpy(),
                 whole.vals)


@pytest.mark.parametrize("kind", ["float", "bfloat16"])
def test_row_index_of_weighted_packs(kind):
    offs = BD_OFFSETS["tri"]
    pack = make_pack(N, offs, kind, 128, seed=4)
    assert_index(port_bd.bd_row_index(pack, offs, N), *expected_index(pack, offs, N))


def union_graph(kind):
    """Symmetric union graphs: fully covered, with a residual of long-range
    edges, and with one cell counted 200 times (an int16 pack)."""
    n = {"full": 1500, "residual": 1600, "int16": 700}[kind]
    src, dst = component_union_graph(n, 2 * n + 200, n // 25, seed=2)
    if kind == "residual":
        e, far = np.random.default_rng(7).integers(0, n, (2, int(0.03 * len(src))))
        src, dst = np.concatenate([src, e, far]), np.concatenate([dst, far, e])
    elif kind == "int16":
        src, dst = np.concatenate([src, np.full(200, 5), np.full(200, 6)]), np.concatenate(
            [dst, np.full(200, 6), np.full(200, 5)])
    return (n, *coo_to_csr(src, dst, n))


@pytest.mark.parametrize("kind", ["full", "residual", "int16"])
def test_graph_row_index_matches_the_jax_decomposition(kind):
    n, rp, ci = union_graph(kind)
    g = TiledGraph(rp, ci, n, TileConfig(), device="cpu")
    assert g.block_diag and g._agnn_bd and g.bd.row_index is not None
    assert g.bd.pack.dtype == (torch.int16 if kind == "int16" else torch.int8)
    m = jax_bd.extract_block_diag(rp, ci, n)
    k, bn = len(m.offsets), m.bin_rows
    p = packed_index(np.asarray(m.tile_idx, np.int64), m.num_bins, k, bn)
    order = np.argsort(p, kind="stable")
    p, cnt = p[order], np.asarray(m.tile_cnt)[order]
    r, j = p // (k * bn), p % (k * bn)
    cols = (r // bn + np.asarray(m.offsets)[j // bn]) * bn + j % bn
    keep = (r < n) & (cols >= 0) & (cols < n)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r[keep], minlength=n), out=ptr[1:])
    assert_index(g.bd.row_index, ptr, cols[keep], torch.from_numpy(cnt[keep]))


def small_pack(n=300, offs=BD_OFFSETS["tri"]):
    return make_pack(n, offs, "int8", 128, seed=5), offs


def test_cpu_wrappers_with_an_index_run_the_plain_versions():
    pack, offs = small_pack()
    idx = port_bd.bd_row_index(pack, offs, 300)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((300, 8)).astype(np.float32))
    reset_counts()
    cfg = TileConfig()
    got = bd_sfused(x, x, x, pack, offsets=offs, cfg=cfg, index=idx)
    dx3, u = bd_sfused_bwd(x, x, pack, offsets=offs, cfg=cfg, index=idx)
    assert (bd_sfused.plain_calls, bd_sfused.launches) == (1, 0)
    assert (bd_sfused_bwd.plain_calls, bd_sfused_bwd.launches) == (1, 0)
    torch.testing.assert_close(got, bd_sfused(x, x, x, pack, offsets=offs, cfg=cfg))
    torch.testing.assert_close(u, got)


BAD_INDEX = {
    "missing": (lambda idx: None, ValueError, "row index"),
    "rows": (lambda idx: dataclasses.replace(idx, row_ptr=idx.row_ptr[:-1]), ValueError,
             "rows for"),
    "nnz_arrays": (lambda idx: dataclasses.replace(idx, cols=idx.cols[:-1]), ValueError,
                   "a value a column"),
    "nnz_pack": (lambda idx: dataclasses.replace(
        idx, cols=torch.zeros(300 * 384 + 1, dtype=torch.int32),
        vals=torch.ones(300 * 384 + 1, dtype=torch.int8)), ValueError, "nonzero count"),
    "dtype": (lambda idx: dataclasses.replace(idx, vals=idx.vals.to(torch.int16)), TypeError,
              "values"),
    "layout": (lambda idx: dataclasses.replace(idx, cols=idx.cols.repeat_interleave(2)[::2]),
               ValueError, "contiguous"),
}


@pytest.mark.parametrize("case", list(BAD_INDEX))
def test_row_index_check_rejects_what_does_not_fit(case):
    pack, offs = small_pack()
    idx = port_bd.bd_row_index(pack, offs, 300)
    x = torch.zeros(300, 4)
    port_bd.check_row_index("op", idx, x, pack)
    make, err, match = BAD_INDEX[case]
    with pytest.raises(err, match=match):
        port_bd.check_row_index("op", make(idx), x, pack)
    if case != "missing":  # a CPU call with an index checks it too
        with pytest.raises(err, match=match):
            bd_sfused(x, x, x, pack, offsets=offs, cfg=TileConfig(), index=make(idx))


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def sgt_graph():
    """A 200-node power-law graph tiled 16x8 in both packages."""
    n = 200
    src, dst = powerlaw_graph(n, 1000, seed=8)
    rp, ci = coo_to_csr(src, dst, n)
    host = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(16, 8), build_tiles=True)
    jmeta = jax_sgt.sparse_graph_translate(rp, ci, n, JaxTileConfig(blk_h=16, blk_w=8),
                                           emit_chunks=False).as_jax(lite=True)
    return n, host.to("cpu"), torch.from_numpy(host.a_tiles), jmeta, jnp.asarray(host.a_tiles)


@pytest.mark.parametrize("d", [129, 200])
def test_wide_sfused_plain_matches_jax(sgt_graph, d):
    n, meta, tiles, jmeta, jtiles = sgt_graph
    xl, xr = features(n, d, 1), features(n, d, 2)
    got = spmm_sfused(torch.from_numpy(xl), torch.from_numpy(xr), torch.from_numpy(xr), meta,
                      tiles)
    want = jax_spmm.spmm_sfused(jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(xr), jmeta, jtiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [129, 200])
def test_wide_sfused_bwd_plain_matches_jax(sgt_graph, d):
    n, meta, tiles, jmeta, jtiles = sgt_graph
    x, dy = features(n, d, 3), features(n, d, 4)
    dx3, u = spmm_sfused_bwd(torch.from_numpy(x), torch.from_numpy(dy), meta, tiles)
    want_dx3, want_u = jax_spmm.spmm_sfused_bwd(jnp.asarray(x), jnp.asarray(dy), jmeta, jtiles)
    np.testing.assert_allclose(dx3.numpy(), np.asarray(want_dx3), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), **TOL)


@pytest.mark.parametrize("d", [129, 200])
def test_wide_bd_sfused_plain_matches_jax(d):
    pack, offs = small_pack()
    xl, xr, xv = (features(300, d, 5 + i) for i in range(3))
    got = bd_sfused(*(torch.from_numpy(a) for a in (xl, xr, xv)), pack, offsets=offs,
                    cfg=TileConfig(), index=port_bd.bd_row_index(pack, offs, 300))
    want = jax_spmm.bd_sfused(*(jnp.asarray(a) for a in (xl, xr, xv)), jnp.asarray(pack.numpy()),
                              offsets=offs, cfg=JaxTileConfig(), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [129, 200])
def test_wide_bd_sfused_bwd_plain_matches_jax(d):
    pack, offs = small_pack()
    x, dy = features(300, d, 8), features(300, d, 9)
    dx3, u = bd_sfused_bwd(torch.from_numpy(x), torch.from_numpy(dy), pack, offsets=offs,
                           cfg=TileConfig())
    want_dx3, want_u = jax_spmm.bd_sfused_bwd(jnp.asarray(x), jnp.asarray(dy),
                                              jnp.asarray(pack.numpy()), offsets=offs,
                                              cfg=JaxTileConfig(), interpret=True)
    np.testing.assert_allclose(dx3.numpy(), np.asarray(want_dx3), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), **TOL)
