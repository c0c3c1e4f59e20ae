"""K4's plain versions at the widths and edge orders its kernel branches on,
against the JAX package.

The CUDA kernel (``csrc/sddmm_dense.cu``) takes lane groups of 4 to 32
lanes of four columns (d <= 128), four scalar loads where d % 4 != 0, and a
loop over 128-column tiles past 128; it reads each edge's own row and
column, in any order.  Its plain versions, what ``sddmm_tc_dense`` and
``sddmm_tc_tiles`` run on a CPU tensor, are held here to the JAX package on
the same numpy inputs (Pallas in interpret mode), in f32 and bf16:

* a directed banded graph through an ``EdgeList`` (what the block-diagonal
  route's SDDMM runs over where the pack covers the graph), against the JAX
  ``sddmm_tc_dense`` of the same graph and an f64 oracle, at d in {1, 5,
  33, 129}; the banded graph's route runs K4 over every CSR edge;
* the condensed tiles' metadata at the same widths;
* a split stream of a 4x2 mesh whose edges are out of row order: per-edge
  scores and score tiles against the tiles of the JAX
  ``_sddmm_dense_padded(..., out_dtype=...)`` at every edge position (zero
  elsewhere).

And the check a CUDA launch runs on the metadata's edge arrays, worked out
once where the metadata is made (``edge_device``): a non-int32 or
non-contiguous index array raises.

Tolerances: ``rtol=atol=1e-5`` (both sides sum the same exact products of
compute-dtype operands in f32, in another order); bf16 score tiles one bf16
unit (``rtol=8e-3``), as ``test_torch_fused.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops.sddmm import _sddmm_dense_padded
from tcgnn_tpu.ops.sddmm import sddmm_tc_dense as jax_sddmm_tc_dense
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch import TileConfig, TiledGraph
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import EdgeList, reset_counts, sddmm_tc_dense, sddmm_tc_tiles
from tcgnn_tpu_torch.ops.reference import sddmm_ref
from tcgnn_tpu_torch.ops.sddmm import check_edge_operands
from tcgnn_tpu_torch.parallel import DistributedTiledGraph, make_mesh
from tcgnn_tpu_torch.sgt import translate as port_sgt

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TILE_TOL = dict(rtol=8e-3, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# One lane group of 4 columns (1, with three lanes idle), the scalar loads
# (5, 33), and two 128-column tiles (129).
WIDTHS = [1, 5, 33, 129]


def banded_graph(far=80):
    """A directed band of +-60 around the diagonal and ``far`` random edges:
    the block-diagonal route, fully covered (no far edges) or with a
    residual, asymmetric."""
    n = 1200
    rng = np.random.default_rng(17)
    src = rng.integers(0, n, 4000)
    dst = np.clip(src + rng.integers(-60, 61, len(src)), 0, n - 1)
    far = rng.integers(0, n, (2, far))
    rp, ci = coo_to_csr(np.concatenate([src, far[0]]), np.concatenate([dst, far[1]]), n)
    return n, rp, ci


def powerlaw():
    n = 240
    src, dst = powerlaw_graph(n, 1300, seed=21)
    keep = (src < dst) | (src % 3 == 0)
    return (n, *coo_to_csr(src[keep], dst[keep], n))


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


def jax_scores(rp, ci, n, dtype, xa, xb, geometry=(512, 128)):
    """The JAX package's per-edge scores over its own SGT pass of the graph."""
    bh, bw = geometry
    jmeta = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, compute_dtype=DTYPES[dtype][1]),
        emit_chunks=False).as_jax(lite=True)
    return np.asarray(jax_sddmm_tc_dense(jnp.asarray(xa), jmeta, jnp.asarray(xb)))


def oracle(rp, ci, dtype, xa, xb):
    """The f64 dots of the compute-dtype operands."""
    ct = DTYPES[dtype][0]
    a64, b64 = (torch.from_numpy(x).to(ct).double() for x in (xa, xb))
    return sddmm_ref(a64, torch.from_numpy(rp), torch.from_numpy(ci), b64).numpy()


@pytest.fixture(scope="module")
def banded():
    n, rp, ci = banded_graph()
    rows = np.repeat(np.arange(n), np.diff(rp))
    return n, rp, ci, rows


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_edge_list_matches_jax_and_oracle(banded, dtype, d):
    n, rp, ci, rows = banded
    el = EdgeList.from_rows(rows, ci, n, TileConfig(compute_dtype=DTYPES[dtype][0]), "cpu")
    xa, xb = features(n, d, 1), features(n, d, 2)
    reset_counts()
    got = sddmm_tc_dense(torch.from_numpy(xa), el, torch.from_numpy(xb))
    assert (sddmm_tc_dense.plain_calls, sddmm_tc_dense.launches) == (1, 0)
    assert got.dtype == torch.float32 and got.shape == (len(ci),)
    np.testing.assert_allclose(got.numpy(), jax_scores(rp, ci, n, dtype, xa, xb), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle(rp, ci, dtype, xa, xb), **TOL)


@pytest.mark.parametrize("far", [0, 80])
def test_banded_graph_runs_k4_over_every_edge(far):
    """The block-diagonal route's SDDMM is K4 over every CSR edge, in CSR
    order: over an ``EdgeList`` where the pack covers the graph, else over
    the condensed metadata's per-edge arrays; its scores are the JAX
    package's."""
    n, rp, ci = banded_graph(far)
    g = TiledGraph(rp, ci, n, TileConfig(), device="cpu")
    assert g.block_diag and g.bd_full_coverage == (far == 0)
    el = g._sddmm_meta
    assert isinstance(el, EdgeList) == (far == 0)
    np.testing.assert_array_equal(el.edge_rows.numpy(), np.repeat(np.arange(n), np.diff(rp)))
    np.testing.assert_array_equal(el.edge_cols.numpy(), ci)
    assert el.edge_device == torch.device("cpu")
    x = features(n, 22, 3)
    got = g.sddmm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), jax_scores(rp, ci, n, "f32", x, x), **TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_condensed_meta_matches_jax_at_kernel_widths(dtype, d):
    n, rp, ci = powerlaw()
    ct = DTYPES[dtype][0]
    meta = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(16, 8, ct)).to("cpu")
    xa, xb = features(n, d, 4), features(n, d, 5)
    got = sddmm_tc_dense(torch.from_numpy(xa), meta, torch.from_numpy(xb)).numpy()
    np.testing.assert_allclose(got, jax_scores(rp, ci, n, dtype, xa, xb, (16, 8)), **TOL)
    np.testing.assert_allclose(got, oracle(rp, ci, dtype, xa, xb), **TOL)


def mega_graph(n=400, seed=11):
    """A symmetric sparse graph with one dense row window at the front: the
    split stream engages on a 4x2 mesh."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    rows = np.repeat(np.arange(n), [len(c) for c in cols])
    cols = np.concatenate(cols)
    return (n, *coo_to_csr(np.concatenate([rows, cols]), np.concatenate([cols, rows]), n))


@pytest.fixture(scope="module")
def split_streams():
    """The forward split streams of a 4x2 mesh (16x16 tiles) whose edges
    are out of row order: K4's tile mode runs over them in the fused AGNN."""
    n, rp, ci = mega_graph()
    dg = DistributedTiledGraph(rp, ci, n, make_mesh(4, 2, "cpu"),
                               TileConfig(blk_h=16, blk_w=16, edge_chunk=16))
    assert dg.agnn_split
    streams = [st for st in dg._fwd.split.streams
               if (np.diff(st.meta.edge_rows.numpy()) < 0).any()]
    assert streams
    return streams


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,tile_f32", [(5, False), (5, True), (33, False), (33, True),
                                        (129, True)])
def test_split_stream_out_of_row_order_matches_jax(split_streams, dtype, d, tile_f32):
    """Each edge's score and the score tiles over a stream whose edges are
    out of row order, against the JAX tiles at every edge's position (the
    JAX kernel keeps f32 tiles past 128 columns, as the port asks for)."""
    ct, jt = DTYPES[dtype]
    for k, st in enumerate(split_streams):
        m = dataclasses.replace(st.meta, config=dataclasses.replace(st.meta.config,
                                                                    compute_dtype=ct))
        xa, xb = features(m.num_rows, d, 6 + k), features(m.num_src, d, 8 + k)
        want = np.asarray(_sddmm_dense_padded(
            jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(m.col_ids.numpy()),
            jnp.asarray(m.block_window.numpy()),
            cfg=JaxTileConfig(blk_h=16, blk_w=16, compute_dtype=jt), num_windows=m.num_windows,
            interpret=True, out_dtype=jnp.float32 if tile_f32 else jt).astype(jnp.float32))
        pos = m.edge_pos.numpy()
        scores = sddmm_tc_dense(torch.from_numpy(xa), m, torch.from_numpy(xb)).numpy()
        if tile_f32:
            np.testing.assert_allclose(scores, want.reshape(-1)[pos], **TOL)
        out = torch.float32 if tile_f32 else ct
        tiles = sddmm_tc_tiles(torch.from_numpy(xa), m, torch.from_numpy(xb), out_dtype=out)
        assert tiles.dtype == out and tiles.shape == want.shape
        flat = tiles.float().numpy().reshape(-1)
        np.testing.assert_allclose(flat[pos], want.reshape(-1)[pos],
                                   **(TOL if out == torch.float32 else BF16_TILE_TOL))
        off = np.ones(flat.size, bool)
        off[pos] = False
        assert not flat[off].any()


def condensed_meta():
    n, rp, ci = powerlaw()
    return port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(16, 8)).to("cpu")


def edge_list():
    n, rp, ci = powerlaw()
    return EdgeList.from_rows(np.repeat(np.arange(n), np.diff(rp)), ci, n, TileConfig(), "cpu")


def strided(t):
    return torch.stack([t, t], 1)[:, 0]


# (metadata, field, replacement, tile mode, error and message or None)
EDGE_CHECK_CASES = {
    "condensed ok": (condensed_meta, None, None, True, None),
    "edge list ok": (edge_list, None, None, False, None),
    "rows int64": (condensed_meta, "edge_rows", torch.Tensor.long, False, (TypeError, "int32")),
    "cols strided": (condensed_meta, "edge_cols", strided, True,
                     (ValueError, "edge_cols is not contiguous")),
    "pos int64, per edge": (condensed_meta, "edge_pos", torch.Tensor.long, False, None),
    "pos int64, tiles": (condensed_meta, "edge_pos", torch.Tensor.long, True,
                         (TypeError, "edge_pos must be int32")),
    "edge list cols int64": (edge_list, "edge_cols", torch.Tensor.long, False,
                             (TypeError, "int32")),
    "edge list rows strided": (edge_list, "edge_rows", strided, False,
                               (ValueError, "not contiguous")),
}


@pytest.mark.parametrize("case", list(EDGE_CHECK_CASES))
def test_edge_check_is_worked_out_once_and_raises(case):
    """``edge_device`` is set where the metadata is made (and again on
    ``dataclasses.replace``); ``check_edge_operands``, what a CUDA launch
    runs first, passes where it matches the features' device and names the
    fault where it does not."""
    make, field, fault, tiles, raises = EDGE_CHECK_CASES[case]
    meta = make()
    assert meta.edge_device == torch.device("cpu")
    if field is not None:
        meta = dataclasses.replace(meta, **{field: fault(getattr(meta, field))})
        assert meta.edge_device is None
    with pytest.raises(ValueError, match="features on meta"):
        check_edge_operands("sddmm", make(), torch.device("meta"), tiles)
    if raises is None:
        check_edge_operands("sddmm", meta, torch.device("cpu"), tiles)
    else:
        with pytest.raises(raises[0], match=raises[1]):
            check_edge_operands("sddmm", meta, torch.device("cpu"), tiles)
