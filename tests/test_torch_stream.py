"""The streamed route of the port (``sgt/stream.py``, ``spmm_tc_streamed``,
``sddmm_tc_streamed``, ``TiledGraph(streamed=True)``) against the JAX package.

Tiny per-segment budgets (``max_chunks=4, max_slab_rows=256``, as
``tests/test_stream.py``) make small graphs stream over several segments.
``segment_chunks`` must give JAX's arrays bit for bit (JAX with
``to_device=False``); the plain versions of the streamed ops must match
JAX's streamed ops (Pallas in interpret mode): f32 at ``rtol=1e-5,
atol=1e-4``, bf16 at ``rtol=atol=1e-5`` on features where every f32 sum is
exact (see ``tests/test_torch_chunk.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops import sddmm as jax_sddmm
from tcgnn_tpu.ops import spmm as jax_spmm
from tcgnn_tpu.sgt import stream as jax_stream
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import (
    reset_counts,
    sddmm_tc,
    sddmm_tc_streamed,
    spmm_tc,
    spmm_tc_streamed,
)
from tcgnn_tpu_torch.sgt import stream as port_stream
from tcgnn_tpu_torch.sgt import translate as port_sgt

F32 = dict(rtol=1e-5, atol=1e-4)
EXACT = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
GEOMETRIES = {"32x32": (32, 32, 32), "16x8": (16, 8, 32)}
BUDGETS = dict(max_chunks=4, max_slab_rows=256)
# segment_chunks cases: the small budgets, a forced segment count, and the
# pad arguments on top of the budgets
CASES = {
    "budgets": dict(BUDGETS),
    "forced": dict(num_segments=3),
    "padded": dict(BUDGETS, pad_chunks_to=64, pad_slab_blocks_to=48),
}
SEG_FIELDS = ("seg_col_ids", "seg_r", "seg_c", "seg_edge_id", "seg_block", "seg_window",
              "seg_first", "edge_perm")


def edges(n=300, e=1500, seed=5, asymmetric=False):
    src, dst = powerlaw_graph(n, e, seed=seed)
    if asymmetric:
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    return (n, *coo_to_csr(src, dst, n))


def hosts(geometry="32x32", dtype="f32", **kw):
    n, rp, ci = edges(**kw)
    bh, bw, ec = GEOMETRIES[geometry]
    pt, jt = DTYPES[dtype]
    port = port_sgt.sparse_graph_translate(
        rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=pt, edge_chunk=ec),
        emit_chunks=True)
    jax_meta = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec, compute_dtype=jt),
        emit_chunks=True)
    return n, rp, ci, port, jax_meta


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_segment_chunks_bit_identical(case, geometry):
    _, _, _, port, jax_meta = hosts(geometry)
    got = port_stream.segment_chunks(port, **CASES[case])
    want = jax_stream.segment_chunks(jax_meta, to_device=False, **CASES[case])
    assert got.num_segments > 1
    for f in ("num_nodes", "num_edges", "num_windows", "wseg", "num_segments"):
        assert getattr(got, f) == getattr(want, f), f
    for f in SEG_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port_stream.segment_chunks(port, plan_only=True, **CASES[case]) == \
        jax_stream.segment_chunks(jax_meta, plan_only=True, **CASES[case])
    # seg_chunks counts each segment's real chunks; the rest are padding.
    assert got.seg_chunks.sum() == port.num_chunks
    for s, nc in enumerate(got.seg_chunks):
        assert (got.seg_r[s, nc:] == port.config.blk_h).all()
        assert (got.seg_r[s, :nc] < port.config.blk_h).any(axis=1).all()


def test_pad_arguments_below_the_need_raise():
    _, _, _, port, _ = hosts()
    with pytest.raises(ValueError, match="pad_chunks_to"):
        port_stream.segment_chunks(port, **BUDGETS, pad_chunks_to=1)
    with pytest.raises(ValueError, match="pad_slab_blocks_to"):
        port_stream.segment_chunks(port, **BUDGETS, pad_slab_blocks_to=1)


@pytest.mark.parametrize("limits", [(None, None), (10, None), (None, 300), (10**6, 10**7)])
def test_needs_streaming_matches_jax(monkeypatch, limits):
    _, _, _, port, jax_meta = hosts()
    for attr, v in zip(("MAX_PREFETCH_CHUNKS", "MAX_SLAB_ROWS"), limits):
        if v is not None:
            monkeypatch.setattr(port_stream, attr, v)
            monkeypatch.setattr(jax_stream, attr, v)
    assert port_stream.needs_streaming(port) == jax_stream.needs_streaming(jax_meta)
    assert port_stream.MAX_PREFETCH_CHUNKS == jax_stream.MAX_PREFETCH_CHUNKS
    assert port_stream.MAX_SLAB_ROWS == jax_stream.MAX_SLAB_ROWS


def test_streamed_meta_upload():
    _, _, _, port, _ = hosts()
    host = port_stream.segment_chunks(port, **BUDGETS)
    m = host.to("cpu")
    assert (m.num_segments, m.wseg, m.max_chunks) == (host.num_segments, host.wseg,
                                                      host.seg_r.shape[1])
    assert m.num_real_chunks == port.num_chunks
    for f in ("seg_col_ids", "seg_r", "seg_c", "seg_edge_id", "seg_block", "seg_window",
              "seg_chunks"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), getattr(host, f), err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 16, 130])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_spmm_tc_streamed_plain_matches_jax(case, geometry, dtype, d, weighted):
    n, rp, ci, port, jax_meta = hosts(geometry, dtype, asymmetric=True)
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    w = (rng.standard_normal(len(ci)) * 0.3).astype(np.float32) if weighted else None
    if dtype == "bf16":
        x = np.clip(np.round(x * 64), -32, 32).astype(np.float32) / 64
        w = None if w is None else np.clip(np.round(w * 64), -32, 32).astype(np.float32) / 64
    smeta = port_stream.segment_chunks(port, **CASES[case]).to("cpu")
    reset_counts()
    got = spmm_tc_streamed(torch.from_numpy(x), smeta, None if w is None else torch.from_numpy(w))
    assert spmm_tc_streamed is spmm_tc and spmm_tc.plain_calls == 1
    assert got.dtype == torch.float32 and got.shape == (n, d)
    want = jax_spmm.spmm_tc_streamed(
        jnp.asarray(x, DTYPES[dtype][1]), jax_stream.segment_chunks(jax_meta, **CASES[case]),
        None if w is None else jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **(F32 if dtype == "f32" else EXACT))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 16, 130])
@pytest.mark.parametrize("two", [False, True], ids=["one_matrix", "two_matrices"])
def test_sddmm_tc_streamed_plain_matches_jax(case, dtype, d, two):
    n, rp, ci, port, jax_meta = hosts("16x8", dtype, asymmetric=True)
    rng = np.random.default_rng(d + 1)
    xa = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    xb = (rng.standard_normal((n, d)) * 0.3).astype(np.float32) if two else None
    if dtype == "bf16":
        xa = np.clip(np.round(xa * 64), -32, 32).astype(np.float32) / 64
        xb = None if xb is None else np.clip(np.round(xb * 64), -32, 32).astype(np.float32) / 64
    smeta = port_stream.segment_chunks(port, **CASES[case]).to("cpu")
    reset_counts()
    got = sddmm_tc_streamed(torch.from_numpy(xa), smeta,
                            None if xb is None else torch.from_numpy(xb))
    assert sddmm_tc_streamed is sddmm_tc and sddmm_tc.plain_calls == 1
    assert got.dtype == torch.float32 and got.shape == (len(ci),)
    jt = DTYPES[dtype][1]
    want = jax_sddmm.sddmm_tc_streamed(
        jnp.asarray(xa, jt), jax_stream.segment_chunks(jax_meta, **CASES[case]),
        None if xb is None else jnp.asarray(xb, jt), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **(F32 if dtype == "f32" else EXACT))
