"""The port's distributed streamed route and chunk fallback against
``tcgnn_tpu.parallel``.

The same CSR and the same numpy inputs go through the JAX
``DistributedTiledGraph`` (8 virtual CPU devices, interpret-mode Pallas) and
the port's (every shard on the CPU, K8's and K9's plain versions):

* ``partition_streamed``, the window segments stacked over the shards, bit
  for bit at G = 2 and 4, forced to many segments and at the default limits;
* the streamed route at 4x1 and 2x2, forced to many segments
  (``_stream_limits``, JAX's ``tests/test_parallel_streamed.py``): ``spmm``,
  ``spmm_weighted`` and ``sddmm``, forward and every gradient, on a
  symmetric graph (the transpose shares the forward layout) and a directed
  one; only K8 and K9 run;
* the chunk fallback (``dense_tiles=False``) at 4x2 against JAX's and the
  port's dense mesh route;
* ``_shards_need_streaming`` decides as JAX does;
* the trainer on ``--mesh 4x1`` over a graph the patched limits send to the
  streamed route: it trains and has the single-device model's first loss;
* a ``TorchChunkMeta`` whose output rows are not its source rows (a shard's
  rows against all the rows): K8's and K9's plain versions against a dense
  oracle.

Tolerances, as the JAX tests use: f32 ``rtol=atol=1e-4`` forward, ``1e-3``
for gradients.
"""

import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.dataset import coo_to_csr as jax_coo_to_csr
from tcgnn_tpu.data.synthetic import powerlaw_graph as jax_powerlaw_graph
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import graph as jax_graph
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu.parallel import partition as jax_part
from tcgnn_tpu.sgt import native as jax_native
from tcgnn_tpu.sgt import stream as jax_stream
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import (
    reset_counts,
    sddmm_tc,
    sddmm_tc_torch,
    spmm_tc,
    spmm_tc_torch,
)
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.parallel import DistributedTiledGraph, make_mesh
from tcgnn_tpu_torch.parallel import graph as port_graph
from tcgnn_tpu_torch.parallel import partition as port_part
from tcgnn_tpu_torch.sgt import stream as port_stream
from tcgnn_tpu_torch.sgt.stream import segment_chunks
from tcgnn_tpu_torch.sgt.translate import sparse_graph_translate, window_blocks
from test_torch_parallel import FWD, GRAD, _jax_ops, _port_ops, random_csr

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
JCFG = JaxTileConfig(blk_h=16, blk_w=16, edge_chunk=16)
# Tiny per-segment limits (max_chunks, max_slab_rows): every shard streams
# several segments (JAX's tests/test_parallel_streamed.py).
LIMITS = (8, 24 * 16)
N = 430
OPS = ("spmm", "spmm_weighted", "sddmm")


def powerlaw_csr(n=N, e=2600, seed=7):
    """JAX's streamed fixture graph (symmetric)."""
    src, dst = jax_powerlaw_graph(n, e, seed=seed)
    ptr, idx = jax_coo_to_csr(src, dst, n)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


GRAPHS = {"powerlaw": powerlaw_csr, "directed": lambda: random_csr(N, 6, seed=3)}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("shards,limits", [(2, LIMITS), (4, LIMITS), (4, None)])
def test_partition_streamed_matches_jax(name, shards, limits):
    ptr, idx = GRAPHS[name]()
    mc, msr = limits if limits is not None else (None, None)
    want = jax_part.partition_streamed(ptr, idx, N, shards, JCFG, max_chunks=mc,
                                       max_slab_rows=msr)
    got = port_part.partition_streamed(ptr, idx, N, shards, CFG, max_chunks=mc,
                                       max_slab_rows=msr)
    assert (want["num_segments"] > 1) == (limits is not None)
    for k, v in want.items():
        if k != "arrays":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in want["arrays"].items():
        assert got["arrays"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["arrays"][k], v, err_msg=k)
    # Each segment's real chunks: the rest of its C_max chunks are padding.
    seg_r, blk_h = got["arrays"]["seg_r"], CFG.blk_h
    for g in range(shards):
        for s, nc in enumerate(got["arrays"]["seg_chunks"][g]):
            assert (seg_r[g, s, nc:] == blk_h).all()


def _graphs(name, mesh, **kw):
    ptr, idx = GRAPHS[name]()
    jg = JaxDistributedTiledGraph(ptr, idx, N, jax_make_mesh(*mesh), JCFG, **kw)
    pg = DistributedTiledGraph(ptr, idx, N, make_mesh(*mesh, "cpu"), CFG, **kw)
    return ptr, idx, jg, pg


def _inputs(seed, e, d):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((N, d))).astype(np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    wv = (np.arange(e) % 7 - 3).astype(np.float32)
    return x, w, wv, None


STREAMED_CASES = [(name, mesh) for name in sorted(GRAPHS) for mesh in ((4, 1), (2, 2))]


@pytest.fixture(scope="module", params=STREAMED_CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def streamed(request):
    name, mesh = request.param
    ptr, idx, jg, pg = _graphs(name, mesh, streamed=True, _stream_limits=LIMITS)
    assert jg.streamed and pg.streamed and not pg.dense_tiles
    assert pg.num_segments == jg._stream_static[0]["num_segments"] > 1
    assert pg.agnn_aggregate is None and jg.agnn_aggregate is None
    x, w, wv, att = _inputs(len(name) + mesh[1], len(idx), 24)
    reset_counts()
    port = _port_ops(pg, N, x, w, wv, att, ops=OPS)
    counts = {k: (sum(f.launches for f in fs), sum(f.plain_calls for f in fs))
              for k, fs in (("K8/K9", (spmm_tc, sddmm_tc)),
                            ("others", [f for f in _kernels.COUNTED
                                        if f not in (spmm_tc, sddmm_tc)]))}
    return dict(name=name, pg=pg, jax=_jax_ops(jg, N, x, w, wv, att, ops=OPS), port=port,
                counts=counts, calls=(spmm_tc.plain_calls, sddmm_tc.plain_calls))


def _check_op(pg, got, want, op):
    if op == "sddmm":
        np.testing.assert_allclose(pg.gather_edge_vector(got[0]), pg.gather_edge_vector(want[0]),
                                   **FWD)
    else:
        np.testing.assert_allclose(got[0][:N], want[0][:N], **FWD)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if g.ndim == 1 and g.shape[0] == pg.padded_edges:
            g, w = pg.gather_edge_vector(g), pg.gather_edge_vector(w)
        elif g.shape[0] == pg.padded_nodes:
            g, w = g[:N], w[:N]
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}", **GRAD)


@pytest.mark.parametrize("op", OPS)
def test_streamed_op_matches_jax(streamed, op):
    _check_op(streamed["pg"], streamed["port"][op], streamed["jax"][op], op)


def test_streamed_route_runs_k8_and_k9_only(streamed):
    """Every op went through K8 or K9 (their plain versions, on the CPU), no
    other kernel; a symmetric graph's transpose shares the forward layout,
    a directed one's has its own; the route line names the segments."""
    pg = streamed["pg"]
    assert streamed["counts"]["others"] == (0, 0)
    spmm_calls, sddmm_calls = streamed["calls"]
    # A shard's calls (``_port_ops`` runs each op's forward twice): spmm K8
    # 2 + 1 (transpose); spmm_weighted K8 2 + 1, K9 1 (the weights'
    # gradient); sddmm K9 2, K8 2 (forward and transpose).
    shards = pg.pg * pg.pf
    assert spmm_calls == 8 * shards and sddmm_calls == 3 * shards
    assert (pg._bwd.metas is pg._fwd.metas) == (streamed["name"] == "powerlaw")
    for m in pg._fwd.metas + pg._bwd.metas:
        assert (m.num_rows, m.num_src) == (pg.rows_per_shard, pg.padded_nodes)
    assert (f"dense_tiles=False streamed=True block_diag=False mesh={pg.pg}x{pg.pf} "
            f"segments={pg.num_segments} wseg={pg.wseg}") in pg.route


@pytest.fixture(scope="module")
def chunk_fallback():
    ptr, idx, jg, pg = _graphs("directed", (4, 2), dense_tiles=False)
    assert not jg.dense_tiles and not pg.dense_tiles and not pg.streamed
    dense = DistributedTiledGraph(ptr, idx, N, make_mesh(4, 2, "cpu"), CFG)
    assert dense.dense_tiles
    # JAX's chunk kernels take a feature shard of a multiple of 128 columns
    # (its ``shard_features`` width).
    x, w, wv, att = _inputs(11, len(idx), 128 * 2)
    reset_counts()
    port = _port_ops(pg, N, x, w, wv, att, ops=OPS)
    calls = (spmm_tc.plain_calls, sddmm_tc.plain_calls)
    return dict(pg=pg, port=port, calls=calls, jax=_jax_ops(jg, N, x, w, wv, att, ops=OPS),
                dense=_port_ops(dense, N, x, w, wv, att, ops=OPS))


@pytest.mark.parametrize("op", OPS)
def test_chunk_fallback_matches_jax_and_the_dense_route(chunk_fallback, op):
    pg, got = chunk_fallback["pg"], chunk_fallback["port"][op]
    assert "dense_tiles=False streamed=False" in pg.route and pg.host_fwd.split is None
    assert chunk_fallback["calls"] == (8 * 8, 3 * 8)
    _check_op(pg, got, chunk_fallback["jax"][op], op)
    _check_op(pg, got, chunk_fallback["dense"][op], op)


def _stream_gate_limits(ptr, idx, shards):
    """(MAX_PREFETCH_CHUNKS, MAX_SLAB_ROWS) settings for the gate: the
    defaults; a chunk limit below a shard's edges; slab limits just below
    and at the heaviest shard's real block rows (past the cheap bound, so
    the block count decides; a shard with an empty window would pass at a
    count with padding blocks)."""
    wd = -(-(-(-N // CFG.blk_h)) // shards)
    rps = wd * CFG.blk_h
    ptr = np.concatenate([np.asarray(ptr, np.int64), np.full(shards * rps + 1 - len(ptr), ptr[-1])])
    blocks = max(int(window_blocks(ptr[s * rps:(s + 1) * rps + 1] - ptr[s * rps],
                                   idx[ptr[s * rps]:ptr[(s + 1) * rps]], rps, CFG).sum())
                 for s in range(shards))
    rows = blocks * CFG.blk_w
    return {"defaults": (None, None, False), "chunks": (8, None, True),
            "slab below": (None, rows - 1, True), "slab at": (None, rows, False)}


@pytest.mark.parametrize("case", ["defaults", "chunks", "slab below", "slab at"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shards_need_streaming_decides_as_jax(monkeypatch, case, shards):
    ptr, idx = powerlaw_csr()
    mc, msr, want = _stream_gate_limits(ptr, idx, shards)[case]
    for mod in (port_stream, jax_stream):
        if mc is not None:
            monkeypatch.setattr(mod, "MAX_PREFETCH_CHUNKS", mc)
        if msr is not None:
            monkeypatch.setattr(mod, "MAX_SLAB_ROWS", msr)
    got = port_graph._shards_need_streaming(ptr, idx, N, shards, CFG)
    assert got == want
    # JAX counts the blocks only through its native pass; without it, it
    # skips a shard past the cheap bound.
    if msr is None or jax_native.available():
        assert jax_graph._shards_need_streaming(ptr, idx, N, shards, JCFG) == got


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_cli_mesh_trains_on_the_streamed_route(monkeypatch, capsys, model):
    """Chunk limits of 8 a segment send rand_600_3000 to the streamed route
    on a 4x1 mesh (and on one device): it prints the route and its host
    prep, its loss falls, and its first loss is the single-device model's
    (``init_distributed_net`` zero-pads the single-device draws)."""
    monkeypatch.setattr(port_stream, "MAX_PREFETCH_CHUNKS", 8)
    args = ["--dataset", "rand_600_3000", "--dim", "12", "--classes", "3", "--epochs", "12",
            "--blk_h", "16", "--blk_w", "16", "--edge_chunk", "16", "--device", "cpu",
            "--model", model, "--hidden", "8", "--no_dropout"]
    reset_counts()
    r = port_train.main(args + ["--mesh", "4x1"])
    out = capsys.readouterr().out
    assert r["streamed"] and not r["dense_tiles"] and "streamed=True" in r["route"]
    for line in ("Route:\tdense_tiles=False streamed=True", "Prep host (ms):", "segments "):
        assert line in out, line
    assert spmm_tc.plain_calls > 0 and (sddmm_tc.plain_calls > 0) == (model == "agnn")
    assert np.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]
    one = port_train.main(args)
    np.testing.assert_allclose(r["first_loss"], one["first_loss"], rtol=1e-4)


def _rect_csr(rows=50, src=120, seed=5):
    """A CSR of ``rows`` rows over ``src`` columns, an empty row and a row
    with duplicate columns among them."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, rows)
    deg[7] = 0
    cols = [rng.integers(0, src, k) for k in deg]
    cols[3] = np.array([5, 5, 9, 119])
    ptr = np.zeros(rows + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr, np.concatenate(cols).astype(np.int32)


@pytest.mark.parametrize("layout", ["flat", "segments"])
def test_chunk_meta_with_rows_apart_from_sources(layout):
    """num_rows 50, num_src 120: K8 ``[50, d]`` from x ``[120, d]``, K9 of
    xa ``[50, d]`` against xb ``[120, d]``, against a dense oracle."""
    rows, src = 50, 120
    ptr, idx = _rect_csr(rows, src)
    host = sparse_graph_translate(ptr, idx, rows, CFG, num_cols=src, emit_chunks=True)
    meta = (host.to_chunks("cpu", num_src=src) if layout == "flat"
            else segment_chunks(host, max_chunks=2, max_slab_rows=32).to("cpu", num_src=src))
    assert (meta.num_rows, meta.num_src) == (rows, src) and meta.row_ptr.shape == (rows + 1,)
    assert (meta.num_segments > 1) == (layout == "segments")
    g = torch.Generator().manual_seed(0)
    x, xa = torch.randn(src, 7, generator=g), torch.randn(rows, 7, generator=g)
    w = torch.randn(len(idx), generator=g)
    dense = torch.zeros(rows, src, dtype=torch.float64)
    dense_w = torch.zeros(rows, src, dtype=torch.float64)
    r = np.repeat(np.arange(rows), np.diff(ptr))
    dense.index_put_((torch.from_numpy(r), torch.from_numpy(idx).long()),
                     torch.ones(len(idx), dtype=torch.float64), accumulate=True)
    dense_w.index_put_((torch.from_numpy(r), torch.from_numpy(idx).long()), w.double(),
                       accumulate=True)
    torch.testing.assert_close(spmm_tc(x, meta), (dense @ x.double()).float(), **FWD)
    torch.testing.assert_close(spmm_tc(x, meta, w), (dense_w @ x.double()).float(), **FWD)
    want = (xa.double()[r] * x.double()[torch.from_numpy(idx).long()]).sum(1).float()
    torch.testing.assert_close(sddmm_tc(xa, meta, x), want, **FWD)
    torch.testing.assert_close(spmm_tc_torch(x, meta), spmm_tc(x, meta))
    torch.testing.assert_close(sddmm_tc_torch(xa, meta, x), sddmm_tc(xa, meta, x))
    with pytest.raises(ValueError, match=r"expected \[120, d\]"):
        spmm_tc(xa, meta)
    with pytest.raises(ValueError, match="xb=None needs num_src == num_rows"):
        sddmm_tc(xa, meta)
    with pytest.raises(ValueError, match=r"expected \[120, 7\]"):
        sddmm_tc(xa, meta, xa)
    with pytest.raises(ValueError, match=r"expected \[50, d\]"):
        sddmm_tc(x, meta, x)
