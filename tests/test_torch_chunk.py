"""The chunk route of the port (K8, K9, the chunk layout, ``TiledGraph`` and
the trainer off dense tiles) against the JAX package.

* Layout: ``sparse_graph_translate(..., emit_chunks=True)`` gives the same
  chunk arrays and ``edge_perm``, bit for bit, as the JAX pass.  JAX's
  ``impl="auto"`` takes its native ``chunk_layout`` in this environment (the
  native pass is built here); both its native and its NumPy path are held.
* Ops: the plain versions (what the wrappers run on a CPU tensor) match the
  JAX ``spmm_tc`` and ``sddmm_tc`` (Pallas in interpret mode) on the same
  numpy inputs.  f32 at ``rtol=1e-5, atol=1e-4`` (the sums run in another
  order).  bf16 at ``rtol=atol=1e-5`` on features and weights on the grid of
  1/64 in [-1/2, 1/2], where every product and sum here is exact in f32, so
  only a rounding point could differ; outputs are f32 under bf16 in both.
* Graph, autograd, auto-routing and trainer: ``TiledGraph(dense_tiles=False)``
  in both packages, ``rtol=atol=1e-5`` on values of order one; Adam loss
  trajectories at ``rtol=1e-4`` (Adam's root of the second moment magnifies
  last-bit gradient differences), as ``tests/test_torch_train.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcgnn_tpu import graph as jax_graph
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.ops import sddmm as jax_sddmm
from tcgnn_tpu.ops import spmm as jax_spmm
from tcgnn_tpu.sgt import stream as jax_stream
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu.train import make_train_step as jax_make_train_step
from tcgnn_tpu_torch import graph as port_graph
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import GPU_REFERENCE_CONFIG, TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN
from tcgnn_tpu_torch.ops import reset_counts, sddmm_tc, sddmm_tc_dense, spmm_tc, spmm_tc_dense
from tcgnn_tpu_torch.sgt import stream as port_stream
from tcgnn_tpu_torch.sgt import translate as port_sgt

F32 = dict(rtol=1e-5, atol=1e-4)
EXACT = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (blk_h, blk_w, edge_chunk): tests/test_stream.py's geometry, and 16x8
GEOMETRIES = {"32x32": (32, 32, 32), "16x8": (16, 8, 32)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_FIELDS = ("chunk_r", "chunk_c", "chunk_edge_id", "chunk_block", "chunk_window",
                "chunk_first_in_window", "chunk_first_in_block", "edge_perm")


def edges(kind, seed=3):
    """(n, row_pointers, column_index) of a test graph."""
    if kind == "dense_block":  # rows 0-39 x columns 0-39: blocks of more than EC edges
        n = 120
        src, dst = powerlaw_graph(n, 500, seed=seed)
        r, c = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
        src, dst = np.concatenate([src, r.ravel()]), np.concatenate([dst, c.ravel()])
    elif kind == "duplicates":  # one edge 40 times, one 3 times
        n = 150
        src, dst = powerlaw_graph(n, 700, seed=seed)
        src = np.concatenate([src, np.full(40, 7), np.full(3, 90)])
        dst = np.concatenate([dst, np.full(40, 11), np.full(3, 2)])
    elif kind == "empty_windows":  # nodes 100-259 have no edges
        n = 260
        src, dst = powerlaw_graph(100, 600, seed=seed)
    elif kind == "asymmetric":
        n = 150
        src, dst = powerlaw_graph(n, 800, seed=seed)
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    else:  # symmetric
        n = 150
        src, dst = powerlaw_graph(n, 800, seed=seed)
    return (n, *coo_to_csr(src, dst, n))


def configs(geometry="32x32", dtype="f32", block_group=1):
    bh, bw, ec = GEOMETRIES[geometry]
    pt, jt = DTYPES[dtype]
    return (TileConfig(blk_h=bh, blk_w=bw, compute_dtype=pt, block_group=block_group,
                       edge_chunk=ec),
            JaxTileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec, compute_dtype=jt,
                          block_group=block_group))


def features(n, d, seed, dtype="f32"):
    """Normal features scaled by 0.3; for bf16 on the grid of 1/64 in
    [-1/2, 1/2] (exact f32 sums at these sizes)."""
    x = (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)
    if dtype == "bf16":
        x = np.clip(np.round(x * 64), -32, 32).astype(np.float32) / 64
    return x


def close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(jnp.asarray(want, jnp.float32)), **tol)


def assert_same_layout(port, jax_meta):
    for f in ("block_partition", "col_ids", "block_window", "block_first_in_window",
              *CHUNK_FIELDS):
        a, b = getattr(port, f), getattr(jax_meta, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.num_chunks == jax_meta.num_chunks
    assert port.num_real_blocks == jax_meta.num_real_blocks


@pytest.mark.parametrize("kind", ["dense_block", "duplicates", "empty_windows", "asymmetric"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("block_group", [1, 2])
@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_chunk_layout_bit_identical(kind, geometry, block_group, impl):
    n, rp, ci = edges(kind)
    cfg, jcfg = configs(geometry, block_group=block_group)
    port = port_sgt.sparse_graph_translate(rp, ci, n, cfg, emit_chunks=True)
    want = jax_sgt.sparse_graph_translate(rp, ci, n, jcfg, impl=impl, emit_chunks=True)
    assert_same_layout(port, want)
    if kind == "dense_block":
        per_block = np.bincount(port.edge_pos // (cfg.blk_h * cfg.blk_w))
        assert per_block.max() > cfg.edge_chunk  # a block of several chunks


def test_chunk_layout_config_and_upload():
    assert TileConfig().edge_chunk == 128 and GPU_REFERENCE_CONFIG.edge_chunk == 32
    assert TileConfig(blk_h=16).row_sentinel == 16
    n, rp, ci = edges("empty_windows")
    cfg, _ = configs("16x8")
    host = port_sgt.sparse_graph_translate(rp, ci, n, cfg)
    assert host.chunk_r is None and host.num_chunks == 0
    with pytest.raises(ValueError, match="emit_chunks"):
        host.to_chunks("cpu")
    host = port_sgt.sparse_graph_translate(rp, ci, n, cfg, emit_chunks=True)
    m = host.to_chunks("cpu")
    assert (m.num_segments, m.wseg, m.max_chunks) == (1, host.num_windows, host.num_chunks)
    assert m.num_real_chunks == host.num_chunks and m.seg_chunks.tolist() == [host.num_chunks]
    assert m.seg_r.dtype == torch.int32 and m.seg_r.shape == (1, *host.chunk_r.shape)


def jax_chunk_meta(rp, ci, n, jcfg):
    return jax_sgt.sparse_graph_translate(rp, ci, n, jcfg, emit_chunks=True).as_jax()


def port_chunk_meta(rp, ci, n, cfg):
    return port_sgt.sparse_graph_translate(rp, ci, n, cfg, emit_chunks=True).to_chunks("cpu")


@pytest.mark.parametrize("kind", ["duplicates", "empty_windows", "asymmetric"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 16, 130])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_spmm_tc_plain_matches_jax(kind, geometry, dtype, d, weighted):
    n, rp, ci = edges(kind)
    cfg, jcfg = configs(geometry, dtype)
    x = features(n, d, 1, dtype)
    w = features(len(ci), 1, 2, dtype)[:, 0] if weighted else None
    reset_counts()
    got = spmm_tc(torch.from_numpy(x), port_chunk_meta(rp, ci, n, cfg),
                  None if w is None else torch.from_numpy(w))
    assert spmm_tc.plain_calls == 1 and spmm_tc.launches == 0
    assert got.dtype == torch.float32 and got.shape == (n, d)
    want = jax_spmm.spmm_tc(jnp.asarray(x, DTYPES[dtype][1]), jax_chunk_meta(rp, ci, n, jcfg),
                            None if w is None else jnp.asarray(w), interpret=True)
    assert want.dtype == jnp.float32
    close(got, want, F32 if dtype == "f32" else EXACT)


@pytest.mark.parametrize("kind", ["duplicates", "asymmetric"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 16, 130])
@pytest.mark.parametrize("two", [False, True], ids=["one_matrix", "two_matrices"])
def test_sddmm_tc_plain_matches_jax(kind, geometry, dtype, d, two):
    n, rp, ci = edges(kind)
    cfg, jcfg = configs(geometry, dtype)
    xa, xb = features(n, d, 3, dtype), features(n, d, 4, dtype) if two else None
    reset_counts()
    got = sddmm_tc(torch.from_numpy(xa), port_chunk_meta(rp, ci, n, cfg),
                   None if xb is None else torch.from_numpy(xb))
    assert sddmm_tc.plain_calls == 1 and got.dtype == torch.float32 and got.shape == (len(ci),)
    jt = DTYPES[dtype][1]
    want = jax_sddmm.sddmm_tc(jnp.asarray(xa, jt), jax_chunk_meta(rp, ci, n, jcfg),
                              None if xb is None else jnp.asarray(xb, jt), interpret=True)
    close(got, want, F32 if dtype == "f32" else EXACT)


def chunk_graphs(kind, dtype="f32", streamed=None, geometry="32x32", **kw):
    n, rp, ci = edges(kind)
    cfg, jcfg = configs(geometry, dtype)
    g = TiledGraph(rp, ci, n, cfg, device="cpu", dense_tiles=False, streamed=streamed, **kw)
    jg = JaxTiledGraph(rp, ci, n, jcfg, dense_tiles=False, streamed=streamed, **kw)
    assert not g.dense_tiles and not jg.dense_tiles and g.streamed == jg.streamed
    assert not g.block_diag and not jg.block_diag
    assert g.agnn_aggregate is None and jg.agnn_aggregate is None
    assert g.symmetric == jg.symmetric == (kind != "asymmetric")
    return n, g, jg


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("streamed", [None, True], ids=["chunk", "streamed"])
def test_graph_ops_and_grads_match_jax(kind, dtype, streamed):
    """``spmm``, ``spmm_weighted`` and ``sddmm`` with every gradient, through
    ``torch.autograd`` and ``jax.grad``, on the chunk and streamed routes."""
    n, g, jg = chunk_graphs(kind, dtype, streamed=streamed)
    assert g.streamed == bool(streamed)
    e = g.num_edges
    x, w = features(n, 12, 5, dtype), features(e, 1, 6, dtype)[:, 0]
    r1, r2 = features(n, 12, 7, dtype), features(n, 12, 8, dtype)
    re = features(e, 1, 9, dtype)[:, 0]
    jt = DTYPES[dtype][1]

    def jloss(xx, ww):
        return (jnp.sum(jg.spmm(xx).astype(jnp.float32) * r1)
                + jnp.sum(jg.spmm_weighted(xx, ww).astype(jnp.float32) * r2)
                + jnp.sum(jg.sddmm(xx) * re))

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x, jt), jnp.asarray(w))
    xt = torch.from_numpy(x).to(DTYPES[dtype][0]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    outs = g.spmm(xt), g.spmm_weighted(xt, wt), g.sddmm(xt)
    assert all(o.dtype == torch.float32 for o in outs)
    loss = ((outs[0] * torch.from_numpy(r1)).sum() + (outs[1] * torch.from_numpy(r2)).sum()
            + (outs[2] * torch.from_numpy(re)).sum())
    loss.backward()
    tol = F32 if dtype == "f32" else EXACT
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    assert xt.grad.dtype == DTYPES[dtype][0]
    close(xt.grad, want[1][0], tol)
    close(wt.grad, want[1][1], tol)


def test_chunk_route_uploads_only_the_chunks():
    n, g, jg = chunk_graphs("asymmetric")
    assert g.meta is None and g.a_struct is None and g.bd is None
    assert g.host_meta is None and g.host_meta_t is None
    assert g.chunks is not g.chunks_t and g.chunks.num_segments == 1
    assert (g.tc_blocks, g.exp_edges) == (jg.tc_blocks, jg.exp_edges) and g.tc_blocks > 0
    x = torch.from_numpy(features(n, 8, 1)).requires_grad_(True)
    reset_counts()
    g.sddmm(x).sum().backward()
    assert sddmm_tc.plain_calls == 1 and spmm_tc.plain_calls == 2
    assert sddmm_tc_dense.plain_calls == 0 and spmm_tc_dense.plain_calls == 0
    _, gs, _ = chunk_graphs("symmetric")
    assert gs.chunks is gs.chunks_t


def test_dense_tiles_argument():
    n, rp, ci = edges("symmetric")
    cfg, _ = configs()
    with pytest.raises(ValueError, match="requires dense_tiles=False"):
        TiledGraph(rp, ci, n, cfg, device="cpu", dense_tiles=True, streamed=True)
    g = TiledGraph(rp, ci, n, cfg, device="cpu", dense_tiles=True, block_diag=False)
    assert g.dense_tiles and not g.streamed and g.a_struct is not None


@pytest.mark.parametrize("weighted_traffic", [False, True])
def test_auto_routing_matches_jax(monkeypatch, weighted_traffic):
    """With the budget and the stream limits monkeypatched down in both
    packages, a small graph takes the chunk route and then the streamed
    route, identically, with equal op outputs."""
    n, rp, ci = edges("asymmetric")
    cfg, jcfg = configs()
    x = features(n, 10, 1)

    def build():
        g = TiledGraph(rp, ci, n, cfg, device="cpu", weighted_traffic=weighted_traffic,
                       block_diag=False)
        jg = JaxTiledGraph(rp, ci, n, jcfg, weighted_traffic=weighted_traffic,
                           block_diag=False)
        route = (g.dense_tiles, g.streamed, g.block_diag)
        assert route == (jg.dense_tiles, jg.streamed, jg.block_diag)
        close(g.spmm(torch.from_numpy(x)), jg.spmm(jnp.asarray(x)))
        close(g.sddmm(torch.from_numpy(x)), jg.sddmm(jnp.asarray(x)))
        return route

    assert build() == (True, False, False)
    for mod in (port_graph, jax_graph):
        monkeypatch.setattr(mod, "DENSE_TILE_BUDGET_BYTES", 1024)
    assert build() == (False, False, False)
    for mod in (port_stream, jax_stream):
        monkeypatch.setattr(mod, "MAX_PREFETCH_CHUNKS", 8)
        monkeypatch.setattr(mod, "MAX_SLAB_ROWS", 128)
    assert build() == (False, True, False)


def trainer_setup(kind, dim, streamed, seed=4):
    n, rp, ci = edges("asymmetric", seed=seed + 3)
    cfg, jcfg = configs("16x8")
    g = TiledGraph(rp, ci, n, cfg, device="cpu", dense_tiles=False, streamed=streamed,
                   weighted_traffic=kind == "agnn")
    jg = JaxTiledGraph(rp, ci, n, jcfg, dense_tiles=False, streamed=streamed,
                       weighted_traffic=kind == "agnn")
    assert g.streamed == jg.streamed == bool(streamed)
    rng = np.random.default_rng(seed)
    scale = 0.3 if kind == "agnn" else 1.0
    x = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    return n, g, jg, x, y


@pytest.mark.parametrize("kind,hoist", [("gcn", False), ("gcn", True), ("gin", False),
                                        ("gin", True), ("agnn", True)])
@pytest.mark.parametrize("streamed", [False, True], ids=["chunk", "streamed"])
def test_adam_trajectory_matches_jax(kind, hoist, streamed):
    """20 Adam steps on the chunk and streamed routes, loss by loss (GCN and
    GIN as ``test_torch_train.py``, a 2-layer AGNN as
    ``test_torch_agnn.py``)."""
    dim = 24
    n, g, jg, x, y = trainer_setup(kind, dim, streamed)
    params = jax_nets.init_net(jax.random.PRNGKey(4), kind, dim, 16, 4, 2,
                               **({} if kind == "agnn" else {"init": "uniform"}))
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jg, kind, jnp.asarray(x), jnp.asarray(y), opt,
                                dropout_rate=0.0, hoist=hoist)
    net = GNN(kind, [dim, 16, 4], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    state, key, want = opt.init(params), jax.random.PRNGKey(0), []
    for _ in range(20):
        params, state, key, loss = jstep(params, state, key)
        want.append(float(loss))
    step = port_train.make_train_step(
        g, net, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.0, hoist=hoist,
    )
    got = [float(step()) for _ in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_cli_over_budget_takes_the_chunk_route(monkeypatch, capsys, model):
    monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", 1024)
    r = port_train.main([
        "--dataset", "rand_300_1500", "--dim", "8", "--classes", "3", "--epochs", "2",
        "--blk_h", "16", "--blk_w", "8", "--edge_chunk", "32", "--device", "cpu",
        "--model", model, "--hidden", "8",
    ])
    out = capsys.readouterr().out
    assert "Route:\tdense_tiles=False streamed=False block_diag=False" in out
    assert r["dense_tiles"] is False and r["streamed"] is False and r["block_diag"] is False
    assert np.isfinite(r["final_loss"]) and r["tc_blocks"] > 0


def test_chunk_route_imports_no_jax():
    """In a fresh process, the chunk and streamed routes of the port's CLI
    load neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "from tcgnn_tpu_torch import graph, train\n"
        "from tcgnn_tpu_torch.sgt import stream\n"
        "graph.DENSE_TILE_BUDGET_BYTES = 1024\n"
        "r = train.main(['--dataset', 'rand_2000_8000', '--dim', '6', '--classes', '3',"
        " '--epochs', '2', '--blk_h', '16', '--blk_w', '8', '--edge_chunk', '32',"
        " '--device', 'cpu', '--model', 'agnn'])\n"
        "assert not r['dense_tiles'] and not r['streamed'], r\n"
        "stream.MAX_PREFETCH_CHUNKS = 64\n"
        "r = train.main(['--dataset', 'rand_2000_8000', '--dim', '6', '--classes', '3',"
        " '--epochs', '2', '--blk_h', '16', '--blk_w', '8', '--edge_chunk', '32',"
        " '--device', 'cpu'])\n"
        "assert not r['dense_tiles'] and r['streamed'], r\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tcgnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
