"""The port's distributed block-diagonal route against ``tcgnn_tpu.parallel``.

The same CSR and the same numpy inputs go through the JAX
``DistributedTiledGraph`` (8 virtual CPU devices) and the port's (every
shard on the CPU, the kernels' plain versions), on 8x1 meshes (the fused
AGNN is K6/K7 over each shard's ext pack) and 4x2 ones (one score a pack
cell from K4's partial dots summed over ``feature``, then K5): ``spmm``,
``spmm_weighted``, ``sddmm`` and ``agnn_aggregate``, forward and every
gradient.  Graphs, all fully covered by 128-row diagonals: a symmetric
component union (the JAX fixture), a directed banded graph (its transpose
pack differs from its forward one), a directed graph with one-signed
offsets (rims of one side), and a symmetric union with duplicate edges
(pack counts of 2 and more).

Also: the gate (misaligned bins and a power-law graph take the dense route
in both packages), the light partition (no condensed tile built on the
host), ``build_bd_shard_meta`` bit for bit against JAX's, and the trainer on
a mesh.

Tolerances, as ``tests/test_torch_parallel.py`` states them: f32
``rtol=atol=1e-4`` forward, ``1e-3`` for gradients.  bf16 ``2e-2``: at one
feature shard K7 rounds ``T + U`` once, where JAX's mesh route rounds ``C ⊙
T`` and forms the transpose term from it; at two, the port's transpose term
rounds ``U_ij = <x_i, dy_j>``, JAX's ``T_ji``, the same dot summed in another
order.  A last-bit difference there may round to the next bf16 value.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.dataset import coo_to_csr as jax_coo_to_csr
from tcgnn_tpu.data.synthetic import component_union_graph as jax_union
from tcgnn_tpu.data.synthetic import powerlaw_graph as jax_powerlaw_graph
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu.parallel import partition as jax_part
from tcgnn_tpu.parallel.blockdiag import build_bd_shard_meta as jax_build_bd_shard_meta
from tcgnn_tpu.sgt.blockdiag import extract_block_diag as jax_extract_block_diag
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import (
    bd_sfused,
    bd_sfused_bwd,
    reset_counts,
    sddmm_tc_dense,
    spmm_block_diag,
)
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    make_mesh,
)
from tcgnn_tpu_torch.parallel import graph as port_graph
from tcgnn_tpu_torch.parallel import partition as port_part
from tcgnn_tpu_torch.parallel.blockdiag import build_bd_shard_meta
from tcgnn_tpu_torch.sgt.blockdiag import extract_block_diag
from tcgnn_tpu_torch.sgt.translate import transpose_csr
from test_torch_parallel import ALL_OPS, BF16, FWD, GRAD, _jax_ops, _port_ops

# blk_h=128 keeps rows_per_shard a multiple of the 128-row bins.
CFG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)
JCFG = JaxTileConfig(blk_h=128, blk_w=128, edge_chunk=64)
N, D = 2048, 16


def union_csr(seed=7, dup=0):
    """The JAX fixture's component union; ``dup`` of its undirected pairs
    added again both ways (pack counts of 2, 3 where a pair repeats)."""
    src, dst = jax_union(N, 5200, 64, seed=seed)
    if dup:
        rng = np.random.default_rng(seed)
        pick = rng.integers(0, len(src), dup)
        src = np.concatenate([src, src[pick], dst[pick]])
        dst = np.concatenate([dst, dst[pick], src[pick]])
    ptr, idx = jax_coo_to_csr(src, dst, N)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


def banded_csr(seed=17, lo=-100, hi=101):
    """A directed banded graph: each source's targets in ``[src + lo, src +
    hi)`` (JAX's ``test_bd_dist_directed_banded_weighted_grads`` graph);
    ``lo=0`` gives the one-signed offsets {0, 1}."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 6000)
    dst = np.clip(src + rng.integers(lo, hi, 6000), 0, N - 1)
    ptr, idx = jax_coo_to_csr(src, dst, N)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


GRAPHS = {
    "union": union_csr,
    "banded directed": banded_csr,
    "one-signed": lambda: banded_csr(seed=5, lo=0, hi=100),
    "duplicates": lambda: union_csr(seed=3, dup=400),
}
CASES = [(name, mesh) for name in GRAPHS for mesh in ((8, 1), (4, 2))]


def both_graphs(name, mesh, cfg=CFG, jcfg=JCFG):
    ptr, idx = GRAPHS[name]()
    jg = JaxDistributedTiledGraph(ptr, idx, N, jax_make_mesh(*mesh), jcfg)
    pg = DistributedTiledGraph(ptr, idx, N, make_mesh(*mesh, "cpu"), cfg)
    assert jg.block_diag and pg.block_diag, name
    return ptr, idx, jg, pg


def inputs(seed, e):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((N, D))).astype(np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    wv = (np.arange(e) % 7 - 3).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    return x, w, wv, att


@pytest.fixture(scope="module", params=CASES, ids=[f"{n} {g}x{f}" for n, (g, f) in CASES])
def case(request):
    name, mesh = request.param
    ptr, idx, jg, pg = both_graphs(name, mesh)
    assert (pg.agnn_aggregate is None) == (jg.agnn_aggregate is None) == (not pg.symmetric)
    x, w, wv, att = inputs(len(name) + mesh[0], len(idx))
    reset_counts()
    port = _port_ops(pg, N, x, w, wv, att)
    counts = {f.__name__: (f.launches + f.plain_calls)
              for f in (spmm_block_diag, bd_sfused, bd_sfused_bwd, sddmm_tc_dense)}
    return dict(name=name, pg=pg, jg=jg, port=port, counts=counts,
                jax=_jax_ops(jg, N, x, w, wv, att))


@pytest.mark.parametrize("op", ALL_OPS)
def test_op_matches_jax(case, op):
    pg = case["pg"]
    if pg.agnn_aggregate is None and op == "agnn_aggregate":
        assert op not in case["port"] and op not in case["jax"]  # asymmetric: no fused AGNN
        return
    got, want = case["port"][op], case["jax"][op]
    if op == "sddmm":  # per-edge vectors, in CSR order
        np.testing.assert_allclose(pg.gather_edge_vector(got[0]),
                                   pg.gather_edge_vector(want[0]), **FWD)
    else:
        np.testing.assert_allclose(got[0][:N], want[0][:N], **FWD)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if g.ndim == 1 and g.shape[0] == pg.padded_edges:
            g, w = pg.gather_edge_vector(g), pg.gather_edge_vector(w)
        elif g.shape[0] == pg.padded_nodes:
            g, w = g[:N], w[:N]
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}", **GRAD)


def test_route_takes_its_kernels(case):
    """K5 on every op; K4 for the SDDMM; the fused AGNN K6/K7 at one
    feature shard, K4 cell scores + K5 at two; the route line names them."""
    pg, c = case["pg"], case["counts"]
    assert c["spmm_block_diag"] > 0 and c["sddmm_tc_dense"] > 0
    assert "block_diag=True" in pg.route and f"mesh={pg.pg}x{pg.pf}" in pg.route
    k67 = c["bd_sfused"] > 0 and c["bd_sfused_bwd"] > 0
    assert k67 == (pg.symmetric and pg.pf == 1)
    if pg.agnn_aggregate is None:
        assert "agnn=none" in pg.route
    else:
        assert ("agnn=K6/K7" if pg.pf == 1 else "agnn=K4 scores + K5") in pg.route
    kmin, kmax = pg._fwd.rim
    assert f"rim=({kmin}, {kmax})" in pg.route
    if case["name"] == "one-signed":
        assert pg._fwd.rim == (0, 1) and pg._bwd.rim == (-1, 0)
    if case["name"] == "duplicates":
        assert max(int(sh.pack.max()) for sh in pg._fwd.shards) >= 2


def test_light_partition_builds_no_condensed_tiles(case):
    """The route uploads packs only: the partition is layout only (JAX's
    ``test_bd_dist_condensed_arrays_skipped``), with JAX's TC_Blocks and
    edge layout."""
    pg, jg = case["pg"], case["jg"]
    assert jg._fwd is None and jg._bwd is None
    for m in (pg.host_fwd, pg.host_bwd):
        assert m.a_tiles is None and m.col_ids is None and m.chunk_r is None
        assert m.halo is None and m.split is None and m.chunk_fwd_slot is None
    assert pg.tc_blocks == jg.tc_blocks and pg.exp_edges == jg.exp_edges
    assert pg.padded_edges == jg.padded_edges and pg.padded_nodes == jg.padded_nodes
    np.testing.assert_array_equal(pg.host_bwd.edge_fwd_slot, jg.host_bwd.edge_fwd_slot)


def test_no_condensed_tile_is_built(monkeypatch):
    """Constructing the route never reaches the tile or chunk passes."""
    def refuse(*a, **k):
        raise AssertionError("a condensed tile pass ran on the BD route")

    monkeypatch.setattr(port_part, "build_a_tiles_host", refuse)
    monkeypatch.setattr(port_part, "sparse_graph_translate", refuse)
    ptr, idx = union_csr()
    pg = DistributedTiledGraph(ptr, idx, N, make_mesh(4, 2, "cpu"), CFG)
    assert pg.block_diag and pg.host_fwd.a_tiles is None


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_bd_shard_meta_matches_jax(name, shards):
    ptr, idx = GRAPHS[name]()
    want_f, want_b = jax_part.partition_graph(ptr, idx, N, shards, JCFG, build_tiles=False)
    got_f, got_b = port_part.partition_graph(ptr, idx, N, shards, CFG, build_tiles=False)
    tp, ti, _ = transpose_csr(ptr, idx, N)
    for (p, i), gm, wm in (((ptr, idx), got_f, want_f), ((tp, ti), got_b, want_b)):
        got = build_bd_shard_meta(extract_block_diag(p, i, N), gm.edge_start, gm.rows_per_shard,
                                  shards, gm.edge_capacity)
        want = jax_build_bd_shard_meta(jax_extract_block_diag(p, i, N), wm.edge_start,
                                       wm.rows_per_shard, shards, wm.edge_capacity)
        assert got.offsets == want.offsets and got.bin_rows == want.bin_rows
        assert got.bins_per_shard == want.bins_per_shard
        for f in ("pack_idx", "pack_cnt", "cov_slot"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, shards, f)


@pytest.mark.parametrize("mesh", [(8, 1), (4, 2)])
def test_agnn_bf16_matches_jax(mesh):
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    _, idx, jg, pg = both_graphs("duplicates", mesh, cfg, jcfg)
    x, w, _, att = inputs(21, len(idx))
    ops = ("agnn_aggregate",)
    got = _port_ops(pg, N, x, w, w, att, ops=ops)["agnn_aggregate"]
    want = _jax_ops(jg, N, x, w, w, att, ops=ops)["agnn_aggregate"]
    np.testing.assert_allclose(got[0][:N], want[0][:N], **BF16)
    np.testing.assert_allclose(got[1][0][:N], want[1][0][:N], **BF16)
    np.testing.assert_allclose(got[1][1], want[1][1], **BF16)


@pytest.mark.parametrize("blk,powerlaw", [(48, False), (128, True)],
                         ids=["misaligned bins", "powerlaw"])
def test_gate_takes_the_dense_route(blk, powerlaw):
    if powerlaw:
        ptr, idx = jax_coo_to_csr(*jax_powerlaw_graph(1024, 6000, seed=2), 1024)
        n = 1024
    else:
        ptr, idx = union_csr(seed=5)
        n = N
    cfg = TileConfig(blk_h=blk, blk_w=blk, edge_chunk=blk)
    jg = JaxDistributedTiledGraph(ptr, idx, n, jax_make_mesh(4, 2),
                                  JaxTileConfig(blk_h=blk, blk_w=blk, edge_chunk=blk))
    pg = DistributedTiledGraph(ptr, idx, n, make_mesh(4, 2, "cpu"), cfg)
    assert not jg.block_diag and not pg.block_diag
    assert "block_diag=False" in pg.route and pg.host_fwd.a_tiles is not None
    with pytest.raises(ValueError, match="not fully covered"):
        DistributedTiledGraph(ptr, idx, n, make_mesh(4, 2, "cpu"), cfg, block_diag=True)


@pytest.mark.parametrize("mesh,model", [("4x2", "gcn"), ("4x2", "agnn"), ("8x1", "agnn")])
def test_cli_mesh_trains_on_the_bd_route(capsys, mesh, model):
    r = port_train.main([
        "--dataset", "rand_400_2000", "--dim", "12", "--classes", "3", "--epochs", "3",
        "--device", "cpu", "--mesh", mesh, "--model", model, "--hidden", "8",
        "--num_layers", "2", "--no_dropout",
    ])
    out = capsys.readouterr().out
    assert "Route:\tdense_tiles=True streamed=False block_diag=True" in out
    assert r["block_diag"] and r["split"] == (False, False) and f"mesh={mesh}" in r["route"]
    assert r["tc_blocks"] > 0 and np.isfinite(r["final_loss"])
    assert r["final_loss"] < r["first_loss"]


def test_dataset_entry_probes_once(monkeypatch):
    """``distributed_graph_from_dataset`` runs the gate once, leaves the
    graph in its order, and the constructor reuses the gate's transpose."""
    calls = []
    probe = port_graph.probe_block_diag
    monkeypatch.setattr(port_graph, "probe_block_diag",
                        lambda *a, **k: calls.append("probe") or probe(*a, **k))
    monkeypatch.setattr(port_part, "transpose_csr",
                        lambda *a, **k: calls.append("transpose") or transpose_csr(*a, **k))
    ptr, idx = union_csr()
    ds = types.SimpleNamespace(row_pointers=ptr, column_index=idx.copy(), num_nodes=N)
    g = distributed_graph_from_dataset(ds, make_mesh(4, 2, "cpu"), CFG)
    assert g.block_diag and calls == ["probe"]
    np.testing.assert_array_equal(ds.column_index, idx)
