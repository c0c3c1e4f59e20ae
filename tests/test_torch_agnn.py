"""AGNN in the port (layers, graph ops, model, trainer) against the JAX package.

Identical parameters (JAX's ``init_agnn`` / ``init_net``, loaded into the
port), the same numpy features (scaled by 0.3, so that 2-3 layers of
unnormalised attention stay finite), dropout off.  Both graphs are built on
the condensed dense-tile route (JAX: ``dense_tiles=True,
block_diag=False``), so a symmetric graph takes the score-fused ops (K2/K3)
in both packages and a directed one the per-edge route (K4 + weighted K1).

Tolerances: f32 outputs and gradients ``rtol=atol=1e-5`` on values of order
one (the two sides differ in the order of f32 sums); bf16 ``2e-2`` of the
largest magnitude (one bf16 rounding of stored activations, 8 mantissa
bits, where the two frameworks' dense products may round differently); the
20-step Adam loss trajectory ``rtol=1e-4`` in f32 as in
``test_torch_train.py`` (Adam's division by the root of the second moment
magnifies last-bit differences of the gradients), and ``rtol=4e-3``, one
bf16 rounding step (2**-8), in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tcgnn_tpu import graph as jax_graph
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.models import layers as jax_layers
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.train import make_train_step as jax_make_train_step
from tcgnn_tpu_torch import graph as port_graph
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, agnn_conv, hoist_l1_aggregate, init_agnn, init_net
from tcgnn_tpu_torch.ops import reset_counts, sddmm_tc_dense, spmm_sfused, spmm_sfused_bwd

F32 = dict(rtol=1e-5, atol=1e-5)
N, CLASSES, HIDDEN = 150, 4, 16
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def edges(symmetric, seed=3):
    src, dst = powerlaw_graph(N, 800, seed=seed)
    if not symmetric:
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    return coo_to_csr(src, dst, N)


def graphs(symmetric, dtype="f32", geometry=(16, 16)):
    rp, ci = edges(symmetric)
    pt, jt = DTYPES[dtype]
    bh, bw = geometry
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=pt), device="cpu",
                   weighted_traffic=True, block_diag=False)
    jg = JaxTiledGraph(rp, ci, N, JaxTileConfig(blk_h=bh, blk_w=bw, compute_dtype=jt),
                       dense_tiles=True, block_diag=False, weighted_traffic=True)
    assert g.symmetric == jg.symmetric == symmetric
    assert (g.agnn_aggregate is None) == (jg.agnn_aggregate is None) == (not symmetric)
    return g, jg


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


def bf16_close(got, want):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


@pytest.mark.parametrize("symmetric", [True, False], ids=["fused", "per_edge"])
@pytest.mark.parametrize("n_heads", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_agnn_conv_and_grads_match_jax(symmetric, n_heads, dtype):
    g, jg = graphs(symmetric, dtype)
    d_in, d_out = 12, 8
    params = jax_layers.init_agnn(jax.random.PRNGKey(n_heads), d_in, d_out, n_heads=n_heads)
    x = features(N, d_in, 1)
    r = np.random.default_rng(2).standard_normal((N, d_out)).astype(np.float32)

    def loss(p, xx):
        out = jax_layers.agnn_conv(p, xx, jg)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, want_out), (want_gp, want_gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    w = torch.tensor(np.asarray(params["weights"]), requires_grad=True)
    att = torch.tensor(np.asarray(params["attention_w"]), requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = agnn_conv(w, att, xt, g)
    (out.float() * torch.from_numpy(r)).sum().backward()

    pairs = [(out.detach(), want_out), (w.grad, want_gp["weights"]),
             (att.grad, want_gp["attention_w"]), (xt.grad, want_gx)]
    for got, want in pairs:
        got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
        assert got.shape == want.shape
        if dtype == "f32":
            np.testing.assert_allclose(got, want, **F32)
        else:
            bf16_close(got, want)
    assert out.dtype == (torch.float32 if symmetric else DTYPES[dtype][0])


@pytest.mark.parametrize("symmetric", [True, False], ids=["fused", "per_edge"])
def test_agnn_conv_routes_through_the_expected_kernels(symmetric):
    g, _ = graphs(symmetric)
    w = torch.from_numpy(features(12, 8, 3))
    att = torch.full((1, 2), 0.5)
    x = torch.from_numpy(features(N, 12, 4)).requires_grad_(True)
    reset_counts()
    agnn_conv(w, att, x, g).sum().backward()
    fused = (spmm_sfused.plain_calls, spmm_sfused_bwd.plain_calls)
    assert fused == ((1, 1) if symmetric else (0, 0))
    # per edge: the scores once forward, dw of each head's weighted SpMM
    assert sddmm_tc_dense.plain_calls == (0 if symmetric else 3)


def test_weighted_spmm_and_sddmm_grads_match_jax():
    """The two per-edge ops on a directed graph, forward and backward."""
    g, jg = graphs(False)
    x = features(N, 10, 5)
    w = np.random.default_rng(6).standard_normal(g.num_edges).astype(np.float32)
    r = np.random.default_rng(7).standard_normal((N, 10)).astype(np.float32)
    re = np.random.default_rng(8).standard_normal(g.num_edges).astype(np.float32)

    def jloss(xx, ww):
        return jnp.sum(jg.spmm_weighted(xx, ww) * r) + jnp.sum(jg.sddmm(xx) * re)

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = (g.spmm_weighted(xt, wt) * torch.from_numpy(r)).sum() + (
        g.sddmm(xt) * torch.from_numpy(re)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1][0]), **F32)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1][1]), **F32)


def test_agnn_aggregate_grads_match_jax():
    """The fused aggregate's own backward, ``datt`` included."""
    g, jg = graphs(True)
    x = features(N, 8, 9)
    att = np.asarray([[0.7, -0.2, 0.4]], np.float32)
    r = np.random.default_rng(10).standard_normal((N, 8)).astype(np.float32)
    want = jax.grad(lambda xx, aa: jnp.sum(jg.agnn_aggregate(xx, aa) * r), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(att))
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    (g.agnn_aggregate(xt, at) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), **F32)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want[1]), **F32)
    assert np.all(at.grad.numpy() == at.grad.numpy()[0, 0])  # one gradient, H heads


@pytest.mark.parametrize("symmetric", [True, False], ids=["fused", "per_edge"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adam_trajectory_matches_jax(symmetric, dtype):
    """20 Adam steps of a 2-layer AGNN, loss by loss."""
    g, jg = graphs(symmetric, dtype)
    dim = 24
    x = features(N, dim, 11)
    y = np.random.default_rng(12).integers(0, CLASSES, N).astype(np.int32)
    params = jax_nets.init_net(jax.random.PRNGKey(4), "agnn", dim, HIDDEN, CLASSES, 2)
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jg, "agnn", jnp.asarray(x), jnp.asarray(y), opt,
                                dropout_rate=0.0, hoist=True)
    state, key, want = opt.init(params), jax.random.PRNGKey(0), []
    for _ in range(20):
        params_next, state, key, loss = jstep(params, state, key)
        params = params_next
        want.append(float(loss))

    net = GNN("agnn", [dim, HIDDEN, CLASSES])
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in
                         jax_nets.init_net(jax.random.PRNGKey(4), "agnn", dim, HIDDEN, CLASSES, 2)])
    step = port_train.make_train_step(
        g, net, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.0, hoist=True,
    )
    got = [float(step()) for _ in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "f32" else 4e-3)
    assert got[-1] < got[0]


def test_forward_matches_jax_apply_net_with_two_heads():
    g, jg = graphs(True)
    params = jax_nets.init_net(jax.random.PRNGKey(5), "agnn", 12, HIDDEN, CLASSES, 3, n_heads=2)
    x = features(N, 12, 13)
    want = jax_nets.apply_net(params, "agnn", jnp.asarray(x), jg)
    net = GNN("agnn", [12, HIDDEN, HIDDEN, CLASSES], n_heads=2)
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    got = net(torch.from_numpy(x), g)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    loss = F.nll_loss(got, torch.zeros(N, dtype=torch.long))
    assert torch.isfinite(loss)


def test_init_agnn_and_init_net_are_seeded_uniform():
    p = init_agnn(torch.Generator().manual_seed(0), 10, 16, n_heads=3)
    assert p["weights"].shape == (10, 16) and p["attention_w"].shape == (1, 3)
    for t in p.values():
        assert float(t.abs().max()) <= 0.25 and float(t.std()) > 0
    a = init_net(torch.Generator().manual_seed(1), "agnn", 10, 8, 3, 3, n_heads=2)
    b = init_net(torch.Generator().manual_seed(1), "agnn", 10, 8, 3, 3, n_heads=2)
    assert [tuple(w.shape) for w in a.weights] == [(10, 8), (8, 8), (8, 3)]
    assert [tuple(t.shape) for t in a.attention_w] == [(1, 2)] * 3
    for ta, tb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(ta, tb)
    assert len(init_net(torch.Generator(), "gcn", 10, 8, 3, 2).attention_w) == 0


def test_hoist_l1_aggregate_is_none_for_agnn():
    g, _ = graphs(True)
    x = torch.from_numpy(features(N, 6, 14))
    assert hoist_l1_aggregate("agnn", x, g) is None
    assert hoist_l1_aggregate("gcn", x, g) is not None


def test_weighted_traffic_counts_in_the_budget(monkeypatch):
    """Attention on an asymmetric graph budgets 4 weighted tile arrays: under
    a budget the structural tiles fit but the weighted ones do not, both
    packages keep the dense tiles for GCN traffic and take the chunk route
    (no BD route) for attention, with the same ops; a symmetric graph needs
    no weighted tiles."""
    rp, ci = edges(False)
    cfg, jcfg = TileConfig(blk_h=16, blk_w=16), JaxTileConfig(blk_h=16, blk_w=16)
    g = TiledGraph(rp, ci, N, cfg, device="cpu", block_diag=False)
    struct_bytes = (g.host_meta.num_blocks + g.host_meta_t.num_blocks) * 256
    monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", struct_bytes)
    monkeypatch.setattr(jax_graph, "DENSE_TILE_BUDGET_BYTES", struct_bytes)
    assert TiledGraph(rp, ci, N, cfg, device="cpu", block_diag=False).dense_tiles
    g = TiledGraph(rp, ci, N, cfg, device="cpu", weighted_traffic=True, block_diag=False)
    jg = JaxTiledGraph(rp, ci, N, jcfg, weighted_traffic=True, block_diag=False)
    assert not g.dense_tiles and not jg.dense_tiles
    assert not g.block_diag and not jg.block_diag
    x = features(N, 6, 21)
    w = np.random.default_rng(22).standard_normal(g.num_edges).astype(np.float32)
    np.testing.assert_allclose(g.spmm_weighted(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jg.spmm_weighted(jnp.asarray(x), jnp.asarray(w))),
                               **F32)
    np.testing.assert_allclose(g.sddmm(torch.from_numpy(x)).numpy(),
                               np.asarray(jg.sddmm(jnp.asarray(x))), **F32)
    rs, cs = edges(True)
    monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", 1 << 30)
    assert TiledGraph(rs, cs, N, cfg, device="cpu", weighted_traffic=True,
                      block_diag=False).dense_tiles
