"""The port's block-diagonal (BD) route of ``TiledGraph`` against the JAX package.

Both packages build their ``TiledGraph`` with the default routing
(``block_diag=None``), so each picks its route by its own rules; they must
agree on every test graph: BD or not, the offsets, full coverage, and
whether the score-fused AGNN aggregate exists.  Then the ops (``spmm``
forward and backward, ``spmm_weighted`` and ``sddmm`` with their
gradients, ``agnn_aggregate`` with the attention gradient), GCN, GIN and
AGNN forwards and gradients through ``params_from_jax``, and a 20-step Adam
trajectory must agree, the JAX side running its Pallas kernels in
interpret mode.

Tolerances: f32 ``rtol=atol=1e-5`` (the two sides differ in the order of
f32 sums); the Adam trajectory ``rtol=1e-4`` (Adam's division by the root
of the second moment magnifies last-bit differences of the gradients, as
in ``test_torch_train.py``).  bf16 ``rtol=atol=1e-5`` too, on inputs on a
grid of 1/64 where every f32 sum is exact, so both sides round the same
values at the same points.
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
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, agnn_conv
from tcgnn_tpu_torch.ops import (
    bd_sfused,
    bd_sfused_bwd,
    reset_counts,
    sddmm_tc_dense,
    spmm_block_diag,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_tc_dense,
)
from tcgnn_tpu_torch.sgt.translate import count_blocks

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
GEOMETRY = (128, 128)


def edges(kind):
    """(n, row_pointers, column_index) of the test graphs."""
    rng = np.random.default_rng(7)
    if kind == "powerlaw":  # below the coverage gate
        n = 2000
        src, dst = powerlaw_graph(n, 8000, seed=3)
    elif kind == "one_signed":  # strictly upper triangular: offsets {+1, +2}
        n = 1024
        src = rng.integers(0, n - 256, 3000)
        dst = src + rng.integers(128, 256, 3000)
    elif kind == "asymmetric_banded":  # directed band plus random edges: a residual
        n = 1500
        src_b = rng.integers(0, n, 4000)
        dst_b = np.clip(src_b + rng.integers(-100, 101, 4000), 0, n - 1)
        src = np.concatenate([src_b, rng.integers(0, n, 400)])
        dst = np.concatenate([dst_b, rng.integers(0, n, 400)])
    else:
        n = {"full": 1500, "residual": 1600, "int16": 700, "far_offsets": 2560}[kind]
        src, dst = component_union_graph(n, 2 * n + 200, n // 25, seed=2)
        if kind == "residual":  # 3% random long-range edges, both directions
            e, far = rng.integers(0, n, (2, int(0.03 * len(src))))
            src, dst = np.concatenate([src, e, far]), np.concatenate([dst, far, e])
        elif kind == "int16":  # one cell counted 200 times, both directions
            src = np.concatenate([src, np.full(200, 5), np.full(200, 6)])
            dst = np.concatenate([dst, np.full(200, 6), np.full(200, 5)])
        elif kind == "far_offsets":  # offsets +-9: past the fused kernels' halo
            e = rng.integers(0, n - 9 * 128, 300)
            src = np.concatenate([src, e, e + 9 * 128])
            dst = np.concatenate([dst, e + 9 * 128, e])
    rp, ci = coo_to_csr(src, dst, n)
    return n, rp, ci


BD_KINDS = ["full", "residual", "one_signed", "asymmetric_banded", "int16"]


def graphs(kind, dtype="f32", weighted_traffic=False):
    n, rp, ci = edges(kind)
    pt, jt = DTYPES[dtype]
    g = TiledGraph(rp, ci, n, TileConfig(*GEOMETRY, compute_dtype=pt), device="cpu",
                   weighted_traffic=weighted_traffic)
    jg = JaxTiledGraph(rp, ci, n, JaxTileConfig(*GEOMETRY, compute_dtype=jt),
                       weighted_traffic=weighted_traffic)
    return n, rp, ci, g, jg


def features(n, d, seed, dtype="f32"):
    """Normal features scaled by 0.3; for bf16, on the grid of 1/64 in
    [-1/2, 1/2], where the sums here are exact in f32."""
    x = (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)
    if dtype == "bf16":
        x = np.clip(np.round(x * 64), -32, 32).astype(np.float32) / 64
    return x


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()),
                               np.asarray(jnp.asarray(want, jnp.float32)), **(tol or TOL))


@pytest.mark.parametrize("kind", BD_KINDS + ["powerlaw", "far_offsets"])
@pytest.mark.parametrize("weighted_traffic", [False, True])
def test_route_matches_jax(kind, weighted_traffic):
    _, _, _, g, jg = graphs(kind, weighted_traffic=weighted_traffic)
    assert g.block_diag == jg.block_diag == (kind != "powerlaw")
    assert g.symmetric == jg.symmetric
    assert (g.agnn_aggregate is None) == (jg.agnn_aggregate is None)
    assert (g.tc_blocks, g.exp_edges) == (jg.tc_blocks, jg.exp_edges)
    if g.block_diag:
        assert (g.bd_offsets, g.bd_offsets_t) == (jg._bd_offsets, jg._bd_offsets_t)
        assert g.bd_full_coverage == jg._bd_full_coverage
        assert g.bd_addressable == jg._bd_addressable
        # A fully covered BD graph uploads no condensed tiles, in both.
        _, _, a_struct, *_ = jg._device_arrays
        assert (g.a_struct is None) == (a_struct is None) == g.bd_full_coverage
    if kind == "far_offsets":  # full coverage past the halo: the per-edge route
        assert g.bd_full_coverage and g.agnn_aggregate is None


def test_weighted_traffic_probes_the_bd_route(monkeypatch):
    """Attention on an asymmetric graph over the dense-tile budget with
    condensed weighted tiles, but under it with BD weighted packs: both
    packages keep the dense tiles and take the BD route."""
    n, rp, ci = edges("asymmetric_banded")
    cfg = TileConfig()  # 512x128: condensed tiles larger than the BD packs
    t_rp, t_ci = port_graph.transpose_csr(rp, ci, n)[:2]
    nb_f, nb_t = count_blocks(rp, ci, n, cfg), count_blocks(t_rp, t_ci, n, cfg)
    dense = (nb_f + nb_t) * 512 * 128
    cond_extra = 4 * nb_f * 512 * 128 * 4
    bd_extra = 3 * 3 * 12 * 128 * 128 * 4  # 3 packs of K=3 offsets, 12 bins, f32
    assert bd_extra < cond_extra
    budget = dense + bd_extra
    monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", budget)
    monkeypatch.setattr(jax_graph, "DENSE_TILE_BUDGET_BYTES", budget)
    g = TiledGraph(rp, ci, n, cfg, device="cpu", weighted_traffic=True)
    jg = JaxTiledGraph(rp, ci, n, JaxTileConfig(), weighted_traffic=True)
    assert g.block_diag and jg.block_diag and jg.dense_tiles and g.dense_tiles
    # Without the BD route the condensed weighted tiles do not fit: both
    # packages take the chunk route, with the same ops.
    g = TiledGraph(rp, ci, n, cfg, device="cpu", weighted_traffic=True, block_diag=False)
    jg = JaxTiledGraph(rp, ci, n, JaxTileConfig(), weighted_traffic=True, block_diag=False)
    assert not g.dense_tiles and not jg.dense_tiles and not g.block_diag and not jg.block_diag
    x = features(n, 8, 23)
    close(g.spmm(torch.from_numpy(x)), jg.spmm(jnp.asarray(x)))
    close(g.sddmm(torch.from_numpy(x)), jg.sddmm(jnp.asarray(x)))


def test_block_diag_argument():
    n, rp, ci = edges("powerlaw")
    with pytest.raises(ValueError, match="below the gate"):
        TiledGraph(rp, ci, n, TileConfig(*GEOMETRY), device="cpu", block_diag=True)
    n, rp, ci = edges("full")
    g = TiledGraph(rp, ci, n, TileConfig(*GEOMETRY), device="cpu", block_diag=False)
    assert not g.block_diag and g.a_struct is not None and g.agnn_aggregate is not None


@pytest.mark.parametrize("kind", BD_KINDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmm_and_grad_match_jax(kind, dtype):
    n, rp, ci, g, jg = graphs(kind, dtype)
    x, dy = features(n, 12, 1, dtype), features(n, 12, 2, dtype)
    want, vjp = jax.vjp(jg.spmm, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy, want.dtype))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = g.spmm(xt)
    out.backward(torch.from_numpy(dy).to(out.dtype))
    assert out.dtype == DTYPES[dtype][0]
    close(out, want)
    close(xt.grad, want_dx)


@pytest.mark.parametrize("kind", BD_KINDS)
def test_spmm_weighted_and_sddmm_grads_match_jax(kind):
    n, rp, ci, g, jg = graphs(kind, weighted_traffic=True)
    e = len(ci)
    x = features(n, 10, 5)
    w = np.random.default_rng(6).standard_normal(e).astype(np.float32)
    r = np.random.default_rng(7).standard_normal((n, 10)).astype(np.float32)
    re = np.random.default_rng(8).standard_normal(e).astype(np.float32)

    def jloss(xx, ww):
        return jnp.sum(jg.spmm_weighted(xx, ww) * r) + jnp.sum(jg.sddmm(xx) * re)

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = (g.spmm_weighted(xt, wt) * torch.from_numpy(r)).sum() + (
        g.sddmm(xt) * torch.from_numpy(re)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    close(xt.grad, want[1][0])
    close(wt.grad, want[1][1])


@pytest.mark.parametrize("kind", ["full", "residual", "int16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_agnn_aggregate_and_grads_match_jax(kind, dtype):
    n, rp, ci, g, jg = graphs(kind, dtype, weighted_traffic=True)
    assert g.agnn_aggregate is not None and jg.agnn_aggregate is not None
    x = features(n, 8, 9, dtype) * (0.25 if kind == "int16" else 1.0)
    att = np.asarray([[0.75, -0.25, 0.5]], np.float32)
    r = features(n, 8, 10, dtype)

    def jloss(xx, aa):
        out = jg.agnn_aggregate(xx, aa)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(att))
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(att).requires_grad_(True)
    out = g.agnn_aggregate(xt, at)
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert str(out.dtype) == "torch." + jnp.dtype(want.dtype).name
    close(out, want)
    close(xt.grad, want_g[0])
    close(at.grad, want_g[1])


def test_bd_ops_route_through_the_bd_kernels():
    """A BD graph with a residual runs K5 and K1, K4 over every edge, and
    K6/K7 with K2/K3; a fully covered one K5 alone and no condensed tile."""
    n, _, _, g, _ = graphs("residual")
    x = torch.from_numpy(features(n, 6, 11)).requires_grad_(True)
    reset_counts()
    g.spmm(x).sum().backward()
    assert (spmm_block_diag.plain_calls, spmm_tc_dense.plain_calls) == (2, 2)
    reset_counts()
    g.agnn_aggregate(x, torch.ones(1, 1)).sum().backward()
    assert (bd_sfused.plain_calls, bd_sfused_bwd.plain_calls) == (1, 1)
    assert (spmm_sfused.plain_calls, spmm_sfused_bwd.plain_calls) == (1, 1)
    reset_counts()
    g.sddmm(x).sum().backward()
    assert sddmm_tc_dense.plain_calls == 1 and spmm_block_diag.plain_calls == 2
    n, _, _, g, _ = graphs("full")
    reset_counts()
    g.spmm(torch.from_numpy(features(n, 6, 12)))
    assert (spmm_block_diag.plain_calls, spmm_tc_dense.plain_calls) == (1, 0)
    assert g.meta is None and g.a_struct is None


def jax_params(kind, dims, seed):
    """JAX parameters of a 2-layer net; GCN and GIN drawn uniform, so that
    the logits stay of order one."""
    init = {} if kind == "agnn" else {"init": "uniform"}
    return jax_nets.init_net(jax.random.PRNGKey(seed), kind, dims[0], dims[1], dims[-1],
                             len(dims) - 1, **init)


@pytest.mark.parametrize("model", ["gcn", "gin", "agnn"])
@pytest.mark.parametrize("kind", ["residual", "asymmetric_banded"])
@pytest.mark.parametrize("dim", [8, 24])  # GCN layer 1: aggregate first / project first
def test_model_logits_and_grads_match_jax(model, kind, dim):
    n, rp, ci, g, jg = graphs(kind, weighted_traffic=model == "agnn")
    dims = [dim, 16, 4]
    params = jax_params(model, dims, 3)
    x = features(n, dim, 13)
    y = np.random.default_rng(14).integers(0, 4, n).astype(np.int32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss_fn(p):
        logp = jax_nets.apply_net(p, model, xj, jg)
        return -jnp.mean(jnp.take_along_axis(logp, yj[:, None], axis=1)), logp

    (want_loss, want_logp), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    net = GNN(model, dims)
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    logp = net(torch.from_numpy(x), g)
    loss = F.nll_loss(logp, torch.from_numpy(y).long())
    loss.backward()
    close(logp, want_logp)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for i, wg in enumerate(want_grads):
        close(net.weights[i].grad, wg["weights"])
        if model == "agnn":
            close(net.attention_w[i].grad, wg["attention_w"])


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_adam_trajectory_matches_jax(model):
    """20 Adam steps on the BD graph with a residual, loss by loss."""
    n, rp, ci, g, jg = graphs("residual", weighted_traffic=model == "agnn")
    dims = [24, 16, 4]
    x = features(n, 24, 15)
    y = np.random.default_rng(16).integers(0, 4, n).astype(np.int32)
    opt = optax.adam(0.01)
    params = jax_params(model, dims, 4)
    jstep = jax_make_train_step(jg, model, jnp.asarray(x), jnp.asarray(y), opt,
                                dropout_rate=0.0, hoist=True)
    net = GNN(model, dims)
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    state, key, want = opt.init(params), jax.random.PRNGKey(0), []
    for _ in range(20):
        params, state, key, loss = jstep(params, state, key)
        want.append(float(loss))
    step = port_train.make_train_step(
        g, net, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.0, hoist=True,
    )
    got = [float(step()) for _ in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_agnn_conv_on_a_bd_graph_matches_jax():
    """One AGNN layer, two heads, on the fully covered graph (K6/K7 alone)."""
    n, rp, ci, g, jg = graphs("full", weighted_traffic=True)
    params = jax_layers.init_agnn(jax.random.PRNGKey(5), 12, 8, n_heads=2)
    x = features(n, 12, 17)
    want = jax_layers.agnn_conv(params, jnp.asarray(x), jg)
    got = agnn_conv(torch.tensor(np.asarray(params["weights"])),
                    torch.tensor(np.asarray(params["attention_w"])), torch.from_numpy(x), g)
    close(got, want)
