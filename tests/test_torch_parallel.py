"""The port's distributed dense-tile route against ``tcgnn_tpu.parallel``.

The same balanced-free CSR and the same numpy inputs go through the JAX
``DistributedTiledGraph`` (8 virtual CPU devices, interpret-mode Pallas)
and the port's (every shard on the CPU, the kernels' plain versions), on
4x2 and 8x1 meshes: ``spmm``, ``spmm_weighted``, ``sddmm`` and
``agnn_aggregate``, forward and every gradient.  The graphs cover the split
stream engaged in both directions (a symmetric mega-window graph), in the
forward only (a directed one), and not at all (a random directed graph, a
symmetric power-law graph); AGNN on the symmetric ones takes K2/K3 at
``pf == 1`` (with K3's window-side overrides on the split stream) and K4
tiles + K10 at ``pf == 2``.  Both packages take the halo-overlap split's
classes on every case (``use_overlap``): the SDDMM always, each direction's
SpMMs where it has no split stream; with ``split=False`` both directions'
SpMMs (the weighted transpose too) take them.  On the cases without a split
stream, K1 and K4 run once a class a shard, the exchange waited between the
local and the remote class.

Tolerances, as the JAX tests use: f32 ``rtol=atol=1e-4`` forward, ``1e-3``
for gradients.  The 4x2 split AGNN also runs in bf16, whose partial score
tiles are rounded per feature shard, summed in f32 and rounded again (the
JAX order): there a score whose last f32 bit the summation order moved may
round to the next bf16 value, so ``rtol=atol=2e-2`` (8 mantissa bits),
forward and gradients (its outputs are f32 sums).  The unsplit SpMM in bf16
stores each class's output in bf16 and adds the two, as JAX does: it
matches JAX at one bf16 rounding step, ``rtol=atol=8e-3``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.dataset import coo_to_csr as jax_coo_to_csr
from tcgnn_tpu.data.synthetic import powerlaw_graph as jax_powerlaw_graph
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import reset_counts, sddmm_tc_tiles, spmm_fused, spmm_sfused_bwd
from tcgnn_tpu_torch.parallel import DistributedTiledGraph, make_mesh

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
JCFG = JaxTileConfig(blk_h=16, blk_w=16, edge_chunk=16)
FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_STEP = dict(rtol=8e-3, atol=8e-3)
D = 16


def random_csr(n, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


def mega_csr(n, seed, symmetric):
    """A sparse graph with one dense row window at the front."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    rows = np.repeat(np.arange(n), [len(c) for c in cols])
    cols = np.concatenate(cols)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        key = np.unique(rows.astype(np.int64) * n + cols)
        rows, cols = key // n, key % n
    ptr, idx = jax_coo_to_csr(rows, cols, n)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


def powerlaw_sym(n, e, seed):
    ptr, idx = jax_coo_to_csr(*jax_powerlaw_graph(n, e, seed=seed), n)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


# name: (n, csr, mesh, the split argument, split engaged (fwd, bwd))
CASES = {
    "mega symmetric 4x2": (400, lambda: mega_csr(400, 11, True), (4, 2), None, (True, True)),
    "mega symmetric 8x1": (400, lambda: mega_csr(400, 11, True), (8, 1), None, (True, True)),
    "mega directed 4x2": (400, lambda: mega_csr(400, 7, False), (4, 2), None, (True, False)),
    "powerlaw symmetric 4x2 unsplit": (160, lambda: powerlaw_sym(160, 1000, 11), (4, 2), False,
                                       (False, False)),
    "powerlaw symmetric 8x1 unsplit": (160, lambda: powerlaw_sym(160, 1000, 11), (8, 1), False,
                                       (False, False)),
    "random directed 4x2": (150, lambda: random_csr(150, 6, seed=3), (4, 2), None,
                            (False, False)),
    "mega directed 4x2 unsplit": (400, lambda: mega_csr(400, 7, False), (4, 2), False,
                                  (False, False)),
    "mega symmetric 8x1 unsplit": (400, lambda: mega_csr(400, 11, True), (8, 1), False,
                                   (False, False)),
}


ALL_OPS = ("spmm", "spmm_weighted", "sddmm", "agnn_aggregate")


def _jax_ops(jg, n, x, w, wv, att, ops=ALL_OPS):
    """Forward values and gradients of every op on the JAX graph."""
    mesh = jg.mesh
    xs = jax.device_put(jnp.pad(jnp.asarray(x), ((0, jg.padded_nodes - n), (0, 0))),
                        NamedSharding(mesh, P("graph", "feature")))
    ws, wvs = jg.edge_weights_to_sharded(w), jg.edge_weights_to_sharded(wv)
    out = {}

    def run(name, fn, *args):
        if name not in ops:
            return
        (value, fwd), grads = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(args))),
                                                          has_aux=True))(*args)
        out[name] = (np.asarray(fwd).astype(np.float32),
                     [np.asarray(g).astype(np.float32) for g in grads])

    run("spmm", lambda xx: (jnp.sum(jnp.sin(jg.spmm(xx)[:n])), jg.spmm(xx)), xs)
    run("spmm_weighted", lambda xx, ww: (jnp.sum(jnp.cos(jg.spmm_weighted(xx, ww)[:n])),
                                         jg.spmm_weighted(xx, ww)), xs, ws)
    run("sddmm", lambda xx: (jnp.sum(jg.sddmm(xx) * wvs), jg.sddmm(xx)), xs)
    if jg.agnn_aggregate is not None:
        run("agnn_aggregate", lambda xx, aa: (jnp.sum(jnp.sin(jg.agnn_aggregate(xx, aa)[:n])),
                                              jg.agnn_aggregate(xx, aa)), xs, jnp.asarray(att))
    return out


def _port_ops(pg, n, x, w, wv, att, ops=ALL_OPS):
    xs = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, pg.padded_nodes - n))
    ws, wvs = pg.edge_weights_to_sharded(w), pg.edge_weights_to_sharded(wv)
    out = {}

    def run(name, fn, *args):
        if name not in ops:
            return
        leaves = [a.clone().requires_grad_(True) for a in args]
        value, fwd = fn(*leaves)
        value.backward()
        out[name] = (fwd.detach().float().numpy(), [t.grad.float().numpy() for t in leaves])

    run("spmm", lambda xx: (torch.sin(pg.spmm(xx)[:n]).sum(), pg.spmm(xx)), xs)
    run("spmm_weighted", lambda xx, ww: (torch.cos(pg.spmm_weighted(xx, ww)[:n]).sum(),
                                         pg.spmm_weighted(xx, ww)), xs, ws)
    run("sddmm", lambda xx: ((pg.sddmm(xx) * wvs).sum(), pg.sddmm(xx)), xs)
    if pg.agnn_aggregate is not None:
        run("agnn_aggregate", lambda xx, aa: (torch.sin(pg.agnn_aggregate(xx, aa)[:n]).sum(),
                                              pg.agnn_aggregate(xx, aa)), xs, torch.tensor(att))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    n, csr, (g, f), split_arg, split = CASES[name]
    ptr, idx = csr()
    jg = JaxDistributedTiledGraph(ptr, idx, n, jax_make_mesh(g, f), JCFG, split=split_arg)
    reset_counts()
    pg = DistributedTiledGraph(ptr, idx, n, make_mesh(g, f, "cpu"), CFG, split=split_arg)
    assert (pg.host_fwd.split is not None, pg.host_bwd.split is not None) == split
    assert (jg.host_fwd.split is not None, jg.host_bwd.split is not None) == split
    assert (pg.agnn_aggregate is None) == (jg.agnn_aggregate is None)
    assert pg.use_overlap == jg._use_overlap and pg.use_overlap
    assert "overlap=True" in pg.route
    rng = np.random.default_rng(len(name))
    x = (0.5 * rng.standard_normal((n, D))).astype(np.float32)
    w = rng.standard_normal(len(idx)).astype(np.float32)
    wv = (np.arange(len(idx)) % 7 - 3).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    port = _port_ops(pg, n, x, w, wv, att)
    return dict(name=name, n=n, pg=pg, x=x, jax=_jax_ops(jg, n, x, w, wv, att), port=port,
                counts=(spmm_fused.plain_calls, sddmm_tc_tiles.plain_calls,
                        spmm_sfused_bwd.plain_calls))


@pytest.mark.parametrize("op", ["spmm", "spmm_weighted", "sddmm", "agnn_aggregate"])
def test_op_matches_jax(case, op):
    if op == "agnn_aggregate" and "directed" in case["name"]:
        assert op not in case["port"] and op not in case["jax"]  # asymmetric: no fused AGNN
        return
    pg, n = case["pg"], case["n"]
    got, want = case["port"][op], case["jax"][op]
    if op == "sddmm":  # per-edge vectors, in CSR order
        np.testing.assert_allclose(pg.gather_edge_vector(got[0]),
                                   pg.gather_edge_vector(want[0]), **FWD)
    else:
        np.testing.assert_allclose(got[0][:n], want[0][:n], **FWD)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if g.ndim == 1 and g.shape[0] == pg.padded_edges:
            g, w = pg.gather_edge_vector(g), pg.gather_edge_vector(w)
        elif g.shape[0] == pg.padded_nodes:
            g, w = g[:n], w[:n]
        np.testing.assert_allclose(g, w, err_msg=f"gradient {i}", **GRAD)


def test_agnn_takes_the_kernels_of_its_mesh(case):
    """pf == 2: K4's tile mode and K10; pf == 1: K2/K3 (K3 with window-side
    overrides on the split stream)."""
    pg = case["pg"]
    fused, tiles, sfused_bwd = case["counts"]
    if pg.agnn_aggregate is None:
        assert fused == tiles == sfused_bwd == 0
    elif pg.pf > 1:
        assert fused > 0 and tiles > 0 and sfused_bwd == 0
    else:
        assert fused == tiles == 0 and sfused_bwd > 0


def test_unsplit_ops_run_each_class_once_a_shard(case, monkeypatch):
    """Where a direction has no split stream, its SpMM is K1 once a class a
    shard, the SDDMM K4 once a class a shard (on every case), and the halo
    exchange is waited after every local class ran and before any remote
    one did."""
    from tcgnn_tpu_torch.ops import sddmm_tc_dense, spmm_tc_dense
    from tcgnn_tpu_torch.parallel import collectives

    pg, n = case["pg"], case["n"]
    shards = pg.pg * pg.pf
    waits = []
    wait = collectives.Started.wait
    monkeypatch.setattr(collectives.Started, "wait", lambda self: waits.append(
        (spmm_tc_dense.plain_calls, sddmm_tc_dense.plain_calls)) or wait(self))
    xs = torch.nn.functional.pad(torch.from_numpy(case["x"]), (0, 0, 0, pg.padded_nodes - n))
    for dn in (pg._fwd, pg._bwd):
        if dn.split is not None:
            continue
        reset_counts()
        waits.clear()
        pg._spmm(xs, dn)
        assert spmm_tc_dense.plain_calls == 2 * shards
        assert waits and set(waits) == {(shards, 0)}, waits
    reset_counts()
    waits.clear()
    pg.sddmm(xs)
    assert sddmm_tc_dense.plain_calls == 2 * shards and spmm_tc_dense.plain_calls == 0
    assert waits and set(waits) == {(0, shards)}, waits


def test_spmm_bf16_unsplit_matches_jax_at_one_rounding_step():
    """The unsplit SpMM in bf16, forward and gradient (a linear loss, so the
    cotangent is exact in bf16): each class's output stored in bf16 and the
    two added, the JAX order; one bf16 rounding step apart at most."""
    n = 400
    ptr, idx = mega_csr(n, 7, False)
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    jg = JaxDistributedTiledGraph(ptr, idx, n, jax_make_mesh(4, 2), jcfg, split=False)
    pg = DistributedTiledGraph(ptr, idx, n, make_mesh(4, 2, "cpu"), cfg, split=False)
    assert pg.use_overlap and jg._use_overlap
    assert pg.host_fwd.split is None and pg.host_bwd.split is None
    rng = np.random.default_rng(23)
    x = (0.5 * rng.standard_normal((n, D))).astype(np.float32)
    c = (rng.integers(-4, 5, (n, D)) / 4).astype(np.float32)  # exact in bf16

    xj = jax.device_put(jnp.pad(jnp.asarray(x), ((0, jg.padded_nodes - n), (0, 0))),
                        NamedSharding(jg.mesh, P("graph", "feature")))
    want_dx = jax.jit(jax.grad(lambda xx: jnp.sum(jg.spmm(xx)[:n].astype(jnp.float32) * c)))(xj)
    want_y = np.asarray(jax.jit(jg.spmm)(xj)).astype(np.float32)[:n]
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, pg.padded_nodes - n))
    xp.requires_grad_(True)
    y = pg.spmm(xp)
    assert y.dtype == torch.bfloat16
    (y[:n].float() * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(y[:n].detach().float().numpy(), want_y, **BF16_STEP)
    np.testing.assert_allclose(xp.grad[:n].float().numpy(),
                               np.asarray(want_dx).astype(np.float32)[:n], **BF16_STEP)


def test_agnn_bf16_split_4x2_matches_jax():
    n = 400
    ptr, idx = mega_csr(n, 11, True)
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    jg = JaxDistributedTiledGraph(ptr, idx, n, jax_make_mesh(4, 2), jcfg)
    pg = DistributedTiledGraph(ptr, idx, n, make_mesh(4, 2, "cpu"), cfg)
    assert pg.agnn_split and jg._ag_split
    rng = np.random.default_rng(21)
    x = (0.5 * rng.standard_normal((n, D))).astype(np.float32)
    att = rng.standard_normal((1, 2)).astype(np.float32)
    w = np.zeros(len(idx), np.float32)
    got = _port_ops(pg, n, x, w, w, att, ops=("agnn_aggregate",))["agnn_aggregate"]
    want = _jax_ops(jg, n, x, w, w, att, ops=("agnn_aggregate",))["agnn_aggregate"]
    np.testing.assert_allclose(got[0][:n], want[0][:n], **BF16)
    np.testing.assert_allclose(got[1][0][:n], want[1][0][:n], **BF16)
    np.testing.assert_allclose(got[1][1], want[1][1], **BF16)
