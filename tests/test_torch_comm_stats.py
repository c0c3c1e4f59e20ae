"""The port's collective traffic accounting (``tcgnn_tpu_torch.parallel.
comm_stats``) against ``tcgnn_tpu.parallel.comm_stats``.

* The counter of ``parallel/collectives.py`` on a hand-built 4x2 grid: each
  collective's kind, count and bytes, with and without ``num_devices``
  (a permute whose pairs leave members at zeros moves nothing to them);
* parity with JAX's ``step_collective_bytes`` of the hoist=False training
  step on the same graph (8 virtual CPU devices): ``collective_permute``,
  ``all_to_all`` and the streamed route's ``all_gather`` equal JAX's
  explicit collectives (the ``shard_map`` ones, HLO ``op_name`` metadata) in
  count and bytes: GCN on ``rand_4000_32000`` at 4x1 and 4x2 (32x32), AGNN
  at 4x1 (the split stream and ``xa_fetch``), the streamed route forced with
  ``_stream_limits=(8, 384)`` (GCN and AGNN), a block-diagonal graph's rim
  shifts.  Kinds that differ on purpose are asserted at the port's value:
  ``all_reduce`` (the port has one copy of the parameters, so no gradient
  all-reduce runs; its ``psum``s are its own instances, where XLA merges
  JAX's into the gradient all-reduce), XLA's resharding permutes and
  all-gathers at F > 1 (the feature-sharded GEMMs), and the
  block-diagonal AGNN's two spill-back shifts a layer, which the port's
  design does without;
* JAX's two properties on the port: the measured halo bytes lie within
  ``[per_op, 40 x per_op]`` of the boundary volume, and a banded graph
  moves under a quarter of a random one's;
* ``dcn_halo_fraction`` equals JAX's; ``make_mesh_two_level``.
"""

import threading

import jax
import numpy as np
import optax
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.synthetic import component_union_graph
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import init_distributed_net as jax_init_distributed_net
from tcgnn_tpu.parallel import make_distributed_train_step as jax_make_step
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu.parallel.comm_stats import collective_bytes_from_hlo
from tcgnn_tpu.parallel.comm_stats import dcn_halo_fraction as jax_dcn_halo_fraction
from tcgnn_tpu.parallel.comm_stats import step_collective_bytes as jax_step_collective_bytes
from tcgnn_tpu_torch.bench.partition_stats import shard_stats
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, synthesize
from tcgnn_tpu_torch.models import GNN
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    collectives,
    dcn_halo_fraction,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
    make_mesh_two_level,
    step_collective_bytes,
)
from tcgnn_tpu_torch.parallel.comm_stats import KINDS, Recorder

CFG = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)
JCFG = JaxTileConfig(blk_h=32, blk_w=32, edge_chunk=32)
# The block-diagonal graph's tiles: rows_per_shard a multiple of its 128-row
# bins.
BD_CFG = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)
BD_JCFG = JaxTileConfig(blk_h=128, blk_w=128, edge_chunk=64)
DIM, CLASSES, HIDDEN = 16, 4, 8


# ---- the counter ---------------------------------------------------------------

def _grid(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
            for _ in range(4)]


@pytest.mark.parametrize("num_devices", [None, 8])
def test_counter_on_a_4x2_grid(num_devices):
    """One instance a call; bytes one member's result: the gathered tensor
    for ``all_gather``, the member's for the others; a permute weighed by
    its listed pairs over every group of its axis, where ``num_devices`` is
    given."""
    grid = _grid((8, 3))
    member = 8 * 3 * 4
    with collectives.recording(Recorder(num_devices)) as rec:
        collectives.all_gather(grid, "graph")
        collectives.all_gather(grid, "feature")
        collectives.all_to_all(grid, "graph")
        collectives.psum(grid, "feature")
        out = collectives.ppermute(grid, [(0, 1), (1, 2)], "graph")
        collectives.ppermute(grid, [(1, 0)], "feature")
    # Members 0 and 3 of each graph-axis group receive zeros.
    for f in range(2):
        assert not out[0][f].any() and not out[3][f].any()
        assert torch.equal(out[1][f], grid[0][f]) and torch.equal(out[2][f], grid[1][f])
    weigh = (lambda b, pairs, groups: b) if num_devices is None else (
        lambda b, pairs, groups: int(round(b * pairs * groups / num_devices)))
    assert rec.stats == {
        "all_gather": {"count": 2, "bytes": 4 * member + 2 * member},
        "all_to_all": {"count": 1, "bytes": member},
        "all_reduce": {"count": 1, "bytes": member},
        "reduce_scatter": {"count": 0, "bytes": 0},
        # graph axis: 2 pairs in each of 2 groups; feature axis: 1 in each of 4
        "collective_permute": {"count": 2,
                               "bytes": weigh(member, 2, 2) + weigh(member, 1, 4)},
    }
    assert num_devices is None or rec.stats["collective_permute"]["bytes"] == member


def test_counter_sees_other_threads():
    """Autograd runs a CUDA backward on its own device thread: a collective
    run there inside ``recording`` is counted too."""
    grid = _grid((8, 3))
    with collectives.recording(Recorder()) as rec:
        t = threading.Thread(target=collectives.all_gather, args=(grid, "graph"))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert rec.stats["all_gather"] == {"count": 1, "bytes": 4 * 8 * 3 * 4}


def test_counter_off_and_unequal_members():
    """Outside ``recording`` nothing is counted; inside, members of unequal
    shapes raise (JAX's shard_map has none)."""
    grid = _grid((8, 3))
    rec = Recorder()
    with collectives.recording(rec):
        pass
    collectives.all_gather(grid, "graph")
    assert all(v == {"count": 0, "bytes": 0} for v in rec.stats.values())
    grid[1][0] = torch.zeros(4, 3)
    with collectives.recording(rec), pytest.raises(ValueError, match="different shapes"):
        collectives.all_gather(grid, "graph")


# ---- parity with JAX's compiled step ------------------------------------------

def _rand():
    ds = synthesize("rand_4000_32000", DIM, CLASSES)
    return ds.row_pointers, ds.column_index, ds.num_nodes


def _bd():
    src, dst = component_union_graph(2048, 5200, 64, seed=7)
    ptr, idx = coo_to_csr(src, dst, 2048)
    return ptr, idx, 2048


def _jax_stats(ptr, idx, n, ng, nf, kind, cfg, **kw):
    """JAX's ``step_collective_bytes`` of the hoist=False step, and the same
    count over its explicit (``shard_map``) collectives only."""
    jg = JaxDistributedTiledGraph(ptr, idx, n, jax_make_mesh(ng, nf), cfg, **kw)
    rng = np.random.default_rng(0)
    x = jg.shard_features(rng.standard_normal((n, DIM)).astype(np.float32))
    y = jg.shard_nodes(rng.integers(0, CLASSES, n).astype(np.int32))
    params, _, _ = jax_init_distributed_net(jax.random.PRNGKey(0), kind, x.shape[1], HIDDEN,
                                            CLASSES, 2, jg)
    opt = optax.adam(0.01)
    step = jax_make_step(jg, kind, x, y, opt, 0.0, num_valid_classes=CLASSES, hoist=False)
    args = (params, opt.init(params), jax.random.PRNGKey(1))
    total = jax_step_collective_bytes(step, *args, num_devices=ng * nf)
    hlo = step.jitted.lower(*args, *step.bound_args).compile().as_text()
    explicit = collective_bytes_from_hlo(
        "\n".join(line for line in hlo.splitlines() if "shard_map/" in line), ng * nf)
    return total, explicit, params


def _port_stats(ptr, idx, n, ng, nf, kind, cfg, params, **kw):
    """The port's ``step_collective_bytes`` of the hoist=False step with
    JAX's parameters, and the route it took."""
    pg = DistributedTiledGraph(ptr, idx, n, make_mesh(ng, nf, "cpu"), cfg, **kw)
    rng = np.random.default_rng(0)
    x = pg.shard_features(rng.standard_normal((n, DIM)).astype(np.float32))
    y = pg.shard_nodes(rng.integers(0, CLASSES, n).astype(np.int64))
    net = GNN(kind, [x.shape[1]] + [p["weights"].shape[1] for p in params], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    step = make_distributed_train_step(pg, net, x, y, torch.optim.Adam(net.parameters(), lr=0.01),
                                       0.0, num_valid_classes=CLASSES, hoist=False)
    return step_collective_bytes(step, num_devices=ng * nf), pg


# name: graph, mesh, model, tiles, graph options, the route's token
PARITY = {
    "gcn_4x1": (_rand, 4, 1, "gcn", {}, "block_diag=False"),
    "gcn_4x2": (_rand, 4, 2, "gcn", {}, "block_diag=False"),
    "agnn_4x1_split": (_rand, 4, 1, "agnn", {}, "K2/K3 on the split stream"),
    "gcn_4x1_streamed": (_rand, 4, 1, "gcn", dict(streamed=True, _stream_limits=(8, 384)),
                         "streamed=True"),
    "agnn_4x1_streamed": (_rand, 4, 1, "agnn", dict(streamed=True, _stream_limits=(8, 384)),
                          "streamed=True"),
    "bd_gcn_4x1": (_bd, 4, 1, "gcn", {}, "block_diag=True"),
    "bd_gcn_4x2": (_bd, 4, 2, "gcn", {}, "block_diag=True"),
    "bd_agnn_4x1": (_bd, 4, 1, "agnn", {}, "block_diag=True"),
}


@pytest.fixture(scope="module", params=sorted(PARITY))
def parity(request):
    make, ng, nf, kind, kw, route = PARITY[request.param]
    ptr, idx, n = make()
    cfgs = (BD_CFG, BD_JCFG) if make is _bd else (CFG, JCFG)
    total, explicit, params = _jax_stats(ptr, idx, n, ng, nf, kind, cfgs[1], **kw)
    port, pg = _port_stats(ptr, idx, n, ng, nf, kind, cfgs[0], params, **kw)
    assert route in pg.route, pg.route
    return request.param, nf, kind, total, explicit, port


def test_step_traffic_matches_jax(parity):
    """The halo kinds equal JAX's explicit collectives in count and bytes;
    the kinds that differ on purpose are held at the port's value."""
    name, nf, kind, total, explicit, port = parity
    assert set(port) == set(KINDS) | {"total_bytes"}
    assert port["total_bytes"] == sum(port[k]["bytes"] for k in KINDS)
    assert port["reduce_scatter"] == {"count": 0, "bytes": 0}
    assert port["all_to_all"] == explicit["all_to_all"] == total["all_to_all"]
    assert port["all_gather"] == explicit["all_gather"]
    if name == "bd_agnn_4x1":
        # JAX's BD AGNN backward spills the transpose term's rim bins back
        # with two more shifts a layer (tcgnn_tpu/parallel/graph.py:1601-1640);
        # the port's K7 takes it from the dy rim stack, so it runs the
        # forward's two shifts and the dy's two a layer.  Every shift here
        # moves one 128-row bin at width 8.
        cp = explicit["collective_permute"]
        assert cp["count"] == 12
        per_shift = cp["bytes"] // cp["count"]
        assert port["collective_permute"] == {"count": 8, "bytes": 8 * per_shift}
    else:
        assert port["collective_permute"] == explicit["collective_permute"]
    if nf == 1:
        # No resharding: every JAX halo collective is an explicit one.
        assert total["collective_permute"] == explicit["collective_permute"]
        assert total["all_gather"] == explicit["all_gather"]
    else:
        # XLA's partitioner adds resharding permutes and all-gathers around
        # the feature-sharded GEMMs and pads; the port runs none.
        assert total["collective_permute"]["count"] > explicit["collective_permute"]["count"]
        assert total["all_gather"]["count"] > explicit["all_gather"]["count"] == 0
    # all_reduce: JAX all-reduces the replicated parameters' gradients (and
    # at F = 1 folds the AGNN's psums into that instance); the port keeps
    # one copy of the parameters, and counts each psum of the step: the
    # AGNN's dc scalar over graph, a layer, on the fused routes.
    assert total["all_reduce"]["count"] >= 1
    fused_agnn = kind == "agnn" and "streamed" not in name
    want = {"count": 2, "bytes": 8} if fused_agnn else {"count": 0, "bytes": 0}
    assert port["all_reduce"] == want


# ---- the JAX tests' properties on the port ------------------------------------

def _banded(n, halfband=12, seed=0):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), 4)
    dst = src + rng.integers(1, halfband, size=len(src))
    keep = dst < n
    src, dst = src[keep], dst[keep]
    return coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)


def _port_hoisted(ptr, idx, n, mesh, steps=1):
    """The port's hoisted GCN step (JAX's test step: hidden 8, no dropout):
    its first step's traffic, the graph and the losses of ``steps`` steps."""
    dg = DistributedTiledGraph(ptr, idx, n, mesh, CFG, block_diag=False)
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((n, DIM)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, CLASSES, n).astype(np.int64))
    net, _, _ = init_distributed_net(torch.Generator().manual_seed(0), "gcn", DIM, HIDDEN,
                                     CLASSES, 2, dg)
    step = make_distributed_train_step(dg, net, x, y, torch.optim.Adam(net.parameters(), lr=0.01),
                                       0.0, num_valid_classes=CLASSES)
    losses = []
    stats = step_collective_bytes(lambda: losses.append(float(step())), num_devices=mesh.size)
    for _ in range(steps - 1):
        losses.append(float(step()))
    return stats, dg, losses


@pytest.fixture(scope="module")
def random_4x2():
    ptr, idx, n = _rand()
    stats, dg, _ = _port_hoisted(ptr, idx, n, make_mesh(4, 2, "cpu"))
    return stats, dg, ptr, idx


def test_halo_bytes_scale_with_the_boundary(random_4x2):
    """The random graph's measured halo bytes lie within a small factor of
    the modelled boundary volume a pass (boundary rows x the hidden width
    over the feature shards x 4 bytes, per device), far below a whole
    feature matrix."""
    stats, dg, ptr, idx = random_4x2
    assert stats["collective_permute"]["count"] >= 2  # forward and backward halos
    _, shards = shard_stats(ptr, idx, dg.num_nodes, dg.pg, config=CFG)
    per_op = sum(s["boundary"] for s in shards) * 8 * 4 // dg.pg
    measured = stats["collective_permute"]["bytes"] + stats["all_to_all"]["bytes"]
    assert per_op <= measured <= 40 * per_op, (measured, per_op)


def test_banded_moves_less_than_random(random_4x2):
    n = 4096
    ptr, idx = _banded(n)
    s_band, _, _ = _port_hoisted(ptr, idx, n, make_mesh(4, 2, "cpu"))
    ds = synthesize(f"rand_{n}_{len(idx)}", DIM, CLASSES)
    s_rand, _, _ = _port_hoisted(ds.row_pointers, ds.column_index, n, make_mesh(4, 2, "cpu"))

    def halo(s):
        return s["collective_permute"]["bytes"] + s["all_to_all"]["bytes"]

    assert 0 < halo(s_band) * 4 < halo(s_rand), (s_band, s_rand)


# ---- two-level meshes ------------------------------------------------------------

@pytest.mark.parametrize("chips_per_host", [2, 4])
def test_dcn_halo_fraction_matches_jax(chips_per_host):
    rng = np.random.default_rng(3)
    pc = rng.integers(0, 50, (8, 8)) * (rng.random((8, 8)) < 0.6)
    np.fill_diagonal(pc, 0)
    assert dcn_halo_fraction(pc, chips_per_host) == jax_dcn_halo_fraction(pc, chips_per_host)
    assert dcn_halo_fraction(np.zeros((8, 8)), chips_per_host) == 0.0


def test_two_level_mesh_fraction_and_step():
    """``make_mesh_two_level`` has ``make_mesh``'s axes; on a banded graph
    the halo crosses hosts only between the two middle shards, and the step
    trains.  A list of two devices raises."""
    mesh = make_mesh_two_level(2, 4, device="cpu")
    assert mesh.shape == {"graph": 8, "feature": 1}
    n = 8192
    ptr, idx = _banded(n)
    _, dg, losses = _port_hoisted(ptr, idx, n, mesh, steps=4)
    frac = dcn_halo_fraction(dg.host_fwd.halo["pair_counts"], chips_per_host=4)
    assert 0.0 < frac < 0.35, frac
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(NotImplementedError, match="8c"):
        make_mesh_two_level(1, 2, device=["cuda:0", "cuda:1"])
