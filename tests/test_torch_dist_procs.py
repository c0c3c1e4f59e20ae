"""The mesh over several processes (``torch.distributed``, gloo on the CPU)
in its two layouts: the graph axis split across ranks, each rank holding its
graph shards with every feature shard of them (``--mesh 4xF``); and one
feature shard a rank (W = 2 over ``1x2``, W = 4 over ``2x2``: the
column-parallel dense side, the feature-axis sums across ranks).

One ``torch.multiprocessing.spawn`` a world size (W = 2 and W = 4, over a
``file://`` store in a temporary directory) runs every case of
``dist_procs_cases.py`` in each rank; the tests read the ranks' results and
hold them to the one-process mesh (run here) and to JAX:

* every collective on a hand-built 4x2 grid, along both axes: each rank's
  members equal the one-process grid's, and the recorder's counts too; the
  same on a grid one feature shard a rank (W = 2: 3x2, W = 4: 6x2);
* on each route (dense tiles with the split stream, block-diagonal,
  streamed, chunk fallback) at F = 1 and 2 within a rank: ``spmm``,
  ``spmm_weighted``, ``sddmm`` and ``agnn_aggregate``, forward and every
  gradient, each rank's rows and edges equal to the one-process mesh's
  (f32 ``rtol=atol=1e-4`` forward, ``1e-3`` gradients: the JAX parity
  tests' tolerances); the attention weights' gradient summed over the ranks
  (each rank's part of ``dc``; the training step's all-reduce sums them);
* three Adam steps of GCN and AGNN over 4x2 from JAX's parameters: every
  rank's losses and parameters equal to JAX's mesh step (``rtol=1e-4``, as
  ``test_torch_dist_train.check_train_step_matches_jax``), and the ranks'
  parameters equal to each other bit for bit;
* dropout on: every rank's losses equal to the one-process port mesh's;
  every rank's step is an ``eager`` ``TrainStep`` in both layouts (a CUDA
  graph cannot hold gloo's host-staged transfers), the one process's not;
* every rank's ``step_collective_bytes`` equal to the one-process mesh's
  plus one ``all_reduce`` of the flattened gradients and the loss: 4,228 B
  for GCN and 4,236 B for AGNN on ``rand_4000_32000`` over 4x1, JAX's
  instance to the byte (ROADMAP.md, Queue 1);
* one feature shard a rank: on each route the four ops, forward and every
  gradient, equal to the one-process mesh of the same shape, each rank's
  node tensors ``D / F`` columns wide, the ranks' attention gradients (their
  parts of ``dc``) summing to one process's; three Adam steps of GCN and
  AGNN equal to JAX's 2x2 and 1x2 steps; dropout on equal to one process;
  ``step_collective_bytes`` one process's plus the gradient bucket plus the
  resharding collectives (the column-parallel products' all-gathers and
  reduce-scatters, the logits' all-gather), reckoned from the widths;
* the halo-overlap split's classes on a directed graph without the split
  stream, over 2 graph shards (W = 2: ``2x1``, one shard a rank; W = 4:
  ``2x2``, one feature shard a rank): ``spmm``, ``spmm_weighted`` and
  ``sddmm``, forward and every gradient, equal to the one-process mesh's;
  in one SpMM a direction and one SDDMM, every exchange is waited on after
  the local class's K1 (K4) ran on each of the rank's shards and before
  the remote class's did;
* ``--single_kernel`` over the ranks in both layouts (every rank reports
  the slowest rank's times, with one process's keys), and
  ``measure_comm`` over the ranks: rank 0 alone writes the CSV, whose rows
  are one process's;
* a mesh that fits neither layout raises (the library and the trainer),
  and so do the trainer without ``--mesh`` and, at W = 4, a two-level mesh
  whose hosts cannot hold a feature group; a two-level mesh puts a rank's
  shards on its host; the ranks load no JAX;
* the trainer under ``torchrun`` (2 processes, AGNN ``--mesh 4x2``, dropout
  on): rank 0's lines are the one-process mesh run's.
"""

import datetime
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import dist_procs_cases as cases
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.parallel import DistributedTiledGraph as JaxDistributedTiledGraph
from tcgnn_tpu.parallel import init_distributed_net as jax_init_distributed_net
from tcgnn_tpu.parallel import make_distributed_train_step as jax_make_step
from tcgnn_tpu.parallel import make_mesh as jax_make_mesh
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.bench import measure_comm as port_measure_comm
from tcgnn_tpu_torch.parallel import make_mesh
from tcgnn_tpu_torch.parallel.mesh import init_process_group

FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
TRAIN = dict(rtol=1e-4, atol=1e-6)
WORLDS = (2, 4)
# A rank's whole run is a few tens of seconds here; past this the spawn is
# taken for hung and its ranks are ended.
SPAWN_TIMEOUT_S = 240
# JAX's one gradient all-reduce of the step (tests/test_torch_comm_stats.py,
# rand_4000_32000 over 4x1): the gradients and the loss.
JAX_ALL_REDUCE_BYTES = {"gcn": 4228, "agnn": 4236}
# The meshes JAX's train step runs on: the graph-axis layout's (4x2), and
# each world's feature-split one.
JAX_MESHES = ((4, 2),) + tuple(cases.SPLIT[w] for w in WORLDS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_train():
    """JAX's mesh step on the training graph, by mesh shape (``JAX_MESHES``)
    and model: its initial parameters (numpy; the same on every mesh of two
    feature shards) and, after ``STEPS`` steps, its losses and parameters."""
    out = {shape: _jax_train(shape) for shape in JAX_MESHES}
    for shape in JAX_MESHES[1:]:
        for kind, r in out[shape].items():
            for p, q in zip(r["init"], out[JAX_MESHES[0]][kind]["init"]):
                assert all(np.array_equal(p[k], q[k]) for k in p)
    return out


def _jax_train(shape):
    ptr, idx, x, y = cases.train_inputs()
    jg = JaxDistributedTiledGraph(ptr, idx, cases.TRAIN_N, jax_make_mesh(*shape),
                                  JaxTileConfig(blk_h=16, blk_w=16, edge_chunk=16))
    xs, ys = jg.shard_features(x), jg.shard_nodes(y.astype(np.int32))
    out = {}
    for kind in ("gcn", "agnn"):
        params, _, _ = jax_init_distributed_net(jax.random.PRNGKey(3), kind, xs.shape[1],
                                                cases.HIDDEN, cases.CLASSES, 2, jg)
        init = [{k: np.asarray(v) for k, v in p.items()} for p in params]
        opt = optax.adam(0.01)
        step = jax_make_step(jg, kind, xs, ys, opt, dropout_rate=0.0,
                             num_valid_classes=cases.CLASSES)
        state, key, losses = opt.init(params), jax.random.PRNGKey(1), []
        for _ in range(cases.STEPS):
            params, state, key, loss = step(params, state, key)
            losses.append(float(loss))
        names = ["weights"] + (["attention_w"] if kind == "agnn" else [])
        # The port's parameter order: every layer's weights, then every
        # layer's attention weights.
        final = [np.asarray(p[name]) for name in names for p in params]
        out[kind] = {"init": init, "losses": losses, "params": final}
    return out


def _spawn(world, root, jax_params):
    store, out = os.path.join(root, "store"), os.path.join(root, "out")
    os.makedirs(out)
    ctx = mp.spawn(cases.run_rank, args=(world, store, out, jax_params), nprocs=world,
                   join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"W={world}: ranks still running after {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_train):
    """Every rank's results, by world size: one spawn each."""
    params = {k: v["init"] for k, v in jax_train[JAX_MESHES[0]].items()}
    return {w: _spawn(w, str(tmp_path_factory.mktemp(f"w{w}")), params) for w in WORLDS}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process mesh's results of the same cases, on one thread as
    each rank runs (torch's threads would oversubscribe the cores the other
    test workers share)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _one_process(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _one_process(tmp_path_factory):
    res = {}
    for route, f in cases.OP_CASES:
        g = cases.op_graph(route, f)
        res[("route", route, f)] = g.route
        res[("ops", route, f)] = cases.run_ops(g, *cases.op_inputs(route, f, g.num_edges))
    res["dropout"] = cases.train_steps("gcn", (4, 2), dropout=0.5)
    for kind in ("gcn", "agnn"):
        res[("comm", kind)] = cases.comm_counts(kind)
    for world in WORLDS:
        shape = cases.SPLIT[world]
        for route in cases.ROUTES:
            g = cases.op_graph(route, 2, shape)
            res[("split route", route, world)] = g.route
            res[("split ops", route, world)] = cases.run_ops(
                g, *cases.op_inputs(route, 2, g.num_edges))
        res[("split dropout", world)] = cases.train_steps("gcn", shape, dropout=0.5)
        for kind, graph in cases.GRAD_CASES:
            res[("split grads", kind, graph, world)] = cases.step_grads(kind, graph, shape)
        for kind in ("gcn", "agnn"):
            res[("split comm", kind, world)] = cases.comm_counts(kind, shape)
        g = cases.overlap_graph(cases.OVERLAP[world])
        res[("overlap route", world)] = g.route
        res[("overlap ops", world)] = cases.run_ops(g, *cases.op_inputs("chunk", 1, g.num_edges))
    res["single_kernel"] = cases.single_kernel("4x1")
    out_csv = str(tmp_path_factory.mktemp("one") / "comm.csv")
    res["measure_comm"] = (port_measure_comm.main([*cases.MEASURE_COMM, "--out", out_csv]),
                           open(out_csv).read())
    return res


COLLECTIVES = ("all_gather graph", "all_gather feature", "ppermute graph", "ppermute feature",
               "all_to_all graph", "psum graph", "psum feature", "all_to_all feature",
               "psum_scatter graph", "psum_scatter feature")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_one_process(ranks, world, name):
    """Each collective on a hand-built 4x2 grid: every rank's members equal
    the one-process grid's rows of them; the recorder counts each call as
    one instance of the same bytes."""
    want, want_stats = cases.run_collectives(None)
    per = 4 // world
    for r in ranks[world]:
        got, stats = r["collectives"]
        assert stats == want_stats
        lo = r["rank"] * per
        for i, row in enumerate(got[name]):
            for f, t in enumerate(row):
                np.testing.assert_allclose(t, want[name][lo + i][f], rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {r['rank']} member ({lo + i}, {f})")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route,f", cases.OP_CASES, ids=[f"{r}-F{f}" for r, f in cases.OP_CASES])
@pytest.mark.parametrize("op", cases.OPS)
def test_op_matches_one_process(ranks, one_process, world, route, f, op):
    want = one_process[("ops", route, f)]
    token = cases.ROUTES[route][4]
    assert token in one_process[("route", route, f)]
    if op not in want:  # no fused AGNN on the streamed and chunk routes
        assert route in ("streamed", "chunk")
        assert all(op not in r[("ops", route, f)] for r in ranks[world])
        return
    att_grads = []
    for r in ranks[world]:
        assert r[("route", route, f)] == one_process[("route", route, f)]
        lo, hi = r[("rows", route, f)]
        elo, ehi = r[("edges", route, f)]
        got_fwd, got_grads = r[("ops", route, f)][op]
        want_fwd, want_grads = want[op]
        if op == "sddmm":
            np.testing.assert_allclose(got_fwd, want_fwd[elo:ehi], **FWD)
        else:
            np.testing.assert_allclose(got_fwd, want_fwd[lo:hi], **FWD)
        for i, (g, w) in enumerate(zip(got_grads, want_grads)):
            if op == "agnn_aggregate" and i == 1:
                att_grads.append(g)
                continue
            w = w[lo:hi] if i == 0 else w[elo:ehi]
            np.testing.assert_allclose(g, w, err_msg=f"rank {r['rank']} gradient {i}", **GRAD)
    if op == "agnn_aggregate":
        np.testing.assert_allclose(sum(att_grads), want[op][1][1], err_msg="attention", **GRAD)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_train_steps_match_jax(ranks, jax_train, world, kind):
    want = jax_train[JAX_MESHES[0]][kind]
    first = ranks[world][0][("jax_train", kind)]
    for r in ranks[world]:
        got = r[("jax_train", kind)]
        np.testing.assert_allclose(got["losses"], want["losses"], **TRAIN)
        for i, (p, q) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(p, q, err_msg=f"parameter {i}", **TRAIN)
        for p, q in zip(got["params"], first["params"]):
            assert np.array_equal(p, q), "ranks stepped Adam differently"
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_matches_one_process(ranks, one_process, world):
    want = one_process["dropout"]["losses"]
    for r in ranks[world]:
        np.testing.assert_allclose(r["dropout"]["losses"], want, **TRAIN)


@pytest.mark.parametrize("world", WORLDS)
def test_step_over_ranks_is_eager(ranks, one_process, world):
    """Over processes the mesh step is built ``eager`` (gloo stages its
    transfers through the host, which a CUDA graph cannot hold; ROADMAP
    item 8c-iv), in both layouts; in one process it is not."""
    assert one_process["dropout"]["eager"] is False
    for r in ranks[world]:
        assert r["dropout"]["eager"] is True
        assert r["split dropout"]["eager"] is True


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_collectives_one_process_plus_the_gradient_all_reduce(ranks, one_process, world, kind):
    want = one_process[("comm", kind)]
    bucket = want["grad_bytes"] + 4  # the gradients and the loss, f32
    assert bucket == JAX_ALL_REDUCE_BYTES[kind]
    for r in ranks[world]:
        got = r[("comm", kind)]
        for k in ("all_to_all", "all_gather", "collective_permute", "reduce_scatter"):
            assert got[k] == want[k], k
        assert got["all_reduce"] == {"count": want["all_reduce"]["count"] + 1,
                                     "bytes": want["all_reduce"]["bytes"] + bucket}
        assert got["total_bytes"] == want["total_bytes"] + bucket


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout_over_ranks(ranks, one_process, world):
    """A mesh that fits neither layout raises (in the library and the
    trainer), and so does the trainer without ``--mesh`` in a group; at W =
    4 so does a two-level mesh of 2 hosts that cannot hold a feature group
    of 4; ``--single_kernel`` runs over the ranks (ROADMAP item 8c-iii);
    a two-level mesh of 2 hosts x 2 chips puts each rank's shards on its
    host; no rank loads JAX."""
    want_keys = sorted(k for k, v in one_process["single_kernel"].items()
                       if isinstance(v, float))
    for r in ranks[world]:
        for name in ("indivisible", "feature indivisible", "cli indivisible"):
            assert "process count must divide the graph axis" in r[name], name
        if world == 4:
            assert "feature groups of 4" in r["two_level features"]
        assert r["no_mesh"].startswith("ValueError") and "--mesh" in r["no_mesh"]
        for mesh_arg in ("4x1", "x".join(map(str, cases.SPLIT[world]))):
            got = r[("single_kernel", mesh_arg)]
            assert sorted(got) == want_keys, mesh_arg
            assert all(np.isfinite(v) and v > 0 for v in got.values()), (mesh_arg, got)
            # Every rank reports the slowest rank's times.
            assert got == ranks[world][0][("single_kernel", mesh_arg)], mesh_arg
        host, shard_hosts = r["two_level"]
        assert host == r["rank"] // (world // 2) and set(shard_hosts) == {host}
        assert r["jax_loaded"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_measure_comm_over_ranks(ranks, one_process, world):
    """``measure_comm`` over the ranks: every rank's rows are one
    process's, and rank 0 alone writes the CSV, one process's file."""
    want_rows, want_csv = one_process["measure_comm"]
    for r in ranks[world]:
        rows, csv = r["measure_comm"]
        assert rows == want_rows
        assert csv == (want_csv if r["rank"] == 0 else None)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_split_collective_matches_one_process(ranks, world, name):
    """Each collective on a grid of one feature shard a rank: every rank's
    members equal the one-process grid's block of them, and the recorder
    counts the same."""
    grid_case = cases.SPLIT_GRID[world]
    (ng, nf), _, _ = grid_case
    want, want_stats = cases.run_collectives(None, grid_case)
    per = ng // (world // nf)
    for r in ranks[world]:
        got, stats = r["split collectives"]
        assert stats == want_stats
        rg, f = divmod(r["rank"], nf)
        for i, row in enumerate(got[name]):
            assert len(row) == 1
            np.testing.assert_allclose(row[0], want[name][rg * per + i][f], rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {r['rank']} member "
                                       f"({rg * per + i}, {f})")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", list(cases.ROUTES))
@pytest.mark.parametrize("op", cases.OPS)
def test_split_op_matches_one_process(ranks, one_process, world, route, op):
    """One feature shard a rank: each op's forward and gradients on the
    rank's block equal the one-process mesh's of the same shape, the node
    tensors ``D / F`` columns wide; the ranks' attention gradients (their
    parts of ``dc``, over graph and feature) sum to one process's."""
    ng, nf = cases.SPLIT[world]
    want = one_process[("split ops", route, world)]
    if op not in want:  # no fused AGNN on the streamed and chunk routes
        assert route in ("streamed", "chunk")
        assert all(op not in r[("split ops", route)] for r in ranks[world])
        return
    dl = cases.D // nf
    att_grads = []
    for r in ranks[world]:
        assert r["split mesh"] == (tuple(range(r["rank"] // nf * ng // (world // nf),
                                               (r["rank"] // nf + 1) * ng // (world // nf))),
                                   (r["rank"] % nf,), world // nf, nf)
        assert (r[("split route", route)] == one_process[("split route", route, world)]
                + f" ranks={world // nf}x{nf}")
        if ng > 1:
            assert cases.SPLIT_ROUTES[route][4] in r[("split route", route)]
        lo, hi = r[("split rows", route)]
        elo, ehi = r[("split edges", route)]
        width, cols = r[("split cols", route)]
        f = r["rank"] % nf
        assert (width, cols) == (cases.D, slice(f * dl, (f + 1) * dl))
        got_fwd, got_grads = r[("split ops", route)][op]
        want_fwd, want_grads = want[op]
        if op == "sddmm":
            np.testing.assert_allclose(got_fwd, want_fwd[elo:ehi], **FWD)
        else:
            assert got_fwd.shape == (hi - lo, dl)
            np.testing.assert_allclose(got_fwd, want_fwd[lo:hi, cols], **FWD)
        for i, (g, w) in enumerate(zip(got_grads, want_grads)):
            if op == "agnn_aggregate" and i == 1:
                att_grads.append(g)
                continue
            if i == 0:
                assert g.shape == (hi - lo, dl)
                w = w[lo:hi, cols]
            else:
                w = w[elo:ehi]
            np.testing.assert_allclose(g, w, err_msg=f"rank {r['rank']} gradient {i}", **GRAD)
    if op == "agnn_aggregate":
        np.testing.assert_allclose(sum(att_grads), want[op][1][1], err_msg="attention", **GRAD)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_split_train_steps_match_jax(ranks, jax_train, world, kind):
    """Three Adam steps one feature shard a rank equal JAX's steps on the
    same mesh (W = 2: 1x2, W = 4: 2x2), every rank's parameters equal bit
    for bit."""
    want = jax_train[cases.SPLIT[world]][kind]
    first = ranks[world][0][("split jax_train", kind)]
    for r in ranks[world]:
        got = r[("split jax_train", kind)]
        np.testing.assert_allclose(got["losses"], want["losses"], **TRAIN)
        for i, (p, q) in enumerate(zip(got["params"], want["params"])):
            np.testing.assert_allclose(p, q, err_msg=f"parameter {i}", **TRAIN)
        for p, q in zip(got["params"], first["params"]):
            assert np.array_equal(p, q), "ranks stepped Adam differently"
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_split_dropout_matches_one_process(ranks, one_process, world):
    want = one_process[("split dropout", world)]["losses"]
    for r in ranks[world]:
        np.testing.assert_allclose(r["split dropout"]["losses"], want, **TRAIN)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,graph", cases.GRAD_CASES,
                         ids=[f"{k}-{g}" for k, g in cases.GRAD_CASES])
def test_split_gradients_match_one_process(ranks, one_process, world, kind, graph):
    """One step's loss and every gradient (dropout on), all-reduced over
    the ranks, equal the one-process mesh's: the loss and the attention
    weights' gradient are counted once, every weight's columns summed from
    the feature ranks' parts (Adam would hide a gradient scaled by F)."""
    want = one_process[("split grads", kind, graph, world)]
    assert want["agnn"] == (kind == "agnn" and graph == "train") or kind == "gcn"
    for r in ranks[world]:
        got = r[("split grads", kind, graph)]
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        for i, (p, q) in enumerate(zip(got["grads"], want["grads"])):
            np.testing.assert_allclose(p, q, err_msg=f"rank {r['rank']} gradient {i}", **GRAD)


def resharding(rows: int, widths, pf: int) -> dict:
    """The resharding collectives of one hoist=False 2-layer GCN or AGNN
    step, one feature shard a rank, by kind: ``{kind: (count, bytes)}``
    (f32, one shard's ``rows``; ``widths``: input, hidden, classes, padded).
    Layer 1 projects first (GCN: ``aggregate_first(256, 8)`` is false) and
    its input needs no gradient: one all-gather of the input.  Layer 2's
    product all-gathers the hidden width and its backward reduce-scatters
    it.  The logits are all-gathered; their backward moves nothing."""
    d_in, hidden, classes = widths
    return {"all_gather": (3, rows * (d_in + hidden + classes) * 4),
            "reduce_scatter": (1, rows * hidden // pf * 4)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_split_collectives_one_process_plus_bucket_and_resharding(ranks, one_process, world,
                                                                    kind):
    want = one_process[("split comm", kind, world)]
    bucket = want["grad_bytes"] + 4  # the gradients and the loss, f32
    extra = resharding(want["rows_per_shard"], want["widths"], cases.SPLIT[world][1])
    for r in ranks[world]:
        got = r[("split comm", kind)]
        assert got["widths"] == want["widths"] and got["rows_per_shard"] == want["rows_per_shard"]
        for k in ("all_to_all", "collective_permute"):
            assert got[k] == want[k], k
        for k, (count, nbytes) in extra.items():
            assert got[k] == {"count": want[k]["count"] + count,
                              "bytes": want[k]["bytes"] + nbytes}, k
        assert got["all_reduce"] == {"count": want["all_reduce"]["count"] + 1,
                                     "bytes": want["all_reduce"]["bytes"] + bucket}
        assert got["total_bytes"] == (want["total_bytes"] + bucket
                                      + sum(b for _, b in extra.values()))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["spmm", "spmm_weighted", "sddmm"])
def test_overlap_op_matches_one_process(ranks, one_process, world, op):
    """The overlap classes over the ranks (W = 2: 2x1, W = 4: 2x2 one
    feature shard a rank): each op's forward and gradients on the rank's
    block equal the one-process mesh's of the same shape."""
    want_fwd, want_grads = one_process[("overlap ops", world)][op]
    assert "overlap=True" in one_process[("overlap route", world)]
    for r in ranks[world]:
        ov = r["overlap"]
        assert ov["use_overlap"] and "overlap=True" in ov["route"] and "fwd=unsplit" in ov["route"]
        (lo, hi), (_, cols), (elo, ehi) = ov["rows"], ov["cols"], ov["edges"]
        got_fwd, got_grads = ov["ops"][op]
        if op == "sddmm":
            np.testing.assert_allclose(got_fwd, want_fwd[elo:ehi], **FWD)
        else:
            np.testing.assert_allclose(got_fwd, want_fwd[lo:hi, cols], **FWD)
        for i, (g, w) in enumerate(zip(got_grads, want_grads)):
            w = w[lo:hi, cols] if i == 0 else w[elo:ehi]
            np.testing.assert_allclose(g, w, err_msg=f"rank {r['rank']} gradient {i}", **GRAD)


@pytest.mark.parametrize("world", WORLDS)
def test_overlap_exchange_waited_between_the_classes(ranks, world):
    """In one SpMM a direction and one SDDMM over the ranks, every wait on
    the halo exchange comes after the local class's kernel ran on each of
    the rank's shards and before the remote class's ran on any; each op ran
    its kernel once a class a shard."""
    for r in ranks[world]:
        ov = r["overlap"]
        k = ov["shards"]
        for name, (waits, after) in ov["waits"].items():
            local, total = ((k, 0), (2 * k, 0)) if name != "sddmm" else ((0, k), (0, 2 * k))
            assert waits and set(waits) == {local}, (r["rank"], name, waits)
            assert after == total, (r["rank"], name, after)


def test_no_group_without_torchrun(monkeypatch):
    """Without torchrun's environment or an ``init_method`` no group forms,
    and in one process the mesh holds every shard."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launch with torchrun"):
        init_process_group("cpu")
    with pytest.raises(ValueError, match="rank and world_size"):
        init_process_group("cpu", init_method="file:///nonexistent")
    mesh = make_mesh(4, 2, "cpu")
    assert (mesh.world, mesh.rank, mesh.graph_shards) == (1, 0, range(4))


def test_torchrun_cli_matches_one_process(tmp_path, capsys):
    """``torchrun --nproc_per_node 2 -m tcgnn_tpu_torch.train ... --mesh 4x2``
    on the CPU (gloo, torchrun's environment): rank 0 alone prints the JAX
    CLI's lines, with dropout on the final loss and the all-reduced
    accuracies are the one-process mesh run's, and rank 0 alone writes
    ``--save_params``."""
    argv = ["--dataset", "rand_600_3000", "--dim", "12", "--classes", "3", "--blk_h", "16",
            "--blk_w", "16", "--epochs", "3", "--device", "cpu", "--model", "agnn", "--mesh",
            "4x2", "--eval"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "tcgnn_tpu_torch.train", *argv, "--save_params", str(tmp_path / "p")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = proc.stdout
    r = port_train.main(argv)
    want = capsys.readouterr().out

    def lines(out):
        return {k: v for k, v in (ln.split(":\t", 1) for ln in out.splitlines() if ":\t" in ln)}

    g, w = lines(got), lines(want)
    for key in ("TC_Blocks", "Exp_Edges", "Route", "Acc train", "Acc test"):
        assert g[key] == w[key], key
    assert got.count("Final loss:") == 1 and got.count("# saved params") == 1
    np.testing.assert_allclose(float(g["Final loss"]), r["final_loss"], **TRAIN)
    assert (tmp_path / "p.pt").exists()
