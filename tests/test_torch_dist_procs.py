"""The mesh over several processes (``torch.distributed``, gloo on the CPU):
the graph axis split across ranks, each rank holding its graph shards with
every feature shard of them.

One ``torch.multiprocessing.spawn`` a world size (W = 2 and W = 4, over a
``file://`` store in a temporary directory) runs every case of
``dist_procs_cases.py`` in each rank; the tests read the ranks' results and
hold them to the one-process mesh (run here) and to JAX:

* every collective on a hand-built 4x2 grid, along both axes: each rank's
  members equal the one-process grid's, and the recorder's counts too;
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
* every rank's ``step_collective_bytes`` equal to the one-process mesh's
  plus one ``all_reduce`` of the flattened gradients and the loss: 4,228 B
  for GCN and 4,236 B for AGNN on ``rand_4000_32000`` over 4x1, JAX's
  instance to the byte (ROADMAP.md, Queue 1);
* a mesh whose ``n_graph`` the world does not divide raises, and so do
  the trainer without ``--mesh`` and with ``--single_kernel``; a two-level
  mesh puts a rank's shards on its host; the ranks load no JAX;
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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_train():
    """JAX's 4x2 mesh step on the training graph: its initial parameters
    (numpy) and, after ``STEPS`` steps, its losses and parameters."""
    ptr, idx, x, y = cases.train_inputs()
    jg = JaxDistributedTiledGraph(ptr, idx, cases.TRAIN_N, jax_make_mesh(4, 2),
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
    params = {k: v["init"] for k, v in jax_train.items()}
    return {w: _spawn(w, str(tmp_path_factory.mktemp(f"w{w}")), params) for w in WORLDS}


@pytest.fixture(scope="module")
def one_process():
    """The one-process mesh's results of the same cases."""
    res = {}
    for route, f in cases.OP_CASES:
        g = cases.op_graph(route, f)
        res[("route", route, f)] = g.route
        res[("ops", route, f)] = cases.run_ops(g, *cases.op_inputs(route, f, g.num_edges))
    res["dropout"] = cases.train_steps("gcn", 2, dropout=0.5)
    for kind in ("gcn", "agnn"):
        res[("comm", kind)] = cases.comm_counts(kind)
    return res


COLLECTIVES = ("all_gather graph", "all_gather feature", "ppermute graph", "ppermute feature",
               "all_to_all graph", "psum graph", "psum feature")


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
    want = jax_train[kind]
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
def test_mesh_layout_over_ranks(ranks, world):
    """A mesh the world does not divide raises, and so do the trainer
    without ``--mesh`` and ``--single_kernel`` (ROADMAP item 8c-iii) in a
    group; a two-level mesh of 2 hosts x 2 chips puts each rank's shards on
    its host; no rank loads JAX."""
    for r in ranks[world]:
        assert "process count must divide the graph axis" in r["indivisible"]
        assert r["no_mesh"].startswith("ValueError") and "--mesh" in r["no_mesh"]
        assert r["single_kernel"].startswith("NotImplementedError")
        assert "8c-iii" in r["single_kernel"]
        host, shard_hosts = r["two_level"]
        assert host == r["rank"] // (world // 2) and set(shard_hosts) == {host}
        assert r["jax_loaded"] == []


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
