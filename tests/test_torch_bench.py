"""The port's bench harness (``tcgnn_tpu_torch.bench``) against the JAX
package's (``tcgnn_tpu.bench``), on the CPU at small sizes.

The tile counters give JAX's counts and files; the incumbents give JAX's
incumbents' outputs and gradients (rtol 1e-4) and the port's ``TiledGraph``
ones; the baseline's first loss is the port trainer's; the ledger's stages
are JAX's ``_agg_stages`` on its CPU rule; the sweep writes the three CSV
contracts; accuracy parity passes and its forward logits are JAX's with the
parameters carried across; ``init_net(init="uniform")`` draws JAX's
distribution.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.bench import accuracy_parity as jax_parity
from tcgnn_tpu.bench import baseline as jax_baseline
from tcgnn_tpu.bench import epoch_ledger as jax_ledger
from tcgnn_tpu.bench import tc_block_count as jax_tc
from tcgnn_tpu.data import dataset as jax_data
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.bench import (
    accuracy_parity,
    baseline,
    epoch_ledger,
    log2csv,
    proc_prof,
    roofline_bound,
    sweep,
    tc_block_count,
)
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.data import dataset as data_lib
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, init_net
from tcgnn_tpu_torch.sgt import native

TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "golden_tiny.npz")
CPU = ["--device", "cpu"]


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n)


def directed_graph(n=200, e=1200, seed=4):
    """A directed power-law graph: the incumbents' backwards need A^T."""
    src, dst = powerlaw_graph(n, e, seed=seed)
    keep = (src < dst) | (src % 3 == 0)
    return coo_to_csr(src[keep], dst[keep], n)


def spec_counts(ptr, cols, blk_h, blk_w):
    """Direct port of 3_cnt_TC_blk_SpMM.py:55-84's per-window logic."""
    n = len(ptr) - 1
    naive = opt = 0
    for start in range(0, n, blk_h):
        end = min(start + blk_h, n)
        uniq = sorted(set(cols[ptr[start]: ptr[end]].tolist()))
        opt += -(-len(uniq) // blk_w)
        i = j = 0
        while i < len(uniq) and j < len(uniq):
            cap = uniq[i] + blk_w
            while j < len(uniq) and uniq[j] < cap:
                j += 1
            i = j
            naive += 1
    return naive, opt


# ---- tile counters ------------------------------------------------------------

@pytest.mark.parametrize("blk", [(16, 8), (16, 16), (128, 128)])
def test_count_tiles_matches_jax_and_spec(blk):
    ptr, cols = make_graph(500, 3000, seed=1)
    got = tc_block_count.count_tiles(ptr, cols, *blk)
    assert got == jax_tc.count_tiles(ptr, cols, *blk)
    assert got == spec_counts(ptr, cols, *blk)


@pytest.mark.parametrize("blk", [(16, 8), (128, 128)])
def test_count_tiles_python_path_matches_native(blk, monkeypatch):
    ptr, cols = make_graph(400, 2500, seed=3)
    want = tc_block_count.count_tiles(ptr, cols, *blk)
    monkeypatch.setattr(native, "available", lambda: False)
    assert tc_block_count.count_tiles(ptr, cols, *blk) == want


def test_naive_never_below_opt():
    ptr, cols = make_graph(300, 2500, seed=9)
    naive, opt = tc_block_count.count_tiles(ptr, cols, 16, 8)
    assert naive >= opt  # the reference's "Duplicate Edges" guard invariant


def test_native_naive_count_matches_spec():
    assert native.available(), native.error()
    ptr, cols = make_graph(400, 2000, seed=2)
    out = native.naive_count(np.ascontiguousarray(ptr, np.int64),
                             np.ascontiguousarray(cols, np.int32), 16, 8)
    assert out.sum() == spec_counts(ptr, cols, 16, 8)[0]


def test_tc_block_count_files_match_jax(tmp_path, monkeypatch):
    """Tile counts do not depend on the chip: both packages write the same
    three files, byte for byte."""
    names = ["cora", "PROTEINS_full"]
    for pkg, main in (("port", tc_block_count.main), ("jax", jax_tc.main)):
        (tmp_path / pkg).mkdir()
        main(["--datasets", *names, "--out_prefix", str(tmp_path / pkg / "cnt")])
    for geom in tc_block_count.GEOMETRIES:
        port = (tmp_path / "port" / f"cnt_{geom}.csv").read_text()
        assert port == (tmp_path / "jax" / f"cnt_{geom}.csv").read_text()
        assert port.splitlines()[0] == "dataset,origin,reduced,reduction (%)"
        assert len(port.splitlines()) == 1 + len(names)


# ---- log2csv and proc_prof ------------------------------------------------------

def test_log2csv_scrape():
    log = [
        "Namespace(dataset='cora', dim=1433)",
        "Prep. (ms):\t12.3",
        "Train (ms):\t 3.141",
        "Namespace(dataset='pubmed', dim=500)",
        "Train (ms):\t 2.718",
    ]
    assert log2csv.scrape(log) == [("cora", 3.141), ("pubmed", 2.718)]


def test_log2csv_scrapes_port_trainer_and_baseline(tmp_path, capsys):
    """The trainer's and the baseline's own output (``print(args)``, the
    ``Prep`` lines, ``Train (ms):``) scrapes to one row a run."""
    common = ["--dim", "8", "--classes", "3", "--epochs", "2", *CPU]
    r1 = port_train.main(["--dataset", "rand_300_1500", *common])
    r2 = baseline.main(["--dataset", "rand_400_2000", *common])
    out = capsys.readouterr().out
    rows = log2csv.scrape(out.splitlines())
    assert [name for name, _ in rows] == ["rand_300_1500", "rand_400_2000"]
    np.testing.assert_allclose([ms for _, ms in rows], [r1["train_ms"], r2["train_ms"]],
                               atol=1e-3)
    log = tmp_path / "run.log"
    log.write_text(out)
    assert log2csv.main([str(log)]) == 0
    lines = (tmp_path / "run.csv").read_text().splitlines()
    assert lines[0] == "dataset,Avg.Epoch (ms)" and lines[1].startswith("rand_300_1500,")


def test_proc_prof_reduces_csvs(tmp_path, capsys):
    p1 = tmp_path / "a.csv"
    p1.write_text("dataset,Avg.Epoch (ms)\ncora,2.0\npubmed,4.0\n")
    p2 = tmp_path / "b.csv"
    p2.write_text("dataset,Avg.Epoch (ms)\ncora,4.0\npubmed,8.0\n")
    columns, by_key = proc_prof.reduce_csvs([str(p1), str(p2)])
    assert columns == ["Avg.Epoch (ms)"]
    assert by_key[("cora", "Avg.Epoch (ms)")] == [2.0, 4.0]
    assert np.mean(by_key[("pubmed", "Avg.Epoch (ms)")]) == 6.0
    assert proc_prof.main([str(p1), str(p2)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["dataset,avg Avg.Epoch (ms)", "cora,3.000", "pubmed,6.000", "<overall>,4.500"]


# ---- the incumbents -------------------------------------------------------------

JAX_IMPLS = {"gather": jax_baseline.XlaBaselineGraph, "sparse": jax_baseline.BcooBaselineGraph}
OPS = ("spmm", "spmm_weighted", "sddmm")


def op_inputs(n, e, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal(e, dtype=np.float32)
    return x, w


def port_vjp(graph, op, x, w, r):
    """Output and gradients (x, and w for the weighted SpMM) of ``op`` with
    cotangent ``r``, through torch autograd."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = graph.spmm_weighted(xt, wt) if op == "spmm_weighted" else getattr(graph, op)(xt)
    out.backward(torch.from_numpy(r))
    grads = [xt.grad.numpy()] + ([wt.grad.numpy()] if op == "spmm_weighted" else [])
    return out.detach().numpy(), grads


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_incumbent_matches_jax_incumbent(impl, op):
    ptr, cols = directed_graph()
    n, e = len(ptr) - 1, len(cols)
    x, w = op_inputs(n, e)
    graph = baseline.IMPLS[impl](ptr, cols, n, device="cpu")
    jgraph = JAX_IMPLS[impl](ptr, cols, n)
    if op == "spmm_weighted":
        want, vjp = jax.vjp(jgraph.spmm_weighted, jnp.asarray(x), jnp.asarray(w))
    else:
        want, vjp = jax.vjp(getattr(jgraph, op), jnp.asarray(x))
    r = np.random.default_rng(1).standard_normal(want.shape, dtype=np.float32)
    got, grads = port_vjp(graph, op, x, w, r)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for g, wg in zip(grads, vjp(jnp.asarray(r))):
        np.testing.assert_allclose(g, np.asarray(wg), **TOL)


@pytest.mark.parametrize("block_diag", [False, True])
@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_incumbent_matches_tiled_graph(impl, block_diag):
    """The mirror of the JAX ``test_xla_baseline_matches_tcgnn_forward``,
    every op's output and gradients, on the condensed and the BD route."""
    if block_diag:
        ds = port_train.load_dataset(argparse.Namespace(
            dataset="PROTEINS_full", data_dir="", dim=8, classes=2, seed=0))
        ptr, cols, n = ds.row_pointers, ds.column_index, ds.num_nodes
    else:
        ptr, cols = directed_graph()
        n = len(ptr) - 1
    tg = TiledGraph(ptr, cols, n, TileConfig(blk_h=16, blk_w=16), device="cpu",
                    block_diag=block_diag)
    assert tg.block_diag == block_diag
    graph = baseline.IMPLS[impl](ptr, cols, n, device="cpu")
    x, w = op_inputs(n, len(cols), d=16, seed=2)
    rng = np.random.default_rng(3)
    for op in OPS:
        r = rng.standard_normal((len(cols),) if op == "sddmm" else (n, 16), dtype=np.float32)
        want, want_grads = port_vjp(tg, op, x, w, r)
        got, grads = port_vjp(graph, op, x, w, r)
        np.testing.assert_allclose(got, want, **TOL)
        for g, wg in zip(grads, want_grads):
            np.testing.assert_allclose(g, wg, **TOL)


@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_baseline_main_runs_and_reports(impl, capsys):
    r = baseline.main(["--dataset", "rand_500_2500", "--dim", "8", "--classes", "3",
                       "--hidden", "8", "--epochs", "3", "--model", "gcn", "--impl", impl, *CPU])
    out = capsys.readouterr().out
    assert set(r) == {"impl", "prep_ms", "first_loss", "final_loss", "train_ms", "step"}
    assert r["step"] == "eager"  # the CPU replays nothing
    assert r["train_ms"] > 0 and np.isfinite(r["final_loss"])
    assert "Prep. (ms):" in out and "Final loss:" in out and "Train (ms):" in out


@pytest.mark.parametrize("model", ["gcn", "agnn"])
@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_baseline_first_loss_matches_trainer(impl, model):
    """The same parameters from the same seed and the same loss: with no
    dropout the first epoch's loss is the port trainer's."""
    args = ["--dataset", "rand_600_3000", "--dim", "12", "--classes", "3", "--epochs", "2",
            "--model", model, "--no_dropout", "--num_layers", "2", *CPU]
    want = port_train.main(args)["first_loss"]
    got = baseline.main([*args, "--impl", impl])["first_loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_baseline_takes_the_library_loss(impl, monkeypatch):
    """The incumbents are yardsticks: their step takes
    ``torch.nn.functional.nll_loss``, never the port's NLL kernel pair."""
    library = torch.nn.functional.nll_loss
    calls = []

    def counted(logp, y):
        calls.append(1)
        return library(logp, y)

    monkeypatch.setattr(torch.nn.functional, "nll_loss", counted)
    port_loss = port_train.F.nll_loss
    before = (port_loss.launches, port_loss.plain_calls)
    baseline.main(["--dataset", "rand_300_1500", "--dim", "8", "--classes", "3",
                   "--hidden", "8", "--epochs", "2", "--model", "gcn", "--impl", impl, *CPU])
    assert (port_loss.launches, port_loss.plain_calls) == before
    assert len(calls) > 0


def test_training_path_does_not_import_the_incumbents():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for f in ("train.py", "graph.py"):
        src = open(os.path.join(root, "tcgnn_tpu_torch", f)).read()
        assert "bench" not in src, f


# ---- the ledger and the floor -------------------------------------------------------

def test_epoch_ledger_smoke(tmp_path):
    """The JAX test's checks: stages measured, summed, and written."""
    out = tmp_path / "ledger.csv"
    rows = epoch_ledger.main(["--datasets", "rand_1500_9000", "--epochs", "12",
                              "--dtype", "float32", "--reorder", "none", "--out", str(out),
                              *CPU])
    assert len(rows) == 1
    r = rows[0]
    assert r["epoch_ms"] > 0 and r["dense_rest_ms"] > 0
    assert len(r["agg_stages"]) >= 3  # L1 fwd + L2 fwd + L2 bwd
    assert abs(r["stage_sum_ms"] - (r["dense_rest_ms"] + r["agg_ms"])) < 1e-6
    lines = out.read_text().splitlines()
    assert lines[0] == ",".join(jax_ledger.COLUMNS)
    assert lines[1].startswith("rand_1500_9000,")


@pytest.mark.parametrize("block_diag", [False, True])
@pytest.mark.parametrize("kind", ["gcn", "gin"])
@pytest.mark.parametrize("din", [12, 150, 500])
def test_agg_stages_match_jax(kind, din, block_diag):
    graph = argparse.Namespace(block_diag=block_diag)
    for layers, hidden in ((2, 16), (3, 64)):
        assert (epoch_ledger._agg_stages(graph, kind, din, hidden, 7, layers)
                == jax_ledger._agg_stages(graph, kind, din, hidden, 7, layers))


def test_identity_graph_keeps_the_schedule():
    ptr, cols = make_graph(300, 1500, seed=5)
    tg = TiledGraph(ptr, cols, 300, TileConfig(blk_h=16, blk_w=16), device="cpu")
    ident = epoch_ledger._IdentityGraph(tg)
    x = torch.randn(300, 8)
    assert ident.spmm(x) is x
    assert ident.block_diag == tg.block_diag and ident.config == tg.config


def test_bounds():
    assert roofline_bound.bound(3.35e12, 0) == (1e3, "bytes")
    assert roofline_bound.bound(0, 67e12) == (1e3, "operations")
    ms, by = roofline_bound.csr_bound(10, 4, 100, 0, weighted=True)
    assert by == "bytes" and ms == pytest.approx((40 + 20 + 40 + 100) / 3.35e12 * 1e3)
    floor, by, hbm = roofline_bound.spmm_floor(1000, 10_000, 96)
    assert by == "bytes" and floor == hbm
    stages = [("spmm@L1", 16, False), ("spmm@L2", 16, False), ("spmm_t@L2", 16, True)]
    ef = roofline_bound.epoch_floor(stages, 1000, 10_000, [96, 16, 4])
    assert ef > 3 * roofline_bound.spmm_floor(1000, 10_000, 16)[0]


def test_roofline_main_reads_the_sweep(tmp_path):
    sk = tmp_path / "sk.csv"
    sk.write_text("dataset,SAG avg (ms)\ncora,0.5\n")
    gcn = tmp_path / "gcn.csv"
    gcn.write_text("dataset,Avg.Epoch (ms)\ncora,2.0\nPROTEINS_full,3.0\n")
    out = tmp_path / "roof.csv"
    rows = roofline_bound.main(["--datasets", "cora", "PROTEINS_full", "--single_kernel_csv",
                                str(sk), "--gcn_csv", str(gcn), "--out", str(out), *CPU])
    assert [(r[0], r[1]) for r in rows] == [("cora", "condensed"), ("PROTEINS_full", "bd")]
    lines = out.read_text().splitlines()
    assert lines[0] == ("dataset,path,spmm_floor_ms_d96,hbm_ms,sag_measured_ms,sag_vs_floor,"
                        "epoch_floor_ms,epoch_measured_ms,epoch_vs_floor")
    cora = lines[1].split(",")
    assert cora[4] == "0.500" and float(cora[5]) == pytest.approx(0.5 / float(cora[2]), rel=1e-2)
    assert lines[2].split(",")[4] == ""  # no single-kernel reading for PROTEINS_full


# ---- the sweep --------------------------------------------------------------------

@pytest.fixture
def one_row(monkeypatch, tmp_path):
    monkeypatch.setattr(sweep, "AE_TABLE", [("rand_600_3000", 6, 3)])
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("impl", ["gather", "sparse"])
def test_sweep_writes_bench_and_fig_csvs(one_row, impl):
    rows = sweep.main(["--epochs", "2", "--baseline_epochs", "2", "--baseline_impl", impl,
                       *CPU])
    (name, base, ours, ours_h, route), = rows
    assert name == "rand_600_3000" and base > 0 and ours > 0 and ours_h > 0
    assert route == (True, False, True)  # (dense_tiles, streamed, block_diag)
    bench = (one_row / "1_bench_gcn.csv").read_text().splitlines()
    assert bench[0] == "dataset,Avg.Epoch (ms)" and bench[1].startswith("rand_600_3000,")
    fig = (one_row / "Fig_6a_torch_gcn.csv").read_text().splitlines()
    assert fig[0] == ("dataset,torch_baseline,tcgnn_torch,speedup,tcgnn_torch_hoisted,"
                      "speedup_hoisted,tcgnn_epochs,baseline_epochs,baseline_step")
    cells = fig[1].split(",")
    assert cells[0] == "rand_600_3000" and cells[-3:] == ["2", "2", "eager"]  # the CPU's
    assert float(cells[3]) == pytest.approx(float(cells[1]) / float(cells[2]), rel=1e-2)


def test_sweep_agnn_skips_the_hoisted_run(one_row, monkeypatch):
    calls = []
    real = port_train.main
    monkeypatch.setattr(port_train, "main", lambda argv: calls.append(argv) or real(argv))
    rows = sweep.main(["--model", "agnn", "--num_layers", "2", "--epochs", "2",
                       "--baseline_epochs", "2", *CPU])
    assert len(calls) == 1 and "--no_hoist" in calls[0]
    assert rows[0][2] == rows[0][3]
    assert (one_row / "Fig_6a_torch_agnn.csv").exists()


def test_sweep_single_kernel_csv(one_row, monkeypatch):
    monkeypatch.setattr(port_train, "SAG_ROUNDS", 4)
    (name, stats), = sweep.main(["--single_kernel", *CPU])
    assert name == "rand_600_3000" and stats["ms"] > 0
    lines = (one_row / "2_tcgnn_single_kernel.csv").read_text().splitlines()
    assert lines[0] == ("dataset,SAG avg (ms),edges_per_s,useful_TFLOPs,tile_TFLOPs,MFU (%),"
                        "SDDMM avg (ms),sddmm_edges_per_s")
    cells = lines[1].split(",")
    assert cells[0] == "rand_600_3000" and all(float(c) > 0 for c in cells[1:3])


def test_sweep_failed_run_writes_no_row(one_row, monkeypatch, capsys):
    monkeypatch.setattr(sweep, "AE_TABLE", [("rand_600_3000", 6, 3), ("no_such_graph", 6, 3)])
    rows = sweep.main(["--epochs", "2", "--baseline_epochs", "2", *CPU])
    assert rows[1][1:4] == (None, None, None)
    assert "Traceback" in capsys.readouterr().err
    bench = (one_row / "1_bench_gcn.csv").read_text().splitlines()
    assert len(bench) == 2 and bench[1].startswith("rand_600_3000,")


def test_ae_sweep_prefers_real_npz(tmp_path, monkeypatch, capsys):
    """A real-contract .npz in --data_dir flows through the sweep and the
    trainer and is flagged REAL by the loader's provenance line."""
    rng = np.random.default_rng(0)
    n, e = 300, 1500
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    np.savez(tmp_path / "citeseer.npz", src_li=np.concatenate([src, dst]),
             dst_li=np.concatenate([dst, src]), num_nodes=np.int64(n))
    monkeypatch.chdir(tmp_path)
    sweep.main(["--model", "gcn", "--datasets", "citeseer", "--epochs", "3",
                "--data_dir", str(tmp_path), "--skip_baseline", *CPU])
    out = capsys.readouterr().out
    assert "REAL" in out and "citeseer.npz" in out, out
    rows = (tmp_path / "1_bench_gcn.csv").read_text().strip().splitlines()
    assert rows[0] == "dataset,Avg.Epoch (ms)" and rows[1].startswith("citeseer,")
    assert not (tmp_path / "Fig_6a_torch_gcn.csv").exists()


# ---- accuracy parity and the uniform init ------------------------------------------

def test_accuracy_parity_harness_on_golden_fixture():
    assert accuracy_parity.main(["--epochs", "60", "--models", "gcn", *CPU]) == 0


@pytest.mark.parametrize("kind", ["gcn", "agnn"])
def test_accuracy_parity_logits_match_jax(kind):
    """Forward logits of the tiled graph and of the dense oracle equal the
    JAX package's, on the golden fixture with JAX's parameters."""
    ds = data_lib.load_npz(GOLDEN, dim=16, num_classes=2)
    jds = jax_data.load_npz(GOLDEN, dim=16, num_classes=2)
    classes = int(ds.y.max()) + 1
    params = jax_nets.init_net(jax.random.PRNGKey(7), kind, ds.x.shape[1], 16, classes, 2,
                               init="uniform")
    net = GNN(kind, [ds.x.shape[1], 16, classes], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    norm = 1.0 / ds.norm_degrees() if kind == "gcn" else None
    jnorm = None if norm is None else jnp.asarray(norm)
    tnorm = None if norm is None else torch.from_numpy(norm)
    x = torch.from_numpy(ds.x)
    jtiled = JaxTiledGraph(jds.row_pointers, jds.column_index, jds.num_nodes)
    want = np.asarray(jax_nets.apply_net(params, kind, jnp.asarray(jds.x), jtiled, norm=jnorm))
    joracle = jax_parity.DenseOracleGraph(jds.row_pointers, jds.column_index, jds.num_nodes)
    want_o = np.asarray(jax_nets.apply_net(params, kind, jnp.asarray(jds.x), joracle, norm=jnorm))
    tiled = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, device="cpu")
    oracle = accuracy_parity.DenseOracleGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                                              device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(net(x, tiled, norm=tnorm).numpy(), want, **TOL)
        np.testing.assert_allclose(net(x, oracle, norm=tnorm).numpy(), want_o, **TOL)


@pytest.mark.parametrize("kind", ["gcn", "gin"])
def test_init_uniform_bounds_and_jax_params(kind):
    dims = (40, 16, 5)
    net = init_net(torch.Generator().manual_seed(3), kind, dims[0], dims[1], dims[2], 2,
                   init="uniform")
    for w in (p.detach() for p in net.weights):
        bound = 1.0 / np.sqrt(w.shape[1])
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
        assert abs(float(w.mean())) < 0.2 * bound
    ref = init_net(torch.Generator().manual_seed(3), kind, *dims, 2)
    assert float(ref.weights[0].detach().abs().max()) > 1.0  # randn, not uniform
    params = jax_nets.init_net(jax.random.PRNGKey(3), kind, *dims, 2, init="uniform")
    carried = GNN(kind, list(dims), device="cpu")
    carried.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    for w, p in zip(carried.weights, params):
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(p["weights"]))
    with pytest.raises(ValueError):
        init_net(torch.Generator(), kind, *dims, 2, init="xavier")
