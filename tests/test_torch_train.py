"""The port's models and trainer against the JAX package.

Identical parameters (JAX's, loaded through ``GNN.params_from_jax``), the
same numpy features and labels, dropout off: logits, loss and every
gradient match the JAX ``apply_net`` and ``jax.grad`` at f32
``rtol=atol=1e-5``, and a 20-step Adam loss trajectory matches the JAX
``make_train_step`` at ``rtol=1e-4`` (Adam divides by the root of the
second moment, which magnifies last-bit differences of the gradients).
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
import torch.nn.functional as F

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.train import build_argparser as jax_build_argparser
from tcgnn_tpu.train import make_train_step as jax_make_train_step
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, aggregate_first, hoist_l1_aggregate, init_net

F32 = dict(rtol=1e-5, atol=1e-5)
N, CLASSES, HIDDEN = 150, 4, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup(kind, dim, seed=0):
    src, dst = powerlaw_graph(N, 800, seed=seed + 3)
    keep = (src < dst) | (src % 3 == 0)  # directed: the backward needs A^T
    rp, ci = coo_to_csr(src[keep], dst[keep], N)
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=16), device="cpu", block_diag=False)
    jg = JaxTiledGraph(rp, ci, N, JaxTileConfig(blk_h=16, blk_w=16), dense_tiles=True,
                       block_diag=False)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, dim), dtype=np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    params = jax_nets.init_net(jax.random.PRNGKey(seed), kind, dim, HIDDEN, CLASSES, 2,
                               init="uniform")
    net = GNN(kind, [dim, HIDDEN, CLASSES], device="cpu")
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    return g, jg, x, y, params, net


@pytest.mark.parametrize("kind", ["gcn", "gin"])
@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("dim", [12, 150])  # aggregate first / project first in GCN layer 1
def test_logits_loss_grads_match_jax(kind, hoist, dim):
    g, jg, x, y, params, net = setup(kind, dim)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    l1j = jax_nets.hoist_l1_aggregate(kind, xj, jg) if hoist else None

    def loss_fn(p):
        logp = jax_nets.apply_net(p, kind, xj, jg, l1_agg=l1j)
        return -jnp.mean(jnp.take_along_axis(logp, yj[:, None], axis=1)), logp

    (want_loss, want_logp), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    xt = torch.from_numpy(x)
    l1 = hoist_l1_aggregate(kind, xt, g) if hoist else None
    logp = net(xt, g, l1_agg=l1)
    loss = F.nll_loss(logp, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(want_logp), **F32)
    np.testing.assert_allclose(loss.item(), float(want_loss), **F32)
    for w, wg in zip(net.weights, want_grads):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(wg["weights"]), **F32)


def test_gcn_norm_matches_jax():
    g, jg, x, y, params, net = setup("gcn", 12, seed=1)
    norm = np.random.default_rng(2).uniform(0.2, 1.0, N).astype(np.float32)
    want = jax_nets.apply_net(params, "gcn", jnp.asarray(x), jg, norm=jnp.asarray(norm))
    got = net(torch.from_numpy(x), g, norm=torch.from_numpy(norm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kind", ["gcn", "gin"])
@pytest.mark.parametrize("hoist", [False, True])
def test_adam_trajectory_matches_jax(kind, hoist):
    g, jg, x, y, params, net = setup(kind, 24, seed=4)
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jg, kind, jnp.asarray(x), jnp.asarray(y), opt,
                                dropout_rate=0.0, hoist=hoist)
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


@pytest.mark.parametrize("kind", ["gcn", "gin"])
def test_hoist_is_exact_with_dropout(kind):
    """Hoisting A X out of the epoch loop changes nothing, dropout included
    (same generator seed, same masks)."""
    trajectories = []
    for hoist in (False, True):
        g, _, x, y, params, net = setup(kind, 20, seed=5)
        step = port_train.make_train_step(
            g, net, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.optim.Adam(net.parameters(), lr=0.01), dropout_rate=0.5, hoist=hoist,
            generator=torch.Generator().manual_seed(9),
        )
        trajectories.append([float(step()) for _ in range(6)])
    np.testing.assert_allclose(trajectories[0], trajectories[1], rtol=1e-5)


def test_init_net_is_seeded_randn():
    a = init_net(torch.Generator().manual_seed(3), "gcn", 10, 8, 3, 3)
    b = init_net(torch.Generator().manual_seed(3), "gcn", 10, 8, 3, 3)
    assert [tuple(w.shape) for w in a.weights] == [(10, 8), (8, 8), (8, 3)]
    for wa, wb in zip(a.weights, b.weights):
        torch.testing.assert_close(wa, wb)
    assert aggregate_first(128, 16) and not aggregate_first(129, 16)


def test_cli_prints_contract(capsys):
    r = port_train.main([
        "--dataset", "rand_200_1000", "--dim", "8", "--classes", "3", "--epochs", "3",
        "--blk_h", "16", "--blk_w", "16", "--device", "cpu", "--eval",
    ])
    out = capsys.readouterr().out
    for line in ("TC_Blocks:", "Exp_Edges:", "Prep. (ms):", "Prep host (ms):",
                 "Final loss:", "Train (ms):", "Acc train:"):
        assert line in out
    assert np.isfinite(r["final_loss"]) and r["tc_blocks"] > 0


@pytest.mark.parametrize("extra", [
    ["--dataset", "rand_200_1000", "--blk_h", "16", "--blk_w", "16"],
    # a graph the mesh keeps on its dense-tile route (rand_100_400 is BD)
    ["--dataset", "rand_2000_8000", "--blk_h", "16", "--blk_w", "8", "--mesh", "2x1"],
], ids=["one_device", "mesh"])
def test_cli_takes_jax_warmup_steps(monkeypatch, extra):
    """``--epochs 3`` makes 9 + 3 Adam updates, as the JAX CLI does
    (``step.many(..., 9)`` on one device, ``range(1, 10)`` on the mesh)."""
    steps = []
    adam_step = torch.optim.Adam.step

    def counting_step(self, *args, **kwargs):
        steps.append(1)
        return adam_step(self, *args, **kwargs)

    monkeypatch.setattr(torch.optim.Adam, "step", counting_step)
    r = port_train.main([*extra, "--dim", "6", "--classes", "3", "--epochs", "3",
                         "--device", "cpu"])
    assert len(steps) == 12 and np.isfinite(r["final_loss"])


@pytest.mark.parametrize("flag", [["--mesh", "2x1"]])
def test_cli_unported_paths_raise(capsys, flag):
    """``--mesh 2x1`` on ``rand_100_400``, a block-diagonal graph, trains on
    the distributed block-diagonal route (it raised before that route was
    ported; the name stays)."""
    r = port_train.main(["--dataset", "rand_100_400", "--device", "cpu", "--epochs", "3",
                         "--no_dropout", *flag])
    assert "block_diag=True mesh=2x1" in capsys.readouterr().out
    assert r["block_diag"] and r["split"] == (False, False)
    assert np.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]


def test_cli_agnn_prints_contract(capsys):
    r = port_train.main([
        "--dataset", "rand_200_1000", "--dim", "8", "--classes", "3", "--epochs", "3",
        "--blk_h", "16", "--blk_w", "16", "--device", "cpu", "--model", "agnn",
        "--n_heads", "2", "--hidden", "8",
    ])
    out = capsys.readouterr().out
    for line in ("TC_Blocks:", "Exp_Edges:", "Prep. (ms):", "Prep host (ms):",
                 "Final loss:", "Train (ms):"):
        assert line in out
    assert np.isfinite(r["final_loss"]) and r["tc_blocks"] > 0


def test_cli_defaults_match_jax():
    """Every option the two trainers share has the same default, so the same
    arguments build the same model (``--device`` and, for the mesh over
    processes, ``--dist_backend`` are the port's own)."""
    jax_opts = {a.dest: a.default for a in jax_build_argparser()._actions}
    port_opts = {a.dest: a.default for a in port_train.build_argparser()._actions}
    shared = sorted(set(jax_opts) & set(port_opts) - {"help"})
    assert {"dim", "classes", "reorder", "dataset", "hidden", "epochs"} <= set(shared)
    assert set(port_opts) - set(jax_opts) == {"device", "dist_backend"}
    assert {k: port_opts[k] for k in shared} == {k: jax_opts[k] for k in shared}


def test_cli_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--dataset", "rand_100_400", "--device", "cuda"])


def test_port_imports_no_jax(tmp_path):
    """In a fresh process (this one has JAX loaded by conftest), importing
    the port and running its CLI (GCN and AGNN, on the condensed route, on
    the block-diagonal route after ``--reorder rcm`` and ``--reorder
    community``, and on a 4x2 mesh; ``--single_kernel`` on one device and on
    the mesh; a checkpointed run resumed, and ``--save_params`` /
    ``--load_params``), importing every module of its bench harness,
    running one sweep row (the trainer twice and the baseline) loads neither
    JAX nor the JAX package; nor does the headline bench's cut CPU run, in a
    second fresh process (so that the first keeps its time limit to itself)."""
    code = (
        "import sys\n"
        "import tcgnn_tpu_torch\n"
        "from tcgnn_tpu_torch import train\n"
        "small = ['--dim', '6', '--classes', '3', '--blk_h', '16', '--blk_w', '8',"
        " '--device', 'cpu']\n"
        "for model in ('gcn', 'agnn'):\n"
        "    for extra in (['--dataset', 'rand_2000_8000'],"
        " ['--dataset', 'PROTEINS_full', '--reorder', 'rcm'],"
        " ['--dataset', 'PROTEINS_full', '--reorder', 'community']):\n"
        "        r = train.main([*extra, *small, '--epochs', '2', '--model', model])\n"
        "        assert r['block_diag'] == (extra[1] == 'PROTEINS_full'), r\n"
        "        assert r['host_pass'] == 'native', r\n"
        "    r = train.main(['--dataset', 'rand_2000_8000', *small, '--epochs', '2',"
        " '--model', model, '--mesh', '4x2'])\n"
        "    assert 'parallel' in repr(type(r['graph'])), r\n"
        "train.SAG_ROUNDS = 4\n"
        "for mesh in ([], ['--mesh', '4x2']):\n"
        "    r = train.main(['--dataset', 'rand_2000_8000', *small, '--single_kernel', *mesh])\n"
        "    assert 'sddmm_ms' in r, r\n"
        "ck = ['--dataset', 'rand_600_3000', *small, '--checkpoint_dir', sys.argv[1] + '/ck',"
        " '--checkpoint_every', '2']\n"
        "train.main([*ck, '--epochs', '4', '--save_params', sys.argv[1] + '/p'])\n"
        "r = train.main([*ck, '--epochs', '6', '--resume', '--load_params',"
        " sys.argv[1] + '/p.pt'])\n"
        "assert r['resumed_at'] == 4, r\n"
        "import importlib, os\n"
        "for m in ('datasets', 'log2csv', 'proc_prof', 'tc_block_count', 'baseline', 'sweep',"
        " 'epoch_ledger', 'roofline_bound', 'accuracy_parity'):\n"
        "    importlib.import_module('tcgnn_tpu_torch.bench.' + m)\n"
        "from tcgnn_tpu_torch.bench import sweep\n"
        "sweep.AE_TABLE = [('rand_600_3000', 6, 3)]\n"
        "os.chdir(sys.argv[1])\n"
        "(row,) = sweep.main(['--epochs', '2', '--baseline_epochs', '2', '--device', 'cpu'])\n"
        "assert all(v > 0 for v in row[1:4]), row\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tcgnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout and "Train (ms):" in proc.stdout
    assert "Reorder (ms):" in proc.stdout and "SGT pass:\tnative" in proc.stdout
    assert "=> SAG profiling avg (ms):" in proc.stdout
    assert "# resumed at epoch 4" in proc.stdout
    code = (
        "import sys\n"
        "from tcgnn_tpu_torch.bench import headline\n"
        "line = headline.main(['--device', 'cpu', '--epochs', '3', '--reps', '1',"
        " '--warmup', '1'])\n"
        "assert line['tc_blocks'] == 334 and line['backend'] == 'cpu', line\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tcgnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout and '"metric": "gcn_pubmed_epoch_ms"' in proc.stdout


def test_profile_union_counts_overlap_once():
    from tcgnn_tpu_torch.profiling import union_us

    assert union_us([]) == 0.0
    assert union_us([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (9.0, 10.0), (20.0, 21.5)]) == 9.5


def test_cli_profile_dir_on_cpu(tmp_path, capsys):
    """``--profile_dir`` traces the timed epochs into a Chrome trace; off the
    card the device figures are reported as not measured."""
    r = port_train.main(["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3",
                         "--epochs", "2", "--blk_h", "16", "--blk_w", "8", "--device", "cpu",
                         "--profile_dir", str(tmp_path)])
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert r["profile"]["busy_ms"] is None and r["profile"]["epochs"] == 2
    assert "device time not measured" in capsys.readouterr().out
    r = port_train.main(["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3",
                         "--epochs", "1", "--blk_h", "16", "--blk_w", "8", "--device", "cpu"])
    assert r["profile"] is None
