"""The port's checkpoints (``tcgnn_tpu_torch.utils.checkpoint``) and the
trainer's ``--save_params`` / ``--load_params`` / ``--checkpoint_dir`` /
``--resume``.

Mirrors the JAX package's checkpoint tests (``tests/test_training_quality.py``:
the parameter roundtrip, the shape mismatch, the training-state roundtrip
with ``keep`` and ``LATEST``, the trainer's resume).  Besides: on the CPU a
run interrupted at a checkpoint and resumed ends with the final loss and
parameters of an uninterrupted run, bit for bit, dropout on (the dropout
generator's state travels in the checkpoint); a resumed port run and a
resumed JAX run from the same parameters agree to the trainer parity tests'
``rtol=1e-4``; the parameters round-trip exactly through the CLI on one
device and on a 2x1 mesh.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tcgnn_tpu import train as jax_train
from tcgnn_tpu.models import nets as jax_nets
from tcgnn_tpu.utils import checkpoint as jax_ckpt
from tcgnn_tpu_torch import train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.models import GNN, init_net
from tcgnn_tpu_torch.utils import checkpoint as ckpt

# The JAX package's trainer resume test's run.
RUN = ["--dataset", "rand_600_3000", "--dim", "8", "--classes", "3", "--hidden", "8",
       "--model", "gcn", "--blk_h", "32", "--blk_w", "32", "--edge_chunk", "32"]


def trained_net(epochs=10):
    n = 300
    rp, ci = coo_to_csr(*powerlaw_graph(n, 1500, seed=2), n)
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=32, blk_w=32), device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((n, 8), np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    net = init_net(torch.Generator().manual_seed(2), "gcn", 8, 8, 3, 2)
    opt = torch.optim.Adam(net.parameters(), lr=0.01)
    step = train.make_train_step(g, net, x, y, opt, 0.5, generator=torch.Generator().manual_seed(3))
    for _ in range(epochs):
        step()
    return net, opt


def test_checkpoint_roundtrip(tmp_path):
    net, _ = trained_net()
    written = ckpt.save(str(tmp_path / "params"), net)
    assert written.endswith(".pt")
    like = GNN("gcn", [8, 8, 3])
    for p in like.parameters():
        torch.nn.init.zeros_(p)
    restored = ckpt.restore(str(tmp_path / "params"), like)  # ".pt" found
    for a, b in zip(net.parameters(), restored.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = ckpt.save(str(tmp_path / "p"), GNN("gcn", [4, 3]))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(path, GNN("gcn", [5, 3]))
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.restore(path, GNN("gcn", [4, 3]).to(torch.float64))


def test_state_checkpoint_roundtrip_and_latest(tmp_path):
    """save_state/restore_state: parameters, optimizer state (Adam's moments
    and step counts), epoch and dropout generator round-trip exactly;
    ``LATEST`` names the newest complete snapshot; ``keep`` prunes."""
    net, opt = trained_net(epochs=3)
    d = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    ckpt.save_state(d, net, opt, epoch=2)
    want = [p.detach().clone() for p in net.parameters()]
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)
    ckpt.save_state(d, net, opt, epoch=4)
    ckpt.save_state(d, net, opt, epoch=6, generator=gen, keep=1)  # keep=1 drops the older
    assert sorted(f for f in os.listdir(d) if f.startswith("state_")) == ["state_00000006.pt"]
    net6, opt6 = trained_net(epochs=1)
    gen6 = torch.Generator().manual_seed(99)
    epoch, restored = ckpt.restore_state(d, net6, opt6, gen6)
    assert epoch == 6 and restored is gen6
    assert torch.equal(torch.rand(4, generator=gen6), torch.rand(4, generator=gen))
    ckpt.save_state(d, net, opt, epoch=2)
    with torch.no_grad():
        for p, w in zip(net.parameters(), want):
            p.copy_(w)
    ckpt.save_state(d, net, opt, epoch=4)
    net4, opt4 = trained_net(epochs=1)
    epoch, restored = ckpt.restore_state(d, net4, opt4, torch.Generator())
    assert epoch == 4 and restored is None  # this snapshot holds no generator
    for a, b in zip(net4.parameters(), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got, ref = opt4.state_dict(), opt.state_dict()
    for i, s in ref["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(got["state"][i][k], v, rtol=0, atol=0)
    assert ckpt.restore_state(str(tmp_path / "empty"), net4, opt4) is None


def test_trainer_resume_continues_from_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = [*RUN, "--epochs", "6", "--checkpoint_dir", d, "--checkpoint_every", "2",
            "--device", "cpu"]
    train.main(args)
    assert (tmp_path / "ck" / "LATEST").exists()
    capsys.readouterr()
    r = train.main(args + ["--resume", "--epochs", "8"])
    out = capsys.readouterr().out
    assert "# resumed at epoch 6" in out and "Final loss" in out and r["resumed_at"] == 6
    r = train.main(args + ["--resume", "--epochs", "8"])
    assert "# checkpoint epoch 8 >= --epochs; no-op" in capsys.readouterr().out
    assert r["final_loss"] is None


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Dropout on: 9 warm-up and 6 timed epochs with checkpoints every 2,
    then a resumed run to 8, against 9 + 8 epochs in one run."""
    d = str(tmp_path / "ck")
    cpu = [*RUN, "--device", "cpu", "--dropout", "0.5"]
    train.main([*cpu, "--epochs", "6", "--checkpoint_dir", d, "--checkpoint_every", "2"])
    resumed = train.main([*cpu, "--epochs", "8", "--checkpoint_dir", d, "--checkpoint_every",
                          "2", "--resume", "--save_params", str(tmp_path / "resumed")])
    whole = train.main([*cpu, "--epochs", "8", "--save_params", str(tmp_path / "whole")])
    assert resumed["resumed_at"] == 6 and resumed["final_loss"] == whole["final_loss"]
    a = torch.load(tmp_path / "resumed.pt", weights_only=True)["params"]
    b = torch.load(tmp_path / "whole.pt", weights_only=True)["params"]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def final_loss(out: str) -> float:
    return float([ln for ln in out.splitlines() if ln.startswith("Final loss:")][-1].split()[-1])


def test_resume_matches_jax(tmp_path, capsys):
    """The same parameters into both CLIs, no dropout, one head: 6 epochs
    with checkpoints every 2, then resumed to 8."""
    params = jax_nets.init_net(jax.random.PRNGKey(5), "gcn", 8, 8, 3, 2)
    jax_params = jax_ckpt.save(str(tmp_path / "jax_params"), params)
    net = GNN("gcn", [8, 8, 3])
    net.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in params])
    port_params = ckpt.save(str(tmp_path / "port_params"), net)
    common = [*RUN, "--no_dropout", "--n_heads", "1", "--checkpoint_every", "2"]
    losses = []
    for main, extra, load in ((jax_train.main, [], jax_params),
                              (train.main, ["--device", "cpu"], port_params)):
        d = str(tmp_path / f"ck{len(losses)}")
        run = [*common, *extra, "--checkpoint_dir", d, "--load_params", load]
        main([*run, "--epochs", "6"])
        capsys.readouterr()
        main([*run, "--epochs", "8", "--resume"])
        out = capsys.readouterr().out
        assert "# resumed at epoch 6" in out
        losses.append(final_loss(out))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


@pytest.mark.parametrize("extra", [
    ["--dataset", "rand_200_1000", "--blk_h", "16", "--blk_w", "16"],
    # a graph the mesh keeps on its dense-tile route (rand_100_400 is BD)
    ["--dataset", "rand_2000_8000", "--blk_h", "16", "--blk_w", "8", "--mesh", "2x1"],
], ids=["one_device", "mesh"])
def test_cli_saves_and_loads_params(tmp_path, capsys, extra):
    """``--load_params`` restores every parameter exactly: a run that loads
    them with learning rate 0 saves them back bit for bit."""
    cli = [*extra, "--dim", "6", "--classes", "3", "--device", "cpu"]
    train.main([*cli, "--epochs", "2", "--save_params", str(tmp_path / "a")])
    assert f"# saved params to {tmp_path / 'a.pt'}" in capsys.readouterr().out
    train.main([*cli, "--epochs", "1", "--lr", "0", "--load_params", str(tmp_path / "a.pt"),
                "--save_params", str(tmp_path / "b")])
    assert "# restored params from" in capsys.readouterr().out
    a = torch.load(tmp_path / "a.pt", weights_only=True)["params"]
    b = torch.load(tmp_path / "b.pt", weights_only=True)["params"]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    fresh = train.main([*cli, "--epochs", "1", "--lr", "0", "--save_params",
                        str(tmp_path / "c")])
    c = torch.load(tmp_path / "c.pt", weights_only=True)["params"]
    assert not all(torch.equal(a[k], c[k]) for k in a) and np.isfinite(fresh["final_loss"])
    if "--mesh" in extra:
        with pytest.raises(ValueError, match="not taken with --mesh"):
            train.main([*cli, "--checkpoint_dir", str(tmp_path / "ck")])
