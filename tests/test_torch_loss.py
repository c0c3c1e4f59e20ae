"""The port's NLL loss (``ops/loss.py``): the plain version against
``F.nll_loss`` on the CPU, the wrapper's checks, and the training step's
loss taken through ``train.F.nll_loss``.

The tests marked ``gpu`` hold the kernel pair (``csrc/nll.cu``) to
``F.nll_loss`` and to a float64 sum at the benchmark graphs' N and C, to
itself across calls and across replays of a captured graph, and count its
launches in the captured step; they skip without a card.  Tolerances: the
kernel sums in double and rounds once, so its loss lies within one f32
rounding of the float64 mean (``rtol=2e-7``) and within ``F.nll_loss``'s own
f32 summation error of the library's (``rtol=1e-5``); both gradients are
``-(g / count)`` in f32 at the label and 0 elsewhere, so they are equal to
the bit.  The file imports no JAX, so it runs on the card too:
``python -m pytest tests/test_torch_loss.py --noconftest -q``.
"""

import re
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as torch_F

from tcgnn_tpu_torch import TileConfig, TiledGraph, train
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.models import init_net
from tcgnn_tpu_torch.ops import loss as loss_mod
from tcgnn_tpu_torch.ops import nll_loss, nll_loss_torch

# Not a multiple of the kernels' 256-thread blocks, nor of 4 (the
# backward's elements a thread) at an odd C.
N = 1037


def inputs(n, c, ignored, seed=0, device="cpu"):
    """Log-probabilities ``[n, c]`` and labels, a tenth of them -100 where
    ``ignored``, from a seed."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32) * 2)
    y = rng.integers(0, c, n)
    if ignored:
        y[rng.random(n) < 0.1] = loss_mod.IGNORE_INDEX
    return (torch.log_softmax(logits, dim=1).to(device),
            torch.from_numpy(y).to(device))


def loss_and_grad(fn, logp, y):
    leaf = logp.detach().clone().requires_grad_(True)
    loss = fn(leaf, y)
    loss.backward()
    return loss.detach(), leaf.grad


@pytest.mark.parametrize("ignored", [False, True], ids=["all-rows", "with-ignored"])
@pytest.mark.parametrize("c", [2, 22, 41])
def test_plain_version_matches_library(c, ignored):
    """The wrapper on CPU tensors runs the plain version: the library's
    loss within f32 summation error, and its gradient to the bit."""
    logp, y = inputs(N, c, ignored, seed=c)
    before = nll_loss.plain_calls
    got, got_grad = loss_and_grad(nll_loss, logp, y)
    want, want_grad = loss_and_grad(torch_F.nll_loss, logp, y)
    assert nll_loss.plain_calls == before + 1
    assert got.shape == () and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    assert torch.equal(got_grad, want_grad)
    if ignored:
        assert (got_grad[y == loss_mod.IGNORE_INDEX] == 0).all()
    exact = -logp.double()[y != -100].gather(1, y[y != -100, None])[:, 0].mean()
    torch.testing.assert_close(got.double(), exact, rtol=2e-6, atol=0)


@pytest.mark.parametrize("case", [
    ("logp float64", lambda lp, y: (lp.double(), y), TypeError),
    ("logp bfloat16", lambda lp, y: (lp.bfloat16(), y), TypeError),
    ("labels int32", lambda lp, y: (lp, y.int()), TypeError),
    ("logp 1-d", lambda lp, y: (lp[:, 0], y), ValueError),
    ("labels 2-d", lambda lp, y: (lp, y[:, None]), ValueError),
    ("rows differ", lambda lp, y: (lp, y[:-1]), ValueError),
], ids=lambda case: case[0])
def test_wrapper_refuses_wrong_operands(case):
    _, make, error = case
    logp, y = inputs(64, 5, False)
    before = nll_loss.plain_calls
    with pytest.raises(error):
        nll_loss(*make(logp, y))
    assert nll_loss.plain_calls == before


def test_a_label_out_of_range_raises_on_the_cpu():
    logp, y = inputs(64, 5, False)
    y[3] = 5
    with pytest.raises((IndexError, RuntimeError)):
        nll_loss(logp, y)


def make_step(device="cpu", n=300):
    src, dst = powerlaw_graph(n, 1500, seed=3)
    rp, ci = coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)
    g = TiledGraph(rp, ci, n, TileConfig(blk_h=16, blk_w=8), device=device, block_diag=False)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((n, 24)) * 0.3).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 4, n)).to(device)
    net = init_net(torch.Generator().manual_seed(5), "gcn", 24, 16, 4, 2, device=device)
    opt = train.make_optimizer(net.parameters(), 0.01, device)
    return train.make_train_step(g, net, x, y, opt, 0.5, hoist=False,
                                 generator=torch.Generator(device=device).manual_seed(6))


class _Doubled:
    """A stand-in for ``train.F``: twice the port's loss."""

    def __init__(self):
        self.calls = 0

    def nll_loss(self, logp, y):
        self.calls += 1
        return 2 * nll_loss(logp, y)


def test_the_step_takes_its_loss_through_train_F(monkeypatch):
    """``train.F`` is the port's loss module, and the step looks
    ``F.nll_loss`` up there at every call: swapping ``train.F`` for a
    stand-in changes what the step returns (so a fault planted there
    reaches the step)."""
    assert train.F is loss_mod
    before = nll_loss.plain_calls
    plain = make_step()()
    assert nll_loss.plain_calls == before + 1
    stand_in = _Doubled()
    monkeypatch.setattr(train, "F", stand_in)
    doubled = make_step()()
    assert stand_in.calls == 1
    torch.testing.assert_close(doubled, 2 * plain, rtol=0, atol=0)


# ---- on the card --------------------------------------------------------------

# (name, N, C): the benchmark graphs' nodes and classes.
CARD_SHAPES = [("yeast", 1_714_644, 2), ("amazon0505", 410_236, 22), ("reddit", 232_965, 41)]
NLL_KERNEL = re.compile(r"::(nll_forward_kernel|nll_backward_kernel)\(")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ignored", [False, True], ids=["all-rows", "with-ignored"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: s[0])
def test_kernel_matches_library(cuda, shape, ignored):
    _, n, c = shape
    logp, y = inputs(n, c, ignored, seed=n, device=cuda)
    before = nll_loss.launches
    got, got_grad = loss_and_grad(nll_loss, logp, y)
    want, want_grad = loss_and_grad(torch_F.nll_loss, logp, y)
    torch.cuda.synchronize()
    assert nll_loss.launches == before + 2
    keep = y != loss_mod.IGNORE_INDEX
    exact = -logp.double()[keep].gather(1, y[keep, None])[:, 0].mean()
    torch.testing.assert_close(got.double(), exact, rtol=2e-7, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(got_grad, want_grad)


@pytest.mark.gpu
def test_two_calls_give_the_same_bits(cuda):
    logp, y = inputs(*CARD_SHAPES[0][1:], True, seed=7, device=cuda)
    first, first_grad = loss_and_grad(nll_loss, logp, y)
    second, second_grad = loss_and_grad(nll_loss, logp, y)
    assert torch.equal(first, second) and torch.equal(first_grad, second_grad)


@pytest.mark.gpu
def test_a_replayed_graph_equals_eager_calls(cuda):
    """The loss and its gradient captured into a CUDA graph: each replay,
    over new log-probabilities copied into the captured input, equals an
    eager call on them to the bit (the ticket is zeroed before each launch,
    so every replay sums anew)."""
    _, n, c = CARD_SHAPES[1]
    logp, y = inputs(n, c, True, seed=1, device=cuda)
    leaf = logp.clone().requires_grad_(True)

    def fn():
        loss = nll_loss(leaf, y)
        (grad,) = torch.autograd.grad(loss, leaf)
        return loss, grad

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    for seed in (2, 3, 4):
        new, _ = inputs(n, c, False, seed=seed, device=cuda)
        with torch.no_grad():
            leaf.copy_(new)
        graph.replay()
        want = fn()
        torch.cuda.synchronize()
        assert torch.equal(captured[0], want[0]) and torch.equal(captured[1], want[1])


@pytest.mark.gpu
def test_launches_count_each_epoch_of_many(cuda):
    """``many(n)``: the card runs one forward and one backward kernel an
    epoch (a profiler trace, the replays' included); the wrapper counts the
    eager warm-up steps' and the capture's, which no replay adds to."""
    step = make_step(cuda)
    epochs = 8

    def pad():
        for _ in range(256):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.1)

    before = nll_loss.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pad()
        step.many(epochs)
        torch.cuda.synchronize()
        pad()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert "spin_kernel" in names[0] and "spin_kernel" in names[-1]
    ran = [m.group(1) for m in map(NLL_KERNEL.search, names) if m]
    assert ran.count("nll_forward_kernel") == ran.count("nll_backward_kernel") == epochs
    assert step.captures == 1
    assert nll_loss.launches - before == 2 * (train.CAPTURE_WARMUP + 1)
    assert not any(re.search(r"nll_loss_(forward|backward)", n) for n in names)
