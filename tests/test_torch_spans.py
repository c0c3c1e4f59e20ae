"""The port's recorder (``profiling.RECORDER``): the phase stamps inside the
training step, the host spans of the set-up, and the readers' arithmetic.

On the CPU a recording stand-in takes the stamps (their labels, in order,
and the thread each fired from; no times): one eager step on each route
(condensed GCN, score-fused AGNN, chunk-route AGNN, block-diagonal GCN)
stamps the phases in the nested order of ``profiling.PHASES``, and with no
stand-in installed no stamp and no ``_Mark`` Function is called.  The tests
marked ``gpu`` capture the stamped twin of a step on the card
(``TrainStep.span_ms``) and read the plain graph's nodes; they skip without
a card.  The file imports no JAX, so it runs on the card too:
``python -m pytest tests/test_torch_spans.py --noconftest -q``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph, profiling, train
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.models import init_net

N = 300


class Recording:
    """A stand-in for ``profiling.DeviceStamps``: labels and threads, no times."""

    def __init__(self):
        self.labels, self.threads, self.last = [], [], []

    def stamp(self, label, last):
        self.labels.append(label)
        self.threads.append(threading.get_ident())
        self.last.append(last)


def symmetric_graph():
    src, dst = powerlaw_graph(N, 1500, seed=3)
    return coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), N)


# route: (model, TiledGraph options, aggregations forward, backward)
ROUTES = {
    "condensed-gcn": ("gcn", {"block_diag": False}, 2, 1),
    "sfused-agnn": ("agnn", {"block_diag": False}, 2, 2),
    "chunk-agnn": ("agnn", {"dense_tiles": False}, 4, 4),
    "bd-gcn": ("gcn", {}, 2, 2),
}


def make_step(route, device="cpu", hoist=False):
    kind, options, _, _ = ROUTES[route]
    rp, ci = symmetric_graph()
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=8), device=device,
                   weighted_traffic=kind == "agnn", **options)
    assert g.dense_tiles == ("dense_tiles" not in options)
    assert g.block_diag == (route == "bd-gcn")
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((N, 24)) * 0.3).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 4, N)).to(device)
    net = init_net(torch.Generator().manual_seed(5), kind, 24, 16, 4, 2, device=device)
    opt = train.make_optimizer(net.parameters(), 0.01, device)
    return train.make_train_step(g, net, x, y, opt, 0.5, hoist=hoist,
                                 generator=torch.Generator(device=device).manual_seed(6))


def expected_labels(n_fwd, n_bwd):
    return (["forward"] + ["agg.fwd", "/agg.fwd"] * n_fwd + ["loss.fwd", "loss.bwd", "backward"]
            + ["agg.bwd", "/agg.bwd"] * n_bwd + ["optimizer", "end"])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_an_eager_step_stamps_its_phases_in_order(route):
    step = make_step(route)
    sink = Recording()
    with profiling.RECORDER.stamps_into(sink):
        loss = step()
    assert torch.isfinite(loss)
    _, _, n_fwd, n_bwd = ROUTES[route]
    assert sink.labels == expected_labels(n_fwd, n_bwd)
    assert sink.last == [label == "end" for label in sink.labels]
    assert set(profiling.leaf_phases(sink.labels)) == set(profiling.PHASES)
    assert profiling.RECORDER.stamping is False


def test_without_spans_no_stamp_and_no_mark(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling._Mark, "apply", lambda *a: calls.append(a))
    monkeypatch.setattr(Recording, "stamp", lambda self, *a: calls.append(a))
    for route in ROUTES:
        step = make_step(route)
        step()
        step.many(2)
    assert calls == [] and not profiling.RECORDER.stamping
    rp, ci = symmetric_graph()
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    assert g.spmm(torch.randn(N, 8, requires_grad=True)).grad_fn.stamps is False


def test_backward_stamps_ride_on_the_forward_ctx():
    """A Function stamps its backward where its forward ran with stamps,
    from whatever thread runs the backward; and not where it ran without."""
    rp, ci = symmetric_graph()
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    x = torch.randn(N, 8, requires_grad=True)
    sink = Recording()
    with profiling.RECORDER.stamps_into(sink):
        stamped = g.spmm(x)
    plain = g.spmm(x)
    with profiling.RECORDER.stamps_into(sink):
        worker = threading.Thread(target=lambda: (stamped.sum() + plain.sum()).backward())
        worker.start()
        worker.join()
    assert sink.labels == ["agg.fwd", "/agg.fwd", "agg.bwd", "/agg.bwd"]
    assert sink.threads[2:] == [worker.ident] * 2 and worker.ident != threading.get_ident()
    assert x.grad is not None


@pytest.mark.parametrize("labels", [
    ["loss.fwd", "forward", "end"],                                    # forward not first
    ["forward", "agg.fwd", "loss.fwd", "end"],                          # an open aggregation
    ["forward", "agg.bwd", "/agg.bwd", "end"],                          # agg.bwd in forward
    ["forward", "backward", "loss.bwd", "end"],                         # top level out of order
    ["forward", "agg.fwd", "/agg.bwd", "end"],                          # closes another phase
    ["forward", "loss.fwd"],                                            # no end
])
def test_leaf_phases_refuse_a_broken_order(labels):
    with pytest.raises(ValueError):
        profiling.leaf_phases(labels)


def test_phase_ms_partitions_the_stamped_epoch():
    labels = expected_labels(2, 1)
    # Two replays, stamps 1 µs apart but for the aggregations (5 µs) and Adam (7 µs).
    gaps = [1000, 5000, 1000, 5000, 1000, 1000, 1000, 1000, 5000, 1000, 7000]
    first = np.concatenate([[10**9], 10**9 + np.cumsum(gaps)])
    ns = np.stack([first, first + 10**7 + 32])
    out = profiling.phase_ms(labels, ns)
    assert out["agg.fwd"] == pytest.approx(0.010) and out["agg.bwd"] == pytest.approx(0.005)
    assert out["forward"] == pytest.approx(0.003) and out["backward"] == pytest.approx(0.002)
    assert out["loss.fwd"] == out["loss.bwd"] == pytest.approx(0.001)
    assert out["optimizer"] == pytest.approx(0.007)
    assert out["epoch"] == pytest.approx(sum(gaps) / 1e6)
    assert sum(out[p] for p in profiling.PHASES) == pytest.approx(out["epoch"])
    assert out["replays"] == 2 and out["tick_ns"] == 1000


def test_span_ms_and_graph_nodes_are_none_on_the_cpu():
    step = make_step("condensed-gcn")
    step.many(4)
    assert step.stamped and step.span_ms(5) is None and step.graph_nodes() is None


def test_the_set_up_is_spanned():
    """The host passes' stages, the upload, the row indexes, Adam's
    construction and the hoist are host spans, shown in a profiler trace;
    ``prep_stages`` keeps its seconds."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        step = make_step("sfused-agnn")
        make_step("condensed-gcn", hoist=True)
    names = {e.name for e in prof.events()}
    for name in ("graph.upload", "graph.row_index", "step.optimizer_build", "step.hoist",
                 "prep.sgt", "prep.transpose"):
        s = profiling.RECORDER.last(name)
        assert name in names and s is not None and t0 <= s.start <= s.end, name
    upload, index = (profiling.RECORDER.last(n) for n in ("graph.upload", "graph.row_index"))
    assert upload.end <= index.start and upload.parent is None
    assert step.stamped
    rp, ci = symmetric_graph()
    g = TiledGraph(rp, ci, N, TileConfig(blk_h=16, blk_w=8), device="cpu", block_diag=False)
    assert g.prep_stages["sgt"] == profiling.RECORDER.last("prep.sgt").seconds
    assert g.prep_host_s >= sum(g.prep_stages.values())
    with profiling.span("outer"):
        with profiling.span("inner") as inner:
            pass
    assert inner.parent.name == "outer"


def test_the_chunk_route_indexes_after_its_upload():
    step = make_step("chunk-agnn")
    assert profiling.RECORDER.last("graph.row_index").start >= \
        profiling.RECORDER.last("graph.upload").end
    assert step.many(1) is not None


def test_profile_dir_prints_the_phase_table(tmp_path, capsys):
    train.main(["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3", "--epochs", "2",
                "--blk_h", "16", "--blk_w", "8", "--device", "cpu", "--profile_dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "Phases: device time not measured" in out
    assert "Set-up spans (s):\tgraph.upload" in out and "step.optimizer_build" in out


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def device_ops(fn, pads=256):
    """The device operations the card ran in ``fn``, spin pads at both ends
    left out (a trace may drop operations at its ends)."""
    def pad():
        for _ in range(pads):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.1)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pad()
        fn()
        torch.cuda.synchronize()
        pad()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    assert names and "spin_kernel" in names[0] and "spin_kernel" in names[-1]
    return [n for n in names if "spin_kernel" not in n]


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_twin_partitions_the_replayed_step(cuda, route):
    """The stamped twin: its stamps rise in every replay, its leaf phases
    sum to its stamp-to-stamp epoch, the parameters are put back after it,
    and the plain graph's nodes are the same before and after its capture
    and are the device operations a traced replay runs, but for the
    generator's two fills."""
    step = make_step(route, cuda)
    step.many(6)
    nodes = step.graph_nodes()
    params = [p.detach().clone() for p in step._params]
    phases = step.span_ms(40)
    stamps = step._twin[1]
    ns = stamps.read(40)
    assert ns.shape == (40, len(stamps.labels)) and (np.diff(ns, axis=1) >= 0).all()
    assert (ns[:, -1] > ns[:, 0]).all()
    assert phases["replays"] == 40 and phases["tick_ns"] > 0
    total = sum(phases[p] for p in profiling.PHASES)
    assert total == pytest.approx(phases["epoch"], rel=0.01)
    assert all(phases[p] > 0 for p in profiling.PHASES)
    for p, v in zip(step._params, params):
        torch.testing.assert_close(p.detach(), v, rtol=0, atol=0)
    assert step.graph_nodes() == nodes and nodes["kernel"] > 0
    ops = device_ops(lambda: step.many(5))
    # Besides the graph's nodes, each replay fills the dropout generator's
    # seed and offset (``CUDAGraph.replay``, a registered generator), and
    # ``many`` clones the last loss.
    assert len(ops) == 5 * (sum(nodes.values()) + 2) + 1
    assert not any("stamp_kernel" in n for n in ops)
    twin_ops = device_ops(lambda: step.span_ms(2))
    assert sum("stamp_kernel" in n for n in twin_ops) == 2 * len(stamps.labels)
