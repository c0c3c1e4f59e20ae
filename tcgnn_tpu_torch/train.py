"""Full-graph GNN trainer CLI (PyTorch port of ``tcgnn_tpu.train``).

Single device: SGT preprocessing timed as ``Prep. (ms)`` with the
``TC_Blocks`` / ``Exp_Edges`` statistics, then full-batch training with Adam
(lr 0.01) and NLL over all nodes: 9 warm-up epochs, as the JAX CLI runs
(``tcgnn_tpu/train.py`` ``step.many(..., 9)``), then ``--epochs`` timed
epochs reported as ``Train (ms)``.  The timed loop reads no value from the
device; it is bracketed by ``torch.cuda.synchronize()``.  On the card the
epochs after the first run as JAX's device-side epoch chain runs them: the
step is captured once into a CUDA graph (in the warm-up, so the capture
stays out of ``Train (ms)``) and replayed once an epoch (``TrainStep.many``),
with no host dispatch of its kernels, on one device and on the mesh in one
process alike; on the CPU, and on a mesh over processes (whose transfers
gloo stages through the host), every epoch is one eager step.

The device is explicit (``--device``, default ``cuda``) and the trainer never
moves to another one: without a card, ``--device cuda`` raises.  It prints
which host pass tiled the graph (``SGT pass:``, native or numpy, with the
native build's first error line where ``auto`` could not load it) and the
host prep's stages (``Prep stages (ms):``).

``--single_kernel`` trains nothing: it times chained rounds of the graph's
SpMM and SDDMM (``profile_sag``, the reference's single-kernel mode) on any
route, the mesh's included, over processes too (each rank times its shards'
rounds, whose collectives cross ranks as a step's do; rank 0 prints the
slowest rank's).  ``--save_params`` / ``--load_params`` write and
read the parameters (one device and the mesh); ``--checkpoint_dir`` /
``--checkpoint_every`` / ``--resume`` checkpoint the training state and
resume from the newest snapshot (one device, as in the JAX CLI).

``--mesh GxF`` trains over a ``('graph','feature')`` mesh of G x F shards
(``tcgnn_tpu_torch.parallel``), all on the one ``--device``: the graph is
balanced over the shards (``--no_balance`` keeps its order), partitioned,
and trained with the same output lines and a ``Route:`` line naming the
route and its layout (the block streams, the block-diagonal offsets, or
the streamed route's segments); ``block_group`` is 1, as the mesh's split
needs.  Under ``torchrun`` (``WORLD_SIZE > 1``) the trainer joins the
process group (``parallel.mesh.init_process_group``; ``--dist_backend``,
default NCCL on a card and gloo on the CPU) and the processes take the
mesh, one a card (``--device cuda`` takes ``LOCAL_RANK``'s; ``--device
cuda:0`` puts every rank on card 0, which only gloo allows): they split
its graph axis where their count divides G, else each holds one feature
shard of a block of graph shards (N = Wg x F ranks, Wg dividing G; the
``Route:`` line ends in ``ranks=WgxF``).  Rank 0 prints the output lines;
``Acc`` counts are all-reduced, each graph block's once; ``Train (ms)`` is
rank 0's after a barrier, so it covers the slowest rank; ``--save_params``
is written by rank 0 and ``--load_params`` read by every rank.

Run:  python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --model gcn
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --mesh 4x2
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --model agnn \
          --hidden 32 --mesh 8x1
      python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --model agnn --hidden 32
      python -m tcgnn_tpu_torch.train --dataset DD --dim 89 --classes 2 --reorder rcm
      python -m tcgnn_tpu_torch.train --dataset reddit --dim 602 --classes 41 --model gcn
      python -m tcgnn_tpu_torch.train --dataset reddit --dim 602 --classes 41 --mesh 4x1
      torchrun --nproc_per_node 4 -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 \
          --classes 3 --mesh 4x1
      torchrun --nproc_per_node 4 -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 \
          --classes 3 --model agnn --hidden 32 --mesh 2x2
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --single_kernel
      python -m tcgnn_tpu_torch.train --dataset pubmed --dim 500 --classes 3 --epochs 200 \
          --checkpoint_dir ckpt/ --checkpoint_every 50 [--resume]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import dataset as data_lib
from tcgnn_tpu_torch.data import synthetic
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch import profiling
from tcgnn_tpu_torch.models import nets
# The step's ``F.nll_loss`` is the port's NLL kernel pair (``ops/loss.py``).
from tcgnn_tpu_torch.ops import loss as F
from tcgnn_tpu_torch.sgt import reorder
from tcgnn_tpu_torch.utils import checkpoint as ckpt

# Warm-up steps before the timed epochs, the first one's loss included: the
# JAX CLI's 9, on one device and on the mesh.
WARMUP_EPOCHS = 9
# Eager steps before a step is captured (``TrainStep.many``), the calls of
# the step before counting: PyTorch's capture recipe runs a few, so that
# what a step sets up once (Adam's state, cuBLAS's workspace, the kernels'
# libraries) is set up outside the capture.
CAPTURE_WARMUP = 3
# SpMM rounds of --single_kernel's chain: the reference's 200
# (main_tcgnn.py:65-70), as in the JAX CLI.
SAG_ROUNDS = 200
# --profile_dir: replays of the stamped twin of the step inside the trace,
# and behind the phase table.
TRACED_TWIN_EPOCHS = 3
PHASE_EPOCHS = 50


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TC-GNN trainer (PyTorch/CUDA port)")
    p.add_argument("--dataset", type=str, default="amazon0601")
    p.add_argument("--dim", type=int, default=96, help="input embedding dimension")
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=22)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--model", type=str, default="gcn", choices=["gcn", "gin", "agnn"])
    p.add_argument(
        "--n_heads", type=int, default=1,
        help="AGNN attention heads (head-averaged)",
    )
    p.add_argument("--single_kernel", action="store_true",
                   help="time chained rounds of the graph's SpMM and SDDMM; trains nothing")
    p.add_argument("--data_dir", type=str, default="tcgnn-ae-graphs/")
    p.add_argument("--blk_h", type=int, default=512)
    p.add_argument("--blk_w", type=int, default=128)
    p.add_argument("--edge_chunk", type=int, default=128,
                   help="edge slots per chunk of the chunk and streamed routes")
    p.add_argument(
        "--block_group", type=int, default=0,
        help="SGT block-count padding granule (0 = auto, which is 1 here: the kernels walk "
        "a window's blocks themselves; the JAX CLI's auto takes 2 on block-dense graphs, "
        "which changes only padding blocks)",
    )
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--symmetric", action="store_true",
                   help="declare A symmetric (skip the transpose tiling)")
    p.add_argument(
        "--reorder", default="none", choices=list(reorder.REORDER_METHODS),
        help="node reordering before tiling: rcm narrows the band so banded "
        "graphs reach the block-diagonal route; community (Rabbit-style) needs the "
        "native SGT pass",
    )
    p.add_argument("--gcn_norm", action="store_true",
                   help="symmetric D^-1/2 A D^-1/2 normalization")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument(
        "--no_hoist", action="store_true",
        help="recompute the loop-invariant layer-1 aggregate every epoch "
        "instead of hoisting it out of the training loop (exact either way)",
    )
    p.add_argument("--eval", action="store_true", help="report train/test accuracy")
    p.add_argument("--save_params", type=str, default=None,
                   help="write the trained parameters to this file (.pt)")
    p.add_argument("--load_params", type=str, default=None,
                   help="start from the parameters in this file")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="directory for training-state checkpoints (parameters, optimizer, "
                   "epoch, dropout generator; atomic writes); one device only, as in the "
                   "JAX CLI: not taken with --mesh")
    p.add_argument("--checkpoint_every", type=int, default=50,
                   help="checkpoint period in epochs (with --checkpoint_dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --checkpoint_dir at its epoch")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace the timed epochs with torch.profiler into this directory "
                   "and print the device's busy time, idle share and largest items")
    p.add_argument("--mesh", type=str, default=None, metavar="GxF",
                   help="train over a ('graph','feature') mesh of G x F shards, e.g. --mesh 4x2; "
                   "every shard lives on --device")
    p.add_argument("--no_balance", action="store_true",
                   help="(--mesh only) disable the window-granular LPT shard balance")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="(under torchrun) the process group's backend: nccl on a card, gloo "
                   "on the CPU by default; gloo on a card stages transfers through the host")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_dataset(args) -> data_lib.GraphDataset:
    npz = os.path.join(args.data_dir, args.dataset + ".npz")
    if os.path.exists(npz):
        return data_lib.load_npz(npz, args.dim, args.classes, seed=args.seed)
    txt = os.path.join(args.data_dir, args.dataset + ".txt")
    if os.path.exists(txt):
        return data_lib.load_txt(txt, args.dim, args.classes, seed=args.seed)
    print(f"# dataset {args.dataset}: synthetic (no file in {args.data_dir})")
    return synthetic.synthesize(args.dataset, args.dim, args.classes, seed=args.seed)


def make_config(args) -> TileConfig:
    return TileConfig(
        blk_h=args.blk_h,
        blk_w=args.blk_w,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        block_group=args.block_group,
        edge_chunk=args.edge_chunk,
    )


def make_optimizer(params, lr: float, device) -> torch.optim.Adam:
    """Adam at ``lr``, capturable on the card (``TrainStep.many`` captures
    its update into a CUDA graph); the CPU takes the plain update.  Its
    construction is the host span ``step.optimizer_build`` (the first one in
    a process imports ``torch._dynamo``)."""
    with profiling.span("step.optimizer_build"):
        return torch.optim.Adam(params, lr=lr, capturable=torch.device(device).type == "cuda")


class TrainStep:
    """One full-batch epoch per call: forward, NLL over all nodes, Adam
    update; returns the epoch's loss (before the update) as a device tensor.

    ``many(n)`` runs n epochs and returns the n-th one's loss: JAX's
    ``step.many`` (``tcgnn_tpu/train.py:203-236``), n epochs in one device
    program.  On the card its first call captures the step into a CUDA
    graph, and every epoch after that is one replay: the same kernels, with
    no Python and no host dispatch between them.  PyTorch's capture recipe
    is kept: a few eager steps first (``CAPTURE_WARMUP``, the calls of the
    step before counting), on a side stream, then the capture, which runs
    nothing, then the replays.  The warm-up steps are real updates and count
    among the n, so ``many(n)`` makes exactly the updates of n calls, with
    the dropout masks of the same generator in the same order (it is
    registered with the graph, so every replay draws the next masks).  The
    graph's static inputs are the features, labels, norms, hoisted
    aggregate and graph arrays, the parameters and Adam's state: each must
    keep its storage after the capture, and ``many`` raises where one has
    moved.  The capture needs a capturable Adam (``make_optimizer``); a
    capture that fails raises, naming what broke it, and nothing falls back
    to eager steps.  A kernel wrapper counts its launch once, at the
    capture: a replay runs no Python.  On the CPU, and for an ``eager``
    step (one that cannot be captured: the ``sparse`` incumbent's, a mesh
    step over processes), ``many(n)`` is n calls.

    ``graph_nodes()`` reads the captured graph's kernel, memset and copy
    nodes (a replay runs them, and fills the registered dropout generator's
    seed and offset before them).  ``span_ms(n)`` times the
    step's phases (``profiling.PHASES``) on the card from a ``stamped``
    step's device stamps, in a twin of the graph that ``many`` never
    replays, so the epochs ``many`` runs carry no stamp.
    """

    def __init__(self, fn, params, optimizer, generator, device: torch.device,
                 eager: bool = False, stamped: bool = False):
        self._fn, self._params, self._optimizer = fn, list(params), optimizer
        self._generator, self.device = generator, device
        self.eager = eager
        self.stamped = stamped
        self.replays = device.type == "cuda" and not eager
        self._graph = self._loss = self._storage = self._twin = None
        self.eager_steps = 0
        self.captures = 0
        self.capture_s = None

    def __call__(self) -> torch.Tensor:
        loss = self._fn()
        self.eager_steps += 1
        return loss

    def many(self, n: int) -> torch.Tensor:
        """``n`` epochs; the n-th one's loss, a tensor no later call
        overwrites."""
        if n < 1:
            raise ValueError(f"step.many: n must be at least 1, got {n}")
        if not self.replays:
            for _ in range(n):
                loss = self()
            return loss
        if self._graph is None:
            if not all(g.get("capturable", False) for g in self._optimizer.param_groups):
                raise ValueError("step.many: on the card the optimizer's update is captured "
                                 "into a CUDA graph; build it with capturable=True "
                                 "(train.make_optimizer)")
            warm = min(max(CAPTURE_WARMUP - self.eager_steps, 0), n - 1)
            if self.eager_steps + warm == 0:  # one epoch, and no step to capture after
                return self()
            if warm:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    for _ in range(warm):
                        self()
                torch.cuda.current_stream(self.device).wait_stream(side)
                n -= warm
            self._capture()
        elif self._tensor_storage() != self._storage:
            raise RuntimeError(
                "step.many: a parameter or Adam state tensor was given new storage after the "
                "step was captured; restore parameters and optimizer state in place, before "
                "the first many()")
        for _ in range(n):
            self._graph.replay()
        return self._loss.clone()

    def _state(self) -> list:
        """Every parameter and Adam state tensor, which the graph reads and
        writes where they lay at the capture."""
        tensors = list(self._params)
        for state in self._optimizer.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
        return tensors

    def _tensor_storage(self) -> list:
        return [t.data_ptr() for t in self._state()]

    def _capture(self) -> None:
        # The graph is kept after its instantiation (``graph_nodes`` reads it);
        # the instantiation is timed with the capture, as without it.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                loss = self._fn()
            graph.instantiate()
        except RuntimeError as e:
            causes = [e] + ([e.__context__] if e.__context__ is not None else [])
            raise RuntimeError(
                "step.many: the training step could not be captured into a CUDA graph: "
                + "; ".join(f"{type(c).__name__}: {c}" for c in reversed(causes))
                + " (a host read in the step, such as .item(), float(), nonzero or a shape "
                "taken from device data, or a launch off the current stream, breaks a "
                "capture)") from e
        self.capture_s = time.perf_counter() - t0
        self._graph, self._loss = graph, loss
        self._storage = self._tensor_storage()
        self.captures += 1

    def graph_nodes(self) -> dict | None:
        """The captured step's kernel, memset and copy nodes; None before the
        capture, on the CPU and for an ``eager`` step."""
        return None if self._graph is None else profiling.graph_nodes(self._graph)

    def span_ms(self, epochs: int) -> dict | None:
        """Device ms an epoch of each phase of the step (``profiling.phase_ms``:
        the median over ``epochs`` replays, with ``epoch``, ``replays`` and
        ``tick_ns``); None on the CPU, for an ``eager`` step, for a step
        built without stamps and before the step's capture.

        The first call captures the twin: the same step once more, with the
        device stamps on (``profiling.DeviceStamps``), its dropout generator
        registered and the plain graph's memory pool shared.  ``many`` keeps
        replaying the plain graph.  The twin's replays are training epochs;
        the parameters and Adam's state are put back afterwards, in place.
        """
        if not (self.replays and self.stamped) or self._graph is None:
            return None
        if self._twin is None:
            stamps = profiling.DeviceStamps(self.device)
            twin = torch.cuda.CUDAGraph()
            if self._generator is not None:
                twin.register_generator_state(self._generator)
            with profiling.RECORDER.stamps_into(stamps):
                with torch.cuda.graph(twin, pool=self._graph.pool()):
                    self._fn()
            self._twin = twin, stamps
        twin, stamps = self._twin
        saved = [t.clone() for t in self._state()]
        rows = []
        for start in range(0, epochs, stamps.rows):
            stamps.rewind()
            for _ in range(min(stamps.rows, epochs - start)):
                twin.replay()
            rows.append(stamps.read(min(stamps.rows, epochs - start)))
        with torch.no_grad():
            for t, v in zip(self._state(), saved):
                t.copy_(v)
        return profiling.phase_ms(stamps.labels, np.concatenate(rows))


def make_train_step(
    graph: TiledGraph, net: nets.GNN, x, y, optimizer, dropout_rate, norm=None,
    hoist: bool = True, generator: torch.Generator | None = None, eager: bool = False,
    loss_fn=None,
) -> TrainStep:
    """The one-device training step, a ``TrainStep``: ``step()`` runs one
    eager epoch, ``step.many(n)`` n epochs, on the card replays of one CUDA
    graph of the step unless ``eager`` (a step that cannot be captured).
    ``hoist`` computes the loop-invariant layer-1 aggregate once
    (``nets.hoist_l1_aggregate``), removing that SpMM and its transpose
    from every epoch; exact for GCN and GIN, and no change for AGNN.
    ``generator`` draws the dropout masks (no dropout without one, or at
    rate 0).  The hoist is the host span ``step.hoist``.  The step stamps
    its phases (``profiling.PHASES``) where stamps are recorded
    (``TrainStep.span_ms``), and nothing otherwise.  ``loss_fn`` takes the
    log-probabilities and labels to the loss; without it the step calls
    ``F.nll_loss`` (the port's NLL kernel pair, ``ops/loss.py``) at each
    call, so that a caller may swap ``train.F``.
    """
    l1_agg = None
    if hoist:
        with profiling.span("step.hoist"):
            l1_agg = nets.hoist_l1_aggregate(net.kind, x, graph, norm=norm)
    gen = generator if dropout_rate > 0 else None
    stamp = profiling.RECORDER.stamp

    def step() -> torch.Tensor:
        stamp("forward")
        optimizer.zero_grad(set_to_none=True)
        logp = net(x, graph, dropout_generator=gen, dropout_rate=dropout_rate,
                   norm=norm, l1_agg=l1_agg)
        stamp("loss.fwd")
        nll = F.nll_loss if loss_fn is None else loss_fn
        loss = nll(profiling.mark(logp, "backward"), y)
        stamp("loss.bwd")
        loss.backward()
        stamp("optimizer")
        optimizer.step()
        stamp("end", last=True)
        return loss.detach()

    return TrainStep(step, net.parameters(), optimizer, gen, x.device, eager=eager,
                     stamped=True)


def timed_epochs(step, args, device, sync, checkpoint=None, resumed_at=None) -> tuple:
    """Warm-up epochs, then the timed ones up to ``--epochs`` (profiled with
    ``--profile_dir``): ``(first_loss, final_loss, train_ms, profile)``, or
    None where a resumed run has no epoch left.

    The JAX CLI's loop (``tcgnn_tpu/train.py:597-630``): the first epoch is
    one ``step()`` (its loss is ``first_loss``), the other warm-up epochs
    one ``step.many``, which holds the capture, and the timed epochs one
    ``step.many`` a piece (``step`` is a ``TrainStep``, the mesh's too).  A
    run resumed at epoch ``resumed_at`` takes no
    warm-up step: the restored state must take no update the first run did
    not count, so its first piece holds its first epoch's ``step()`` and
    the capture, as JAX's first chunk holds its compile.  With
    ``checkpoint`` (a function of the epoch that writes the training state)
    the timed epochs run in pieces that end on multiples of
    ``--checkpoint_every``; a synchronize closes each piece before its
    write, and the writes are left out of ``Train (ms)``.  The final state
    is always written.  With ``--profile_dir`` the stamped twin of the step
    (``TrainStep.span_ms``) replays a few epochs at the end of the trace,
    outside its summary, and the phase table follows ``Train (ms)``."""
    start_epoch = resumed_at or 0
    first_loss = loss = None
    if resumed_at is None:
        first_loss = step()
        loss = step.many(WARMUP_EPOCHS - 1)
    sync()
    every = args.checkpoint_every
    epochs_run = max(args.epochs - start_epoch, 1)
    twin = (lambda: step.span_ms(TRACED_TWIN_EPOCHS)) if args.profile_dir else None
    with profiling.trace(args.profile_dir, device, epochs_run, tail=twin) as prof:
        start_train, ckpt_s, epoch = time.perf_counter(), 0.0, start_epoch
        while epoch < args.epochs:
            piece = args.epochs - epoch
            if checkpoint is not None:
                piece = min(piece, every - epoch % every)
            if first_loss is None:
                first_loss = loss = step()
                if piece > 1:
                    loss = step.many(piece - 1)
            else:
                loss = step.many(piece)
            epoch += piece
            if checkpoint is not None and epoch % every == 0:
                sync()
                t0 = time.perf_counter()
                checkpoint(epoch)
                ckpt_s += time.perf_counter() - t0
        sync()
        train_time = time.perf_counter() - start_train - ckpt_s
    if epoch == start_epoch and resumed_at is not None:
        print(f"# checkpoint epoch {resumed_at} >= --epochs; no-op")
        return None
    if checkpoint is not None and args.epochs % every != 0:
        checkpoint(args.epochs)
    final_loss = float(loss)
    print("Final loss:\t{:.6f}".format(final_loss))
    print("Train (ms):\t{:6.3f}".format(train_time * 1e3 / epochs_run))
    if args.profile_dir:
        profiling.print_phases(step.span_ms(PHASE_EPOCHS), step.graph_nodes(), prof)
    return float(first_loss), final_loss, train_time * 1e3 / epochs_run, prof or None


def profile_sag(graph, x: torch.Tensor, num_rounds: int = SAG_ROUNDS) -> tuple:
    """The reference's single-kernel mode (``gnn_conv.py:179-189``): chained
    rounds of the graph's SpMM, each taking the previous output, then of its
    SDDMM, no gradient.  Returns ``(seconds a round, stats)``, the stats
    with the JAX ``profile_sag``'s keys.  On a mesh over processes each rank
    times its shards' rounds, and the slowest rank's times (each the largest
    over the ranks) are the ones reported; ``d`` is the global width.

    "SAG profiling avg" is the device time a round (``profiling.device_ms``
    over ``num_rounds`` chained rounds) on the card, the host clock on the
    CPU; "SAG dispatch-chained avg" the host clock over ``min(num_rounds,
    50)`` chained calls with one synchronize at the end.  The SDDMM runs
    ``max(num_rounds // 2, 4)`` rounds, each nudging its input by its first
    score so that every round depends on the last.  Values overflow over
    unnormalized rounds, as in the JAX package; only the time is read.  The
    JAX package's chain differencing and lane padding are TPU workarounds
    and are left out: ``d`` is the true width."""
    x = x.to(graph.config.compute_dtype)
    on_card = x.device.type == "cuda"
    carry = {"x": x}

    def spmm_round():
        carry["x"] = graph.spmm(carry["x"]).to(x.dtype)

    def sddmm_round():
        c = carry["x"]
        carry["x"] = c + (1e-30 * graph.sddmm(c)[0]).to(c.dtype)

    def per_round(fn, rounds: int) -> float:
        """Seconds a round of ``rounds`` chained rounds."""
        carry["x"] = x
        if on_card:
            return profiling.device_ms(fn, calls=rounds) / 1e3
        start = time.perf_counter()
        for _ in range(rounds):
            fn()
        return (time.perf_counter() - start) / rounds

    def sync():
        if on_card:
            torch.cuda.synchronize(x.device)

    with torch.no_grad():
        kernel_s = per_round(spmm_round, num_rounds)
        carry["x"] = x
        spmm_round()  # settle
        sync()
        chain_rounds = min(num_rounds, 50)
        carry["x"] = x
        start = time.perf_counter()
        for _ in range(chain_rounds):
            spmm_round()
        sync()
        pipelined = (time.perf_counter() - start) / chain_rounds
        sddmm_s = per_round(sddmm_round, max(num_rounds // 2, 4))
    mesh = getattr(graph, "mesh", None)
    if mesh is not None and mesh.world > 1:
        from tcgnn_tpu_torch.parallel.collectives import all_reduce_max

        kernel_s, pipelined, sddmm_s = all_reduce_max([kernel_s, pipelined, sddmm_s], mesh)

    d = graph.node_cols(x.shape[1])[0] if hasattr(graph, "node_cols") else x.shape[1]
    print("=> SAG profiling avg (ms): {:.3f}".format(kernel_s * 1e3))
    print("=> SAG dispatch-chained avg (ms): {:.3f}".format(pipelined * 1e3))
    stats = profiling.kernel_report(graph.num_edges, graph.exp_edges, d, kernel_s)
    stats["dispatch_chained_ms"] = pipelined * 1e3
    print("=> SAG edges/s: {:.3e}  useful TFLOP/s: {:.3f}  tile TFLOP/s: {:.2f}  MFU: {:.1f}% "
          "(bf16 peak {:.0f})".format(stats["edges_per_s"], stats["useful_tflops"],
                                      stats["tile_tflops"], stats["mfu_pct"],
                                      profiling.PEAK_BF16_TFLOPS))
    stats["sddmm_ms"] = sddmm_s * 1e3
    stats["sddmm_edges_per_s"] = graph.num_edges / sddmm_s if sddmm_s > 0 else float("inf")
    print("=> SDDMM avg (ms): {:.3f}  edges/s: {:.3e}".format(stats["sddmm_ms"],
                                                             stats["sddmm_edges_per_s"]))
    print()
    return kernel_s, stats


def print_prep(graph, prep: float, route: str) -> None:
    """The preprocessing lines (one device and the mesh): the tiling's
    statistics, ``Prep. (ms)`` (``prep`` seconds), the host passes' time
    and stages, the host pass that ran, and the route."""
    print("TC_Blocks:\t{}\nExp_Edges:\t{}".format(graph.tc_blocks, graph.exp_edges))
    print("Prep. (ms):\t{:.3f}".format(prep * 1e3))
    print("Prep host (ms):\t{:.3f}".format(graph.prep_host_s * 1e3))
    print("SGT pass:\t" + graph.host_pass)
    print("Prep stages (ms):\t" + "  ".join(
        "{} {:.3f}".format(k, v * 1e3) for k, v in graph.prep_stages.items()))
    print("Route:\t" + route)


def train_distributed(args, ds, cfg, device, sync) -> dict:
    """Full-batch training over a ``('graph','feature')`` mesh (``--mesh
    GxF``): every shard on ``device``, or, in a process group, this rank's
    graph shards."""
    from tcgnn_tpu_torch.parallel import (
        collectives,
        distributed_graph_from_dataset,
        init_distributed_net,
        make_distributed_train_step,
        make_mesh,
    )

    if args.checkpoint_dir:
        raise ValueError("--checkpoint_dir is not taken with --mesh (as in the JAX CLI)")
    ng, nf = (int(v) for v in args.mesh.lower().split("x"))
    mesh = make_mesh(ng, nf, device)
    if mesh.world > 1:
        one = sync

        def sync():
            one()
            dist.barrier()

        if mesh.rank:
            args.profile_dir = None  # rank 0 traces

    start = time.perf_counter()
    graph = distributed_graph_from_dataset(ds, mesh, cfg, balance=not args.no_balance)
    sync()
    prep = time.perf_counter() - start
    print_prep(graph, prep, graph.route)

    x = graph.shard_features(ds.x)
    if args.single_kernel:
        sec, stats = profile_sag(graph, x, SAG_ROUNDS)
        return {"ms": sec * 1e3, **stats}
    y = graph.shard_nodes(ds.y.astype(np.int64))
    net, _, _ = init_distributed_net(
        torch.Generator().manual_seed(args.seed), args.model, ds.num_features, args.hidden,
        ds.num_classes, args.num_layers, graph, n_heads=args.n_heads,
    )
    load_params(args, net)
    optimizer = make_optimizer(net.parameters(), args.lr, device)
    norm = (graph.shard_nodes((1.0 / ds.norm_degrees()).astype(np.float32))
            if args.gcn_norm else None)
    step = make_distributed_train_step(
        graph, net, x, y, optimizer, 0.0 if args.no_dropout else args.dropout,
        num_valid_classes=ds.num_classes, norm=norm, hoist=not args.no_hoist,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1),
    )
    first_loss, final_loss, train_ms, prof = timed_epochs(step, args, device, sync)

    if args.eval:
        with torch.no_grad():
            pred = net(x, graph, norm=norm, num_valid_classes=ds.num_classes).argmax(dim=1)
        for split, m_host in (("train", ds.train_mask), ("test", ds.test_mask)):
            if m_host.any():
                m = graph.shard_nodes(m_host).bool()
                counts = torch.stack([(pred[m] == y[m]).sum(), m.sum()]).double()
                if mesh.world > 1:
                    if mesh.feature_rank:  # each graph block's rows count once
                        counts.zero_()
                    collectives.all_reduce_bucket([counts], mesh)
                print("Acc {}:\t{:.4f}".format(split, float(counts[0] / counts[1])))
    if mesh.rank == 0:
        save_params(args, net)
    return {
        "dense_tiles": graph.dense_tiles, "streamed": graph.streamed,
        "block_diag": graph.block_diag, "mesh": (ng, nf), "route": graph.route,
        "split": (graph.host_fwd.split is not None, graph.host_bwd.split is not None),
        "tc_blocks": graph.tc_blocks, "exp_edges": graph.exp_edges, "prep_ms": prep * 1e3,
        "prep_host_ms": graph.prep_host_s * 1e3,
        "prep_stages_ms": {k: v * 1e3 for k, v in graph.prep_stages.items()},
        "host_pass": graph.host_pass, "first_loss": first_loss, "final_loss": final_loss,
        "train_ms": train_ms, "profile": prof, "captures": step.captures,
        "capture_s": step.capture_s, "graph": graph,
    }


def load_params(args, net) -> None:
    if args.load_params:
        ckpt.restore(args.load_params, net)
        print(f"# restored params from {args.load_params}")


def save_params(args, net) -> None:
    if args.save_params:
        path = ckpt.save(args.save_params, net, step=args.epochs)
        print(f"# saved params to {path}")


def main(argv=None) -> dict:
    """Parse ``argv`` and train.  Under ``torchrun`` (``WORLD_SIZE > 1``) or
    in a process group the caller formed, the run is one rank of ``--mesh``:
    it joins the group where none is formed (and leaves it at the end), and
    only rank 0 prints."""
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    formed = dist.is_available() and dist.is_initialized()
    join = not formed and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if (join or (formed and dist.get_world_size() > 1)) and not args.mesh:
        raise ValueError("over several processes the trainer trains a --mesh GxF")
    if join:
        from tcgnn_tpu_torch.parallel.mesh import init_process_group

        device = init_process_group(device, backend=args.dist_backend)
    rank = dist.get_rank() if (formed or join) else 0
    try:
        with contextlib.ExitStack() as quiet:
            if rank:
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            return _run(args, device)
    finally:
        if join:
            dist.destroy_process_group()


def _run(args, device) -> dict:
    print(args)
    if args.resume and not args.checkpoint_dir:
        raise ValueError("--resume needs --checkpoint_dir")
    # f32 means f32: no TF32 in the dense products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ds = load_dataset(args)
    cfg = make_config(args)
    if args.mesh:
        if args.reorder != "none":
            reorder.reorder_dataset(ds, args.reorder)
        return train_distributed(args, ds, cfg, device, sync)
    if args.reorder != "none":
        start = time.perf_counter()
        reorder.reorder_dataset(ds, args.reorder)
        print("Reorder (ms):\t{:.3f}".format((time.perf_counter() - start) * 1e3))

    # ---- SGT preprocessing and upload (the "Prep." stage) ----------------
    start = time.perf_counter()
    graph = TiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes, cfg,
        symmetric=args.symmetric, device=device, weighted_traffic=args.model == "agnn",
    )
    sync()
    prep = time.perf_counter() - start
    print_prep(graph, prep, "dense_tiles={} streamed={} block_diag={}".format(
        graph.dense_tiles, graph.streamed, graph.block_diag))

    x = torch.from_numpy(ds.x).to(device)
    if args.single_kernel:
        sec, stats = profile_sag(graph, x, SAG_ROUNDS)
        return {"ms": sec * 1e3, **stats}
    y = torch.from_numpy(ds.y.astype(np.int64)).to(device)

    # ---- model + optimizer -------------------------------------------------
    net = nets.init_net(
        torch.Generator().manual_seed(args.seed), args.model, ds.num_features,
        args.hidden, ds.num_classes, args.num_layers, device=device, n_heads=args.n_heads,
    )
    load_params(args, net)
    optimizer = make_optimizer(net.parameters(), args.lr, device)
    dropout = 0.0 if args.no_dropout else args.dropout
    norm = (
        torch.from_numpy(1.0 / ds.norm_degrees()).to(device) if args.gcn_norm else None
    )
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    step = make_train_step(
        graph, net, x, y, optimizer, dropout, norm=norm, hoist=not args.no_hoist,
        generator=generator,
    )

    # ---- warm-up epochs, then timed epochs (with checkpoints) --------------
    checkpoint, resumed_at = None, None
    if args.checkpoint_dir:
        def checkpoint(epoch):
            ckpt.save_state(args.checkpoint_dir, net, optimizer, epoch, generator=generator)

        if args.resume:
            state = ckpt.restore_state(args.checkpoint_dir, net, optimizer, generator)
            if state is not None:
                resumed_at = state[0]
                print(f"# resumed at epoch {resumed_at}")
    timed = timed_epochs(step, args, device, sync, checkpoint, resumed_at)
    first_loss, final_loss, train_ms, prof = timed if timed else (None, None, 0.0, None)

    if args.eval:
        with torch.no_grad():
            pred = net(x, graph, norm=norm).argmax(dim=1)
        for split, mask in (("train", ds.train_mask), ("test", ds.test_mask)):
            if mask.any():
                m = torch.from_numpy(mask).to(device)
                acc = float((pred[m] == y[m]).float().mean())
                print("Acc {}:\t{:.4f}".format(split, acc))
    if timed:
        save_params(args, net)

    return {
        "dense_tiles": graph.dense_tiles,
        "streamed": graph.streamed,
        "block_diag": graph.block_diag,
        "tc_blocks": graph.tc_blocks,
        "exp_edges": graph.exp_edges,
        "prep_ms": prep * 1e3,
        "prep_host_ms": graph.prep_host_s * 1e3,
        "prep_stages_ms": {k: v * 1e3 for k, v in graph.prep_stages.items()},
        "host_pass": graph.host_pass,
        "resumed_at": resumed_at,
        "first_loss": first_loss,
        "final_loss": final_loss,
        "train_ms": train_ms,
        "profile": prof,
        "captures": step.captures,
        "capture_s": step.capture_s,
        "graph": graph,
        "dataset": ds,
    }


if __name__ == "__main__":
    main()
