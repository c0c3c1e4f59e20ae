"""The system under test: the port's training step, built as its trainer builds it.

``build`` follows ``tcgnn_tpu_torch.train._run`` on one device: a
``TileConfig`` in the configuration's compute dtype, ``tiled_graph_from_dataset``
(the route, the upload, the device row indexes), the ``GNN`` with the
benchmark's weights copied in place, ``train.make_optimizer`` (capturable
Adam on the card), a device generator for dropout, and
``train.make_train_step(..., hoist=...)``, whose ``many`` the window calls.
What depends on the model comes from its module (``spec.model``) as plain
data: ``WEIGHTED_TRAFFIC`` and ``NET_ARGS``.  A configuration's
``optimizer`` settings go to ``make_optimizer`` as keyword arguments where
the file states them, and not otherwise.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.reference import Readings
from tcgnn_tpu_torch import TileConfig, tiled_graph_from_dataset, train
from tcgnn_tpu_torch.models import nets

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Program:
    graph: object
    net: object
    optimizer: object
    step: object


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_graph(config: dict, model, data, device, dtype: str | None = None):
    """The port's graph of ``data`` and the seconds its build took, closed
    by a synchronize.  ``dtype`` overrides the configuration's (the
    lower-precision control)."""
    cfg = TileConfig(compute_dtype=DTYPES[dtype or config["dtype"]])
    start = time.perf_counter()
    graph = tiled_graph_from_dataset(data, cfg, device=device,
                                     weighted_traffic=model.WEIGHTED_TRAFFIC)
    sync(device)
    return graph, time.perf_counter() - start


def build(config: dict, model, dims: list, graph, x, y, weights: dict,
          dropout_seed: int) -> Program:
    """The training step over ``graph`` from ``weights`` (copied in place)."""
    device = x.device
    net = nets.GNN(config["model"], dims, device=device,
                   **{key: config[key] for key in model.NET_ARGS})
    with torch.no_grad():
        for name, value in weights.items():
            net.get_parameter(name).copy_(value)
    optimizer = train.make_optimizer(net.parameters(), float(config["lr"]), device,
                                     **config.get("optimizer", {}))
    generator = torch.Generator(device=device).manual_seed(dropout_seed)
    step = train.make_train_step(graph, net, x, y, optimizer, float(config["dropout"]),
                                 hoist=bool(config["hoist"]), generator=generator)
    return Program(graph, net, optimizer, step)


def first_gradients(program: Program) -> dict:
    """Each leaf's gradient in the first step, as Adam got it, from its
    state after that step: ``exp_avg = (1 - beta1) * g``; all nan where
    Adam made no update."""
    out = {}
    beta1 = program.optimizer.param_groups[0]["betas"][0]
    for name, param in program.net.named_parameters():
        exp_avg = program.optimizer.state.get(param, {}).get("exp_avg")
        out[name] = (torch.full(param.shape, float("nan"), dtype=torch.float64)
                     if exp_avg is None else exp_avg.detach().double().cpu() / (1 - beta1))
    return out


def first_steps(program: Program, weights: dict, steps: int) -> Readings:
    """The first ``steps`` steps, each one ``step.many(1)`` as the window
    calls it (the first eager, the second capturing the step on the card):
    their losses, the first gradient from Adam's state, and each leaf's
    change from ``weights`` after the steps."""
    losses, grad = [], {}
    for i in range(steps):
        losses.append(float(program.step.many(1)))
        if i == 0:
            grad = first_gradients(program)
    change = {name: (p.detach() - weights[name]).double().cpu()
              for name, p in program.net.named_parameters()}
    return Readings(losses, grad, change)
