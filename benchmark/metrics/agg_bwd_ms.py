"""Kernels, backward: device ms an epoch inside the backward of the graph's
four aggregation Functions (``graph.py``: the transpose kernels, the
per-edge weight gathers, the SDDMM of the weights' gradient), from the
program's device stamps (``spans.phases``, phase ``agg.bwd``).  Moves
``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "agg.bwd")
