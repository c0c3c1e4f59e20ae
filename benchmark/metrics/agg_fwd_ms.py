"""Kernels, forward: device ms an epoch inside the forward of the graph's
four aggregation Functions (``graph.py``: the kernels and what runs around
them, casts, gathers, the AGNN gate), from the program's device stamps
(``spans.phases``, phase ``agg.fwd``).  Moves ``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "agg.fwd")
