"""Model, forward: device ms an epoch of the forward pass less its
aggregations (``models/nets.py``, ``models/layers.py``: GEMMs, ReLU,
dropout, log-softmax), from the program's device stamps (``spans.phases``,
phase ``forward``).  Moves ``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "forward")
