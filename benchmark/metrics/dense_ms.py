"""Model (``models/layers.py``, ``models/nets.py``: GEMMs, activations,
dropout, loss; Adam): device ms an epoch of the traced device operations
that are not the port's own kernels.  Moves ``epoch_ms``."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.other_s * 1e3 / run.trace.epochs
