"""Model, backward: device ms an epoch of the backward pass from the
log-probabilities on, less its aggregations (the GEMMs' gradients, the
activations', the gradients summed and accumulated), from the program's
device stamps (``spans.phases``, phase ``backward``).  Moves
``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "backward")
