"""Model, loss: device ms an epoch of the NLL loss over all nodes, forward
(the step's ``F.nll_loss``, which is the port's ``ops/loss.py``: the kernel
pair of ``csrc/nll.cu`` on the card) and backward (from ``loss.backward()``
to the gradient of the log-probabilities), from the program's device stamps
(``spans.phases``, phases ``loss.fwd`` and ``loss.bwd``).  Moves
``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "loss.fwd", "loss.bwd")
