"""Model, optimizer: device ms an epoch of Adam's captured update
(``optimizer.step()``), from the program's device stamps (``spans.phases``,
phase ``optimizer``).  Moves ``epoch_ms``."""

from benchmark import spans


def read(run):
    return spans.phase_ms(run, "optimizer")
