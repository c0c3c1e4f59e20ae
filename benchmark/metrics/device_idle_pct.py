"""Device: the share of the traced window (first device operation to the
last) in which no device operation ran, in %.  Moves ``epoch_ms``."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
