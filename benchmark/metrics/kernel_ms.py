"""Kernels (``ops/*.py`` -> ``csrc/*.cu``): device ms an epoch of the port's
own kernels in the trace.  Moves ``epoch_ms``."""


def read(run):
    if run.trace is None or run.trace.kernel_s == 0:
        return None
    return run.trace.kernel_s * 1e3 / run.trace.epochs
