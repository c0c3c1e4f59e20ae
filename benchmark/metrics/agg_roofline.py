"""Kernels: the least time the card could take for an epoch's aggregation
work (``counts.epoch_counts``' ``agg_bytes`` and ``agg_flops`` at
``counts.bound_s``) over the port's kernels' device time an epoch, in %.
Moves ``epoch_ms``."""

from benchmark import counts


def read(run):
    if run.trace is None or run.trace.kernel_s == 0:
        return None
    floor = counts.bound_s(run.counts["agg_bytes"], run.counts["agg_flops"])
    return 100.0 * floor / (run.trace.kernel_s / run.trace.epochs)
