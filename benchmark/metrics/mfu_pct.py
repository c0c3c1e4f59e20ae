"""Trainer, the whole step: the epoch's FLOPs (``counts.epoch_counts``, a
function of the configuration and the graph's sizes) over the untraced
window's epoch time and the card's f32 peak, 67 TFLOP/s (NVIDIA's H100 SXM
data sheet at 700 W), in %.  Moves ``epoch_ms``."""

from benchmark import counts


def read(run):
    if not run.on_card:
        return None
    return 100.0 * run.counts["flops"] / (run.epoch_ms / 1e3 * counts.F32_FLOPS)
