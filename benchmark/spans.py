"""The program's own spans and counters, shared by the per-layer readers in
``metrics/`` that read them.

``phases(run)`` is the device time an epoch of each phase of the training
step, from the program's device stamps: ``TrainStep.span_ms`` captures an
instrumented twin of the step's CUDA graph once and replays it (about
``SPAN_S`` seconds of epochs, at least ``MIN_REPLAYS``), after the window
and the trace, so neither carries a stamp.  It is measured once a run and
kept on the run for the six phase readers.  ``host_s(*names)`` is the
seconds of the program's latest host spans of those names
(``tcgnn_tpu_torch.profiling.RECORDER``).

Each returns None where there is nothing to read: off the card (phases), or
where the program has no such spans (a program older than them), so the
readers leave their metric out and never raise.
"""

from __future__ import annotations

import math

SPAN_S = 1.0
MIN_REPLAYS = 20


def phases(run) -> dict | None:
    """The step's phases in ms an epoch (``tcgnn_tpu_torch.profiling.PHASES``),
    with ``epoch`` (first stamp to last) and ``replays``; None off the card
    or without ``span_ms``."""
    if not hasattr(run, "phase_ms"):
        span_ms = getattr(run.step, "span_ms", None)
        run.phase_ms = None
        if run.on_card and span_ms is not None:
            run.phase_ms = span_ms(max(MIN_REPLAYS, math.ceil(SPAN_S * 1e3 / run.epoch_ms)))
    return run.phase_ms


def phase_ms(run, *names) -> float | None:
    """The sum of the phases ``names``, ms an epoch."""
    found = phases(run)
    return None if found is None else sum(found[n] for n in names)


def host_s(*names) -> float | None:
    """The seconds of the latest host span of each of ``names``, summed;
    None where one is missing."""
    from tcgnn_tpu_torch import profiling

    recorder = getattr(profiling, "RECORDER", None)
    found = [recorder.last(n) for n in names] if recorder is not None else [None]
    return None if None in found else sum(s.seconds for s in found)
