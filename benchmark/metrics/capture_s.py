"""Trainer (``train.py``, ``TrainStep``): seconds of the step's CUDA-graph
capture, the program's own counter ``TrainStep.capture_s``; nothing off the
card, where no step is captured.  Moves ``setup_s``."""


def read(run):
    return run.step.capture_s
