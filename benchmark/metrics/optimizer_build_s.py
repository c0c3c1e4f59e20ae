"""Trainer (``train.make_optimizer``): seconds of Adam's construction, whose
first one in a process imports ``torch._dynamo``; the program's host span
``step.optimizer_build`` (``spans.host_s``).  Moves ``setup_s``."""

from benchmark import spans


def read(run):
    return spans.host_s("step.optimizer_build")
