"""The benchmark of ``tcgnn_tpu_torch``, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``run.py``).  This folder holds
the yardstick, which the program does not touch: the traffic generator
(``synthetic.py``, a frozen copy of the port's), the plain reference's
shared part (``reference.py``) and the comparison that decides ``correct``
(``correct.py``), the card's peaks and bound (``counts.py``), the trace
reader (``trace.py``), and, found by name (``spec.py``), the models (each a
module of ``models/``: its reference, weights, masks and work counts), the
configurations (``configs/``), traffic mixes (``traffic/``), cells
(``workloads/``) and per-layer metric readers (``metrics/``).  ``calibrate.py`` reads the
numbers the limits were set from; ``tests/`` are its CPU tests.
"""
