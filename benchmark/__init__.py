"""The benchmark of ``tcgnn_tpu_torch``, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``run.py``).  This folder holds
the yardstick, which the program does not touch: the traffic generator
(``synthetic.py``, a frozen copy of the port's), the plain reference
(``reference.py``) and the comparison that decides ``correct``
(``correct.py``), the work counts and the card's peaks (``counts.py``), the
trace reader (``trace.py``), and, found by name, the configurations
(``configs/``), traffic mixes (``traffic/``), cells (``workloads/``) and
per-layer metric readers (``metrics/``).  ``calibrate.py`` reads the
numbers the limits were set from; ``tests/`` are its CPU tests.
"""
