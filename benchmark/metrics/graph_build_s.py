"""Graph (``graph.py``, ``tiled_graph_from_dataset``): seconds of the whole
build, host passes, upload and device row indexes, by the benchmark's clock
closed by a synchronize.  Moves ``setup_s``."""


def read(run):
    return run.graph_build_s
