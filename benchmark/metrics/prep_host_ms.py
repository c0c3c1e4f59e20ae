"""Host passes (``sgt/translate.py``, ``sgt/blockdiag.py``, ``sgt/stream.py``,
``sgt/native``): the graph's host preprocessing in ms, the program's own
counter ``TiledGraph.prep_host_s``.  Moves ``setup_s``."""


def read(run):
    return run.graph.prep_host_s * 1e3
