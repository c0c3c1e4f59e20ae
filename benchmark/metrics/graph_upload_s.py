"""Graph (``graph.py``, ``TiledGraph``): seconds from the host passes' end
to the build's end, the uploads and the device row indexes, closed by one
synchronize on the card; the program's host spans ``graph.upload`` and
``graph.row_index`` (``spans.host_s``).  Moves ``setup_s``."""

from benchmark import spans


def read(run):
    return spans.host_s("graph.upload", "graph.row_index")
