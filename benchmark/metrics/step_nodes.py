"""Trainer (``train.py``, ``TrainStep``): the kernel, memset and copy nodes
of the step's CUDA graph, read from the graph by the program's counter
``TrainStep.graph_nodes()``: the device operations of an epoch but the
dropout generator's two fills, which a replay launches before the graph,
and the copy of the loss that ``many`` returns.  Nothing off the card,
where no step is captured.  Moves ``epoch_ms``."""


def read(run):
    graph_nodes = getattr(run.step, "graph_nodes", None)
    nodes = graph_nodes() if run.on_card and graph_nodes is not None else None
    return None if nodes is None else sum(nodes.values())
