"""Collective traffic of the distributed step (PyTorch port of
``tcgnn_tpu.parallel.comm_stats``).

``bench/partition_stats.py`` models the halo volume from the partition's
metadata; this module counts what the step's collectives move: it runs the
step once with a recorder set on ``parallel/collectives.py``, whose
collectives report each call's kind and bytes to it.  The bytes are the
logical tensor size a device holds, one instance a call, JAX's accounting
(the wire algorithm may move more or less); kinds are reported apart so a
caller can apply its own wire model.

Against JAX, which reads the compiled program's HLO:

* ``collective_bytes_from_hlo`` is not ported: it parses XLA's HLO text,
  and torch has no such text.  The recorder counts the calls the port makes;
* a collective in a Python loop is counted once an iteration, since the
  port counts what executes; JAX counts an instruction once where it is
  defined, and warns (``_flags``/``in_loop_body``) for one inside a loop
  body, which has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from tcgnn_tpu_torch.parallel import collectives

KINDS = ("all_to_all", "all_gather", "all_reduce", "reduce_scatter", "collective_permute")


class Recorder:
    """``{kind: {count, bytes}}`` of the collectives run inside
    ``collectives.recording(recorder)``; ``num_devices`` weighs partial
    ``ppermute``s by their listed pairs."""

    def __init__(self, num_devices: int | None = None):
        self.num_devices = num_devices
        self.stats: Dict[str, Dict[str, int]] = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def add(self, kind: str, nbytes: int) -> None:
        self.stats[kind]["count"] += 1
        self.stats[kind]["bytes"] += int(nbytes)


def dcn_halo_fraction(pair_counts, chips_per_host: int) -> float:
    """Fraction of halo rows crossing a host boundary on a two-level mesh.

    ``pair_counts[s, t]`` = rows shard ``s`` requests from shard ``t``
    (``partition.build_halo``); with :func:`mesh.make_mesh_two_level`'s
    host-major placement, a pair crosses hosts iff ``s // chips_per_host !=
    t // chips_per_host``.  Returns 0.0 for an empty halo.
    """
    pc = np.asarray(pair_counts, np.int64)
    total = int(pc.sum())
    if total == 0:
        return 0.0
    g = np.arange(pc.shape[0]) // chips_per_host
    cross = pc[g[:, None] != g[None, :]].sum()
    return float(cross) / total


def step_collective_bytes(fn, *args, num_devices: int | None = None, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and report its collective traffic:
    ``{kind: {count, bytes}}`` plus ``total_bytes``.

    ``fn`` is typically a step of ``make_distributed_train_step``: the call
    runs one training step, its backward included, so it updates the net
    and the optimizer's state.  The numbers are per executed step, so the
    epoch count times them gives training traffic.  ``num_devices`` (the
    mesh's shard count) weighs each partial ``ppermute`` by its active
    pairs, the per-device average.
    """
    recorder = Recorder(num_devices)
    with collectives.recording(recorder):
        fn(*args, **kwargs)
    stats: Dict[str, Any] = {k: dict(v) for k, v in recorder.stats.items()}
    stats["total_bytes"] = int(sum(v["bytes"] for v in recorder.stats.values()))
    return stats
