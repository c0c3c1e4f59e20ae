"""The ``('graph', 'feature')`` shard grid of the distributed layer
(PyTorch port of ``tcgnn_tpu.parallel.mesh``).

Axes:
  * ``graph``   — row-window-aligned node and edge partition: each shard
    owns a contiguous range of row windows (``parallel/partition.py``);
  * ``feature`` — the embedding dimension, cut into ``n_feature`` equal
    column slices.

In this port every shard of the grid lives on one device: the JAX
package's single-controller design (one program drives every shard)
without its device placement.  The collectives between shards are copies
between shard views on that device (``parallel/collectives.py``).  One
process per card over NCCL is a later step (ROADMAP.md, Queue 1 item 8c),
so a mesh over more than one card raises.

``make_mesh_two_level`` lays the graph axis out host-major, as JAX's does:
shard ``g`` belongs to host ``g // chips_per_host``.  The placement changes
no collective; ``comm_stats.dcn_halo_fraction`` reads which halo rows would
cross a host boundary.
"""

from __future__ import annotations

import dataclasses

import torch

MULTI_CARD = (
    "a mesh over more than one card is not ported yet: every shard of this "
    "port's mesh lives on one device (ROADMAP.md, Queue 1 item 8c)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[n_graph, n_feature]`` grid of shards, all on ``device``."""

    n_graph: int
    n_feature: int
    device: torch.device

    axis_names = ("graph", "feature")

    @property
    def shape(self) -> dict:
        return {"graph": self.n_graph, "feature": self.n_feature}

    @property
    def size(self) -> int:
        return self.n_graph * self.n_feature


def make_mesh(n_graph: int = 1, n_feature: int = 1, device="cuda") -> Mesh:
    """A ``('graph', 'feature')`` grid of ``n_graph x n_feature`` shards on
    ``device`` (one device: see the module docstring).  A list of devices
    naming more than one raises."""
    if n_graph < 1 or n_feature < 1:
        raise ValueError(f"mesh {n_graph}x{n_feature}: both sizes must be >= 1")
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) != 1:
            raise NotImplementedError(MULTI_CARD)
        device = devices.pop()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh on cuda, but torch finds no CUDA device")
    return Mesh(int(n_graph), int(n_feature), device)



def make_mesh_two_level(n_hosts: int, chips_per_host: int, n_feature: int = 1,
                        device="cuda") -> Mesh:
    """A ``('graph', 'feature')`` grid whose graph axis spans ``n_hosts *
    chips_per_host`` shards laid out host-major: shard ``g`` belongs to host
    ``g // chips_per_host``.  The partition gives consecutive graph indices
    contiguous window ranges, so a bandwidth-ordered graph's halo stays
    mostly within a host (``comm_stats.dcn_halo_fraction`` counts the rest).
    Axes and collectives are ``make_mesh``'s: every shard lives on
    ``device``, and a list naming more than one device raises."""
    return make_mesh(n_hosts * chips_per_host, n_feature, device)
