"""The ``('graph', 'feature')`` shard grid of the distributed layer
(PyTorch port of ``tcgnn_tpu.parallel.mesh``).

Axes:
  * ``graph``   — row-window-aligned node and edge partition: each shard
    owns a contiguous range of row windows (``parallel/partition.py``);
  * ``feature`` — the embedding dimension, cut into ``n_feature`` equal
    column slices.

The grid runs in one process or over several, one a card, under
``torch.distributed`` (launched by ``torchrun``; ``init_process_group``
joins the group).  JAX drives every device from one controller; PyTorch's
idiom is one process a device, which also spans hosts.

* One process (``world == 1``): every shard of the grid lives on one device,
  and the collectives between shards are copies between shard views there
  (``parallel/collectives.py``).
* ``world`` processes take the grid in one of two layouts:

  - ``world`` divides ``n_graph``: the ranks split the graph axis.  Rank r
    holds graph shards ``[r * n_graph / world, (r + 1) * n_graph / world)``
    with every feature shard of them; feature-axis collectives stay copies
    inside a rank.
  - else, where ``world = Wg * n_feature`` and ``Wg`` divides ``n_graph``:
    rank ``r = rg * n_feature + f`` holds feature shard ``f`` of graph
    shards ``[rg * n_graph / Wg, (rg + 1) * n_graph / Wg)`` (JAX's own
    layout at ``world = n_graph * n_feature``: one device a shard).  Ranks
    are feature-minor, so a feature group sits on adjacent ranks.

  Graph-axis collectives run within a *graph group* (the ranks of one
  feature index), feature-axis ones within a *feature group* (the ranks of
  one graph block): subgroups every rank creates with ``dist.new_group``, in
  the same order.  Each rank holds the whole parameters, and the training
  step all-reduces their gradients (``parallel/train.py``).  One process
  given several devices raises (``MULTI_CARD``): the multi-card run over
  NCCL is ROADMAP.md, Queue 1 item 8c-iv.

The backend is NCCL for CUDA and gloo for the CPU.  gloo on CUDA tensors
(two ranks on one card, where NCCL refuses to run) is taken where it is asked
for, and then every transfer is staged through host memory
(``Mesh.staged``).

``make_mesh_two_level`` lays the graph axis out host-major, as JAX's does:
shard ``g`` belongs to host ``g // chips_per_host``; over processes rank r's
host is ``r // local_world``.  ``comm_stats.dcn_halo_fraction`` reads which
halo rows cross a host boundary.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

MULTI_CARD = (
    "one process drives one card: run one process a card under torchrun "
    "(torchrun --nproc_per_node N -m tcgnn_tpu_torch.train ... --mesh GxF; N divides G, or "
    "N = Wg * F with Wg dividing G); see ROADMAP.md, Queue 1 item 8c"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[n_graph, n_feature]`` grid of shards.  This process (``rank`` of
    ``world``) holds graph shards ``graph_shards`` and, of each, feature
    shards ``feature_shards`` on ``device``; ``local_world`` ranks share a
    host.  ``feature_world`` is 1 where a rank holds every feature shard,
    else ``n_feature`` (one feature shard a rank); ``graph_group`` and
    ``feature_group`` are the subgroups its graph-axis and feature-axis
    collectives run in (None: the default group, or no other rank)."""

    n_graph: int
    n_feature: int
    device: torch.device
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None
    local_world: int = 1
    feature_world: int = 1
    graph_group: object = dataclasses.field(default=None, compare=False, repr=False)
    feature_group: object = dataclasses.field(default=None, compare=False, repr=False)

    axis_names = ("graph", "feature")

    @property
    def shape(self) -> dict:
        return {"graph": self.n_graph, "feature": self.n_feature}

    @property
    def size(self) -> int:
        return self.n_graph * self.n_feature

    @property
    def graph_world(self) -> int:
        """Ranks along the graph axis (the size of a graph group)."""
        return self.world // self.feature_world

    @property
    def graph_rank(self) -> int:
        """This rank's place in its graph group: its block of graph shards."""
        return self.rank // self.feature_world

    @property
    def feature_rank(self) -> int:
        """This rank's place in its feature group (0 where it holds every
        feature shard)."""
        return self.rank % self.feature_world

    @property
    def graph_shards(self) -> range:
        """The graph shards this rank holds: a contiguous range."""
        per = self.n_graph // self.graph_world
        return range(self.graph_rank * per, (self.graph_rank + 1) * per)

    @property
    def feature_shards(self) -> range:
        """The feature shards this rank holds of each of its graph shards."""
        if self.feature_world == 1:
            return range(self.n_feature)
        return range(self.feature_rank, self.feature_rank + 1)

    def peer(self, axis: str, k: int) -> int:
        """The global rank of member ``k`` of this rank's ``axis`` group."""
        if axis == "graph":
            return k * self.feature_world + self.feature_rank
        return self.graph_rank * self.feature_world + k

    @property
    def host(self) -> int:
        return self.rank // self.local_world

    @property
    def staged(self) -> bool:
        """gloo moves CPU tensors only (apart from broadcast and all-reduce):
        on a card, each transfer goes through host memory."""
        return self.world > 1 and self.backend == "gloo" and self.device.type == "cuda"


def _subgroup(ranks: list, world: int):
    """The process group of ``ranks``: None (the default group) for the
    whole world, else a new group.  Every rank calls this for every group,
    with the same lists in the same order, as ``dist.new_group`` asks; a
    group that cannot form raises."""
    return None if len(ranks) == world else dist.new_group(list(ranks))


def init_process_group(device="cuda", backend: Optional[str] = None,
                       init_method: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without ``init_method`` the group comes from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with one
    (a ``file://`` store, ``tcp://localhost:<port>``), ``rank`` and
    ``world_size`` are given.  ``backend`` defaults to ``nccl`` on CUDA and
    ``gloo`` on the CPU.  On CUDA a device without an index takes
    ``LOCAL_RANK``'s card; ``torch.cuda.set_device`` runs before the group
    forms.  Nothing falls back: a group that cannot form raises."""
    device = torch.device(device)
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group: {', '.join(missing)} not set "
                               "(launch with torchrun, or pass init_method)")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("process group on cuda, but torch finds no CUDA device")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    # The first collective involves every rank (NCCL's rule for a group's
    # first point-to-point batch).
    dist.barrier()
    return device


def make_mesh(n_graph: int = 1, n_feature: int = 1, device="cuda",
              local_world: Optional[int] = None) -> Mesh:
    """A ``('graph', 'feature')`` grid of ``n_graph x n_feature`` shards.

    Where ``torch.distributed``'s group is initialized, the grid spans its
    ranks and ``device`` is this rank's (``init_process_group``'s): the
    graph axis split over them where ``world`` divides ``n_graph``, else one
    feature shard a rank where ``world = Wg * n_feature`` and ``Wg`` divides
    ``n_graph``; any other world raises ``ValueError``.  Without a group
    every shard lives on ``device``.  A list of devices naming more than
    one raises: one process drives one card."""
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
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(int(n_graph), int(n_feature), device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_graph % world == 0:
        fw = 1
    elif world % n_feature == 0 and n_graph % (world // n_feature) == 0:
        fw = n_feature
    else:
        raise ValueError(f"mesh {n_graph}x{n_feature} over {world} processes: the process "
                         "count must divide the graph axis, or be a multiple of the feature "
                         "axis whose quotient divides the graph axis")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    local_world = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    wg = world // fw
    # Every rank makes every group, graph groups first, in rank order.
    graph_groups = [_subgroup([rg * fw + f for rg in range(wg)], world) if wg > 1 else None
                    for f in range(fw)]
    feature_groups = [_subgroup([rg * fw + f for f in range(fw)], world) if fw > 1 else None
                      for rg in range(wg)]
    return Mesh(int(n_graph), int(n_feature), device, rank, world, dist.get_backend(),
                local_world, fw, graph_groups[rank % fw], feature_groups[rank // fw])


def make_mesh_two_level(n_hosts: int, chips_per_host: int, n_feature: int = 1,
                        device="cuda") -> Mesh:
    """A ``('graph', 'feature')`` grid whose graph axis spans ``n_hosts *
    chips_per_host`` shards laid out host-major: shard ``g`` belongs to host
    ``g // chips_per_host``.  The partition gives consecutive graph indices
    contiguous window ranges, so a bandwidth-ordered graph's halo stays
    mostly within a host (``comm_stats.dcn_halo_fraction`` counts the rest).

    Over processes the ranks are ``n_hosts`` hosts of ``world / n_hosts``
    ranks, rank-major within a host, so rank r (host ``r // local_world``)
    holds shards of its host only; where a rank holds one feature shard,
    ``local_world`` must be a multiple of ``n_feature``, so that a feature
    group stays on one host.  In one process every shard lives on
    ``device``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world % n_hosts:
            raise ValueError(f"{world} processes do not split into {n_hosts} hosts")
        local_world = world // n_hosts
        env = os.environ.get("LOCAL_WORLD_SIZE")
        if env is not None and int(env) != local_world:
            raise ValueError(f"LOCAL_WORLD_SIZE={env}, but {world} processes over {n_hosts} "
                             f"hosts make {local_world} a host")
        mesh = make_mesh(n_hosts * chips_per_host, n_feature, device, local_world)
        if local_world % mesh.feature_world:
            raise ValueError(f"{local_world} processes a host do not hold whole feature groups "
                             f"of {mesh.feature_world}")
        return mesh
    return make_mesh(n_hosts * chips_per_host, n_feature, device)
