"""Collectives over a shard grid (the port's counterparts of the
``jax.lax`` collectives that ``tcgnn_tpu.parallel.graph`` runs inside its
``shard_map``).

A shard grid is a list over the ``graph`` axis of lists over the
``feature`` axis: ``grid[g][f]`` is shard ``(g, f)``'s tensor.  Every shard
lives on the mesh's one device, so a collective is a set of copies (or
sums) between shard tensors there; each keeps its JAX semantics exactly:

* ``all_gather(grid, axis)`` — tiled: every member of an axis group gets
  its members' tensors concatenated along dim 0, in axis order;
* ``ppermute(grid, pairs, axis)`` — ``(src, dst)`` pairs along the axis; a
  member no pair sends to receives zeros;
* ``all_to_all(grid, axis)`` — tiled, split and concatenated along dim 0:
  member ``s`` cuts its tensor into as many chunks as the axis has members,
  and chunk ``j`` lands on member ``j`` at position ``s``;
* ``psum(grid, axis)`` — every member gets the sum over its axis group,
  added in axis order.

Members of a group that receive the same value share one tensor.

Traffic accounting (``parallel/comm_stats.py``): inside ``recording(r)``,
each call reports ``(kind, bytes)`` to it under the JAX
package's kind names (``all_gather``, ``collective_permute``,
``all_to_all``, ``all_reduce`` for ``psum``).  The bytes are JAX's per-device
logical count, one member's result from its shape and dtype alone (no
device sync), not the copies this one-device grid makes; one call over the
grid is one instance, as JAX emits one instruction for a collective over
all of an axis' groups.  A ``ppermute`` with ``num_devices`` set weighs its
bytes by the pairs it lists over every group of the axis, over
``num_devices``: a member no pair sends to gets zeros, which move nothing.
"""

from __future__ import annotations

import contextlib

import torch

AXES = ("graph", "feature")

# The active traffic recorder (``comm_stats.Recorder``), or None.  A module
# attribute, not a context variable: autograd runs a CUDA backward on its
# own device thread, which sees no context variable the caller set, and the
# backward's collectives must be counted.
_recorder = None


@contextlib.contextmanager
def recording(recorder):
    """Report every collective run inside the block, on any thread, to
    ``recorder``."""
    global _recorder
    previous, _recorder = _recorder, recorder
    try:
        yield recorder
    finally:
        _recorder = previous


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(recorder, kind: str, grid, member_bytes: int, pairs=None,
            axis: str = "graph") -> None:
    """Report one instance of ``kind`` to ``recorder``: one member's result
    bytes (a ``ppermute``'s weighed by its listed pairs over every group of
    ``axis``, where the recorder has ``num_devices``)."""
    if pairs is not None and recorder.num_devices:
        groups = len(grid[0]) if axis == "graph" else len(grid)
        member_bytes = int(round(member_bytes * len(pairs) * groups / recorder.num_devices))
    recorder.add(kind, member_bytes)


def _equal_shapes(grid) -> torch.Tensor:
    shapes = {tuple(t.shape) for row in grid for t in row}
    if len(shapes) != 1:
        raise ValueError(f"collective over members of different shapes {sorted(shapes)}")
    return grid[0][0]


def _check_axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXES}")


def _transposed(grid):
    return [list(col) for col in zip(*grid)]


def _over(axis, grid, fn):
    """Apply ``fn`` (one graph-axis group -> its outputs) to every group of
    ``axis``: the columns of the grid for ``graph``, its rows for
    ``feature``."""
    _check_axis(axis)
    if axis == "feature":
        return [fn(list(row)) for row in grid]
    return _transposed([fn(list(col)) for col in _transposed(grid)])


def all_gather(grid, axis: str = "graph"):
    """Tiled all-gather along dim 0 over ``axis``."""

    def group(members):
        full = torch.cat(members, dim=0)
        return [full] * len(members)

    out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _equal_shapes(grid)
        _record(recorder, "all_gather", grid, _nbytes(out[0][0]))
    return out


def ppermute(grid, pairs, axis: str = "graph"):
    """Send member ``src``'s tensor to member ``dst`` for every ``(src,
    dst)`` in ``pairs``; members that receive nothing get zeros."""

    def group(members):
        out = [None] * len(members)
        for src, dst in pairs:
            if out[dst] is not None:
                raise ValueError(f"ppermute: member {dst} receives twice")
            out[dst] = members[src]
        return [torch.zeros_like(m) if o is None else o for m, o in zip(members, out)]

    out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _record(recorder, "collective_permute", grid, _nbytes(_equal_shapes(grid)), pairs, axis)
    return out


def all_to_all(grid, axis: str = "graph"):
    """Tiled all-to-all along dim 0: member ``s``'s chunk ``j`` lands on
    member ``j`` at position ``s``."""

    def group(members):
        n = len(members)
        for m in members:
            if m.shape[0] % n:
                raise ValueError(f"all_to_all: dim 0 of {tuple(m.shape)} "
                                 f"does not split into {n} chunks")
        chunks = [torch.chunk(m, n, dim=0) for m in members]
        return [torch.cat([chunks[s][j] for s in range(n)], dim=0) for j in range(n)]

    out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _record(recorder, "all_to_all", grid, _nbytes(_equal_shapes(grid)))
    return out


def psum(grid, axis: str):
    """Sum over ``axis``, added in axis order; every member gets the sum."""

    def group(members):
        total = members[0]
        for m in members[1:]:
            total = total + m
        return [total] * len(members)

    out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        # Groups may differ from each other (the block-diagonal route's
        # per-shard cell scores): the largest group's result counts.
        _record(recorder, "all_reduce", grid, max(_nbytes(t) for row in out for t in row))
    return out
