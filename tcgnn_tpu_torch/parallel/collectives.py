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
"""

from __future__ import annotations

import torch

AXES = ("graph", "feature")


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

    return _over(axis, grid, group)


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

    return _over(axis, grid, group)


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

    return _over(axis, grid, group)


def psum(grid, axis: str):
    """Sum over ``axis``, added in axis order; every member gets the sum."""

    def group(members):
        total = members[0]
        for m in members[1:]:
            total = total + m
        return [total] * len(members)

    return _over(axis, grid, group)
