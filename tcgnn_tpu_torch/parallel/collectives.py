"""Collectives over a shard grid (the port's counterparts of the
``jax.lax`` collectives that ``tcgnn_tpu.parallel.graph`` runs inside its
``shard_map``).

A shard grid is a list over the ``graph`` axis of lists over the
``feature`` axis: ``grid[g][f]`` is shard ``(g, f)``'s tensor.  Each
collective keeps its JAX semantics exactly:

* ``all_gather(grid, axis)`` — tiled: every member of an axis group gets
  its members' tensors concatenated along dim 0, in axis order;
* ``ppermute(grid, pairs, axis)`` — ``(src, dst)`` pairs along the axis; a
  member no pair sends to receives zeros.  ``ppermute_start`` is its
  started form: it issues the transfers and returns a ``Started`` whose
  ``wait()`` gives the grid, so work that does not need the result can be
  issued in between (``ppermute`` is start, then wait);
* ``all_to_all(grid, axis)`` — tiled, split and concatenated along dim 0:
  member ``s`` cuts its tensor into as many chunks as the axis has members,
  and chunk ``j`` lands on member ``j`` at position ``s``;
* ``psum(grid, axis)`` — every member gets the sum over its axis group,
  added in axis order;
* ``psum_scatter(grid, axis)`` — tiled: member ``j`` gets chunk ``j``
  (along dim 0) of the sum over its axis group (``lax.psum_scatter``).

In one process (``mesh`` None or of one rank) the grid holds every shard,
and a collective is a set of copies (or sums) between shard tensors on the
mesh's device; members of a group that receive the same value share one
tensor.  Over processes (``parallel/mesh.py``) the grid holds this rank's
members only: ``grid[i][j]`` is shard ``(mesh.graph_shards[i],
mesh.feature_shards[j])``.  Members on this rank still move by copies, and
a collective over an axis the rank does not hold whole crosses ranks
through ``torch.distributed``, within the rank's group of that axis
(``Mesh.graph_group``, ``Mesh.feature_group``), one call for all the
rank's members: ``all_gather_single`` (``all_gather_into_tensor``),
``batch_isend_irecv`` (one message a pair of ranks, peers by global rank),
``all_to_all_single``, ``all_reduce`` and ``reduce_scatter_single``
(``reduce_scatter_tensor``).  With
gloo on a card (``Mesh.staged``) every transfer goes through host memory.
``all_reduce_bucket`` sums a list of tensors over every rank in one call
(the training step's gradients).

Traffic accounting (``parallel/comm_stats.py``): inside ``recording(r)``,
each call reports ``(kind, bytes)`` to it under the JAX
package's kind names (``all_gather``, ``collective_permute``,
``all_to_all``, ``all_reduce`` for ``psum``, ``reduce_scatter`` for
``psum_scatter``).  The bytes are JAX's per-device
logical count, one member's result from its shape and dtype alone (no
device sync), not the copies a grid makes; one call over the grid is one
instance, as JAX emits one instruction for a collective over all of an
axis' groups, whatever the number of processes.  A ``ppermute`` with
``num_devices`` set weighs its bytes by the pairs it lists over every group
of the axis, over ``num_devices``: a member no pair sends to gets zeros,
which move nothing.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

AXES = ("graph", "feature")
# torch 2.13 names all_gather_into_tensor all_gather_single and
# reduce_scatter_tensor reduce_scatter_single (the old names warn); older
# versions have only the old ones.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)

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


def _record(recorder, kind: str, member_bytes: int, pairs=None, groups: int = 1) -> None:
    """Report one instance of ``kind`` to ``recorder``: one member's result
    bytes (a ``ppermute``'s weighed by its listed pairs over the axis'
    ``groups``, where the recorder has ``num_devices``)."""
    if pairs is not None and recorder.num_devices:
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


def _ranks(mesh, axis: str) -> bool:
    """Does a collective over ``axis`` cross ranks?"""
    _check_axis(axis)
    if mesh is None or mesh.world == 1:
        return False
    return (mesh.graph_world if axis == "graph" else mesh.feature_world) > 1


def _axis_world(mesh, axis: str) -> tuple:
    """``(ranks, this rank's place, group)`` along ``axis``."""
    if axis == "graph":
        return mesh.graph_world, mesh.graph_rank, mesh.graph_group
    return mesh.feature_world, mesh.feature_rank, mesh.feature_group


def _members(grid, axis: str):
    """The grid as ``[member along axis][group]``: the grid for ``graph``,
    its transpose for ``feature``; ``_members`` of the result undoes it."""
    return grid if axis == "graph" else _transposed(grid)


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: in host memory for gloo on a card."""
    return t.cpu() if mesh.staged else t


def _back(mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def _columns(members):
    """The rank's members stacked a group: ``[groups, L * m, ...]``, the
    members of each group concatenated in axis order."""
    return torch.stack([torch.cat(col) for col in _transposed(members)])


def all_gather(grid, axis: str = "graph", mesh=None):
    """Tiled all-gather along dim 0 over ``axis``."""

    def group(members):
        full = torch.cat(members, dim=0)
        return [full] * len(members)

    if _ranks(mesh, axis):
        world, _, pg = _axis_world(mesh, axis)
        members = _members(grid, axis)
        local = _staged(mesh, _columns(members))
        full = local.new_empty((world * local.shape[0],) + tuple(local.shape[1:]))
        _all_gather_single(full, local, group=pg)
        full = _back(mesh, full).view((world,) + tuple(local.shape))
        cols = [full[:, j].reshape((-1,) + tuple(full.shape[3:])) for j in range(full.shape[1])]
        out = _members([list(cols) for _ in members], axis)
    else:
        out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _equal_shapes(grid)
        _record(recorder, "all_gather", _nbytes(out[0][0]))
    return out


class Started:
    """A collective in flight: ``wait()`` finishes it (once) and gives its
    grid.  Until then it holds what the transfer reads and writes."""

    def __init__(self, finish):
        self._finish, self._out = finish, None

    @classmethod
    def done(cls, out) -> "Started":
        return cls(lambda: out)

    def wait(self):
        if self._finish is not None:
            self._out, self._finish = self._finish(), None
        return self._out


def ppermute(grid, pairs, axis: str = "graph", mesh=None):
    """Send member ``src``'s tensor to member ``dst`` for every ``(src,
    dst)`` in ``pairs``; members that receive nothing get zeros."""
    return ppermute_start(grid, pairs, axis, mesh).wait()


def ppermute_start(grid, pairs, axis: str = "graph", mesh=None, tag: int = 0) -> Started:
    """``ppermute``, started: over ranks the round's sends and receives are
    issued (``batch_isend_irecv``, under ``tag``: rounds in flight together
    take distinct tags) and ``wait()`` waits on them; in one process the
    copies are made here.  The recorder counts the call here."""

    def group(members):
        out = [None] * len(members)
        for src, dst in pairs:
            if out[dst] is not None:
                raise ValueError(f"ppermute: member {dst} receives twice")
            out[dst] = members[src]
        return [torch.zeros_like(m) if o is None else o for m, o in zip(members, out)]

    if _ranks(mesh, axis):
        started = _ppermute_ranks(_members(grid, axis), pairs, axis, mesh, tag)
        out = Started(lambda: _members(started.wait(), axis))
    else:
        out = Started.done(_over(axis, grid, group))
    recorder = _recorder
    if recorder is not None:
        # The axis' groups over the whole grid: a group a shard of the other
        # axis, this rank's or another's.
        if mesh is not None:
            groups = mesh.n_feature if axis == "graph" else mesh.n_graph
        else:
            groups = len(grid[0]) if axis == "graph" else len(grid)
        _record(recorder, "collective_permute", _nbytes(_equal_shapes(grid)), pairs, groups)
    return out


def _ppermute_ranks(members, pairs, axis, mesh, tag) -> Started:
    """A ``ppermute`` over ranks on ``members[i][j]`` (member i of this
    rank's along the axis, of group j), started: pairs within this rank are
    copies; the members one rank sends another travel as one message, in
    pair order, every group of them.  The send buffers (staged in host
    memory for gloo on a card, before the sends are issued) live until
    ``wait()``, which copies what arrived back to the device."""
    dsts = [dst for _, dst in pairs]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a member receives twice in {pairs}")
    _, me, _ = _axis_world(mesh, axis)
    per = len(members)
    g0 = me * per
    proto = _equal_shapes(members)
    out = [None] * per
    sends, recvs = {}, {}  # peer's place on the axis -> this rank's members, in pair order
    for src, dst in pairs:
        s_rank, d_rank = src // per, dst // per
        if s_rank == d_rank == me:
            out[dst - g0] = members[src - g0]
        elif s_rank == me:
            sends.setdefault(d_rank, []).append(src - g0)
        elif d_rank == me:
            recvs.setdefault(s_rank, []).append(dst - g0)
    groups = len(members[0])
    ops, inbox = [], []
    for peer, idx in sorted(sends.items()):
        buf = _staged(mesh, torch.stack([torch.stack(members[i]) for i in idx]))
        ops.append(dist.P2POp(dist.isend, buf.contiguous(), mesh.peer(axis, peer), tag=tag))
    for peer, idx in sorted(recvs.items()):
        buf = torch.empty((len(idx), groups) + tuple(proto.shape), dtype=proto.dtype,
                          device="cpu" if mesh.staged else proto.device)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis, peer), tag=tag))
        inbox.append((idx, buf))
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def finish():
        for req in reqs:
            req.wait()
        ops.clear()  # the send buffers, held until here
        for idx, buf in inbox:
            buf = _back(mesh, buf)
            for k, i in enumerate(idx):
                out[i] = list(buf[k].unbind(0))
        return [[torch.zeros_like(m) for m in row] if o is None else o
                for row, o in zip(members, out)]

    return Started(finish)


def all_to_all(grid, axis: str = "graph", mesh=None):
    """Tiled all-to-all along dim 0: member ``s``'s chunk ``j`` lands on
    member ``j`` at position ``s``."""

    def check(members, n):
        for m in members:
            if m.shape[0] % n:
                raise ValueError(f"all_to_all: dim 0 of {tuple(m.shape)} "
                                 f"does not split into {n} chunks")

    def group(members):
        n = len(members)
        check(members, n)
        chunks = [torch.chunk(m, n, dim=0) for m in members]
        return [torch.cat([chunks[s][j] for s in range(n)], dim=0) for j in range(n)]

    if _ranks(mesh, axis):
        # Member (i, q)'s chunks as [w, per, c, ...]: the chunks bound for
        # each rank of the axis, in member order.  The send stack is [w
        # (dest rank), per (source member), per (dest member), groups, c,
        # ...]; the received one has the source rank first.
        w, _, pg = _axis_world(mesh, axis)
        members = _members(grid, axis)
        per = len(members)
        check([m for row in members for m in row], w * per)
        proto = members[0][0]
        c, rest = proto.shape[0] // (w * per), tuple(proto.shape[1:])
        send = torch.stack([torch.stack([m.reshape((w, per, c) + rest) for m in row])
                            for row in members])       # [per_i, groups, w, per_j, c, ...]
        send = _staged(mesh, send.movedim(2, 0).movedim(3, 2).contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=pg)
        recv = _back(mesh, recv)                       # [w, per_i, per_j, groups, c, ...]
        out = _members([[recv[:, :, j, q].reshape((-1,) + rest)
                         for q in range(len(members[0]))] for j in range(per)], axis)
    else:
        out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _record(recorder, "all_to_all", _nbytes(_equal_shapes(grid)))
    return out


def _rank_sums(members):
    """Each group's members on this rank summed in axis order."""
    sums = []
    for col in _transposed(members):
        total = col[0]
        for m in col[1:]:
            total = total + m
        sums.append(total)
    return sums


def psum(grid, axis: str, mesh=None):
    """Sum over ``axis``, added in axis order; every member gets the sum.
    Over ranks, each rank's members are summed in axis order and the ranks'
    sums all-reduced (groups of any shapes, flattened into one call)."""

    def group(members):
        total = members[0]
        for m in members[1:]:
            total = total + m
        return [total] * len(members)

    if _ranks(mesh, axis):
        _, _, pg = _axis_world(mesh, axis)
        members = _members(grid, axis)
        sums = _rank_sums(members)
        flat = _staged(mesh, torch.cat([t.reshape(-1) for t in sums]))
        dist.all_reduce(flat, group=pg)
        flat = _back(mesh, flat)
        total, pos = [], 0
        for t in sums:
            total.append(flat[pos:pos + t.numel()].view_as(t))
            pos += t.numel()
        out = _members([list(total) for _ in members], axis)
    else:
        out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        # Groups may differ from each other (the block-diagonal route's
        # per-shard cell scores): the largest group's result counts.
        _record(recorder, "all_reduce", max(_nbytes(t) for row in out for t in row))
    return out


def psum_scatter(grid, axis: str, mesh=None):
    """Tiled reduce-scatter along dim 0 over ``axis``: member ``j`` gets
    chunk ``j`` of the group's sum, added in axis order.  Over ranks, each
    rank's members are summed in axis order and the ranks' sums
    reduce-scattered."""

    def group(members):
        total = members[0]
        for m in members[1:]:
            total = total + m
        if total.shape[0] % len(members):
            raise ValueError(f"psum_scatter: dim 0 of {tuple(total.shape)} does not split "
                             f"into {len(members)} chunks")
        return list(torch.chunk(total, len(members), dim=0))

    if _ranks(mesh, axis):
        w, _, pg = _axis_world(mesh, axis)
        members = _members(grid, axis)
        per = len(members)
        sums = torch.stack(_rank_sums(members))           # [groups, w * per * c, ...]
        if sums.shape[1] % (w * per):
            raise ValueError(f"psum_scatter: dim 0 of {tuple(sums.shape[1:])} does not split "
                             f"into {w * per} chunks")
        c, rest = sums.shape[1] // (w * per), tuple(sums.shape[2:])
        # [w, groups, per, c, ...]: rank k's chunks first, as the call cuts.
        send = _staged(mesh, sums.reshape((sums.shape[0], w, per, c) + rest)
                       .movedim(1, 0).contiguous())
        recv = send.new_empty(tuple(send.shape[1:]))
        _reduce_scatter_single(recv.view(-1), send.view(-1), group=pg)
        recv = _back(mesh, recv)                          # [groups, per, c, ...]
        out = _members([[recv[q, i] for q in range(recv.shape[0])] for i in range(per)], axis)
    else:
        out = _over(axis, grid, group)
    recorder = _recorder
    if recorder is not None:
        _equal_shapes(grid)
        _record(recorder, "reduce_scatter", _nbytes(out[0][0]))
    return out


def all_reduce_bucket(tensors, mesh) -> None:
    """Sum each tensor over every rank in place, all of them flattened into
    one bucket and one ``all_reduce`` (one instance of the bucket's bytes
    to the recorder).  The tensors share a dtype."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    recorder = _recorder
    if recorder is not None:
        recorder.add("all_reduce", _nbytes(flat))
    staged = _staged(mesh, flat)
    dist.all_reduce(staged)
    flat = _back(mesh, staged)
    pos = 0
    for t in tensors:
        t.copy_(flat[pos:pos + t.numel()].view_as(t))
        pos += t.numel()


def all_reduce_max(values, mesh) -> list:
    """The largest of each of ``values`` (floats) over every rank."""
    t = torch.tensor(values, dtype=torch.float64,
                     device="cpu" if mesh.staged or mesh.device.type == "cpu" else mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()
