"""Row-window-aligned partition of a graph over the mesh's graph axis
(PyTorch port of ``tcgnn_tpu.parallel.partition``).

A shard owns a contiguous range of ``windows_per_shard`` row windows.  The
SGT pass is strictly per window, so each shard's tiling is the matching
slice of a single-device tiling.  Per-shard arrays are padded to common
shapes and stacked on a leading ``[num_shards, ...]`` axis; a shard's edges
are the contiguous CSR slice of its rows.

The JAX host pass, carried over with the same arrays field by field
(``tests/test_torch_partition.py`` holds the two to ``np.array_equal``):
the stacked metadata (``_stack_shards``), the mega-window block-stream
split (``build_split``), the boundary halo (``plan_halo_rounds``,
``build_halo``), and both directions (``partition_graph``).  Two
differences.  The JAX pass also builds local/remote block classes for its
halo-overlap split; the port's ops run one pass over a shard's whole block
stream (``parallel/graph.py``), so it builds none.  Tiles whose duplicate
count passes 127 are f32 on the host whatever the compute dtype (NumPy has
no bfloat16); the device copy takes the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tcgnn_tpu_torch.config import DEFAULT_CONFIG, TileConfig
from tcgnn_tpu_torch.sgt.translate import (
    SGTMeta,
    build_a_tiles_host,
    sparse_graph_translate,
    transpose_csr,
)


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass
class ShardedSGTMeta:
    """Stacked per-shard SGT metadata (host NumPy).

    Shapes: G = num_shards, Cn = chunk capacity, EC = edge_chunk, Bw = block
    capacity * blk_w, Emax = edge capacity.  ``chunk_edge_id`` holds local
    edge ids with sentinel ``Emax``; ``edge_fwd_slot`` (transpose only) holds
    forward padded-layout slots ``shard * Emax + local`` with sentinel
    ``G * Emax``, the index space of an all-gathered edge vector.
    """

    config: TileConfig
    num_shards: int
    num_nodes: int
    num_edges: int
    rows_per_shard: int     # Wd * blk_h
    windows_per_shard: int  # Wd
    edge_capacity: int      # Emax
    num_real_blocks: int    # summed over shards == single-device TC_Blocks

    edge_start: np.ndarray        # [G+1] int64
    col_ids: np.ndarray           # [G, Bw] int32
    a_tiles: np.ndarray           # [G, Bmax, blk_h, blk_w] int8 (f32 past 127)
    block_window: np.ndarray      # [G, Bmax] int32 (pad -> last window)
    block_first_in_window: np.ndarray  # [G, Bmax] int32 (pad -> 0)
    edge_pos: np.ndarray          # [G, Emax] int32 (pad -> 0)
    chunk_r: np.ndarray           # [G, Cn, EC] int32
    chunk_c: np.ndarray           # [G, Cn, EC] int32
    chunk_edge_id: np.ndarray     # [G, Cn, EC] int32
    chunk_block: np.ndarray       # [G, Cn] int32
    chunk_window: np.ndarray      # [G, Cn] int32
    chunk_first_in_window: np.ndarray  # [G, Cn] int32
    edge_perm: np.ndarray         # [G, Emax] int32
    edge_valid: np.ndarray        # [G, Emax] bool
    chunk_fwd_slot: Optional[np.ndarray] = None  # [G, Cn, EC] int32
    edge_fwd_slot: Optional[np.ndarray] = None  # [G, Emax] int32
    # Boundary halo (build_halo): "offset_caps", "rounds" ((pos, size,
    # pairs), ...), "halo_rows", "send_idx" [G, halo_rows], "col_ids_ext"
    # [G, Bw], "pair_counts", ...
    halo: Optional[dict] = None
    # Block-stream split (build_split): "a_tiles" [G, Bs, bh, bw],
    # "col_ids_ext" [G, Bs*bw], "block_window"/"block_first" [G, Bs],
    # "guest_cap", "pair_cap", "send_pos", "recv_row_idx", "edge_pos",
    # "w_src", "xa_fetch", "col_ids_global".
    split: Optional[dict] = None

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def padded_edges(self) -> int:
        return self.num_shards * self.edge_capacity


def _pad_axis0(a: np.ndarray, target: int, fill) -> np.ndarray:
    if a.shape[0] == target:
        return a
    pad = np.full((target - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _tile_dtype(tiles_per_shard: list):
    """int8 structural tiles, or f32 for every shard when a duplicate count
    passes 127 (stacking stays homogeneous, no count wraps)."""
    if max(t.max(initial=0.0) for t in tiles_per_shard) <= 127:
        return np.int8
    return np.float32


def _stack_shards(
    metas: list[SGTMeta],
    edge_start: np.ndarray,
    num_nodes: int,
    num_edges: int,
    rows_per_shard: int,
    config: TileConfig,
    edge_capacity: Optional[int] = None,
    tiles_per_shard: Optional[list] = None,
) -> ShardedSGTMeta:
    G = len(metas)
    blk_w = config.blk_w
    cn_max = max(m.num_chunks for m in metas)
    group = max(int(config.block_group), 1)
    b_max = -(-max(m.num_blocks for m in metas) // group) * group
    counts = np.diff(edge_start)
    e_max = int(edge_capacity if edge_capacity is not None else max(counts.max(), 1))
    last_window = rows_per_shard // config.blk_h - 1

    if tiles_per_shard is None:
        tiles_per_shard = [build_a_tiles_host(m) for m in metas]
    tile_np_dtype = _tile_dtype(tiles_per_shard)

    col_ids, chunk_r, chunk_c, chunk_eid = [], [], [], []
    chunk_block, chunk_window, chunk_first = [], [], []
    edge_perm, edge_valid = [], []
    a_tiles, block_window, block_first, edge_pos = [], [], [], []
    for s, m in enumerate(metas):
        e_s = int(counts[s])
        col_ids.append(_pad_axis0(m.col_ids, b_max * blk_w, 0))
        a_tiles.append(_pad_axis0(tiles_per_shard[s].astype(tile_np_dtype), b_max, 0))
        # Padding blocks: zero tiles, first 0, the shard's last window.
        block_window.append(_pad_axis0(m.block_window, b_max, last_window))
        block_first.append(_pad_axis0(m.block_first_in_window, b_max, 0))
        edge_pos.append(_pad_axis0(m.edge_pos.astype(np.int32), e_max, 0))
        chunk_r.append(_pad_axis0(m.chunk_r, cn_max, config.row_sentinel))
        chunk_c.append(_pad_axis0(m.chunk_c, cn_max, 0))
        eid = m.chunk_edge_id.copy()
        eid[eid == m.num_edges] = e_max  # local pad sentinel -> Emax
        chunk_eid.append(_pad_axis0(eid, cn_max, e_max))
        chunk_block.append(_pad_axis0(m.chunk_block, cn_max, 0))
        chunk_window.append(_pad_axis0(m.chunk_window, cn_max, last_window))
        chunk_first.append(_pad_axis0(m.chunk_first_in_window, cn_max, 0))
        edge_perm.append(_pad_axis0(m.edge_perm, e_max, 0))
        valid = np.zeros(e_max, dtype=bool)
        valid[:e_s] = True
        edge_valid.append(valid)

    return ShardedSGTMeta(
        config=config,
        num_shards=G,
        num_nodes=num_nodes,
        num_edges=num_edges,
        rows_per_shard=rows_per_shard,
        windows_per_shard=rows_per_shard // config.blk_h,
        edge_capacity=e_max,
        num_real_blocks=sum(m.num_real_blocks for m in metas),
        edge_start=edge_start.astype(np.int64),
        col_ids=np.stack(col_ids),
        a_tiles=np.stack(a_tiles),
        block_window=np.stack(block_window),
        block_first_in_window=np.stack(block_first),
        edge_pos=np.stack(edge_pos),
        chunk_r=np.stack(chunk_r),
        chunk_c=np.stack(chunk_c),
        chunk_edge_id=np.stack(chunk_eid),
        chunk_block=np.stack(chunk_block),
        chunk_window=np.stack(chunk_window),
        chunk_first_in_window=np.stack(chunk_first),
        edge_perm=np.stack(edge_perm),
        edge_valid=np.stack(edge_valid),
    )


def build_split(
    metas: list,
    rows_per_shard: int,
    config: TileConfig,
    imbalance_gate: float = 1.3,
    tiles_per_shard: Optional[list] = None,
    edge_capacity: Optional[int] = None,
) -> Optional[dict]:
    """Mega-window block-stream split for the dense SpMM, both flavours, and
    the fused AGNN.

    Overloaded windows keep the head of their block stream; underloaded
    shards compute consecutive tail slices as appended guest windows,
    placed by column affinity (the shard owning the median column of the
    slice), and return partial ``[blk_h, d]`` output tiles to the owners by
    one all_to_all (``send_pos`` / ``recv_row_idx``).  Per-edge maps
    (``edge_pos``, ``w_src``) let the weighted SpMM rebuild its tiles on the
    computing shard from an all-gathered edge vector; ``xa_fetch`` gives a
    guest slot its owner's window rows for the fused AGNN's score tiles.

    None when ``max shard load <= imbalance_gate * ideal``, or with
    ``block_group != 1``.
    """
    g = len(metas)
    blk_h, blk_w = config.blk_h, config.blk_w
    wd = rows_per_shard // blk_h
    if g <= 1 or config.block_group != 1:
        return None

    win_counts = [np.bincount(m.block_window, minlength=wd).astype(np.int64) for m in metas]
    loads = np.array([int(c.sum()) for c in win_counts])
    total = int(loads.sum())
    ideal = -(-total // g)
    if loads.max() <= imbalance_gate * ideal:
        return None

    # ---- exports: (owner, window, keep, count) ---------------------------
    slack = max(ideal // 20, 1)
    cap = np.maximum(ideal + slack - loads, 0)
    exports = []
    for s in range(g):
        excess = int(loads[s] - ideal)
        if excess <= 0:
            continue
        for w in np.argsort(-win_counts[s], kind="stable"):
            if excess <= 0:
                break
            cnt = int(win_counts[s][w])
            keep = max(1, cnt - excess)
            if cnt - keep <= 0:
                continue
            exports.append((s, int(w), keep, cnt))
            excess -= cnt - keep
            loads[s] -= cnt - keep
    if not exports:
        return None

    # ---- consecutive slices placed by column affinity --------------------
    win_start = [np.cumsum(np.concatenate([[0], c[:-1]])) for c in win_counts]
    parts: list[list[tuple]] = [[] for _ in range(g)]
    for (o, w, keep, cnt) in exports:
        base = int(win_start[o][w])
        cols = metas[o].col_ids.reshape(-1, blk_w)
        b = keep
        while b < cnt:
            med = int(np.median(cols[base + b]))
            aff = min(med // rows_per_shard, g - 1)
            c = aff if (aff != o and cap[aff] > 0) else int(np.argmax(cap))
            if c == o or cap[c] <= 0:
                c = int(np.argmin(loads))
                if c == o:
                    break
            take = int(min(cnt - b, max(cap[c], 16)))
            parts[c].append((o, w, base + b, base + b + take))
            cap[c] -= take
            loads[c] += take
            b += take
    if not any(parts):
        return None
    for c in range(g):
        parts[c].sort()

    gcap = max(len(p) for p in parts)
    pair_n = np.zeros((g, g), np.int64)
    for c in range(g):
        for (o, _, _, _) in parts[c]:
            pair_n[c, o] += 1
    qcap = int(pair_n.max())

    exported = [np.zeros(int(c.sum()), bool) for c in win_counts]
    for c in range(g):
        for (o, _, lo, hi) in parts[c]:
            exported[o][lo:hi] = True

    # ---- per-shard streams: own survivors, then guest slices -------------
    tiles_list = (
        tiles_per_shard if tiles_per_shard is not None
        else [build_a_tiles_host(m) for m in metas]
    )
    tdt = _tile_dtype(tiles_list)
    blk_comp = [np.full(int(c.sum()), -1, np.int64) for c in win_counts]
    blk_newpos = [np.full(int(c.sum()), -1, np.int64) for c in win_counts]

    a_tiles, col_ids, block_window, block_first = [], [], [], []
    send_pos = np.full((g, max(gcap, 1)), g * max(qcap, 1), np.int32)
    recv_row = np.full((g, g, max(qcap, 1)), rows_per_shard, np.int32)
    for c in range(g):
        keep_mask = ~exported[c]
        kept_idx = np.flatnonzero(keep_mask)
        blk_comp[c][kept_idx] = c
        blk_newpos[c][kept_idx] = np.arange(len(kept_idx))
        stream_off = len(kept_idx)
        t = [tiles_list[c][keep_mask].astype(tdt)]
        ci = [metas[c].col_ids.reshape(-1, blk_w)[keep_mask]]
        bw = [metas[c].block_window[keep_mask]]
        bf = [metas[c].block_first_in_window[keep_mask]]
        lane_used = np.zeros(g, np.int64)
        for j, (o, w, lo, hi) in enumerate(parts[c]):
            blk_comp[o][lo:hi] = c
            blk_newpos[o][lo:hi] = stream_off + np.arange(hi - lo)
            stream_off += hi - lo
            t.append(tiles_list[o][lo:hi].astype(tdt))
            ci.append(metas[o].col_ids.reshape(-1, blk_w)[lo:hi])
            bw.append(np.full(hi - lo, wd + j, np.int32))
            first = np.zeros(hi - lo, np.int32)
            first[0] = 1
            bf.append(first)
            lane = int(lane_used[o])
            lane_used[o] += 1
            send_pos[c, j] = o * qcap + lane
            recv_row[o, c, lane] = w * blk_h
        # Unused guest slots: one zero block each, so their output is defined.
        for j in range(len(parts[c]), gcap):
            t.append(np.zeros((1, blk_h, blk_w), tdt))
            ci.append(np.zeros((1, blk_w), metas[c].col_ids.dtype))
            bw.append(np.full(1, wd + j, np.int32))
            bf.append(np.ones(1, np.int32))
        a_tiles.append(np.concatenate(t))
        col_ids.append(np.concatenate(ci).reshape(-1))
        block_window.append(np.concatenate(bw).astype(np.int32))
        block_first.append(np.concatenate(bf).astype(np.int32))

    bs = max(a.shape[0] for a in a_tiles)

    # ---- per-edge maps of the weighted split stream ----------------------
    # Per real edge (owner o, local slot e): its cell in the computing
    # shard's split tile space (sentinel bs*tile) and its slot o*Emax+e in
    # the all-gathered forward edge vector (sentinel g*Emax).
    tile = blk_h * blk_w
    e_max = int(edge_capacity) if edge_capacity is not None else max(
        max(m.num_edges for m in metas), 1
    )
    if bs * tile >= 2**31 or g * e_max >= 2**31:
        return None
    pos_lists: list[list] = [[] for _ in range(g)]
    src_lists: list[list] = [[] for _ in range(g)]
    for o in range(g):
        ep = metas[o].edge_pos.astype(np.int64)
        b = ep // tile
        comp = blk_comp[o][b]
        newpos = blk_newpos[o][b] * tile + ep % tile
        src = o * e_max + np.arange(len(ep), dtype=np.int64)
        for c in range(g):
            sel = comp == c
            pos_lists[c].append(newpos[sel])
            src_lists[c].append(src[sel])
    pos_cat = [np.concatenate(p) for p in pos_lists]
    src_cat = [np.concatenate(s) for s in src_lists]
    es = max(1, max(len(p) for p in pos_cat))
    edge_pos_split = np.full((g, es), bs * tile, np.int32)
    w_src = np.full((g, es), g * e_max, np.int32)
    for c in range(g):
        edge_pos_split[c, : len(pos_cat[c])] = pos_cat[c].astype(np.int32)
        w_src[c, : len(src_cat[c])] = src_cat[c].astype(np.int32)

    last = wd + max(gcap, 1) - 1
    split = {
        "a_tiles": np.stack([_pad_axis0(a, bs, 0) for a in a_tiles]),
        "col_ids": np.stack(
            [_pad_axis0(cil.reshape(-1, blk_w), bs, 0).reshape(-1) for cil in col_ids]
        ),
        "block_window": np.stack([_pad_axis0(b, bs, last) for b in block_window]),
        "block_first": np.stack([_pad_axis0(b, bs, 0) for b in block_first]),
        "guest_cap": gcap,
        "pair_cap": qcap,
        "send_pos": send_pos,
        "edge_pos": edge_pos_split,
        "w_src": w_src,
    }
    # Guest slot j's owner-window rows sit at send_pos[j]*blk_h of the
    # owner-row all_to_all stack [G*qcap*blk_h]; sentinel slots gather out
    # of bounds (zeros).
    split["xa_fetch"] = (
        send_pos[:, :, None].astype(np.int64) * blk_h + np.arange(blk_h, dtype=np.int64)
    ).reshape(g, -1).astype(np.int32)
    # Owner-side targets of each incoming partial row (sentinel
    # rows_per_shard: dropped).
    rr = recv_row[:, :, :, None] + np.arange(blk_h, dtype=np.int32)
    rr = np.where(recv_row[:, :, :, None] >= rows_per_shard, rows_per_shard, rr)
    split["recv_row_idx"] = rr.reshape(g, -1).astype(np.int32)
    return split


def plan_halo_rounds(
    pair_counts,
    *,
    target_overhead: float = 1.2,
    slack_rows: int = 64,
    max_rounds_per_offset: int = 16,
):
    """Quantized partial-pair exchange schedule over the pair matrix.

    Per owner offset o (requester s pulls from owner ``(s+o) % G``), the
    offset's segment of the halo is cut into rounds of quantum Q; round j
    moves rows ``[j*Q, j*Q+size)`` and lists only the pairs still owing
    rows.  Q is the largest halving of the offset's cap whose scheduled
    volume is within ``target_overhead`` of the ideal (plus ``slack_rows``
    a pair), at most ``max_rounds_per_offset`` rounds.

    Returns ``(offset_caps, rounds, halo_rows)``; a round is ``(pos, size,
    pairs)`` with ``pairs`` a tuple of ``(src, dst)`` shards.
    """
    G = len(pair_counts)
    offset_caps = []
    rounds = []
    pos = 0
    for o in range(1, G):
        p = [int(pair_counts[s][(s + o) % G]) for s in range(G)]
        cap = max(p)
        if cap == 0:
            continue
        ideal = sum(p)
        budget = target_overhead * ideal + slack_rows * sum(1 for pi in p if pi)

        def schedule(q):
            sizes = []
            start = 0
            while start < cap:
                sizes.append(min(q, cap - start))
                start += q
            wire = sum(sz * sum(1 for pi in p if pi > j * q) for j, sz in enumerate(sizes))
            return sizes, wire

        q = cap
        while True:
            sizes, wire = schedule(q)
            if wire <= budget or len(sizes) * 2 > max_rounds_per_offset:
                break
            q = -(-q // 2)
        for j, sz in enumerate(sizes):
            pairs = tuple(((s + o) % G, s) for s in range(G) if p[s] > j * q)
            rounds.append((pos + j * q, sz, pairs))
        offset_caps.append((o, cap))
        pos += cap
    return tuple(offset_caps), tuple(rounds), pos


def build_halo(
    local_cols_list: list[np.ndarray],
    col_ids_stacked: np.ndarray,
    num_shards: int,
    rows_per_shard: int,
    extra_cols_list: Optional[list] = None,
    split_col_ids: Optional[np.ndarray] = None,
) -> dict:
    """Boundary-only halo of every shard.

    Shard s's remote set is the sorted unique columns its edges (and guest
    windows) reference outside its rows.  Its extended slab is
    ``[rows_per_shard + halo_rows]``: owner t's rank-p row of s's request
    lies at ``rows_per_shard + seg_start[(t-s) % G] + p``.  ``send_idx[t]``
    lists, per offset segment, t's local rows for its offset-o receiver
    (0-padded: padded slots land where no column refers).  Column ids are
    remapped into the slab (``col_ids_ext``); padding columns that are not
    the shard's columns map to local slot 0 (their tile entries are zero).
    """
    G = num_shards
    requests = []  # requests[s][t]: sorted unique ids owned by t, needed by s
    for s in range(G):
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard
        cols = np.asarray(local_cols_list[s], np.int64)
        if extra_cols_list is not None and len(extra_cols_list[s]):
            cols = np.concatenate([cols, np.asarray(extra_cols_list[s], np.int64)])
        cols = np.unique(cols)
        remote = cols[(cols < lo) | (cols >= hi)]
        owner = remote // rows_per_shard
        requests.append([remote[owner == t] for t in range(G)])

    pair_counts = np.array(
        [[len(requests[s][t]) for t in range(G)] for s in range(G)], np.int64
    )
    H = max((len(r) for reqs in requests for r in reqs), default=0)
    H = max(int(H), 1)

    offset_caps, rounds, halo_rows = plan_halo_rounds(pair_counts)
    seg_start = {}
    run = 0
    for o, c in offset_caps:
        seg_start[o] = run
        run += c

    send_idx = np.zeros((G, max(halo_rows, 1)), np.int32)
    for t in range(G):
        for o, cap in offset_caps:
            s = (t - o) % G
            r = requests[s][t]
            p0 = seg_start[o]
            send_idx[t, p0: p0 + len(r)] = (r - t * rows_per_shard).astype(np.int32)

    def make_remap(s):
        ids = np.concatenate([requests[s][t] for t in range(G)]) if G else np.empty(0, np.int64)
        slots = np.concatenate(
            [
                rows_per_shard + seg_start.get((t - s) % G, 0)
                + np.arange(len(requests[s][t]), dtype=np.int64)
                for t in range(G)
            ]
        ) if G else np.empty(0, np.int64)
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard

        def remap(col_arr):
            c = np.asarray(col_arr, np.int64)
            local = (c >= lo) & (c < hi)
            out = np.where(local, c - lo, 0)
            if len(ids):
                pos = np.searchsorted(ids, c)
                pos_c = np.minimum(pos, len(ids) - 1)
                hit = (~local) & (ids[pos_c] == c)
                out = np.where(hit, slots[pos_c], out)
            return out.astype(np.int32)

        return remap

    remaps = [make_remap(s) for s in range(G)]
    col_ids_ext = np.stack([remaps[s](col_ids_stacked[s]) for s in range(G)])
    sp_ext = None
    if split_col_ids is not None:
        sp_ext = np.stack([remaps[s](split_col_ids[s]) for s in range(G)])
    return {
        "capacity": H,
        "offset_caps": offset_caps,
        "rounds": rounds,
        "halo_rows": halo_rows,
        "send_idx": send_idx,
        "col_ids_ext": col_ids_ext,
        "split_col_ids_ext": sp_ext,
        "pair_counts": pair_counts,
    }


def partition_csr(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
    edge_capacity: Optional[int] = None,
    split: bool = False,
) -> ShardedSGTMeta:
    """Window-aligned 1-D partition of a CSR adjacency over ``num_shards``:
    each shard's rows tiled by the SGT pass, stacked, with the halo and
    (``split``) the block-stream split.  The JAX
    ``build_tiles=False`` light layout serves only the block-diagonal
    route, not ported here."""
    blk_h = config.blk_h
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    column_index = np.asarray(column_index, dtype=np.int64)
    num_edges = int(column_index.shape[0])

    num_windows = max(_cdiv(num_nodes, blk_h), 1)
    wd = _cdiv(num_windows, num_shards)
    rows_per_shard = wd * blk_h
    n_pad = num_shards * rows_per_shard

    ptr = np.concatenate(
        [row_pointers, np.full(n_pad + 1 - len(row_pointers), row_pointers[-1], np.int64)]
    )
    edge_start = ptr[::rows_per_shard].copy()  # [G+1]

    metas, local_cols_list = [], []
    for s in range(num_shards):
        r0, r1 = s * rows_per_shard, (s + 1) * rows_per_shard
        local_ptr = ptr[r0: r1 + 1] - ptr[r0]
        local_cols = column_index[ptr[r0]: ptr[r1]]
        local_cols_list.append(local_cols)
        metas.append(
            sparse_graph_translate(local_ptr, local_cols, rows_per_shard, config,
                                   emit_chunks=True)
        )

    tiles_per_shard = [build_a_tiles_host(m) for m in metas]
    stacked = _stack_shards(
        metas, edge_start, num_nodes, num_edges, rows_per_shard, config,
        edge_capacity, tiles_per_shard=tiles_per_shard,
    )
    split_host = (
        build_split(metas, rows_per_shard, config, tiles_per_shard=tiles_per_shard,
                    edge_capacity=stacked.edge_capacity)
        if split else None
    )
    stacked.halo = build_halo(
        local_cols_list,
        stacked.col_ids,
        num_shards,
        rows_per_shard,
        extra_cols_list=(
            [split_host["col_ids"][s] for s in range(num_shards)]
            if split_host is not None else None
        ),
        split_col_ids=split_host["col_ids"] if split_host is not None else None,
    )
    if split_host is not None:
        split_host["col_ids_ext"] = stacked.halo.pop("split_col_ids_ext")
        split_host["col_ids_global"] = split_host.pop("col_ids")
        stacked.split = split_host
    else:
        stacked.halo.pop("split_col_ids_ext", None)
    return stacked


def partition_graph(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: TileConfig = DEFAULT_CONFIG,
    split: bool = False,
    transpose: Optional[tuple] = None,
) -> tuple[ShardedSGTMeta, ShardedSGTMeta]:
    """Forward and transpose partitions.  The transpose carries
    ``chunk_fwd_slot`` and ``edge_fwd_slot`` (each transpose edge's forward
    padded-layout slot) so per-edge weights in forward CSR order reach the
    backward after one all-gather, and its split stream's ``w_src`` is
    remapped to forward slots.  ``transpose``: a precomputed ``(t_ptr,
    t_idx, t_src)`` of this CSR."""
    fwd = partition_csr(row_pointers, column_index, num_nodes, num_shards, config, split=split)

    t_ptr, t_idx, t_src = (
        transpose if transpose is not None
        else transpose_csr(np.asarray(row_pointers), np.asarray(column_index), num_nodes)
    )
    bwd = partition_csr(t_ptr, t_idx, num_nodes, num_shards, config, split=split)

    G, e_max_t = bwd.num_shards, bwd.edge_capacity
    e_max_f = fwd.edge_capacity
    sentinel = G * e_max_f

    fwd_slot_of_global = np.empty(fwd.num_edges + 1, dtype=np.int64)
    for s in range(G):
        lo, hi = fwd.edge_start[s], fwd.edge_start[s + 1]
        fwd_slot_of_global[lo:hi] = s * e_max_f + np.arange(hi - lo)
    fwd_slot_of_global[fwd.num_edges] = sentinel

    t_src_ext = np.concatenate([t_src.astype(np.int64), [fwd.num_edges]])
    chunk_fwd_slot = np.empty_like(bwd.chunk_edge_id)
    for s in range(G):
        local = bwd.chunk_edge_id[s].astype(np.int64)
        global_t = np.where(local == e_max_t, len(t_src), bwd.edge_start[s] + local)
        chunk_fwd_slot[s] = fwd_slot_of_global[t_src_ext[global_t]].astype(np.int32)
    bwd.chunk_fwd_slot = chunk_fwd_slot

    if bwd.split is not None:
        src = bwd.split["w_src"].astype(np.int64)
        s_idx = np.minimum(src // e_max_t, G - 1)
        global_t = np.where(
            src >= G * e_max_t, len(t_src), bwd.edge_start[s_idx] + src % e_max_t
        )
        bwd.split["w_src"] = fwd_slot_of_global[t_src_ext[global_t]].astype(np.int32)

    t_counts = np.diff(bwd.edge_start)
    edge_fwd_slot = np.full((G, e_max_t), sentinel, dtype=np.int32)
    for s in range(G):
        cnt = int(t_counts[s])
        global_t = bwd.edge_start[s] + np.arange(cnt, dtype=np.int64)
        edge_fwd_slot[s, :cnt] = fwd_slot_of_global[
            t_src.astype(np.int64)[global_t]
        ].astype(np.int32)
    bwd.edge_fwd_slot = edge_fwd_slot
    return fwd, bwd
