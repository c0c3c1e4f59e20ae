"""The port's distributed host pass against the JAX package, bit for bit.

``tcgnn_tpu_torch.parallel.partition`` and ``sgt.reorder``'s shard balance
carry the JAX NumPy passes over; every array they build must be
``np.array_equal`` to JAX's: the window-granular LPT balance, and for G in
{1, 2, 4, 8} every field of the forward and transpose ``ShardedSGTMeta``
(the stacked tiles and chunks, ``edge_fwd_slot`` and ``chunk_fwd_slot``),
the halo tables and rounds (the remote class's columns in the slab too),
the split stream, and the local and remote block classes of the
halo-overlap split (``overlap``).
JAX's ``DistributedTiledGraph`` pads ``send_idx`` apart when two halo
plans share a width (a tracing workaround); the port's plans travel with
their metadata, so this compares ``partition_graph``'s tables, before any
such padding.

Graphs: ``random_csr`` (directed, random), a symmetric power-law graph, a
directed power-law graph, and planted mega-window graphs (directed and
symmetric) on which the split engages.
"""

import numpy as np
import pytest

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data.dataset import coo_to_csr as jax_coo_to_csr
from tcgnn_tpu.data.synthetic import powerlaw_graph as jax_powerlaw_graph
from tcgnn_tpu.parallel import partition as jax_part
from tcgnn_tpu.sgt import reorder as jax_reorder
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.parallel import partition as port_part
from tcgnn_tpu_torch.sgt import reorder as port_reorder

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
JCFG = JaxTileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def random_csr(n, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


def mega_csr(n, hub_rows=16, hub_deg=160, seed=0, symmetric=False):
    """A sparse graph with one dense row window at the front."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:hub_rows] = hub_deg
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    rows = np.repeat(np.arange(n), [len(c) for c in cols])
    cols = np.concatenate(cols)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    ptr, idx = jax_coo_to_csr(rows, cols, n)
    if symmetric:  # drop the duplicates the union made
        keep = np.ones(len(idx), bool)
        r = np.repeat(np.arange(n), np.diff(ptr))
        keep[1:] = (r[1:] != r[:-1]) | (idx[1:] != idx[:-1])
        ptr, idx = jax_coo_to_csr(r[keep], idx[keep], n)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


def powerlaw(n, e, seed, symmetric):
    src, dst = jax_powerlaw_graph(n, e, seed=seed)  # symmetric generator
    if not symmetric:
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    ptr, idx = jax_coo_to_csr(src, dst, n)
    return np.asarray(ptr, np.int32), np.asarray(idx, np.int32)


GRAPHS = {
    "random": lambda: (150, *random_csr(150, 6, seed=3)),
    "powerlaw symmetric": lambda: (160, *powerlaw(160, 1000, 11, True)),
    "powerlaw directed": lambda: (200, *powerlaw(200, 1200, 4, False)),
    "mega directed": lambda: (400, *mega_csr(400, seed=7)),
    "mega symmetric": lambda: (400, *mega_csr(400, seed=11, symmetric=True)),
}

SCALARS = ("num_shards", "num_nodes", "num_edges", "rows_per_shard", "windows_per_shard",
           "edge_capacity", "num_real_blocks")
ARRAYS = ("edge_start", "col_ids", "a_tiles", "block_window", "block_first_in_window",
          "edge_pos", "chunk_r", "chunk_c", "chunk_edge_id", "chunk_block", "chunk_window",
          "chunk_first_in_window", "edge_perm", "edge_valid", "chunk_fwd_slot",
          "edge_fwd_slot")


def assert_same(path, got, want):
    """Recursive bit-identity of dicts, sequences, arrays and scalars."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(f"{path}.{k}", got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(f"{path}[{i}]", a, b)
    elif want is None:
        assert got is None, path
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return request.param, GRAPHS[request.param]()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_shard_balance_permutation_matches_jax(graph, shards):
    _, (n, ptr, idx) = graph
    got = port_reorder.shard_balance_permutation(ptr, idx, n, shards, CFG)
    want = jax_reorder.shard_balance_permutation(ptr, idx, n, shards, JCFG)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_partition_graph_matches_jax(graph, shards):
    name, (n, ptr, idx) = graph
    got = port_part.partition_graph(ptr, idx, n, shards, CFG, split=shards > 1)
    want = jax_part.partition_graph(ptr, idx, n, shards, JCFG, split=shards > 1)
    for tag, g, w in zip(("fwd", "bwd"), got, want):
        for f in SCALARS:
            assert getattr(g, f) == getattr(w, f), (tag, f)
        for f in ARRAYS:
            assert_same(f"{tag}.{f}", getattr(g, f), getattr(w, f))
        assert_same(f"{tag}.halo", g.halo, w.halo)
        assert_same(f"{tag}.overlap", g.overlap, w.overlap)
        assert_same(f"{tag}.split", g.split, w.split)
    if name.startswith("mega") and shards == 4:
        assert got[0].split is not None, "the planted mega window must engage the split"


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_light_partition_matches_jax(graph, shards):
    """``build_tiles=False``, the block-diagonal route's layout-only
    partition: JAX's scalars, edge offsets and transpose slots; no tile,
    chunk, halo or split."""
    _, (n, ptr, idx) = graph
    got = port_part.partition_graph(ptr, idx, n, shards, CFG, build_tiles=False)
    want = jax_part.partition_graph(ptr, idx, n, shards, JCFG, build_tiles=False)
    for tag, g, w in zip(("fwd", "bwd"), got, want):
        for f in SCALARS:
            assert getattr(g, f) == getattr(w, f), (tag, f)
        for f in ARRAYS:
            assert_same(f"{tag}.{f}", getattr(g, f), getattr(w, f))
        assert g.halo is None and g.split is None and g.overlap is None


def test_overlap_split_is_nontrivial(graph):
    """Counterpart of JAX's ``test_overlap_split_is_nontrivial_and_used``:
    over 4 shards both classes hold real blocks, every window of a class
    has a block, and each real edge lies in exactly one class."""
    _, (n, ptr, idx) = graph
    fwd, _ = port_part.partition_graph(ptr, idx, n, 4, CFG)
    ov = fwd.overlap
    real = {c: int((ov[c]["a_tiles"] != 0).any(axis=(2, 3)).sum()) for c in ov}
    assert real["local"] > 0 and real["remote"] > 0, real
    tile = CFG.blk_h * CFG.blk_w
    counts = np.diff(fwd.edge_start)
    for s in range(4):
        in_class = [ov[c]["edge_pos"][s] < ov[c]["a_tiles"].shape[1] * tile for c in ov]
        assert np.array_equal(in_class[0] ^ in_class[1], np.arange(fwd.edge_capacity) < counts[s])
        for c in ov:
            starts = ov[c]["block_window"][s][ov[c]["block_first_in_window"][s] == 1]
            assert np.array_equal(starts, np.arange(fwd.windows_per_shard)), c
    # The local class gathers the shard's own rows only.
    assert int(ov["local"]["col_ids"].max()) < fwd.rows_per_shard


def test_int8_overflow_classes_take_the_wide_dtype():
    """A multigraph with a duplicate count above 127: the stacked tiles and
    both classes take f32 (int8 would wrap 200 to -56), as JAX's do."""
    n = 48
    cols = np.concatenate([np.zeros(200, np.int64), np.arange(1, n)])
    ptr = np.zeros(n + 1, np.int64)
    ptr[1] = 200
    ptr[2:] = 200 + np.arange(1, n)
    fwd, _ = port_part.partition_graph(ptr.astype(np.int32), cols.astype(np.int32), n, 2, CFG)
    want, _ = jax_part.partition_graph(ptr.astype(np.int32), cols.astype(np.int32), n, 2, JCFG)
    assert fwd.a_tiles.dtype != np.int8 and fwd.a_tiles.max() == 200
    for cls in ("local", "remote"):
        assert fwd.overlap[cls]["a_tiles"].dtype != np.int8
    assert max(fwd.overlap[c]["a_tiles"].max() for c in ("local", "remote")) == 200
    assert_same("overlap", fwd.overlap, want.overlap)


def test_balance_dataset_permutes_in_place():
    from tcgnn_tpu_torch.data import synthesize

    ds = synthesize("rand_700_4000", 8, 3, seed=2)
    x0, ptr0 = ds.x.copy(), np.asarray(ds.row_pointers).copy()
    perm = port_reorder.balance_dataset(ds, 4, CFG)
    assert perm is not None
    np.testing.assert_array_equal(ds.x, x0[perm])
    np.testing.assert_array_equal(np.diff(ds.row_pointers), np.diff(ptr0)[perm])
