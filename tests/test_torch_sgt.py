"""The PyTorch port's NumPy host code (datasets, SGT) against the JAX package.

Same numpy inputs into both packages; every array must come out identical
(integer metadata and seeded float features: exact equality).
"""

import numpy as np
import pytest

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data import dataset as jax_dataset
from tcgnn_tpu.data import synthetic as jax_synthetic
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import dataset as port_dataset
from tcgnn_tpu_torch.data import synthetic as port_synthetic
from tcgnn_tpu_torch.sgt import translate as port_sgt

GEOMETRIES = [(8, 8), (16, 8), (16, 16)]
DATASET_FIELDS = (
    "name", "num_nodes", "num_edges", "num_features", "num_classes",
    "row_pointers", "column_index", "x", "y", "train_mask", "val_mask",
    "test_mask", "avg_degree", "avg_edge_span",
)


def assert_same_dataset(a, b):
    for f in DATASET_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


def csr(n, e, seed, n_used=None):
    """Power-law CSR; nodes at or past ``n_used`` have no edges (empty
    trailing windows)."""
    src, dst = port_synthetic.powerlaw_graph(n_used or n, e, seed=seed)
    return port_dataset.coo_to_csr(src, dst, n)


def with_duplicates(n, e, seed, count):
    """A graph where one edge appears ``count`` times."""
    src, dst = port_synthetic.powerlaw_graph(n, e, seed=seed)
    src = np.concatenate([src, np.full(count, 3)])
    dst = np.concatenate([dst, np.full(count, 5)])
    return port_dataset.coo_to_csr(src, dst, n)


@pytest.mark.parametrize("name", ["cora", "rand_300_1500", "planted_200_800", "PROTEINS_full"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_identical(name, seed):
    assert_same_dataset(
        port_synthetic.synthesize(name, seed=seed),
        jax_synthetic.synthesize(name, seed=seed),
    )


@pytest.mark.parametrize("n,e", [(300, 1500), (200, 20000)])  # sparse, dense branch
def test_powerlaw_graph_identical(n, e):
    for got, want in zip(port_synthetic.powerlaw_graph(n, e, seed=7),
                         jax_synthetic.powerlaw_graph(n, e, seed=7)):
        np.testing.assert_array_equal(got, want)


def test_component_union_graph_identical():
    for got, want in zip(port_synthetic.component_union_graph(500, 2000, 40, seed=2),
                         jax_synthetic.component_union_graph(500, 2000, 40, seed=2)):
        np.testing.assert_array_equal(got, want)


def test_loaders_identical(tmp_path):
    src, dst = port_synthetic.powerlaw_graph(150, 700, seed=4)
    npz = tmp_path / "g.npz"
    np.savez(npz, src_li=src, dst_li=dst, num_nodes=150)
    assert_same_dataset(port_dataset.load_npz(str(npz), 12, 3, seed=1),
                        jax_dataset.load_npz(str(npz), 12, 3, seed=1))
    txt = tmp_path / "g.txt"
    np.savetxt(txt, np.stack([src, dst], 1), fmt="%d")
    assert_same_dataset(port_dataset.load_txt(str(txt), 12, 3, seed=1),
                        jax_dataset.load_txt(str(txt), 12, 3, seed=1))


def _graphs():
    return {
        "powerlaw": (300, *csr(300, 1500, seed=1)),
        "empty_and_partial_windows": (300, *csr(300, 1200, seed=2, n_used=230)),
        "duplicates_over_127": (200, *with_duplicates(200, 900, seed=3, count=130)),
    }


@pytest.mark.parametrize("graph", ["powerlaw", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("block_group", [1, 2])
def test_translate_identical(graph, geometry, block_group):
    n, rp, ci = _graphs()[graph]
    bh, bw = geometry
    got = port_sgt.sparse_graph_translate(
        rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, block_group=block_group), build_tiles=True
    )
    # The JAX package's own default pass (the native C++ one where built).
    want = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, block_group=block_group),
        emit_chunks=False, build_tiles=True,
    )
    for f in ("col_ids", "edge_pos", "block_window", "block_first_in_window",
              "block_partition", "a_tiles"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.a_tiles.dtype == want.a_tiles.dtype
    assert got.num_real_blocks == want.num_real_blocks
    assert got.exp_edges == want.exp_edges
    assert (got.num_windows, got.num_blocks) == (want.num_windows, want.num_blocks)
    np.testing.assert_array_equal(port_sgt.build_a_tiles_host(got),
                                  jax_sgt.build_a_tiles_host(want))
    assert port_sgt.count_blocks(rp, ci, n, got.config) == jax_sgt.count_blocks(
        rp, ci, n, want.config
    ) == got.num_blocks


def test_duplicate_counts_over_127_give_float_tiles():
    n, rp, ci = _graphs()["duplicates_over_127"]
    meta = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(blk_h=16, blk_w=8),
                                           build_tiles=True)
    assert meta.a_tiles.dtype == np.float32 and meta.a_tiles.max() == 130


def test_transpose_csr_identical():
    n = 250
    src, dst = port_synthetic.powerlaw_graph(n, 1400, seed=6)
    keep = (src < dst) | (src % 4 == 0)  # directed
    rp, ci = port_dataset.coo_to_csr(src[keep], dst[keep], n)
    for got, want in zip(port_sgt.transpose_csr(rp, ci, n), jax_sgt.transpose_csr(rp, ci, n)):
        np.testing.assert_array_equal(got, want)


def test_meta_to_device_window_offsets():
    n, rp, ci = _graphs()["empty_and_partial_windows"]
    host = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(blk_h=16, blk_w=8, block_group=2))
    meta = host.to("cpu")
    ws = meta.win_start.numpy()
    assert ws[0] == 0 and ws[-1] == host.num_blocks
    np.testing.assert_array_equal(np.diff(ws), host.block_partition)
    np.testing.assert_array_equal(ws[:-1], np.flatnonzero(host.block_first_in_window))
    assert meta.col_ids.dtype == meta.win_start.dtype == meta.block_window.dtype
    # The kernel's runs cover every block once, in window order.
    assert meta.max_window_blocks == host.block_partition.max() > port_sgt.KERNEL_RUN_BLOCKS
    covered = np.zeros(host.num_blocks, int)
    for w, b in zip(meta.run_window.numpy(), meta.run_block.numpy()):
        assert ws[w] <= b < ws[w + 1]
        covered[b:min(b + port_sgt.KERNEL_RUN_BLOCKS, ws[w + 1])] += 1
    assert np.all(covered == 1)


@pytest.mark.parametrize("geometry,windows,tc_blocks", [((512, 128), 39, 334), ((16, 8), 1233, 7030)])
def test_pubmed_block_counts(geometry, windows, tc_blocks):
    ds = port_synthetic.synthesize("pubmed", seed=0)
    assert (ds.num_nodes, ds.num_edges) == (19717, 81120)
    bh, bw = geometry
    meta = port_sgt.sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                           TileConfig(blk_h=bh, blk_w=bw))
    assert (meta.num_windows, meta.num_real_blocks) == (windows, tc_blocks)
