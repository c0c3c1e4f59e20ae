"""The port's node reordering (``tcgnn_tpu_torch.sgt.reorder``) against the JAX package.

``permute_csr`` and ``apply_permutation`` must give the JAX arrays bit for
bit.  ``rcm_permutation`` must equal the JAX one where the JAX package
takes its scipy path (its native library switched off here); the port has
no native library.  ``--reorder community`` exists only as the JAX native
pass and must raise in the port.  The trainer prints ``Reorder (ms)``, and
RCM brings a shuffled banded graph onto the block-diagonal route in both
packages.
"""

import numpy as np
import pytest

import tcgnn_tpu.sgt.native as jax_native
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.data import synthetic as jax_synthetic
from tcgnn_tpu.graph import TiledGraph as JaxTiledGraph
from tcgnn_tpu.sgt import reorder as jax_reorder
from tcgnn_tpu_torch import train as port_train
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.sgt import reorder as port_reorder


def shuffled_band(n=1500, seed=4):
    """A symmetric banded graph under a random relabeling."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4000)
    dst = np.clip(src + rng.integers(-60, 61, 4000), 0, n - 1)
    label = rng.permutation(n)
    src, dst = label[src], label[dst]
    return n, *coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)


def graph(kind):
    if kind == "band":
        return shuffled_band()
    n = 400
    src, dst = powerlaw_graph(n, 2500, seed=6)
    if kind == "directed":
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    return n, *coo_to_csr(src, dst, n)


@pytest.fixture
def jax_scipy_path(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("kind", ["band", "powerlaw", "directed"])
def test_rcm_permutation_matches_jax(jax_scipy_path, kind):
    n, rp, ci = graph(kind)
    got = port_reorder.rcm_permutation(rp, ci, n)
    np.testing.assert_array_equal(got, jax_reorder.rcm_permutation(rp, ci, n))
    assert got.dtype == np.int64 and np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("kind", ["band", "powerlaw", "directed"])
@pytest.mark.parametrize("perm", ["rcm", "random"])
def test_permute_csr_is_bit_identical(kind, perm):
    n, rp, ci = graph(kind)
    p = (port_reorder.rcm_permutation(rp, ci, n) if perm == "rcm"
         else np.random.default_rng(1).permutation(n))
    got = port_reorder.permute_csr(rp, ci, p)
    want = jax_reorder.permute_csr(rp, ci, p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["DD", "rand_300_1500"])
def test_reorder_dataset_is_bit_identical(jax_scipy_path, name):
    ds = synthesize(name, 8, 3, seed=2)
    jds = jax_synthetic.synthesize(name, 8, 3, seed=2)
    if name == "DD":  # a DD-shaped slice keeps the test fast
        ds, jds = (trim(d, 3000) for d in (ds, jds))
    np.testing.assert_array_equal(port_reorder.reorder_dataset(ds, "rcm"),
                                  jax_reorder.reorder_dataset(jds, "rcm"))
    for f in ("row_pointers", "column_index", "x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f), err_msg=f)
    assert port_reorder.reorder_dataset(ds, "none") is None


def trim(ds, n):
    """The dataset's first n nodes and the edges among them, in place."""
    rows = np.repeat(np.arange(ds.num_nodes), np.diff(ds.row_pointers))
    keep = (rows < n) & (ds.column_index < n)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=ptr[1:])
    ds.row_pointers, ds.column_index = ptr.astype(np.int32), ds.column_index[keep]
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        setattr(ds, f, getattr(ds, f)[:n])
    ds.num_nodes = n
    return ds


def test_rcm_brings_a_banded_graph_onto_the_bd_route(jax_scipy_path):
    n, rp, ci = shuffled_band()
    cfg, jcfg = TileConfig(128, 128), JaxTileConfig(128, 128)
    assert not TiledGraph(rp, ci, n, cfg, device="cpu").block_diag
    assert not JaxTiledGraph(rp, ci, n, jcfg).block_diag
    p = port_reorder.rcm_permutation(rp, ci, n)
    new_rp, new_ci, _ = port_reorder.permute_csr(rp, ci, p)
    g = TiledGraph(new_rp, new_ci, n, cfg, device="cpu")
    jg = JaxTiledGraph(new_rp, new_ci, n, jcfg)
    assert g.block_diag and jg.block_diag and g.bd_offsets == jg._bd_offsets


def test_community_raises():
    ds = synthesize("rand_100_400", 4, 2)
    with pytest.raises(NotImplementedError, match="native"):
        port_reorder.reorder_dataset(ds, "community")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        port_train.main(["--dataset", "rand_100_400", "--device", "cpu", "--reorder",
                         "community"])
    with pytest.raises(ValueError, match="unknown"):
        port_reorder.reorder_dataset(ds, "rabbit")


def test_cli_prints_reorder_time(capsys):
    r = port_train.main([
        "--dataset", "PROTEINS_full", "--dim", "4", "--classes", "2", "--epochs", "1",
        "--hidden", "4", "--device", "cpu", "--reorder", "rcm",
    ])
    out = capsys.readouterr().out
    assert "Reorder (ms):" in out and "TC_Blocks:" in out
    assert r["block_diag"] and np.isfinite(r["final_loss"])
