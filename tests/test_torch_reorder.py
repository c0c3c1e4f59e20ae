"""The port's node reordering (``tcgnn_tpu_torch.sgt.reorder``) against the JAX package.

``permute_csr`` and ``apply_permutation`` must give the JAX arrays bit for
bit.  ``rcm_permutation`` must equal the JAX one on both paths: the scipy
path (``impl="numpy"``, the JAX native library switched off) and the
native BFS (the default, as the JAX package runs where its library builds;
the two orders differ).  ``--reorder community`` needs the native pass and
raises without it (the JAX package would quietly take RCM).  The trainer
prints ``Reorder (ms)``, and RCM brings a shuffled banded graph onto the
block-diagonal route in both packages.
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
from tcgnn_tpu_torch.sgt import native as port_native
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


def require_jax_native(monkeypatch):
    """The JAX package's native library, loaded once more if its first load
    lost the test workers' build race; skip if it still does not load."""
    if jax_native.load() is None:
        monkeypatch.setattr(jax_native, "_tried", False)
        if jax_native.load() is None:
            pytest.skip("the JAX package's native library did not load")


KINDS = ["band", "powerlaw", "directed"]


# The scipy cases keep their ids; the native ones are "<kind>-native".
@pytest.mark.parametrize("kind,impl", [pytest.param(k, "numpy", id=k) for k in KINDS]
                         + [pytest.param(k, "auto", id=f"{k}-native") for k in KINDS])
def test_rcm_permutation_matches_jax(monkeypatch, kind, impl):
    if impl == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        require_jax_native(monkeypatch)
    n, rp, ci = graph(kind)
    got = port_reorder.rcm_permutation(rp, ci, n, impl=impl)
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
def test_reorder_dataset_is_bit_identical(monkeypatch, name):
    """Both packages' default paths: the native RCM."""
    require_jax_native(monkeypatch)
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


def rcm_onto_the_bd_route(impl):
    n, rp, ci = shuffled_band()
    cfg, jcfg = TileConfig(128, 128), JaxTileConfig(128, 128)
    assert not TiledGraph(rp, ci, n, cfg, device="cpu").block_diag
    assert not JaxTiledGraph(rp, ci, n, jcfg).block_diag
    p = port_reorder.rcm_permutation(rp, ci, n, impl=impl)
    new_rp, new_ci, _ = port_reorder.permute_csr(rp, ci, p)
    g = TiledGraph(new_rp, new_ci, n, cfg, device="cpu")
    jg = JaxTiledGraph(new_rp, new_ci, n, jcfg)
    assert g.block_diag and jg.block_diag and g.bd_offsets == jg._bd_offsets


def test_rcm_brings_a_banded_graph_onto_the_bd_route(jax_scipy_path):
    rcm_onto_the_bd_route("numpy")


def test_native_rcm_brings_a_banded_graph_onto_the_bd_route(monkeypatch):
    require_jax_native(monkeypatch)
    rcm_onto_the_bd_route("auto")


def test_community_raises(monkeypatch):
    """Without the native library, ``--reorder community`` raises with the
    build's error; an unknown method raises ``ValueError``."""
    ds = synthesize("rand_100_400", 4, 2)
    with pytest.raises(ValueError, match="unknown"):
        port_reorder.reorder_dataset(ds, "rabbit")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", "g++: error: no such compiler")
    with pytest.raises(RuntimeError, match=r"native SGT pass is unavailable: g\+\+: error"):
        port_reorder.reorder_dataset(ds, "community")
    with pytest.raises(RuntimeError, match="native SGT pass is unavailable"):
        port_train.main(["--dataset", "rand_100_400", "--device", "cpu", "--reorder",
                         "community"])


def test_cli_trains_after_community_reorder(monkeypatch, capsys):
    require_jax_native(monkeypatch)
    r = port_train.main(["--dataset", "rand_300_1500", "--dim", "4", "--classes", "2",
                         "--epochs", "1", "--hidden", "4", "--blk_h", "16", "--blk_w", "8",
                         "--device", "cpu", "--reorder", "community"])
    assert "Reorder (ms):" in capsys.readouterr().out and np.isfinite(r["final_loss"])
    ds = synthesize("rand_300_1500", 4, 2)
    jds = jax_synthetic.synthesize("rand_300_1500", 4, 2)
    np.testing.assert_array_equal(port_reorder.reorder_dataset(ds, "community"),
                                  jax_reorder.reorder_dataset(jds, "community"))
    for f in ("row_pointers", "column_index", "x", "y"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f), err_msg=f)


def test_cli_prints_reorder_time(capsys):
    r = port_train.main([
        "--dataset", "PROTEINS_full", "--dim", "4", "--classes", "2", "--epochs", "1",
        "--hidden", "4", "--device", "cpu", "--reorder", "rcm",
    ])
    out = capsys.readouterr().out
    assert "Reorder (ms):" in out and "TC_Blocks:" in out
    assert r["block_diag"] and np.isfinite(r["final_loss"])
