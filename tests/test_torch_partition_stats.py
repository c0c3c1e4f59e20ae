"""``tcgnn_tpu_torch.bench.partition_stats`` against
``tcgnn_tpu.bench.partition_stats``.

* ``shard_stats`` equals JAX's (edges, boundary, blocks, ``pair_row``) on
  the JAX test's graph at 128x128 and on pubmed at 4 shards (the default
  tiles);
* ``roofline``'s balance equals JAX's, and its times and efficiencies equal
  JAX's formula with JAX's module constants set to the H100's data-sheet
  rates and its TPU lane padding (``_lane_pad``) set to the true width,
  through ``monkeypatch`` (no file of the JAX package changes); the JAX
  test's sanity checks hold;
* ``main``'s CSV equals JAX's column for column on a small graph, apart
  from the four columns the H100 rates set (``t_local_us``, ``t_ici_us``,
  ``pred_efficiency``, ``pred_efficiency_split``);
* no v5e constant is left in the port's module.
"""

import csv

import numpy as np
import pytest

import tcgnn_tpu.bench.partition_stats as jax_ps
from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu_torch.bench import partition_stats as ps
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import synthesize


def jax_test_graph():
    """The JAX test's graph: 2,000 nodes, Poisson(5) distinct neighbours."""
    rng = np.random.default_rng(0)
    n = 2000
    deg = rng.poisson(5, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32), n


def pubmed_graph():
    ds = synthesize("pubmed", 16, 3)
    return ds.row_pointers, ds.column_index, ds.num_nodes


# name: graph, shards, tiles (blk_h, blk_w)
CASES = {
    "jax_test_128x128": (jax_test_graph, 4, (128, 128)),
    "pubmed_default": (pubmed_graph, 4, (512, 128)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, g, (bh, bw) = CASES[request.param]
    ptr, idx, n = make()
    cfg, jcfg = TileConfig(blk_h=bh, blk_w=bw), JaxTileConfig(blk_h=bh, blk_w=bw)
    return ps.shard_stats(ptr, idx, n, g, cfg), jax_ps.shard_stats(ptr, idx, n, g, jcfg), \
        cfg, jcfg, n, int(ptr[-1])


def test_shard_stats_match_jax(case):
    (rps, shards), (j_rps, j_shards), *_ = case
    assert rps == j_rps and len(shards) == len(j_shards)
    for s, j in zip(shards, j_shards):
        assert (s["edges"], s["boundary"], s["blocks"]) == (j["edges"], j["boundary"], j["blocks"])
        np.testing.assert_array_equal(s["pair_row"], j["pair_row"])


@pytest.mark.parametrize("dim", [16, 96])
def test_roofline_is_jax_formula_at_h100_rates(case, dim, monkeypatch):
    (rps, shards), (j_rps, j_shards), cfg, jcfg, *_ = case
    r = ps.roofline(shards, rps, dim, cfg)
    assert r["balance"] == jax_ps.roofline(j_shards, j_rps, dim, jcfg)["balance"]
    monkeypatch.setattr(jax_ps, "HBM_BPS", ps.HBM_BPS)
    monkeypatch.setattr(jax_ps, "ICI_BPS", ps.NVLINK_BPS)
    monkeypatch.setattr(jax_ps, "MXU_FLOPS", ps.TENSOR_FLOPS)
    monkeypatch.setattr(jax_ps, "_lane_pad", lambda d: d)
    want = jax_ps.roofline(j_shards, j_rps, dim, jcfg)
    for k in want:
        np.testing.assert_allclose(r[k], want[k], rtol=1e-12, err_msg=k)


def test_sanity(case):
    """The JAX test's checks, on the port."""
    (rps, shards), _, cfg, _, n, num_edges = case
    assert len(shards) == 4 and rps * 4 >= n
    assert sum(s["edges"] for s in shards) == num_edges
    for s in shards:
        assert 0 <= s["boundary"] <= n
        assert s["blocks"] >= rps // cfg.blk_h  # at least one padded block a window
    r = ps.roofline(shards, rps, dim=16, config=cfg)
    assert 0 < r["balance"] <= 1
    assert 0 < r["efficiency"] <= 1
    assert r["efficiency"] <= r["efficiency_split"] <= 1
    assert r["t_local_us"] > 0 and r["t_ici_us"] >= 0


# The columns the H100's rates set (the JAX tool's are the v5e's).
RATE_COLUMNS = {"t_local_us", "t_ici_us", "pred_efficiency", "pred_efficiency_split"}


def test_main_csv_matches_jax(tmp_path):
    """Both tools on ``rand_3000_15000`` over 2 and 4 shards, RCM order,
    with and without the shard balance."""
    for balance in ([], ["--balance"]):
        args = ["--datasets", "rand_3000_15000", "--shards", "2", "4", "--data_dir",
                str(tmp_path), *balance]
        jax_ps.main([*args, "--csv", str(tmp_path / "jax.csv")])
        rows = ps.main([*args, "--csv", str(tmp_path / "port.csv")])
        with open(tmp_path / "jax.csv") as f:
            want = list(csv.DictReader(f))
        with open(tmp_path / "port.csv") as f:
            got = list(csv.DictReader(f))
        assert len(got) == len(want) == len(rows) == 2
        for g, w in zip(got, want):
            assert list(g) == list(w)
            assert {k: v for k, v in g.items() if k not in RATE_COLUMNS} == \
                {k: v for k, v in w.items() if k not in RATE_COLUMNS}
            assert 0 < float(g["pred_efficiency"]) <= float(g["pred_efficiency_split"]) <= 1


def test_no_v5e_constant_or_lane_padding():
    src = open(ps.__file__).read()
    for v5e in ("819e9", "45e9", "197e12", "_lane_pad"):
        assert v5e not in src
    assert (ps.HBM_BPS, ps.NVLINK_BPS, ps.TENSOR_FLOPS) == (3.35e12, 450e9, 989.4e12)
