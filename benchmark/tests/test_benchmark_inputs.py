"""The generator copy gives the port's synthetic graphs, features and labels."""

import json

import numpy as np
import pytest

from benchmark import spec, synthetic
from tcgnn_tpu_torch.data import synthetic as port_synthetic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_powerlaw_matches_the_port(seed):
    n, e, d, c = 3000, 24000, 16, 5
    want = port_synthetic.synthesize(f"rand_{n}_{e}", d, c, seed=seed)
    got = synthetic.make_dataset({"graph": "g", "generator": "powerlaw", "nodes": n,
                                  "edges": e, "features": d, "classes": c,
                                  "graph_seed": seed}, seed)
    np.testing.assert_array_equal(got.row_pointers, want.row_pointers)
    np.testing.assert_array_equal(got.column_index, want.column_index)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)


@pytest.mark.parametrize("seed", [0, 3])
def test_components_match_the_port(seed):
    n, e, graphs = 4000, 9000, 90
    want = port_synthetic.component_union_graph(n, e, graphs, seed=seed)
    got = synthetic.component_union_graph(n, e, graphs, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_a_tu_collection_matches_the_port():
    want = port_synthetic.synthesize("PROTEINS_full", seed=5)
    n, e, d, c = synthetic.AE_DATASETS["PROTEINS_full"]
    got = synthetic.make_dataset({"graph": "PROTEINS_full", "generator": "components",
                                  "nodes": n, "edges": e, "features": d, "classes": c,
                                  "member_graphs": synthetic.TU_COLLECTIONS["PROTEINS_full"],
                                  "graph_seed": 5}, 5)
    np.testing.assert_array_equal(got.column_index, want.column_index)
    np.testing.assert_array_equal(got.row_pointers, want.row_pointers)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)


def test_tables_match_the_port():
    assert synthetic.AE_DATASETS == port_synthetic.AE_DATASETS
    assert synthetic.TU_COLLECTIONS == port_synthetic.TU_COLLECTIONS


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_keeps_the_published_sizes(path):
    t = json.loads(path.read_text())
    assert (t["nodes"], t["edges"], t["features"], t["classes"]) == \
        synthetic.AE_DATASETS[t["graph"]]
    if t["generator"] == "components":
        assert t["member_graphs"] == synthetic.TU_COLLECTIONS[t["graph"]]


def test_features_follow_the_seed_and_the_graph_does_not():
    t = {"graph": "g", "generator": "powerlaw", "nodes": 500, "edges": 3000, "features": 8,
         "classes": 3, "graph_seed": 0}
    a, b = synthetic.make_dataset(t, 1), synthetic.make_dataset(t, 2)
    np.testing.assert_array_equal(a.column_index, b.column_index)
    assert not np.array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.x, synthetic.make_dataset(t, 1).x)
