"""The model modules' work counts on a hand-worked small graph, and the bound."""

import pytest

from benchmark import counts, spec

GCN = {"model": "gcn", "num_layers": 2, "hidden": 2, "hoist": True}
AGNN = {"model": "agnn", "num_layers": 2, "hidden": 2, "hoist": True}


def epoch_counts(config, dims, n, e):
    return spec.model(config["model"]).epoch_counts(config, dims, n, e)


def test_gcn_hoisted():
    # 4 nodes, 6 edges, widths 3 -> 2 -> 5.  Layer 1: GEMM 2*4*3*2 = 48, forward and
    # weight gradient; aggregate hoisted.  Layer 2: GEMM 2*4*2*5 = 80, three times;
    # aggregation at width 2, forward and backward: 2 * 2*6*2 = 48.
    c = epoch_counts(GCN, [3, 2, 5], 4, 6)
    assert c["flops"] == 2 * 48 + 3 * 80 + 48
    assert c["agg_flops"] == 48
    # Each pass: 4*6 column indices + 4*5 row pointers + x read and out written 2*4*4*2.
    assert c["agg_bytes"] == 2 * (24 + 20 + 64)


def test_gcn_not_hoisted_aggregates_the_input_once():
    # Layer 1 unhoisted: (A x) W, one pass at width 3 (2*6*3 FLOPs, 24 + 20 + 2*4*4*3 bytes),
    # moves fewer bytes than A (x W) at width 2 with the pass over the transpose that W's
    # gradient then takes (2 * (24 + 20 + 64)).
    c = epoch_counts({**GCN, "hoist": False}, [3, 2, 5], 4, 6)
    assert c["agg_flops"] == 48 + 2 * 6 * 3
    assert c["agg_bytes"] == 2 * (24 + 20 + 64) + (24 + 20 + 96)


def test_gcn_not_hoisted_takes_the_narrow_side_and_its_transpose():
    # Widths 500 -> 16 -> 3 (pubmed's): layer 1 is A (x W) at width 16 and its pass over the
    # transpose, not (A x) W's one pass at width 500.
    n, e = 10, 40
    c = epoch_counts({**GCN, "hoist": False}, [500, 16, 3], n, e)
    csr = 4 * e + 4 * (n + 1)
    assert c["agg_flops"] == 2 * 2 * e * 16 + 2 * 2 * e * 3
    assert c["agg_bytes"] == 2 * (csr + 2 * 4 * n * 16) + 2 * (csr + 2 * 4 * n * 3)


def test_agnn():
    # Widths 3 -> 2 -> 5; a layer at width b: 12 E b FLOPs of aggregation and scores,
    # two passes over the graph, 5 * 4 N b dense bytes.
    c = epoch_counts(AGNN, [3, 2, 5], 4, 6)
    assert c["agg_flops"] == 12 * 6 * 2 + 12 * 6 * 5
    assert c["flops"] == 2 * 48 + 3 * 80 + c["agg_flops"]
    assert c["agg_bytes"] == 2 * (2 * 44 + 5 * 4 * 4 * 2) // 2 + (2 * 44 + 5 * 4 * 4 * 5)


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_layer_dims(model):
    assert spec.model(model).layer_dims({"num_layers": 3, "hidden": 16},
                                        {"features": 96, "classes": 22}) == [96, 16, 16, 22]


def test_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
