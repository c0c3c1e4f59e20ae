"""The work counts on a hand-worked small graph."""

import pytest

from benchmark import counts

GCN = {"model": "gcn", "num_layers": 2, "hidden": 2, "hoist": True}
AGNN = {"model": "agnn", "num_layers": 2, "hidden": 2, "hoist": True}


def test_gcn_hoisted():
    # 4 nodes, 6 edges, widths 3 -> 2 -> 5.  Layer 1: GEMM 2*4*3*2 = 48, forward and
    # weight gradient; aggregate hoisted.  Layer 2: GEMM 2*4*2*5 = 80, three times;
    # aggregation at width 2, forward and backward: 2 * 2*6*2 = 48.
    c = counts.epoch_counts(GCN, [3, 2, 5], 4, 6)
    assert c["flops"] == 2 * 48 + 3 * 80 + 48
    assert c["agg_flops"] == 48
    # Each pass: 4*6 column indices + 4*5 row pointers + x read and out written 2*4*4*2.
    assert c["agg_bytes"] == 2 * (24 + 20 + 64)


def test_gcn_not_hoisted_aggregates_the_input_once():
    c = counts.epoch_counts({**GCN, "hoist": False}, [3, 2, 5], 4, 6)
    assert c["agg_flops"] == 48 + 2 * 6 * 2
    assert c["agg_bytes"] == 2 * (24 + 20 + 64) + (24 + 20 + 64)


def test_agnn():
    # Widths 3 -> 2 -> 5; a layer at width b: 12 E b FLOPs of aggregation and scores,
    # two passes over the graph, 5 * 4 N b dense bytes.
    c = counts.epoch_counts(AGNN, [3, 2, 5], 4, 6)
    assert c["agg_flops"] == 12 * 6 * 2 + 12 * 6 * 5
    assert c["flops"] == 2 * 48 + 3 * 80 + c["agg_flops"]
    assert c["agg_bytes"] == 2 * (2 * 44 + 5 * 4 * 4 * 2) // 2 + (2 * 44 + 5 * 4 * 4 * 5)


def test_layer_dims():
    assert counts.layer_dims({"num_layers": 3, "hidden": 16}, {"features": 96, "classes": 22}) \
        == [96, 16, 16, 22]


def test_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_unknown_model_raises():
    with pytest.raises(ValueError):
        counts.epoch_counts({"model": "gin", "hoist": True}, [3, 2, 5], 4, 6)
