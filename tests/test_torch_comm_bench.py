"""The port's ``measure_comm`` and ``scaling`` benches on the CPU.

* ``measure_comm.main`` on ``rand_4000_32000`` over 4 and 8 shards writes
  the CSV the JAX tool writes on the same arguments (its 8 virtual CPU
  devices), column for column: the bytes by kind, the boundary rows, the
  modelled and ideal bytes, the ratio, the padding overhead and the
  cross-host fraction;
* ``measure_comm.measure`` over the routes the JAX rows do not reach (the
  block-diagonal route, the chunk fallback, the streamed route forced on a
  small graph): ratio 1.000;
* ``scaling.main`` prints its header and sizes 1, 2, 4 and 8, efficiency
  1.000 at size 1;
* in a fresh process, importing ``parallel.comm_stats`` and the three new
  bench modules and running one ``measure_comm`` row loads neither JAX nor
  the JAX package.
"""

import csv
import os
import subprocess
import sys
import types

import numpy as np

from tcgnn_tpu.bench import measure_comm as jax_measure_comm
from tcgnn_tpu_torch.bench import measure_comm, scaling
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, synthesize
from tcgnn_tpu_torch.data.synthetic import component_union_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_measure_comm_csv_matches_jax(tmp_path):
    args = ["--datasets", "rand_4000_32000", "--shards", "4", "8"]
    jax_measure_comm.main([*args, "--out", str(tmp_path / "jax.csv")])
    rows = measure_comm.main([*args, "--device", "cpu", "--out", str(tmp_path / "port.csv")])
    with open(tmp_path / "jax.csv") as f:
        want = list(csv.reader(f))
    with open(tmp_path / "port.csv") as f:
        got = list(csv.reader(f))
    assert got == want and len(got) == 3
    assert [r.split(",") for r in rows] == got[1:]
    assert got[0] == measure_comm.HEADER.split(",")
    assert all(r[8] == "1.000" for r in got[1:])


def _row(ds, name, shards, **graph_kw):
    """One ``measure`` row as a dict of the CSV's columns, and its graph."""
    r = measure_comm.measure(ds, name, shards, 4, "cpu", **graph_kw)
    return dict(zip(measure_comm.HEADER.split(","), r["row"].split(","))), r["graph"]


def test_measure_comm_models_every_gcn_route():
    """The program model covers the block-diagonal route (two rim shifts a
    pass), the chunk fallback and the streamed route (one all-gather a
    pass): measured over modelled is 1.000 on each.  Only the dense-tile
    route has a halo plan, so elsewhere the cross-host fraction is nan."""
    src, dst = component_union_graph(2048, 5200, 64, seed=7)
    ptr, idx = coo_to_csr(src, dst, 2048)
    union = types.SimpleNamespace(row_pointers=ptr, column_index=idx, num_nodes=2048,
                                  x=np.zeros((2048, 16), np.float32))
    row, g = _row(union, "union", 4)
    assert g.block_diag and int(row["measured_ppermute_bytes"]) > 0
    assert row["ratio_measured_vs_model"] == "1.000" and row["dcn_frac_cph4"] == "nan"
    ds = synthesize("rand_2000_8000", 16, 4)
    cfg = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)
    for kw in (dict(dense_tiles=False), dict(streamed=True, _stream_limits=(8, 384))):
        row, g = _row(ds, "rand_2000_8000", 4, cfg=cfg, **kw)
        assert not g.dense_tiles and g.streamed == ("streamed" in kw)
        assert int(row["measured_ag_bytes"]) > 0 and row["measured_ppermute_bytes"] == "0"
        assert row["ratio_measured_vs_model"] == "1.000"
    assert row["dcn_frac_cph4"] == "nan"


def test_scaling_prints_its_sizes(capsys):
    rows = scaling.main(["--dataset", "rand_2000_8000", "--dim", "16", "--epochs", "1",
                         "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "devices,epoch_ms,edges_per_s,efficiency" in out
    lines = out[out.index("devices,epoch_ms,edges_per_s,efficiency") + 1:]
    assert [int(line.split(",")[0]) for line in lines] == [1, 2, 4, 8]
    assert lines[0].endswith(",1.000") and rows[0][3] == 1.0
    assert all(ms > 0 and eps > 0 for _, ms, eps, _ in rows)


def test_comm_modules_import_no_jax():
    """A fresh process (this one has JAX loaded by conftest); with the mesh
    over processes' entry points (``init_process_group``,
    ``all_reduce_bucket``)."""
    code = (
        "import sys\n"
        "from tcgnn_tpu_torch.parallel import comm_stats, init_process_group\n"
        "from tcgnn_tpu_torch.parallel.collectives import all_reduce_bucket\n"
        "from tcgnn_tpu_torch.bench import measure_comm, partition_stats, scaling\n"
        "from tcgnn_tpu_torch.data import synthesize\n"
        "r = measure_comm.measure(synthesize('rand_600_3000', 16, 4), 'rand_600_3000', 4, 4,"
        " 'cpu')\n"
        "assert r['stats']['total_bytes'] > 0, r\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tcgnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK', r['row'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK rand_600_3000,4," in proc.stdout
