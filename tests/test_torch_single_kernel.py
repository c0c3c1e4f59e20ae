"""The trainer's ``--single_kernel`` (``train.profile_sag``) and
``profiling.kernel_report`` against the JAX package's.

On every route (condensed tiles, block-diagonal, chunk, streamed, the mesh)
``main([..., "--single_kernel"])`` returns exactly the keys the JAX CLI's
returns, prints its four labels and trains no epoch.  ``kernel_report``
takes the true width where the JAX one takes ``lane_pad(d)`` (a TPU layout
rule), and quotes the card's peak: at the JAX width and peak the two give
the same numbers.
"""

import numpy as np
import pytest
import torch

from tcgnn_tpu import train as jax_train
from tcgnn_tpu.ops.spmm import lane_pad
from tcgnn_tpu.utils import profiling as jax_profiling
from tcgnn_tpu_torch import graph as port_graph
from tcgnn_tpu_torch import profiling, train
from tcgnn_tpu_torch.sgt import stream

SMALL = ["--dataset", "rand_2000_8000", "--dim", "6", "--classes", "3", "--blk_h", "16",
         "--blk_w", "8"]


def labels(out: str) -> list:
    """The text before the first ':' of each '=>' line."""
    return [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("=>")]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX CLI's ``--single_kernel`` on a small graph, 4 rounds (its
    chain differencing at 200 rounds runs minutes in interpret mode):
    its returned keys and printed labels."""
    import contextlib
    import io

    defaults = jax_train.profile_sag.__defaults__
    jax_train.profile_sag.__defaults__ = (4,)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            r = jax_train.main(["--dataset", "rand_300_1200", "--dim", "8", "--classes", "3",
                                "--blk_h", "16", "--blk_w", "16", "--single_kernel"])
    finally:
        jax_train.profile_sag.__defaults__ = defaults
    return set(r), labels(out.getvalue())


ROUTES = {
    "condensed": (SMALL, "dense_tiles=True streamed=False block_diag=False"),
    "bd": (["--dataset", "rand_100_400", "--dim", "6", "--classes", "3"],
           "dense_tiles=True streamed=False block_diag=True"),
    "chunk": (SMALL, "dense_tiles=False streamed=False block_diag=False"),
    "streamed": (SMALL, "dense_tiles=False streamed=True block_diag=False"),
    "mesh": ([*SMALL, "--mesh", "2x1"], "mesh=2x1"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_single_kernel_returns_jax_keys_on_every_route(monkeypatch, capsys, jax_run, route):
    argv, route_line = ROUTES[route]
    monkeypatch.setattr(train, "SAG_ROUNDS", 4)  # 200 rounds of plain versions: seconds
    if route in ("chunk", "streamed"):
        monkeypatch.setattr(port_graph, "DENSE_TILE_BUDGET_BYTES", 0)
    if route == "streamed":
        monkeypatch.setattr(stream, "MAX_PREFETCH_CHUNKS", 8)
    steps = []
    adam_step = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, *a, **k: steps.append(1) or adam_step(self, *a, **k))
    r = train.main([*argv, "--device", "cpu", "--single_kernel"])
    out = capsys.readouterr().out
    keys, jax_labels = jax_run
    assert set(r) == keys
    assert labels(out) == jax_labels
    assert route_line in [ln for ln in out.splitlines() if ln.startswith("Route:")][0]
    assert not steps and "Final loss" not in out and "Train (ms)" not in out
    assert r["ms"] > 0 and r["sddmm_ms"] > 0 and r["edges_per_s"] > 0


@pytest.mark.parametrize("d", [1, 3, 8, 16, 96, 100, 128, 200, 602])
def test_kernel_report_matches_jax_at_lane_padded_width(d):
    e, exp, seconds = 81_120, 334 * 512 * 128, 1.7e-4
    want = jax_profiling.kernel_report(e, exp, d, seconds)
    got = profiling.kernel_report(e, exp, lane_pad(d), seconds,
                                  peak_tflops=jax_profiling.PEAK_BF16_TFLOPS)
    assert set(got) == set(want)
    for k in ("edges_per_s", "tile_tflops", "mfu_pct"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    # The useful work is the true width's on both sides.
    assert profiling.op_stats(e, d, seconds) == jax_profiling.op_stats(e, d, seconds)
    assert profiling.kernel_report(e, exp, d, seconds)["mfu_pct"] == pytest.approx(
        100 * 2 * exp * d / seconds / 1e12 / profiling.PEAK_BF16_TFLOPS)
