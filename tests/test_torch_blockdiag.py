"""The port's block-diagonal decomposition and pack scatters against the JAX package.

``tcgnn_tpu_torch.sgt.blockdiag.extract_block_diag`` carries over the JAX
NumPy path; the JAX package runs its native pass where the library is
built, and its NumPy path otherwise (both are checked here, the second by
switching the library off).  Every ``BDMeta`` field and
``packed_cov_idx()`` must hold the same values; dtypes of the edge-id
arrays may differ between the JAX paths (int32 native, int64 NumPy), so
values are compared, and the tile counts' dtype (int8, or int16 past 127
duplicates) must match.  ``build_bd_pack`` must give the JAX pack exactly;
``bd_scatter_weights`` the JAX weighted pack exactly where no two edges
share a cell, and to f32 summation order (``rtol=1e-6``) where 200 do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcgnn_tpu.sgt.native as jax_native
from tcgnn_tpu.ops import spmm as jax_spmm
from tcgnn_tpu.sgt import blockdiag as jax_bd
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.ops import bd_scatter_weights, build_bd_pack
from tcgnn_tpu_torch.sgt import blockdiag as port_bd

FIELDS = ("bin_rows", "num_bins", "offsets", "tile_idx", "tile_cnt", "coverage", "res_ptr",
          "res_idx", "res_edge_ids", "cov_edge_ids", "cov_flat_idx")


def bd_graph(kind):
    """(n, row_pointers, column_index) of the test graphs."""
    rng = np.random.default_rng(7)
    if kind == "powerlaw":  # rejected by the coverage gate
        n = 2000
        src, dst = powerlaw_graph(n, 8000, seed=3)
    elif kind == "one_signed":  # strictly upper triangular: offsets {+1, +2}
        n = 1024
        src = rng.integers(0, n - 256, 3000)
        dst = src + rng.integers(128, 256, 3000)
    elif kind == "asymmetric_banded":  # directed band plus random edges
        n = 1500
        src_b = rng.integers(0, n, 4000)
        dst_b = np.clip(src_b + rng.integers(-100, 101, 4000), 0, n - 1)
        src = np.concatenate([src_b, rng.integers(0, n, 400)])
        dst = np.concatenate([dst_b, rng.integers(0, n, 400)])
    else:
        n = {"full": 1500, "residual": 1600, "int16": 700}[kind]
        src, dst = component_union_graph(n, 2 * n + 200, n // 25, seed=2)
        if kind == "residual":  # 3% random long-range edges, both directions
            e, far = rng.integers(0, n, (2, int(0.03 * len(src))))
            src, dst = np.concatenate([src, e, far]), np.concatenate([dst, far, e])
        elif kind == "int16":  # one cell counted 200 times
            src = np.concatenate([src, np.full(200, 5)])
            dst = np.concatenate([dst, np.full(200, 6)])
    rp, ci = coo_to_csr(src, dst, n)
    return n, rp, ci


BD_KINDS = ["full", "residual", "one_signed", "asymmetric_banded", "int16"]


def jax_extract(monkeypatch, native, *args):
    if not native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    return jax_bd.extract_block_diag(*args)


@pytest.mark.parametrize("kind", BD_KINDS + ["powerlaw"])
@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_numpy"])
def test_extract_block_diag_matches_jax(monkeypatch, kind, native):
    n, rp, ci = bd_graph(kind)
    want = jax_extract(monkeypatch, native, rp, ci, n)
    got = port_bd.extract_block_diag(rp, ci, n)
    assert (got is None) == (want is None) == (kind == "powerlaw")
    if got is None:
        return
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None or g is None:
            assert g is None and w is None, f
        elif isinstance(w, (tuple, int, float)):
            assert g == w, f
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)
    assert got.tile_cnt.dtype == want.tile_cnt.dtype == (np.int16 if kind == "int16" else np.int8)
    np.testing.assert_array_equal(got.packed_cov_idx(), np.asarray(want.packed_cov_idx()))
    np.testing.assert_array_equal(got.dense_tiles(), want.dense_tiles())


def test_expected_decompositions():
    """What each test graph exercises."""
    for kind, offsets in (("full", None), ("one_signed", (1, 2))):
        n, rp, ci = bd_graph(kind)
        m = port_bd.extract_block_diag(rp, ci, n)
        assert m.coverage == 1.0 and m.res_ptr is None
        assert offsets is None or m.offsets == offsets
    n, rp, ci = bd_graph("residual")
    m = port_bd.extract_block_diag(rp, ci, n)
    assert 0.85 < m.coverage < 1.0 and len(m.res_idx) == len(ci) - len(m.cov_edge_ids)


def test_candidate_offsets_and_coverage_match_jax():
    n, rp, ci = bd_graph("residual")
    assert port_bd.bd_coverage(rp, ci) == jax_bd.bd_coverage(rp, ci)
    got = port_bd.extract_block_diag(rp, ci, n, candidate_offsets=(0, -1, 1), min_coverage=0.5)
    want = jax_bd.extract_block_diag(rp, ci, n, candidate_offsets=(0, -1, 1), min_coverage=0.5)
    assert got.offsets == want.offsets and got.coverage == want.coverage
    np.testing.assert_array_equal(got.packed_cov_idx(), np.asarray(want.packed_cov_idx()))


@pytest.mark.parametrize("kind", BD_KINDS)
def test_build_bd_pack_matches_jax(kind):
    n, rp, ci = bd_graph(kind)
    m = port_bd.extract_block_diag(rp, ci, n)
    k = len(m.offsets)
    got = build_bd_pack(torch.from_numpy(m.tile_idx), torch.from_numpy(m.tile_cnt), k=k,
                        nbins=m.num_bins, bn=m.bin_rows)
    want = np.asarray(jax_spmm.build_bd_pack(jnp.asarray(m.tile_idx), jnp.asarray(m.tile_cnt),
                                             k=k, nbins=m.num_bins, bn=m.bin_rows))
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    assert got.shape[0] % 8 == 0 and got.shape[0] >= m.num_bins
    np.testing.assert_array_equal(got.numpy(), want)


# bf16 only where no two edges share a cell: the int16 graph's 200 edges on
# one cell sum in bf16, in an order neither package fixes.
@pytest.mark.parametrize("kind,dtype", [(k, "f32") for k in BD_KINDS]
                         + [(k, "bf16") for k in BD_KINDS if k != "int16"])
def test_bd_scatter_weights_matches_jax(kind, dtype):
    n, rp, ci = bd_graph(kind)
    m = port_bd.extract_block_diag(rp, ci, n)
    k, bn = len(m.offsets), m.bin_rows
    bp = -(-m.num_bins // 8) * 8
    w = np.random.default_rng(3).standard_normal(len(m.cov_edge_ids)).astype(np.float32)
    pt, jt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    got = bd_scatter_weights(torch.from_numpy(w), torch.from_numpy(m.packed_cov_idx()), bp=bp,
                             bn=bn, k=k, dtype=pt)
    want = jax_spmm.bd_scatter_weights(jnp.asarray(w), jnp.asarray(m.packed_cov_idx()), bp=bp,
                                       bn=bn, k=k, dtype=jt)
    assert got.dtype == pt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-6,
                               atol=0)
