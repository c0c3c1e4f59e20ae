"""K4 of the port (``tcgnn_tpu_torch.ops.sddmm``) and ``build_a_tiles``
against the JAX package.

The plain version ``sddmm_tc_dense_torch`` (what ``sddmm_tc_dense`` runs on
a CPU tensor) must match the JAX ``sddmm_tc_dense`` (Pallas in interpret
mode) and an f64 CSR oracle on the same numpy inputs, in f32 and bf16.
Tolerance ``rtol=atol=1e-5``: both sides form the same products of
compute-dtype operands and sum them in f32, in another order (for bf16 the
products are exact in f32, so bf16 holds the same tolerance).  The weighted
tiles must equal the JAX scatter (f32 ``rtol=1e-6``; bf16 within one bf16
step).  The CUDA kernel itself runs only on a card
(``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops.sddmm import sddmm_tc_dense as jax_sddmm_tc_dense
from tcgnn_tpu.ops.spmm import build_a_tiles as jax_build_a_tiles
from tcgnn_tpu.ops.spmm import spmm_tc_dense as jax_spmm_tc_dense
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import reference as port_ref
from tcgnn_tpu_torch.ops import sddmm as port_sddmm
from tcgnn_tpu_torch.ops import build_a_tiles, reset_counts, sddmm_tc_dense, spmm_tc_dense_torch
from tcgnn_tpu_torch.sgt import translate as port_sgt

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def graph(kind):
    n = 240
    src, dst = powerlaw_graph(n, 1300, seed=21)
    if kind == "directed":
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    elif kind == "duplicates":  # one edge 5 times: the weighted tiles sum them
        src, dst = np.concatenate([src, np.full(5, 7)]), np.concatenate([dst, np.full(5, 30)])
    rp, ci = coo_to_csr(src, dst, n)
    return n, rp, ci


def metas(n, rp, ci, geometry, dtype="f32"):
    bh, bw = geometry
    pt, jt = DTYPES[dtype]
    host = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(bh, bw, pt), build_tiles=True)
    jmeta = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, compute_dtype=jt), emit_chunks=False
    ).as_jax(lite=True)
    return host, host.to("cpu"), jmeta


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("kind", ["symmetric", "directed", "duplicates"])
@pytest.mark.parametrize("geometry", [(16, 8), (16, 16), (512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 32])
def test_plain_matches_jax_and_oracle(kind, geometry, dtype, d):
    n, rp, ci = graph(kind)
    _, meta, jmeta = metas(n, rp, ci, geometry, dtype)
    xa, xb = features(n, d, 1), features(n, d, 2)
    got = sddmm_tc_dense(torch.from_numpy(xa), meta, torch.from_numpy(xb))
    assert got.dtype == torch.float32 and got.shape == (len(ci),)
    want = jax_sddmm_tc_dense(jnp.asarray(xa), jmeta, jnp.asarray(xb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The oracle on the compute-dtype operands, in f64.
    ct = DTYPES[dtype][0]
    xa64, xb64 = (torch.from_numpy(a).to(ct).double() for a in (xa, xb))
    oracle = port_ref.sddmm_ref(xa64, torch.from_numpy(rp), torch.from_numpy(ci), xb64)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_xb_defaults_to_xa():
    n, rp, ci = graph("directed")
    _, meta, jmeta = metas(n, rp, ci, (16, 8))
    x = features(n, 12, 3)
    got = sddmm_tc_dense(torch.from_numpy(x), meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sddmm_tc_dense(jnp.asarray(x), jmeta)),
                               **TOL)


def test_edge_dot_route_gives_the_same_scores(monkeypatch):
    """Above SDDMM_EDGE_DOT_BYTES the plain version forms no score tiles;
    the per-edge dots are the same values."""
    n, rp, ci = graph("duplicates")
    _, meta, _ = metas(n, rp, ci, (16, 16))
    xa, xb = torch.from_numpy(features(n, 20, 4)), torch.from_numpy(features(n, 20, 5))
    tiles_route = port_sddmm.sddmm_tc_dense_torch(xa, meta, xb)
    monkeypatch.setattr(port_sddmm, "SDDMM_EDGE_DOT_BYTES", 0)
    np.testing.assert_allclose(port_sddmm.sddmm_tc_dense_torch(xa, meta, xb).numpy(),
                               tiles_route.numpy(), **TOL)


def test_edge_rows_and_cols_are_the_csr_edges():
    n, rp, ci = graph("duplicates")
    _, meta, _ = metas(n, rp, ci, (16, 8))
    np.testing.assert_array_equal(meta.edge_rows.numpy(), np.repeat(np.arange(n), np.diff(rp)))
    np.testing.assert_array_equal(meta.edge_cols.numpy(), ci)
    assert meta.edge_pos.dtype == torch.int32


@pytest.mark.parametrize("kind", ["symmetric", "duplicates"])
@pytest.mark.parametrize("geometry", [(16, 8), (512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_build_a_tiles_matches_jax(kind, geometry, dtype):
    """Equal to the JAX scatter; in bf16 the duplicates' sum may round in
    another order, within one bf16 step (2**-8)."""
    n, rp, ci = graph(kind)
    host, meta, jmeta = metas(n, rp, ci, geometry)
    pt, jt = DTYPES[dtype]
    w = np.random.default_rng(6).standard_normal(len(ci)).astype(np.float32)
    got = build_a_tiles(meta, torch.from_numpy(w), dtype=pt)
    assert got.dtype == pt and got.shape == host.a_tiles.shape
    want = jax_build_a_tiles(jmeta, jnp.asarray(w), dtype=jt).astype(jnp.float32)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "f32" else dict(rtol=4e-3, atol=4e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)
    # Unit weights give the structural counts.
    ones = build_a_tiles(meta, torch.ones(len(ci)))
    np.testing.assert_array_equal(ones.numpy(), host.a_tiles.astype(np.float32))


@pytest.mark.parametrize("geometry", [(16, 8), (512, 128)])
def test_weighted_spmm_rounds_weights_under_bf16(geometry):
    """K1's plain version over f32 weighted tiles under a bf16 config rounds
    each weight to bf16, as the JAX kernel casts its tiles
    (``a_ref[k].astype(compute_dtype)``)."""
    n, rp, ci = graph("directed")
    _, meta, jmeta = metas(n, rp, ci, geometry, "bf16")
    w = np.random.default_rng(7).standard_normal(len(ci)).astype(np.float32)
    x = features(n, 24, 8)
    tiles = build_a_tiles(meta, torch.from_numpy(w))
    got = spmm_tc_dense_torch(torch.from_numpy(x), meta, tiles)
    want = jax_spmm_tc_dense(jnp.asarray(x), jmeta, jax_build_a_tiles(jmeta, jnp.asarray(w)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    # The rounding is there: unrounded weights give another sum.
    exact = (tiles.float() - tiles.to(torch.bfloat16).float()).abs().max()
    assert float(exact) > 0


def test_cpu_tensor_counts_plain_calls_and_rejects_bad_operands():
    n, rp, ci = graph("symmetric")
    _, meta, _ = metas(n, rp, ci, (16, 8))
    x = torch.from_numpy(features(n, 4, 9))
    reset_counts()
    sddmm_tc_dense(x, meta)
    sddmm_tc_dense(x, meta, x)
    assert (sddmm_tc_dense.plain_calls, sddmm_tc_dense.launches) == (2, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        sddmm_tc_dense(torch.empty(n, 4, device="meta"), meta)
    with pytest.raises(ValueError, match="expected"):
        sddmm_tc_dense(torch.zeros(n + 1, 4), meta)
    with pytest.raises(ValueError, match="xb"):
        sddmm_tc_dense(x, meta, torch.zeros(n, 5))
    with pytest.raises(ValueError, match="expected"):
        build_a_tiles(meta, torch.ones(len(ci) + 1))
    reset_counts()
    assert (sddmm_tc_dense.plain_calls, sddmm_tc_dense.launches) == (0, 0)


def test_meta_refuses_an_index_space_past_int32():
    n, rp, ci = graph("symmetric")
    host, _, _ = metas(n, rp, ci, (16, 8))
    big = dataclasses.replace(host, config=TileConfig(blk_h=2**16, blk_w=2**14))
    with pytest.raises(ValueError, match="int32"):
        big.to("cpu")
