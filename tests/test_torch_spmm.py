"""K1 of the port (``tcgnn_tpu_torch.ops.spmm``) against the JAX package.

The plain PyTorch version ``spmm_tc_dense_torch`` must match the JAX
``spmm_tc_dense`` (Pallas in interpret mode, as ``tests/test_dense_tiles.py``
runs it) and both CSR oracles on the same numpy inputs.  f32 tolerance
``rtol=atol=1e-5``: the paths differ only in summation order over a few
dozen terms.  The CUDA kernel itself runs only on a card
(``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops import reference as jax_ref
from tcgnn_tpu.ops.spmm import spmm_tc_dense as jax_spmm_tc_dense
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import reference as port_ref
from tcgnn_tpu_torch.ops.spmm import (
    check_tiled_operands,
    reset_counts,
    spmm_tc_dense,
    spmm_tc_dense_torch,
)
from tcgnn_tpu_torch.sgt import translate as port_sgt

F32 = dict(rtol=1e-5, atol=1e-5)


def graph(kind):
    if kind == "powerlaw":
        n = 300
        src, dst = powerlaw_graph(n, 1500, seed=8)
    elif kind == "empty_and_partial_windows":
        # Nodes 200..260 have no edges (empty 16-row windows); 260 rows
        # leave the last window partial at every geometry used here.
        n = 260
        src, dst = powerlaw_graph(200, 1000, seed=9)
    else:  # one edge 140 times: counts over 127 force float tiles
        n = 200
        src, dst = powerlaw_graph(n, 900, seed=10)
        src, dst = np.concatenate([src, np.full(140, 4)]), np.concatenate([dst, np.full(140, 9)])
    rp, ci = coo_to_csr(src, dst, n)
    return n, rp, ci


def port_meta(n, rp, ci, bh, bw, dtype=torch.float32):
    host = port_sgt.sparse_graph_translate(
        rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), build_tiles=True
    )
    return host, host.to("cpu"), torch.from_numpy(host.a_tiles)


def jax_out(x, n, rp, ci, bh, bw, tiles, dtype=jnp.float32):
    meta = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, compute_dtype=dtype), emit_chunks=False
    ).as_jax(lite=True)
    return np.asarray(jax_spmm_tc_dense(jnp.asarray(x), meta, jnp.asarray(tiles)).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["powerlaw", "empty_and_partial_windows", "duplicates_over_127"])
@pytest.mark.parametrize("geometry", [(8, 8), (16, 8), (16, 16), (512, 128)])
@pytest.mark.parametrize("d", [3, 16, 50, 130])
def test_plain_matches_jax_and_oracles(kind, geometry, d):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    host, meta, tiles = port_meta(n, rp, ci, bh, bw)
    assert tiles.dtype == (torch.float32 if kind == "duplicates_over_127" else torch.int8)
    x = np.random.default_rng(d).standard_normal((n, d), dtype=np.float32)

    got = spmm_tc_dense_torch(torch.from_numpy(x), meta, tiles)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), jax_out(x, n, rp, ci, bh, bw, host.a_tiles), **F32)
    oracle = port_ref.spmm_ref(torch.from_numpy(x), torch.from_numpy(rp), torch.from_numpy(ci))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **F32)
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(jax_ref.spmm_ref(jnp.asarray(x), jnp.asarray(rp), jnp.asarray(ci))),
        **F32,
    )


@pytest.mark.parametrize("geometry", [(16, 8), (512, 128)])
def test_plain_bf16_matches_jax(geometry):
    """bf16 compute: x cast before the gather, f32 accumulation, bf16
    store.  Both sides round the same f32 sums once, so they agree to one
    bf16 rounding step (rtol 1e-2)."""
    n, rp, ci = graph("powerlaw")
    bh, bw = geometry
    host, meta, tiles = port_meta(n, rp, ci, bh, bw, dtype=torch.bfloat16)
    x = np.random.default_rng(1).standard_normal((n, 24), dtype=np.float32)
    got = spmm_tc_dense_torch(torch.from_numpy(x), meta, tiles)
    assert got.dtype == torch.bfloat16
    want = jax_out(x, n, rp, ci, bh, bw, host.a_tiles, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_padding_windows_write_zeros():
    """Empty windows carry one zero padding block (column 0): their output
    rows are zero, and the partial last window is cut at n rows."""
    n, rp, ci = graph("empty_and_partial_windows")
    host, meta, tiles = port_meta(n, rp, ci, 16, 8)
    assert np.all(host.block_partition >= 1)
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(0))
    out = spmm_tc_dense_torch(x, meta, tiles)
    assert out.shape == (n, 5)
    assert torch.all(out[200:] == 0)


def test_sddmm_ref_matches_jax():
    n, rp, ci = graph("powerlaw")
    x = np.random.default_rng(2).standard_normal((n, 7), dtype=np.float32)
    got = port_ref.sddmm_ref(torch.from_numpy(x), torch.from_numpy(rp), torch.from_numpy(ci))
    want = jax_ref.sddmm_ref(jnp.asarray(x), jnp.asarray(rp), jnp.asarray(ci))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cpu_tensor_counts_plain_calls():
    n, rp, ci = graph("powerlaw")
    _, meta, tiles = port_meta(n, rp, ci, 16, 8)
    x = torch.randn(n, 4, generator=torch.Generator().manual_seed(0))
    reset_counts()
    out = spmm_tc_dense(x, meta, tiles)
    out = spmm_tc_dense(out, meta, tiles)
    assert (spmm_tc_dense.plain_calls, spmm_tc_dense.launches) == (2, 0)
    torch.testing.assert_close(out, spmm_tc_dense_torch(spmm_tc_dense_torch(x, meta, tiles),
                                                        meta, tiles))
    reset_counts()
    assert (spmm_tc_dense.plain_calls, spmm_tc_dense.launches) == (0, 0)


def test_wrapper_rejects_other_devices_and_shapes():
    n, rp, ci = graph("powerlaw")
    _, meta, tiles = port_meta(n, rp, ci, 16, 8)
    reset_counts()
    with pytest.raises(ValueError, match="no kernel for device"):
        spmm_tc_dense(torch.empty(n, 4, device="meta"), meta, tiles)
    with pytest.raises(ValueError, match="expected"):
        spmm_tc_dense(torch.zeros(n + 1, 4), meta, tiles)
    assert (spmm_tc_dense.plain_calls, spmm_tc_dense.launches) == (0, 0)


@pytest.mark.parametrize("fault", ["none", "int64", "strided", "other_device"])
def test_meta_checks_its_kernel_arrays_once(fault):
    """``TorchSGTMeta.kernel_device`` is set where the meta is made (and on
    ``dataclasses.replace``): the device of the four arrays the tile kernels
    read when all are int32 and contiguous there, else None, so that the
    wrappers look at them again only to name a fault."""
    n, rp, ci = graph("powerlaw")
    _, meta, tiles = port_meta(n, rp, ci, 16, 8)
    assert meta.kernel_device == torch.device("cpu")
    bad = {"none": meta.win_start, "int64": meta.win_start.long(),
           "strided": torch.stack([meta.win_start, meta.win_start], 1)[:, 0],
           "other_device": meta.win_start.to("meta")}[fault]
    m = dataclasses.replace(meta, win_start=bad)
    assert m.kernel_device == (torch.device("cpu") if fault == "none" else None)
    if fault == "int64":
        with pytest.raises(TypeError, match="win_start must be int32"):
            check_tiled_operands("spmm_tc_dense", torch.zeros(n, 4), m, tiles)
