"""K2 and K3 of the port (``tcgnn_tpu_torch.ops.sfused``) against the JAX package.

The plain versions ``spmm_sfused_torch`` and ``spmm_sfused_bwd_torch``
(what the wrappers run on a CPU tensor) must match the JAX
``spmm_sfused`` / ``spmm_sfused_bwd`` (Pallas in interpret mode) on the
same numpy inputs, in f32 and bf16, with the value operand shared and
separate, and the f64 CSR oracles in f32.  Tolerance ``rtol=atol=1e-5``:
both sides round at the same points (the score to the compute dtype, the
tile product in it, ``t + u`` summed in f32 first) and differ only in the
order of f32 sums.  Inputs are scaled by 0.3, the scale of AGNN's
projected features.  The CUDA kernels run only on a card
(``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops.spmm import spmm_sfused as jax_spmm_sfused
from tcgnn_tpu.ops.spmm import spmm_sfused_bwd as jax_spmm_sfused_bwd
from tcgnn_tpu.sgt import translate as jax_sgt
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.ops import reference as port_ref
from tcgnn_tpu_torch.ops import reset_counts, spmm_sfused, spmm_sfused_bwd
from tcgnn_tpu_torch.sgt import translate as port_sgt

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def graph(kind):
    n = 200
    src, dst = powerlaw_graph(n, 1000, seed=8)
    if kind == "directed":
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    elif kind == "empty_and_partial_windows":  # rows 170.. have no edges
        src, dst = powerlaw_graph(170, 800, seed=9)
    rp, ci = coo_to_csr(src, dst, n)
    return n, rp, ci


def setup(kind, geometry, dtype):
    n, rp, ci = graph(kind)
    bh, bw = geometry
    pt, jt = DTYPES[dtype]
    host = port_sgt.sparse_graph_translate(rp, ci, n, TileConfig(bh, bw, pt), build_tiles=True)
    jmeta = jax_sgt.sparse_graph_translate(
        rp, ci, n, JaxTileConfig(blk_h=bh, blk_w=bw, compute_dtype=jt), emit_chunks=False
    ).as_jax(lite=True)
    return n, rp, ci, host.to("cpu"), torch.from_numpy(host.a_tiles), jmeta, host.a_tiles


def features(n, d, seed):
    return (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)


def oracle_inputs(dtype, *arrays):
    """The compute-dtype operands, in f64."""
    ct = DTYPES[dtype][0]
    return [torch.from_numpy(a).to(ct).double() for a in arrays]


@pytest.mark.parametrize("kind", ["symmetric", "directed", "empty_and_partial_windows"])
@pytest.mark.parametrize("geometry", [(16, 8), (16, 16), (512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 32])
@pytest.mark.parametrize("share", [True, False])
def test_forward_plain_matches_jax(kind, geometry, dtype, d, share):
    n, rp, ci, meta, tiles, jmeta, np_tiles = setup(kind, geometry, dtype)
    xl, xr = features(n, d, 1), features(n, d, 2)
    xv = xr if share else features(n, d, 3)
    xl_t, xr_t = torch.from_numpy(xl), torch.from_numpy(xr)
    xv_t = xr_t if share else torch.from_numpy(xv)
    got = spmm_sfused(xl_t, xr_t, xv_t, meta, tiles)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    xl_j, xr_j = jnp.asarray(xl), jnp.asarray(xr)
    xv_j = xr_j if share else jnp.asarray(xv)
    want = jax_spmm_sfused(xl_j, xr_j, xv_j, jmeta, jnp.asarray(np_tiles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if dtype == "f32":
        oracle = port_ref.sfused_ref(*oracle_inputs(dtype, xl, xr, xv), torch.from_numpy(rp),
                                     torch.from_numpy(ci))
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)
    if kind == "empty_and_partial_windows":
        assert torch.all(got[170:] == 0)


@pytest.mark.parametrize("kind", ["symmetric", "directed"])
@pytest.mark.parametrize("geometry", [(16, 8), (16, 16), (512, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [3, 32])
def test_backward_plain_matches_jax(kind, geometry, dtype, d):
    n, rp, ci, meta, tiles, jmeta, np_tiles = setup(kind, geometry, dtype)
    x, dy = features(n, d, 4), features(n, d, 5)
    dx3, u = spmm_sfused_bwd(torch.from_numpy(x), torch.from_numpy(dy), meta, tiles)
    assert dx3.dtype == u.dtype == torch.float32 and dx3.shape == u.shape == (n, d)
    want_dx3, want_u = jax_spmm_sfused_bwd(jnp.asarray(x), jnp.asarray(dy), jmeta,
                                           jnp.asarray(np_tiles))
    np.testing.assert_allclose(dx3.numpy(), np.asarray(want_dx3), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), **TOL)
    if dtype == "f32":
        o_dx3, o_u = port_ref.sfused_bwd_ref(*oracle_inputs(dtype, x, dy), torch.from_numpy(rp),
                                             torch.from_numpy(ci))
        np.testing.assert_allclose(dx3.numpy(), o_dx3.numpy(), **TOL)
        np.testing.assert_allclose(u.numpy(), o_u.numpy(), **TOL)


def test_backward_u_is_the_forward():
    """``u`` of the backward is the forward product ``(A ⊙ x x^T) @ x``."""
    n, _, _, meta, tiles, _, _ = setup("symmetric", (16, 8), "f32")
    x = torch.from_numpy(features(n, 9, 6))
    _, u = spmm_sfused_bwd(x, torch.from_numpy(features(n, 9, 7)), meta, tiles)
    torch.testing.assert_close(u, spmm_sfused(x, x, x, meta, tiles), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_count_plain_calls_and_bad_operands_raise():
    n, _, _, meta, tiles, _, _ = setup("symmetric", (16, 8), "f32")
    x = torch.from_numpy(features(n, 4, 8))
    reset_counts()
    spmm_sfused(x, x, x, meta, tiles)
    spmm_sfused_bwd(x, x, meta, tiles)
    assert (spmm_sfused.plain_calls, spmm_sfused.launches) == (1, 0)
    assert (spmm_sfused_bwd.plain_calls, spmm_sfused_bwd.launches) == (1, 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.empty(n, 4, device="meta")
        spmm_sfused(m, m, m, meta, tiles)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.empty(n, 4, device="meta")
        spmm_sfused_bwd(m, m, meta, tiles)
    with pytest.raises(ValueError, match="expected"):
        spmm_sfused(torch.zeros(n + 1, 4), x, x, meta, tiles)
    with pytest.raises(ValueError, match="operands"):
        spmm_sfused_bwd(x, torch.zeros(n, 5), meta, tiles)
    reset_counts()
    assert (spmm_sfused.plain_calls, spmm_sfused_bwd.plain_calls) == (0, 0)
