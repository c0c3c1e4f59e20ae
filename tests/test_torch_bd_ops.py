"""K5, K6 and K7 of the port (``tcgnn_tpu_torch.ops.blockdiag``) against the JAX package.

The plain versions (what the wrappers run on a CPU tensor) must match the
JAX ``spmm_block_diag``, ``bd_sfused`` and ``bd_sfused_bwd`` (Pallas in
interpret mode) on the same numpy inputs: random packs of about 5 entries
a row, as on DD (int8 and int16 counts, and for K5 weighted packs of the
compute dtype)
for the offset sets ``(0,)``, ``(-1, 0, 1)``, ``(-3..3)`` and ``(0, 1, 2)``,
on 1,000 and 1,100 nodes (a partial last bin; 1,100 also pads the pack
with zero bins), f32 and bf16, and every K6 operand-sharing case.
Tolerance ``rtol=atol=1e-5`` in both dtypes: both sides round at the same
points (pack and features to the compute dtype, the score, the pack-score
product, ``t + u`` in f32, the compute-dtype store) and differ only in the
order of f32 sums.  The bf16 cases take features on a grid where those sums
are exact, so any difference is a rounding point.  In f32 the outputs also
match the f64 CSR oracles of ``ops.reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgnn_tpu.config import TileConfig as JaxTileConfig
from tcgnn_tpu.ops import spmm as jax_spmm
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.ops import (
    bd_sfused,
    bd_sfused_bwd,
    reset_counts,
    spmm_block_diag,
)
from tcgnn_tpu_torch.ops import reference as port_ref

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
OFFSETS = {"diag": (0,), "tri": (-1, 0, 1), "hepta": (-3, -2, -1, 0, 1, 2, 3),
           "upper": (0, 1, 2)}
BN = 128


def make_pack(n, offsets, kind, dtype="f32", seed=0):
    """A random pack [Bp, BN, K*BN], about 5 entries a row as on DD, as
    numpy: int8 counts 1-3; int16, the same with one entry in 500 a count of
    128-300; or (kind "weighted") normal weights rounded to the compute
    dtype."""
    rng = np.random.default_rng(seed)
    bp = -(-(-(-n // BN)) // 8) * 8
    shape = (bp, BN, len(offsets) * BN)
    mask = rng.random(shape) < 5 / shape[2]
    if kind == "int8":
        pack = (mask * rng.integers(1, 4, shape)).astype(np.int8)
    elif kind == "int16":
        big = rng.random(shape) < 0.002
        pack = (mask * np.where(big, rng.integers(128, 301, shape),
                                rng.integers(1, 4, shape))).astype(np.int16)
    else:
        w = torch.from_numpy((mask * rng.standard_normal(shape)).astype(np.float32))
        pack = w.to(DTYPES[dtype][0]).float().numpy()
    return pack


def pack_tensors(pack, kind, dtype):
    """The pack for both packages: weighted packs in the compute dtype."""
    pt, jt = DTYPES[dtype]
    if kind == "weighted":
        return torch.from_numpy(pack).to(pt), jnp.asarray(pack, jt)
    return torch.from_numpy(pack), jnp.asarray(pack)


def pack_csr(pack, offsets, n):
    """The pack's nonzeros as a CSR over n nodes (rows/columns inside the
    graph only) and its per-edge values, for the f64 oracles."""
    bp, bn, kw = pack.shape
    r, j = np.nonzero(pack.reshape(bp * bn, kw))
    vals = pack.reshape(bp * bn, kw)[r, j].astype(np.float64)
    cols = (r // bn + np.asarray(offsets)[j // bn]) * bn + j % bn
    keep = (r < n) & (cols >= 0) & (cols < n)
    r, cols, vals = r[keep], cols[keep], vals[keep]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=ptr[1:])
    return torch.from_numpy(ptr), torch.from_numpy(cols), torch.from_numpy(vals)


def features(n, d, seed, dtype="f32"):
    """Normal features scaled by 0.3; for bf16, on the grid of 1/64 in
    [-1/2, 1/2], where every product and every sum of the sizes here is
    exact in f32, so the comparison sees the rounding points and not the
    order of the sums."""
    x = (np.random.default_rng(seed).standard_normal((n, d)) * 0.3).astype(np.float32)
    if dtype == "bf16":
        x = np.clip(np.round(x * 64), -32, 32).astype(np.float32) / 64
    return x


def configs(dtype):
    pt, jt = DTYPES[dtype]
    return TileConfig(compute_dtype=pt), JaxTileConfig(compute_dtype=jt)


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


@pytest.mark.parametrize("offsets", list(OFFSETS), ids=list(OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16", "weighted"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(1000, 16), (1100, 3)])
def test_spmm_block_diag_plain_matches_jax(offsets, kind, dtype, n, d):
    offs = OFFSETS[offsets]
    pack = make_pack(n, offs, kind, dtype)
    pt_pack, jx_pack = pack_tensors(pack, kind, dtype)
    cfg, jcfg = configs(dtype)
    x = features(n, d, 1, dtype)
    got = spmm_block_diag(torch.from_numpy(x), pt_pack, offsets=offs, cfg=cfg)
    assert got.dtype == cfg.compute_dtype and got.shape == (n, d)
    want = jax_spmm.spmm_block_diag(jnp.asarray(x), jx_pack, offsets=offs, cfg=jcfg,
                                    interpret=True)
    close(got, want)
    if dtype == "f32":
        ptr, cols, vals = pack_csr(pack, offs, n)
        close(got, port_ref.spmm_ref(torch.from_numpy(x).double(), ptr, cols, vals).numpy())


SHARING = {  # which operands of K6 are the same tensor
    "all_one": ("x", "x", "x"),
    "l_is_r": ("x", "x", "v"),
    "l_is_v": ("x", "r", "x"),
    "v_is_r": ("l", "x", "x"),
    "separate": ("l", "r", "v"),
}


@pytest.mark.parametrize("offsets", list(OFFSETS), ids=list(OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sharing", list(SHARING))
def test_bd_sfused_plain_matches_jax(offsets, kind, dtype, sharing):
    n, d = 1100, 16
    offs = OFFSETS[offsets]
    pack = make_pack(n, offs, kind, dtype, seed=2)
    pt_pack, jx_pack = pack_tensors(pack, kind, dtype)
    cfg, jcfg = configs(dtype)
    arrays = {name: features(n, d, 3 + i, dtype) for i, name in enumerate("xlrv")}
    pt = {name: torch.from_numpy(a) for name, a in arrays.items()}
    jx = {name: jnp.asarray(a) for name, a in arrays.items()}
    names = SHARING[sharing]
    got = bd_sfused(*(pt[k] for k in names), pt_pack, offsets=offs, cfg=cfg)
    assert got.dtype == cfg.compute_dtype and got.shape == (n, d)
    want = jax_spmm.bd_sfused(*(jx[k] for k in names), jx_pack, offsets=offs, cfg=jcfg,
                              interpret=True)
    close(got, want)
    if dtype == "f32":
        ptr, cols, vals = pack_csr(pack, offs, n)
        xl, xr, xv = (torch.from_numpy(arrays[k]).double() for k in names)
        scores = port_ref.sddmm_ref(xl, ptr, cols, xr) * vals
        close(got, port_ref.spmm_ref(xv, ptr, cols, scores).numpy())


@pytest.mark.parametrize("offsets", list(OFFSETS), ids=list(OFFSETS))
@pytest.mark.parametrize("kind", ["int8", "int16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [2, 16])
def test_bd_sfused_bwd_plain_matches_jax(offsets, kind, dtype, d):
    n = 1100
    offs = OFFSETS[offsets]
    pack = make_pack(n, offs, kind, dtype, seed=4)
    pt_pack, jx_pack = pack_tensors(pack, kind, dtype)
    cfg, jcfg = configs(dtype)
    x, dy = features(n, d, 8, dtype), features(n, d, 9, dtype)
    dx3, u = bd_sfused_bwd(torch.from_numpy(x), torch.from_numpy(dy), pt_pack, offsets=offs,
                           cfg=cfg)
    assert dx3.dtype == u.dtype == cfg.compute_dtype and dx3.shape == u.shape == (n, d)
    want_dx3, want_u = jax_spmm.bd_sfused_bwd(jnp.asarray(x), jnp.asarray(dy), jx_pack,
                                              offsets=offs, cfg=jcfg, interpret=True)
    close(dx3, want_dx3)
    close(u, want_u)
    if dtype == "f32":
        ptr, cols, vals = pack_csr(pack, offs, n)
        xd, dyd = torch.from_numpy(x).double(), torch.from_numpy(dy).double()
        s = port_ref.sddmm_ref(xd, ptr, cols) * vals
        tw = vals * (port_ref.sddmm_ref(dyd, ptr, cols, xd)
                     + port_ref.sddmm_ref(xd, ptr, cols, dyd))
        close(dx3, (port_ref.spmm_ref(dyd, ptr, cols, s)
                    + port_ref.spmm_ref(xd, ptr, cols, tw)).numpy())
        close(u, port_ref.spmm_ref(xd, ptr, cols, s).numpy())


def test_bd_backward_u_is_the_forward():
    """``u`` of K7 is K6's ``(C ⊙ x x^T) @ x``."""
    offs = OFFSETS["tri"]
    pack = torch.from_numpy(make_pack(700, offs, "int8"))
    x = torch.from_numpy(features(700, 9, 10))
    _, u = bd_sfused_bwd(x, torch.from_numpy(features(700, 9, 11)), pack, offsets=offs,
                         cfg=TileConfig())
    torch.testing.assert_close(u, bd_sfused(x, x, x, pack, offsets=offs, cfg=TileConfig()),
                               rtol=1e-5, atol=1e-6)


def test_cpu_tensors_count_plain_calls_and_bad_operands_raise():
    offs, cfg = OFFSETS["tri"], TileConfig()
    pack = torch.from_numpy(make_pack(300, offs, "int8"))
    x = torch.from_numpy(features(300, 4, 12))
    reset_counts()
    spmm_block_diag(x, pack, offsets=offs, cfg=cfg)
    bd_sfused(x, x, x, pack, offsets=offs, cfg=cfg)
    bd_sfused_bwd(x, x, pack, offsets=offs, cfg=cfg)
    for op in (spmm_block_diag, bd_sfused, bd_sfused_bwd):
        assert (op.plain_calls, op.launches) == (1, 0)
    m = torch.empty(300, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        spmm_block_diag(m, pack, offsets=offs, cfg=cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        bd_sfused(m, m, m, pack, offsets=offs, cfg=cfg)
    with pytest.raises(ValueError, match="no kernel for device"):
        bd_sfused_bwd(m, m, pack, offsets=offs, cfg=cfg)
    with pytest.raises(ValueError, match="do not fit"):
        spmm_block_diag(x, pack, offsets=(0, 1), cfg=cfg)
    with pytest.raises(ValueError, match="nodes"):
        spmm_block_diag(torch.zeros(pack.shape[0] * BN + 1, 4), pack, offsets=offs, cfg=cfg)
    with pytest.raises(ValueError, match="operands"):
        bd_sfused_bwd(x, torch.zeros(300, 5), pack, offsets=offs, cfg=cfg)
    reset_counts()
    assert (spmm_block_diag.plain_calls, bd_sfused.plain_calls) == (0, 0)
