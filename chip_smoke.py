#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tcgnn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
  2. build K1-K7 (``tcgnn_tpu_torch/csrc/{spmm_dense,spmm_sfused,
     sddmm_dense,spmm_bd}.cu``) with nvcc for sm_90a, one nvcc per source,
     all at once, printing ``-Xptxas -v``;
  3. K1 against its plain PyTorch version on the card: pubmed tiling at
     512x128 and 16x8, d in {16, 500}, f32 and bf16; a graph with a
     duplicate count above 127 (float tiles); an asymmetric graph through
     its transpose tiling, and through weighted tiles;
  4. autograd: ``TiledGraph.spmm`` forward and backward, kernel against
     plain version and CSR oracle, on the asymmetric graph;
  5. K2, K3 and K4 against their plain versions and f64 CSR oracles:
     pubmed at 512x128 and 16x8, d in {32, 3} (AGNN's hidden and class
     widths), f32 and bf16, K2's value operand shared and separate; K4 on
     the asymmetric graph too;
  6. autograd of the AGNN ops, forward and backward, against f64 oracles:
     ``agnn_aggregate`` (K2/K3, gradient of the attention weights included)
     on pubmed, and the weighted SpMM and SDDMM (K1/K4) on the asymmetric
     graph;
  7. K5, K6 and K7 against their plain versions and the f64 oracles of the
     covered edges: DD's pack (301 MB) with K5 at d in {2, 16, 89} and over
     a weighted pack, K6 (every operand-sharing case) and K7 at d in
     {32, 2}, f32 and bf16; K5 over Yeast's pack (659 MB, fully covered) at
     d=2, over an int16 pack (a union graph with a duplicate count above
     127) and over a banded graph's transpose pack;
  8. autograd on the block-diagonal route against f64 oracles: ``spmm``,
     ``agnn_aggregate`` (attention gradient included), ``spmm_weighted``
     and ``sddmm`` on DD and on the asymmetric banded graph;
  9. the main path through ``tcgnn_tpu_torch.train.main``, 20 timed epochs
     each: pubmed (``--dim 500 --classes 3``) GCN with and without
     ``--no_hoist``, GIN (K1), AGNN hidden 32 with 2 and 4 layers (K2/K3),
     AGNN 2 layers on the asymmetric graph (K4 and weighted K1); DD
     (``--dim 89 --classes 2``) GCN with and without ``--no_hoist``, GIN
     (K5, and K1 for the residual), AGNN with 2 and 4 layers (K6/K7, K2/K3
     for the residual), GCN after ``--reorder rcm``; Yeast GCN (K5 alone:
     fully covered, no condensed tiles); AGNN 2 layers on the banded graph
     (K4, K5 over weighted packs, K1).  Each run must take the expected
     route and launch its kernels, and no plain version may have run; the
     loss must be finite and fall, except in the 4-layer AGNN runs (pubmed
     overflows to nan in f32, as in the JAX package), which are only timed;
 10. every kernel and its plain version timed with CUDA events: K1-K4 at
     the pubmed shapes, K5-K7 at DD's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph, train
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.ops import (
    _kernels,
    bd_scatter_weights,
    bd_sfused,
    bd_sfused_bwd,
    bd_sfused_bwd_torch,
    bd_sfused_torch,
    build_a_tiles,
    build_bd_pack,
    reset_counts,
    sddmm_tc_dense,
    sddmm_tc_dense_torch,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
    spmm_block_diag,
    spmm_block_diag_torch,
    spmm_tc_dense,
    spmm_tc_dense_torch,
)
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.sgt.blockdiag import extract_block_diag
from tcgnn_tpu_torch.sgt.translate import sparse_graph_translate, transpose_csr

# Summation order is the only difference between a kernel and its
# references, so rtol applies to the sum of the magnitudes of the summed
# terms (|A| @ |x| for K1; the oracle over absolute values for K2-K4): an
# f32 sum's rounding error scales with it, not with the result (the pubmed
# hub row sums 17,058 terms that largely cancel).
F32_TOL = dict(rtol=1e-5, atol=1e-4)
# bf16: one rounding of a stored sum (K1), or of a score whose last f32 bit
# the summation order moved (K2, K3): 8 mantissa bits.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GEOMETRIES = {"512x128": (512, 128), "16x8": (16, 8)}
TIMING_RUNS = 25
KERNEL_SOURCES = ("spmm_dense", "spmm_sfused", "sddmm_dense", "spmm_bd")
# name, source, TPU kernel it replaces, wrapper
KERNELS = {
    "K1": ("spmm_dense (K1)", "spmm_dense", "tcgnn_tpu/ops/spmm.py:249", spmm_tc_dense),
    "K2": ("spmm_sfused (K2)", "spmm_sfused", "tcgnn_tpu/ops/spmm.py:1335", spmm_sfused),
    "K3": ("spmm_sfused_bwd (K3)", "spmm_sfused", "tcgnn_tpu/ops/spmm.py:1487",
           spmm_sfused_bwd),
    "K4": ("sddmm_dense (K4)", "sddmm_dense", "tcgnn_tpu/ops/sddmm.py:264", sddmm_tc_dense),
    "K5": ("spmm_bd (K5)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:813", spmm_block_diag),
    "K6": ("bd_sfused (K6)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:928", bd_sfused),
    "K7": ("bd_sfused_bwd (K7)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:1094", bd_sfused_bwd),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def compare(name, got, want, mag, tol) -> float:
    """Max abs error of ``got`` against ``want``; raises unless every element
    is finite and within ``atol + rtol * mag``."""
    got32, want32 = got.double(), want.double()
    if got32.shape != want32.shape:
        raise AssertionError(f"{name}: shape {tuple(got32.shape)} vs {tuple(want32.shape)}")
    err = (got32 - want32).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.isfinite(got32).all()) and bool(
        torch.all(err <= tol["atol"] + tol["rtol"] * mag)
    )
    print(f"  {name}: max_abs_err={max_abs:.3e} "
          f"(rtol={tol['rtol']} of the magnitude, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its reference")
    return max_abs


class Csr:
    """A CSR adjacency on the card, for the f64 oracle ``A @ x`` and the
    magnitude ``|A| @ |x|`` (optionally with per-edge weights ``w``)."""

    def __init__(self, rp, ci, dev):
        self.ptr = torch.from_numpy(np.asarray(rp)).to(dev)
        self.idx = torch.from_numpy(np.asarray(ci)).to(dev)

    def oracle(self, x, w=None):
        return spmm_ref(x.double(), self.ptr, self.idx, None if w is None else w.double())

    def magnitude(self, x, w=None):
        return spmm_ref(x.double().abs(), self.ptr, self.idx,
                        None if w is None else w.double().abs())


def with_dtype(meta, dtype):
    return dataclasses.replace(meta, config=dataclasses.replace(meta.config, compute_dtype=dtype))


def check_case(name, x, meta, tiles, csr, errs=None, w=None):
    """K1 on (meta, tiles) against the plain version (f32 and bf16) and, in
    f32, the CSR oracle.  Records the f32 error against the plain version.
    ``w``: the tiles are ``build_a_tiles(meta, w)``, and stay f32 under bf16
    (the kernel rounds them as it reads them)."""
    mag = csr.magnitude(x, w)
    got = spmm_tc_dense(x, meta, tiles)
    err = compare(f"{name} f32 vs plain", got, spmm_tc_dense_torch(x, meta, tiles), mag, F32_TOL)
    compare(f"{name} f32 vs CSR oracle (f64)", got, csr.oracle(x, w), mag, F32_TOL)
    if errs is not None:
        errs[name] = err
    mb = with_dtype(meta, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    tb = tiles if tiles.dtype == torch.int8 or w is not None else tiles.to(torch.bfloat16)
    got = spmm_tc_dense(xb, mb, tb)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: bf16 config stored {got.dtype}")
    compare(f"{name} bf16 vs plain", got, spmm_tc_dense_torch(xb, mb, tb), mag, BF16_TOL)


def randn(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def phase_compare(ds, dev) -> dict:
    """Phase 3 on pubmed and on a graph with duplicate counts above 127.
    Returns the f32 max abs error of each case against the plain version."""
    errs = {}
    csr = Csr(ds.row_pointers, ds.column_index, dev)
    for geo, (bh, bw) in GEOMETRIES.items():
        host = sparse_graph_translate(
            ds.row_pointers, ds.column_index, ds.num_nodes,
            TileConfig(blk_h=bh, blk_w=bw), build_tiles=True,
        )
        print(f"pubmed {geo}: windows={host.num_windows} blocks={host.num_blocks} "
              f"tc_blocks={host.num_real_blocks}")
        meta, tiles = host.to(dev), torch.from_numpy(host.a_tiles).to(dev)
        for d in (16, 500):
            check_case(f"pubmed {geo} d={d}", randn((ds.num_nodes, d), d, dev), meta, tiles,
                       csr, errs)

    # Duplicate counts above 127: the tiles fall back to the compute dtype.
    n = 300
    src, dst = powerlaw_graph(n, 1500, seed=3)
    rp, ci = coo_to_csr(np.concatenate([src, np.full(200, 7)]),
                        np.concatenate([dst, np.full(200, 11)]), n)
    for bh, bw in GEOMETRIES.values():
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev, block_diag=False)
        if g.a_struct.dtype != torch.float32:
            raise AssertionError(f"dup>127 tiles are {g.a_struct.dtype}, expected float32")
        check_case(f"dup>127 {bh}x{bw}", randn((n, 64), 5, dev), g.meta, g.a_struct,
                   Csr(rp, ci, dev), errs)
    return errs


def asymmetric_graph():
    n = 5000
    src, dst = powerlaw_graph(n, 40000, seed=11)
    keep = (src < dst) | ((src + dst) % 3 == 0)  # drop one direction of most pairs
    rp, ci = coo_to_csr(src[keep], dst[keep], n)
    return n, rp, ci


def phase_transpose_and_autograd(dev) -> dict:
    """Phase 3 on an asymmetric graph's transpose tiling, and phase 4:
    autograd through ``TiledGraph.spmm``."""
    errs = {}
    n, rp, ci = asymmetric_graph()
    t_ptr, t_idx, _ = transpose_csr(rp, ci, n)
    csr, csr_t = Csr(rp, ci, dev), Csr(t_ptr, t_idx, dev)
    for bh, bw in GEOMETRIES.values():
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev, block_diag=False)
        if g.symmetric:
            raise AssertionError("test graph came out symmetric")
        dy = randn((n, 48), 13, dev)
        check_case(f"asymmetric {bh}x{bw} transpose", dy, g.meta_t, g.a_struct_t, csr_t, errs)
        w = randn((g.num_edges,), 19, dev)
        check_case(f"asymmetric {bh}x{bw} weighted", dy, g.meta, build_a_tiles(g.meta, w), csr,
                   errs, w=w)

        x = randn((n, 48), 17, dev).requires_grad_(True)
        out = g.spmm(x)
        (out * dy).sum().backward()
        name = f"autograd {bh}x{bw}"
        mag, mag_t = csr.magnitude(x.detach()), csr_t.magnitude(dy)
        errs[name + " fwd"] = compare(f"{name} forward vs plain", out.detach(),
                                      spmm_tc_dense_torch(x.detach(), g.meta, g.a_struct),
                                      mag, F32_TOL)
        errs[name + " bwd"] = compare(f"{name} grad vs plain", x.grad,
                                      spmm_tc_dense_torch(dy, g.meta_t, g.a_struct_t),
                                      mag_t, F32_TOL)
        compare(f"{name} grad vs CSR oracle of A^T (f64)", x.grad, csr_t.oracle(dy), mag_t,
                F32_TOL)
    return errs


def check_agnn_kernels(name, meta, tiles, csr, d, dev, errs):
    """K2 (value operand shared and separate), K3 and K4 on one tiling at
    width d, f32 and bf16, against the plain versions and, in f32, the f64
    CSR oracles (K4 in bf16 too: its products are exact in f32)."""
    n = meta.num_nodes
    ptr, idx = csr.ptr, csr.idx
    xl, xr, xv = (randn((n, d), 30 + i, dev) * 0.3 for i in range(3))
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        m, tag = with_dtype(meta, dtype), f"{name} d={d} {str(dtype)[6:]}"
        ab = [t.to(dtype).double() for t in (xl, xr, xv)]  # the compute-dtype operands
        for share in (True, False):
            v = xr if share else xv
            got = spmm_sfused(xl, xr, v, m, tiles)
            mag = sfused_ref(ab[0].abs(), ab[1].abs(), (ab[1] if share else ab[2]).abs(), ptr, idx)
            what = "shared" if share else "separate"
            err = compare(f"K2 {tag} xv {what} vs plain", got,
                          spmm_sfused_torch(xl, xr, v, m, tiles), mag, tol)
            if dtype == torch.float32:
                errs["K2"][f"{tag} {what}"] = err
                compare(f"K2 {tag} xv {what} vs CSR oracle (f64)", got,
                        sfused_ref(ab[0], ab[1], ab[1] if share else ab[2], ptr, idx), mag, tol)
        dx3, u = spmm_sfused_bwd(xl, xr, m, tiles)
        p_dx3, p_u = spmm_sfused_bwd_torch(xl, xr, m, tiles)
        mag_dx3, mag_u = sfused_bwd_ref(ab[0].abs(), ab[1].abs(), ptr, idx)
        err = max(compare(f"K3 {tag} dx3 vs plain", dx3, p_dx3, mag_dx3, tol),
                  compare(f"K3 {tag} u vs plain", u, p_u, mag_u, tol))
        if dtype == torch.float32:
            errs["K3"][tag] = err
            o_dx3, o_u = sfused_bwd_ref(ab[0], ab[1], ptr, idx)
            compare(f"K3 {tag} dx3 vs CSR oracle (f64)", dx3, o_dx3, mag_dx3, tol)
            compare(f"K3 {tag} u vs CSR oracle (f64)", u, o_u, mag_u, tol)
        check_sddmm(tag, xl, xr, m, csr, ab, errs)


def check_sddmm(tag, xa, xb, meta, csr, ab, errs):
    """K4 against its plain version and the f64 oracle (``ab``: the
    compute-dtype operands in f64)."""
    got = sddmm_tc_dense(xa, meta, xb)
    mag = sddmm_ref(ab[0].abs(), csr.ptr, csr.idx, ab[1].abs())
    err = compare(f"K4 {tag} vs plain", got, sddmm_tc_dense_torch(xa, meta, xb), mag, F32_TOL)
    compare(f"K4 {tag} vs CSR oracle (f64)", got, sddmm_ref(ab[0], csr.ptr, csr.idx, ab[1]), mag,
            F32_TOL)
    if meta.config.compute_dtype == torch.float32:
        errs["K4"][tag] = err


def phase_agnn_kernels(ds, dev) -> dict:
    """Phase 5.  Returns, per kernel, the f32 max abs error of each case
    against the plain version."""
    errs = {"K2": {}, "K3": {}, "K4": {}}
    csr = Csr(ds.row_pointers, ds.column_index, dev)
    for geo, (bh, bw) in GEOMETRIES.items():
        host = sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                      TileConfig(blk_h=bh, blk_w=bw), build_tiles=True)
        meta, tiles = host.to(dev), torch.from_numpy(host.a_tiles).to(dev)
        for d in (32, 3):
            check_agnn_kernels(f"pubmed {geo}", meta, tiles, csr, d, dev, errs)
    n, rp, ci = asymmetric_graph()
    csr = Csr(rp, ci, dev)
    for bh, bw in GEOMETRIES.values():
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev, block_diag=False)
        xa, xb = randn((n, 32), 40, dev), randn((n, 32), 41, dev)
        for dtype in (torch.float32, torch.bfloat16):
            ab = [t.to(dtype).double() for t in (xa, xb)]
            check_sddmm(f"asymmetric {bh}x{bw} {str(dtype)[6:]}", xa, xb,
                        with_dtype(g.meta, dtype), csr, ab, errs)
    return errs


def oracle_grads(fn, inputs):
    """``fn``'s scalar value and the gradients of its inputs, in f64, at the
    inputs and at their absolute values (every gradient here is a sum of
    products of the inputs, so the second bounds each summed term)."""
    results = []
    for transform in (lambda t: t, torch.abs):
        leaves = [transform(t.detach().double()).requires_grad_(True) for t in inputs]
        fn(*leaves).backward()
        results.append([t.grad for t in leaves])
    return results


def check_agnn_autograd(name, g, csr, dev) -> None:
    """``g.agnn_aggregate`` forward, ``dx`` and the attention gradient
    against f64 oracle autograd."""
    n = g.num_nodes
    x, r = randn((n, 32), 50, dev) * 0.3, randn((n, 32), 51, dev)
    att = torch.tensor([[0.6, -0.3]], device=dev)
    leaves = [x.clone().requires_grad_(True), att.clone().requires_grad_(True)]
    out = g.agnn_aggregate(*leaves)
    (out * r).sum().backward()
    x64, a64 = x.double(), att.double()
    compare(f"agnn_aggregate {name} forward vs oracle (f64)", out.detach(),
            a64.mean() * sfused_ref(x64, x64, x64, csr.ptr, csr.idx),
            a64.abs().mean() * sfused_ref(x64.abs(), x64.abs(), x64.abs(), csr.ptr, csr.idx),
            F32_TOL)
    want, mag = oracle_grads(
        lambda x_, a_, r_: (a_.mean() * sfused_ref(x_, x_, x_, csr.ptr, csr.idx) * r_).sum(),
        [x, att, r])
    compare(f"agnn_aggregate {name} dx vs oracle (f64)", leaves[0].grad, want[0], mag[0],
            F32_TOL)
    compare(f"agnn_aggregate {name} datt vs oracle (f64)", leaves[1].grad, want[1], mag[1],
            F32_TOL)


def check_weighted_autograd(name, g, csr, dev) -> None:
    """``g.spmm_weighted`` and ``g.sddmm``, forward and every gradient,
    against f64 oracle autograd."""
    n = g.num_nodes
    x, w = randn((n, 16), 52, dev), randn((g.num_edges,), 53, dev)
    r, re = randn((n, 16), 54, dev), randn((g.num_edges,), 55, dev)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    out, e = g.spmm_weighted(*leaves), g.sddmm(leaves[0])
    ((out * r).sum() + (e * re).sum()).backward()
    name = f"spmm_weighted + sddmm {name}"
    compare(f"{name} forward (spmm_weighted) vs oracle (f64)", out.detach(), csr.oracle(x, w),
            csr.magnitude(x, w), F32_TOL)
    compare(f"{name} forward (sddmm) vs oracle (f64)", e.detach(),
            sddmm_ref(x.double(), csr.ptr, csr.idx),
            sddmm_ref(x.double().abs(), csr.ptr, csr.idx), F32_TOL)
    want, mag = oracle_grads(
        lambda x_, w_, r_, re_: (spmm_ref(x_, csr.ptr, csr.idx, w_) * r_).sum()
        + (sddmm_ref(x_, csr.ptr, csr.idx) * re_).sum(),
        [x, w, r, re])
    compare(f"{name} dx vs oracle (f64)", leaves[0].grad, want[0], mag[0], F32_TOL)
    compare(f"{name} dw vs oracle (f64)", leaves[1].grad, want[1], mag[1], F32_TOL)


def phase_agnn_autograd(ds, dev) -> None:
    """Phase 6: the AGNN ops, forward and backward, against f64 oracles."""
    csr = Csr(ds.row_pointers, ds.column_index, dev)
    for geo, (bh, bw) in GEOMETRIES.items():
        g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                       TileConfig(blk_h=bh, blk_w=bw), device=dev)
        check_agnn_autograd(geo, g, csr, dev)
    n, rp, ci = asymmetric_graph()
    csr = Csr(rp, ci, dev)
    for bh, bw in GEOMETRIES.values():
        g = TiledGraph(rp, ci, n, TileConfig(bh, bw), device=dev, block_diag=False)
        check_weighted_autograd(f"{bh}x{bw}", g, csr, dev)


# ---- the block-diagonal route ------------------------------------------------

def banded_graph():
    """A directed banded graph: 200,000 nodes, 1.2 M edges within +-100 of
    the diagonal and 2% random long-range edges.  The BD route with a
    residual, asymmetric: weighted packs and K4 under AGNN."""
    n = 200_000
    rng = np.random.default_rng(21)
    src = rng.integers(0, n, 1_200_000)
    dst = np.clip(src + rng.integers(-100, 101, len(src)), 0, n - 1)
    far = rng.integers(0, n, (2, 24_000))
    rp, ci = coo_to_csr(np.concatenate([src, far[0]]), np.concatenate([dst, far[1]]), n)
    return n, rp, ci


def covered_csr(rp, ci, m, dev) -> Csr:
    """The CSR of a BD decomposition's covered edges (what its pack holds)."""
    n = len(rp) - 1
    rows = np.repeat(np.arange(n), np.diff(rp))[m.cov_edge_ids]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return Csr(ptr, np.asarray(ci)[m.cov_edge_ids], dev)


def check_bd_spmm(name, x, pack, offsets, csr, errs, w=None, pack_bf16=None):
    """K5 on ``pack`` against the plain version (f32 and bf16) and, in f32,
    the f64 oracle of the covered edges (weighted by ``w``: the pack is
    then f32 weights, and ``pack_bf16`` the same weights in bf16)."""
    mag = csr.magnitude(x, w)
    f32, bf16 = TileConfig(), TileConfig(compute_dtype=torch.bfloat16)
    got = spmm_block_diag(x, pack, offsets=offsets, cfg=f32)
    errs[name] = compare(f"K5 {name} f32 vs plain", got,
                         spmm_block_diag_torch(x, pack, offsets=offsets, cfg=f32), mag, F32_TOL)
    compare(f"K5 {name} f32 vs CSR oracle (f64)", got, csr.oracle(x, w), mag, F32_TOL)
    pb = pack if pack_bf16 is None else pack_bf16
    got = spmm_block_diag(x, pb, offsets=offsets, cfg=bf16)
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"K5 {name}: bf16 config stored {got.dtype}")
    compare(f"K5 {name} bf16 vs plain", got,
            spmm_block_diag_torch(x, pb, offsets=offsets, cfg=bf16), mag, BF16_TOL)


def check_bd_agnn_kernels(name, pack, offsets, csr, d, dev, errs):
    """K6 (every operand-sharing case) and K7 at width d, f32 and bf16,
    against the plain versions and, in f32, the f64 oracles of the covered
    edges."""
    n = csr.ptr.shape[0] - 1
    ptr, idx = csr.ptr, csr.idx
    xl, xr, xv = (randn((n, d), 60 + i, dev) * 0.3 for i in range(3))
    cases = {"all one": (xl, xl, xl), "xl is xr": (xl, xl, xv), "xl is xv": (xl, xr, xl),
             "xv is xr": (xl, xr, xr), "separate": (xl, xr, xv)}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        cfg, tag = TileConfig(compute_dtype=dtype), f"{name} d={d} {str(dtype)[6:]}"
        ab = {id(t): t.to(dtype).double() for t in (xl, xr, xv)}  # compute-dtype operands
        for case, ops in cases.items():
            got = bd_sfused(*ops, pack, offsets=offsets, cfg=cfg)
            o64 = [ab[id(t)] for t in ops]
            mag = sfused_ref(*(t.abs() for t in o64), ptr, idx)
            err = compare(f"K6 {tag} {case} vs plain", got,
                          bd_sfused_torch(*ops, pack, offsets=offsets, cfg=cfg), mag, tol)
            if dtype == torch.float32:
                errs["K6"][f"{tag} {case}"] = err
                compare(f"K6 {tag} {case} vs CSR oracle (f64)", got, sfused_ref(*o64, ptr, idx),
                        mag, tol)
        dx3, u = bd_sfused_bwd(xl, xr, pack, offsets=offsets, cfg=cfg)
        p_dx3, p_u = bd_sfused_bwd_torch(xl, xr, pack, offsets=offsets, cfg=cfg)
        x64, dy64 = ab[id(xl)], ab[id(xr)]
        mag_dx3, mag_u = sfused_bwd_ref(x64.abs(), dy64.abs(), ptr, idx)
        err = max(compare(f"K7 {tag} dx3 vs plain", dx3, p_dx3, mag_dx3, tol),
                  compare(f"K7 {tag} u vs plain", u, p_u, mag_u, tol))
        if dtype == torch.float32:
            errs["K7"][tag] = err
            o_dx3, o_u = sfused_bwd_ref(x64, dy64, ptr, idx)
            compare(f"K7 {tag} dx3 vs CSR oracle (f64)", dx3, o_dx3, mag_dx3, tol)
            compare(f"K7 {tag} u vs CSR oracle (f64)", u, o_u, mag_u, tol)


def bd_pack(name, ds, dev):
    """A dataset's BD decomposition, its structural pack on the card, and
    the CSR of its covered edges."""
    m = extract_block_diag(ds.row_pointers, ds.column_index, ds.num_nodes)
    pack = build_bd_pack(torch.from_numpy(m.tile_idx).to(dev), torch.from_numpy(m.tile_cnt).to(dev),
                         k=len(m.offsets), nbins=m.num_bins, bn=m.bin_rows)
    print(f"{name} BD pack: offsets {m.offsets}, coverage {m.coverage:.5f}, "
          f"{tuple(pack.shape)} {pack.dtype}, {pack.numel() / 2**20:.1f} MiB, "
          f"{float((pack != 0).float().mean()) * 100:.3f}% nonzero")
    return m, pack, covered_csr(ds.row_pointers, ds.column_index, m, dev)


def phase_bd_kernels(dd, dev) -> dict:
    """Phase 7: K5, K6 and K7 against their plain versions and f64 oracles.
    Returns, per kernel, the f32 max abs error of each case against the
    plain version."""
    errs = {"K5": {}, "K6": {}, "K7": {}}
    n = dd.num_nodes
    m, pack, cov = bd_pack("DD", dd, dev)
    k = len(m.offsets)
    # d=2: a hoisted GCN's layer 2 projects first, so every K5 call of its
    # epoch (forward and transpose backward) aggregates DD's 2 classes.
    for d in (2, 16, 89):
        check_bd_spmm(f"DD d={d}", randn((n, d), 70 + d, dev), pack, m.offsets, cov, errs["K5"])
    w = randn((len(m.cov_edge_ids),), 72, dev)
    cov_pack = torch.from_numpy(m.packed_cov_idx()).to(dev)
    weighted = {dt: bd_scatter_weights(w, cov_pack, bp=pack.shape[0], bn=m.bin_rows, k=k, dtype=dt)
                for dt in (torch.float32, torch.bfloat16)}
    check_bd_spmm("DD weighted d=16", randn((n, 16), 73, dev), weighted[torch.float32], m.offsets,
                  cov, errs["K5"], w=w, pack_bf16=weighted[torch.bfloat16])
    del weighted
    for d in (32, 2):
        check_bd_agnn_kernels("DD", pack, m.offsets, cov, d, dev, errs)
    del pack

    # Yeast's fully covered pack (659 MB), at the width of its GCN epoch.
    yeast = synthesize("Yeast", 74, 2)
    m, pack, cov = bd_pack("Yeast", yeast, dev)
    check_bd_spmm("Yeast d=2", randn((yeast.num_nodes, 2), 76, dev), pack, m.offsets, cov,
                  errs["K5"])
    del yeast, m, pack, cov
    torch.cuda.empty_cache()

    # An int16 pack: one cell counted 200 times, on a small union graph.
    ns = 3000
    src, dst = component_union_graph(ns, 7000, 100, seed=4)
    rp, ci = coo_to_csr(np.concatenate([src, np.full(200, 5)]),
                        np.concatenate([dst, np.full(200, 6)]), ns)
    g = TiledGraph(rp, ci, ns, TileConfig(), device=dev)
    if not g.block_diag or g.bd.pack.dtype != torch.int16:
        raise AssertionError(f"dup>127 union graph: block_diag {g.block_diag}, "
                             f"pack {g.bd.pack.dtype if g.block_diag else None}")
    check_bd_spmm("dup>127 int16 pack d=24", randn((ns, 24), 74, dev), g.bd.pack, g.bd_offsets,
                  Csr(rp, ci, dev), errs["K5"])

    # An asymmetric banded graph's transpose pack.
    nb, rp, ci = banded_graph()
    t_ptr, t_idx, _ = transpose_csr(rp, ci, nb)
    g = TiledGraph(rp, ci, nb, TileConfig(), device=dev)
    if not g.block_diag or g.symmetric:
        raise AssertionError("banded graph: expected an asymmetric BD graph")
    m_t = extract_block_diag(t_ptr, t_idx, nb)
    check_bd_spmm("banded transpose pack d=48", randn((nb, 48), 75, dev), g.bd_t.pack,
                  g.bd_offsets_t, covered_csr(t_ptr, t_idx, m_t, dev), errs["K5"])
    return errs


def phase_bd_autograd(dd, dev) -> None:
    """Phase 8: the graph ops on the BD route (K5-K7 with the residual's
    K1-K3, K4 over every edge), forward and backward, against f64 oracle
    autograd: DD (symmetric, with a residual) and the banded graph
    (asymmetric, with a residual)."""
    nb, rp, ci = banded_graph()
    graphs = [("DD", dd.num_nodes, dd.row_pointers, dd.column_index), ("banded", nb, rp, ci)]
    for name, n, rp, ci in graphs:
        g = TiledGraph(rp, ci, n, TileConfig(), device=dev, weighted_traffic=True)
        if not g.block_diag or g.bd_full_coverage:
            raise AssertionError(f"{name}: expected the BD route with a residual")
        csr = Csr(rp, ci, dev)
        t_ptr, t_idx, _ = transpose_csr(rp, ci, n)
        csr_t = Csr(t_ptr, t_idx, dev)
        x, dy = randn((n, 24), 80, dev), randn((n, 24), 81, dev)
        xl = x.clone().requires_grad_(True)
        out = g.spmm(xl)
        (out * dy).sum().backward()
        compare(f"spmm {name} forward vs oracle (f64)", out.detach(), csr.oracle(x),
                csr.magnitude(x), F32_TOL)
        compare(f"spmm {name} grad vs oracle of A^T (f64)", xl.grad, csr_t.oracle(dy),
                csr_t.magnitude(dy), F32_TOL)
        if g.agnn_aggregate is not None:
            check_agnn_autograd(name, g, csr, dev)
        check_weighted_autograd(name, g, csr, dev)


def write_dataset(directory, name, graph) -> str:
    """A graph as the trainer's ``.npz`` format, with random labels of 4
    classes."""
    n, rp, ci = graph()
    rows = np.repeat(np.arange(n), np.diff(rp))
    y = np.random.default_rng(12).integers(0, 4, n).astype(np.int32)
    np.savez(os.path.join(directory, f"{name}.npz"), src_li=rows, dst_li=ci, num_nodes=n, y=y)
    return name


def phase_train(data_dir) -> tuple[list, dict]:
    """Phase 9: the main path, through the trainer's entry point.  Every
    count is set to 0 just before each run and read just after it; returns
    the runs and each kernel's launches summed over them."""
    asym = write_dataset(data_dir, "asymmetric", asymmetric_graph)
    banded = write_dataset(data_dir, "banded", banded_graph)
    pubmed = ["--dataset", "pubmed", "--dim", "500", "--classes", "3"]
    dd = ["--dataset", "DD", "--dim", "89", "--classes", "2"]
    agnn = ["--model", "agnn", "--hidden", "32"]
    bd_kernels = ("K5", "K6", "K7")
    # label, arguments, kernels the run must launch, kernels it must not,
    # loss must fall, BD route
    runs = [
        ("gcn --no_hoist", [*pubmed, "--model", "gcn", "--no_hoist"], ("K1",), bd_kernels,
         True, False),
        ("gcn", [*pubmed, "--model", "gcn"], ("K1",), bd_kernels, True, False),
        ("gin", [*pubmed, "--model", "gin"], ("K1",), bd_kernels, True, False),
        ("agnn 2 layers", [*pubmed, *agnn, "--num_layers", "2"], ("K2", "K3"), bd_kernels,
         True, False),
        ("agnn 4 layers", [*pubmed, *agnn, "--num_layers", "4"], ("K2", "K3"), bd_kernels,
         False, False),
        ("agnn 2 layers, asymmetric graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", asym, "--dim", "64"],
         ("K1", "K4"), bd_kernels, True, False),
        ("DD gcn --no_hoist", [*dd, "--model", "gcn", "--no_hoist"], ("K5", "K1"), (), True,
         True),
        ("DD gcn", [*dd, "--model", "gcn"], ("K5", "K1"), (), True, True),
        ("DD gin", [*dd, "--model", "gin"], ("K5", "K1"), (), True, True),
        ("DD agnn 2 layers", [*dd, *agnn, "--num_layers", "2"], ("K6", "K7", "K2", "K3"), (),
         True, True),
        ("DD agnn 4 layers", [*dd, *agnn, "--num_layers", "4"], ("K6", "K7", "K2", "K3"), (),
         False, True),
        ("DD gcn --reorder rcm", [*dd, "--model", "gcn", "--reorder", "rcm"], ("K5",), (), True,
         True),
        ("Yeast gcn", ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn"],
         ("K5",), ("K1",), True, True),
        ("agnn 2 layers, banded graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", banded, "--dim", "64"],
         ("K5", "K4", "K1"), ("K6", "K7"), True, True),
    ]
    results, launches = [], {k: 0 for k in KERNELS}
    for label, extra, expected, absent, must_fall, bd_route in runs:
        print(f"--- train.main {' '.join(extra)}")
        args = ["--device", "cuda", "--epochs", "20", *extra]
        reset_counts()
        r = train.main(args)
        counts = {k: (w.launches, w.plain_calls) for k, (_, _, _, w) in KERNELS.items()}
        print(f"  block_diag {r['block_diag']}  first loss {r['first_loss']:.6f}  final loss "
              f"{r['final_loss']:.6f}  "
              + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}" for k, c in counts.items()))
        if must_fall and not (math.isfinite(r["final_loss"])
                              and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall "
                                 f"({r['first_loss']} -> {r['final_loss']})")
        if (any(counts[k][0] <= 0 for k in expected) or any(counts[k][0] for k in absent)
                or any(c[1] for c in counts.values())):
            raise AssertionError(f"{label}: expected launches of {expected}, none of {absent}, "
                                 f"no plain calls; got {counts}")
        if r["block_diag"] != bd_route:
            raise AssertionError(f"{label}: block_diag {r['block_diag']}, expected {bd_route}")
        if "pubmed" in extra and r["tc_blocks"] != 334:
            raise AssertionError(f"pubmed at 512x128 gave {r['tc_blocks']} TC blocks, not 334")
        for k, c in counts.items():
            launches[k] += c[0]
        results.append((label, r))
    return results, launches


def median_ms(fn, runs=TIMING_RUNS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_pair(kernel, plain) -> tuple[float, float]:
    """Median ms of kernel and plain version, in turns: plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = median_ms(plain), median_ms(kernel), median_ms(kernel), median_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_timing(ds, dev, card) -> dict:
    """Phase 10: each kernel and its plain version at the pubmed shapes
    (f32): K1 at d=16 and 500 (GCN's layer-2 and hoisted layer-1
    aggregates), K2-K4 at d=32 and 3 (AGNN's hidden and class widths)."""
    times = {}
    for geo, (bh, bw) in GEOMETRIES.items():
        g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                       TileConfig(blk_h=bh, blk_w=bw), device=dev)
        m, a = g.meta, g.a_struct
        for d in (16, 500):
            x = randn((ds.num_nodes, d), 100 + d, dev)
            times[("K1", geo, d)] = timed_pair(lambda: spmm_tc_dense(x, m, a),
                                               lambda: spmm_tc_dense_torch(x, m, a))
        for d in (32, 3):
            x, dy = randn((ds.num_nodes, d), 200 + d, dev) * 0.3, randn((ds.num_nodes, d), 300, dev)
            times[("K2", geo, d)] = timed_pair(lambda: spmm_sfused(x, x, x, m, a),
                                               lambda: spmm_sfused_torch(x, x, x, m, a))
            times[("K3", geo, d)] = timed_pair(lambda: spmm_sfused_bwd(x, dy, m, a),
                                               lambda: spmm_sfused_bwd_torch(x, dy, m, a))
            times[("K4", geo, d)] = timed_pair(lambda: sddmm_tc_dense(x, m, x),
                                               lambda: sddmm_tc_dense_torch(x, m, x))
    return times


def phase_bd_timing(dd, dev) -> dict:
    """Phase 10, BD part: K5 at DD's d=2, 16 and 89 (a hoisted GCN epoch's
    width, GCN's hidden and input widths), K6 and K7 at d=32 and 2 (AGNN's
    hidden and class widths), f32, against their plain versions."""
    times = {}
    g = TiledGraph(dd.row_pointers, dd.column_index, dd.num_nodes, TileConfig(), device=dev)
    p, offs, cfg, n = g.bd.pack, g.bd_offsets, TileConfig(), dd.num_nodes
    for d in (2, 16, 89):
        x = randn((n, d), 400 + d, dev)
        times[("K5", "DD", d)] = timed_pair(
            lambda: spmm_block_diag(x, p, offsets=offs, cfg=cfg),
            lambda: spmm_block_diag_torch(x, p, offsets=offs, cfg=cfg))
    for d in (32, 2):
        x, dy = randn((n, d), 500 + d, dev) * 0.3, randn((n, d), 600, dev)
        times[("K6", "DD", d)] = timed_pair(
            lambda: bd_sfused(x, x, x, p, offsets=offs, cfg=cfg),
            lambda: bd_sfused_torch(x, x, x, p, offsets=offs, cfg=cfg))
        times[("K7", "DD", d)] = timed_pair(
            lambda: bd_sfused_bwd(x, dy, p, offsets=offs, cfg=cfg),
            lambda: bd_sfused_bwd_torch(x, dy, p, offsets=offs, cfg=cfg))
    return times


def build_kernels():
    """One nvcc per source, all started together; prints ``-Xptxas -v``."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(lambda name: _kernels.build(name, verbose=True), KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        _kernels.load(name)
    print(f"K1-K7 build (nvcc, sm_90a, {len(KERNEL_SOURCES)} sources at once): "
          f"{time.perf_counter() - t0:.2f} s")


def main():
    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA GPU")
    card = card_line()
    print(card)
    print("torch.cuda.get_device_name(0):", torch.cuda.get_device_name(0))
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 2. build K1-K7 -------------------------------------------------------
    build_kernels()

    # ---- 3-6. K1-K4 against plain versions and oracles -----------------------
    ds = synthesize("pubmed", seed=0)
    print(f"pubmed: N={ds.num_nodes} E={ds.num_edges} d={ds.num_features}")
    errs = {"K1": phase_compare(ds, dev)}
    errs["K1"].update(phase_transpose_and_autograd(dev))
    errs.update(phase_agnn_kernels(ds, dev))
    phase_agnn_autograd(ds, dev)
    torch.cuda.synchronize()

    # ---- 7-8. K5-K7 and the BD route against plain versions and oracles ------
    dd = synthesize("DD", 89, 2)
    print(f"DD: N={dd.num_nodes} E={dd.num_edges} d={dd.num_features}")
    errs.update(phase_bd_kernels(dd, dev))
    phase_bd_autograd(dd, dev)
    torch.cuda.synchronize()

    # ---- 9. the main path ---------------------------------------------------
    with tempfile.TemporaryDirectory() as data_dir:
        runs, launches = phase_train(data_dir)

    # ---- 10. timing ---------------------------------------------------------
    times = phase_timing(ds, dev, card)
    times.update(phase_bd_timing(dd, dev))
    torch.cuda.synchronize()
    for (k, geo, d), (kt, pt) in times.items():
        print(f"  time {KERNELS[k][0]} {geo} d={d}: kernel {kt:.4f} ms, plain {pt:.4f} ms "
              f"(median of {TIMING_RUNS}, CUDA events; card: {card})")

    for name, r in runs:
        print(f"main path [{name}]: block_diag {r['block_diag']}  TC_Blocks {r['tc_blocks']}  "
              f"Prep. (ms) {r['prep_ms']:.3f}  Prep host (ms) {r['prep_host_ms']:.3f}  "
              f"Train (ms) {r['train_ms']:.3f}  First loss {r['first_loss']:.6f}  "
              f"Final loss {r['final_loss']:.6f}  (card: {card})")
    # The times reported: pubmed 512x128 for K1-K4, DD for K5-K7.
    shape = {"K1": ("512x128", 16), "K2": ("512x128", 32), "K3": ("512x128", 32),
             "K4": ("512x128", 32), "K5": ("DD", 16), "K6": ("DD", 32), "K7": ("DD", 32)}
    kernels = []
    for k, (name, source, replaces, _) in KERNELS.items():
        kt, pt = times[(k, *shape[k])]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tcgnn_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(errs[k].values()),
            "ms": kt,
            "plain_ms": pt,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
