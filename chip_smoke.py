#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tcgnn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
  2. build K1-K10 (``tcgnn_tpu_torch/csrc/{spmm_dense,spmm_sfused,
     sddmm_dense,spmm_bd,chunk}.cu``; K10 is K1's kernel with a score
     operand) with nvcc for sm_90a, one nvcc per source, all at once,
     printing ``-Xptxas -v``;
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
  9. K8 and K9 against their plain versions and f64 CSR oracles: pubmed's
     chunk layout (``dense_tiles=False``) at 512x128 (edge_chunk 128) and
     16x8 (32), flat and cut into window segments by small budgets; K8 at d
     in {16, 41, 500}, K9 at d in {32, 3} with one matrix and two, f32 and
     bf16, K8 weighted and not;
 10. autograd on the streamed route (``dense_tiles=False, streamed=True``):
     ``spmm``, ``spmm_weighted`` and ``sddmm`` on the asymmetric graph,
     against f64 oracle autograd;
 11. the main path through ``tcgnn_tpu_torch.train.main``, 20 timed epochs
     each unless named: pubmed (``--dim 500 --classes 3``) GCN with and without
     ``--no_hoist``, GIN (K1), AGNN hidden 32 with 2 and 4 layers (K2/K3),
     AGNN 2 layers on the asymmetric graph (K4 and weighted K1); DD
     (``--dim 89 --classes 2``) GCN with and without ``--no_hoist``, GIN
     (K5, and K1 for the residual), AGNN with 2 and 4 layers (K6/K7, K2/K3
     for the residual), GCN after ``--reorder rcm``; Yeast GCN (K5 alone:
     fully covered, no condensed tiles); AGNN 2 layers on the banded graph
     (K4, K5 over weighted packs, K1); reddit (``--dim 602 --classes 41``,
     the streamed route, TC_Blocks 265,565) GCN hoisted (K8) and AGNN hidden
     32, 2 layers (K8 and K9).  Each run must take the expected route and
     launch its kernels and no others of K1-K10, and no plain version may
     have run; the loss must be finite and fall, except in the 4-layer AGNN
     runs (pubmed overflows to nan in f32, as in the JAX package), which are
     only timed.  The reddit runs print the peak host RSS and device memory.
     After the reddit GCN run, on its graph: the segment layout, and K8 (d=16,
     602, and 32 and 41 weighted) and K9 (d=32 and 41, one matrix and two)
     against their plain versions at the main path's shapes, each timed
     beside its bound;
 12. every kernel and its plain version timed with CUDA events (K1-K4, K8
     and K9 at the pubmed shapes, K5-K7 at DD's), each beside its bound
     (``csr_bound``: the function's own operands, a CSR adjacency's indices
     and pointers and the dense inputs and outputs, over 3.35 TB/s, or its
     f32 operations over 67 TFLOP/s, whichever is larger; the same for every
     kernel) and the one PyTorch call that computes the same function, where
     there is one: ``torch.sparse.mm`` on a CSR tensor (K1, K5, K8),
     ``torch.sparse.sampled_addmm`` (K4, K9).  Yardsticks only: nothing on
     the main path calls them;
 13. the distributed dense-tile route (``tcgnn_tpu_torch.parallel``), every
     shard of the mesh on this one card: on pubmed balanced over a 4x2 mesh
     (512x128), each shard's split stream: K10 (d in {32, 16, 8}: the
     check's width and the main path's feature-shard widths), K4's tile
     mode and K3 with its window-side overrides (d=32) against their plain
     versions, f32 and bf16; then the path through the trainer, 20 timed
     epochs each, ``--no_dropout``: pubmed GCN hidden 16 on ``--mesh 4x2``
     (K1), AGNN hidden 32 on ``--mesh 4x2`` (K4 tiles and K10) and on
     ``--mesh 8x1`` (K2/K3), each with the split stream in both directions,
     a finite falling loss, its kernels and no others, no plain version, and
     a first loss within ``rtol=1e-4`` of the single-device run's (the same
     model: ``init_distributed_net`` zero-pads the single-device draws);
     K10 timed at d=16 on the heaviest shard beside its bound (``csr_bound``
     over the shard's edges, one f32 score read an edge) and
     ``torch.sparse.mm`` over the shard's CSR with the scores as values.

Every phase prints its elapsed seconds.  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Nothing of JAX is imported.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import json
import math
import os
import resource
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
    sddmm_tc_tiles,
    sddmm_tc_tiles_torch,
    spmm_fused,
    spmm_fused_torch,
    bd_scatter_weights,
    bd_sfused,
    bd_sfused_bwd,
    bd_sfused_bwd_torch,
    bd_sfused_torch,
    build_a_tiles,
    build_bd_pack,
    reset_counts,
    sddmm_tc,
    sddmm_tc_dense,
    sddmm_tc_dense_torch,
    sddmm_tc_torch,
    spmm_sfused,
    spmm_sfused_bwd,
    spmm_sfused_bwd_torch,
    spmm_sfused_torch,
    spmm_block_diag,
    spmm_block_diag_torch,
    spmm_tc,
    spmm_tc_dense,
    spmm_tc_dense_torch,
    spmm_tc_torch,
)
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.parallel import distributed_graph_from_dataset, make_mesh
from tcgnn_tpu_torch.sgt.blockdiag import extract_block_diag
from tcgnn_tpu_torch.sgt.stream import segment_chunks
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
CHUNK_GEOMETRIES = {"512x128": (512, 128, 128), "16x8": (16, 8, 32)}
TIMING_RUNS = 25
KERNEL_SOURCES = ("spmm_dense", "spmm_sfused", "sddmm_dense", "spmm_bd", "chunk")
# name, source, TPU kernel it replaces, wrappers that launch it
KERNELS = {
    "K1": ("spmm_dense (K1)", "spmm_dense", "tcgnn_tpu/ops/spmm.py:249", (spmm_tc_dense,)),
    "K2": ("spmm_sfused (K2)", "spmm_sfused", "tcgnn_tpu/ops/spmm.py:1335", (spmm_sfused,)),
    "K3": ("spmm_sfused_bwd (K3)", "spmm_sfused", "tcgnn_tpu/ops/spmm.py:1487",
           (spmm_sfused_bwd,)),
    "K4": ("sddmm_dense (K4)", "sddmm_dense", "tcgnn_tpu/ops/sddmm.py:264",
           (sddmm_tc_dense, sddmm_tc_tiles)),
    "K5": ("spmm_bd (K5)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:813", (spmm_block_diag,)),
    "K6": ("bd_sfused (K6)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:928", (bd_sfused,)),
    "K7": ("bd_sfused_bwd (K7)", "spmm_bd", "tcgnn_tpu/ops/spmm.py:1094", (bd_sfused_bwd,)),
    "K8": ("spmm_chunk (K8)", "chunk", "tcgnn_tpu/ops/spmm.py:82", (spmm_tc,)),
    "K9": ("sddmm_chunk (K9)", "chunk", "tcgnn_tpu/ops/sddmm.py:44", (sddmm_tc,)),
    "K10": ("spmm_fused (K10)", "spmm_dense", "tcgnn_tpu/ops/spmm.py:1229", (spmm_fused,)),
}
# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): memory rate and
# f32 rate outside the tensor cores (every kernel here multiplies in f32 on
# the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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
    n = meta.num_rows
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


# ---- the chunk and streamed routes -----------------------------------------

def chunk_layouts(ds, dev):
    """pubmed's chunk layout at each chunk geometry, flat and cut into window
    segments by small budgets: name -> meta."""
    layouts = {}
    for geo, (bh, bw, ec) in CHUNK_GEOMETRIES.items():
        host = sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                      TileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec),
                                      emit_chunks=True)
        # Budgets of half the graph: the hub's window fits, and the graph
        # takes a few segments.
        segs = segment_chunks(host, max_chunks=host.num_chunks // 2,
                              max_slab_rows=host.num_blocks * bw // 2)
        if segs.num_segments < 2:
            raise AssertionError(f"pubmed {geo}: expected several segments")
        print(f"pubmed {geo} chunks: {host.num_chunks} chunks of {ec} slots, "
              f"{segs.num_segments} segments of {segs.wseg} windows, C_max {segs.seg_r.shape[1]}")
        layouts[f"{geo} flat"] = host.to_chunks(dev)
        layouts[f"{geo} segments"] = segs.to(dev)
    return layouts


def phase_chunk_kernels(ds, dev) -> dict:
    """Phase 9: K8 and K9 on pubmed's chunk layouts against their plain
    versions and the f64 CSR oracles (K8 at d=41 too: AGNN's class width on
    reddit).  Both store f32 under bf16 too, so
    every comparison takes the f32 tolerance.  Returns, per kernel, the f32
    max abs error of each case against the plain version."""
    errs = {"K8": {}, "K9": {}}
    csr = Csr(ds.row_pointers, ds.column_index, dev)
    n, e = ds.num_nodes, ds.num_edges
    for name, meta in chunk_layouts(ds, dev).items():
        for dtype in (torch.float32, torch.bfloat16):
            m, dt = with_dtype(meta, dtype), str(dtype)[6:]
            for d in (16, 41, 500):
                x = randn((n, d), 110 + d, dev)
                for w in (None, randn((e,), 111, dev)):
                    tag = f"K8 {name} d={d} {dt}{'' if w is None else ' weighted'}"
                    x64 = x.to(dtype).double()
                    w64 = None if w is None else w.to(dtype).double()
                    mag = spmm_ref(x64.abs(), csr.ptr, csr.idx, None if w is None else w64.abs())
                    got = spmm_tc(x, m, w)
                    if got.dtype != torch.float32:
                        raise AssertionError(f"{tag}: stored {got.dtype}, expected float32")
                    err = compare(f"{tag} vs plain", got, spmm_tc_torch(x, m, w), mag, F32_TOL)
                    compare(f"{tag} vs CSR oracle (f64)", got,
                            spmm_ref(x64, csr.ptr, csr.idx, w64), mag, F32_TOL)
                    if dtype == torch.float32:
                        errs["K8"][tag] = err
            for d in (32, 3):
                xa, xb = randn((n, d), 120 + d, dev), randn((n, d), 121 + d, dev)
                for two in (False, True):
                    tag = f"K9 {name} d={d} {dt} {'two matrices' if two else 'one matrix'}"
                    a64 = xa.to(dtype).double()
                    b64 = xb.to(dtype).double() if two else a64
                    got = sddmm_tc(xa, m, xb if two else None)
                    mag = sddmm_ref(a64.abs(), csr.ptr, csr.idx, b64.abs())
                    err = compare(f"{tag} vs plain", got,
                                  sddmm_tc_torch(xa, m, xb if two else None), mag, F32_TOL)
                    compare(f"{tag} vs CSR oracle (f64)", got,
                            sddmm_ref(a64, csr.ptr, csr.idx, b64), mag, F32_TOL)
                    if dtype == torch.float32:
                        errs["K9"][tag] = err
    return errs


def phase_chunk_autograd(dev) -> None:
    """Phase 10: ``spmm``, ``spmm_weighted`` and ``sddmm`` on the streamed
    route (K8 forward and over the transpose's segments, K9), forward and
    backward, against f64 oracle autograd, on the asymmetric graph."""
    n, rp, ci = asymmetric_graph()
    csr = Csr(rp, ci, dev)
    t_ptr, t_idx, _ = transpose_csr(rp, ci, n)
    csr_t = Csr(t_ptr, t_idx, dev)
    for geo, (bh, bw, ec) in CHUNK_GEOMETRIES.items():
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec), device=dev,
                       dense_tiles=False, streamed=True)
        if g.dense_tiles or not g.streamed or g.symmetric or g.agnn_aggregate is not None:
            raise AssertionError(f"asymmetric {geo}: expected the streamed route, no fused AGNN")
        x, dy = randn((n, 24), 130, dev), randn((n, 24), 131, dev)
        xl = x.clone().requires_grad_(True)
        out = g.spmm(xl)
        (out * dy).sum().backward()
        compare(f"streamed spmm {geo} forward vs oracle (f64)", out.detach(), csr.oracle(x),
                csr.magnitude(x), F32_TOL)
        compare(f"streamed spmm {geo} grad vs oracle of A^T (f64)", xl.grad, csr_t.oracle(dy),
                csr_t.magnitude(dy), F32_TOL)
        check_weighted_autograd(f"streamed {geo}", g, csr, dev)


def check_reddit_kernels(g, dev, card) -> dict:
    """Phase 11, after the reddit GCN run, on that run's graph: K8 and K9 on
    the streamed route's segments (each direction) at the main path's
    shapes, against their plain versions (the tolerance's magnitude is the
    plain version over absolute values: an f64 oracle would need [E, d]).
    K8: d=16 (GCN's layer 2), d=602 (the hoisted layer-1 aggregate), d=32
    and 41 weighted (AGNN's hidden and class widths); K9 at d=32 and 41 with
    one matrix and two.  Prints the segment layout, and each shape's kernel
    time beside its bound.  Returns, per kernel, the max abs error of each
    case."""
    errs = {"K8": {}, "K9": {}}
    n, e = g.num_nodes, g.num_edges
    layouts = {"A": g.chunks} if g.chunks_t is g.chunks else {"A": g.chunks, "A^T": g.chunks_t}
    w = randn((e,), 140, dev)
    for name, m in layouts.items():
        stacked = nbytes(m.seg_col_ids, m.seg_r, m.seg_c, m.seg_edge_id, m.seg_block,
                         m.seg_window, m.seg_chunks)
        print(f"reddit {name}: {m.num_segments} segments of {m.wseg} windows, C_max "
              f"{m.max_chunks}, {m.num_real_chunks} real chunks; chunk metadata "
              f"{stacked / 1e6:.1f} MB stacked")
        if name == "A":
            # What the flat layout (to_chunks) would upload: the real
            # chunks' slots, block and window ids, the TC blocks' col_ids.
            flat = (4 * m.num_real_chunks * (3 * m.config.edge_chunk + 2)
                    + 4 * g.tc_blocks * m.config.blk_w)
            print(f"  the flat layout's: {flat / 1e6:.1f} MB")
        for d, wd in ((16, None), (602, None), (32, w), (41, w)):
            x = randn((n, d), 141 + d, dev)
            tag = f"K8 reddit {name} d={d}{'' if wd is None else ' weighted'}"
            mag = spmm_tc_torch(x.abs(), m, None if wd is None else wd.abs())
            errs["K8"][tag] = compare(f"{tag} vs plain", spmm_tc(x, m, wd),
                                      spmm_tc_torch(x, m, wd), mag, F32_TOL)
            del mag
            ms = median_ms(lambda: spmm_tc(x, m, wd), runs=5)
            b = csr_bound(e, n, 2 * nbytes(x), 2 * e * d, weighted=wd is not None)
            print(f"  time {tag}: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) "
                  f"(median of 5, CUDA events; card: {card})")
        for d in (32, 41):
            xa, xb = randn((n, d), 150 + d, dev), randn((n, d), 151 + d, dev)
            for two in (False, True):
                tag = f"K9 reddit {name} d={d} {'two matrices' if two else 'one matrix'}"
                other = xb if two else None
                mag = sddmm_tc_torch(xa.abs(), m, None if other is None else other.abs())
                errs["K9"][tag] = compare(f"{tag} vs plain", sddmm_tc(xa, m, other),
                                          sddmm_tc_torch(xa, m, other), mag, F32_TOL)
                del mag
                ms = median_ms(lambda: sddmm_tc(xa, m, other), runs=5)
                b = csr_bound(e, n, nbytes(xa) * (2 if two else 1) + 4 * e, 2 * e * d)
                print(f"  time {tag}: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) "
                      f"(median of 5, CUDA events; card: {card})")
    return errs


def write_dataset(directory, name, graph) -> str:
    """A graph as the trainer's ``.npz`` format, with random labels of 4
    classes."""
    n, rp, ci = graph()
    rows = np.repeat(np.arange(n), np.diff(rp))
    y = np.random.default_rng(12).integers(0, 4, n).astype(np.int32)
    np.savez(os.path.join(directory, f"{name}.npz"), src_li=rows, dst_li=ci, num_nodes=n, y=y)
    return name


def phase_train(data_dir, dev, card) -> tuple[list, dict, dict]:
    """Phase 11: the main path, through the trainer's entry point.  Every
    count is set to 0 just before each run and read just after it; returns
    the runs, each kernel's launches summed over them, and the errors of
    ``check_reddit_kernels``, run on the reddit GCN run's graph once its
    counts are read."""
    asym = write_dataset(data_dir, "asymmetric", asymmetric_graph)
    banded = write_dataset(data_dir, "banded", banded_graph)
    pubmed = ["--dataset", "pubmed", "--dim", "500", "--classes", "3"]
    dd = ["--dataset", "DD", "--dim", "89", "--classes", "2"]
    reddit = ["--dataset", "reddit", "--dim", "602", "--classes", "41"]
    agnn = ["--model", "agnn", "--hidden", "32"]
    condensed, bd, streamed = (True, False, False), (True, False, True), (False, True, False)
    # label, arguments, kernels the run must launch, loss must fall, route
    # (dense_tiles, streamed, block_diag), TC blocks (None: not checked);
    # every other kernel of K1-K10 must not launch
    runs = [
        ("gcn --no_hoist", [*pubmed, "--model", "gcn", "--no_hoist"], ("K1",), True, condensed,
         334),
        ("gcn", [*pubmed, "--model", "gcn"], ("K1",), True, condensed, 334),
        ("gin", [*pubmed, "--model", "gin"], ("K1",), True, condensed, 334),
        ("agnn 2 layers", [*pubmed, *agnn, "--num_layers", "2"], ("K2", "K3"), True, condensed,
         334),
        ("agnn 4 layers", [*pubmed, *agnn, "--num_layers", "4"], ("K2", "K3"), False, condensed,
         334),
        ("agnn 2 layers, asymmetric graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", asym, "--dim", "64"],
         ("K1", "K4"), True, condensed, None),
        ("DD gcn --no_hoist", [*dd, "--model", "gcn", "--no_hoist"], ("K5", "K1"), True, bd,
         None),
        ("DD gcn", [*dd, "--model", "gcn"], ("K5", "K1"), True, bd, None),
        ("DD gin", [*dd, "--model", "gin"], ("K5", "K1"), True, bd, None),
        ("DD agnn 2 layers", [*dd, *agnn, "--num_layers", "2"], ("K6", "K7", "K2", "K3"), True,
         bd, None),
        ("DD agnn 4 layers", [*dd, *agnn, "--num_layers", "4"], ("K6", "K7", "K2", "K3"), False,
         bd, None),
        ("DD gcn --reorder rcm", [*dd, "--model", "gcn", "--reorder", "rcm"], ("K5", "K1"),
         True, bd, None),
        ("Yeast gcn", ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn"],
         ("K5",), True, bd, None),
        ("agnn 2 layers, banded graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", banded, "--dim", "64"],
         ("K5", "K4", "K1"), True, bd, None),
        ("reddit gcn", [*reddit, "--model", "gcn"], ("K8",), True, streamed, 265_565),
        ("reddit agnn 2 layers", [*reddit, *agnn, "--num_layers", "2"], ("K8", "K9"), True,
         streamed, 265_565),
    ]
    results, launches, reddit_errs = [], {k: 0 for k in KERNELS}, {}
    for label, extra, expected, must_fall, route, tc_blocks in runs:
        print(f"--- train.main {' '.join(extra)}")
        t0 = time.perf_counter()
        args = ["--device", "cuda", "--epochs", "20", *extra]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        r = train.main(args)
        counts = {k: (sum(w.launches for w in ws), sum(w.plain_calls for w in ws))
                  for k, (_, _, _, ws) in KERNELS.items()}
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        r["peak_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        r["seconds"] = time.perf_counter() - t0
        print(f"  route {(r['dense_tiles'], r['streamed'], r['block_diag'])}  first loss "
              f"{r['first_loss']:.6f}  final loss {r['final_loss']:.6f}  "
              + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}" for k, c in counts.items()))
        if must_fall and not (math.isfinite(r["final_loss"])
                              and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall "
                                 f"({r['first_loss']} -> {r['final_loss']})")
        if (any(counts[k][0] <= 0 for k in expected)
                or any(c[0] for k, c in counts.items() if k not in expected)
                or any(c[1] for c in counts.values())):
            raise AssertionError(f"{label}: expected launches of {expected} and no other "
                                 f"kernel, no plain calls; got {counts}")
        if (r["dense_tiles"], r["streamed"], r["block_diag"]) != route:
            raise AssertionError(f"{label}: route {(r['dense_tiles'], r['streamed'], r['block_diag'])}"
                                 f", expected {route}")
        if tc_blocks is not None and r["tc_blocks"] != tc_blocks:
            raise AssertionError(f"{label}: {r['tc_blocks']} TC blocks, expected {tc_blocks}")
        for k, c in counts.items():
            launches[k] += c[0]
        graph = r.pop("graph")
        if label == "reddit gcn":
            t1 = time.perf_counter()
            reddit_errs = check_reddit_kernels(graph, dev, card)
            print(f"  reddit kernel checks done in {time.perf_counter() - t1:.1f} s")
        del graph
        results.append((label, r))
        torch.cuda.empty_cache()
    return results, launches, reddit_errs


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops) -> tuple[float, str]:
    """The least time the card could take (ms): each input read once and
    each output written once at the memory rate, or the f32 operations at
    the f32 rate, whichever is larger, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bound(nnz, n, dense_bytes, flops, weighted=False) -> tuple[float, str]:
    """``bound`` for a function over a CSR adjacency of ``nnz`` edges on
    ``n`` rows: what it must read of the graph is the int32 column indices,
    the n+1 int32 row pointers and, weighted, an f32 weight an edge; the
    dense operands read once and outputs written once are ``dense_bytes``.
    The same for every kernel, whatever layout it reads."""
    return bound(4 * nnz + 4 * (n + 1) + (4 * nnz if weighted else 0) + dense_bytes, flops)


def csr_tensor(ptr, idx, n, dev) -> torch.Tensor:
    """A float CSR adjacency (ones) on the card, for the library yardsticks."""
    ptr = torch.as_tensor(np.asarray(ptr), dtype=torch.int64)
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    vals = torch.ones(idx.numel(), dtype=torch.float32)
    return torch.sparse_csr_tensor(ptr, idx, vals, size=(n, n)).to(dev)


def record(kt, pt, b, lib_ms) -> dict:
    return {"ms": kt, "plain_ms": pt, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms}


def phase_timing(ds, dev) -> tuple[dict, dict]:
    """Phase 12: each kernel and its plain version at the pubmed shapes
    (f32): K1 at d=16 and 500 (GCN's layer-2 and hoisted layer-1
    aggregates), K2-K4 at d=32 and 3 (AGNN's hidden and class widths), K8 on
    the flat chunk layout at d=16 and 500, K9 at d=32 and 3.  Returns the
    times, and for the reported shape of each kernel (512x128, d=16 for the
    SpMMs, 32 for the others) its record with bound and library time."""
    times, records = {}, {}
    n, e = ds.num_nodes, ds.num_edges
    a_csr = csr_tensor(ds.row_pointers, ds.column_index, n, dev)
    for geo, (bh, bw) in GEOMETRIES.items():
        g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                       TileConfig(blk_h=bh, blk_w=bw), device=dev)
        m, a = g.meta, g.a_struct
        for d in (16, 500):
            x = randn((ds.num_nodes, d), 100 + d, dev)
            times[("K1", geo, d)] = timed_pair(lambda: spmm_tc_dense(x, m, a),
                                               lambda: spmm_tc_dense_torch(x, m, a))
            if geo == "512x128" and d == 16:
                records["K1"] = record(*times[("K1", geo, d)],
                                       csr_bound(e, n, 2 * nbytes(x), 2 * e * d),
                                       median_ms(lambda: torch.sparse.mm(a_csr, x)))
        for d in (32, 3):
            x, dy = randn((ds.num_nodes, d), 200 + d, dev) * 0.3, randn((ds.num_nodes, d), 300, dev)
            times[("K2", geo, d)] = timed_pair(lambda: spmm_sfused(x, x, x, m, a),
                                               lambda: spmm_sfused_torch(x, x, x, m, a))
            times[("K3", geo, d)] = timed_pair(lambda: spmm_sfused_bwd(x, dy, m, a),
                                               lambda: spmm_sfused_bwd_torch(x, dy, m, a))
            times[("K4", geo, d)] = timed_pair(lambda: sddmm_tc_dense(x, m, x),
                                               lambda: sddmm_tc_dense_torch(x, m, x))
            if geo == "512x128" and d == 32:
                xt = x.t().contiguous()
                records["K2"] = record(*times[("K2", geo, d)],
                                       csr_bound(e, n, 2 * nbytes(x), 4 * e * d), None)
                records["K3"] = record(*times[("K3", geo, d)],
                                       csr_bound(e, n, 4 * nbytes(x), 12 * e * d), None)
                records["K4"] = record(
                    *times[("K4", geo, d)],
                    csr_bound(e, n, nbytes(x) + 4 * e, 2 * e * d),
                    median_ms(lambda: torch.sparse.sampled_addmm(a_csr, x, xt, beta=0.0)))
    for geo, (bh, bw, ec) in CHUNK_GEOMETRIES.items():
        host = sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                      TileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec),
                                      emit_chunks=True)
        m = host.to_chunks(dev)
        for d in (16, 500):
            x = randn((ds.num_nodes, d), 700 + d, dev)
            times[("K8", geo, d)] = timed_pair(lambda: spmm_tc(x, m), lambda: spmm_tc_torch(x, m))
            if geo == "512x128" and d == 16:
                records["K8"] = record(*times[("K8", geo, d)],
                                       csr_bound(e, n, 2 * nbytes(x), 2 * e * d),
                                       median_ms(lambda: torch.sparse.mm(a_csr, x)))
        for d in (32, 3):
            x = randn((ds.num_nodes, d), 800 + d, dev)
            times[("K9", geo, d)] = timed_pair(lambda: sddmm_tc(x, m), lambda: sddmm_tc_torch(x, m))
            if geo == "512x128" and d == 32:
                xt = x.t().contiguous()
                records["K9"] = record(
                    *times[("K9", geo, d)], csr_bound(e, n, nbytes(x) + 4 * e, 2 * e * d),
                    median_ms(lambda: torch.sparse.sampled_addmm(a_csr, x, xt, beta=0.0)))
    return times, records


def phase_bd_timing(dd, dev) -> tuple[dict, dict]:
    """Phase 12, BD part: K5 at DD's d=2, 16 and 89 (a hoisted GCN epoch's
    width, GCN's hidden and input widths), K6 and K7 at d=32 and 2 (AGNN's
    hidden and class widths), f32, against their plain versions; records at
    d=16 (K5) and 32 (K6, K7)."""
    times, records = {}, {}
    g = TiledGraph(dd.row_pointers, dd.column_index, dd.num_nodes, TileConfig(), device=dev)
    p, offs, cfg, n = g.bd.pack, g.bd_offsets, TileConfig(), dd.num_nodes
    cov = covered_csr(dd.row_pointers, dd.column_index,
                      extract_block_diag(dd.row_pointers, dd.column_index, n), dev)
    nnz = cov.idx.numel()  # the covered edges: the work K5-K7 do
    cov_csr = csr_tensor(cov.ptr.cpu(), cov.idx.cpu(), n, dev)
    for d in (2, 16, 89):
        x = randn((n, d), 400 + d, dev)
        times[("K5", "DD", d)] = timed_pair(
            lambda: spmm_block_diag(x, p, offsets=offs, cfg=cfg),
            lambda: spmm_block_diag_torch(x, p, offsets=offs, cfg=cfg))
        if d == 16:
            records["K5"] = record(*times[("K5", "DD", d)],
                                   csr_bound(nnz, n, 2 * nbytes(x), 2 * nnz * d),
                                   median_ms(lambda: torch.sparse.mm(cov_csr, x)))
    for d in (32, 2):
        x, dy = randn((n, d), 500 + d, dev) * 0.3, randn((n, d), 600, dev)
        times[("K6", "DD", d)] = timed_pair(
            lambda: bd_sfused(x, x, x, p, offsets=offs, cfg=cfg),
            lambda: bd_sfused_torch(x, x, x, p, offsets=offs, cfg=cfg))
        times[("K7", "DD", d)] = timed_pair(
            lambda: bd_sfused_bwd(x, dy, p, offsets=offs, cfg=cfg),
            lambda: bd_sfused_bwd_torch(x, dy, p, offsets=offs, cfg=cfg))
        if d == 32:
            records["K6"] = record(*times[("K6", "DD", d)],
                                   csr_bound(nnz, n, 2 * nbytes(x), 4 * nnz * d), None)
            records["K7"] = record(*times[("K7", "DD", d)],
                                   csr_bound(nnz, n, 4 * nbytes(x), 12 * nnz * d), None)
    return times, records


# ---- the distributed dense-tile route ----------------------------------------

# One bf16 unit: K4's tile mode rounds each score once.
BF16_TILE_TOL = dict(rtol=8e-3, atol=1e-4)
# A mesh run's first loss (no dropout) against the single-device run's: the
# same model, summed in another order.
FIRST_LOSS_RTOL = 1e-4
K10_ROUNDS = 3


def mesh_graph(ds, mesh, dev):
    """pubmed balanced over ``mesh`` on the card, as the trainer builds it
    (on a copy: the balance permutes the dataset)."""
    return distributed_graph_from_dataset(copy.deepcopy(ds), make_mesh(*mesh, dev),
                                          TileConfig(block_group=1))


def phase_mesh_kernels(ds, dev, card) -> tuple[dict, dict]:
    """Phase 13, kernels: K10, K4's tile mode and K3 with its window-side
    overrides on each split-stream shard of pubmed over 4x2, against their
    plain versions (magnitude: the plain version on absolute values), f32
    and bf16; then K10 timed.  Returns the f32 errors per kernel and K10's
    record."""
    errs = {"K10": {}, "K4": {}, "K3": {}}
    g = mesh_graph(ds, (4, 2), dev)
    sp = g._fwd.split
    if sp is None or g.host_bwd.split is None:
        raise AssertionError("pubmed 4x2: expected the split stream in both directions")
    print(f"pubmed 4x2: {g.route}; split stream {sp.streams[0].meta.num_blocks} blocks a shard "
          f"(unsplit {g._fwd.streams[0].meta.num_blocks}), guest_cap {sp.guest_cap}, "
          f"pair_cap {sp.pair_cap}, halo rows {g.host_fwd.halo['halo_rows']}")
    for i, st in enumerate(sp.streams):
        a = st.tiles
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            m, dt = with_dtype(st.meta, dtype), str(dtype)[6:]
            f32 = dtype == torch.float32
            for d in (32, 16, 8):
                tag = f"pubmed 4x2 shard {i} d={d} {dt}"
                xw = randn((m.num_rows, d), 900 + d, dev) * 0.3
                x = randn((m.num_src, d), 901 + d, dev) * 0.3
                s = sddmm_tc_tiles(xw, m, x)
                err = compare(f"K4 tile mode {tag} vs plain", s.float(),
                              sddmm_tc_tiles_torch(xw, m, x).float(),
                              sddmm_tc_tiles_torch(xw.abs(), m, x.abs(), torch.float32),
                              F32_TOL if f32 else BF16_TILE_TOL)
                if f32:
                    errs["K4"][f"tiles {tag}"] = err
                err = compare(f"K10 {tag} vs plain", spmm_fused(x, m, a, s),
                              spmm_fused_torch(x, m, a, s),
                              spmm_fused_torch(x.abs(), m, a, s.abs()), tol)
                if f32:
                    errs["K10"][tag] = err
            d, tag = 32, f"pubmed 4x2 shard {i} d=32 {dt}"
            x, dy = randn((m.num_src, d), 910, dev) * 0.3, randn((m.num_src, d), 911, dev) * 0.3
            xw, dyw = randn((m.num_rows, d), 912, dev) * 0.3, randn((m.num_rows, d), 913, dev) * 0.3
            got = spmm_sfused_bwd(x, dy, m, a, xw=xw, dyw=dyw)
            want = spmm_sfused_bwd_torch(x, dy, m, a, xw, dyw)
            mags = spmm_sfused_bwd_torch(x.abs(), dy.abs(), m, a, xw.abs(), dyw.abs())
            err = max(compare(f"K3 with xw/dyw {tag} {what} vs plain", p, q, r, tol)
                      for what, p, q, r in zip(("dx3", "u"), got, want, mags))
            if f32:
                errs["K3"][f"overrides {tag}"] = err

    # K10 timed at the main path's feature-shard width (hidden 32 over 2
    # feature shards) on the heaviest shard's split stream.
    st = max(sp.streams, key=lambda t: t.meta.num_edges)
    m, a, d = st.meta, st.tiles, 16
    x = randn((m.num_src, d), 920, dev)
    s = sddmm_tc_tiles(randn((m.num_rows, d), 921, dev), m, x)
    # Three rounds of the pair, to tell the order of kernel and plain
    # version apart from the spread of one round; the record is their median.
    rounds = [timed_pair(lambda: spmm_fused(x, m, a, s), lambda: spmm_fused_torch(x, m, a, s))
              for _ in range(K10_ROUNDS)]
    kt = statistics.median(r[0] for r in rounds)
    pt = statistics.median(r[1] for r in rounds)
    pos = m.edge_pos.long()
    a_csr = torch.sparse_coo_tensor(
        torch.stack([m.edge_rows.long(), m.edge_cols.long()]), s.view(-1)[pos].float(),
        (m.num_rows, m.num_src)).coalesce().to_sparse_csr()
    compare("torch.sparse.mm yardstick vs K10's plain version", torch.sparse.mm(a_csr, x),
            spmm_fused_torch(x, m, a, s), spmm_fused_torch(x.abs(), m, a, s.abs()), F32_TOL)
    lib = median_ms(lambda: torch.sparse.mm(a_csr, x))
    b = csr_bound(m.num_edges, m.num_rows, nbytes(x) + 4 * m.num_rows * d, 2 * m.num_edges * d,
                  weighted=True)
    print(f"  time K10 pubmed 4x2 heaviest shard ({m.num_edges} edges, {m.num_blocks} blocks) "
          f"d={d}: kernel {kt:.4f} ms, plain {pt:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}) (median of {K10_ROUNDS} rounds of {TIMING_RUNS}, CUDA "
          f"events; card: {card}; one card held all 8 shards); rounds (kernel, plain): "
          + ", ".join(f"({k:.4f}, {p:.4f})" for k, p in rounds))
    return errs, record(kt, pt, b, lib)


def phase_mesh_train(dev, card) -> tuple[list, dict]:
    """Phase 13, the path: the trainer on pubmed over 4x2 and 8x1 meshes.
    Every count is set to 0 just before each mesh run and read just after;
    the single-device run that its first loss is held to runs afterwards.
    Returns the runs and each kernel's launches summed over them."""
    pubmed = ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--no_dropout"]
    agnn = ["--model", "agnn", "--hidden", "32", "--num_layers", "2"]
    runs = [  # label, model arguments, mesh, kernels the run must launch
        ("mesh 4x2 gcn", ["--model", "gcn", "--hidden", "16", "--num_layers", "2"], "4x2",
         ("K1",)),
        ("mesh 4x2 agnn", agnn, "4x2", ("K4", "K10")),
        ("mesh 8x1 agnn", agnn, "8x1", ("K2", "K3")),
    ]
    results, launches = [], {k: 0 for k in KERNELS}
    for label, model, mesh, expected in runs:
        extra = [*pubmed, *model, "--mesh", mesh]
        print(f"--- train.main {' '.join(extra)}")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        r = train.main(["--device", "cuda", "--epochs", "20", *extra])
        counts = {k: (sum(w.launches for w in ws), sum(w.plain_calls for w in ws))
                  for k, (_, _, _, ws) in KERNELS.items()}
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        r["seconds"] = time.perf_counter() - t0
        print(f"  {r['route']}  first loss {r['first_loss']:.6f}  final loss "
              f"{r['final_loss']:.6f}  "
              + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}" for k, c in counts.items()))
        if not (math.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall ({r['first_loss']} -> "
                                 f"{r['final_loss']})")
        if (any(counts[k][0] <= 0 for k in expected)
                or any(c[0] for k, c in counts.items() if k not in expected)
                or any(c[1] for c in counts.values())):
            raise AssertionError(f"{label}: expected launches of {expected} and no other "
                                 f"kernel, no plain calls; got {counts}")
        if r["split"] != (True, True) or r["tc_blocks"] != 334:
            raise AssertionError(f"{label}: split {r['split']}, {r['tc_blocks']} TC blocks; "
                                 "expected the split stream both ways and 334")
        for k, c in counts.items():
            launches[k] += c[0]
        del r["graph"]
        single = train.main(["--device", "cuda", "--epochs", "1", *pubmed, *model])
        rel = abs(r["first_loss"] - single["first_loss"]) / abs(single["first_loss"])
        print(f"  first loss {r['first_loss']:.6f} vs one device {single['first_loss']:.6f}: "
              f"relative difference {rel:.3e} (rtol {FIRST_LOSS_RTOL})")
        if not rel <= FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first loss {r['first_loss']} vs one device "
                                 f"{single['first_loss']}")
        del single["graph"]
        results.append((label, r))
        torch.cuda.empty_cache()
    return results, launches


def build_kernels():
    """One nvcc per source, all started together; prints ``-Xptxas -v``."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(lambda name: _kernels.build(name, verbose=True), KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        _kernels.load(name)
    print(f"K1-K10 build (nvcc, sm_90a, {len(KERNEL_SOURCES)} sources at once): "
          f"{time.perf_counter() - t0:.2f} s")


def phase_start(name) -> float:
    print(f"=== phase {name}", flush=True)
    return time.perf_counter()


def phase_end(t0) -> None:
    print(f"=== phase done in {time.perf_counter() - t0:.1f} s", flush=True)


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

    # ---- 2. build K1-K10 ------------------------------------------------------
    t0 = phase_start("2. build")
    build_kernels()
    phase_end(t0)

    # ---- 3-6. K1-K4 against plain versions and oracles -----------------------
    t0 = phase_start("3-6. K1-K4")
    ds = synthesize("pubmed", seed=0)
    print(f"pubmed: N={ds.num_nodes} E={ds.num_edges} d={ds.num_features}")
    errs = {"K1": phase_compare(ds, dev)}
    errs["K1"].update(phase_transpose_and_autograd(dev))
    errs.update(phase_agnn_kernels(ds, dev))
    phase_agnn_autograd(ds, dev)
    torch.cuda.synchronize()
    phase_end(t0)

    # ---- 7-8. K5-K7 and the BD route against plain versions and oracles ------
    t0 = phase_start("7-8. K5-K7 and the BD route")
    dd = synthesize("DD", 89, 2)
    print(f"DD: N={dd.num_nodes} E={dd.num_edges} d={dd.num_features}")
    errs.update(phase_bd_kernels(dd, dev))
    phase_bd_autograd(dd, dev)
    torch.cuda.synchronize()
    phase_end(t0)

    # ---- 9-10. K8, K9 and the streamed route against plain versions and oracles
    t0 = phase_start("9-10. K8, K9 and the streamed route")
    errs.update(phase_chunk_kernels(ds, dev))
    phase_chunk_autograd(dev)
    torch.cuda.synchronize()
    phase_end(t0)

    # ---- 11. the main path --------------------------------------------------
    t0 = phase_start("11. the main path")
    with tempfile.TemporaryDirectory() as data_dir:
        runs, launches, reddit_errs = phase_train(data_dir, dev, card)
    for k, kernel_errs in reddit_errs.items():
        errs[k].update(kernel_errs)
    phase_end(t0)

    # ---- 12. timing ---------------------------------------------------------
    t0 = phase_start("12. timing")
    times, records = phase_timing(ds, dev)
    bd_times, bd_records = phase_bd_timing(dd, dev)
    times.update(bd_times)
    records.update(bd_records)
    torch.cuda.synchronize()
    phase_end(t0)

    # ---- 13. the distributed dense-tile route ---------------------------------
    t0 = phase_start("13. the distributed dense-tile route (every shard on this card)")
    mesh_errs, records["K10"] = phase_mesh_kernels(ds, dev, card)
    for k, kernel_errs in mesh_errs.items():
        errs.setdefault(k, {}).update(kernel_errs)
    mesh_runs, mesh_launches = phase_mesh_train(dev, card)
    for k, c in mesh_launches.items():
        launches[k] += c
    phase_end(t0)

    for (k, geo, d), (kt, pt) in times.items():
        print(f"  time {KERNELS[k][0]} {geo} d={d}: kernel {kt:.4f} ms, plain {pt:.4f} ms "
              f"(median of {TIMING_RUNS}, CUDA events; card: {card})")

    for name, r in runs:
        print(f"main path [{name}]: dense_tiles {r['dense_tiles']}  streamed {r['streamed']}  "
              f"block_diag {r['block_diag']}  TC_Blocks {r['tc_blocks']}  "
              f"Prep. (ms) {r['prep_ms']:.3f}  Prep host (ms) {r['prep_host_ms']:.3f}  "
              f"Train (ms) {r['train_ms']:.3f}  First loss {r['first_loss']:.6f}  "
              f"Final loss {r['final_loss']:.6f}  peak host RSS {r['peak_rss'] / 2**30:.2f} GiB  "
              f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB  "
              f"run {r['seconds']:.1f} s  (card: {card})")
    for name, r in mesh_runs:
        print(f"main path [{name}]: {r['route']}  TC_Blocks {r['tc_blocks']}  "
              f"Prep. (ms) {r['prep_ms']:.3f}  Train (ms) {r['train_ms']:.3f}  "
              f"First loss {r['first_loss']:.6f}  Final loss {r['final_loss']:.6f}  "
              f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB  "
              f"run {r['seconds']:.1f} s  (card: {card}; one card held all shards)")
    kernels = []
    for k, (name, source, replaces, _) in KERNELS.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tcgnn_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(errs[k].values()),
            **records[k],
        })
        print(f"  {name}: {records[k]['ms']:.4f} ms, plain {records[k]['plain_ms']:.4f}, bound "
              f"{records[k]['bound_ms']:.4f} ({records[k]['bound_by']}), library "
              f"{records[k]['library_ms']} (card: {card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
