#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tcgnn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

``python3 chip_smoke.py --ab DIR`` runs none of the phases below: it builds
another commit's ``spmm_bd.cu``, ``spmm_dense.cu``, ``chunk.cu``,
``spmm_sfused.cu`` and ``sddmm_dense.cu``, those of them DIR holds (with
the ``sparse_row.cuh`` they include), beside the tree's and times the
kernels of the two in turns through the tree's wrappers (K5, K6 and K7 on
DD; K1 and K10; K8 and K9 on pubmed and reddit; K2 and K3 on pubmed and
DD's residual; K4 on pubmed, the asymmetric and the banded graphs and in
its tile mode on a 4x2 shard) (``ab_main``).

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
  5. K2 and K3 over the tiles' row index (``sgt_row_index``, its nonzeros,
     bytes and build time printed), and K4, against their plain versions
     and f64 CSR oracles: pubmed at 512x128 and 16x8, d in {32, 3} (AGNN's
     hidden and class widths) and 200 (K2/K3's wide path), f32 and bf16,
     K2's value operand shared and separate; K4 on the asymmetric graph too;
  6. autograd of the AGNN ops, forward and backward, against f64 oracles:
     ``agnn_aggregate`` (K2/K3, gradient of the attention weights included)
     on pubmed, and the weighted SpMM and SDDMM (K1/K4) on the asymmetric
     graph;
  7. K5, K6 and K7 against their plain versions and the f64 oracles of the
     covered edges: DD's pack (301 MB) with K5 at d in {2, 16, 89} and over
     a weighted pack, K6 (every operand-sharing case) and K7 over the
     pack's row index at d in {32, 2}, and at 200 (the wide path; K6 with
     one operand and with three), f32 and bf16; K5 over Yeast's pack (659
     MB, fully covered) at d=2, over an int16 pack (a union graph with a
     duplicate count above 127) and over a banded graph's transpose pack;
     DD's residual (what DD's AGNN sends through K2/K3): its row index, K2
     and K3 at d in {32, 2, 200}, f32 and bf16, against the plain versions
     and the residual's f64 oracles, then timed at d=32 (event and device)
     beside the plain version and the bound;
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
 11. the main path through ``tcgnn_tpu_torch.train.main``, 21 timed epochs
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
     After the reddit GCN run, on its graph: the segment layout, its mean
     row run and the row index's bytes, and K8 (d=16, 602, and 32 and 41
     weighted) and K9 (d=32 and 41, one matrix and two) against their plain
     versions at the main path's shapes, each timed (event and device)
     beside its bound and ``torch.sparse.mm`` or
     ``torch.sparse.sampled_addmm`` over the row index;
 12. every kernel and its plain version timed with CUDA events (K1-K4, K8
     and K9 at the pubmed shapes, K2/K3 over the row index the graph builds,
     K4 also over the banded graph's 1.22 M edges at d=32 and 22, first
     held against its plain version and the f64 oracle, with its kernel
     time under torch.profiler, K5-K7 at DD's): the median of 25 event
     pairs around one call each (the wrapper's host work included), and the
     kernel's device time, one event pair around 25 back-to-back calls over
     25 (``device_ms``); each beside its bound
     (``csr_bound``: the function's own operands, a CSR adjacency's indices
     and pointers and the dense inputs and outputs, over 3.35 TB/s, or its
     f32 operations over 67 TFLOP/s, whichever is larger; the same for every
     kernel) and the one PyTorch call that computes the same function, where
     there is one: ``torch.sparse.mm`` on a CSR tensor (K1, K5, K8),
     ``torch.sparse.sampled_addmm`` (K4, K9).  Yardsticks only: nothing on
     the main path calls them.  The kernels line takes K8 and K9 from phase
     11's reddit timing (d=16 and d=32), the shapes of their main path;
 13. the distributed dense-tile route (``tcgnn_tpu_torch.parallel``), every
     shard of the mesh on this one card: on pubmed balanced over an 8x1
     mesh, each split stream's row index (built at upload) and K2/K3 over it
     with the window side apart (d in {32, 3, 200}); over a 4x2 mesh
     (512x128), each shard's split stream: K10 (d in {32, 16, 8}: the
     check's width and the main path's feature-shard widths), K4's tile
     mode and K2/K3 with the window side apart (d=32) against their plain
     versions, f32 and bf16; then the path through the trainer, 21 timed
     epochs each, ``--no_dropout``: pubmed GCN hidden 16 on ``--mesh 4x2``
     (K1), AGNN hidden 32 on ``--mesh 4x2`` (K4 tiles and K10) and on
     ``--mesh 8x1`` (K2/K3), each with the split stream in both directions,
     a finite falling loss, its kernels and no others, no plain version, and
     a first loss within ``rtol=1e-4`` of the single-device run's (the same
     model: ``init_distributed_net`` zero-pads the single-device draws);
     K4's tile mode timed at d=16 on the heaviest shard (event and device
     time, its kernel time and the tiles' zeroing apart under
     torch.profiler); K10 timed there (event and device time, in
     three rounds) beside its bound (``csr_bound``
     over the shard's edges, one f32 score read an edge) and
     ``torch.sparse.mm`` over the shard's CSR with the scores as values.

Every phase prints its elapsed seconds.  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Nothing of JAX is imported.
"""

from __future__ import annotations

import concurrent.futures
import copy
import ctypes
import dataclasses
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph, train
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.data.edge_graphs import asymmetric_graph, banded_graph, write_npz
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.ops import (
    EdgeList,
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
from tcgnn_tpu_torch.ops.blockdiag import bd_row_index
from tcgnn_tpu_torch.ops.reference import sddmm_ref, sfused_bwd_ref, sfused_ref, spmm_ref
from tcgnn_tpu_torch.ops.sfused import sgt_row_index
from tcgnn_tpu_torch.parallel import distributed_graph_from_dataset, make_mesh
from tcgnn_tpu_torch.profiling import device_ms as kernel_ms
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
# Timed epochs of a main-path run: with the trainer's 9 warm-up epochs, 30
# Adam updates, where the falling-loss check reads the final loss (dropout
# makes the huge early AGNN losses swing from one update to the next:
# pubmed's 2-layer AGNN reads above its first loss after 29).
TRAIN_EPOCHS = 21
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


def check_agnn_kernels(name, meta, tiles, index, csr, d, dev, errs, sddmm=True):
    """K2 (value operand shared and separate) and K3 over the tiles' row
    index ``index``, and K4 (``sddmm``), on one tiling at width d, f32 and
    bf16, against the plain versions and, in f32, the f64 CSR oracles (K4
    in bf16 too: its products are exact in f32)."""
    n = meta.num_rows
    ptr, idx = csr.ptr, csr.idx
    xl, xr, xv = (randn((n, d), 30 + i, dev) * 0.3 for i in range(3))
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        m, tag = with_dtype(meta, dtype), f"{name} d={d} {str(dtype)[6:]}"
        ab = [t.to(dtype).double() for t in (xl, xr, xv)]  # the compute-dtype operands
        for share in (True, False):
            v = xr if share else xv
            got = spmm_sfused(xl, xr, v, m, tiles, index=index)
            mag = sfused_ref(ab[0].abs(), ab[1].abs(), (ab[1] if share else ab[2]).abs(), ptr, idx)
            what = "shared" if share else "separate"
            err = compare(f"K2 {tag} xv {what} vs plain", got,
                          spmm_sfused_torch(xl, xr, v, m, tiles), mag, tol)
            if dtype == torch.float32:
                errs["K2"][f"{tag} {what}"] = err
                compare(f"K2 {tag} xv {what} vs CSR oracle (f64)", got,
                        sfused_ref(ab[0], ab[1], ab[1] if share else ab[2], ptr, idx), mag, tol)
        dx3, u = spmm_sfused_bwd(xl, xr, m, tiles, index=index)
        p_dx3, p_u = spmm_sfused_bwd_torch(xl, xr, m, tiles)
        mag_dx3, mag_u = sfused_bwd_ref(ab[0].abs(), ab[1].abs(), ptr, idx)
        err = max(compare(f"K3 {tag} dx3 vs plain", dx3, p_dx3, mag_dx3, tol),
                  compare(f"K3 {tag} u vs plain", u, p_u, mag_u, tol))
        if dtype == torch.float32:
            errs["K3"][tag] = err
            o_dx3, o_u = sfused_bwd_ref(ab[0], ab[1], ptr, idx)
            compare(f"K3 {tag} dx3 vs CSR oracle (f64)", dx3, o_dx3, mag_dx3, tol)
            compare(f"K3 {tag} u vs CSR oracle (f64)", u, o_u, mag_u, tol)
        if sddmm:
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


def timed_index(name, meta, tiles):
    """``sgt_row_index`` of the tiles, its build time and bytes printed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = sgt_row_index(meta, tiles)
    torch.cuda.synchronize()
    print(f"{name} row index: {index.nnz} nonzeros over {index.num_rows} rows, "
          f"{index.nbytes / 2**20:.3f} MiB (tiles {nbytes(tiles) / 2**20:.1f} MiB), built in "
          f"{time.perf_counter() - t0:.4f} s")
    return index


def phase_agnn_kernels(ds, dev) -> dict:
    """Phase 5 (d=200: K2/K3's wide path).  Returns, per kernel, the f32 max abs error of each case
    against the plain version."""
    errs = {"K2": {}, "K3": {}, "K4": {}}
    csr = Csr(ds.row_pointers, ds.column_index, dev)
    for geo, (bh, bw) in GEOMETRIES.items():
        host = sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                      TileConfig(blk_h=bh, blk_w=bw), build_tiles=True)
        meta, tiles = host.to(dev), torch.from_numpy(host.a_tiles).to(dev)
        index = timed_index(f"pubmed {geo}", meta, tiles)
        for d in (32, 3, 200):
            check_agnn_kernels(f"pubmed {geo}", meta, tiles, index, csr, d, dev, errs)
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


def check_bd_agnn_kernels(name, pack, offsets, index, csr, d, dev, errs, sharing=None):
    """K6 over the pack's row index ``index`` (the operand-sharing cases
    ``sharing``, all by default) and K7 at width d, f32 and bf16, against
    the plain versions and, in f32, the f64 oracles of the covered
    edges."""
    n = csr.ptr.shape[0] - 1
    ptr, idx = csr.ptr, csr.idx
    xl, xr, xv = (randn((n, d), 60 + i, dev) * 0.3 for i in range(3))
    cases = {"all one": (xl, xl, xl), "xl is xr": (xl, xl, xv), "xl is xv": (xl, xr, xl),
             "xv is xr": (xl, xr, xr), "separate": (xl, xr, xv)}
    cases = {k: v for k, v in cases.items() if sharing is None or k in sharing}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        cfg, tag = TileConfig(compute_dtype=dtype), f"{name} d={d} {str(dtype)[6:]}"
        ab = {id(t): t.to(dtype).double() for t in (xl, xr, xv)}  # compute-dtype operands
        for case, ops in cases.items():
            got = bd_sfused(*ops, pack, offsets=offsets, cfg=cfg, index=index)
            o64 = [ab[id(t)] for t in ops]
            mag = sfused_ref(*(t.abs() for t in o64), ptr, idx)
            err = compare(f"K6 {tag} {case} vs plain", got,
                          bd_sfused_torch(*ops, pack, offsets=offsets, cfg=cfg), mag, tol)
            if dtype == torch.float32:
                errs["K6"][f"{tag} {case}"] = err
                compare(f"K6 {tag} {case} vs CSR oracle (f64)", got, sfused_ref(*o64, ptr, idx),
                        mag, tol)
        dx3, u = bd_sfused_bwd(xl, xr, pack, offsets=offsets, cfg=cfg, index=index)
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


def check_residual_kernels(dd, m, dev, card, errs) -> None:
    """Phase 7, DD's residual (the edges the diagonals leave, which DD's
    AGNN sends through K2/K3): its tiles' row index, K2 and K3 over it at
    d in {32, 2} (AGNN's hidden and class widths) and 200 against their
    plain versions and the f64 oracles of the residual, f32 and bf16; then
    K2 and K3 at d=32, f32, timed (event and device) beside the plain
    version and the bound of the residual's edges."""
    n = dd.num_nodes
    host = sparse_graph_translate(m.res_ptr, m.res_idx, n, TileConfig(), build_tiles=True)
    meta, tiles = host.to(dev), torch.from_numpy(host.a_tiles).to(dev)
    print(f"DD residual: {len(m.res_idx)} edges, {host.num_real_blocks} TC blocks over "
          f"{host.num_windows} windows, tiles {nbytes(tiles) / 2**20:.1f} MiB")
    index = timed_index("DD residual", meta, tiles)
    res = Csr(m.res_ptr, m.res_idx, dev)
    errs.setdefault("K2", {})
    errs.setdefault("K3", {})
    for d in (32, 2, 200):
        check_agnn_kernels("DD residual", meta, tiles, index, res, d, dev, errs, sddmm=False)
    e, d = len(m.res_idx), 32
    x, dy = randn((n, d), 500 + d, dev) * 0.3, randn((n, d), 600, dev)
    for k, kernel, plain, b in (
            ("K2", lambda: spmm_sfused(x, x, x, meta, tiles, index=index),
             lambda: spmm_sfused_torch(x, x, x, meta, tiles),
             csr_bound(e, n, 2 * nbytes(x), 4 * e * d)),
            ("K3", lambda: spmm_sfused_bwd(x, dy, meta, tiles, index=index),
             lambda: spmm_sfused_bwd_torch(x, dy, meta, tiles),
             csr_bound(e, n, 4 * nbytes(x), 12 * e * d))):
        kt, pt, dv = timed_pair(kernel, plain)
        print(f"  time {KERNELS[k][0]} DD residual d={d} f32: kernel {kt:.4f} ms (device "
              f"{dv:.4f}), plain {pt:.4f} ms, bound {b[0]:.5f} ms ({b[1]}) (median of "
              f"{TIMING_RUNS} event pairs a call; device: one pair around {TIMING_RUNS} calls; "
              f"card: {card})")


def phase_bd_kernels(dd, dev, card) -> dict:
    """Phase 7: K5, K6 and K7 against their plain versions and f64 oracles,
    and K2/K3 over DD's residual (``check_residual_kernels``).  Returns, per
    kernel, the f32 max abs error of each case against the plain
    version."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = bd_row_index(pack, m.offsets, n)
    torch.cuda.synchronize()
    print(f"DD row index: {index.nnz} nonzeros, "
          f"{nbytes(index.row_ptr, index.cols, index.vals) / 2**20:.1f} MiB, built in "
          f"{time.perf_counter() - t0:.3f} s")
    for d in (32, 2):
        check_bd_agnn_kernels("DD", pack, m.offsets, index, cov, d, dev, errs)
    # The wide path (d > 128), two of the sharing cases.
    check_bd_agnn_kernels("DD", pack, m.offsets, index, cov, 200, dev, errs,
                          sharing=("all one", "separate"))
    del pack, index
    check_residual_kernels(dd, m, dev, card, errs)

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


def row_runs(m) -> int:
    """Runs of a chunk's consecutive real slots that share an output row,
    over the layout (a chunk is one TC block's edges, in CSR order)."""
    runs, per = 0, 1 << 15
    for s, nc in enumerate(m.seg_chunks.tolist()):
        for c0 in range(0, nc, per):
            r = m.seg_r[s, c0:min(nc, c0 + per)]
            first = r < m.config.blk_h
            first[:, 1:] &= r[:, 1:] != r[:, :-1]
            runs += int(first.sum())
    return runs


def index_csr(m, dev, w=None) -> torch.Tensor:
    """The layout's row index as a float CSR tensor (ones, or ``w``), for the
    library yardsticks."""
    vals = torch.ones(m.num_edges, device=dev) if w is None else w
    return torch.sparse_csr_tensor(m.row_ptr, m.row_src.long(), vals,
                                   size=(m.num_nodes, m.num_nodes))


def check_reddit_kernels(g, dev, card) -> dict:
    """Phase 11, after the reddit GCN run, on that run's graph: K8 and K9 on
    the streamed route's layout (each direction) at the main path's shapes,
    against their plain versions (the tolerance's magnitude is the plain
    version over absolute values: an f64 oracle would need [E, d]).  K8:
    d=16 (GCN's layer 2), d=602 (the hoisted layer-1 aggregate), d=32 and 41
    weighted (AGNN's hidden and class widths); K9 at d=32 and 41 with one
    matrix and two.  Prints the segment layout, its mean row run (what the
    slot order kept of CSR order) and the row index's bytes, and each
    shape's kernel time (event and device) beside its bound and the library
    call's (``torch.sparse.mm``, ``torch.sparse.sampled_addmm`` over the
    row index) and the plain version's (the one call the check makes).
    Returns, per kernel, the max abs error of each case, and the records of
    K8 at d=16 and K9 at d=32 (one matrix) on A for the kernels line."""
    errs, records = {"K8": {}, "K9": {}}, {}
    n, e = g.num_nodes, g.num_edges
    layouts = {"A": g.chunks} if g.chunks_t is g.chunks else {"A": g.chunks, "A^T": g.chunks_t}
    w = randn((e,), 140, dev)

    def plain_once(fn):
        """The plain version's result and event ms of its one call."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def timed(tag, fn, lib, b, pt) -> dict:
        """Kernel and (``lib`` not None) library, event and device ms,
        printed beside the plain version's ``pt``; the kernel's record."""
        kt, kd = median_ms(fn, runs=5), device_ms(fn, runs=5)
        lt = None if lib is None else median_ms(lib, runs=5)
        ls = "" if lib is None else f", library {lt:.4f} ms (device {device_ms(lib, runs=5):.4f})"
        print(f"  time {tag}: kernel {kt:.4f} ms (device {kd:.4f}){ls}, plain {pt:.4f} ms (one "
              f"call), bound {b[0]:.4f} ms ({b[1]}) (median of 5, CUDA events; device: one pair "
              f"around 5 calls; card: {card})")
        return record(kt, pt, kd, b, lt)

    for name, m in layouts.items():
        stacked = nbytes(m.seg_col_ids, m.seg_r, m.seg_c, m.seg_edge_id, m.seg_block,
                         m.seg_window, m.seg_chunks)
        runs = row_runs(m)
        print(f"reddit {name}: {m.num_segments} segments of {m.wseg} windows, C_max "
              f"{m.max_chunks}, {m.num_real_chunks} real chunks; chunk metadata "
              f"{stacked / 1e6:.1f} MB stacked; {runs} row runs in the chunks, "
              f"{m.num_edges / runs:.4f} slots a run; row index (row_ptr, row_src) "
              f"{nbytes(m.row_ptr, m.row_src) / 1e6:.1f} MB")
        if name == "A":
            # What the flat layout (to_chunks) would upload: the real
            # chunks' slots, block and window ids, the TC blocks' col_ids.
            flat = (4 * m.num_real_chunks * (3 * m.config.edge_chunk + 2)
                    + 4 * g.tc_blocks * m.config.blk_w)
            print(f"  the flat layout's: {flat / 1e6:.1f} MB")
        a_csr, a_w = index_csr(m, dev), index_csr(m, dev, w)
        for d, wd in ((16, None), (602, None), (32, w), (41, w)):
            x = randn((n, d), 141 + d, dev)
            tag = f"K8 reddit {name} d={d}{'' if wd is None else ' weighted'}"
            mag = spmm_tc_torch(x.abs(), m, None if wd is None else wd.abs())
            want, pt = plain_once(lambda: spmm_tc_torch(x, m, wd))
            errs["K8"][tag] = compare(f"{tag} vs plain", spmm_tc(x, m, wd), want, mag, F32_TOL)
            del mag, want
            csr_a = a_csr if wd is None else a_w
            rec = timed(tag, lambda: spmm_tc(x, m, wd), lambda: torch.sparse.mm(csr_a, x),
                        csr_bound(e, n, 2 * nbytes(x), 2 * e * d, weighted=wd is not None), pt)
            if name == "A" and d == 16:
                records["K8"] = rec
        for d in (32, 41):
            xa, xb = randn((n, d), 150 + d, dev), randn((n, d), 151 + d, dev)
            for two in (False, True):
                tag = f"K9 reddit {name} d={d} {'two matrices' if two else 'one matrix'}"
                other = xb if two else None
                mag = sddmm_tc_torch(xa.abs(), m, None if other is None else other.abs())
                want, pt = plain_once(lambda: sddmm_tc_torch(xa, m, other))
                errs["K9"][tag] = compare(f"{tag} vs plain", sddmm_tc(xa, m, other), want, mag,
                                          F32_TOL)
                del mag, want
                # The library call once a width: two matrices cost it the same.
                xat = xa.t().contiguous()
                rec = timed(tag, lambda: sddmm_tc(xa, m, other),
                            None if two else lambda: torch.sparse.sampled_addmm(a_csr, xa, xat,
                                                                                beta=0.0),
                            csr_bound(e, n, nbytes(xa) * (2 if two else 1) + 4 * e, 2 * e * d),
                            pt)
                if name == "A" and d == 32 and not two:
                    records["K9"] = rec
        del a_csr, a_w
    return errs, records


def phase_train(data_dir, dev, card) -> tuple[list, dict, dict, dict]:
    """Phase 11: the main path, through the trainer's entry point.  Every
    count is set to 0 just before each run and read just after it; returns
    the runs, each kernel's launches summed over them, and the errors and
    records of ``check_reddit_kernels``, run on the reddit GCN run's graph
    once its counts are read."""
    asym = write_npz(data_dir, "asymmetric", asymmetric_graph)
    banded = write_npz(data_dir, "banded", banded_graph)
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
    results, launches, reddit_errs, reddit_records = [], {k: 0 for k in KERNELS}, {}, {}
    for label, extra, expected, must_fall, route, tc_blocks in runs:
        print(f"--- train.main {' '.join(extra)}")
        t0 = time.perf_counter()
        args = ["--device", "cuda", "--epochs", str(TRAIN_EPOCHS), *extra]
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
            reddit_errs, reddit_records = check_reddit_kernels(graph, dev, card)
            print(f"  reddit kernel checks done in {time.perf_counter() - t1:.1f} s")
        del graph
        results.append((label, r))
        torch.cuda.empty_cache()
    return results, launches, reddit_errs, reddit_records


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


def device_ms(fn, runs=TIMING_RUNS) -> float:
    """Device ms of one call: one event pair around ``runs`` back-to-back
    calls, over ``runs``.  The host work of a call overlaps the device's
    queue, so this is the kernel's own time wherever the kernel takes
    longer than the wrapper's host work (``median_ms`` counts both)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def timed_pair(kernel, plain) -> tuple[float, float, float]:
    """Median event ms of kernel and plain version, in turns: plain,
    kernel, kernel, plain; and between the two kernel runs, the kernel's
    device ms (``device_ms``)."""
    p1, k1 = median_ms(plain), median_ms(kernel)
    dev = device_ms(kernel)
    k2, p2 = median_ms(kernel), median_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, dev


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


def record(kt, pt, dev, b, lib_ms) -> dict:
    return {"ms": kt, "device_ms": dev, "plain_ms": pt, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms}


def phase_timing(ds, dev) -> tuple[dict, dict]:
    """Phase 12: each kernel and its plain version at the pubmed shapes
    (f32): K1 at d=16 and 500 (GCN's layer-2 and hoisted layer-1
    aggregates), K2-K4 at d=32 and 3 (AGNN's hidden and class widths), K8 on
    the flat chunk layout at d=16 and 500, K9 at d=32 and 3.  Returns the
    times, and for the reported shape of K1-K4 (512x128, d=16 for K1, 32 for
    the others) its record with bound and library time (K8's and K9's come
    from reddit, ``check_reddit_kernels``)."""
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
            idx = g.sfused_index
            times[("K2", geo, d)] = timed_pair(lambda: spmm_sfused(x, x, x, m, a, index=idx),
                                               lambda: spmm_sfused_torch(x, x, x, m, a))
            times[("K3", geo, d)] = timed_pair(lambda: spmm_sfused_bwd(x, dy, m, a, index=idx),
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
                records["K4"]["kernel_ms"] = kernel_ms(lambda: sddmm_tc_dense(x, m, x))
    for geo, (bh, bw, ec) in CHUNK_GEOMETRIES.items():
        host = sparse_graph_translate(ds.row_pointers, ds.column_index, ds.num_nodes,
                                      TileConfig(blk_h=bh, blk_w=bw, edge_chunk=ec),
                                      emit_chunks=True)
        m = host.to_chunks(dev)
        for d in (16, 500):
            x = randn((ds.num_nodes, d), 700 + d, dev)
            times[("K8", geo, d)] = timed_pair(lambda: spmm_tc(x, m), lambda: spmm_tc_torch(x, m))
        for d in (32, 3):
            x = randn((ds.num_nodes, d), 800 + d, dev)
            times[("K9", geo, d)] = timed_pair(lambda: sddmm_tc(x, m), lambda: sddmm_tc_torch(x, m))
    return times, records


def phase_edge_timing(dev, card, errs) -> dict:
    """Phase 12, K4 over the banded graph's 1.22 M edges (an ``EdgeList``
    in CSR order, the edges its AGNN scores) at d=32 and 22 (AGNN's hidden
    and class widths there; 16-byte and scalar loads), f32: held against
    its plain version and the f64 oracle (the error into ``errs["K4"]``),
    then event and device time, and the kernel's own time under the
    profiler, beside its bound (``csr_bound``: the edges' columns and row
    pointers, x once and an f32 score an edge) and
    ``torch.sparse.sampled_addmm``.  Returns the times."""
    times = {}
    n, rp, ci = banded_graph()
    e = len(ci)
    meta = EdgeList.from_rows(np.repeat(np.arange(n), np.diff(rp)), ci, n, TileConfig(), dev)
    a_csr, csr = csr_tensor(rp, ci, n, dev), Csr(rp, ci, dev)
    for d in (32, 22):
        x = randn((n, d), 170 + d, dev) * 0.3
        check_sddmm(f"banded EdgeList d={d} f32", x, x, meta, csr, [x.double()] * 2, errs)
        xt = x.t().contiguous()
        kt, pt, dv = times[("K4", "banded", d)] = timed_pair(
            lambda: sddmm_tc_dense(x, meta), lambda: sddmm_tc_dense_torch(x, meta))
        kn = kernel_ms(lambda: sddmm_tc_dense(x, meta))
        lib = median_ms(lambda: torch.sparse.sampled_addmm(a_csr, x, xt, beta=0.0))
        b = csr_bound(e, n, nbytes(x) + 4 * e, 2 * e * d)
        print(f"  time K4 banded graph ({e} edges, EdgeList) d={d}: event {kt:.4f} ms, device "
              f"{dv:.4f} ms, kernel {kn:.4f} ms (device operations under torch.profiler), "
              f"plain {pt:.4f} ms, sampled_addmm {lib:.4f} ms, bound {b[0]:.5f} ms ({b[1]}) "
              f"(card: {card})")
    return times


def phase_bd_timing(dd, dev) -> tuple[dict, dict]:
    """Phase 12, BD part: K5 at DD's d=2, 16 and 89 (a hoisted GCN epoch's
    width, GCN's hidden and input widths), K6 and K7 at d=32 and 2 (AGNN's
    hidden and class widths), f32, against their plain versions; records at
    d=16 (K5) and 32 (K6, K7)."""
    times, records = {}, {}
    g = TiledGraph(dd.row_pointers, dd.column_index, dd.num_nodes, TileConfig(), device=dev)
    p, offs, cfg, n = g.bd.pack, g.bd_offsets, TileConfig(), dd.num_nodes
    index = g.bd.row_index
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
            lambda: bd_sfused(x, x, x, p, offsets=offs, cfg=cfg, index=index),
            lambda: bd_sfused_torch(x, x, x, p, offsets=offs, cfg=cfg))
        times[("K7", "DD", d)] = timed_pair(
            lambda: bd_sfused_bwd(x, dy, p, offsets=offs, cfg=cfg, index=index),
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


def check_stream_sfused(name, m, a, index, d, dev, tol, errs) -> None:
    """K2 and K3 over a shard stream's row index at width d, the window side
    (``xl``; ``xw``, ``dyw``) apart from the gathered side, against their
    plain versions (magnitude: the plain version on absolute values)."""
    dt = str(m.config.compute_dtype)[6:]
    tag = f"{name} d={d} {dt}"
    x, dy = randn((m.num_src, d), 910, dev) * 0.3, randn((m.num_src, d), 911, dev) * 0.3
    xw, dyw = randn((m.num_rows, d), 912, dev) * 0.3, randn((m.num_rows, d), 913, dev) * 0.3
    err = compare(f"K2 with xl apart {tag} vs plain", spmm_sfused(xw, x, x, m, a, index=index),
                  spmm_sfused_torch(xw, x, x, m, a),
                  spmm_sfused_torch(xw.abs(), x.abs(), x.abs(), m, a), tol)
    if dt == "float32":
        errs["K2"][f"stream {tag}"] = err
    got = spmm_sfused_bwd(x, dy, m, a, xw=xw, dyw=dyw, index=index)
    want = spmm_sfused_bwd_torch(x, dy, m, a, xw, dyw)
    mags = spmm_sfused_bwd_torch(x.abs(), dy.abs(), m, a, xw.abs(), dyw.abs())
    err = max(compare(f"K3 with xw/dyw {tag} {what} vs plain", p, q, r, tol)
              for what, p, q, r in zip(("dx3", "u"), got, want, mags))
    if dt == "float32":
        errs["K3"][f"overrides {tag}"] = err


def check_8x1_streams(ds, dev, errs) -> None:
    """Phase 13, the 8x1 mesh the trainer's ``--mesh 8x1`` AGNN runs: each
    split stream's row index (built at upload; rebuilt here to time it), and
    K2/K3 over it at d in {32, 3} (AGNN's hidden and class widths) and 200,
    f32 and bf16."""
    g = mesh_graph(ds, (8, 1), dev)
    streams, _ = g._agnn_streams()
    if not g.agnn_split or any(st.index is None for st in streams):
        raise AssertionError("pubmed 8x1: expected the split stream, each with its row index")
    for i, st in enumerate(streams):
        timed_index(f"pubmed 8x1 shard {i} ({st.meta.num_rows} window rows, "
                    f"{st.meta.num_src} gathered)", st.meta, st.tiles)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            for d in (32, 3, 200):
                check_stream_sfused(f"pubmed 8x1 shard {i}", with_dtype(st.meta, dtype), st.tiles,
                                    st.index, d, dev, tol, errs)


def phase_mesh_kernels(ds, dev, card) -> tuple[dict, dict]:
    """Phase 13, kernels: K10, K4's tile mode and K3 with its window-side
    overrides on each split-stream shard of pubmed over 4x2, against their
    plain versions (magnitude: the plain version on absolute values), f32
    and bf16; then K10 timed.  Returns the f32 errors per kernel and K10's
    record."""
    errs = {"K10": {}, "K4": {}, "K3": {}, "K2": {}}
    check_8x1_streams(ds, dev, errs)
    g = mesh_graph(ds, (4, 2), dev)
    sp = g._fwd.split
    if sp is None or g.host_bwd.split is None:
        raise AssertionError("pubmed 4x2: expected the split stream in both directions")
    print(f"pubmed 4x2: {g.route}; split stream {sp.streams[0].meta.num_blocks} blocks a shard "
          f"(unsplit {g._fwd.streams[0].meta.num_blocks}), guest_cap {sp.guest_cap}, "
          f"pair_cap {sp.pair_cap}, halo rows {g.host_fwd.halo['halo_rows']}")
    for i, st in enumerate(sp.streams):
        a = st.tiles
        index = sgt_row_index(st.meta, a)
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
            check_stream_sfused(f"pubmed 4x2 shard {i}", m, a, index, 32, dev, tol, errs)

    # K10 timed at the main path's feature-shard width (hidden 32 over 2
    # feature shards) on the heaviest shard's split stream, and K4's tile
    # mode that makes its scores.
    st = max(sp.streams, key=lambda t: t.meta.num_edges)
    m, a, d = st.meta, st.tiles, 16
    x, xw = randn((m.num_src, d), 920, dev), randn((m.num_rows, d), 921, dev)
    s = sddmm_tc_tiles(xw, m, x)
    kt, pt, dv = timed_pair(lambda: sddmm_tc_tiles(xw, m, x),
                            lambda: sddmm_tc_tiles_torch(xw, m, x))
    kn, kn_all = (kernel_ms(lambda: sddmm_tc_tiles(xw, m, x), fills=f) for f in (False, True))
    print(f"  time K4 tile mode pubmed 4x2 heaviest shard ({m.num_edges} edges, "
          f"{m.num_blocks} f32 tiles) d={d}: event {kt:.4f} ms, device {dv:.4f} ms, kernel "
          f"{kn:.4f} ms and the tiles' zeroing {kn_all - kn:.4f} ms (device operations under "
          f"torch.profiler), plain {pt:.4f} ms (card: {card})")
    # Three rounds of the pair, to tell the order of kernel and plain
    # version apart from the spread of one round; the record is their median.
    rounds = [timed_pair(lambda: spmm_fused(x, m, a, s), lambda: spmm_fused_torch(x, m, a, s))
              for _ in range(K10_ROUNDS)]
    kt = statistics.median(r[0] for r in rounds)
    pt = statistics.median(r[1] for r in rounds)
    dev = statistics.median(r[2] for r in rounds)
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
          f"d={d}: kernel {kt:.4f} ms (device {dev:.4f}), plain {pt:.4f} ms, torch.sparse.mm "
          f"{lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) (median of {K10_ROUNDS} rounds of "
          f"{TIMING_RUNS}, CUDA events; card: {card}; one card held all 8 shards); rounds "
          "(kernel, plain, device): "
          + ", ".join(f"({k:.4f}, {p:.4f}, {v:.4f})" for k, p, v in rounds))
    return errs, record(kt, pt, dev, b, lib)


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
        r = train.main(["--device", "cuda", "--epochs", str(TRAIN_EPOCHS), *extra])
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
    for k, kernel_errs in phase_bd_kernels(dd, dev, card).items():
        errs.setdefault(k, {}).update(kernel_errs)
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
        runs, launches, reddit_errs, reddit_records = phase_train(data_dir, dev, card)
    for k, kernel_errs in reddit_errs.items():
        errs[k].update(kernel_errs)
    phase_end(t0)

    # ---- 12. timing ---------------------------------------------------------
    t0 = phase_start("12. timing")
    times, records = phase_timing(ds, dev)
    times.update(phase_edge_timing(dev, card, errs))
    bd_times, bd_records = phase_bd_timing(dd, dev)
    times.update(bd_times)
    records.update(bd_records)
    records.update(reddit_records)  # K8 and K9 at the main path's shapes
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

    for (k, geo, d), (kt, pt, dev) in times.items():
        print(f"  time {KERNELS[k][0]} {geo} d={d}: kernel {kt:.4f} ms (device {dev:.4f} ms), "
              f"plain {pt:.4f} ms (median of {TIMING_RUNS} event pairs a call; device: one "
              f"pair around {TIMING_RUNS} calls; card: {card})")

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
        print(f"  {name}: {records[k]['ms']:.4f} ms (device {records[k]['device_ms']:.4f}), "
              f"plain {records[k]['plain_ms']:.4f}, bound "
              f"{records[k]['bound_ms']:.4f} ({records[k]['bound_by']}), library "
              f"{records[k]['library_ms']} (card: {card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


# ---- parent against tree (``--ab``, not a phase) -------------------------------

AB_ROUNDS = 3
AB_SOURCES = ("spmm_bd", "spmm_dense", "chunk", "spmm_sfused", "sddmm_dense")


@dataclasses.dataclass
class AbCase:
    """One shape of one kernel in the A/B: ``fn`` calls the tree's wrapper,
    behind which either side's C functions run; ``plain`` and
    ``magnitude`` hold both to the plain version; ``library`` is the one
    PyTorch call of the same function, or None; ``fills_apart``: the
    wrapper zeroes the output the same way on both sides (K4's tiles), so
    the kernel-time verdict leaves memsets and fills out.  Elsewhere the
    zeroing is part of the design (K2/K3's and K8's atomics add into it)
    and stays in."""

    kernel: str
    shape: str
    fn: object
    plain: object
    library: object
    magnitude: object
    tol: dict = dataclasses.field(default_factory=lambda: F32_TOL)
    fills_apart: bool = False


def build_other(name, src_dir) -> ctypes.CDLL:
    """``<src_dir>/<name>.cu`` (another commit's source, with the tree's C
    interface) built beside the tree's libraries, ``-Xptxas -v`` printed,
    its C functions declared as the tree's."""
    out = _kernels.BUILD_DIR / f"lib{name}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(out), os.path.join(src_dir, f"{name}.cu")],
                          capture_output=True, text=True)
    print(f"--- {src_dir}/{name}.cu ptxas:\n{proc.stdout}{proc.stderr}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}/{name}.cu")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _kernels.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.tcgnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tcgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def use_libraries(libs) -> None:
    """Point the wrappers' launches of every C function of each source in
    ``libs`` (name -> library) at that library."""
    for name, lib in libs.items():
        for fn in _kernels.SIGNATURES[name]:
            _kernels._functions[(name, fn)] = getattr(lib, fn)


def sfused_ab_cases(dev) -> list:
    """K2 (one operand, as AGNN calls it) and K3 over the row index:
    pubmed at 512x128, d=32 in f32 and bf16 and d=3 in f32, and DD's
    residual at d=32 in f32.  No library call computes a score-fused SpMM."""
    cases = []
    pm = synthesize("pubmed", seed=0)
    tg = TiledGraph(pm.row_pointers, pm.column_index, pm.num_nodes, TileConfig(), device=dev)
    dd = synthesize("DD", 89, 2)
    bg = TiledGraph(dd.row_pointers, dd.column_index, dd.num_nodes, TileConfig(), device=dev)
    print(f"DD residual: {bg.bd.res_index.nnz} nonzeros, {bg.bd.res_meta.num_blocks} blocks",
          flush=True)
    shapes = [("pubmed", tg.meta, tg.a_struct, tg.sfused_index, 32, torch.float32),
              ("pubmed", tg.meta, tg.a_struct, tg.sfused_index, 32, torch.bfloat16),
              ("pubmed", tg.meta, tg.a_struct, tg.sfused_index, 3, torch.float32),
              ("DD residual", bg.bd.res_meta, bg.bd.res_a, bg.bd.res_index, 32, torch.float32)]
    for name, meta, a, idx, d, dtype in shapes:
        m, tol = with_dtype(meta, dtype), F32_TOL if dtype == torch.float32 else BF16_TOL
        n = m.num_rows
        x, dy = randn((n, d), 200 + d, dev) * 0.3, randn((n, d), 300, dev)
        shape = f"{name} d={d} {str(dtype)[6:]}"
        # Every lambda binds its operands: the loop rebinds the names.
        cases.append(AbCase(
            "K2", shape, lambda x=x, m=m, a=a, idx=idx: spmm_sfused(x, x, x, m, a, index=idx),
            lambda x=x, m=m, a=a: spmm_sfused_torch(x, x, x, m, a), None,
            lambda x=x, m=m, a=a: spmm_sfused_torch(x.abs(), x.abs(), x.abs(), m, a), tol))
        cases.append(AbCase(
            "K3", shape,
            lambda x=x, dy=dy, m=m, a=a, idx=idx: spmm_sfused_bwd(x, dy, m, a, index=idx),
            lambda x=x, dy=dy, m=m, a=a: spmm_sfused_bwd_torch(x, dy, m, a), None,
            lambda x=x, dy=dy, m=m, a=a: spmm_sfused_bwd_torch(x.abs(), dy.abs(), m, a), tol))
    return cases


def bd_agnn_ab_cases(g, cov) -> list:
    """K6 (one operand, as AGNN calls it) and K7 over the pack's row index
    on DD at d=32 and 2 in f32 (AGNN's hidden and class widths) and d=32 in
    bf16.  No library call computes a score-fused SpMM.  K7's (dx3, u) are
    timed as they come and compared side by side."""
    cases = []
    p, offs, n, index, dev = g.bd.pack, g.bd_offsets, g.num_nodes, g.bd.row_index, g.device
    for d, dtype in ((32, torch.float32), (2, torch.float32), (32, torch.bfloat16)):
        cfg, tol = TileConfig(compute_dtype=dtype), (F32_TOL if dtype == torch.float32
                                                      else BF16_TOL)
        x, dy = randn((n, d), 500 + d, dev) * 0.3, randn((n, d), 600, dev)
        shape = f"DD d={d} {str(dtype)[6:]}"
        xa, dya = x.to(dtype).double().abs(), dy.to(dtype).double().abs()
        cases.append(AbCase(
            "K6", shape,
            lambda x=x, cfg=cfg: bd_sfused(x, x, x, p, offsets=offs, cfg=cfg, index=index),
            lambda x=x, cfg=cfg: bd_sfused_torch(x, x, x, p, offsets=offs, cfg=cfg), None,
            lambda xa=xa: sfused_ref(xa, xa, xa, cov.ptr, cov.idx), tol))
        cases.append(AbCase(
            "K7", shape,
            lambda x=x, dy=dy, cfg=cfg: bd_sfused_bwd(x, dy, p, offsets=offs, cfg=cfg,
                                                      index=index),
            lambda x=x, dy=dy, cfg=cfg: bd_sfused_bwd_torch(x, dy, p, offsets=offs, cfg=cfg),
            None, lambda xa=xa, dya=dya: sfused_bwd_ref(xa, dya, cov.ptr, cov.idx), tol))
    return cases


def chunk_ab_cases(dev) -> list:
    """K8 and K9 cases: pubmed's flat layout at 512x128 (K8 d=16 and 500, K9
    d=32 and 3) and reddit's streamed layout, built once (K8 d=16, d=32 and
    41 weighted; K9 d=32 and 41, one matrix), with ``torch.sparse.mm`` and
    ``torch.sparse.sampled_addmm`` over the row index as the library."""
    cases = []
    pm = synthesize("pubmed", seed=0)
    graphs = [("pubmed", TiledGraph(pm.row_pointers, pm.column_index, pm.num_nodes,
                                    TileConfig(), device=dev, dense_tiles=False),
               ((16, False), (500, False)), (32, 3))]
    t0 = time.perf_counter()
    rd = synthesize("reddit", 602, 41)
    g = TiledGraph(rd.row_pointers, rd.column_index, rd.num_nodes, TileConfig(), device=dev)
    print(f"reddit: {rd.num_edges} edges, streamed {g.streamed}, TC_Blocks {g.tc_blocks}, "
          f"{g.chunks.num_segments} segments; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del rd
    graphs.append(("reddit", g, ((16, False), (32, True), (41, True)), (32, 41)))
    for name, tg, spmm_shapes, sddmm_widths in graphs:
        m, n, e = tg.chunks, tg.num_nodes, tg.num_edges
        w = randn((e,), 140, dev)
        a_csr, a_w = index_csr(m, dev), index_csr(m, dev, w)
        # Every lambda binds its operands: the loops rebind the names.
        for d, weighted in spmm_shapes:
            x, wd = randn((n, d), 141 + d, dev), (w if weighted else None)
            csr_a = a_w if weighted else a_csr
            cases.append(AbCase(
                "K8", f"{name} d={d}{' weighted' if weighted else ''}",
                lambda x=x, m=m, wd=wd: spmm_tc(x, m, wd),
                lambda x=x, m=m, wd=wd: spmm_tc_torch(x, m, wd),
                lambda x=x, csr_a=csr_a: torch.sparse.mm(csr_a, x),
                lambda x=x, m=m, wd=wd: spmm_tc_torch(x.abs(), m,
                                                      None if wd is None else wd.abs())))
        for d in sddmm_widths:
            x = randn((n, d), 150 + d, dev)
            xt = x.t().contiguous()
            cases.append(AbCase(
                "K9", f"{name} d={d} one matrix", lambda x=x, m=m: sddmm_tc(x, m),
                lambda x=x, m=m: sddmm_tc_torch(x, m),
                lambda x=x, xt=xt, a_csr=a_csr: torch.sparse.sampled_addmm(a_csr, x, xt,
                                                                           beta=0.0),
                lambda x=x, m=m: sddmm_tc_torch(x.abs(), m)))
    return cases


def sddmm_ab_cases(dev) -> list:
    """K4, per-edge with one operand as AGNN calls it: pubmed at 512x128,
    d=32 in f32 and bf16 and d=3 (AGNN's hidden and class widths); the
    asymmetric graph at d=32; the banded graph's 1.22 M edges as an
    ``EdgeList`` at d=32 and 22 (AGNN's hidden and class widths there); with
    ``torch.sparse.sampled_addmm`` beside the f32 ones.  On pubmed and the
    Then K4's tile mode
    on the heaviest pubmed 4x2 shard's split stream (out of row order) at
    d=16 and 32, f32 and bf16 tiles, zeroed by the wrapper
    (``fills_apart``: the verdict leaves the zeroing out).  The features are in the compute dtype
    already, as AGNN hands them over, so no cast is timed."""
    cases = []
    pm = synthesize("pubmed", seed=0)
    an, arp, aci = asymmetric_graph()
    bn, brp, bci = banded_graph()
    banded = EdgeList.from_rows(np.repeat(np.arange(bn), np.diff(brp)), bci, bn, TileConfig(),
                                dev)
    print(f"banded graph: {bn} nodes, {banded.num_edges} edges", flush=True)
    graphs = {
        "pubmed 512x128": (TiledGraph(pm.row_pointers, pm.column_index, pm.num_nodes,
                                      TileConfig(), device=dev).meta,
                           pm.row_pointers, pm.column_index),
        "asymmetric": (TiledGraph(arp, aci, an, TileConfig(), device=dev).meta, arp, aci),
        "banded": (banded, brp, bci),
    }
    shapes = [("pubmed 512x128", 32, torch.float32), ("pubmed 512x128", 32, torch.bfloat16),
              ("pubmed 512x128", 3, torch.float32), ("asymmetric", 32, torch.float32),
              ("banded", 32, torch.float32), ("banded", 22, torch.float32)]
    for name, d, dtype in shapes:
        meta, rp, ci = graphs[name]
        m = dataclasses.replace(meta, config=dataclasses.replace(meta.config,
                                                                 compute_dtype=dtype))
        n = m.num_rows
        # In the compute dtype, as AGNN's projection hands it over: the
        # kernel time holds no cast.
        x = (randn((n, d), 160 + d, dev) * 0.3).to(dtype)
        xa = x.double().abs()
        csr = Csr(rp, ci, dev)
        lib = None
        if dtype == torch.float32:
            a_csr, xt = csr_tensor(rp, ci, n, dev), x.t().contiguous()
            lib = lambda x=x, xt=xt, a_csr=a_csr: torch.sparse.sampled_addmm(  # noqa: E731
                a_csr, x, xt, beta=0.0)
        cases.append(AbCase(
            "K4", f"{name} d={d} {str(dtype)[6:]}", lambda x=x, m=m: sddmm_tc_dense(x, m),
            lambda x=x, m=m: sddmm_tc_dense_torch(x, m), lib,
            lambda xa=xa, csr=csr: sddmm_ref(xa, csr.ptr, csr.idx, xa)))
    st = max(mesh_graph(pm, (4, 2), dev)._fwd.split.streams, key=lambda t: t.meta.num_edges)
    print(f"K4 tile-mode shard: {st.meta.num_edges} edges, {st.meta.num_blocks} blocks",
          flush=True)
    for d in (16, 32):
        for dtype in (torch.float32, torch.bfloat16):
            m = with_dtype(st.meta, dtype)
            xw = (randn((m.num_rows, d), 921, dev) * 0.3).to(dtype)
            x = (randn((m.num_src, d), 920, dev) * 0.3).to(dtype)
            cases.append(AbCase(
                "K4 tiles", f"pubmed 4x2 heaviest shard d={d} {str(dtype)[6:]} tiles",
                lambda xw=xw, x=x, m=m: sddmm_tc_tiles(xw, m, x),
                lambda xw=xw, x=x, m=m: sddmm_tc_tiles_torch(xw, m, x), None,
                lambda xw=xw, x=x, m=m: sddmm_tc_tiles_torch(xw.abs(), m, x.abs(), torch.float32),
                F32_TOL if dtype == torch.float32 else BF16_TILE_TOL, fills_apart=True))
    return cases


def ab_cases(dev, sources) -> list:
    """The ``AbCase``s of each source in ``sources``: K5 on DD at d in {2,
    16, 89} and K6/K7 as ``bd_agnn_ab_cases``, K1 on pubmed at 512x128 d in
    {16, 500} and 16x8 d=16, K10 on the heaviest pubmed 4x2 shard at d in
    {8, 16, 32}, K8 and K9 as ``chunk_ab_cases``, K2 and K3 as
    ``sfused_ab_cases``, K4 as ``sddmm_ab_cases``."""
    cases = []
    if "spmm_bd" in sources:
        dd = synthesize("DD", 89, 2)
        g = TiledGraph(dd.row_pointers, dd.column_index, dd.num_nodes, TileConfig(), device=dev)
        p, offs, cfg, n = g.bd.pack, g.bd_offsets, TileConfig(), dd.num_nodes
        cov = covered_csr(dd.row_pointers, dd.column_index,
                          extract_block_diag(dd.row_pointers, dd.column_index, n), dev)
        cov_csr = csr_tensor(cov.ptr.cpu(), cov.idx.cpu(), n, dev)
        print(f"DD: N={n} pack {tuple(p.shape)} {p.dtype} offsets {offs}, covered edges "
              f"{cov.idx.numel()}", flush=True)
        for d in (2, 16, 89):
            x = randn((n, d), 400 + d, dev)
            cases.append(AbCase(
                "K5", f"DD d={d}", lambda x=x: spmm_block_diag(x, p, offsets=offs, cfg=cfg),
                lambda x=x: spmm_block_diag_torch(x, p, offsets=offs, cfg=cfg),
                lambda x=x: torch.sparse.mm(cov_csr, x), lambda x=x: cov.magnitude(x)))
        cases += bd_agnn_ab_cases(g, cov)
    if "spmm_dense" in sources:
        pm = synthesize("pubmed", seed=0)
        a_csr = csr_tensor(pm.row_pointers, pm.column_index, pm.num_nodes, dev)
        pcsr = Csr(pm.row_pointers, pm.column_index, dev)
        for geo, d in (("512x128", 16), ("512x128", 500), ("16x8", 16)):
            bh, bw = GEOMETRIES[geo]
            tg = TiledGraph(pm.row_pointers, pm.column_index, pm.num_nodes,
                            TileConfig(blk_h=bh, blk_w=bw), device=dev)
            x = randn((pm.num_nodes, d), 100 + d, dev)
            cases.append(AbCase(
                "K1", f"pubmed {geo} d={d}",
                lambda x=x, m=tg.meta, a=tg.a_struct: spmm_tc_dense(x, m, a),
                lambda x=x, m=tg.meta, a=tg.a_struct: spmm_tc_dense_torch(x, m, a),
                lambda x=x: torch.sparse.mm(a_csr, x), lambda x=x: pcsr.magnitude(x)))
        st = max(mesh_graph(pm, (4, 2), dev)._fwd.split.streams, key=lambda t: t.meta.num_edges)
        m, a = st.meta, st.tiles
        print(f"K10 shard: {m.num_edges} edges, {m.num_blocks} blocks, {m.num_windows} windows",
              flush=True)
        for d in (8, 16, 32):
            x = randn((m.num_src, d), 920, dev)
            s = sddmm_tc_tiles(randn((m.num_rows, d), 921, dev), m, x)
            s_csr = torch.sparse_coo_tensor(
                torch.stack([m.edge_rows.long(), m.edge_cols.long()]),
                s.view(-1)[m.edge_pos.long()].float(), (m.num_rows, m.num_src)
            ).coalesce().to_sparse_csr()
            cases.append(AbCase(
                "K10", f"pubmed 4x2 heaviest shard d={d}", lambda x=x, s=s: spmm_fused(x, m, a, s),
                lambda x=x, s=s: spmm_fused_torch(x, m, a, s),
                lambda x=x, s_csr=s_csr: torch.sparse.mm(s_csr, x),
                lambda x=x, s=s: spmm_fused_torch(x.abs(), m, a, s.abs())))
    if "chunk" in sources:
        cases += chunk_ab_cases(dev)
    if "spmm_sfused" in sources:
        cases += sfused_ab_cases(dev)
    if "sddmm_dense" in sources:
        cases += sddmm_ab_cases(dev)
    return cases


def ab_main(other_dir) -> None:
    """The kernels of another commit's sources in ``other_dir`` (those of
    ``AB_SOURCES`` it holds, each with the tree's C interface, and the
    ``sparse_row.cuh`` they include) against the tree's, in one process,
    through the tree's wrappers (the same host work; only the C functions
    behind them differ): each side held to the plain version, then
    AB_ROUNDS rounds of other, tree, then the same in reverse, each the event time (``median_ms``) and the device
    time (``device_ms``), and the library call, where there is one, in the
    same round; and each side's kernel time (``kernel_ms``: the sum of its
    device operations under torch.profiler, which a call whose host work
    outlasts its kernels does not hide, as it hides them from the device
    time), and for a case with ``fills_apart`` also without the memsets
    and fills that zero its output (``kernel_only``, which its verdict
    reads).  Prints each round, then all of them as one JSON line."""
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sources = [s for s in AB_SOURCES if os.path.exists(os.path.join(other_dir, f"{s}.cu"))]
    if not sources:
        raise SystemExit(f"--ab: {other_dir} holds none of {[s + '.cu' for s in AB_SOURCES]}")
    print("--- the tree's ptxas:", flush=True)
    libs = {"tree": {}, "other": {}}
    for name in sources:
        _kernels.build(name, verbose=True)
        libs["tree"][name] = _kernels.load(name)
        libs["other"][name] = build_other(name, other_dir)
    results = []

    def joined(out):  # several outputs (K7's dx3, u) side by side
        return torch.cat(out, 1) if isinstance(out, tuple) else out

    for case in ab_cases(dev, sources):
        want, m = joined(case.plain()), joined(case.magnitude())
        for which in ("other", "tree"):
            use_libraries(libs[which])
            compare(f"{case.kernel} {case.shape} {which} vs plain", joined(case.fn()).float(),
                    want.float(), m, case.tol)
        del want, m
        rounds = []
        for _ in range(AB_ROUNDS):
            r = {}
            for which in ("other", "tree", "tree", "other"):
                use_libraries(libs[which])
                ev, dv = median_ms(case.fn), device_ms(case.fn)
                r[f"{which}_event_ms"] = r.get(f"{which}_event_ms", 0.0) + ev / 2
                r[f"{which}_device_ms"] = r.get(f"{which}_device_ms", 0.0) + dv / 2
            for which in ("other", "tree"):
                use_libraries(libs[which])
                r[f"{which}_kernel_ms"] = kernel_ms(case.fn)
                if case.fills_apart:
                    r[f"{which}_kernel_only_ms"] = kernel_ms(case.fn, fills=False)
            r["library_event_ms"] = None if case.library is None else median_ms(case.library,
                                                                                 runs=5)
            r["library_device_ms"] = None if case.library is None else device_ms(case.library,
                                                                                  runs=5)
            rounds.append(r)
        use_libraries(libs["tree"])
        faster = all(r["tree_device_ms"] < r["other_device_ms"] for r in rounds)
        k = "kernel_only_ms" if case.fills_apart else "kernel_ms"
        faster_kernel = all(r[f"tree_{k}"] < r[f"other_{k}"] for r in rounds)
        results.append({"kernel": case.kernel, "shape": case.shape, "rounds": rounds,
                        "tree_faster_in_every_round": faster,
                        "tree_kernel_faster_in_every_round": faster_kernel})
        print(f"{case.kernel} {case.shape}: tree faster in every round: device {faster}, "
              f"kernel {faster_kernel}", flush=True)
        for i, r in enumerate(rounds):
            print(f"    round {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                                                if v is not None), flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "other": other_dir,
                      "results": results}))
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        ab_main(sys.argv[2])
    elif len(sys.argv) == 1:
        main()
    else:
        raise SystemExit("usage: python3 chip_smoke.py [--ab OTHER_CSRC_DIR]")
