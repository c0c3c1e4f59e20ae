#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tcgnn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
  2. build K1 (``tcgnn_tpu_torch/csrc/spmm_dense.cu``) with nvcc for sm_90a;
  3. K1 against its plain PyTorch version on the card: pubmed tiling at
     512x128 and 16x8, d in {16, 500}, f32 and bf16; a graph with a
     duplicate count above 127 (float tiles); an asymmetric graph through
     its transpose tiling;
  4. autograd: ``TiledGraph.spmm`` forward and backward, kernel against
     plain version and CSR oracle, on the asymmetric graph;
  5. the main path through ``tcgnn_tpu_torch.train.main``: pubmed GCN with
     and without ``--no_hoist``, and GIN, 20 timed epochs each; the loss must
     be finite and fall, K1 must have launched and the plain version must
     not have run;
  6. K1 and the plain version timed with CUDA events at the pubmed shapes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from tcgnn_tpu_torch import TileConfig, TiledGraph, train
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.ops import _kernels
from tcgnn_tpu_torch.ops.reference import spmm_ref
from tcgnn_tpu_torch.ops.spmm import reset_counts, spmm_tc_dense, spmm_tc_dense_torch
from tcgnn_tpu_torch.sgt.translate import sparse_graph_translate, transpose_csr

# Summation order is the only difference between K1 and its references, so
# rtol applies to the sum of the magnitudes of the summed terms, |A| @ |x|
# (an f32 sum's rounding error scales with it, not with the result: the
# pubmed hub row sums 17,058 terms that largely cancel).
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 output store: 8 mantissa bits
GEOMETRIES = {"512x128": (512, 128), "16x8": (16, 8)}
TIMING_RUNS = 25


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
          f"(rtol={tol['rtol']} of |A||x|, atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its reference")
    return max_abs


class Csr:
    """A CSR adjacency on the card, for the f64 oracle ``A @ x`` and the
    magnitude ``|A| @ |x|``."""

    def __init__(self, rp, ci, dev):
        self.ptr = torch.from_numpy(np.asarray(rp)).to(dev)
        self.idx = torch.from_numpy(np.asarray(ci)).to(dev)

    def oracle(self, x):
        return spmm_ref(x.double(), self.ptr, self.idx)

    def magnitude(self, x):
        return spmm_ref(x.double().abs(), self.ptr, self.idx)


def check_case(name, x, meta, tiles, csr, errs=None):
    """K1 on (meta, tiles) against the plain version (f32 and bf16) and, in
    f32, the CSR oracle.  Records the f32 error against the plain version."""
    mag = csr.magnitude(x)
    got = spmm_tc_dense(x, meta, tiles)
    err = compare(f"{name} f32 vs plain", got, spmm_tc_dense_torch(x, meta, tiles), mag, F32_TOL)
    compare(f"{name} f32 vs CSR oracle (f64)", got, csr.oracle(x), mag, F32_TOL)
    if errs is not None:
        errs[name] = err
    mb = dataclasses.replace(
        meta, config=dataclasses.replace(meta.config, compute_dtype=torch.bfloat16))
    xb = x.to(torch.bfloat16)
    tb = tiles if tiles.dtype == torch.int8 else tiles.to(torch.bfloat16)
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
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev)
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
        g = TiledGraph(rp, ci, n, TileConfig(blk_h=bh, blk_w=bw), device=dev)
        if g.symmetric:
            raise AssertionError("test graph came out symmetric")
        dy = randn((n, 48), 13, dev)
        check_case(f"asymmetric {bh}x{bw} transpose", dy, g.meta_t, g.a_struct_t, csr_t, errs)

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


def phase_train() -> tuple[list, int]:
    """Phase 5: the main path, through the trainer's entry point."""
    runs = [
        ["--model", "gcn", "--no_hoist"],
        ["--model", "gcn"],
        ["--model", "gin"],
    ]
    results = []
    reset_counts()
    for extra in runs:
        before = spmm_tc_dense.launches
        print(f"--- train.main {' '.join(extra)}")
        r = train.main(["--dataset", "pubmed", "--device", "cuda", "--epochs", "20", *extra])
        launched = spmm_tc_dense.launches - before
        print(f"  first loss {r['first_loss']:.6f}  final loss {r['final_loss']:.6f}  "
              f"K1 launches {launched}  plain calls {spmm_tc_dense.plain_calls}")
        if not math.isfinite(r["final_loss"]) or not r["final_loss"] < r["first_loss"]:
            raise AssertionError(f"{extra}: loss did not fall ({r['first_loss']} -> {r['final_loss']})")
        if launched <= 0 or spmm_tc_dense.plain_calls != 0:
            raise AssertionError(f"{extra}: K1 launches {launched}, plain calls "
                                 f"{spmm_tc_dense.plain_calls}")
        if r["tc_blocks"] != 334:
            raise AssertionError(f"pubmed at 512x128 gave {r['tc_blocks']} TC blocks, not 334")
        results.append((" ".join(extra), r))
    return results, spmm_tc_dense.launches


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


def phase_timing(ds, dev, card) -> dict:
    """Phase 6: K1 and the plain version at the pubmed shapes (f32), in
    turns: plain, kernel, kernel, plain."""
    times = {}
    for geo, (bh, bw) in GEOMETRIES.items():
        g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes,
                       TileConfig(blk_h=bh, blk_w=bw), device=dev)
        for d, what in ((16, "layer-2 aggregate, d=16"), (500, "hoisted layer-1 aggregate, d=500")):
            x = randn((ds.num_nodes, d), 100 + d, dev)

            def kernel():
                spmm_tc_dense(x, g.meta, g.a_struct)

            def plain():
                spmm_tc_dense_torch(x, g.meta, g.a_struct)

            p1, k1, k2, p2 = median_ms(plain), median_ms(kernel), median_ms(kernel), median_ms(plain)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            times[(geo, d)] = (k, p)
            print(f"  time {geo} {what}: K1 {k:.4f} ms, plain {p:.4f} ms "
                  f"(median of {TIMING_RUNS}, CUDA events; card: {card})")
    return times


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

    # ---- 2. build K1 ---------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build("spmm_dense", verbose=True)
    _kernels.load_spmm_dense()
    print(f"K1 build (nvcc, sm_90a): {time.perf_counter() - t0:.2f} s")

    # ---- 3-4. kernel against plain version ------------------------------------
    ds = synthesize("pubmed", seed=0)
    print(f"pubmed: N={ds.num_nodes} E={ds.num_edges} d={ds.num_features}")
    errs = phase_compare(ds, dev)
    errs.update(phase_transpose_and_autograd(dev))
    torch.cuda.synchronize()

    # ---- 5. the main path ---------------------------------------------------
    runs, launches = phase_train()

    # ---- 6. timing ----------------------------------------------------------
    times = phase_timing(ds, dev, card)
    torch.cuda.synchronize()

    for name, r in runs:
        print(f"main path [{name}]: TC_Blocks {r['tc_blocks']}  Prep. (ms) {r['prep_ms']:.3f}  "
              f"Prep host (ms) {r['prep_host_ms']:.3f}  Train (ms) {r['train_ms']:.3f}  "
              f"Final loss {r['final_loss']:.6f}  (card: {card})")
    k16, p16 = times[("512x128", 16)]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "spmm_dense (K1)",
        "route": "cuda",
        "source": "tcgnn_tpu_torch/csrc/spmm_dense.cu",
        "replaces": "tcgnn_tpu/ops/spmm.py:249",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": k16,
        "plain_ms": p16,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
