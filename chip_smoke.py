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
     operand) and the NLL loss's pair (``nll.cu``) with nvcc for sm_90a,
     one nvcc per source, and the native SGT host pass (``tcgnn_tpu_torch/sgt/native/sgt.cpp``) with g++, all at
     once, printing ``-Xptxas -v``, the g++ flags and the build seconds;
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
     each unless named, every epoch after the first through ``step.many``
     (on the card one CUDA graph of the step, captured once in the warm-up
     and replayed an epoch): pubmed (``--dim 500 --classes 3``) GCN with and without
     ``--no_hoist``, GIN (K1), AGNN hidden 32 with 2 and 4 layers (K2/K3),
     AGNN 2 layers on the asymmetric graph (K4 and weighted K1); DD
     (``--dim 89 --classes 2``) GCN with and without ``--no_hoist``, GIN
     (K5, and K1 for the residual), AGNN with 2 and 4 layers (K6/K7, K2/K3
     for the residual), GCN after ``--reorder rcm``; Yeast GCN (K5 alone:
     fully covered, no condensed tiles); AGNN 2 layers on the banded graph
     (K4, K5 over weighted packs, K1); reddit (``--dim 602 --classes 41``,
     the streamed route, TC_Blocks 265,565) GCN hoisted (K8) and AGNN hidden
     32, 2 layers (K8 and K9).  Each run must take the expected route and
     launch its kernels and no others of K1-K10, by its wrappers and on the
     card (``device_launches``: a ``torch.profiler`` trace of the run's
     device activity, which shows a CUDA graph's replays), and no plain
     version may have run; its step must have been captured once, and the
     card must have run, beyond what the wrappers launched, each kernel's
     launches an epoch (the run table's) once for every replay but one
     (``check_replays``: the wrappers count the capture, which runs
     nothing, and no replay); its loss must have gone through the NLL
     kernel pair, one forward and one backward an eager step and a replay
     on the card, no plain version (``check_nll_launches``); the loss must be
     finite and fall, except in the 4-layer AGNN
     runs (pubmed overflows to nan in f32, as in the JAX package), which are
     only timed.  Every run must print ``SGT pass:\tnative`` (the native
     host pass tiled its graph).  The reddit runs print the peak host RSS
     and device memory.  After the reddit GCN run, on its graph: the segment
     layout, its mean row run and the row index's bytes, and K8 (d=16, 602,
     and 32 and 41 weighted) and K9 (d=32 and 41, one matrix and two)
     against their plain versions at the main path's shapes, each timed
     (event and device) beside its bound and ``torch.sparse.mm`` or
     ``torch.sparse.sampled_addmm`` over the row index; then the NumPy host
     pass over the same arrays, its ``Prep host (ms)`` stage by stage
     (transpose, symmetry check, block counts, SGT and chunk layout,
     segments) beside the native run's, the two graphs' row indexes equal.
     Last, the epoch chain against eager steps (``CHAIN_RUNS``: pubmed GCN
     no hoist, K1; DD AGNN, K6/K7; the banded AGNN, K4, weighted K5 and K1,
     ``index_add_``): from the same parameters and dropout generator,
     dropout 0.5, ``step.many(30)`` (its warm-up steps, the capture, the
     replays) against 30 eager steps, the final losses within
     ``RESUME_RTOL``, the launches the card ran equal on both sides and
     equal to the eager steps' wrappers' count, then 30 more epochs of each
     timed (ms an epoch, eager and replayed, printed);
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
     11's reddit timing (d=16 and d=32), the shapes of their main path.
     Last, the NLL loss's pair at Yeast's, amazon0505's and reddit's N and
     C (``phase_nll``): held to ``F.nll_loss``, then timed beside its plain
     version, the library's many-block ``F.nll_loss(..., reduction="none")
     .mean()``, ``F.nll_loss``'s one-block reduction and its bound; the
     kernels line takes its Yeast record and lists every shape's;
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
     a finite falling loss, its kernels and no others, no plain version, a
     first loss within ``rtol=1e-4`` of the single-device run's (the same
     model: ``init_distributed_net`` zero-pads the single-device draws), and
     its whole mesh step captured once and replayed an epoch as phase 11's
     runs are (``mesh_run``: the launches read on the card, one epoch's as
     the capture recorded them, ``check_replays``); then the mesh's epoch
     chain against eager steps (``MESH_CHAIN_RUNS``: pubmed GCN 4x2 and
     AGNN 8x1) as phase 11's chain check runs;
     K4's tile mode timed at d=16 on the heaviest shard (event and device
     time, its kernel time and the tiles' zeroing apart under
     torch.profiler); K10 timed there (event and device time, in
     three rounds) beside its bound (``csr_bound``
     over the shard's edges, one f32 score read an edge) and
     ``torch.sparse.mm`` over the shard's CSR with the scores as values;
 13b. the halo-overlap split (``DistributedTiledGraph.use_overlap``: the
     local and remote block classes), every shard on this one card: the
     asymmetric graph over 2x1 with ``split=False`` (every dense op through
     the classes, the weighted transpose too): ``spmm``, ``spmm_weighted``
     and ``sddmm``, forward and every gradient, against the single-device
     ``TiledGraph``'s (f32, d=32, ``rtol=atol=1e-4`` forward, ``1e-3``
     gradients), K1 and K4 launched once a class a shard a pass and no
     plain version; then the trainer, ``TRAIN_EPOCHS`` timed epochs,
     ``--no_dropout``: soc-BlogCatalog GCN (``--dim 128 --classes 39``, no
     hoist) over ``--mesh 2x1`` (both directions unsplit: every SpMM through
     the classes, K1) and the asymmetric graph's AGNN over ``--mesh 2x1``
     (its forward unsplit: the SDDMM and the forward weighted SpMM through
     the classes, K1 and K4), each replayed (``mesh_run``) with
     ``use_overlap``, a falling loss, its kernels and no others, no plain
     version, a first loss within
     ``FIRST_LOSS_RTOL`` of the single-device run's, and its ``Train (ms)``,
     ``max_memory_allocated`` and the device bytes of its classes beside
     the unsplit streams';
 14. ``--single_kernel`` (``train.profile_sag``: chained SpMM rounds, then
     SDDMM rounds, device time a round) through the trainer on pubmed at
     512x128 (K1, K4), DD (K5, K1, K4) and pubmed on ``--mesh 4x2`` (K1,
     K4, ``MESH_SAG_ROUNDS`` rounds), and over phase 11's reddit GCN graph
     (K8, K9, ``REDDIT_SAG_ROUNDS`` rounds): each run must return the JAX CLI's
     keys, launch its kernels and no others, and no plain version; it
     prints its SAG and SDDMM lines, edges/s and ``mfu_pct``;
 15. checkpoints: pubmed GCN with ``--checkpoint_dir`` every 2 epochs for
     6 epochs, then ``--resume --epochs 8``, its final loss within
     ``rtol=1e-5`` of an uninterrupted 8-epoch run's (whether bit-equal is
     printed); ``--save_params`` then ``--load_params`` on one device and
     on ``--mesh 4x2`` restoring every parameter exactly (a learning-rate-0
     run saves them back bit for bit); each run launches K1 on the card
     (``device_launches``);
 16. the AE harness (``tcgnn_tpu_torch.bench``) through its entry points:
     ``sweep`` GCN (no hoist and hoisted, 20 epochs) against both torch
     incumbents (10 epochs each) on cora, pubmed, PROTEINS_full, DD and
     amazon0601, AGNN (2 layers, hidden 32) on pubmed and DD, GIN on cora,
     ``--single_kernel`` on cora and DD, ``epoch_ledger`` on pubmed and DD
     (every stage timed under replays: ``step.many`` epochs, one CUDA graph
     of a chain of aggregation rounds; each row printed beside
     ``LEDGER_EAGER``'s row of eager steps) and ``accuracy_parity`` (GCN,
     AGNN) on the golden fixture: every CSV row
     there, finite and positive, each graph on its route, parity passing,
     every ``Fig_6a`` row's incumbent ``replayed`` (``gather``: one CUDA
     graph of its step) or ``eager`` (``sparse``, which cannot be captured),
     K1-K7 launched (on the card, but ``--single_kernel``'s, which traces
     its rounds itself and replays nothing: its wrappers' count) and no
     plain version run; then, on each of the five
     sweep graphs, both incumbents' ``spmm``, ``spmm_weighted`` and
     ``sddmm`` outputs and gradients against ``TiledGraph``'s at d=16;
 17. the distributed block-diagonal route, every shard on this one card: on
     Yeast (``--dim 74 --classes 2``, fully covered), a
     ``DistributedTiledGraph`` over 4x1 and over 2x2 takes the route, and
     its ``spmm``, ``spmm_weighted``, ``sddmm`` and ``agnn_aggregate``,
     forward and every gradient, hold against the single-device
     ``TiledGraph``'s on the card (f32, d=32, ``rtol=atol=1e-4`` forward,
     ``1e-3`` gradients, elementwise), launching K5 (4x1: K6/K7; 2x2: K4)
     and no plain version; then the trainer, ``TRAIN_EPOCHS`` timed
     epochs each, ``--no_dropout``: GCN 2 layers hidden 16 on ``--mesh
     4x1`` and ``2x2`` (K5), AGNN 2 layers hidden 32 on ``--mesh 4x1``
     (K6/K7) and ``2x2`` (K4 cell scores and K5), each replayed
     (``mesh_run``) on the route with no split, a falling loss, its kernels
     and no others, no plain version, a first loss within
     ``FIRST_LOSS_RTOL`` of one device's, and its ``Train (ms)``, ``Prep.
     (ms)`` and ``torch.cuda.max_memory_allocated()``; then the mesh's epoch
     chain against eager steps (``MESH_CHAIN_RUNS``: Yeast AGNN 2x2);
 18. the distributed streamed route and the chunk fallback, every shard on
     this one card: on reddit at full size (phase 11's dataset, unbalanced),
     a ``DistributedTiledGraph`` over 2x2 takes the streamed route (its
     segments, caps and the device bytes of its layouts and row indexes
     printed) and its ``spmm``, ``spmm_weighted`` (d=16) and ``sddmm``
     (d=32), forward and every gradient, hold against phase 11's
     single-device graph on the card (``rtol=atol=1e-4`` forward, ``1e-3``
     gradients, elementwise), launching K8 and K9 only and no plain
     version; K8 (d=16) and K9 (d=32) timed on its heaviest shard (event and
     device time) beside ``csr_bound`` over the shard's edges and
     ``torch.sparse.mm`` / ``sampled_addmm`` over the shard's CSR; then the
     trainer, ``TRAIN_EPOCHS`` timed epochs, ``--no_dropout``: reddit GCN
     (hidden 16, hoisted) on ``--mesh 4x1`` (K8) and AGNN 2 layers hidden 32
     on ``--mesh 2x2`` (K8 and K9), each replayed (``mesh_run``) on the
     streamed route, with the native host pass, a falling loss, its kernels
     and no others, no plain
     version, a first loss within ``FIRST_LOSS_RTOL`` of one device's (the
     trainer's first step over phase 11's graph with the same parameters),
     and its ``Train (ms)``, ``Prep. (ms)``, ``Prep host (ms)`` by stage,
     peak host RSS and ``torch.cuda.max_memory_allocated()``; last, pubmed
     on the chunk fallback (``dense_tiles=False``) over 4x2: the same ops
     against the single-device graph, K8 and K9 only;
 19. traffic accounting (``tcgnn_tpu_torch.bench``'s ``measure_comm``,
     ``partition_stats`` and ``scaling``), every shard on this one card:
     ``measure_comm.measure`` (one 2-layer GCN training step, no hoist,
     128x128 tiles, its collectives counted) on pubmed, amazon0601 and
     soc-BlogCatalog over 4 and 8 shards (K1) and reddit over 4 (the
     streamed route, K8; phase 11's graph, not synthesized again), each
     row's bytes by kind, boundary rows, modeled
     and ideal bytes equal to the JAX package's committed row
     (``results/comm_measured.csv``), its ratio 1.000, its kernel launched
     and no other, no plain version, and the counted step's wall ms printed;
     ``partition_stats`` on pubmed and amazon0601 over 2, 4 and 8 shards
     with the H100 data-sheet rates (each shard's edges summing to the
     graph's); ``scaling`` on its default graph (``rand_20000_100000``, GCN
     hidden 16, 10 epochs) over 1, 2, 4 and 8 shards (K1 only; each size's
     step captured in its warm-up and its timed epochs replays, the launches
     read on the card and held to the replays, ``check_replays``): epoch
     ms, edges/s and efficiency printed;
 20. the headline bench (``tcgnn_tpu_torch.bench.headline``, the port's
     ``bench.py``) at its full schedule: pubmed GCN in bf16, no hoist and
     hoisted, 200x3 epochs, and the 4-layer hidden-32 AGNN datum, 50x3.  Its
     JSON line, printed, must have ``bench.py``'s keys in their order (read
     from that file with ``ast``) and ``dtype`` last, ``backend`` cuda,
     ``dtype`` bfloat16, ``tc_blocks`` 334, positive finite times and a
     number for the AGNN datum; it must launch K1, K2 and K3 and no other
     kernel, and no plain version, and each of its three measures
     (``HEADLINE_STEPS``) must have captured its step once (its reps are
     replays, as ``bench.py``'s are ``step.many``) and the card must have
     run every replayed epoch's launches (``check_replays``);
 21. the mesh over processes (``torch.distributed``): 2 ranks split the
     graph axis, over NCCL one a card where the machine has two cards, else
     (it is printed) over gloo on this one card, every transfer staged
     through host memory.  Each rank runs ``train.main`` with ``--no_dropout``
     and ``TRAIN_EPOCHS`` timed epochs (reddit's run in 2 ranks of its own,
     beside the others): pubmed GCN ``--mesh 4x1`` at full
     width (K1, the split stream's ``all_to_all``, the halo's ``ppermute``),
     pubmed AGNN ``--mesh 4x1`` (K2/K3) and ``4x2`` (K4 tiles, K10), Yeast
     GCN and AGNN ``--mesh 4x1`` (K5, K6/K7, the rim ``ppermute``), reddit GCN
     ``--mesh 4x1`` at its published widths (K8, the all-gather), and phase
     13b's soc-BlogCatalog GCN and asymmetric AGNN over ``--mesh 2x1`` (the
     overlap classes, the local class enqueued while the halo's transfers
     are in flight).  Each run's first loss within ``FIRST_LOSS_RTOL`` and
     final loss within ``FINAL_LOSS_RTOL`` of the one-process mesh run
     (phases 13, 13b, 17 and 18; the pubmed 4x1 runs in this phase, all
     replayed); every rank's step is eager (gloo stages every transfer
     through host memory, which a CUDA graph cannot hold) and launches the
     one-process run's kernels and no other, no plain version, and each
     kernel's launches over the ranks (the wrappers') sum to the
     one-process run's (the card's).  Each rank's ``Train (ms)`` and
     ``torch.cuda.max_memory_allocated()`` are printed; then the overlap
     evidence: rank 0's ``torch.profiler`` trace of a few soc-BlogCatalog
     steps, the host's time waiting on the exchanges a step and the device
     time of K1 inside those waits (the local class's), compared with
     nothing; then one ``torchrun`` CLI run's (pubmed GCN ``--mesh 4x1``; on
     one card a gloo-on-one-card figure, not a multi-card one);
 22. the feature axis over processes, one feature shard a rank (the
     column-parallel dense side, the feature-axis sums across ranks), over
     gloo on this one card unless the machine has a card a rank (then
     NCCL): 4 ranks over ``--mesh 2x2`` (two graph blocks of two feature
     shards) train pubmed GCN (K1), pubmed AGNN (K4 tiles, K10) and Yeast
     AGNN (K4 cell scores, K5), 2 ranks over ``--mesh 1x2`` reddit AGNN at
     its published widths (K8, K9), each with ``--no_dropout`` and
     ``TRAIN_EPOCHS`` timed epochs (the AGNN runs ``SPLIT_AGNN_EPOCHS``),
     held to the one-process mesh run of the same shape and depth (run in
     this phase, replayed; pubmed over two graph shards is unsplit after the
     balance, so its GCN's SpMMs take the overlap classes) as phase 21 holds
     its runs (losses, kernels, launches summed over the ranks); each rank's
     ``Train (ms)``, ``max_memory_allocated``, peak host RSS and launches
     are printed.  Two more ranks, beside them, run ``--single_kernel``
     on pubmed ``--mesh 1x2`` and ``2x2`` (K1, K4; every rank reports the
     slowest rank's stats) and ``measure_comm`` on pubmed over 4 and 8
     shards (every rank's rows equal, each against
     ``results/comm_measured.csv``); then one ``torchrun`` CLI run of pubmed
     AGNN ``--mesh 2x2`` over 4 processes.

The kernels line's launches are summed over every run of phases 11, 13, 13b,
14, 15, 16, 17, 18, 19, 20, 21 and 22 (every rank's), each read with the counts
set to 0 just before it: where a run replays a CUDA graph (phases 11, 13, 13b,
15, 16, 17, 18, 19's ``scaling``, 20, and the one-process runs of 21 and 22)
the launches the card ran, from a profiler trace of the run
(``device_launches``), else the wrappers' counts (eager launches, which the
card runs one for one: ``--single_kernel``, ``measure_comm``'s counted step,
the ranks over processes).  The NLL pair's launches are phase 11's, read
on the card.  Every bound of K1-K10
is ``tcgnn_tpu_torch.bench.roofline_bound``'s ``csr_bound``.

Every phase prints its elapsed seconds.  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import contextlib
import copy
import csv
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tcgnn_tpu_torch import TileConfig, TiledGraph, train
from tcgnn_tpu_torch.bench import (
    accuracy_parity,
    epoch_ledger,
    headline,
    measure_comm,
    partition_stats,
    scaling,
    sweep,
)
from tcgnn_tpu_torch.bench.baseline import EAGER_IMPLS as EAGER_INCUMBENTS
from tcgnn_tpu_torch.bench.baseline import IMPLS as INCUMBENTS
from tcgnn_tpu_torch.bench.roofline_bound import csr_bound
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph, synthesize
from tcgnn_tpu_torch.data.edge_graphs import asymmetric_graph, banded_graph, write_npz
from tcgnn_tpu_torch.data.synthetic import component_union_graph
from tcgnn_tpu_torch.models import nets
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
    nll_loss,
    nll_loss_torch,
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
from tcgnn_tpu_torch.parallel import (
    DistributedTiledGraph,
    distributed_graph_from_dataset,
    init_distributed_net,
    make_distributed_train_step,
    make_mesh,
)
from tcgnn_tpu_torch.profiling import device_ms as kernel_ms
from tcgnn_tpu_torch.train import CAPTURE_WARMUP, WARMUP_EPOCHS
from tcgnn_tpu_torch.sgt import native
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
# reddit at its published widths (phases 11 and 18).
REDDIT = ["--dataset", "reddit", "--dim", "602", "--classes", "41"]
# The epoch chain against eager steps (phase 11): label, trainer arguments
# ("BANDED" is the banded graph's data directory), and the updates of each
# side before the losses are compared (then as many more are timed).
CHAIN_RUNS = [
    ("pubmed gcn --no_hoist (K1)",
     ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "gcn", "--no_hoist"]),
    ("DD agnn 2 layers (K6/K7, K2/K3)",
     ["--dataset", "DD", "--dim", "89", "--classes", "2", "--model", "agnn", "--hidden", "32"]),
    ("banded agnn 2 layers (K4, weighted K5 and K1, index_add_)",
     ["--data_dir", "BANDED", "--dataset", "banded", "--dim", "64", "--model", "agnn",
      "--hidden", "32"]),
]
CHAIN_EPOCHS = 30
# A resumed run's final loss against an uninterrupted run's: K1 adds the
# parts of a split window's rows (pubmed's hub window) with f32 atomics in
# no fixed order, as K2/K3 and K8 add rows cut between ranges, so the last
# bits vary from run to run and only a tolerance is promised on the card.
RESUME_RTOL = 1e-5
# The pubmed AGNN chain's final losses, many against eager: K2/K3 add the
# parts of the hub's rows (degree 17,058, cut between many ranges) with f32
# atomics in no fixed order, and 30 updates of the 2-layer AGNN from its
# huge first loss (about 1e9) magnify those last bits, so two eager runs
# from one state differ too (printed beside; chip_smoke's own runs put
# both spreads near 1e-5).
ATOMICS_CHAIN_RTOL = 1e-4
# The mesh's epoch chain against eager steps (``check_chain``), by phase:
# label, trainer arguments, the final losses' tolerance.
MESH_CHAIN_RUNS = {
    "13": [("pubmed gcn --mesh 4x2 (K1)",
            ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "gcn",
             "--mesh", "4x2"], RESUME_RTOL),
           ("pubmed agnn --mesh 8x1 (K2/K3)",
            ["--dataset", "pubmed", "--dim", "500", "--classes", "3", "--model", "agnn",
             "--hidden", "32", "--num_layers", "2", "--mesh", "8x1"], ATOMICS_CHAIN_RTOL)],
    "17": [("Yeast agnn --mesh 2x2 (K4 cell scores, K5)",
            ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "agnn",
             "--hidden", "32", "--num_layers", "2", "--mesh", "2x2"], RESUME_RTOL)],
}
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
                                   size=(m.num_rows, m.num_src))


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


def host_pass_stages(ds, graph, dev, card) -> dict:
    """Phase 11, after the reddit GCN run: the NumPy host pass over the same
    arrays (a ``TiledGraph(..., host_pass="numpy")``), its ``Prep host
    (ms)`` stage by stage beside the native run's; the two graphs must
    upload the same chunk layouts' row indexes.  Returns both passes'
    stage milliseconds."""
    t0 = time.perf_counter()
    g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, graph.config, device=dev,
                   host_pass="numpy")
    run_s = time.perf_counter() - t0
    if (g.host_pass, g.streamed, g.tc_blocks) != ("numpy", graph.streamed, graph.tc_blocks):
        raise AssertionError(f"NumPy pass: {g.host_pass} streamed {g.streamed} TC blocks "
                             f"{g.tc_blocks}, the native one {graph.streamed} {graph.tc_blocks}")
    for a, b in ((g.chunks, graph.chunks), (g.chunks_t, graph.chunks_t)):
        if not (torch.equal(a.row_ptr, b.row_ptr) and torch.equal(a.row_src, b.row_src)):
            raise AssertionError("the NumPy and native passes uploaded other row indexes")
    passes = {"native": graph, "numpy": g}
    stages = {name: {k: v * 1e3 for k, v in p.prep_stages.items()} for name, p in passes.items()}
    for name, p in passes.items():
        stages[name]["other"] = p.prep_host_s * 1e3 - sum(stages[name].values())
        stages[name]["Prep host"] = p.prep_host_s * 1e3
    print(f"reddit Prep host (ms) by stage, native pass (the GCN run) and NumPy pass (the same "
          f"arrays, this call; its graph built in {run_s:.1f} s, the same row indexes) "
          f"(card host: {card}):")
    for k in stages["numpy"]:
        nat, num = stages["native"].get(k, 0.0), stages["numpy"][k]
        print(f"  {k:12s} native {nat:12.3f}  numpy {num:12.3f}  "
              f"({num / nat if nat > 0 else float('nan'):.2f}x)")
    del g
    torch.cuda.empty_cache()
    return stages


def phase_train(data_dir, dev, card) -> tuple:
    """Phase 11: the main path, through the trainer's entry point.  Every
    count is set to 0 just before each run and read just after it; returns
    the runs, each kernel's launches summed over them, the errors and
    records of ``check_reddit_kernels`` and the stages of
    ``host_pass_stages``, run on the reddit GCN run's graph once its counts
    are read, and that graph with its features and dataset (phase 14 times
    them; phase 18 holds the mesh to them)."""
    asym = write_npz(data_dir, "asymmetric", asymmetric_graph)
    banded = write_npz(data_dir, "banded", banded_graph)
    pubmed = ["--dataset", "pubmed", "--dim", "500", "--classes", "3"]
    dd = ["--dataset", "DD", "--dim", "89", "--classes", "2"]
    agnn = ["--model", "agnn", "--hidden", "32"]
    condensed, bd, streamed = (True, False, False), (True, False, True), (False, True, False)
    # label, arguments, the launches of one epoch (the kernels the run must
    # launch; every other kernel of K1-K10 must not), loss must fall, route
    # (dense_tiles, streamed, block_diag), TC blocks (None: not checked)
    runs = [
        ("gcn --no_hoist", [*pubmed, "--model", "gcn", "--no_hoist"], {"K1": 4}, True,
         condensed, 334),
        ("gcn", [*pubmed, "--model", "gcn"], {"K1": 2}, True, condensed, 334),
        ("gin", [*pubmed, "--model", "gin"], {"K1": 2}, True, condensed, 334),
        ("agnn 2 layers", [*pubmed, *agnn, "--num_layers", "2"], {"K2": 2, "K3": 2}, True,
         condensed, 334),
        ("agnn 4 layers", [*pubmed, *agnn, "--num_layers", "4"], {"K2": 4, "K3": 4}, False,
         condensed, 334),
        ("agnn 2 layers, asymmetric graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", asym, "--dim", "64"],
         {"K1": 8, "K4": 4}, True, condensed, None),
        ("DD gcn --no_hoist", [*dd, "--model", "gcn", "--no_hoist"], {"K5": 4, "K1": 4}, True,
         bd, None),
        ("DD gcn", [*dd, "--model", "gcn"], {"K5": 2, "K1": 2}, True, bd, None),
        ("DD gin", [*dd, "--model", "gin"], {"K5": 2, "K1": 2}, True, bd, None),
        ("DD agnn 2 layers", [*dd, *agnn, "--num_layers", "2"],
         {"K6": 2, "K7": 2, "K2": 2, "K3": 2}, True, bd, None),
        ("DD agnn 4 layers", [*dd, *agnn, "--num_layers", "4"],
         {"K6": 4, "K7": 4, "K2": 4, "K3": 4}, False, bd, None),
        ("DD gcn --reorder rcm", [*dd, "--model", "gcn", "--reorder", "rcm"],
         {"K5": 2, "K1": 2}, True, bd, None),
        ("Yeast gcn", ["--dataset", "Yeast", "--dim", "74", "--classes", "2", "--model", "gcn"],
         {"K5": 2}, True, bd, None),
        ("agnn 2 layers, banded graph",
         [*agnn, "--num_layers", "2", "--data_dir", data_dir, "--dataset", banded, "--dim", "64"],
         {"K5": 8, "K4": 4, "K1": 8}, True, bd, None),
        ("reddit gcn", [*REDDIT, "--model", "gcn"], {"K8": 2}, True, streamed, 265_565),
        ("reddit agnn 2 layers", [*REDDIT, *agnn, "--num_layers", "2"], {"K8": 8, "K9": 4},
         True, streamed, 265_565),
    ]
    results, launches = [], {k: 0 for k in (*KERNELS, "NLL")}
    reddit_errs, reddit_records, stages, reddit_graph = {}, {}, {}, None
    for label, extra, per_epoch, must_fall, route, tc_blocks in runs:
        print(f"--- train.main {' '.join(extra)}")
        t0 = time.perf_counter()
        args = ["--device", "cuda", "--epochs", str(TRAIN_EPOCHS), *extra]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        nll_ran = {"NLL": 0}
        with device_launches(nll_ran) as ran:
            r = run_main(args)
        counts = launch_counts()
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        r["peak_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        r["seconds"] = time.perf_counter() - t0
        print(f"  route {(r['dense_tiles'], r['streamed'], r['block_diag'])}  first loss "
              f"{r['first_loss']:.6f}  final loss {r['final_loss']:.6f}  "
              + "  ".join(f"{k} launches {c[0]} (on the card {ran[k]}) plain calls {c[1]}"
                          for k, c in counts.items()))
        if must_fall and not (math.isfinite(r["final_loss"])
                              and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall "
                                 f"({r['first_loss']} -> {r['final_loss']})")
        check_launches(label, counts, per_epoch)
        check_launches(f"{label} (on the card)", on_card(ran), per_epoch)
        check_replays(label, counts, ran, [r["captures"]],
                      [(WARMUP_EPOCHS + TRAIN_EPOCHS, per_epoch)])
        check_nll_launches(label, nll_loss.launches, nll_ran["NLL"],
                           WARMUP_EPOCHS + TRAIN_EPOCHS)
        launches["NLL"] += nll_ran["NLL"]
        r["step_launches"] = per_epoch
        print(f"  captured once in {r['capture_s']:.3f} s; launches an epoch "
              + "  ".join(f"{k} {c}" for k, c in per_epoch.items()))
        if (r["dense_tiles"], r["streamed"], r["block_diag"]) != route:
            raise AssertionError(f"{label}: route {(r['dense_tiles'], r['streamed'], r['block_diag'])}"
                                 f", expected {route}")
        if tc_blocks is not None and r["tc_blocks"] != tc_blocks:
            raise AssertionError(f"{label}: {r['tc_blocks']} TC blocks, expected {tc_blocks}")
        for k, c in ran.items():
            launches[k] += c
        graph, ds = r.pop("graph"), r.pop("dataset")
        if label == "reddit gcn":
            t1 = time.perf_counter()
            reddit_errs, reddit_records = check_reddit_kernels(graph, dev, card)
            print(f"  reddit kernel checks done in {time.perf_counter() - t1:.1f} s")
            stages = host_pass_stages(ds, graph, dev, card)
            reddit_graph = (graph, torch.from_numpy(ds.x).to(dev), ds)
        del graph, ds
        results.append((label, r))
        torch.cuda.empty_cache()
    for label, argv in CHAIN_RUNS:
        chain_against_eager(label, [data_dir if a == "BANDED" else a for a in argv], dev, card)
        torch.cuda.empty_cache()
    return results, launches, reddit_errs, reddit_records, stages, reddit_graph


# A kernel's name in a profiler trace (``void (anonymous namespace)::
# spmm_dense_kernel<float, signed char, float, false>(...)``): the function
# and its template arguments.
TRACED_KERNEL = re.compile(r"::(\w+)<([^<>]*)>\(")
# The function each of K2-K9 launches, one a wrapper call; K1 and K10 are
# both ``spmm_dense_kernel``, K10 the scored one (its last template
# argument ``true``).
TRACED_NAMES = {"sfused_kernel": "K2", "sfused_bwd_kernel": "K3", "sddmm_edge_kernel": "K4",
                "spmm_bd_kernel": "K5", "bd_sfused_kernel": "K6",
                "bd_sfused_bwd_kernel": "K7", "spmm_csr_kernel": "K8",
                "sddmm_csr_kernel": "K9"}
# The NLL loss's pair (``csrc/nll.cu``), not templated.
TRACED_NLL = re.compile(r"::nll_(forward|backward)_kernel\(")


# A ``device_launches`` trace drops device operations at its ends: past its
# window's end, where their time converted to the host's clock falls
# outside it, and, once a process has run phase 11, the first few of a
# trace (the first step's forward, in every other trace of one step; an
# H100, torch 2.11; once, all of 256 pads at one end of a trace).  So each
# end holds ``TRACE_PADS`` spin kernels (``torch.cuda._sleep``), then an
# idle ``TRACE_MARGIN_S``, and a trace whose first or last device
# operation is not a pad may have lost operations of the block: it raises.
TRACE_PADS = 1024
TRACE_MARGIN_S = 0.1


def traced_kernel(name) -> str | None:
    """Which of K1-K10 a device operation of a profiler trace is, or None."""
    m = TRACED_KERNEL.search(name)
    if m is None:
        return None
    if m.group(1) == "spmm_dense_kernel":
        return "K10" if m.group(2).rsplit(",", 1)[-1].strip() == "true" else "K1"
    return TRACED_NAMES.get(m.group(1))


@contextlib.contextmanager
def device_launches(nll=None):
    """Traces the block's device activity with ``torch.profiler`` and
    yields a dict that holds, once the block has ended, each kernel's
    launches that the card ran in it: the replays of a captured CUDA graph
    too, where no wrapper runs.  ``nll``, a dict, takes the NLL pair's
    launches under ``"NLL"``.  The block must not start a profiler of its
    own (``--single_kernel`` does)."""
    ran = dict.fromkeys(KERNELS, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pad_trace()
        yield ran
        pad_trace()
    # The trace's raw events: ``prof.events()`` would build the whole event
    # tree first, some seconds for the headline's tens of thousands.
    pads, ends = 0, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            pad = "spin_kernel" in e.name()
            ends = sorted(ends + [(e.start_ns(), pad)])
            ends = ends[:1] + ends[-1:]
            if pad:
                pads += 1
            elif (k := traced_kernel(e.name())) is not None:
                ran[k] += 1
            elif nll is not None and TRACED_NLL.search(e.name()):
                nll["NLL"] += 1
    if not (ends and ends[0][1] and ends[-1][1]):
        raise AssertionError(f"device_launches: the trace's first or last device operation is "
                             f"not a pad kernel (it kept {pads} of its {2 * TRACE_PADS}), so it "
                             "may have lost operations of the block")


def pad_trace() -> None:
    """``TRACE_PADS`` spin kernels, then ``TRACE_MARGIN_S`` of idle card."""
    for _ in range(TRACE_PADS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(TRACE_MARGIN_S)


def on_card(ran) -> dict:
    """``device_launches``' counts as ``launch_counts`` gives the
    wrappers': (launches, plain calls), no plain call on the card."""
    return {k: (n, 0) for k, n in ran.items()}


def check_replays(label, counts, ran, captures, steps, eager=CAPTURE_WARMUP) -> None:
    """Raise unless each of ``steps`` (its epochs and the launches of one
    epoch) captured its step once and the card ran, beyond what the
    wrappers launched (``counts``), each kernel's launches an epoch once for
    every epoch but ``eager`` + 1 of each step.  Both sides count the
    launches outside the step (the hoisted aggregate) and the eager warm-up
    steps' (``eager`` of each step, ``CAPTURE_WARMUP`` unless its first
    ``many`` was shorter); the wrappers count one step's more at the
    capture, which runs nothing, and the card the replays', which no
    wrapper sees."""
    want = {k: sum((epochs - eager - 1) * per_epoch.get(k, 0)
                   for epochs, per_epoch in steps) for k in KERNELS}
    got = {k: ran[k] - counts[k][0] for k in KERNELS}
    if captures != [1] * len(steps) or got != want:
        raise AssertionError(f"{label}: captures {captures} (one a step expected); the card "
                             f"ran {got} launches more than the wrappers counted, expected "
                             f"{want}")


@contextlib.contextmanager
def capture_launches():
    """Yields a list that holds, once the block has ended, each kernel's
    launches that every ``train.TrainStep`` capture in it recorded: one
    epoch's, what each replay of that step runs (the wrappers' counts
    around the capture, which runs nothing)."""
    captured, capture = [], train.TrainStep._capture

    def counted(step):
        before = launch_counts()
        capture(step)
        captured.append({k: c[0] - before[k][0] for k, c in launch_counts().items()
                         if c[0] > before[k][0]})

    train.TrainStep._capture = counted
    try:
        yield captured
    finally:
        train.TrainStep._capture = capture


def mesh_run(label, argv, expected, card) -> dict:
    """A one-process mesh run through ``train.main`` (``--device cuda
    --epochs TRAIN_EPOCHS``, then ``argv``), every count set to 0 just
    before it and read just after: its kernels ``expected`` launched and no
    other, by its wrappers and on the card (``device_launches``), no plain
    version; its step captured once, and the card's launches the wrappers'
    plus every replay's (``check_replays``, one epoch's launches as the
    capture recorded them, ``capture_launches``).  The result gains
    ``counts``, the card's launches as ``launch_counts`` gives the
    wrappers' (phases 21 and 22 hold their ranks' eager launches to them),
    ``step_launches``, ``max_memory_allocated`` and ``seconds``."""
    t0 = time.perf_counter()
    argv = ["--device", "cuda", "--epochs", str(TRAIN_EPOCHS), *argv]
    epochs = WARMUP_EPOCHS + train.build_argparser().parse_args(argv).epochs
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with device_launches() as ran, capture_launches() as captured:
        r = run_main(argv)
    counts = launch_counts()
    r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    r["seconds"] = time.perf_counter() - t0
    check_launches(label, counts, expected)
    check_launches(f"{label} (on the card)", on_card(ran), expected)
    check_replays(label, counts, ran, [r["captures"]],
                  [(epochs, per_epoch) for per_epoch in captured] or [(epochs, {})])
    r["counts"], r["step_launches"] = on_card(ran), captured[0]
    print(f"  {label}: captured once in {r['capture_s']:.3f} s, replayed "
          f"{epochs - CAPTURE_WARMUP} times; launches an epoch "
          + " ".join(f"{k} {c}" for k, c in captured[0].items())
          + "; on the card " + " ".join(f"{k} {n}" for k, n in ran.items() if n)
          + " (the wrappers counted " + " ".join(f"{k} {c[0]}" for k, c in counts.items()
                                                 if c[0]) + f")  (card: {card})")
    return r


def chain_against_eager(label, argv, dev, card) -> None:
    """The one-device epoch chain against eager steps (``check_chain``) on
    the trainer's graph of ``argv``."""
    t0 = time.perf_counter()
    args = train.build_argparser().parse_args(["--device", "cuda", *argv])
    ds = train.load_dataset(args)
    graph = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, train.make_config(args),
                       device=dev, weighted_traffic=args.model == "agnn")
    x = torch.from_numpy(ds.x).to(dev)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(dev)

    def made():
        net = nets.init_net(torch.Generator().manual_seed(args.seed), args.model,
                            ds.num_features, args.hidden, ds.num_classes, args.num_layers,
                            device=dev)
        return train.make_train_step(
            graph, net, x, y, train.make_optimizer(net.parameters(), args.lr, dev), 0.5,
            hoist=not args.no_hoist, generator=torch.Generator(device=dev).manual_seed(
                args.seed + 1))

    check_chain(label, made, card, t0)


def mesh_chain_against_eager(label, argv, dev, card, rtol) -> None:
    """The mesh's epoch chain against eager steps (``check_chain``): the
    trainer's mesh of ``argv`` (``--mesh GxF``, balanced as the trainer
    balances), every shard on this card, its step
    ``make_distributed_train_step``'s."""
    t0 = time.perf_counter()
    args = train.build_argparser().parse_args(["--device", "cuda", *argv])
    ds = train.load_dataset(args)
    graph = distributed_graph_from_dataset(
        ds, make_mesh(*(int(v) for v in args.mesh.split("x")), dev), train.make_config(args))
    x = graph.shard_features(ds.x)
    y = graph.shard_nodes(ds.y.astype(np.int64))

    def made():
        net, _, _ = init_distributed_net(torch.Generator().manual_seed(args.seed), args.model,
                                         ds.num_features, args.hidden, ds.num_classes,
                                         args.num_layers, graph)
        return make_distributed_train_step(
            graph, net, x, y, train.make_optimizer(net.parameters(), args.lr, dev), 0.5,
            num_valid_classes=ds.num_classes, hoist=not args.no_hoist,
            generator=torch.Generator(device=dev).manual_seed(args.seed + 1))

    print(f"  {label}: {graph.route}")
    check_chain(label, made, card, t0, rtol)


def check_chain(label, made, card, t0, rtol=RESUME_RTOL) -> None:
    """Two steps of one model from ``made()`` (the same parameters and
    dropout generator, dropout 0.5): ``CHAIN_EPOCHS`` eager steps against
    ``step.many(CHAIN_EPOCHS)`` (its warm-up steps, the capture, the
    replays), the final losses within ``rtol`` (the atomics' last bits),
    and the launches the card ran (``device_launches``) equal on both sides
    and to what the eager steps' wrappers counted; a third step's
    ``CHAIN_EPOCHS`` eager steps give the eager steps' own spread, printed
    beside; then ``CHAIN_EPOCHS`` more of the first two, timed."""
    def eager_epochs(step):
        for _ in range(CHAIN_EPOCHS):
            loss = step()
        return loss

    eager, chained = made(), made()
    reset_counts()
    with device_launches() as ran_eager:
        want = eager_epochs(eager)
    counted = {k: c[0] for k, c in launch_counts().items()}
    with device_launches() as ran_chained:
        got = chained.many(CHAIN_EPOCHS)
    a, b = float(got), float(want)
    rel = abs(a - b) / abs(b)
    again = float(eager_epochs(made()))

    def ms_an_epoch(run) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss = run()
        float(loss)
        return (time.perf_counter() - start) * 1e3 / CHAIN_EPOCHS

    eager_ms = ms_an_epoch(lambda: eager_epochs(eager))
    replay_ms = ms_an_epoch(lambda: chained.many(CHAIN_EPOCHS))
    print(f"chain against eager [{label}]: final loss after {CHAIN_EPOCHS} updates, many "
          f"{a:.9g} against eager {b:.9g}: relative difference {rel:.3e} (rtol {rtol}), "
          f"bit-equal {a == b}; a second eager run {again:.9g}: relative difference "
          f"{abs(again - b) / abs(b):.3e}; the card ran, on each side, "
          + " ".join(f"{k} {n}" for k, n in ran_chained.items() if n)
          + f"; captured once in {chained.capture_s:.3f} s; ms an epoch over "
          f"{CHAIN_EPOCHS} more: eager {eager_ms:.4f}, replayed {replay_ms:.4f}  (card: {card}; "
          f"{time.perf_counter() - t0:.1f} s)")
    if chained.captures != 1 or not rel <= rtol:
        raise AssertionError(f"{label}: step.many does not make the eager steps' updates")
    if not any(ran_eager.values()) or ran_eager != counted or ran_chained != ran_eager:
        raise AssertionError(f"{label}: the card ran {ran_eager} launches in the eager steps "
                             f"(their wrappers counted {counted}) and {ran_chained} in "
                             "step.many; all three must agree")


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
          f"(unsplit capacity {g.host_fwd.a_tiles.shape[1]}), guest_cap {sp.guest_cap}, "
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
        r = mesh_run(label, extra, expected, card)
        counts = r["counts"]
        print(f"  {r['route']}  first loss {r['first_loss']:.6f}  final loss "
              f"{r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  "
              + "  ".join(f"{k} launches {c[0]}" for k, c in counts.items() if c[0]))
        if not (math.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall ({r['first_loss']} -> "
                                 f"{r['final_loss']})")
        if r["split"] != (True, True) or r["tc_blocks"] != 334:
            raise AssertionError(f"{label}: split {r['split']}, {r['tc_blocks']} TC blocks; "
                                 "expected the split stream both ways and 334")
        for k, c in counts.items():
            launches[k] += c[0]
        del r["graph"]
        single = run_main(["--device", "cuda", "--epochs", "1", *pubmed, *model])
        rel = abs(r["first_loss"] - single["first_loss"]) / abs(single["first_loss"])
        print(f"  first loss {r['first_loss']:.6f} vs one device {single['first_loss']:.6f}: "
              f"relative difference {rel:.3e} (rtol {FIRST_LOSS_RTOL})")
        if not rel <= FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first loss {r['first_loss']} vs one device "
                                 f"{single['first_loss']}")
        del single["graph"], single["dataset"]
        results.append((label, r))
        torch.cuda.empty_cache()
    for label, argv, rtol in MESH_CHAIN_RUNS["13"]:
        mesh_chain_against_eager(label, argv, dev, card, rtol)
        torch.cuda.empty_cache()
    return results, launches


# ---- the halo-overlap split (phase 13b) -------------------------------------------

# soc-BlogCatalog at its AE row's widths: both directions unsplit over 2x1,
# so every SpMM takes the overlap classes.
SOC = ["--dataset", "soc-BlogCatalog", "--dim", "128", "--classes", "39"]
# The op check's width (AGNN's hidden width) and the kernels each op's
# forward and backward launch on a 2x1 mesh with both directions unsplit: K1
# once a class a shard in each SpMM pass, K4 once a class a shard in each
# SDDMM.
OVERLAP_D = 32
OVERLAP_OPS = {"spmm": {"K1": 8}, "spmm_weighted": {"K1": 8, "K4": 4},
               "sddmm": {"K1": 8, "K4": 4}}
# Timed epochs of rank 0's traced soc-BlogCatalog run (after the trainer's
# 9 warm-ups).
OVERLAP_TRACE_EPOCHS = 3
HALO_WAIT = "halo exchange wait"


def overlap_runs(data_dir) -> list:
    """The overlap split's trainer runs (one process in phase 13b, two
    ranks in phase 21), ``--no_dropout``, ``TRAIN_EPOCHS``: label,
    arguments, kernels, each direction's split, the single-device
    arguments its first loss is held to.  soc-BlogCatalog GCN without hoist
    (every SpMM through the classes) and the asymmetric graph's AGNN
    (``data_dir``; its forward unsplit: the SDDMM and the forward weighted
    SpMM through the classes, the transpose's split stream)."""
    gcn = [*SOC, *MESH_GCN, "--no_hoist"]
    agnn = ["--data_dir", data_dir, "--dataset", "asymmetric", "--dim", "64", *MESH_AGNN]
    return [("soc-BlogCatalog gcn --mesh 2x1 --no_hoist", [*gcn, "--mesh", "2x1"], ("K1",),
             (False, False), gcn),
            ("asymmetric agnn --mesh 2x1", [*agnn, "--mesh", "2x1"], ("K1", "K4"),
             (False, True), agnn)]


def class_bytes(g) -> tuple[int, int]:
    """The device bytes of the overlap classes (tiles and window and edge
    arrays, both directions) and of the unsplit streams beside them (the
    forward's, where the fused AGNN reads them)."""
    def size(st):
        m = st.meta
        arrays = [st.tiles, m.col_ids, m.block_window, m.win_start, m.run_window, m.run_block,
                  m.edge_pos, m.edge_rows, m.edge_cols] + ([st.edges] if st.edges is not None
                                                            else [])
        return sum(a.numel() * a.element_size() for a in arrays)

    dirs = (g._fwd, g._bwd)
    return (sum(size(st) for dn in dirs for st in dn.local + dn.remote),
            sum(size(st) for dn in dirs for st in dn.streams))


def phase_overlap_ops(dev) -> None:
    """Phase 13b, ops: the asymmetric graph over a 2x1 mesh on the card with
    ``split=False``, so every dense op takes the overlap classes, the
    weighted transpose too: ``spmm``, ``spmm_weighted`` and ``sddmm``,
    forward and every gradient, against the single-device ``TiledGraph``'s
    (f32, d=32, ``MESH_FWD`` and ``MESH_GRAD``); each op launches K1 (K4)
    once a class a shard in every pass (``OVERLAP_OPS``) and no plain
    version."""
    n, rp, ci = asymmetric_graph()
    e = len(ci)
    x, w = randn((n, OVERLAP_D), 190, dev) * 0.3, randn((e,), 191, dev)
    cot = {op: randn((e,) if op == "sddmm" else (n, OVERLAP_D), 192, dev) for op in OVERLAP_OPS}
    one = TiledGraph(rp, ci, n, device=dev)
    want = {op: mesh_op(one, op, x, w, None, cot[op], False) for op in OVERLAP_OPS}
    del one
    g = DistributedTiledGraph(rp, ci, n, mesh=make_mesh(2, 1, dev), split=False)
    if not (g.use_overlap and g.host_fwd.split is None and g.host_bwd.split is None):
        raise AssertionError(f"asymmetric 2x1 split=False: {g.route}, use_overlap "
                             f"{g.use_overlap}")
    for op, expected in OVERLAP_OPS.items():
        reset_counts()
        got = mesh_op(g, op, x, w, None, cot[op], True)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(f"asymmetric 2x1 overlap {op}", counts, tuple(expected))
        if any(counts[k][0] != c for k, c in expected.items()):
            raise AssertionError(f"asymmetric 2x1 overlap {op}: launches {counts}, expected "
                                 f"{expected} (once a class a shard a pass)")
        for part, a in got.items():
            b = want[op][part]
            compare(f"asymmetric 2x1 overlap {op} {part} vs one device", a, b, b.abs(),
                    MESH_FWD if part == "out" else MESH_GRAD)
        print(f"  asymmetric 2x1 overlap {op}: "
              + "  ".join(f"{k} launches {counts[k][0]}" for k in expected))
    local, unsplit = class_bytes(g)
    print(f"asymmetric 2x1 split=False: {g.route}; classes {local / 2**20:.2f} MiB beside the "
          f"unsplit streams' {unsplit / 2**20:.2f} MiB")
    del g
    torch.cuda.empty_cache()


def phase_overlap_train(data_dir, dev, card) -> tuple[list, dict]:
    """Phase 13b, the path: ``overlap_runs`` through the trainer in one
    process, every count set to 0 just before each run and read just after:
    ``use_overlap``, each direction's split as expected, a falling loss, its
    kernels and no others, no plain version, and a first loss within
    ``FIRST_LOSS_RTOL`` of the single-device run's; its ``Train (ms)``,
    ``max_memory_allocated`` and the device bytes of its classes beside the
    unsplit streams'.  Returns the runs (with their counts: phase 21 holds
    its ranks to them) and each kernel's launches summed over them."""
    results, launches = [], {k: 0 for k in KERNELS}
    for label, argv, expected, split, single_argv in overlap_runs(data_dir):
        print(f"--- train.main {' '.join(argv)}")
        r = mesh_run(label, ["--no_dropout", *argv], expected, card)
        counts = r["counts"]
        g = r.pop("graph")
        local, unsplit = class_bytes(g)
        print(f"  {r['route']}  first loss {r['first_loss']:.6f}  final loss "
              f"{r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  max_memory_allocated "
              f"{r['max_memory_allocated'] / 2**30:.2f} GiB, of which the classes "
              f"{local / 2**30:.3f} GiB (the unsplit streams {unsplit / 2**30:.3f} GiB)  "
              + "  ".join(f"{k} launches {c[0]}" for k, c in counts.items() if c[0])
              + f"  (card: {card})")
        if not (g.use_overlap and "overlap=True" in r["route"] and r["split"] == split):
            raise AssertionError(f"{label}: {r['route']}, use_overlap {g.use_overlap}, split "
                                 f"{r['split']}; expected the classes and split {split}")
        del g
        if not (math.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall ({r['first_loss']} -> "
                                 f"{r['final_loss']})")
        for k, c in counts.items():
            launches[k] += c[0]
        torch.cuda.empty_cache()
        single = run_main(["--device", "cuda", "--epochs", "1", "--no_dropout", *single_argv])
        rel = abs(r["first_loss"] - single["first_loss"]) / abs(single["first_loss"])
        print(f"  first loss {r['first_loss']:.6f} vs one device {single['first_loss']:.6f}: "
              f"relative difference {rel:.3e} (rtol {FIRST_LOSS_RTOL})")
        if not rel <= FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first loss {r['first_loss']} vs one device "
                                 f"{single['first_loss']}")
        del single
        results.append((label, r))
        torch.cuda.empty_cache()
    return results, launches


def overlap_trace(device, argv, out_dir, rank) -> dict:
    """A rank's soc-BlogCatalog run with ``OVERLAP_TRACE_EPOCHS`` timed
    epochs under ``torch.profiler`` (rank 0 traces, ``--profile_dir``), a
    ``record_function`` range around each wait on an exchange (the
    outermost ``collectives.Started.wait``).  Rank 0 reads its trace: the
    host's time in those waits a step, and the device time of K1 inside
    them (the local class's: the remote class is enqueued after the wait)
    and in all a step."""
    from tcgnn_tpu_torch.parallel import collectives

    prof_dir = os.path.join(out_dir, f"trace_rank{rank}")
    wait, depth = collectives.Started.wait, [0]

    def ranged(self):
        if depth[0]:
            return wait(self)
        depth[0] += 1
        try:
            with torch.profiler.record_function(HALO_WAIT):
                return wait(self)
        finally:
            depth[0] -= 1

    collectives.Started.wait = ranged
    try:
        r = train.main(["--device", str(device), "--epochs", str(OVERLAP_TRACE_EPOCHS),
                        "--no_dropout", "--profile_dir", prof_dir, *argv])
    finally:
        collectives.Started.wait = wait
    out = {"route": r["route"], "final_loss": r["final_loss"]}
    if rank:
        return out
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    waits = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == HALO_WAIT]
    k1 = [(e["ts"], e["ts"] + e["dur"]) for e in events
          if e.get("cat") == "kernel" and "spmm_dense_kernel" in e["name"]]
    inside = sum(max(0.0, min(b, wb) - max(a, wa)) for a, b in k1 for wa, wb in waits)
    steps = OVERLAP_TRACE_EPOCHS
    out.update(waits=len(waits) / steps, wait_ms=sum(b - a for a, b in waits) / 1e3 / steps,
               k1_in_wait_ms=inside / 1e3 / steps, k1_ms=sum(b - a for a, b in k1) / 1e3 / steps,
               k1_calls=len(k1) / steps)
    return out


# The keys ``train.main([..., "--single_kernel"])`` returns: the JAX CLI's.
SAG_KEYS = {"ms", "edges_per_s", "useful_tflops", "tile_tflops", "mfu_pct",
            "dispatch_chained_ms", "sddmm_ms", "sddmm_edges_per_s"}
# Rounds of reddit's single-kernel chain (phase 14): at reddit's input
# width (d=602; K8 about 43 ms a call on an H100 at 700 W) the trainer's 200
# took about 25 s; 50 SpMM rounds, 50 dispatch-chained ones and 25 SDDMM
# rounds keep the smoke inside its time.
REDDIT_SAG_ROUNDS = 50
# Rounds of the one-card pubmed 4x2 mesh's chain (phase 14): 200 took about
# 17 s, a mesh round's dispatch included; 50 keep the smoke inside its
# time.
MESH_SAG_ROUNDS = 50


def phase_single_kernel(reddit, dev) -> tuple[list, dict]:
    """Phase 14: the trainer's ``--single_kernel`` (``train.profile_sag``):
    pubmed at 512x128 (K1, K4), DD (K5, K1 for the residual, K4), pubmed on
    ``--mesh 4x2`` (K1, K4, ``MESH_SAG_ROUNDS`` rounds), and reddit:
    ``profile_sag`` over phase 11's reddit GCN graph and features (K8, K9),
    ``REDDIT_SAG_ROUNDS`` rounds.
    Every count is set to 0 just before each run and read just after: each
    run must launch its kernels and no others, and no plain version.
    Returns each run's stats and the launches summed over them."""
    pubmed = ["--dataset", "pubmed", "--dim", "500", "--classes", "3"]
    runs = [  # label, arguments, kernels, rounds (the trainer's, or cut)
        ("pubmed 512x128", pubmed, ("K1", "K4"), train.SAG_ROUNDS),
        ("DD", ["--dataset", "DD", "--dim", "89", "--classes", "2"], ("K5", "K1", "K4"),
         train.SAG_ROUNDS),
        ("pubmed --mesh 4x2", [*pubmed, "--mesh", "4x2"], ("K1", "K4"), MESH_SAG_ROUNDS),
    ]
    results, launches = [], {k: 0 for k in KERNELS}

    def read(label, expected, stats, t0):
        counts = launch_counts()
        check_launches(label, counts, expected)
        for k, c in counts.items():
            launches[k] += c[0]
        print(f"  {label}: SAG {stats['ms']:.4f} ms a round, {stats['edges_per_s']:.4e} edges/s, "
              f"mfu_pct {stats['mfu_pct']:.4f}, dispatch-chained {stats['dispatch_chained_ms']:.4f}"
              f" ms, SDDMM {stats['sddmm_ms']:.4f} ms ({stats['sddmm_edges_per_s']:.4e} edges/s);"
              f" run {time.perf_counter() - t0:.1f} s; "
              + "  ".join(f"{k} launches {c[0]}" for k, c in counts.items() if c[0]))
        results.append((label, stats))

    for label, extra, expected, rounds in runs:
        print(f"--- train.main {' '.join(extra)} --single_kernel  ({rounds} rounds)")
        t0 = time.perf_counter()
        reset_counts()
        trainer_rounds, train.SAG_ROUNDS = train.SAG_ROUNDS, rounds
        try:
            r = run_main(["--device", "cuda", *extra, "--single_kernel"])
        finally:
            train.SAG_ROUNDS = trainer_rounds
        if set(r) != SAG_KEYS:
            raise AssertionError(f"{label}: --single_kernel returned {sorted(r)}")
        read(label, expected, r, t0)
    graph, x, _ = reddit
    print(f"--- train.profile_sag(the reddit GCN run's graph and features, "
          f"num_rounds={REDDIT_SAG_ROUNDS})")
    t0 = time.perf_counter()
    reset_counts()
    sec, stats = train.profile_sag(graph, x, num_rounds=REDDIT_SAG_ROUNDS)
    read("reddit", ("K8", "K9"), {"ms": sec * 1e3, **stats}, t0)
    return results, launches


def phase_checkpoints(dev) -> dict:
    """Phase 15: pubmed GCN with ``--checkpoint_dir`` (every 2 epochs) for
    6 epochs, then ``--resume --epochs 8``, its final loss held to an
    uninterrupted 8-epoch run's (``RESUME_RTOL``; whether the two are
    bit-equal is printed); ``--save_params`` then ``--load_params`` on one
    device and on ``--mesh 4x2``: a run that loads them with learning rate 0
    must save them back bit for bit.  Every run must launch K1 and no other
    kernel, and no plain version; returns the launches."""
    gcn = ["--device", "cuda", "--dataset", "pubmed", "--dim", "500", "--classes", "3",
           "--model", "gcn"]
    launches = {k: 0 for k in KERNELS}

    def run(label, args) -> dict:
        print(f"--- train.main {' '.join(args)}")
        reset_counts()
        with device_launches() as ran:
            r = run_main(args)
        counts = launch_counts()
        check_launches(label, counts, ("K1",))
        check_launches(f"{label} (on the card)", on_card(ran), ("K1",))
        for k, c in ran.items():
            launches[k] += c
        r.pop("graph", None), r.pop("dataset", None)
        torch.cuda.empty_cache()
        return r

    with tempfile.TemporaryDirectory() as d:
        ck = [*gcn, "--checkpoint_dir", os.path.join(d, "ck"), "--checkpoint_every", "2"]
        run("checkpointed, 6 epochs", [*ck, "--epochs", "6"])
        resumed = run("resumed to 8 epochs", [*ck, "--epochs", "8", "--resume"])
        whole = run("uninterrupted, 8 epochs", [*gcn, "--epochs", "8"])
        a, b = resumed["final_loss"], whole["final_loss"]
        rel = abs(a - b) / abs(b)
        print(f"resume: resumed at epoch {resumed['resumed_at']}, final loss {a:.9g} against the "
              f"uninterrupted run's {b:.9g}: relative difference {rel:.3e} (rtol {RESUME_RTOL}), "
              f"bit-equal {a == b}")
        if resumed["resumed_at"] != 6 or not rel <= RESUME_RTOL:
            raise AssertionError("the resumed run does not continue the checkpointed one")
        for tag, extra in (("one device", []), ("--mesh 4x2", ["--mesh", "4x2", "--no_dropout"])):
            saved, again = os.path.join(d, "saved.pt"), os.path.join(d, "again.pt")
            run(f"{tag} --save_params", [*gcn, *extra, "--epochs", "2", "--save_params", saved])
            run(f"{tag} --load_params", [*gcn, *extra, "--epochs", "1", "--lr", "0",
                                         "--load_params", saved, "--save_params", again])
            pa = torch.load(saved, weights_only=True)["params"]
            pb = torch.load(again, weights_only=True)["params"]
            same = pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
            print(f"{tag}: --load_params then learning rate 0 saved back "
                  f"{len(pa)} parameters {'bit for bit' if same else 'CHANGED'}")
            if not same:
                raise AssertionError(f"{tag}: --load_params did not restore every parameter")
    return launches


# ---- the AE harness (``tcgnn_tpu_torch.bench``) -----------------------------

# The GCN sweep's graphs: two condensed (cora, pubmed), two block-diagonal
# (PROTEINS_full, DD) and the largest amazon graph of the reference's table.
AE_GCN_GRAPHS = ("cora", "pubmed", "PROTEINS_full", "DD", "amazon0601")
AE_EPOCHS, AE_BASELINE_EPOCHS = 20, 10
# Routes (dense_tiles, streamed, block_diag) of the sweep's graphs.
AE_ROUTES = {"cora": (True, False, False), "pubmed": (True, False, False),
             "PROTEINS_full": (True, False, True), "DD": (True, False, True),
             "amazon0601": (True, False, False)}


@contextlib.contextmanager
def in_dir(path):
    """Run the body with ``path`` (created) as the working directory."""
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(old)


def check_baseline_step(path, impl) -> None:
    """Raise unless every row of a sweep's ``Fig_6a`` CSV says how its
    incumbent ran on the card: ``eager`` for ``baseline.EAGER_IMPLS``, else
    ``replayed`` (one CUDA graph of its step)."""
    want = "eager" if impl in EAGER_INCUMBENTS else "replayed"
    with open(path) as f:
        got = {r["dataset"]: r["baseline_step"] for r in csv.DictReader(f)}
    if set(got.values()) != {want}:
        raise AssertionError(f"{os.path.basename(path)} ({impl}): baseline_step {got}, "
                             f"expected {want}")
    print(f"  {os.path.basename(path)} ({impl}): every incumbent epoch {want}")


def check_csv(path, names, columns) -> None:
    """Raise unless ``path`` has a row for each of ``names`` whose
    ``columns`` are finite and positive."""
    with open(path) as f:
        rows = {r["dataset"]: r for r in csv.DictReader(f)}
    for name in names:
        if name not in rows:
            raise AssertionError(f"{os.path.basename(path)}: no row for {name}")
        for c in columns:
            v = float(rows[name][c])
            if not (math.isfinite(v) and v > 0):
                raise AssertionError(f"{os.path.basename(path)} {name}: {c} = {v}")
    print(f"  {os.path.basename(path)}: rows of {', '.join(names)} finite and positive")


def check_sweep_routes(label, rows, expected) -> None:
    for name, base, ours, ours_h, route in rows:
        if name in expected and route != expected[name]:
            raise AssertionError(f"{label} {name}: route {route}, expected {expected[name]}")


def phase_ae_harness(out_dir) -> dict:
    """Phase 16: the bench harness through its entry points, on the card.
    ``sweep`` GCN (no-hoist and hoisted, both incumbents) over
    ``AE_GCN_GRAPHS``, AGNN (2 layers, hidden 32) on pubmed and DD, GIN on
    cora, ``--single_kernel`` on cora and DD, ``epoch_ledger`` on pubmed and
    DD and ``accuracy_parity`` (GCN, AGNN) on the golden fixture.  The counts
    are set to 0 before the first and read after the last: K1-K7 must have
    launched, and no plain version run; the launches are the card's
    (``device_launches``, the replays of the trainer's and the ``gather``
    incumbent's steps included) but ``--single_kernel``'s, which traces its
    rounds itself and replays nothing: its wrappers count them.  Every CSV
    row must be there, finite and positive, each graph on its route, and
    parity must pass.  Returns the launches."""
    sk_cols = ("SAG avg (ms)", "edges_per_s", "useful_TFLOPs", "tile_TFLOPs", "MFU (%)",
               "SDDMM avg (ms)", "sddmm_edges_per_s")
    reset_counts()
    t0 = time.perf_counter()
    with device_launches() as ran:
        harness_runs(out_dir)
    counts = launch_counts()
    reset_counts()
    with in_dir(os.path.join(out_dir, "single_kernel")) as d:
        sweep.main(["--single_kernel", "--datasets", "cora", "DD", "--device", "cuda"])
        check_csv(os.path.join(d, "2_tcgnn_single_kernel.csv"), ("cora", "DD"), sk_cols)
    single = launch_counts()
    total = {k: (n + single[k][0], counts[k][1] + single[k][1]) for k, n in ran.items()}
    print("  AE harness: " + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}"
                                       for k, c in total.items()))
    if (any(total[k][0] <= 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7"))
            or any(c[1] for c in total.values())):
        raise AssertionError(f"AE harness: K1-K7 must launch and no plain version run: "
                             f"{total}")
    print(f"  AE harness done in {time.perf_counter() - t0:.1f} s")
    return {k: c[0] for k, c in total.items()}


# The epoch ledger's rows of eager steps (the AE run on an H100 before its
# stages were timed under replays), which phase 16 prints beside its own.
LEDGER_EAGER = "results_h100/ledger/epoch_ledger_all.csv"
LEDGER_MS = ("epoch_ms", "agg_ms", "dense_rest_ms", "stage_sum_ms", "residual_ms")


def harness_runs(out_dir) -> None:
    """Phase 16's runs but ``--single_kernel``'s."""
    fig = ("torch_baseline", "tcgnn_torch", "speedup", "tcgnn_torch_hoisted",
           "speedup_hoisted")
    ledger_cols = ("epoch_ms", "agg_ms", "dense_rest_ms", "stage_sum_ms")
    common = ["--epochs", str(AE_EPOCHS), "--baseline_epochs", str(AE_BASELINE_EPOCHS),
              "--dtype", "float32", "--device", "cuda"]
    t0 = time.perf_counter()
    for impl in INCUMBENTS:
        with in_dir(os.path.join(out_dir, f"gcn_{impl}")) as d:
            rows = sweep.main(["--model", "gcn", "--datasets", *AE_GCN_GRAPHS,
                               "--baseline_impl", impl, *common])
            check_sweep_routes(f"gcn {impl}", rows, AE_ROUTES)
            check_csv(os.path.join(d, "1_bench_gcn.csv"), AE_GCN_GRAPHS, ("Avg.Epoch (ms)",))
            check_csv(os.path.join(d, "Fig_6a_torch_gcn.csv"), AE_GCN_GRAPHS, fig)
            check_baseline_step(os.path.join(d, "Fig_6a_torch_gcn.csv"), impl)
    print(f"  GCN sweeps: {time.perf_counter() - t0:.1f} s")
    with in_dir(os.path.join(out_dir, "agnn")) as d:
        rows = sweep.main(["--model", "agnn", "--num_layers", "2", "--hidden", "32",
                           "--datasets", "pubmed", "DD", *common])
        check_sweep_routes("agnn", rows, AE_ROUTES)
        check_csv(os.path.join(d, "Fig_6a_torch_agnn.csv"), ("pubmed", "DD"), fig)
        check_baseline_step(os.path.join(d, "Fig_6a_torch_agnn.csv"), "gather")
    with in_dir(os.path.join(out_dir, "gin")) as d:
        sweep.main(["--model", "gin", "--datasets", "cora", *common])
        check_csv(os.path.join(d, "Fig_6a_torch_gin.csv"), ("cora",), fig)
    with in_dir(os.path.join(out_dir, "ledger")) as d:
        rows = epoch_ledger.main(["--datasets", "pubmed", "DD", "--epochs", str(AE_EPOCHS),
                                  "--device", "cuda"])
        check_csv(os.path.join(d, "epoch_ledger.csv"), ("pubmed", "DD"), ledger_cols)
    with open(LEDGER_EAGER) as f:
        eager = {r["dataset"]: r for r in csv.DictReader(f)}
    for row in rows:
        old = eager[row["dataset"]]
        print(f"  ledger {row['dataset']} (replayed): "
              + "  ".join(f"{c} {row[c]:.3f}" for c in LEDGER_MS)
              + "  [" + " + ".join(f"{lbl}[w{w}]={ms:.3f}" for lbl, w, ms in row["agg_stages"])
              + "]  against the eager row of " + LEDGER_EAGER + ": "
              + "  ".join(f"{c} {float(old[c]):.3f}" for c in LEDGER_MS)
              + f"  [{old['agg_stages']}]")
    failures = accuracy_parity.main(["--models", "gcn", "agnn", "--device", "cuda"])
    if failures:
        raise AssertionError(f"accuracy parity: {failures} failure(s)")


def op_grads(graph, op, x, w, r):
    """Output and gradients (x, and w for the weighted SpMM) of ``op`` with
    cotangent ``r``."""
    x = x.detach().clone().requires_grad_(True)
    w = w.detach().clone().requires_grad_(True)
    out = graph.spmm_weighted(x, w) if op == "spmm_weighted" else getattr(graph, op)(x)
    out.backward(r)
    return [out.detach(), x.grad] + ([w.grad] if op == "spmm_weighted" else [])


def phase_incumbent_grads(dev) -> None:
    """Phase 16, after its counts are read: on each of ``AE_GCN_GRAPHS``,
    both incumbents' ``spmm``, ``spmm_weighted`` and ``sddmm`` outputs and
    gradients against the port's ``TiledGraph`` at d=16, within the smoke's
    f32 tolerance of the magnitude (the same op over absolute values)."""
    dims = {n: (d, c) for n, d, c in sweep.AE_TABLE}
    for name in AE_GCN_GRAPHS:
        ds = train.load_dataset(argparse.Namespace(dataset=name, data_dir="tcgnn-ae-graphs/",
                                                   dim=dims[name][0], classes=dims[name][1],
                                                   seed=0))
        args = (ds.row_pointers, ds.column_index, ds.num_nodes)
        tg = TiledGraph(*args, device=dev)
        incumbents = {k: cls(*args, device=dev) for k, cls in INCUMBENTS.items()}
        n, e = ds.num_nodes, ds.num_edges
        x, w = randn((n, 16), 1, dev), randn((e,), 2, dev)
        for op in ("spmm", "spmm_weighted", "sddmm"):
            r = randn((e,) if op == "sddmm" else (n, 16), 3, dev)
            want = op_grads(tg, op, x, w, r)
            mag = op_grads(incumbents["gather"], op, x.abs(), w.abs(), r.abs())
            for impl, g in incumbents.items():
                got = op_grads(g, op, x, w, r)
                for part, a, b, m in zip(("out", "dx", "dw"), got, want, mag):
                    compare(f"{name} {impl} {op} {part} against TiledGraph", a, b, m, F32_TOL)
        del tg, incumbents
        torch.cuda.empty_cache()


# ---- the distributed block-diagonal route -------------------------------------

# A mesh's ops against one device's on the card (phases 17 and 18), f32,
# elementwise (``atol + rtol * |one device|``): the same kernels over the
# same pack rows or edges; at 2x2 the AGNN's scores are two feature shards'
# partial dots summed, at 4x1 and 2x2 the SDDMM's too.  The CPU parity
# tests' tolerances.
MESH_FWD = dict(rtol=1e-4, atol=1e-4)
MESH_GRAD = dict(rtol=1e-3, atol=1e-3)
BD_MESH_D = 32  # AGNN's hidden width
# Kernels each mesh's op check launches: K4 is the SDDMM on both.
BD_MESHES = {"4x1": ("K4", "K5", "K6", "K7"), "2x2": ("K4", "K5")}
YEAST = ["--dataset", "Yeast", "--dim", "74", "--classes", "2"]


def mesh_op(g, op, x, w, att, r, mesh) -> dict:
    """``op``'s output and gradients (x; w for the weighted SpMM, the
    attention weights for the AGNN aggregate) with cotangent ``r``, in one
    device's layout: on a mesh graph the inputs are padded to its node and
    edge layouts and the results taken back."""
    n, dev = x.shape[0], x.device
    if mesh:
        def nodes(t):
            return torch.nn.functional.pad(t, (0, 0, 0, g.padded_nodes - n))

        def back(t):
            if t.dim() == 1:
                return torch.from_numpy(g.gather_edge_vector(t)).to(dev)
            return t[:n]

        edges = g.edge_weights_to_sharded
    else:
        nodes = edges = back = torch.clone
    xl, wl = nodes(x).requires_grad_(True), edges(w).requires_grad_(True)
    al = None if att is None else att.clone().requires_grad_(True)
    if op == "spmm_weighted":
        out = g.spmm_weighted(xl, wl)
    elif op == "agnn_aggregate":
        out = g.agnn_aggregate(xl, al)
    else:
        out = getattr(g, op)(xl)
    out.backward(edges(r) if op == "sddmm" else nodes(r))
    parts = {"out": back(out.detach()), "dx": back(xl.grad)}
    if op == "spmm_weighted":
        parts["dw"] = back(wl.grad)
    if op == "agnn_aggregate":
        parts["datt"] = al.grad
    return parts


def phase_bd_mesh_ops(dev) -> None:
    """Phase 17, ops: on Yeast, ``DistributedTiledGraph`` over 4x1 and 2x2
    meshes on the card, each on the block-diagonal route, its ``spmm``,
    ``spmm_weighted``, ``sddmm`` and ``agnn_aggregate``, forward and every
    gradient, against the single-device ``TiledGraph``'s same ops on the
    card (f32, seeded inputs at d=32).  The mesh ops must launch K5 (4x1:
    K6/K7; 2x2: K4) and run no plain version."""
    ds = synthesize("Yeast", 74, 2)
    args = (ds.row_pointers, ds.column_index, ds.num_nodes)
    n, e, d = ds.num_nodes, ds.num_edges, BD_MESH_D
    x, w = randn((n, d), 170, dev) * 0.3, randn((e,), 171, dev)
    att = randn((1, 2), 172, dev)
    ops = ("spmm", "spmm_weighted", "sddmm", "agnn_aggregate")
    cot = {op: randn((e,) if op == "sddmm" else (n, d), 173, dev) for op in ops}
    t0 = time.perf_counter()
    one = TiledGraph(*args, device=dev)
    if not (one.block_diag and one.bd_full_coverage and one.agnn_aggregate is not None):
        raise AssertionError("Yeast: one device must take the fully covered BD route")
    want = {op: mesh_op(one, op, x, w, att, cot[op], False) for op in ops}
    print(f"Yeast one device: offsets {one.bd_offsets}, ops in {time.perf_counter() - t0:.1f} s")
    del one
    torch.cuda.empty_cache()
    for mesh, expected in BD_MESHES.items():
        t0 = time.perf_counter()
        g = DistributedTiledGraph(*args, mesh=make_mesh(*map(int, mesh.split("x")), dev))
        if not g.block_diag or g.agnn_aggregate is None:
            raise AssertionError(f"Yeast {mesh}: expected the BD route with the fused AGNN")
        prep = time.perf_counter() - t0
        pack_mb = sum(sh.pack.numel() * sh.pack.element_size() for sh in g._fwd.shards) / 2**20
        reset_counts()
        got = {op: mesh_op(g, op, x, w, att, cot[op], True) for op in ops}
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"Yeast {mesh}: {g.route}; {pack_mb:.1f} MiB of ext packs, rows_per_shard "
              f"{g.rows_per_shard}, built in {prep:.1f} s; "
              + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}" for k, c in counts.items()
                          if c[0] or c[1]))
        check_launches(f"Yeast {mesh} ops", counts, expected)
        for op in ops:
            for part, a in got[op].items():
                b = want[op][part]
                compare(f"Yeast {mesh} {op} {part} vs one device", a, b, b.abs(),
                        MESH_FWD if part == "out" else MESH_GRAD)
        del g, got
        torch.cuda.empty_cache()


def phase_bd_mesh_train(dev, card) -> tuple[list, dict]:
    """Phase 17, the path: the trainer on Yeast over 4x1 and 2x2 meshes,
    ``TRAIN_EPOCHS`` timed epochs each, ``--no_dropout``: GCN 2 layers
    hidden 16 (K5), AGNN 2 layers hidden 32 (4x1: K6/K7; 2x2: K4 cell
    scores and K5).  Each on the BD route with no split, a falling loss,
    its kernels and no others, no plain version, and a first loss within
    ``FIRST_LOSS_RTOL`` of one device's.  Every count is set to 0 just
    before each mesh run and read just after; the single-device runs (one
    epoch a model) come after.  Returns the runs and each kernel's launches
    summed over them."""
    gcn = ["--model", "gcn", "--hidden", "16", "--num_layers", "2"]
    agnn = ["--model", "agnn", "--hidden", "32", "--num_layers", "2"]
    runs = [  # label, model, mesh, kernels the run must launch
        ("Yeast gcn --mesh 4x1", gcn, "4x1", ("K5",)),
        ("Yeast gcn --mesh 2x2", gcn, "2x2", ("K5",)),
        ("Yeast agnn --mesh 4x1", agnn, "4x1", ("K6", "K7")),
        ("Yeast agnn --mesh 2x2", agnn, "2x2", ("K4", "K5")),
    ]
    results, launches, single = [], {k: 0 for k in KERNELS}, {}
    for label, model, mesh, expected in runs:
        extra = [*YEAST, "--no_dropout", *model, "--mesh", mesh]
        print(f"--- train.main {' '.join(extra)}")
        r = mesh_run(label, extra, expected, card)
        counts = r["counts"]
        del r["graph"]
        print(f"  {r['route']}  first loss {r['first_loss']:.6f}  final loss "
              f"{r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  Prep. (ms) "
              f"{r['prep_ms']:.3f}  max_memory_allocated "
              f"{r['max_memory_allocated'] / 2**30:.2f} GiB  "
              + "  ".join(f"{k} launches {c[0]}" for k, c in counts.items() if c[0]))
        if not (r["block_diag"] and "block_diag=True" in r["route"]
                and r["split"] == (False, False)):
            raise AssertionError(f"{label}: expected the BD route, no split: {r['route']}, "
                                 f"split {r['split']}")
        if not (math.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall ({r['first_loss']} -> "
                                 f"{r['final_loss']})")
        for k, c in counts.items():
            launches[k] += c[0]
        results.append((label, r))
        torch.cuda.empty_cache()
    for label, r in results:
        model = label.split()[1]
        if model not in single:
            s = run_main(["--device", "cuda", "--epochs", "1", *YEAST, "--no_dropout",
                          *(gcn if model == "gcn" else agnn)])
            single[model] = s["first_loss"]
            del s
            torch.cuda.empty_cache()
        rel = abs(r["first_loss"] - single[model]) / abs(single[model])
        print(f"  {label}: first loss {r['first_loss']:.6f} vs one device {single[model]:.6f}: "
              f"relative difference {rel:.3e} (rtol {FIRST_LOSS_RTOL})")
        if not rel <= FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first loss {r['first_loss']} vs one device "
                                 f"{single[model]}")
    for label, argv, rtol in MESH_CHAIN_RUNS["17"]:
        mesh_chain_against_eager(label, argv, dev, card, rtol)
        torch.cuda.empty_cache()
    return results, launches


# ---- the distributed streamed route and the chunk fallback ----------------------

# Widths of phase 18's op check (``MESH_FWD``, ``MESH_GRAD``: the same
# kernels over each shard's edges, the rows cut between warps elsewhere):
# the SpMMs at GCN's hidden width, the SDDMM at AGNN's.
STREAM_OP_D = {"spmm": 16, "spmm_weighted": 16, "sddmm": 32}


def vm_hwm():
    """The process's peak resident set in bytes (``VmHWM``), or None where
    ``/proc/self/status`` has none."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return None


def reset_peak_rss() -> bool:
    """Reset the process's peak resident set (``/proc/self/clear_refs``);
    False where the kernel has no such reset or no ``VmHWM`` to read it
    back, and ``peak_rss`` then reads the process's peak since it
    started."""
    if vm_hwm() is None:
        return False
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def peak_rss() -> int:
    """The process's peak resident set in bytes: ``VmHWM``, else
    ``getrusage``'s ``ru_maxrss``."""
    hwm = vm_hwm()
    return hwm if hwm is not None else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_bytes() -> int:
    """The process's resident set now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def mem_available() -> int:
    """The host's available memory now (``MemAvailable``), bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


class Sampled:
    """The extreme (``pick``: max or min) of ``read()`` over a block
    (``value``), sampled every 10 ms by a thread.  A spawned rank cannot
    always reset ``VmHWM`` (``reset_peak_rss``), which then reads the peak
    since the process began, so the ranks sample their resident set."""

    def __init__(self, read=rss_bytes, pick=max, period_s: float = 0.01):
        self.read, self.pick, self.period_s = read, pick, period_s
        self.value = None
        self._stop = threading.Event()

    def _sample(self) -> None:
        v = self.read()
        self.value = v if self.value is None else self.pick(self.value, v)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self._sample()

    def __enter__(self) -> "Sampled":
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._sample()


def stream_mesh_ops(g, one, n, e, dev, tag, expected) -> None:
    """``spmm``, ``spmm_weighted`` and ``sddmm`` of the mesh graph ``g``,
    forward and every gradient, against the single-device graph ``one``'s on
    the card (``mesh_op``'s layouts; f32 at ``STREAM_OP_D``'s widths);
    the mesh's ops must launch ``expected`` and no other kernel, and no plain
    version."""
    w = randn((e,), 181, dev)
    total = {k: (0, 0) for k in KERNELS}
    for op, d in STREAM_OP_D.items():
        x = randn((n, d), 180 + d, dev) * 0.3
        r = randn((e,) if op == "sddmm" else (n, d), 182, dev)
        want = mesh_op(one, op, x, w, None, r, False)
        reset_counts()
        got = mesh_op(g, op, x, w, None, r, True)
        torch.cuda.synchronize()
        total = {k: (c[0] + total[k][0], c[1] + total[k][1]) for k, c in launch_counts().items()}
        for part, a in got.items():
            b = want[part]
            compare(f"{tag} {op} {part} vs one device", a, b, b.abs(),
                    MESH_FWD if part == "out" else MESH_GRAD)
        del want, got
    print(f"  {tag} ops: " + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}"
                                       for k, c in total.items() if c[0] or c[1]))
    check_launches(f"{tag} ops", total, expected)
    torch.cuda.empty_cache()


def layout_bytes(metas) -> tuple[int, int]:
    """Device bytes of chunk layouts (the slots the plain versions read) and
    of their row indexes (what K8 and K9 read)."""
    uniq = {id(m): m for m in metas}.values()
    slots = sum(nbytes(m.seg_col_ids, m.seg_r, m.seg_c, m.seg_edge_id, m.seg_block,
                       m.seg_window, m.seg_chunks) for m in uniq)
    return slots, sum(nbytes(m.row_ptr, m.row_src) for m in uniq)


def time_heaviest_shard(g, dev, card) -> dict:
    """K8 (d=16) and K9 (d=32) on the mesh's heaviest shard layout: event
    and device ms (``TIMING_RUNS`` back-to-back calls) beside ``csr_bound``
    over the shard's edges and ``torch.sparse.mm`` / ``sampled_addmm`` over
    the shard's CSR (its rows against all the rows)."""
    m = max(g._fwd.metas, key=lambda t: t.num_edges)
    e, rows, src = m.num_edges, m.num_rows, m.num_src
    a_csr = torch.sparse_csr_tensor(m.row_ptr, m.row_src.long(),
                                    torch.ones(e, device=dev), size=(rows, src))
    out = {}
    x = randn((src, 16), 190, dev)
    b = csr_bound(e, rows, nbytes(x) + 4 * rows * 16, 2 * e * 16)
    out["K8"] = dict(ms=median_ms(lambda: spmm_tc(x, m)), device_ms=device_ms(lambda: spmm_tc(x, m)),
                     library_ms=device_ms(lambda: torch.sparse.mm(a_csr, x)), bound=b)
    xa, xb = randn((rows, 32), 191, dev), randn((src, 32), 192, dev)
    xbt = xb.t().contiguous()
    b = csr_bound(e, rows, nbytes(xa, xb) + 4 * e, 2 * e * 32)
    out["K9"] = dict(ms=median_ms(lambda: sddmm_tc(xa, m, xb)),
                     device_ms=device_ms(lambda: sddmm_tc(xa, m, xb)),
                     library_ms=device_ms(lambda: torch.sparse.sampled_addmm(
                         a_csr, xa, xbt, beta=0.0)), bound=b)
    for k, t in out.items():
        d = 16 if k == "K8" else 32
        print(f"  time {k} reddit 2x2 heaviest shard ({e} edges, {rows} rows against {src}) "
              f"d={d}: event {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, library "
              f"(device) {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]}) (event: median of {TIMING_RUNS}; device: one pair around "
              f"{TIMING_RUNS} calls; card: {card}; one card held all 4 shards)")
    del a_csr
    return out


def phase_stream_mesh_ops(reddit, dev, card) -> dict:
    """Phase 18 (a): reddit at full size (phase 11's dataset, in its own
    order: unbalanced, so the mesh's rows are one device's), a
    ``DistributedTiledGraph`` over 2x2 (the all-gather over ``graph`` and
    the SDDMM's sum over ``feature``) on the streamed route: its layout
    printed, its ops held to phase 11's single-device graph (K8 and K9
    only), then K8 and K9 timed on its heaviest shard.  Returns the
    timings."""
    one, _, ds = reddit
    n, e = ds.num_nodes, ds.num_edges
    t0 = time.perf_counter()
    g = DistributedTiledGraph(ds.row_pointers, ds.column_index, n, make_mesh(2, 2, dev))
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    if not (g.streamed and not g.dense_tiles and g.agnn_aggregate is None):
        raise AssertionError(f"reddit 2x2: expected the streamed route: {g.route}")
    slots, index = layout_bytes(g._fwd.metas + g._bwd.metas)
    print(f"reddit 2x2: {g.route}; rows_per_shard {g.rows_per_shard}, edges a shard "
          f"{[m.num_edges for m in g._fwd.metas]}; layouts {slots / 1e6:.1f} MB, row indexes "
          f"{index / 1e6:.1f} MB on the card; built in {prep:.1f} s (Prep host "
          f"{g.prep_host_s * 1e3:.1f} ms: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in g.prep_stages.items()) + ")")
    stream_mesh_ops(g, one, n, e, dev, "reddit 2x2", ("K8", "K9"))
    times = time_heaviest_shard(g, dev, card)
    del g
    torch.cuda.empty_cache()
    return times


def one_device_first_loss(reddit, model, dev) -> float:
    """The first loss of a ``--no_dropout`` trainer run of ``model`` on one
    device: ``train.make_train_step``'s first step over phase 11's reddit
    graph and dataset, the parameters ``nets.init_net``'s draws from the
    trainer's seed (what ``train.main`` does after its preprocessing)."""
    graph, x, ds = reddit
    args = train.build_argparser().parse_args([*REDDIT, "--no_dropout", *model])
    net = nets.init_net(torch.Generator().manual_seed(args.seed), args.model, ds.num_features,
                        args.hidden, ds.num_classes, args.num_layers, device=dev,
                        n_heads=args.n_heads)
    y = torch.from_numpy(ds.y.astype(np.int64)).to(dev)
    step = train.make_train_step(graph, net, x, y,
                                 train.make_optimizer(net.parameters(), args.lr, dev), 0.0,
                                 hoist=not args.no_hoist)
    return float(step())


def phase_stream_mesh_train(reddit, dev, card) -> tuple[list, dict]:
    """Phase 18 (b), the path: the trainer on reddit, ``TRAIN_EPOCHS`` timed
    epochs each, ``--no_dropout``: GCN 2 layers hidden 16 hoisted (the
    trainer's defaults) on ``--mesh 4x1`` (K8) and AGNN 2 layers hidden 32
    on ``--mesh 2x2`` (K8 and K9), balanced as the trainer balances.  Each
    on the streamed route, with the native host pass, a falling loss, its
    kernels and no others, no plain version, and a first loss within
    ``FIRST_LOSS_RTOL`` of one device's (``one_device_first_loss``; the loss
    is a mean, so the balance's relabelling does not move it).  Every count
    is set to 0 just before each run and read just after.  Returns the runs
    and each kernel's launches summed over them."""
    gcn = ["--model", "gcn"]
    agnn = ["--model", "agnn", "--hidden", "32", "--num_layers", "2"]
    runs = [  # label, model, mesh, kernels the run must launch
        ("reddit gcn --mesh 4x1", gcn, "4x1", ("K8",)),
        ("reddit agnn --mesh 2x2", agnn, "2x2", ("K8", "K9")),
    ]
    results, launches = [], {k: 0 for k in KERNELS}
    for label, model, mesh, expected in runs:
        extra = [*REDDIT, "--no_dropout", *model, "--mesh", mesh]
        print(f"--- train.main {' '.join(extra)}")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # phase 11's graph, for the first losses
        rss_reset = reset_peak_rss()
        r = mesh_run(label, extra, expected, card)
        counts = r["counts"]
        r["held_before"] = held
        r["peak_rss"], r["rss_of_run"] = peak_rss(), rss_reset
        r["seconds"] = time.perf_counter() - t0
        del r["graph"]
        single = one_device_first_loss(reddit, model, dev)
        rel = abs(r["first_loss"] - single) / abs(single)
        print(f"  {r['route']}  first loss {r['first_loss']:.6f} (one device {single:.6f}, "
              f"relative difference {rel:.3e}, rtol {FIRST_LOSS_RTOL})  final loss "
              f"{r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  Prep. (ms) "
              f"{r['prep_ms']:.3f}  Prep host (ms) {r['prep_host_ms']:.3f}  peak host RSS "
              f"{r['peak_rss'] / 2**30:.2f} GiB ({'this run' if rss_reset else 'the process'})"
              f"  max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB ("
              f"{held / 2**30:.2f} GiB held before the run)  run {r['seconds']:.1f} s  "
              + "  ".join(f"{k} launches {c[0]}" for k, c in counts.items() if c[0])
              + f"  (card: {card})")
        if not (r["streamed"] and "streamed=True" in r["route"]):
            raise AssertionError(f"{label}: expected the streamed route: {r['route']}")
        if not (math.isfinite(r["final_loss"]) and r["final_loss"] < r["first_loss"]):
            raise AssertionError(f"{label}: loss did not fall ({r['first_loss']} -> "
                                 f"{r['final_loss']})")
        if not rel <= FIRST_LOSS_RTOL:
            raise AssertionError(f"{label}: first loss {r['first_loss']} vs one device {single}")
        for k, c in counts.items():
            launches[k] += c[0]
        results.append((label, r))
        torch.cuda.empty_cache()
    return results, launches


def phase_chunk_fallback_ops(ds, dev) -> None:
    """Phase 18 (c): pubmed on the chunk fallback (``dense_tiles=False``)
    over a 4x2 mesh, in its own order: its ops and gradients against the
    single-device graph's (its condensed route: K1 and K4) on the card,
    the mesh's launching K8 and K9 only."""
    n, e = ds.num_nodes, ds.num_edges
    g = DistributedTiledGraph(ds.row_pointers, ds.column_index, n, make_mesh(4, 2, dev),
                              dense_tiles=False)
    if g.dense_tiles or g.streamed:
        raise AssertionError(f"pubmed 4x2 dense_tiles=False: {g.route}")
    one = TiledGraph(ds.row_pointers, ds.column_index, n, TileConfig(), device=dev)
    print(f"pubmed 4x2: {g.route}")
    stream_mesh_ops(g, one, n, e, dev, "pubmed 4x2 chunk fallback", ("K8", "K9"))
    del g, one
    torch.cuda.empty_cache()


# ---- traffic accounting (``bench``: measure_comm, partition_stats, scaling) ----

# Phase 19's measure_comm rows: dataset, shard counts.  soc-BlogCatalog's
# 4-shard row has no all_to_all (no split), reddit's takes the streamed route.
COMM_ROWS = (("pubmed", (4, 8)), ("amazon0601", (4, 8)), ("soc-BlogCatalog", (4, 8)),
             ("reddit", (4,)))
# The JAX package's rows, and the columns a row must equal there: the bytes
# by kind and the partition's rows depend on the partition and the widths,
# not on the device.
COMM_REFERENCE = "results/comm_measured.csv"
COMM_EQUAL = ("measured_a2a_bytes", "measured_a2a_count", "measured_ag_bytes",
              "measured_ppermute_bytes", "boundary_rows", "modeled_halo_bytes",
              "ideal_boundary_bytes")


def phase_measure_comm(dev, card, synthesized) -> dict:
    """Phase 19 (a): ``measure_comm.measure`` on ``COMM_ROWS``, each row
    against the committed JAX row, its route's kernel (K1, or K8 streamed)
    launched and no other, no plain version.  A graph of ``synthesized``
    (name -> an earlier phase's dataset: a synthetic graph's edges do not
    depend on its widths) is not synthesized again.  Every count is set to
    0 just before each row's graph and step and read just after.  Returns
    each kernel's launches summed over the rows."""
    with open(COMM_REFERENCE) as f:
        want = {(r["dataset"], int(r["shards"])): r for r in csv.DictReader(f)}
    columns = measure_comm.HEADER.split(",")
    launches = {k: 0 for k in KERNELS}
    for name, shard_counts in COMM_ROWS:
        t0 = time.perf_counter()
        if name in synthesized:  # the rows read the features' width only
            ds = dataclasses.replace(synthesized[name],
                                     x=np.empty((synthesized[name].num_nodes, 16), np.float32))
        else:
            ds = synthesize(name, 16, 4)
        print(f"  {name}: N={ds.num_nodes} E={ds.num_edges}, "
              + ("phase 11's graph" if name in synthesized else "synthesized")
              + f" in {time.perf_counter() - t0:.1f} s")
        for g in shard_counts:
            t0 = time.perf_counter()
            reset_counts()
            r = measure_comm.measure(ds, name, g, 4, dev)
            counts = launch_counts()
            dg = r["graph"]
            expected = ("K1",) if dg.dense_tiles else ("K8",)
            print(f"  measure_comm {r['row']}  step {r['step_ms']:.3f} ms  row "
                  f"{time.perf_counter() - t0:.1f} s  "
                  + "  ".join(f"{k} launches {c[0]} plain calls {c[1]}"
                              for k, c in counts.items() if c[0] or c[1]) + f"  (card: {card})")
            print(f"    {dg.route}")
            if dg.block_diag or dg.streamed != (name == "reddit"):
                raise AssertionError(f"measure_comm {name} {g}: unexpected route {dg.route}")
            check_launches(f"measure_comm {name} {g}", counts, expected)
            got, ref = dict(zip(columns, r["row"].split(","))), want[(name, g)]
            bad = [c for c in COMM_EQUAL if got[c] != ref[c]]
            if bad or got["ratio_measured_vs_model"] != "1.000":
                raise AssertionError(f"measure_comm {name} {g}: {r['row']} against the JAX row "
                                     f"{ref} (columns {bad} differ)")
            for k, c in counts.items():
                launches[k] += c[0]
            del r, dg
            torch.cuda.empty_cache()
    return launches


# ``scaling``'s timed epochs a mesh size (its default).
SCALING_EPOCHS = 10


def phase_traffic(dev, card, synthesized) -> dict:
    """Phase 19: measure_comm's rows (``phase_measure_comm``), then
    ``partition_stats`` on pubmed and amazon0601 over 2, 4 and 8 shards with
    the H100's data-sheet rates, then ``scaling``'s default curve over 1, 2,
    4 and 8 shards (K1 only, no plain version, the counts set to 0 just
    before).  Returns each kernel's launches."""
    t0 = time.perf_counter()
    launches = phase_measure_comm(dev, card, synthesized)
    print(f"  measure_comm done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"  partition_stats rates (NVIDIA H100 80GB HBM3 SXM5 data sheet at 700 W, not "
          f"measured): HBM {partition_stats.HBM_BPS / 1e12} TB/s, NVLink "
          f"{partition_stats.NVLINK_BPS / 1e9:.0f} GB/s each way, bf16 "
          f"{partition_stats.TENSOR_FLOPS / 1e12} TFLOP/s; card: {card}")
    rows = partition_stats.main(["--datasets", "pubmed", "amazon0601", "--shards", "2", "4", "8"])
    if len(rows) != 6 or not all(0 < r["pred_efficiency"] <= r["pred_efficiency_split"] <= 1
                                 for r in rows):
        raise AssertionError(f"partition_stats: {rows}")
    print(f"  partition_stats done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_counts()
    with device_launches() as ran, capture_launches() as captured:
        curve = scaling.main(["--device", str(dev)])
    counts = launch_counts()
    for size, ms, eps, eff in curve:
        print(f"  scaling {size} shards: epoch {ms:.3f} ms  {eps:.4e} edges/s  efficiency "
              f"{eff:.3f}  (replays; card: {card}; one card held all shards)")
    print("  scaling " + "  ".join(f"{k} launches {c[0]} (on the card {ran[k]}) plain calls "
                                   f"{c[1]}" for k, c in counts.items() if c[0] or c[1])
          + "; launches an epoch by mesh size " + " / ".join(
              " ".join(f"{k} {n}" for k, n in per_epoch.items()) for per_epoch in captured))
    if [r[0] for r in curve] != [1, 2, 4, 8] or curve[0][3] != 1.0:
        raise AssertionError(f"scaling: {curve}")
    check_launches("scaling", counts, ("K1",))
    check_launches("scaling (on the card)", on_card(ran), ("K1",))
    # Each size: ``many(3)`` (2 eager steps, the capture, a replay), then
    # ``many(10)`` replays.
    check_replays("scaling", counts, ran, [1] * len(captured),
                  [(3 + SCALING_EPOCHS, per_epoch) for per_epoch in captured], eager=2)
    if len(captured) != len(curve):
        raise AssertionError(f"scaling: {len(captured)} captures over {len(curve)} sizes")
    for k, n in ran.items():
        launches[k] += n
    print(f"  scaling done in {time.perf_counter() - t0:.1f} s")
    return launches


# ---- the headline bench (``tcgnn_tpu_torch.bench.headline``) -------------------

def bench_py_keys() -> list:
    """The keys, in order, of the dict literal inside ``bench.py``'s
    ``json.dumps`` call: the file beside this script is read with ``ast``,
    never imported (it imports JAX)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    (keys,) = [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
               if isinstance(node, ast.Call) and ast.unparse(node.func) == "json.dumps"]
    return keys


# The headline's three measures at its defaults on the card
# (``bench/headline.py``): the epochs of each (its warm-up, then 3 reps) and
# the launches of one epoch.
HEADLINE_STEPS = [
    (headline.WARMUP_EPOCHS + 3 * 200, {"K1": 4}),  # GCN, no hoist
    (headline.WARMUP_EPOCHS + 3 * 200, {"K1": 2}),  # GCN hoisted
    (headline.WARMUP_EPOCHS + 3 * 50, {"K2": 4, "K3": 4}),  # AGNN, 4 layers
]


def phase_headline(card) -> tuple[dict, dict]:
    """Phase 20: ``headline.main([])`` at its full schedule on the card, the
    counts set to 0 just before; raises unless its line has ``bench.py``'s
    keys and ``dtype``, the card's backend and dtype, pubmed's 334 TC blocks,
    positive finite times and an AGNN datum, and unless it launched K1, K2
    and K3 and no other kernel, and no plain version, and unless each of its
    three measures (``HEADLINE_STEPS``) captured its step once and the card
    ran every replayed epoch's launches (``check_replays``).  Returns the
    line and each kernel's launches on the card."""
    reset_counts()
    out = io.StringIO()
    with device_launches() as ran, contextlib.redirect_stdout(Tee(sys.stdout, out)):
        line = headline.main([])
    counts = launch_counts()
    captures = [int(c) for c in re.findall(r"step captured (\d+) time", out.getvalue())]
    print(f"  headline line: {json.dumps(line)}  (card: {card})")
    print("  headline " + "  ".join(f"{k} launches {c[0]} (on the card {ran[k]}) plain calls "
                                    f"{c[1]}" for k, c in counts.items() if c[0] or c[1]))
    check_launches("headline", counts, ("K1", "K2", "K3"))
    check_launches("headline (on the card)", on_card(ran), ("K1", "K2", "K3"))
    check_replays("headline", counts, ran, captures, HEADLINE_STEPS)
    keys = bench_py_keys()
    if len(keys) != 11 or list(line) != keys + ["dtype"]:
        raise AssertionError(f"headline keys {list(line)}; bench.py's {keys} and dtype")
    if (line["backend"], line["dtype"], line["tc_blocks"]) != ("cuda", "bfloat16", 334):
        raise AssertionError(f"headline: {line}")
    times = [line[k] for k in ("value", "value_hoisted_default", "prep_ms",
                               "agnn_pubmed_epoch_ms")]
    if not all(isinstance(t, (int, float)) and math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"headline times {times}")
    return line, ran


# ---- the mesh over processes (torch.distributed) ------------------------------

# Ranks of phase 21: the graph axis of every run's mesh (4) split in two.
MESH_RANKS = 2
# A 2-rank run's final loss against the one-process mesh run's, after the
# same 30 Adam updates: the ranks sum each gradient from two partial sums
# (the all-reduce) where one process sums it whole, and K1, K2/K3 and K8
# add rows with atomics in no fixed order, so the last bits of every update
# may move.
FINAL_LOSS_RTOL = 1e-3
PUBMED = ["--dataset", "pubmed", "--dim", "500", "--classes", "3"]
MESH_GCN = ["--model", "gcn", "--hidden", "16", "--num_layers", "2"]
MESH_AGNN = ["--model", "agnn", "--hidden", "32", "--num_layers", "2"]
# label, trainer arguments (all --no_dropout, TRAIN_EPOCHS), kernels each
# rank must launch, and where the one-process mesh run it is held to comes
# from (the phase-13/17/18 run of that label, or phase 21's own).
PROC_RUNS = [
    ("pubmed gcn --mesh 4x1", [*PUBMED, *MESH_GCN, "--mesh", "4x1"], ("K1",), "21"),
    ("pubmed agnn --mesh 4x1", [*PUBMED, *MESH_AGNN, "--mesh", "4x1"], ("K2", "K3"), "21"),
    ("pubmed agnn --mesh 4x2", [*PUBMED, *MESH_AGNN, "--mesh", "4x2"], ("K4", "K10"),
     "mesh 4x2 agnn"),
    ("Yeast gcn --mesh 4x1", [*YEAST, *MESH_GCN, "--mesh", "4x1"], ("K5",),
     "Yeast gcn --mesh 4x1"),
    ("Yeast agnn --mesh 4x1", [*YEAST, *MESH_AGNN, "--mesh", "4x1"], ("K6", "K7"),
     "Yeast agnn --mesh 4x1"),
    ("reddit gcn --mesh 4x1", [*REDDIT, "--model", "gcn", "--mesh", "4x1"], ("K8",),
     "reddit gcn --mesh 4x1"),
]


def mesh_rank(rank, world, store, backend, device, out_dir, tasks=None) -> None:
    """One rank of phases 21 and 22 (started by
    ``torch.multiprocessing.spawn``): join the group over the ``file://``
    store, run every task on ``device`` (``{rank}`` is the rank), each with
    the counts set to 0 just before it and read just after, and write each
    task's results to ``out_dir/rank<r>.pt``.  A task is ``(kind, label,
    argv)``: ``train`` runs ``train.main`` with ``--no_dropout`` and
    ``TRAIN_EPOCHS`` timed epochs (losses, ``Train (ms)``, peak device
    memory and host RSS), ``single_kernel`` runs it with ``--single_kernel``
    (the stats), ``measure_comm`` runs ``measure_comm.main`` (the rows),
    ``overlap_trace`` runs ``overlap_trace`` (rank 0's figures).  Without
    ``tasks``, ``PROC_RUNS``' trainer runs."""
    from tcgnn_tpu_torch.parallel.mesh import init_process_group

    device = init_process_group(device.format(rank=rank), backend=backend,
                                init_method=f"file://{store}", rank=rank, world_size=world)
    if tasks is None:
        tasks = [("train", label, argv) for label, argv, _, _ in PROC_RUNS]
    results = []
    for kind, label, argv in tasks:
        buf = io.StringIO()
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with contextlib.redirect_stdout(Tee(sys.stdout, buf)), Sampled() as rss:
            if kind == "measure_comm":
                out_csv = os.path.join(out_dir, f"comm_rank{rank}.csv")
                r = {"rows": measure_comm.main([*argv, "--device", str(device),
                                                "--out", out_csv])}
            elif kind == "single_kernel":
                r = {"stats": train.main(["--device", str(device), *argv, "--single_kernel"])}
            elif kind == "overlap_trace":
                r = overlap_trace(device, argv, out_dir, rank)
            else:
                r = train.main(["--device", str(device), "--epochs", str(TRAIN_EPOCHS),
                                "--no_dropout", *argv])
        counts = launch_counts()
        res = {"label": label, "counts": counts, "seconds": time.perf_counter() - t0,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "peak_rss": rss.value, "native": "SGT pass:\tnative\n" in buf.getvalue()}
        if kind == "train":
            res.update({k: r[k] for k in ("route", "first_loss", "final_loss", "train_ms",
                                          "captures")})
        else:
            res.update(r)
        results.append(res)
        del r
        torch.cuda.empty_cache()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@contextlib.contextmanager
def ranks_running(world, backend, device, tasks=None, phase="21"):
    """``mesh_rank`` started in ``world`` processes; yields ``wait(timeout_s)``,
    which returns every rank's results.  A rank that fails ends the others
    and raises; so does the time limit; leaving the block ends any rank
    still running."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(mesh_rank, args=(world, os.path.join(tmp, "store"), backend, device, tmp,
                                        tasks),
                       nprocs=world, join=False)

        def wait(timeout_s) -> list:
            deadline = time.perf_counter() + timeout_s
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"phase {phase}: ranks still running after {timeout_s} s")
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]

        try:
            yield wait
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()


def spawn_ranks(world, backend, device, timeout_s, tasks=None, phase="21") -> list:
    """``mesh_rank`` in ``world`` processes; every rank's results."""
    with ranks_running(world, backend, device, tasks, phase) as wait:
        return wait(timeout_s)


def torchrun_train_ms(backend, device, card, nproc=MESH_RANKS,
                      argv=(*PUBMED, *MESH_GCN, "--mesh", "4x1")) -> dict:
    """One ``torchrun`` CLI run (``nproc`` processes; by default pubmed GCN
    ``--mesh 4x1`` over ``MESH_RANKS``): rank 0's ``Train (ms)``, final loss
    and route, read from its output."""
    with torchrun_running(backend, device, nproc, argv) as finish:
        return finish(card)


@contextlib.contextmanager
def torchrun_running(backend, device, nproc=MESH_RANKS,
                     argv=(*PUBMED, *MESH_GCN, "--mesh", "4x1")):
    """``torchrun_train_ms``'s run, started; yields ``finish(card)``, which
    waits for it (600 s at most) and reads rank 0's lines.  Leaving the
    block ends the run if it is still running."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "tcgnn_tpu_torch.train", "--device", device,
           "--dist_backend", backend, "--epochs", str(TRAIN_EPOCHS), "--no_dropout", *argv]
    print("--- " + " ".join(cmd[1:]), flush=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(card) -> dict:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"torchrun exited {proc.returncode}: {stderr[-4000:]}")
        lines = dict(line.split(":\t", 1) for line in stdout.splitlines() if ":\t" in line)
        for key in ("TC_Blocks", "Exp_Edges", "Prep. (ms)", "Final loss", "Train (ms)", "Route"):
            if key not in lines:
                raise AssertionError(f"torchrun: no {key!r} line in rank 0's output:\n{stdout}")
        if stdout.count("Final loss:") != 1:
            raise AssertionError("torchrun: a rank other than 0 printed")
        r = {"train_ms": float(lines["Train (ms)"]), "final_loss": float(lines["Final loss"]),
             "route": lines["Route"]}
        print(f"  torchrun {nproc} processes, backend {backend}, {device}: Train (ms) "
              f"{r['train_ms']:.3f}, Final loss {r['final_loss']:.6f}, Route {r['route']} "
              f"(card: {card})")
        return r

    try:
        yield finish
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def phase_mesh_procs(earlier, dev, card, data_dir) -> tuple[list, dict, dict]:
    """Phase 21: the mesh over processes.  ``MESH_RANKS`` ranks split each
    run's graph axis: over NCCL one rank a card where the machine has as
    many cards, else over gloo on this one card, every transfer staged
    through host memory.  Each rank runs ``PROC_RUNS`` and phase 13b's
    ``overlap_runs`` (``data_dir``) through ``train.main`` (``--no_dropout``,
    ``TRAIN_EPOCHS`` timed epochs; reddit's run in 2 ranks of its own,
    beside the others): each run's first loss within
    ``FIRST_LOSS_RTOL`` and final loss within ``FINAL_LOSS_RTOL`` of the
    one-process mesh run (``earlier``: phases 13, 13b, 17 and 18, by label;
    the pubmed 4x1 runs here), every rank's launches of the expected
    kernels and no other, no plain call, and each kernel's launches summed
    over the ranks equal to the one-process run's (each shard's on its own
    rank); then ``overlap_trace`` of the soc-BlogCatalog run (rank 0's
    figures printed).  One ``torchrun`` CLI run runs beside the ranks.
    Returns the runs, each kernel's launches summed over every rank's runs
    and rank 0's trace figures."""
    backend, device = rank_backend(MESH_RANKS)
    refs = dict(earlier)
    for label, argv, expected, source in PROC_RUNS:
        if source == "21":
            one_process_run(label, argv, expected, refs, card)
    overlap = [(label, argv, expected, label)
               for label, argv, expected, _, _ in overlap_runs(data_dir)]
    # reddit's run (its host pass in every rank, the phase's long pole) takes
    # ranks of its own, beside the others'.
    reddit = [spec for spec in PROC_RUNS if spec[0].startswith("reddit")]
    specs = [spec for spec in PROC_RUNS if spec not in reddit] + overlap
    tasks = [("train", label, argv) for label, argv, _, _ in specs]
    trace_label, trace_argv = f"{overlap[0][0]} traced", overlap[0][1]
    tasks.append(("overlap_trace", trace_label, trace_argv))
    t1 = time.perf_counter()
    # The torchrun CLI run, reddit's ranks and the other ranks run at once.
    with torchrun_running(backend, device.format(rank=0) if backend == "gloo" else "cuda") \
            as finish_cli, \
            ranks_running(MESH_RANKS, backend, device,
                          [("train", label, argv) for label, argv, _, _ in reddit]) as wait_reddit:
        ranks = spawn_ranks(MESH_RANKS, backend, device, 900, tasks)
        print(f"  {MESH_RANKS} ranks ran {len(tasks)} tasks in {time.perf_counter() - t1:.1f} s")
        ranks_reddit = wait_reddit(900)
        print(f"  reddit's {MESH_RANKS} ranks ran {len(reddit)} task by "
              f"{time.perf_counter() - t1:.1f} s")
        cli = finish_cli(card)
    launches = {k: 0 for k in KERNELS}
    runs = check_rank_runs(specs + reddit, [rk[:len(specs)] + rd for rk, rd in
                                           zip(ranks, ranks_reddit)],
                           refs, card, launches, backend)
    per_rank = [rk[len(specs)] for rk in ranks]
    for rank, r in enumerate(per_rank):
        check_launches(f"{trace_label} rank {rank}", r["counts"], ("K1",))
        for k in KERNELS:
            launches[k] += r["counts"][k][0]
    trace = per_rank[0]
    if not trace["waits"] > 0:
        raise AssertionError(f"{trace_label}: rank 0's trace holds no wait on an exchange")
    print(f"  {trace_label}, rank 0 of {MESH_RANKS} ({backend}), {OVERLAP_TRACE_EPOCHS} steps "
          f"under torch.profiler: {trace['waits']:.0f} exchange waits a step, the host waits "
          f"{trace['wait_ms']:.3f} ms a step; K1 {trace['k1_ms']:.3f} ms a step on the device "
          f"({trace['k1_calls']:.0f} calls), {trace['k1_in_wait_ms']:.3f} ms of it inside the "
          f"waits (the local class's)  (card: {card})")
    want = refs["pubmed gcn --mesh 4x1"]["final_loss"]
    if not abs(cli["final_loss"] - want) <= FINAL_LOSS_RTOL * abs(want):
        raise AssertionError(f"torchrun final loss {cli['final_loss']} vs one process {want}")
    return runs + [("torchrun pubmed gcn --mesh 4x1", cli, None)], launches, trace


# ---- the feature axis over processes (phase 22) ----------------------------------

# Timed epochs of phase 22's AGNN runs (after the 9 warm-ups; the argument
# comes after ``TRAIN_EPOCHS``' and wins): an epoch over gloo on one card
# takes about 8 s (reddit 1x2), 2.7 s (Yeast 2x2) and 1.6 s (pubmed 2x2), so
# they are cut to keep the smoke within its time (30 updates to 10 each).
SPLIT_AGNN_EPOCHS = 1
# Phase 22's trainer runs, one feature shard a rank: label, trainer
# arguments (all --no_dropout, TRAIN_EPOCHS), kernels each rank must launch,
# and where the one-process mesh run it is held to comes from (phase 22's
# own, of the same depth).  Four ranks take 2x2 (two graph blocks, two
# feature shards); two take reddit's 1x2 (two reddit host passes fit the
# host, as phase 21 shows; four are unmeasured).
SPLIT_RUNS = {
    4: [("pubmed gcn --mesh 2x2", [*PUBMED, *MESH_GCN, "--mesh", "2x2"], ("K1",), "22"),
        ("pubmed agnn --mesh 2x2", [*PUBMED, *MESH_AGNN, "--mesh", "2x2", "--epochs",
                                    str(SPLIT_AGNN_EPOCHS)], ("K4", "K10"), "22"),
        ("Yeast agnn --mesh 2x2", [*YEAST, *MESH_AGNN, "--mesh", "2x2", "--epochs",
                                   str(SPLIT_AGNN_EPOCHS)], ("K4", "K5"), "22")],
    2: [("reddit agnn --mesh 1x2", [*REDDIT, *MESH_AGNN, "--mesh", "1x2", "--epochs",
                                     str(SPLIT_AGNN_EPOCHS)], ("K8", "K9"), "22")],
}
# The other two-rank spawn's tasks: --single_kernel one feature shard a
# rank (1x2) and the graph axis split (2x2), and measure_comm on pubmed.
SPLIT_SAG = [("pubmed --mesh 1x2 --single_kernel", [*PUBMED, "--mesh", "1x2"]),
             ("pubmed --mesh 2x2 --single_kernel", [*PUBMED, "--mesh", "2x2"])]
SPLIT_COMM = ("pubmed", (4, 8))


def rank_backend(world) -> tuple[str, str]:
    """NCCL one rank a card where the machine has ``world`` cards, else gloo
    on card 0 (every transfer staged through host memory): the backend and
    the device (``{rank}`` the rank's)."""
    cards = torch.cuda.device_count()
    if cards >= world:
        print(f"{cards} cards: {world} ranks over NCCL, one a card")
        return "nccl", "cuda:{rank}"
    print(f"{cards} card: NCCL is not run (it takes one rank a card); {world} ranks on card 0 "
          "over gloo, every transfer staged through host memory")
    return "gloo", "cuda:0"


def one_process_run(label, argv, expected, refs, card) -> None:
    """The one-process mesh run a rank run is held to: ``train.main`` with
    ``--no_dropout`` and ``TRAIN_EPOCHS`` timed epochs (``mesh_run``: its
    step replayed, its kernels and no other, no plain call); kept in
    ``refs`` under ``label`` with the launches the card ran."""
    print(f"--- one process: train.main {' '.join(argv)}")
    t0 = time.perf_counter()
    r = mesh_run(f"one process {label}", ["--no_dropout", *argv], expected, card)
    print(f"  one process {label}: first loss {r['first_loss']:.6f}  final loss "
          f"{r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  run "
          f"{time.perf_counter() - t0:.1f} s  (card: {card})")
    del r["graph"]
    refs[label] = r
    torch.cuda.empty_cache()


def check_rank_runs(specs, ranks, refs, card, launches, backend, layout=None) -> list:
    """Each trainer run of ``specs`` (label, arguments, kernels, the label
    of its one-process run in ``refs``, or a phase's own under the run's
    label) over the ranks: every rank's route (ending in ``layout`` where
    given), its kernels and no other, no plain call, each kernel's launches
    summed over the ranks equal to one process's (the card's count of its
    replayed run), every rank's step eager (no capture), the first and final
    losses within ``FIRST_LOSS_RTOL`` and ``FINAL_LOSS_RTOL``.  Prints each
    rank's ``Train (ms)``, peak device memory, sampled peak host RSS and
    launches; adds the launches to ``launches``.  Returns ``(label, the
    ranks' results, the reference)`` a run."""
    runs = []
    for i, (label, _, expected, source) in enumerate(specs):
        ref = refs[source] if source in refs else refs[label]
        per_rank = [rk[i] for rk in ranks]
        for rank, r in enumerate(per_rank):
            check_launches(f"{label} rank {rank}", r["counts"], expected)
            if r["captures"]:
                raise AssertionError(f"{label} rank {rank}: {r['captures']} capture(s); a step "
                                     "over processes runs eager")
            if layout is not None and not r["route"].endswith(layout):
                raise AssertionError(f"{label} rank {rank}: route {r['route']}, expected "
                                     f"{layout!r} at its end")
            print(f"  {label} rank {rank}: {r['route']}  first loss {r['first_loss']:.6f}  "
                  f"final loss {r['final_loss']:.6f}  Train (ms) {r['train_ms']:.3f}  "
                  f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB  "
                  f"peak host RSS {r['peak_rss'] / 2**30:.2f} GiB (sampled)  run "
                  f"{r['seconds']:.1f} s  "
                  + "  ".join(f"{k} launches {c[0]}" for k, c in r["counts"].items() if c[0])
                  + f"  (card: {card}; {backend})")
        if not per_rank[0]["native"]:
            raise AssertionError(f"{label}: rank 0 printed no 'SGT pass:\tnative' line")
        for k in KERNELS:
            total = sum(r["counts"][k][0] for r in per_rank)
            launches[k] += total
            if total != ref["counts"][k][0]:
                raise AssertionError(f"{label}: {k} launched {total} times over the ranks, "
                                     f"{ref['counts'][k][0]} in one process")
        for what, rtol in (("first_loss", FIRST_LOSS_RTOL), ("final_loss", FINAL_LOSS_RTOL)):
            want = ref[what]
            rels = [abs(r[what] - want) / abs(want) for r in per_rank]
            print(f"  {label}: {what} {[r[what] for r in per_rank]} vs one process {want:.6f}: "
                  f"relative difference {max(rels):.3e} (rtol {rtol})")
            if not (math.isfinite(want) and max(rels) <= rtol):
                raise AssertionError(f"{label}: {what} {[r[what] for r in per_rank]} vs one "
                                     f"process {want}")
        runs.append((label, per_rank, ref))
    return runs


def check_split_extras(ranks, card, launches) -> list:
    """The second two-rank spawn's ``--single_kernel`` runs (every rank reports the
    slowest rank's stats, ``SAG_KEYS``, positive and finite; K1 and K4 and
    no other kernel, no plain call) and its ``measure_comm`` rows (every
    rank's equal, each against ``results/comm_measured.csv``'s row).
    Returns the ``--single_kernel`` stats by label."""
    sag = []
    for j, (label, _) in enumerate(SPLIT_SAG):
        per_rank = [rk[j] for rk in ranks]
        stats = per_rank[0]["stats"]
        for rank, r in enumerate(per_rank):
            check_launches(f"{label} rank {rank}", r["counts"], ("K1", "K4"))
            if set(r["stats"]) != SAG_KEYS or r["stats"] != stats:
                raise AssertionError(f"{label} rank {rank}: {r['stats']} vs rank 0 {stats}")
        if not all(math.isfinite(v) and v > 0 for v in stats.values()):
            raise AssertionError(f"{label}: {stats}")
        for k in KERNELS:
            launches[k] += sum(r["counts"][k][0] for r in per_rank)
        print(f"  {label} (the slowest of 2 ranks): SAG {stats['ms']:.4f} ms a round, "
              f"dispatch-chained {stats['dispatch_chained_ms']:.4f} ms, SDDMM "
              f"{stats['sddmm_ms']:.4f} ms; launches a rank "
              + " / ".join(f"K1 {r['counts']['K1'][0]} K4 {r['counts']['K4'][0]}"
                           for r in per_rank) + f"  (card: {card})")
        sag.append((label, stats))
    per_rank = [rk[len(SPLIT_SAG)] for rk in ranks]
    rows = per_rank[0]["rows"]
    with open(COMM_REFERENCE) as f:
        want = {(r["dataset"], int(r["shards"])): r for r in csv.DictReader(f)}
    columns = measure_comm.HEADER.split(",")
    for rank, r in enumerate(per_rank):
        check_launches(f"measure_comm rank {rank}", r["counts"], ("K1",))
        if r["rows"] != rows:
            raise AssertionError(f"measure_comm rank {rank}: {r['rows']} vs rank 0 {rows}")
    for k in KERNELS:
        launches[k] += sum(r["counts"][k][0] for r in per_rank)
    name, shard_counts = SPLIT_COMM
    for row, g in zip(rows, shard_counts):
        got, ref = dict(zip(columns, row.split(","))), want[(name, g)]
        bad = [c for c in COMM_EQUAL if got[c] != ref[c]]
        if bad or got["ratio_measured_vs_model"] != "1.000":
            raise AssertionError(f"measure_comm over 2 ranks {name} {g}: {row} against the JAX "
                                 f"row {ref} (columns {bad} differ)")
        print(f"  measure_comm over 2 ranks: {row} (the JAX row's columns; card: {card})")
    return sag


def phase_feature_procs(dev, card) -> tuple[list, list, dict]:
    """Phase 22: the feature axis over processes, one feature shard a rank
    (``rank_backend``: gloo on this one card unless the machine has a card
    a rank).  The one-process mesh runs ``SPLIT_RUNS`` holds the ranks to;
    four ranks over 2x2 and two over reddit's 1x2, each rank through
    ``train.main`` (``check_rank_runs``); two more ranks run
    ``--single_kernel`` and ``measure_comm`` (``check_split_extras``); then
    one ``torchrun`` CLI run of pubmed AGNN 2x2 over four processes.
    Returns the runs, the ``--single_kernel`` stats and each kernel's
    launches summed over every rank's runs."""
    refs = {}
    launches = {k: 0 for k in KERNELS}
    tasks = {w: [("train", label, argv) for label, argv, _, _ in SPLIT_RUNS[w]] for w in (4, 2)}
    extras = [("single_kernel", label, argv) for label, argv in SPLIT_SAG]
    extras.append(("measure_comm", "measure_comm",
                   ["--datasets", SPLIT_COMM[0], "--shards", *map(str, SPLIT_COMM[1])]))
    (b4, d4), (b2, d2) = rank_backend(4), rank_backend(2)
    for label, argv, expected, _ in SPLIT_RUNS[4]:
        one_process_run(label, argv, expected, refs, card)
    # Reddit's 2 ranks (its host pass, then its epochs) and the 2 ranks of
    # the other tasks run beside the rest: reddit's one-process run, then
    # the 4 ranks, then the torchrun run.  Each rank's times are taken with
    # the others on the host and the card.
    print("  reddit's 2 ranks and 2 ranks of --single_kernel and measure_comm run beside "
          "reddit's one-process run, the 4 ranks and the torchrun run")
    t1 = time.perf_counter()
    with Sampled(mem_available, min) as low, \
            ranks_running(2, b2, d2, tasks[2], "22") as wait2, \
            ranks_running(2, b2, d2, extras, "22") as wait_extras:
        for label, argv, expected, _ in SPLIT_RUNS[2]:
            one_process_run(label, argv, expected, refs, card)
        with ranks_running(4, b4, d4, tasks[4], "22") as wait4:
            ranks4 = wait4(600)
        print(f"  4 ranks ran {len(tasks[4])} tasks by {time.perf_counter() - t1:.1f} s")
        runs = check_rank_runs(SPLIT_RUNS[4], ranks4, refs, card, launches, b4, " ranks=2x2")
        label, argv, _, _ = SPLIT_RUNS[4][1]
        cli = torchrun_train_ms(b4, d4.format(rank=0) if b4 == "gloo" else "cuda", card,
                                nproc=4, argv=argv)
        ranks_extras = wait_extras(600)
        print(f"  2 ranks ran {len(extras)} tasks by {time.perf_counter() - t1:.1f} s")
        ranks2 = wait2(600)
        print(f"  reddit's 2 ranks ran {len(tasks[2])} task in {time.perf_counter() - t1:.1f} s")
    print(f"  the host's available memory fell to {low.value / 2**30:.2f} GiB while the ranks "
          f"ran (card host: {card})")
    runs += check_rank_runs(SPLIT_RUNS[2], ranks2, refs, card, launches, b2, " ranks=1x2")
    sag = check_split_extras(ranks_extras, card, launches)
    want = refs[label]["final_loss"]
    if not (abs(cli["final_loss"] - want) <= FINAL_LOSS_RTOL * abs(want)
            and cli["route"].endswith(" ranks=2x2")):
        raise AssertionError(f"torchrun {label}: final loss {cli['final_loss']} vs one process "
                             f"{want}, route {cli['route']}")
    return runs + [(f"torchrun 4 processes {label}", cli, None)], sag, launches


def build_kernels():
    """One nvcc per source and the native SGT pass's g++, all started
    together; prints ``-Xptxas -v``, the g++ flags and each build's
    seconds.  A failed build raises."""
    t0 = time.perf_counter()

    def build_native() -> tuple[float, bool]:
        t = time.perf_counter()
        found = native.library_path(native.BUILD_DIR).exists()
        native.build(native.BUILD_DIR)
        return time.perf_counter() - t, found

    sources = (*KERNEL_SOURCES, "nll")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        native_build = pool.submit(build_native)
        list(pool.map(lambda name: _kernels.build(name, verbose=True), sources))
        native_s, found = native_build.result()
    for name in sources:
        _kernels.load(name)
    print(f"K1-K10 and NLL build (nvcc, sm_90a, {len(sources)} sources at once): "
          f"{time.perf_counter() - t0:.2f} s")
    if not native.available():
        raise RuntimeError(f"the native SGT pass did not load: {native.error()}")
    print(f"native SGT pass: {native.CXX} {' '.join(native.FLAGS)} {native.SRC.name} -> "
          f"{native.library_path(native.BUILD_DIR).name}: "
          f"{'found built, ' if found else ''}{native_s:.2f} s")


class Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


class SyntheticCache:
    """``train.load_dataset`` with the synthesized reddit dataset kept in
    this process and copied for each run (a run may permute its dataset in
    place: the mesh's shard balance): each trainer run of the smoke's
    process after the first skips reddit's ~20 s synthesis.  Spawned ranks
    synthesize their own."""

    def __init__(self, load):
        self.load, self.kept = load, {}

    def __call__(self, args):
        if args.dataset != "reddit":
            return self.load(args)
        key = (args.dataset, args.dim, args.classes, args.seed, args.data_dir)
        if key not in self.kept:
            self.kept[key] = self.load(args)
        return copy.deepcopy(self.kept[key])


def run_main(args) -> dict:
    """``train.main(args)`` with its output printed as it comes; raises
    unless it printed ``SGT pass:\tnative`` (every trainer run tiles its
    graph with the native host pass)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        r = train.main(args)
    if "SGT pass:\tnative\n" not in buf.getvalue():
        raise AssertionError(f"train.main {' '.join(args)}: no 'SGT pass:\tnative' line")
    return r


def launch_counts() -> dict:
    """Each kernel's (launches, plain calls) since ``reset_counts``."""
    return {k: (sum(w.launches for w in ws), sum(w.plain_calls for w in ws))
            for k, (_, _, _, ws) in KERNELS.items()}


def check_launches(label, counts, expected) -> None:
    """Raise unless the kernels ``expected`` launched, no other kernel of
    K1-K10 did and no plain version ran."""
    if (any(counts[k][0] <= 0 for k in expected)
            or any(c[0] for k, c in counts.items() if k not in expected)
            or any(c[1] for c in counts.values())):
        raise AssertionError(f"{label}: expected launches of {expected} and no other "
                             f"kernel, no plain calls; got {counts}")


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
    train.load_dataset = SyntheticCache(train.load_dataset)

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
        runs, launches, reddit_errs, reddit_records, prep_stages, reddit = phase_train(
            data_dir, dev, card)
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
    nll_err, nll_records = phase_nll(dev, card)
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

    # ---- 13b. the halo-overlap split --------------------------------------------
    t0 = phase_start("13b. the halo-overlap split (every shard on this card)")
    overlap_dir = tempfile.TemporaryDirectory()  # phase 21's ranks read it too
    write_npz(overlap_dir.name, "asymmetric", asymmetric_graph)
    phase_overlap_ops(dev)
    overlap_mesh_runs, overlap_launches = phase_overlap_train(overlap_dir.name, dev, card)
    for k, c in overlap_launches.items():
        launches[k] += c
    phase_end(t0)

    # ---- 14. --single_kernel ----------------------------------------------------
    t0 = phase_start("14. --single_kernel on each route")
    sag_runs, sag_launches = phase_single_kernel(reddit, dev)
    for k, c in sag_launches.items():
        launches[k] += c
    phase_end(t0)

    # ---- 15. checkpoints ------------------------------------------------------
    t0 = phase_start("15. checkpoints, --resume, --save_params / --load_params")
    for k, c in phase_checkpoints(dev).items():
        launches[k] += c
    phase_end(t0)

    # ---- 16. the AE harness ---------------------------------------------------
    t0 = phase_start("16. the AE harness: sweep, incumbents, ledger, parity")
    with tempfile.TemporaryDirectory() as out_dir:
        for k, c in phase_ae_harness(out_dir).items():
            launches[k] += c
    phase_incumbent_grads(dev)
    phase_end(t0)

    # ---- 17. the distributed block-diagonal route ------------------------------
    t0 = phase_start("17. the distributed block-diagonal route (every shard on this card)")
    phase_bd_mesh_ops(dev)
    bd_mesh_runs, bd_mesh_launches = phase_bd_mesh_train(dev, card)
    for k, c in bd_mesh_launches.items():
        launches[k] += c
    phase_end(t0)

    # ---- 18. the distributed streamed route and the chunk fallback -------------
    t0 = phase_start("18. the distributed streamed route and the chunk fallback (every shard "
                     "on this card)")
    t1 = time.perf_counter()
    shard_times = phase_stream_mesh_ops(reddit, dev, card)
    print(f"  op check and timing done in {time.perf_counter() - t1:.1f} s")
    stream_runs, stream_launches = phase_stream_mesh_train(reddit, dev, card)
    for k, c in stream_launches.items():
        launches[k] += c
    reddit_ds = reddit[2]
    del reddit
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_chunk_fallback_ops(ds, dev)
    print(f"  chunk fallback check done in {time.perf_counter() - t1:.1f} s")
    phase_end(t0)

    # ---- 19. traffic accounting -----------------------------------------------
    t0 = phase_start("19. traffic accounting: measure_comm, partition_stats, scaling (every "
                     "shard on this card)")
    for k, c in phase_traffic(dev, card, {"reddit": reddit_ds}).items():
        launches[k] += c
    del reddit_ds
    phase_end(t0)

    # ---- 20. the headline bench ------------------------------------------------
    t0 = phase_start("20. the headline bench (bench.headline: pubmed GCN bf16, AGNN datum)")
    headline_line, headline_launches = phase_headline(card)
    for k, c in headline_launches.items():
        launches[k] += c
    phase_end(t0)

    # ---- 21. the mesh over processes -------------------------------------------
    t0 = phase_start(f"21. the mesh over processes ({MESH_RANKS} ranks, torch.distributed)")
    torch.cuda.empty_cache()
    proc_runs, proc_launches, overlap_figures = phase_mesh_procs(
        mesh_runs + overlap_mesh_runs + bd_mesh_runs + stream_runs, dev, card, overlap_dir.name)
    overlap_dir.cleanup()
    for k, c in proc_launches.items():
        launches[k] += c
    phase_end(t0)

    # ---- 22. the feature axis over processes -----------------------------------
    t0 = phase_start("22. the feature axis over processes (4 ranks over 2x2, 2 over reddit's "
                     "1x2, one feature shard a rank)")
    torch.cuda.empty_cache()
    split_runs, split_sag, split_launches = phase_feature_procs(dev, card)
    for k, c in split_launches.items():
        launches[k] += c
    phase_end(t0)

    for (k, geo, d), (kt, pt, dev) in times.items():
        print(f"  time {KERNELS[k][0]} {geo} d={d}: kernel {kt:.4f} ms (device {dev:.4f} ms), "
              f"plain {pt:.4f} ms (median of {TIMING_RUNS} event pairs a call; device: one "
              f"pair around {TIMING_RUNS} calls; card: {card})")

    for name, r in runs:
        print(f"main path [{name}]: dense_tiles {r['dense_tiles']}  streamed {r['streamed']}  "
              f"block_diag {r['block_diag']}  TC_Blocks {r['tc_blocks']}  "
              f"Prep. (ms) {r['prep_ms']:.3f}  Prep host (ms) {r['prep_host_ms']:.3f} "
              f"(SGT pass {r['host_pass']})  "
              f"Train (ms) {r['train_ms']:.3f}  First loss {r['first_loss']:.6f}  "
              f"Final loss {r['final_loss']:.6f}  peak host RSS {r['peak_rss'] / 2**30:.2f} GiB  "
              f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB  "
              f"capture {r['capture_s']:.3f} s  launches an epoch "
              + " ".join(f"{k} {c}" for k, c in r["step_launches"].items() if c)
              + f"  run {r['seconds']:.1f} s  (card: {card})")
    for name, r in mesh_runs + overlap_mesh_runs + bd_mesh_runs + stream_runs:
        print(f"main path [{name}]: {r['route']}  TC_Blocks {r['tc_blocks']}  "
              f"Prep. (ms) {r['prep_ms']:.3f}  Prep host (ms) {r['prep_host_ms']:.3f}  "
              f"Train (ms) {r['train_ms']:.3f}  "
              f"First loss {r['first_loss']:.6f}  Final loss {r['final_loss']:.6f}  "
              f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB  "
              f"capture {r['capture_s']:.3f} s  launches an epoch "
              + " ".join(f"{k} {c}" for k, c in r["step_launches"].items())
              + f"  run {r['seconds']:.1f} s  (card: {card}; one card held all shards, "
              "replays)")
    for k, t in shard_times.items():
        print(f"  {KERNELS[k][0]} reddit 2x2 heaviest shard: {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}), bound {t['bound'][0]:.4f} ({t['bound'][1]}), library "
              f"(device) {t['library_ms']:.4f} (card: {card})")
    print("reddit Prep host (ms) by stage: " + json.dumps(
        {p: {k: round(v, 3) for k, v in st.items()} for p, st in prep_stages.items()})
          + f" (card host: {card})")
    print(f"headline: {json.dumps(headline_line)}  (card: {card})")
    for name, per_rank, _ in proc_runs[:-1]:
        print(f"mesh over processes [{name}]: Train (ms) "
              + " / ".join(f"{r['train_ms']:.3f}" for r in per_rank)
              + "  max_memory_allocated (GiB) "
              + " / ".join(f"{r['max_memory_allocated'] / 2**30:.2f}" for r in per_rank)
              + f"  (rank 0 / rank 1; card: {card})")
    print(f"mesh over processes [{proc_runs[-1][0]}]: Train (ms) {proc_runs[-1][1]['train_ms']:.3f}"
          f" (card: {card})")
    print(f"overlap evidence [soc-BlogCatalog gcn --mesh 2x1, rank 0 of 2]: host wait on the "
          f"exchanges {overlap_figures['wait_ms']:.3f} ms a step, K1 inside it "
          f"{overlap_figures['k1_in_wait_ms']:.3f} ms a step of {overlap_figures['k1_ms']:.3f} "
          f"(card: {card})")
    for name, per_rank, _ in split_runs[:-1]:
        print(f"one feature shard a rank [{name}]: Train (ms) "
              + " / ".join(f"{r['train_ms']:.3f}" for r in per_rank)
              + "  max_memory_allocated (GiB) "
              + " / ".join(f"{r['max_memory_allocated'] / 2**30:.2f}" for r in per_rank)
              + "  peak host RSS (GiB) "
              + " / ".join(f"{r['peak_rss'] / 2**30:.2f}" for r in per_rank)
              + f"  (rank 0 / 1 / ...; card: {card})")
    print(f"one feature shard a rank [{split_runs[-1][0]}]: Train (ms) "
          f"{split_runs[-1][1]['train_ms']:.3f} (card: {card})")
    for name, stats in split_sag:
        print(f"--single_kernel over 2 ranks [{name}]: " + "  ".join(
            f"{k} {v:.6g}" for k, v in stats.items()) + f"  (card: {card})")
    for name, stats in sag_runs:
        print(f"--single_kernel [{name}]: " + "  ".join(
            f"{k} {v:.6g}" for k, v in stats.items()) + f"  (card: {card})")
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
    kernels.append({"name": "nll (NLL)", "route": "cuda", "source": "tcgnn_tpu_torch/csrc/nll.cu",
                    "replaces": NLL_REPLACES, "launches": launches["NLL"],
                    "max_abs_err": nll_err, **nll_records[0], "shapes": nll_records})
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


# ---- the NLL loss (phases 11 and 12) ------------------------------------------

# (graph, N, C): Yeast's, amazon0505's and reddit's nodes and classes.
NLL_SHAPES = (("Yeast", 1_714_644, 2), ("amazon0505", 410_236, 22), ("reddit", 232_965, 41))
NLL_REPLACES = "none: the JAX package's one-hot NLL (tcgnn_tpu/train.py:180)"


def check_nll_launches(label, wrapped, ran, epochs) -> None:
    """Raise unless a one-device run's loss went through the NLL kernel
    pair, one forward and one backward a step: the wrapper counts the
    ``CAPTURE_WARMUP`` eager steps and the capture; the card runs every
    epoch, the eager steps and the replays (the capture runs nothing, and
    its epoch is the first replay); no plain version ran."""
    want = (2 * (CAPTURE_WARMUP + 1), 2 * epochs, 0)
    if (wrapped, ran, nll_loss.plain_calls) != want:
        raise AssertionError(f"{label}: NLL launches {wrapped} by the wrapper, {ran} on the "
                             f"card, plain calls {nll_loss.plain_calls}; expected {want}")


def phase_nll(dev, card) -> tuple[float, list]:
    """Phase 12's NLL kernel pair at each of ``NLL_SHAPES``.  First held to
    ``F.nll_loss``, a tenth of the labels -100 and then none: the loss
    within rtol 1e-5, the gradient to the bit.  Then, over labels with no
    -100 (the step's), forward and backward together (the loss and
    ``torch.autograd.grad``) timed as every kernel of the smoke is (event
    ms, device ms of back-to-back calls) and by the profiler's device time
    of all their operations (``kernel_ms``: the autograd seed's fill and
    the ticket's memset included), beside the plain version, the library's
    many-block form ``F.nll_loss(..., reduction="none").mean()``
    (``library_*``), ``F.nll_loss``'s one-block reduction (``reduce_*``)
    and the bound (the labels read once, one f32 of ``logp`` a row, the N x
    C gradient written once, at 3.35 TB/s).  Returns the largest error and
    a record a shape."""
    err, rows = 0.0, []
    for name, n, c in NLL_SHAPES:
        rng = np.random.default_rng(n)
        logits = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(dev)
        logp = torch.log_softmax(logits, 1).requires_grad_(True)
        labels = rng.integers(0, c, n)

        def pair(fn, y):
            def run():
                loss = fn(logp, y)
                return loss, torch.autograd.grad(loss, logp)[0]
            return run

        def unreduced(lp, y):
            return F.nll_loss(lp, y, reduction="none").mean()

        y = torch.from_numpy(labels).to(dev)
        ignored = labels.copy()
        ignored[rng.random(n) < 0.1] = -100
        for labelled in (torch.from_numpy(ignored).to(dev), y):
            got, want = pair(nll_loss, labelled)(), pair(F.nll_loss, labelled)()
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"nll {name}: the kernel's gradient is not F.nll_loss's")
            err = max(err, (got[0] - want[0]).abs().item())
        kernel, plain = pair(nll_loss, y), pair(nll_loss_torch, y)
        library, reduce = pair(unreduced, y), pair(F.nll_loss, y)
        torch.testing.assert_close(library()[0], kernel()[0], rtol=1e-5, atol=0)
        event, plain_event, device = timed_pair(kernel, plain)
        bound = (8 * n + 4 * n + 4 * n * c) / 3.35e12 * 1e3
        row = {"graph": name, "n": n, "c": c, "ms": event, "device_ms": device,
               "kernel_ms": kernel_ms(kernel), "plain_ms": plain_event,
               "library_ms": median_ms(library), "library_device_ms": device_ms(library),
               "library_kernel_ms": kernel_ms(library), "reduce_ms": median_ms(reduce),
               "reduce_device_ms": device_ms(reduce), "reduce_kernel_ms": kernel_ms(reduce),
               "bound_ms": bound, "bound_by": "bytes"}
        rows.append(row)
        print(f"  nll {name} N {n} C {c}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if isinstance(v, float))
              + f" (card: {card})", flush=True)
    return err, rows


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        ab_main(sys.argv[2])
    elif len(sys.argv) == 1:
        main()
    else:
        raise SystemExit("usage: python3 chip_smoke.py [--ab OTHER_CSRC_DIR]")
