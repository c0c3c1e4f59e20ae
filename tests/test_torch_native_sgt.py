"""The port's native (C++/OpenMP) SGT pass against its NumPy pass, and its
orderings against the JAX package's native ones.

Mirrors ``tests/test_native_sgt.py`` case for case, on the port: every array
``impl="native"`` gives must equal the one ``impl="numpy"`` gives, bit for
bit.  Also: ``sgt.cpp`` is a byte-identical copy of the JAX package's (read
as data: the port never reads the JAX file); the native RCM and community
orderings equal the JAX package's native ones; eight processes building
into one empty directory at once all load one working library; without the
library ``impl="native"`` raises with the build's error and ``impl="auto"``
says which pass it took.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tcgnn_tpu.sgt.native as jax_native
from tcgnn_tpu.sgt import reorder as jax_reorder
from tcgnn_tpu_torch.config import TileConfig
from tcgnn_tpu_torch.data import coo_to_csr, powerlaw_graph
from tcgnn_tpu_torch.graph import TiledGraph
from tcgnn_tpu_torch.sgt import blockdiag as bd
from tcgnn_tpu_torch.sgt import native
from tcgnn_tpu_torch.sgt import reorder as port_reorder
from tcgnn_tpu_torch.sgt.translate import (
    build_a_tiles_host,
    count_blocks,
    sparse_graph_translate,
    transpose_csr,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = [TileConfig(blk_h=8, blk_w=8, edge_chunk=8), TileConfig()]
CHUNK_FIELDS = ("chunk_r", "chunk_c", "chunk_edge_id", "chunk_block", "chunk_window",
                "chunk_first_in_window", "chunk_first_in_block", "edge_perm")


@pytest.fixture(scope="module", autouse=True)
def library():
    if not native.available():
        pytest.fail(f"the native SGT pass did not build: {native.error()}")


def make_graph(n, e, seed=0):
    src, dst = powerlaw_graph(n, e, seed=seed)
    return coo_to_csr(src, dst, n)


def assert_same(a, b, fields, tag=""):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f"{f} {tag}"
        np.testing.assert_array_equal(x, y, err_msg=f"{f} {tag}")


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("n,e", [(100, 600), (1000, 8000)])
def test_native_matches_numpy(cfg, n, e):
    indptr, indices = make_graph(n, e, seed=n)
    m_np = sparse_graph_translate(indptr, indices, n, cfg, impl="numpy", emit_chunks=True)
    m_nat = sparse_graph_translate(indptr, indices, n, cfg, impl="native", emit_chunks=True)
    assert_same(m_np, m_nat, ("block_partition", "col_ids", "edge_pos", "block_window",
                              "block_first_in_window") + CHUNK_FIELDS)
    assert m_np.num_real_blocks == m_nat.num_real_blocks


@pytest.mark.parametrize("cfg", CFGS)
def test_fused_tiles_match_bincount(cfg):
    indptr, indices = make_graph(500, 3000, seed=7)
    m = sparse_graph_translate(indptr, indices, 500, cfg, impl="native", build_tiles=True)
    ref = np.bincount(m.edge_pos, minlength=m.num_blocks * cfg.blk_h * cfg.blk_w).astype(
        np.int8).reshape(m.num_blocks, cfg.blk_h, cfg.blk_w)
    assert m.a_tiles.dtype == np.int8
    np.testing.assert_array_equal(m.a_tiles, ref)
    np.testing.assert_array_equal(build_a_tiles_host(m), m.a_tiles)
    m_np = sparse_graph_translate(indptr, indices, 500, cfg, impl="numpy", build_tiles=True)
    assert_same(m, m_np, ("a_tiles",))


def test_count_blocks_matches_translate():
    cfg = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)
    indptr, indices = make_graph(700, 4000, seed=11)
    m = sparse_graph_translate(indptr, indices, 700, cfg, impl="numpy")
    for impl in ("native", "numpy"):
        assert count_blocks(indptr, indices, 700, cfg, impl=impl) == m.num_blocks


def test_lite_meta_has_no_chunks():
    cfg = TileConfig(blk_h=8, blk_w=8, edge_chunk=8)
    indptr, indices = make_graph(200, 900, seed=3)
    m = sparse_graph_translate(indptr, indices, 200, cfg, impl="native")
    assert m.chunk_block is None and m.num_chunks == 0
    with pytest.raises(ValueError, match="emit_chunks"):
        m.to_chunks("cpu")
    assert m.to("cpu").col_ids is not None


@pytest.mark.parametrize("blk_h,blk_w", [(16, 8), (16, 16), (128, 128)])
def test_naive_count_matches_a_window_walk(blk_h, blk_w):
    """``naive_count``: per window, the tiles of a sliding ``blk_w``-wide
    window over the sorted distinct columns (the reference's uncondensed
    count), here walked in Python."""
    n = 700
    indptr, indices = make_graph(n, 5000, seed=12)
    want = []
    for start in range(0, n, blk_h):
        cols = np.unique(indices[indptr[start]:indptr[min(start + blk_h, n)]])
        tiles, i = 0, 0
        while i < len(cols):
            i = int(np.searchsorted(cols, cols[i] + blk_w))
            tiles += 1
        want.append(tiles)
    got = native.naive_count(indptr, indices, blk_h, blk_w)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_native_transpose_matches_numpy():
    rng = np.random.default_rng(5)
    n, e = 700, 4000
    ptr, cols = coo_to_csr(rng.integers(0, n, e), rng.integers(0, n, e), n)
    for got, want in zip(transpose_csr(ptr, cols, n, impl="native"),
                         transpose_csr(ptr, cols, n, impl="numpy")):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_native_chunk_layout_matches_numpy():
    rng = np.random.default_rng(6)
    n, e = 900, 7000
    ptr, cols = coo_to_csr(rng.integers(0, n, e), rng.integers(0, n, e), n)
    cfg = TileConfig(blk_h=64, blk_w=32, edge_chunk=16)
    m_nat = sparse_graph_translate(ptr, cols, n, cfg, impl="native", emit_chunks=True)
    m_np = sparse_graph_translate(ptr, cols, n, cfg, impl="numpy", emit_chunks=True)
    assert_same(m_nat, m_np, CHUNK_FIELDS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_vs_numpy_fuzz_multigraph(seed):
    """Random multigraphs (duplicate edges, empty windows, isolated tail
    rows): both passes agree on every field they emit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    e = int(rng.integers(10, 2000))
    src = rng.integers(0, max(n - 7, 1), e)  # leave empty tail windows
    dst = rng.integers(0, max(n - 7, 1), e)
    dup = rng.integers(0, e, e // 3)  # force duplicate edges
    ptr, cols = coo_to_csr(np.concatenate([src, src[dup]]), np.concatenate([dst, dst[dup]]), n)
    cfg = TileConfig(blk_h=32, blk_w=16, edge_chunk=8)
    m_nat = sparse_graph_translate(ptr, cols, n, cfg, impl="native", build_tiles=True,
                                   emit_chunks=True)
    m_np = sparse_graph_translate(ptr, cols, n, cfg, impl="numpy", build_tiles=True,
                                  emit_chunks=True)
    assert_same(m_nat, m_np, ("block_partition", "col_ids", "block_window",
                              "block_first_in_window", "edge_pos", "a_tiles") + CHUNK_FIELDS,
                f"seed={seed}")
    assert m_nat.num_real_blocks == m_np.num_real_blocks


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_vs_numpy_bd_extract_fuzz(seed):
    """The native block-diagonal extraction (``sgt_bd_hist``/``sgt_bd_fill``)
    against the NumPy one on random banded, power-law and multigraph inputs:
    the same selection, streams, tile contents and packed indices."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 2500))
    e = int(rng.integers(2, 6 * n))
    mode = seed % 4
    src = rng.integers(0, n, e)
    if mode == 3:  # unbanded (power-law-ish): exercises the None gate
        dst = rng.integers(0, n, e)
    else:
        band = int(rng.integers(1, 300))
        dst = np.clip(src + rng.integers(-band, band + 1, e), 0, n - 1)
    if mode == 1:  # duplicate edges (multigraph tile counts)
        dup = rng.integers(0, e, e // 8)
        src = np.concatenate([src, src[dup]])
        dst = np.concatenate([dst, dst[dup]])
    ptr, cols = coo_to_csr(src, dst, n)
    for cand in (None, (0, -1, 1)):
        kw = dict(bin_rows=128, candidate_offsets=cand,
                  min_coverage=0.0 if mode == 2 else 0.85)
        m_nat = bd.extract_block_diag(ptr, cols, n, impl="native", **kw)
        m_np = bd.extract_block_diag(ptr, cols, n, impl="numpy", **kw)
        assert (m_nat is None) == (m_np is None), (seed, cand)
        if m_nat is None:
            continue
        assert m_nat.offsets == m_np.offsets
        assert abs(m_nat.coverage - m_np.coverage) < 1e-12
        assert m_nat.tile_cnt.dtype == m_np.tile_cnt.dtype
        np.testing.assert_array_equal(m_nat.packed_cov_idx(), m_np.packed_cov_idx())
        for f in ("tile_idx", "tile_cnt", "cov_edge_ids", "cov_flat_idx", "res_ptr", "res_idx",
                  "res_edge_ids"):
            x, y = getattr(m_nat, f), getattr(m_np, f)
            if x is None and y is None:
                continue
            np.testing.assert_array_equal(x, y, err_msg=f"{f} seed={seed}")


def test_outputs_do_not_depend_on_the_thread_count(monkeypatch):
    """The same arrays on one OpenMP thread (a small graph's count) and on
    all of them (``EDGES_PER_THREAD`` at 1)."""
    from tcgnn_tpu_torch.data.synthetic import component_union_graph

    n = 3000
    rp, ci = coo_to_csr(*component_union_graph(n, 9000, 100, seed=5), n)
    cfg = TileConfig(blk_h=64, blk_w=32, edge_chunk=16)

    def passes():
        return (sparse_graph_translate(rp, ci, n, cfg, build_tiles=True, emit_chunks=True),
                transpose_csr(rp, ci, n), bd.extract_block_diag(rp, ci, n),
                port_reorder.rcm_permutation(rp, ci, n),
                port_reorder.community_permutation(rp, ci, n))

    one = passes()
    monkeypatch.setattr(native, "EDGES_PER_THREAD", 1)
    many = passes()
    assert_same(one[0], many[0], ("col_ids", "edge_pos", "a_tiles") + CHUNK_FIELDS)
    for a, b in zip(one[1], many[1]):
        np.testing.assert_array_equal(a, b)
    assert_same(one[2], many[2], ("tile_idx", "tile_cnt", "cov_edge_ids", "cov_flat_idx",
                                  "cov_pack_idx"))
    for a, b in zip(one[3:], many[3:]):
        np.testing.assert_array_equal(a, b)


def test_source_is_byte_identical():
    with open(os.path.join(REPO, "tcgnn_tpu", "sgt", "native", "sgt.cpp"), "rb") as f:
        assert native.SRC.read_bytes() == f.read()


def band(n=1500, seed=4):
    """A symmetric banded graph under a random relabeling."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4000)
    dst = np.clip(src + rng.integers(-60, 61, 4000), 0, n - 1)
    label = rng.permutation(n)
    src, dst = label[src], label[dst]
    return n, *coo_to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)


def ordering_graph(kind):
    """The three graphs of ``test_torch_reorder.py``."""
    if kind == "band":
        return band()
    n = 400
    src, dst = powerlaw_graph(n, 2500, seed=6)
    if kind == "directed":
        keep = (src < dst) | (src % 3 == 0)
        src, dst = src[keep], dst[keep]
    return n, *coo_to_csr(src, dst, n)


@pytest.mark.parametrize("kind", ["band", "powerlaw", "directed"])
@pytest.mark.parametrize("method", ["rcm", "community"])
def test_orderings_match_jax_native(monkeypatch, kind, method):
    if jax_native.load() is None:  # it lost the test workers' build race: once more
        monkeypatch.setattr(jax_native, "_tried", False)
        if jax_native.load() is None:
            pytest.skip("the JAX package's native library did not load")
    n, rp, ci = ordering_graph(kind)
    port_fn = getattr(port_reorder, f"{method}_permutation")
    jax_fn = getattr(jax_reorder, f"{method}_permutation")
    got = port_fn(rp, ci, n)
    np.testing.assert_array_equal(got, jax_fn(rp, ci, n))
    assert got.dtype == np.int64 and np.array_equal(np.sort(got), np.arange(n))


BUILD_AND_RUN = """
import importlib.util, sys
from pathlib import Path
import numpy as np
spec = importlib.util.spec_from_file_location("sgt_native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.BUILD_DIR = Path(sys.argv[2])
ptr = np.array([0, 2, 4, 5, 6], np.int64)
cols = np.array([1, 2, 0, 3, 0, 1], np.int32)
assert native.available(), native.error()
print(native.rcm(ptr, cols).tolist(), native.library_path(native.BUILD_DIR).name)
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Eight processes that find the build directory empty at once: one
    compiles, the others wait on the lock, and all load the same library."""
    build_dir = tmp_path / "build"
    src = os.path.join(REPO, "tcgnn_tpu_torch", "sgt", "native", "__init__.py")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_RUN, src, str(build_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(8)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out for out, _ in outs}) == 1, outs
    files = sorted(f.name for f in build_dir.iterdir())
    assert files == ["libsgt.lock", outs[0][0].split()[-1]], files


def test_without_the_library(monkeypatch):
    """A failed build: ``impl="native"`` raises with the compiler's first
    error line, ``impl="auto"`` takes the NumPy pass and says why, and the
    graph records it."""
    rp, ci = make_graph(300, 1500, seed=2)
    want = sparse_graph_translate(rp, ci, 300, CFGS[0], impl="numpy")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++ failed on sgt.cpp (exit 1):\n"
                        "sgt.cpp:1:1: error: expected unqualified-id\n")
    assert native.error_line() == "sgt.cpp:1:1: error: expected unqualified-id"
    with pytest.raises(RuntimeError, match="unavailable: sgt.cpp:1:1: error"):
        sparse_graph_translate(rp, ci, 300, CFGS[0], impl="native")
    with pytest.raises(RuntimeError, match="unavailable"):
        port_reorder.community_permutation(rp, ci, 300)
    got = sparse_graph_translate(rp, ci, 300, CFGS[0])
    np.testing.assert_array_equal(got.edge_pos, want.edge_pos)
    g = TiledGraph(rp, ci, 300, CFGS[0], device="cpu")
    assert g.host_pass == ("numpy (native build failed: "
                           "sgt.cpp:1:1: error: expected unqualified-id)")
    with pytest.raises(ValueError, match="unknown host pass"):
        sparse_graph_translate(rp, ci, 300, CFGS[0], impl="cuda")


@pytest.mark.parametrize("route", ["condensed", "bd", "chunk", "streamed"])
def test_graph_host_passes_agree(route):
    """``TiledGraph`` on each route: the native and NumPy host passes upload
    the same graph (the SpMM and SDDMM agree bit for bit on the CPU), record
    which pass ran, and time the stages that route runs."""
    if route == "bd":
        from tcgnn_tpu_torch.data.synthetic import component_union_graph

        n = 1500
        rp, ci = coo_to_csr(*component_union_graph(n, 3200, 60, seed=2), n)
    else:
        n = 600
        rp, ci = make_graph(n, 4000, seed=9)
    kw = dict(block_diag=False if route == "condensed" else None,
              dense_tiles=False if route in ("chunk", "streamed") else None,
              streamed=True if route == "streamed" else None)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 5), np.float32))
    graphs = [TiledGraph(rp, ci, n, TileConfig(blk_h=32, blk_w=16, edge_chunk=8), device="cpu",
                         host_pass=p, **kw) for p in ("native", "numpy")]
    for g, p in zip(graphs, ("native", "numpy")):
        assert g.host_pass == p
        assert g.block_diag == (route == "bd") and g.streamed == (route == "streamed")
        stages = {"transpose", "symmetry", "block_counts", "sgt"}
        stages |= {"bd_probe"} if route == "bd" else set()
        stages |= {"segments"} if route == "streamed" else set()
        assert stages <= set(g.prep_stages) and sum(g.prep_stages.values()) <= g.prep_host_s
    torch.testing.assert_close(graphs[0].spmm(x), graphs[1].spmm(x), rtol=0, atol=0)
    torch.testing.assert_close(graphs[0].sddmm(x), graphs[1].sddmm(x), rtol=0, atol=0)
