"""The native (C++/OpenMP) SGT host pass: ``sgt.cpp`` built with g++ and
loaded with ``ctypes`` (counterpart of ``tcgnn_tpu.sgt.native``).

``sgt.cpp`` is a byte-identical copy of the JAX package's source.  Each
function gives the same arrays as the NumPy pass it replaces, bit for bit
(``tests/test_torch_native_sgt.py``): the SGT block count and fill, the
chunk layout, the transpose (a counting sort), the block-diagonal offset
histogram and fill, and the RCM and community orderings.

The library is built at first use, never at import, into
``tcgnn_tpu_torch/_build/`` with the JAX package's flags.  ``-march=native``
compiles for this host's CPU, so the library's name carries a hash of the
source, the flags and the CPU's model and feature flags.  The compiler
writes a temporary file that is renamed into place, under an ``fcntl`` lock
beside it, so processes that start at once (test workers) build it once and
never load a half-written file.  A call runs one OpenMP thread for each
``EDGES_PER_THREAD`` edges of its input, up to the runtime's count: below
that, waking the threads costs more than the work, and processes that share
the CPU (test workers) would oversubscribe it.  The outputs do not depend on
the thread count.  Where the build fails, its stderr is kept
(``error``): callers that asked for the native pass raise with it, and
``impl="auto"`` callers take the NumPy pass and report why
(``pass_name``, which ``TiledGraph.host_pass`` records and the trainer
prints), never silently.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "sgt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX = "g++"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
IMPLS = ("auto", "native", "numpy")
EDGES_PER_THREAD = 1 << 17

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _host_cpu() -> bytes:
    """The CPU that ``-march=native`` compiles for: its model and feature
    flags (``/proc/cpuinfo``), else the machine type."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(sorted({line for line in f
                                    if line.startswith((b"model name", b"flags"))}))
    except OSError:
        return platform.machine().encode()


def library_path(build_dir: Path) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX, *FLAGS]).encode())
    h.update(_host_cpu())
    return build_dir / f"libsgt_{h.hexdigest()[:12]}.so"


def build(build_dir: Path) -> Path:
    """Compile ``sgt.cpp`` into ``build_dir`` unless the library for this
    source, these flags and this CPU is there; returns its path.  Raises
    ``RuntimeError`` with the compiler's output where the build fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libsgt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([CXX, *FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{CXX} could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed on {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    """Every C function's argument types, as the JAX loader declares them."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int
    signatures = {
        "sgt_count": [i64, i32, i32, i64p, i32p, i32p],
        "sgt_fill": [i64, i32, i32, i64p, i32p, i64p, i32p, i64p, ctypes.c_void_p, i32,
                     ctypes.POINTER(ctypes.c_int32)],
        "sgt_naive_count": [i64, i32, i32, i64p, i32p, i64p],
        "sgt_rcm": [i64, i64p, i32p, i32p],
        "sgt_transpose": [i64, i64, i64, i64p, i32p, i64p, i32p, i32p, i64p],
        "sgt_chunk_count": [i64, i64, i64p, i64p],
        "sgt_chunk_fill": [i64, i64, i32, i32, i64p, i64p, i32p, i32p, i32p, i32p, i64p],
        "sgt_community": [i64, i64p, i32p, i32p],
        "sgt_bd_hist": [i64, i32, i64p, i32p, i64, i64p],
        "sgt_bd_fill": [i64, i32, i64, i32, i64p, i64p, i64p, i32p, i64p, i32p, i32p, i32,
                        i64p, i64p, i32p, ctypes.POINTER(ctypes.c_int64), i64p, i32p, i32p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    # The OpenMP runtime the library runs on, found through its handle.
    lib.omp_get_max_threads.argtypes, lib.omp_get_max_threads.restype = [], i32
    lib.omp_set_num_threads.argtypes, lib.omp_set_num_threads.restype = [i32], None


@contextlib.contextmanager
def _threads(lib: ctypes.CDLL, edges: int):
    """Parallel regions started inside run ``edges // EDGES_PER_THREAD``
    threads (at least 1, at most the runtime's count); the calling thread's
    count is restored after."""
    before = lib.omp_get_max_threads()
    lib.omp_set_num_threads(max(1, min(before, int(edges) // EDGES_PER_THREAD)))
    try:
        yield
    finally:
        lib.omp_set_num_threads(before)


def load() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None where the build failed
    (``error`` holds why).  Tried once a process."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build(BUILD_DIR)))
            except (RuntimeError, OSError) as e:
                _error = str(e)
            else:
                _declare(lib)
                _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def error() -> Optional[str]:
    """Why the library is missing (the compiler's output), or None."""
    load()
    return _error


def error_line() -> str:
    """The first line of ``error`` that names an error, else its first line."""
    lines = [ln.strip() for ln in (error() or "").splitlines() if ln.strip()]
    named = [ln for ln in lines if "error" in ln.lower()]
    return (named or lines or [""])[0]


def use(impl: str) -> bool:
    """Whether a host pass called with ``impl`` runs natively: ``"native"``
    needs the library (raises with the build's error where it is missing),
    ``"auto"`` takes it where it loads, ``"numpy"`` never does."""
    if impl not in IMPLS:
        raise ValueError(f"unknown host pass {impl!r}: one of {IMPLS}")
    if impl == "numpy":
        return False
    if impl == "native":
        _require()
        return True
    return available()


def pass_name(impl: str) -> str:
    """Which host pass ``impl`` runs, as the trainer's ``SGT pass:`` line
    gives it: ``native``, ``numpy``, or under ``"auto"`` where the build
    failed, ``numpy (native build failed: <its first error line>)``."""
    if use(impl):
        return "native"
    return "numpy" if impl == "numpy" else f"numpy (native build failed: {error_line()})"


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native SGT pass is unavailable: {error_line()}")
    return lib


def count_blocks(row_ptr: np.ndarray, col_idx: np.ndarray, blk_h: int, blk_w: int) -> np.ndarray:
    """Real TC blocks of each window (0 for an empty one), int32."""
    lib = _require()
    n_rows = len(row_ptr) - 1
    out = np.zeros(max(-(-n_rows // blk_h), 1), np.int32)
    if n_rows:
        with _threads(lib, len(col_idx)):
            lib.sgt_count(n_rows, blk_h, blk_w, np.ascontiguousarray(row_ptr, np.int64),
                          np.ascontiguousarray(col_idx, np.int32), out)
    return out


def naive_count(row_ptr: np.ndarray, col_idx: np.ndarray, blk_h: int, blk_w: int) -> np.ndarray:
    """Per-window naive (uncondensed) sliding-window tile counts, int64."""
    lib = _require()
    n_rows = len(row_ptr) - 1
    out = np.zeros(max(-(-n_rows // blk_h), 1), np.int64)
    if n_rows:
        with _threads(lib, len(col_idx)):
            lib.sgt_naive_count(n_rows, blk_h, blk_w, np.ascontiguousarray(row_ptr, np.int64),
                                np.ascontiguousarray(col_idx, np.int32), out)
    return out


def _ordering(fn_name: str, sym_row_ptr, sym_col_idx) -> np.ndarray:
    lib = _require()
    n = len(sym_row_ptr) - 1
    out = np.zeros(n, np.int32)
    if n:
        with _threads(lib, len(sym_col_idx)):
            getattr(lib, fn_name)(n, np.ascontiguousarray(sym_row_ptr, np.int64),
                                  np.ascontiguousarray(sym_col_idx, np.int32), out)
    return out.astype(np.int64)


def rcm(sym_row_ptr: np.ndarray, sym_col_idx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (``perm[new] = old``) of a
    symmetric CSR."""
    return _ordering("sgt_rcm", sym_row_ptr, sym_col_idx)


def community(sym_row_ptr: np.ndarray, sym_col_idx: np.ndarray) -> np.ndarray:
    """Rabbit-style community permutation (``perm[new] = old``) of a
    symmetric CSR."""
    return _ordering("sgt_community", sym_row_ptr, sym_col_idx)


def transpose(row_ptr: np.ndarray, col_idx: np.ndarray, num_cols: int):
    """Counting-sort CSR transpose: ``(t_ptr int64, t_cols int32, t_src
    int32)``, each transpose row's columns ascending."""
    lib = _require()
    n_rows, nnz = len(row_ptr) - 1, len(col_idx)
    t_ptr = np.zeros(num_cols + 1, np.int64)
    t_cols = np.zeros(nnz, np.int32)
    t_src = np.zeros(nnz, np.int32)
    if nnz:
        with _threads(lib, nnz):
            lib.sgt_transpose(n_rows, num_cols, nnz, np.ascontiguousarray(row_ptr, np.int64),
                              np.ascontiguousarray(col_idx, np.int32), t_ptr, t_cols, t_src,
                              np.zeros(num_cols, np.int64))
    return t_ptr, t_cols, t_src


def chunk_layout(edge_pos: np.ndarray, num_blocks: int, blk_h: int, blk_w: int, ec: int,
                 row_sentinel: int):
    """The uniform chunk layout from each edge's flat tile slot, in one pass:
    ``(chunk_r, chunk_c, chunk_edge_id, edge_perm, chunks_per_block,
    block_chunk_start)``, those of the NumPy layout exactly."""
    lib = _require()
    nnz, tile = len(edge_pos), blk_h * blk_w
    edge_pos = np.ascontiguousarray(edge_pos, np.int64)
    edges_per_block = np.zeros(num_blocks, np.int64)
    if nnz:
        with _threads(lib, nnz):
            lib.sgt_chunk_count(nnz, tile, edge_pos, edges_per_block)
    chunks_per_block = np.maximum(-(-edges_per_block // ec), 1)
    block_chunk_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(chunks_per_block, out=block_chunk_start[1:])
    num_chunks = int(block_chunk_start[-1])
    chunk_r = np.full(num_chunks * ec, row_sentinel, np.int32)
    chunk_c = np.zeros(num_chunks * ec, np.int32)
    chunk_edge_id = np.full(num_chunks * ec, nnz, np.int32)
    edge_perm = np.zeros(nnz, np.int32)
    if nnz:
        with _threads(lib, nnz):
            lib.sgt_chunk_fill(nnz, tile, blk_w, ec, edge_pos, block_chunk_start, chunk_r,
                               chunk_c, chunk_edge_id, edge_perm, np.zeros(num_blocks, np.int64))
    return (chunk_r.reshape(num_chunks, ec), chunk_c.reshape(num_chunks, ec),
            chunk_edge_id.reshape(num_chunks, ec), edge_perm, chunks_per_block,
            block_chunk_start)


def fill(row_ptr: np.ndarray, col_idx: np.ndarray, block_start: np.ndarray, blk_h: int,
         blk_w: int, build_tiles: bool):
    """``(col_ids [B * blk_w], edge_pos [E], a_tiles or None, overflow)``.

    The tiles come back int8; ``overflow`` is True where a tile slot holds
    more than 127 edges, and the caller counts the tiles again in f32 from
    ``edge_pos``."""
    lib = _require()
    n_rows = len(row_ptr) - 1
    num_blocks = int(block_start[-1])
    col_ids = np.zeros(num_blocks * blk_w, np.int32)
    edge_pos = np.zeros(len(col_idx), np.int64)
    a_tiles = np.zeros(num_blocks * blk_h * blk_w, np.int8) if build_tiles else None
    overflow = ctypes.c_int32(0)
    if n_rows:
        with _threads(lib, len(col_idx)):
            lib.sgt_fill(n_rows, blk_h, blk_w, np.ascontiguousarray(row_ptr, np.int64),
                         np.ascontiguousarray(col_idx, np.int32),
                         np.ascontiguousarray(block_start, np.int64), col_ids, edge_pos,
                         a_tiles.ctypes.data_as(ctypes.c_void_p) if build_tiles else None,
                         2 if build_tiles else 0, ctypes.byref(overflow))
    return col_ids, edge_pos, a_tiles, bool(overflow.value)


def bd_hist(row_ptr: np.ndarray, col_idx: np.ndarray, bin_rows: int, nbins: int):
    """The block-offset histogram: the offsets present and their edge
    counts, as ``np.unique(col_bin - row_bin, return_counts=True)``."""
    lib = _require()
    n_rows = len(row_ptr) - 1
    hist = np.zeros(2 * nbins - 1, np.int64)
    if n_rows and len(col_idx):
        with _threads(lib, len(col_idx)):
            lib.sgt_bd_hist(n_rows, bin_rows, np.ascontiguousarray(row_ptr, np.int64),
                            np.ascontiguousarray(col_idx, np.int32), nbins, hist)
    nz = np.nonzero(hist)[0]
    return nz - (nbins - 1), hist[nz]


def bd_fill(row_ptr: np.ndarray, col_idx: np.ndarray, bin_rows: int, nbins: int, offsets,
            k_counts, num_res: int):
    """The covered and residual streams of the block-diagonal decomposition:
    ``(cov_flat, cov_eid, cov_pack, tile_idx, tile_cnt, res_counts,
    res_idx, res_eid)`` (``sgt.cpp:sgt_bd_fill``).  ``res_counts`` holds
    each row's residual degree at ``[r + 1]`` (the caller sums them up);
    ``cov_pack`` is None where the packed index passes int32."""
    lib = _require()
    n_rows, k = len(row_ptr) - 1, len(offsets)
    k_base = np.zeros(k + 1, np.int64)
    np.cumsum(np.asarray(k_counts, np.int64), out=k_base[1:])
    c = int(k_base[-1])
    emit_pack = int(nbins * bin_rows * k * bin_rows < 2**31)
    cov_flat = np.zeros(c, np.int64)
    cov_eid = np.zeros(c, np.int32)
    cov_pack = np.zeros(c if emit_pack else 1, np.int32)
    tile_idx = np.zeros(c, np.int64)
    tile_cnt = np.zeros(c, np.int32)
    res_ptr = np.zeros(n_rows + 1, np.int64)
    res_idx = np.zeros(num_res, np.int32)
    res_eid = np.zeros(num_res, np.int32)
    uniques = ctypes.c_int64(0)
    if n_rows and (c or num_res):
        with _threads(lib, len(col_idx)):
            lib.sgt_bd_fill(n_rows, bin_rows, nbins, k, np.ascontiguousarray(offsets, np.int64),
                            k_base, np.ascontiguousarray(row_ptr, np.int64),
                            np.ascontiguousarray(col_idx, np.int32), cov_flat, cov_eid,
                            cov_pack, emit_pack, np.zeros(c, np.int64), tile_idx, tile_cnt,
                            ctypes.byref(uniques), res_ptr, res_idx, res_eid)
    nu = int(uniques.value)
    return (cov_flat, cov_eid, cov_pack if emit_pack else None, tile_idx[:nu], tile_cnt[:nu],
            res_ptr, res_idx, res_eid)
