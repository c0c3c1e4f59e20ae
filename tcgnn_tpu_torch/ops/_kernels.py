"""Build and load the port's CUDA kernels (``tcgnn_tpu_torch/csrc``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The build runs at
first use, never at import, into ``tcgnn_tpu_torch/_build/`` (listed in
``.gitignore``); the library's name carries a hash of its source and of the
headers beside it (``csrc/*.cuh``), so an edited source is rebuilt and a
current one is reused.  ``call`` launches a C function with the least host
work a call can take: the function looked up once, no device switch when
the tensors lie on the current device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch finds (``CUDA_HOME``), else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source exists.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per kernel).
    """
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
# Every C function of each library, with its argument types: an undeclared
# pointer argument would be cut to 32 bits.  Each returns a cudaError_t.
SIGNATURES = {
    "spmm_dense": {
        "tcgnn_spmm_dense": [_P] * 8 + [_I] * 10 + [_P],
        "tcgnn_spmm_fused": [_P] * 8 + [_I] * 9 + [_P],
    },
    "sddmm_dense": {"tcgnn_sddmm_dense": [_P] * 6 + [_I] * 4 + [_P]},
    "spmm_sfused": {
        "tcgnn_spmm_sfused": [_P] * 7 + [_I] * 5 + [_P],
        "tcgnn_spmm_sfused_bwd": [_P] * 9 + [_I] * 5 + [_P],
    },
    "spmm_bd": {
        "tcgnn_spmm_bd": [_P] * 4 + [_I] * 6 + [_P],
        "tcgnn_bd_sfused": [_P] * 7 + [_I] * 4 + [_P],
        "tcgnn_bd_sfused_bwd": [_P] * 7 + [_I] * 4 + [_P],
    },
    "chunk": {
        "tcgnn_spmm_chunk": [_P] * 5 + [_I] * 4 + [_P],
        "tcgnn_sddmm_chunk": [_P] * 5 + [_I] * 4 + [_P],
    },
    "nll": {
        "tcgnn_nll_forward": [_P] * 5 + [_I] * 3 + [_P],
        "tcgnn_nll_backward": [_P] * 4 + [_I] * 2 + [_P],
    },
    "stamp": {
        "tcgnn_stamp": [_P] * 2 + [_I] * 4 + [_P],
        "tcgnn_graph_nodes": [_P] * 2,
    },
}


def load(name: str, verbose: bool = False) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built at first use, with
    every C function's argument types declared."""
    if name in _loaded and not verbose:
        return _loaded[name]
    lib = ctypes.CDLL(str(build(name, verbose=verbose)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.tcgnn_cuda_error_string.argtypes = [_I]
    lib.tcgnn_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def call(name: str, fn: str, device: torch.device, *args) -> None:
    """Launch C function ``fn`` of library ``name`` with ``args`` on
    ``device`` (a CUDA device), and raise if the launch failed.  The
    function is looked up once; the device is made current only where it is
    not already."""
    f = _functions.get((name, fn))
    if f is None:
        f = _functions[(name, fn)] = getattr(load(name), fn)
    if device.index is None or device.index == torch.cuda.current_device():
        err = f(*args)
    else:
        with torch.cuda.device(device):
            err = f(*args)
    if err != 0:
        check(_loaded[name], err, name)


def check_operands(op: str, device, tiles=None, **index) -> None:
    """Raise unless the tiles and every index array lie on ``device`` and
    are contiguous (a kernel reads them through raw pointers), and the index
    arrays are int32."""
    for name, t in dict(index, a_tiles=tiles).items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, features on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
        if name in index and t.dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.tcgnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


# Every kernel wrapper, each with two counters: ``launches`` (kernel
# launches, one a call; a call under a CUDA graph capture records its launch
# into the graph, and the graph's replays launch it again with no Python, so
# no wrapper counts them) and ``plain_calls`` (runs of the plain version on a
# CPU tensor).
COUNTED = []


def counted(wrapper):
    """Give a kernel wrapper its two counters, at 0."""
    wrapper.launches = 0
    wrapper.plain_calls = 0
    COUNTED.append(wrapper)
    return wrapper


def reset_counts() -> None:
    """Set every kernel wrapper's ``launches`` and ``plain_calls`` to 0."""
    for wrapper in COUNTED:
        wrapper.launches = 0
        wrapper.plain_calls = 0
