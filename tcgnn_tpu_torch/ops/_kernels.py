"""Build and load the port's CUDA kernels (``tcgnn_tpu_torch/csrc``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The build runs at
first use, never at import, into ``tcgnn_tpu_torch/_build/`` (listed in
``.gitignore``); the library's name carries a hash of its source, so an
edited source is rebuilt and a current one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
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


def load_spmm_dense(verbose: bool = False) -> ctypes.CDLL:
    """The K1 library, with every C function's argument types declared
    (an undeclared pointer argument would be cut to 32 bits)."""
    if "spmm_dense" in _loaded and not verbose:
        return _loaded["spmm_dense"]
    lib = ctypes.CDLL(str(build("spmm_dense", verbose=verbose)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcgnn_spmm_dense.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.tcgnn_spmm_dense.restype = i
    lib.tcgnn_cuda_error_string.argtypes = [i]
    lib.tcgnn_cuda_error_string.restype = ctypes.c_char_p
    _loaded["spmm_dense"] = lib
    return lib
