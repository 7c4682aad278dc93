"""Builds the package's CUDA sources into a shared library and loads it.

Route: ``nvcc`` into a shared object with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library is
built at first use from the sources under ``simpleworks_tpu_torch/csrc/``
into ``simpleworks_tpu_torch/csrc/build/`` (git-ignored), named by a hash of
the source and flags so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_BINARY_ARGS = [ctypes.c_int, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, ctypes.c_uint32, _P, _P]
_SIGNATURES = {
    "swt_mont_mul": _BINARY_ARGS,
    "swt_mod_add": _BINARY_ARGS,
    "swt_mod_sub": _BINARY_ARGS,
    "swt_mont_pow": [ctypes.c_int, _P, _I64, _I64, _P, _I64, _P, ctypes.c_uint32, _P,
                     _P, ctypes.c_int, ctypes.c_int, _P],
}

_lib: ctypes.CDLL | None = None
#: seconds nvcc took in this process (0.0 while only a cached build was loaded)
build_seconds = 0.0


def _nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default install location."""
    found = shutil.which("nvcc") or shutil.which("nvcc", path="/usr/local/cuda/bin")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source: Path = CSRC / "field_kernels.cu") -> Path:
    """Compiles ``source`` unless a build of this exact source exists."""
    global build_seconds
    out = _library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    build_seconds += time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
