"""Builds the package's CUDA sources into shared libraries and loads them.

Route: ``nvcc`` into a shared object with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Each source under
``simpleworks_tpu_torch/csrc/`` is built at first use into
``simpleworks_tpu_torch/csrc/build/`` (git-ignored), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale build.
:func:`build_all` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
(:func:`count_launch`) where it launches its kernel, and nowhere else.

Thread-safe: the proof pipeline indexes and proves on two threads at once,
so the first use of a library builds and loads it under one lock (a second
thread waits for that build instead of starting its own ``nvcc`` into the
same file), and a launch count is one increment under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
#: source stem -> {C symbol: argtypes}
SIGNATURES = {
    "field_kernels": {
        "swt_mont_mul": _BINARY_ARGS,
        "swt_mod_add": _BINARY_ARGS,
        "swt_mod_sub": _BINARY_ARGS,
        "swt_mont_pow": [ctypes.c_int, _P, _I64, _I64, _P, _I64, _P, ctypes.c_uint32, _P,
                         _P, ctypes.c_int, ctypes.c_int, _P],
        "swt_field_kernel_resources": [_P],
    },
    "ntt_kernels": {
        "swt_ntt_reduce": [_P, _I64, _P, _I64, _P, ctypes.c_uint32, _P],
    },
    "g1_kernels": {
        "swt_g1_fused_add": [_P, _P, _I64, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_madd_accumulate": [_P, _P, _P, _P, _I64, _I64, _P, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_bucket_combine": [_P, _P, _P, _I64, _I64, _I64, _P, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_kernel_resources": [_P],
    },
}

#: kernel launches by kernel name since the last :func:`reset_launches`
LAUNCHES = {"mont_mul": 0, "mod_add": 0, "mod_sub": 0, "mont_pow": 0, "ntt_reduce": 0,
            "g1_fused_add": 0, "g1_fused_madd": 0, "g1_bucket_combine": 0}

_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
_launch_lock = threading.Lock()
#: seconds of wall clock the builds took in this process (0.0 while only
#: cached builds were loaded)
build_seconds = 0.0


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Adds one to ``LAUNCHES[name]`` (atomic across threads)."""
    with _launch_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default install location."""
    found = shutil.which("nvcc") or shutil.which("nvcc", path="/usr/local/cuda/bin")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _library_path(source: Path) -> Path:
    text = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_all(stems=tuple(SIGNATURES)) -> list[Path]:
    """Compiles every source of ``stems`` that has no build of its exact
    text yet, one ``nvcc`` process per source, all started together."""
    global build_seconds
    outs = [_library_path(CSRC / f"{stem}.cu") for stem in stems]
    todo = [(stem, out) for stem, out in zip(stems, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for stem, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {stem}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(stem: str = "field_kernels") -> Path:
    """Compiles one source unless a build of its exact text exists."""
    return build_all((stem,))[0]


def library(stem: str = "field_kernels") -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<stem>.cu`` (built on first call,
    once however many threads ask for it)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _libs_lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            for name, args in SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _libs[stem] = lib
    return lib
