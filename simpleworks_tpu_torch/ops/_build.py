"""Builds the package's CUDA sources and its host C++ runtime into shared
libraries and loads them.

Route: ``nvcc`` into a shared object with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Each source under
``simpleworks_tpu_torch/csrc/`` is built at first use into
``simpleworks_tpu_torch/csrc/build/`` (git-ignored), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale build.
:func:`build_all` starts one ``nvcc`` per source, all at once.

The host runtime (``csrc/host_native.cpp``, :mod:`..native`) is built the
same way with the C++ compiler (:func:`host_library`); ``-march=native``
bakes the host's CPU into it, so its name also hashes the CPU's model and
feature flags, and a file lock lets one process of several build it while
the others wait.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
(:func:`count_launch`) where it launches its kernel, and nowhere else.

Thread-safe: the proof pipeline indexes and proves on two threads at once,
so the first use of a library builds and loads it under one lock (a second
thread waits for that build instead of starting its own ``nvcc`` into the
same file), and a launch count is one increment under a lock.
"""

from __future__ import annotations

import ctypes
import fcntl
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

#: the host runtime's flags (the JAX package's Makefile's)
HOST_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native", "-pthread"]

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
        "swt_ntt_bitrev": [_P, _P, _I64, ctypes.c_int, _P],
        "swt_ntt_butterfly": [_P, _I64, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_uint32, _P,
                              _P, _P],
        "swt_ntt_transform": [_P, _P, _P, _I64, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
                              _P, _P, ctypes.c_int, _P, ctypes.c_uint32, _P, _P, _P],
        "swt_ntt_kernel_resources": [_P],
    },
    "g1_kernels": {
        "swt_g1_fused_add": [_P, _P, _I64, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_madd_accumulate": [_P, _P, _P, _P, _I64, _I64, _P, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_bucket_combine": [_P, _P, _P, _I64, _I64, _I64, _P, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_fixed_base": [_P, _I64, _I64, _P, _I64, _P, _P, ctypes.c_uint32, _P, _P],
        "swt_g1_kernel_resources": [_P],
    },
    "mask_kernels": {
        "swt_mask_draw": [_P, ctypes.c_int, _I64, _I64, _P, _I64, _I64, _I64, _I64, _P,
                          ctypes.c_uint32, _P, ctypes.c_uint32, _P, _I64, _P],
    },
}

#: kernel launches by kernel name since the last :func:`reset_launches`
LAUNCHES = {"mont_mul": 0, "mod_add": 0, "mod_sub": 0, "mont_pow": 0, "ntt_reduce": 0,
            "ntt_bitrev": 0, "ntt_butterfly": 0, "ntt_pass": 0, "g1_fused_add": 0,
            "g1_fused_madd": 0, "g1_bucket_combine": 0, "g1_fixed_base": 0, "mask_draw": 0}

_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
_launch_lock = threading.Lock()
#: seconds of wall clock the builds took in this process (0.0 while only
#: cached builds were loaded)
build_seconds = 0.0
#: of which the host runtime's C++ build
host_build_seconds = 0.0


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


_CPU_KEYS = ("model name", "vendor_id", "cpu family", "model", "flags", "Features", "CPU part")


def _cpuinfo() -> dict:
    """The first value of each of ``_CPU_KEYS`` in ``/proc/cpuinfo``."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return {}
    found = {}
    for line in lines:
        key, _, value = line.partition(":")
        key = key.strip()
        if key in _CPU_KEYS and key not in found:
            found[key] = value.strip()
    return found


def cpu_id() -> str:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), from ``/proc/cpuinfo``."""
    info = _cpuinfo()
    return " | ".join([os.uname().machine] + [info.get(k, "") for k in _CPU_KEYS])


def cpu_model() -> str:
    """The host CPU's model name (printed beside host timings); its vendor,
    family and model numbers where the name reads ``unknown``."""
    info = _cpuinfo()
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    vendor, family, model = (info.get(k, "") for k in ("vendor_id", "cpu family", "model"))
    if vendor or family or model:
        return f"{vendor} family {family} model {model}"
    return os.uname().machine


def _host_library_path(source: Path) -> Path:
    text = source.read_bytes() + " ".join(HOST_CXX_FLAGS).encode() + cpu_id().encode()
    return BUILD_DIR / f"lib{source.stem}_{hashlib.sha256(text).hexdigest()[:16]}.so"


def build_host(source: Path, compiler: str) -> Path:
    """Compiles the C++ ``source`` with ``compiler`` and the host flags unless
    a build of its exact text, for this CPU, exists.  Processes that start
    together wait on one file lock while the first builds; a failed build
    raises with the compiler's output."""
    global build_seconds, host_build_seconds
    out = _host_library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        t0 = time.perf_counter()
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([compiler, *HOST_CXX_FLAGS, "-o", str(tmp), str(source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        build_seconds += seconds
        host_build_seconds += seconds
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed on {source.name}:\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def host_library(stem: str, compiler: str, signatures: dict) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<stem>.cpp`` (built on first call,
    once however many threads ask for it), its functions given
    ``signatures`` ({C symbol: argtypes}; they return nothing)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _libs_lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(CSRC / f"{stem}.cpp", compiler)))
            for name, args in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = None
            _libs[stem] = lib
    return lib
