"""ctypes bindings for the host native runtime (``csrc/host_native.cpp``).

Port of ``simpleworks_tpu/native/__init__.py`` over the port's own copy of
the JAX package's C++ source (byte for byte).  The library is built at first
use with the C++ compiler and the host flags (``ops/_build.py``
:func:`~simpleworks_tpu_torch.ops._build.host_library`: ``-O3 -march=native
-pthread``) into the git-ignored ``csrc/build/``; a compiler that fails on
the source raises.  :func:`available` is false only under
``SWTPU_NATIVE=0`` or when no C++ compiler is on ``PATH`` (``$CXX``, else
``g++``, else ``c++``); the host routes then take their pure paths.  The
runtime reads ``SWTPU_THREADS`` once a process (default: the hardware's
threads, at most 8).

The reference's API keeps its names and ABI: field elements are ``[N, n]``
little-endian u64 words in Montgomery form (R = 2^(64·n): Fr 4 words, Fq 6),
points ``[N, 18]`` u64 Jacobian Montgomery rows.  The bridges to the port's
layouts are numpy views and one copy, with no Python ints:

* :func:`limbs_to_words` / :func:`words_to_limbs`: a ``[16, N]`` int32
  Montgomery limb tensor (:mod:`..fields.dvec`) and ``[N, 4]`` words hold
  the same Montgomery value (both R = 2^256);
* :func:`planes_to_native` / :func:`native_to_planes_u16`: the ``[2, 24, N]``
  affine X/Y planes of an SRS and the normalised ``[N, 18]`` rows (Z = R mod
  q, the identity all zero).

Only CPU tensors take the routes built on this module; a CUDA tensor never
does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from functools import lru_cache

import numpy as np
import torch

from ..fields.bls12_377 import FQ_MODULUS, FR_MODULUS, Fq, Fr, FrEd

STEM = "host_native"


class _FpCtx(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("p", ctypes.c_uint64 * 6),
        ("r2", ctypes.c_uint64 * 6),
        ("inv", ctypes.c_uint64),
        ("one", ctypes.c_uint64 * 6),
    ]


_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_CTXP = ctypes.POINTER(_FpCtx)
_SIZE = ctypes.c_size_t
SIGNATURES = {
    "swtpu_fp_mul_batch": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_add_batch": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_sub_batch": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_to_mont": [_CTXP, _U64P, _U64P, _SIZE],
    "swtpu_fp_from_mont": [_CTXP, _U64P, _U64P, _SIZE],
    "swtpu_fp_powers": [_CTXP, _U64P, _U64P, _SIZE],
    "swtpu_ntt": [_CTXP, _U64P, _SIZE, _U64P],
    "swtpu_scale": [_CTXP, _U64P, _SIZE, _U64P],
    "swtpu_g1_msm": [_CTXP, _U64P, _U64P, _SIZE, ctypes.c_int, _U64P],
    "swtpu_g1_msm_affine": [_CTXP, _U64P, _U64P, _SIZE, ctypes.c_int, _U64P],
    "swtpu_g1_normalize": [_CTXP, _U64P, _SIZE],
    "swtpu_g1_fixed_base": [_CTXP, _U64P, _U64P, _SIZE, _U64P],
    "swtpu_g1_add_batch": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_axpy": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_horner": [_CTXP, _U64P, _SIZE, _U64P, _U64P],
    "swtpu_fp_inv_batch": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_spmv": [_CTXP, _SIZE, _U32P, _U32P, _U64P, _U64P, _U64P],
    "swtpu_fp_scalar_sub_vec": [_CTXP, _U64P, _U64P, _U64P, _SIZE],
    "swtpu_fp_div_linear": [_CTXP, _U64P, _SIZE, _U64P, _U64P, _U64P],
    "swtpu_fp_mul_add_batch": [_CTXP, _U64P, _U64P, _U64P, _U64P, _SIZE],
}

_MASK64 = (1 << 64) - 1
_FR_R = Fr.PARAMS.montgomery_r
_FQ_R = Fq.PARAMS.montgomery_r


@lru_cache(maxsize=1)
def compiler() -> str | None:
    """The C++ compiler on ``PATH`` (``$CXX``, ``g++``, ``c++``), or None."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name:
            found = shutil.which(name)
            if found:
                return found
    return None


def available() -> bool:
    """Whether the host routes take the native runtime: not under
    ``SWTPU_NATIVE=0``, and a C++ compiler is on ``PATH`` (the library is
    built at the first call that needs it)."""
    if os.environ.get("SWTPU_NATIVE") == "0":
        return False
    return compiler() is not None


def threads() -> int:
    """The runtime's worker threads: ``SWTPU_THREADS``, else the hardware's
    threads, at most 8 (``csrc/host_native.cpp`` ``worker_count``)."""
    env = os.environ.get("SWTPU_THREADS", "")
    if env.isdigit() and int(env) >= 1:
        return int(env)
    return max(1, min(8, os.cpu_count() or 1))


def _lib() -> ctypes.CDLL:
    from ..errors import SimpleworksError
    from ..ops import _build

    cxx = compiler()
    if cxx is None:
        raise SimpleworksError("native runtime unavailable: no C++ compiler on PATH "
                               "(gate on native.available())")
    return _build.host_library(STEM, cxx, SIGNATURES)


def _make_ctx(params) -> _FpCtx:
    ctx = _FpCtx()
    ctx.n = params.repr_bits // 64
    p = params.modulus
    r2 = params.montgomery_r ** 2 % p
    one = params.montgomery_r % p
    for i in range(6):
        ctx.p[i] = (p >> (64 * i)) & _MASK64
        ctx.r2[i] = (r2 >> (64 * i)) & _MASK64
        ctx.one[i] = (one >> (64 * i)) & _MASK64
    ctx.inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    return ctx


@lru_cache(maxsize=4)
def _ctx_for(name: str) -> _FpCtx:
    return _make_ctx({"fr": Fr, "fq": Fq, "fr_ed": FrEd}[name].PARAMS)


def _ctx(name: str):
    return ctypes.byref(_ctx_for(name))


def ints_to_limbs64(values, n_limbs: int) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(8 * n_limbs, "little") for v in values)
    return np.frombuffer(buf, dtype="<u8").reshape(len(values), n_limbs).copy()


def limbs64_to_ints(arr: np.ndarray) -> list[int]:
    data = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    stride = arr.shape[1] * 8
    return [int.from_bytes(data[i * stride : (i + 1) * stride], "little")
            for i in range(arr.shape[0])]


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(_U64P)


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(_U32P)


def _c(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype="<u8")


# ------------------------------------------------------ layout bridges ----


def limbs_to_words(t: torch.Tensor) -> np.ndarray:
    """[16, N] int32 Montgomery limb tensor (CPU) -> [N, 4] u64 Montgomery
    words: one copy of the transposed 16-bit limbs, viewed as u64."""
    u16 = np.ascontiguousarray(t.numpy().T, dtype="<u2")  # [N, 16]
    return u16.view("<u8")


def words_to_limbs(words: np.ndarray) -> torch.Tensor:
    """[N, 4] u64 Montgomery words -> [16, N] int32 CPU limb tensor."""
    u16 = _c(words).view("<u2")  # [N, 16]
    return torch.from_numpy(np.ascontiguousarray(u16.T, dtype=np.int32))


def planes_to_native(planes) -> np.ndarray:
    """[2, 24, N] affine X/Y planes (a tensor on any device, or numpy) ->
    [N, 18] u64 rows normalised as the runtime's batch-affine MSM reads them:
    Z = R mod q, the identity (x = y = 0) all zero.  One read-back for a
    device tensor, one copy."""
    arr = planes.cpu().numpy() if isinstance(planes, torch.Tensor) else np.asarray(planes)
    n = arr.shape[2]
    xy = np.ascontiguousarray(arr.transpose(2, 0, 1), dtype="<u2")  # [N, 2, 24]
    out = np.empty((n, 18), dtype="<u8")
    out[:, :12] = xy.view("<u8").reshape(n, 12)
    one = np.array([(_FQ_R >> (64 * t)) & _MASK64 for t in range(6)], dtype="<u8")
    live = out[:, :12].any(axis=1)
    out[:, 12:] = np.where(live[:, None], one[None, :], np.uint64(0))
    return out


def native_to_planes_u16(points_native: np.ndarray) -> np.ndarray:
    """[N, 18] normalised rows -> [2, 24, N] uint16 X/Y limb planes (numpy;
    ``g1_limb.native_points_to_limb_major`` puts them on a device)."""
    rows = _c(points_native).reshape(-1, 18)
    u16 = rows.view("<u2").reshape(-1, 3, 24)
    return np.ascontiguousarray(u16[:, :2].transpose(1, 2, 0))


def std_words(t: torch.Tensor) -> np.ndarray:
    """[16, N] Montgomery limb tensor (CPU) -> [N, 4] standard-form words
    (the MSM's scalars)."""
    return fr_from_mont_arr(limbs_to_words(t))


# ---------------------------------------------- the reference's API ----


def fp_mul_batch(field: str, a: list[int], b: list[int]) -> list[int]:
    """Standard-form in/out batched modular multiplication."""
    lib = _lib()
    n = _ctx_for(field).n
    aa, bb = ints_to_limbs64(a, n), ints_to_limbs64(b, n)
    am, bm = np.empty_like(aa), np.empty_like(bb)
    lib.swtpu_fp_to_mont(_ctx(field), _u64p(aa), _u64p(am), len(a))
    lib.swtpu_fp_to_mont(_ctx(field), _u64p(bb), _u64p(bm), len(b))
    out = np.empty_like(aa)
    lib.swtpu_fp_mul_batch(_ctx(field), _u64p(am), _u64p(bm), _u64p(out), len(a))
    res = np.empty_like(aa)
    lib.swtpu_fp_from_mont(_ctx(field), _u64p(out), _u64p(res), len(a))
    return limbs64_to_ints(res)


def _stage_twiddles(n: int, omega: int) -> np.ndarray:
    """The NTT's per-stage twiddles (sizes 1, 2, ..., n/2), Montgomery."""
    stages = []
    length = 2
    while length <= n:
        w = pow(omega, n // length, FR_MODULUS)
        stages.append(fr_powers_arr(ints_to_limbs64([w * _FR_R % FR_MODULUS], 4), length // 2))
        length <<= 1
    return np.concatenate(stages) if stages else np.zeros((0, 4), dtype="<u8")


def ntt_fr(values: list[int], omega: int, scale: int | None = None) -> list[int]:
    """Natural-order NTT over Fr with root ``omega`` (standard form in/out);
    ``scale`` (e.g. n^−1 for the inverse) applied afterwards."""
    data = ints_to_limbs64([v * _FR_R % FR_MODULUS for v in values], 4)
    out = fr_ntt_arr(data, omega, scale)
    rinv = pow(_FR_R, -1, FR_MODULUS)
    return [v * rinv % FR_MODULUS for v in limbs64_to_ints(out)]


def _points_to_native(points) -> np.ndarray:
    """G1Points -> [N, 18] u64 Jacobian Montgomery."""
    rows = []
    for p in points:
        rows.extend([p.X * _FQ_R % FQ_MODULUS, p.Y * _FQ_R % FQ_MODULUS,
                     p.Z * _FQ_R % FQ_MODULUS])
    return ints_to_limbs64(rows, 6).reshape(len(points), 18)


def _points_from_native(arr: np.ndarray):
    from ..curves.bls12_377 import G1Point

    rinv = pow(_FQ_R, -1, FQ_MODULUS)
    flat = limbs64_to_ints(_c(arr).reshape(-1, 6))
    return [G1Point(flat[i] * rinv % FQ_MODULUS, flat[i + 1] * rinv % FQ_MODULUS,
                    flat[i + 2] * rinv % FQ_MODULUS) for i in range(0, len(flat), 3)]


def _msm_window_bits(n: int) -> int:
    """The reference's Pippenger window: c = 16 from 2^20 points, else
    bit_length − 2 clamped to [2, 13]."""
    if n >= (1 << 20):
        return 16
    return max(2, min(13, n.bit_length() - 2))


def _msm_call(symbol: str, pts: np.ndarray, scs: np.ndarray, window_bits):
    lib = _lib()
    pts, scs = _c(pts), _c(scs)
    if pts.ndim != 2 or pts.shape[1] != 18 or scs.shape != (pts.shape[0], 4):
        raise ValueError(f"expected [N, 18] points and [N, 4] scalars, got {pts.shape}, "
                         f"{scs.shape}")
    if window_bits is None:
        window_bits = _msm_window_bits(pts.shape[0])
    out = np.zeros((1, 18), dtype="<u8")
    getattr(lib, symbol)(_ctx("fq"), _u64p(pts), _u64p(scs), pts.shape[0], window_bits,
                         _u64p(out))
    return _points_from_native(out)[0]


def g1_msm(points, scalars: list[int], window_bits: int | None = None):
    """Pippenger MSM (native) of G1Points and int scalars."""
    return _msm_call("swtpu_g1_msm", _points_to_native(points),
                     ints_to_limbs64([int(s) for s in scalars], 4), window_bits)


def g1_fixed_base_raw(base, scalars: list[int]) -> np.ndarray:
    """out[i] = scalars[i]·base as a raw [N, 18] Jacobian Montgomery array
    (the SRS storage format)."""
    return g1_fixed_base_arr(base, ints_to_limbs64([int(s) for s in scalars], 4))


def g1_fixed_base_arr(base, scalars_std: np.ndarray) -> np.ndarray:
    """:func:`g1_fixed_base_raw` over [N, 4] standard-form scalar words."""
    lib = _lib()
    b = _points_to_native([base])
    scs = _c(scalars_std)
    _same_rows(scs)
    out = np.zeros((scs.shape[0], 18), dtype="<u8")
    lib.swtpu_g1_fixed_base(_ctx("fq"), _u64p(b), _u64p(scs), scs.shape[0], _u64p(out))
    return out


def g1_fixed_base(base, scalars: list[int]):
    """out[i] = scalars[i]·base via the native windowed table."""
    return _points_from_native(g1_fixed_base_raw(base, scalars))


def g1_msm_raw(points_native: np.ndarray, scalars: list[int], window_bits: int | None = None):
    """Pippenger MSM over a preconverted [N, 18] point array."""
    return _msm_call("swtpu_g1_msm", points_native,
                     ints_to_limbs64([int(s) for s in scalars], 4), window_bits)


def g1_normalize_arr(points_native: np.ndarray) -> np.ndarray:
    """Batch-normalise a [N, 18] Jacobian array to Z = 1 in place (identity
    rows become all zero); returns the (contiguous) array."""
    lib = _lib()
    pts = _c(points_native)
    lib.swtpu_g1_normalize(_ctx("fq"), _u64p(pts), pts.shape[0])
    return pts


def g1_ensure_normalized(points_native: np.ndarray) -> np.ndarray:
    """Normalise a [N, 18] array to Z = 1 unless it already is."""
    one = ints_to_limbs64([_FQ_R % FQ_MODULUS], 6)[0]
    z = points_native[:, 12:18]
    if np.array_equal(z, np.broadcast_to(one, z.shape)):
        return points_native
    return g1_normalize_arr(points_native)


def g1_msm_affine_arr(points_native: np.ndarray, scalars_std: np.ndarray,
                      window_bits: int | None = None):
    """Batch-affine Pippenger MSM over a normalised [N, 18] array and [N, 4]
    standard-form scalars; the same group element as :func:`g1_msm_arr`."""
    return _msm_call("swtpu_g1_msm_affine", points_native, scalars_std, window_bits)


def g1_msm_arr(points_native: np.ndarray, scalars_std: np.ndarray,
               window_bits: int | None = None):
    """Jacobian Pippenger MSM over [N, 18] points and [N, 4] standard-form
    scalars."""
    return _msm_call("swtpu_g1_msm", points_native, scalars_std, window_bits)


def fr_combine(polys_with_weights) -> list[int]:
    """Σ w_i · p_i over Fr (standard-form coefficient lists in and out)."""
    n = max((len(p) for p, _ in polys_with_weights), default=0)
    if n == 0:
        return []
    acc = np.zeros((n, 4), dtype="<u8")
    for coeffs, weight in polys_with_weights:
        if coeffs:
            fr_axpy_arr(acc, ints_to_limbs64([c * _FR_R % FR_MODULUS for c in coeffs], 4),
                        ints_to_limbs64([weight * _FR_R % FR_MODULUS], 4))
    rinv = pow(_FR_R, -1, FR_MODULUS)
    return [v * rinv % FR_MODULUS for v in limbs64_to_ints(acc)]


def fr_horner(coeffs: list[int], z: int) -> int:
    """Polynomial evaluation at z over Fr (standard form)."""
    if not coeffs:
        return 0
    out = fr_horner_arr(ints_to_limbs64([c * _FR_R % FR_MODULUS for c in coeffs], 4),
                        ints_to_limbs64([z * _FR_R % FR_MODULUS], 4))
    return limbs64_to_ints(out)[0] * pow(_FR_R, -1, FR_MODULUS) % FR_MODULUS


# -------------------------------------- array-level Fr kernels ([N, 4]) ----


def _scalar(x: np.ndarray) -> np.ndarray:
    """One Montgomery Fr element as 4 contiguous u64 words (a [1, 4] or [4]
    array)."""
    x = _c(x)
    if x.size != 4:
        raise ValueError(f"expected one [1, 4] scalar, got {x.shape}")
    return x


def _same_rows(*arrays) -> None:
    if any(a.ndim != 2 or a.shape != arrays[0].shape or a.shape[1] != 4 for a in arrays):
        raise ValueError(f"expected [N, 4] arrays of one shape, got {[a.shape for a in arrays]}")


def fr_binop_arr(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise Montgomery op over [N, 4] arrays: 'mul' | 'add' | 'sub'."""
    lib = _lib()
    a, b = _c(a), _c(b)
    _same_rows(a, b)
    out = np.empty_like(a)
    fn = {"mul": lib.swtpu_fp_mul_batch, "add": lib.swtpu_fp_add_batch,
          "sub": lib.swtpu_fp_sub_batch}[op]
    fn(_ctx("fr"), _u64p(a), _u64p(b), _u64p(out), a.shape[0])
    return out


def fr_mul_add_arr(a: np.ndarray, b: np.ndarray, d: np.ndarray) -> np.ndarray:
    """a·b + d elementwise (Montgomery)."""
    lib = _lib()
    a, b, d = _c(a), _c(b), _c(d)
    _same_rows(a, b, d)
    out = np.empty_like(a)
    lib.swtpu_fp_mul_add_batch(_ctx("fr"), _u64p(a), _u64p(b), _u64p(d), _u64p(out),
                               a.shape[0])
    return out


def fr_to_mont_arr(a_std: np.ndarray) -> np.ndarray:
    lib = _lib()
    a_std = _c(a_std)
    _same_rows(a_std)
    out = np.empty_like(a_std)
    lib.swtpu_fp_to_mont(_ctx("fr"), _u64p(a_std), _u64p(out), a_std.shape[0])
    return out


def fr_from_mont_arr(a_mont: np.ndarray) -> np.ndarray:
    lib = _lib()
    a_mont = _c(a_mont)
    _same_rows(a_mont)
    out = np.empty_like(a_mont)
    lib.swtpu_fp_from_mont(_ctx("fr"), _u64p(a_mont), _u64p(out), a_mont.shape[0])
    return out


def fr_scale_arr(a: np.ndarray, factor_mont: np.ndarray) -> np.ndarray:
    """a · factor (a [1, 4] Montgomery scalar); a new array."""
    lib = _lib()
    out = _c(a).copy()
    _same_rows(out)
    lib.swtpu_scale(_ctx("fr"), _u64p(out), out.shape[0], _u64p(_scalar(factor_mont)))
    return out


def fr_powers_arr(base_mont: np.ndarray, count: int) -> np.ndarray:
    """[count, 4]: base^0 .. base^(count−1) (Montgomery in and out)."""
    lib = _lib()
    out = np.empty((count, 4), dtype="<u8")
    lib.swtpu_fp_powers(_ctx("fr"), _u64p(_scalar(base_mont)), _u64p(out), count)
    return out


_P_MINUS_2 = ints_to_limbs64([FR_MODULUS - 2], 4)


def fr_inv_arr(a: np.ndarray) -> np.ndarray:
    """Batch inversion (Montgomery in and out); zeros map to zero."""
    lib = _lib()
    a = _c(a)
    _same_rows(a)
    out = np.empty_like(a)
    lib.swtpu_fp_inv_batch(_ctx("fr"), _u64p(a), _u64p(_P_MINUS_2), _u64p(out), a.shape[0])
    return out


def fr_scalar_sub_arr(scalar_mont: np.ndarray, a: np.ndarray) -> np.ndarray:
    """out[i] = scalar − a[i] (Montgomery)."""
    lib = _lib()
    a = _c(a)
    _same_rows(a)
    out = np.empty_like(a)
    lib.swtpu_fp_scalar_sub_vec(_ctx("fr"), _u64p(_scalar(scalar_mont)), _u64p(a), _u64p(out),
                                a.shape[0])
    return out


def fr_spmv_arr(rows: np.ndarray, cols: np.ndarray, coeffs_mont: np.ndarray,
                x_mont: np.ndarray, out_len: int) -> np.ndarray:
    """out[rows[i]] += coeffs[i]·x[cols[i]] over [out_len, 4] (Montgomery)."""
    lib = _lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    coeffs_mont, x_mont = _c(coeffs_mont), _c(x_mont)
    if not rows.shape == cols.shape == (coeffs_mont.shape[0],):
        raise ValueError("rows, cols and coeffs must have one length")
    if rows.size and (int(rows.max()) >= out_len or int(cols.max()) >= x_mont.shape[0]):
        raise ValueError("a sparse term indexes past its output or input")
    out = np.zeros((out_len, 4), dtype="<u8")
    lib.swtpu_fp_spmv(_ctx("fr"), rows.shape[0], _u32p(rows), _u32p(cols),
                      _u64p(coeffs_mont), _u64p(x_mont), _u64p(out))
    return out


def fr_div_linear_arr(coeffs_mont: np.ndarray, z_mont: np.ndarray):
    """Synthetic division by (X − z): (quotient [N−1, 4], remainder [1, 4])."""
    lib = _lib()
    coeffs_mont = _c(coeffs_mont)
    _same_rows(coeffs_mont)
    n = coeffs_mont.shape[0]
    if n == 0:
        raise ValueError("division of the empty polynomial")
    quot = np.zeros((max(n - 1, 1), 4), dtype="<u8")
    rem = np.zeros((1, 4), dtype="<u8")
    lib.swtpu_fp_div_linear(_ctx("fr"), _u64p(coeffs_mont), n, _u64p(_scalar(z_mont)),
                            _u64p(quot), _u64p(rem))
    return quot[: n - 1], rem


def fr_horner_arr(coeffs_mont: np.ndarray, z_mont: np.ndarray) -> np.ndarray:
    """Evaluation at z (Montgomery in and out) -> [1, 4]."""
    lib = _lib()
    coeffs_mont = _c(coeffs_mont)
    _same_rows(coeffs_mont)
    out = np.zeros((1, 4), dtype="<u8")
    lib.swtpu_fp_horner(_ctx("fr"), _u64p(coeffs_mont), coeffs_mont.shape[0],
                        _u64p(_scalar(z_mont)), _u64p(out))
    return out


def fr_axpy_arr(acc_mont: np.ndarray, poly_mont: np.ndarray, w_mont: np.ndarray) -> None:
    """acc[:len(poly)] += w · poly, in place (Montgomery)."""
    lib = _lib()
    if not acc_mont.flags["C_CONTIGUOUS"] or acc_mont.dtype != np.dtype("<u8"):
        raise ValueError("the accumulator must be a C-contiguous u64 array")
    poly_mont = _c(poly_mont)
    if poly_mont.shape[0] > acc_mont.shape[0] or acc_mont.shape[1:] != (4,):
        raise ValueError(f"{poly_mont.shape[0]} coefficients exceed the accumulator")
    lib.swtpu_fp_axpy(_ctx("fr"), _u64p(acc_mont), _u64p(poly_mont), _u64p(_scalar(w_mont)),
                      poly_mont.shape[0])


_NTT_TWIDDLES: dict = {}
_NTT_TWIDDLES_MAX = 32
_NTT_TWIDDLES_LOCK = threading.Lock()


def fr_ntt_arr(data_mont: np.ndarray, omega: int, scale: int | None = None) -> np.ndarray:
    """Natural-order radix-2 NTT over a [n, 4] Montgomery array (a new
    array), ``scale`` (an int) applied afterwards; twiddles cached per
    (n, ω)."""
    lib = _lib()
    data = _c(data_mont).copy()
    _same_rows(data)
    n = data.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"an NTT of {n} points: the length must be a power of two")
    with _NTT_TWIDDLES_LOCK:
        tws = _NTT_TWIDDLES.get((n, omega))
    if tws is None:
        tws = _stage_twiddles(n, omega)
        with _NTT_TWIDDLES_LOCK:
            if len(_NTT_TWIDDLES) >= _NTT_TWIDDLES_MAX:
                _NTT_TWIDDLES.pop(next(iter(_NTT_TWIDDLES)))
            _NTT_TWIDDLES[(n, omega)] = tws
    lib.swtpu_ntt(_ctx("fr"), _u64p(data), n, _u64p(tws))
    if scale is not None:
        s = ints_to_limbs64([scale * _FR_R % FR_MODULUS], 4)
        lib.swtpu_scale(_ctx("fr"), _u64p(data), n, _u64p(s))
    return data
