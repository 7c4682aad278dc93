"""The NTT over BLS12-377 Fr: a recursive 4-step DFT-as-matmul over 8-bit
limbs, with its reduce kernel in CUDA.

Port of ``simpleworks_tpu/ops/ntt_mxu.py`` (``MXUNTT``, ``get_mxu_ntt``).
A transform of size N = N1·N2 (N1 ≤ 256) is

    A' = reduce( Ŵ1 @ X ) ⊙ T ;   A = NTT_N2( A' ) , transposed

with X the input viewed as [N1, N2], Ŵ1[k, j] = ω_N1^{kj}·2^272 mod p,
T[k1, j2] = ω^{k1·j2} (Montgomery) and the row transforms recursing down to a
base DFT of size ≤ 256 (its matrix carries the 1/N of the inverse).

* **Limb matmul** (``_limb_matmul``): field elements (Montgomery residues
  < p) are cut into 32 byte planes held in float32; 32 matrix products
  (``torch.matmul``) give the 63 partial-limb planes.  Every sum of one
  product is an integer below 255²·256 < 2^24, exact in float32 as long as
  the card really accumulates in float32: the call pins TF32 off for its
  duration.  The cross-plane sums (up to 2^29) are taken in int32.
* **Reduce** (``ntt_reduce``): recombines the 63 planes into 16-bit limbs
  and Montgomery-reduces by 2^272 (Ŵ carries 2^272, so the result is the
  Montgomery form of the DFT).  A CUDA tensor launches the kernel of
  ``csrc/ntt_kernels.cu`` or raises; a CPU tensor takes the plain int64
  version beside it.
* **Twiddles**: one Montgomery multiply (``mont_mul``) a level.

Natural order in and out; no bit reversal.  Outputs equal the reference's
value for value.

No path of the port runs it: the JAX package runs this NTT only on a TPU,
and the port's transforms (``dvec.fft``/``ifft``, the sharded plane) take
the route it takes elsewhere, the butterfly of :mod:`..poly.ntt_device`.
It stays as the port of ``ntt_mxu.py``, held by its tests and
``chip_smoke.check_ntt``.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
from functools import lru_cache

import torch

from ..device import resolve
from ..fields.bls12_377 import FR_MODULUS, fr_root_of_unity
from ..fields.device import FR, LIMB_BITS, LIMB_MASK, split_words, to_mont
from ._build import LAUNCHES, count_launch
from .mont_mul import _on_cuda, _raise_on, _reduce, mont_mul

P = FR_MODULUS
L = 16            # 16-bit limbs per element
L8 = 32           # byte planes per element
PLANES = 2 * L8 - 1
REDC_K = 17       # reduce by 2^(16·17) = 2^272
ACC_LIMBS = REDC_K + L + 1  # 34 16-bit limbs cover the matmul sum
MAX_BASE = 256    # float32 exactness: contraction length ≤ 256

_P16 = (ctypes.c_uint32 * L)(*split_words(P, L, LIMB_BITS))
_N0_16 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


# ------------------------------------------------------------------ reduce --


def ntt_reduce_plain(c: torch.Tensor) -> torch.Tensor:
    """[63, B] int32 partial-limb planes (each < 2^29) -> [16, B] int32
    Montgomery limbs of Σ_l C_l·2^(8l)·2^(−272) mod p, in int64 limb
    arithmetic: the arithmetic of the Pallas ``_reduce_kernel``."""
    B = c.shape[1]
    c64 = c.to(torch.int64)
    t = torch.zeros((ACC_LIMBS + 1, B), dtype=torch.int64, device=c.device)
    odd = c64[1::2]  # C_{2k+1}, k = 0..30
    t[:L8] += c64[0::2]  # C_{2k} at limb k
    t[: L8 - 1] += (odd << 8) & LIMB_MASK  # its low byte at limb k, bit 8
    t[1:L8] += odd >> 8  # the rest at limb k + 1
    carry = torch.zeros_like(t[0])
    for k in range(ACC_LIMBS):
        v = t[k] + carry
        t[k] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    p = FR.col(FR.p_limbs, c.device, torch.int64)
    for i in range(REDC_K):
        m = ((t[i] & LIMB_MASK) * _N0_16) & LIMB_MASK
        prod = m * p  # [16, B]
        t[i : i + L] += prod & LIMB_MASK
        t[i + 1 : i + L + 1] += prod >> LIMB_BITS
        t[i + 1] += t[i] >> LIMB_BITS
    return _reduce(t[REDC_K : REDC_K + L + 1], FR)


def ntt_reduce(c: torch.Tensor) -> torch.Tensor:
    """The reduce step of every transform level: [63, B] int32 -> [16, B]."""
    if c.dtype != torch.int32 or c.dim() != 2 or c.shape[0] != PLANES:
        raise ValueError(f"expected [{PLANES}, B] int32 partial-limb planes, got "
                         f"{tuple(c.shape)} {c.dtype}")
    if not _on_cuda(c):
        return ntt_reduce_plain(c)
    from ._build import library

    if c.stride(1) != 1:
        c = c.contiguous()
    B = c.shape[1]
    out = torch.empty((L, B), dtype=torch.int32, device=c.device)
    if B == 0:
        return out
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = library("ntt_kernels").swt_ntt_reduce(
            c.data_ptr(), c.stride(0), out.data_ptr(), B, ctypes.addressof(_P16), _N0_16, stream)
    _raise_on(rc, "ntt_reduce")
    count_launch("ntt_reduce")
    return out


# ----------------------------------------------------------- limb matmul --


def _byte_planes(x: torch.Tensor) -> torch.Tensor:
    """[16, ...] int32 16-bit limbs -> [32, ...] float32 byte planes
    (plane 2t the low byte of limb t, plane 2t + 1 its high byte)."""
    lo = (x & 0xFF).to(torch.float32)
    hi = ((x >> 8) & 0xFF).to(torch.float32)
    return torch.stack([lo, hi], dim=1).reshape((L8,) + tuple(x.shape[1:]))


_fp32_lock = threading.Lock()
_fp32_inside = 0     # threads inside _exact_fp32
_fp32_saved = None   # the process's setting, restored when the last one leaves


@contextmanager
def _exact_fp32():
    """float32 matrix products in full float32 on the card (never TF32,
    whatever the process set), for the duration of the block only.

    The setting is process-wide, so the blocks of all threads share it: the
    first thread in sets it, the last one out restores the setting it found
    (a thread leaving early must not put TF32 back under another's limb
    matmuls)."""
    global _fp32_inside, _fp32_saved
    matmul = torch.backends.cuda.matmul
    with _fp32_lock:
        if _fp32_inside == 0:
            _fp32_saved = matmul.fp32_precision
            matmul.fp32_precision = "ieee"
        _fp32_inside += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_inside -= 1
            if _fp32_inside == 0:
                matmul.fp32_precision = _fp32_saved


def _limb_matmul(lhs8: torch.Tensor, rhs8: torch.Tensor) -> torch.Tensor:
    """out[l] = Σ_{p+q=l} lhs8[p] @ rhs8[q]: lhs8 [32, I, K], rhs8 [32, K, J]
    float32 byte planes -> [63, I, J] int32.  Each product's sums are below
    2^24 (exact in float32); the cross-plane sums (< 2^29) run in int32."""
    I, J = lhs8.shape[1], rhs8.shape[2]
    out = torch.zeros((PLANES, I, J), dtype=torch.int32, device=lhs8.device)
    with _exact_fp32():
        for p0 in range(L8):
            r = torch.matmul(lhs8[p0], rhs8)  # [32, I, J]
            out[p0 : p0 + L8] += r.to(torch.int32)
            del r
    return out


# ---------------------------------------------------------------- tables --


def _row_powers(bases: list[int], width: int, device) -> torch.Tensor:
    """[16, len(bases), width] Montgomery table of bases[r]^j, by
    log-doubling along the row (one multiply a doubling)."""
    rows = len(bases)
    out = FR.one(rows, device).reshape(L, rows, 1)
    done = 1
    while done < width:
        step = min(done, width - done)
        top = to_mont([pow(b, done, P) for b in bases], FR, device)  # [16, rows]
        ext = mont_mul(out[:, :, :step].reshape(L, -1),
                       top.reshape(L, rows, 1).expand(L, rows, step).reshape(L, -1), FR)
        out = torch.cat([out, ext.reshape(L, rows, step)], dim=2)
        done += step
    return out


def _dft_limb_table(size: int, omega: int, scale: int, device) -> torch.Tensor:
    """Ŵ[k, j] = ω^{kj}·scale·2^272 mod p (standard form) as [32, size, size]
    float32 byte planes."""
    w = _row_powers([pow(omega, k, P) for k in range(size)], size, device).reshape(L, -1)
    factor = scale * pow(2, 16 * REDC_K, P) % P
    w = mont_mul(w, to_mont([factor], FR, device).expand_as(w), FR)  # Montgomery of Ŵ
    one = torch.zeros((L, 1), dtype=torch.int32, device=device)
    one[0, 0] = 1
    std = mont_mul(w, one.expand_as(w), FR)  # out of Montgomery form
    return _byte_planes(std).reshape(L8, size, size)


def _build_level_tables(n: int, omega: int, base_scale: int, device):
    """Recursive 4-step table tree (the reference's structure and split
    sizes).  The base level's DFT matrix carries ``base_scale`` (the
    inverse's 1/n: each element crosses the base exactly once)."""
    if n <= MAX_BASE:
        return ("base", n, _dft_limb_table(n, omega, base_scale, device))
    k = n.bit_length() - 1
    n1 = min(MAX_BASE, 1 << ((k + 1) // 2))
    n2 = n // n1
    w1_8 = _dft_limb_table(n1, pow(omega, n2, P), 1, device)
    t_mont = _row_powers([pow(omega, k1, P) for k1 in range(n1)], n2, device).reshape(L, n)
    sub = _build_level_tables(n2, pow(omega, n1, P), base_scale, device)
    return ("split", n1, n2, w1_8, t_mont, sub)


class LimbMatmulNTT:
    """NTT of one power-of-two size on [16, n] (or batched [16, B, n])
    int32 Montgomery limb tensors of one device, natural order in and out.
    Counterpart of the reference's ``MXUNTT``."""

    def __init__(self, n: int, device):
        if n < 1 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two, got {n}")
        self.n = n
        self.device = resolve(device)
        omega = fr_root_of_unity(n)
        omega_inv = pow(omega, P - 2, P)
        self._fwd = _build_level_tables(n, omega, 1, self.device)
        self._inv = _build_level_tables(n, omega_inv, pow(n, P - 2, P), self.device)

    def _run(self, x: torch.Tensor, tables) -> torch.Tensor:
        """x: [16, B, n] -> [16, B, n]."""
        B = x.shape[1]
        if tables[0] == "base":
            _, n, w8 = tables
            rhs = _byte_planes(x).transpose(1, 2)  # [32, n, B]
            y = ntt_reduce(_limb_matmul(w8, rhs).reshape(PLANES, -1))  # [16, n·B]
            return y.reshape(L, n, B).transpose(1, 2)
        _, n1, n2, w1_8, t_mont, sub = tables
        # phase A: column transforms over j1 (contraction n1), free axis (B, j2)
        y = ntt_reduce(self._phase_a_planes(x, tables))
        # twiddle Hadamard: T[k1, j2] broadcast over B
        t_full = t_mont.reshape(L, n1, 1, n2).expand(L, n1, B, n2).reshape(L, -1)
        y = mont_mul(y, t_full, FR)
        # phase B: row transforms of size n2, batched over (k1, B)
        z = self._run(y.reshape(L, n1 * B, n2), sub)
        # out[b, k2·n1 + k1] = z[k1, b, k2]
        z = z.reshape(L, n1, B, n2).permute(0, 2, 3, 1)
        return z.reshape(L, B, n1 * n2)

    @staticmethod
    def _phase_a_planes(x: torch.Tensor, tables) -> torch.Tensor:
        """[63, n1·B·n2] partial-limb planes of a split level's column
        transforms (x: [16, B, n])."""
        _, n1, n2, w1_8 = tables[:4]
        B = x.shape[1]
        x8 = _byte_planes(x.reshape(L, B, n1, n2))
        rhs = x8.permute(0, 2, 1, 3).reshape(L8, n1, B * n2)
        del x8
        return _limb_matmul(w1_8, rhs).reshape(PLANES, -1)

    def partial_planes(self, x: torch.Tensor) -> torch.Tensor:
        """The [63, n] int32 planes that the forward transform's first level
        hands to :func:`ntt_reduce` for the [16, n] input ``x`` (n > 256):
        real inputs for holding the reduce kernel against its plain version."""
        self._check(x)
        if self._fwd[0] != "split":
            raise ValueError("a transform of at most 256 points has no split level")
        return self._phase_a_planes(x[:, None, :], self._fwd)

    def _check(self, x: torch.Tensor, batched: bool = False) -> None:
        dims = 3 if batched else 2
        if x.dim() != dims or x.shape[0] != L or x.shape[-1] != self.n or x.dtype != torch.int32:
            shape = f"[16, B, {self.n}]" if batched else f"[16, {self.n}]"
            raise ValueError(f"expected a {shape} int32 limb tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, transform tables on {self.device}")

    def fft_mont(self, x: torch.Tensor) -> torch.Tensor:
        """coefficients -> evaluations over the size-n domain."""
        self._check(x)
        return self._run(x[:, None, :], self._fwd)[:, 0, :].contiguous()

    def ifft_mont(self, x: torch.Tensor) -> torch.Tensor:
        """evaluations -> coefficients (1/n folded into the tables)."""
        self._check(x)
        return self._run(x[:, None, :], self._inv)[:, 0, :].contiguous()

    def fft_mont_batch(self, x: torch.Tensor) -> torch.Tensor:
        """B transforms at once, [16, B, n] -> [16, B, n]: one pass over the
        shared tables, each level's matmuls B times as wide."""
        self._check(x, batched=True)
        return self._run(x, self._fwd).contiguous()

    def ifft_mont_batch(self, x: torch.Tensor) -> torch.Tensor:
        """B inverse transforms at once (1/n folded in), [16, B, n]."""
        self._check(x, batched=True)
        return self._run(x, self._inv).contiguous()


@lru_cache(maxsize=16)
def get_ntt(n: int, device: torch.device) -> LimbMatmulNTT:
    """The transform of size ``n`` on ``device``, its tables built once."""
    return LimbMatmulNTT(n, device)
