"""DVec: the device-resident polynomial plane over BLS12-377 Fr.

Port of ``simpleworks_tpu/fields/dvec.py``.  A field vector is an
``[16, N]`` ``torch.int32`` tensor of 16-bit Montgomery limbs
(:mod:`simpleworks_tpu_torch.fields.device`).  Elementwise ops go through
the field kernels of :mod:`simpleworks_tpu_torch.ops.mont_mul` (CUDA
kernels for CUDA tensors, their plain versions for CPU tensors), so every
width is accepted as it is: the kernels mask their own ragged edge.

Sequential-looking polynomial ops are log-depth device programs:
divide-by-linear is a powers build, two multiplies and a log-step suffix
scan of modular adds; divide-by-vanishing is the same scan with a stride of
one block; evaluation is a powers build, a multiply and a halving tree of
modular adds.  The transforms (``fft``/``ifft``) run the NTT of
:mod:`simpleworks_tpu_torch.ops.ntt` on the vector's device, or the sharded
4-step NTT over the prover's devices when :mod:`..ops.accel` routes them
there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..errors import ensure
from ..ops import accel
from ..ops.mont_mul import FR, mod_add, mod_sub, mont_mul, mont_pow
from ..ops.ntt import get_ntt
from ..device import resolve
from .bls12_377 import FR_MODULUS
from .device import from_mont, limbs_to_ints, mont_scalar, to_mont

P = FR_MODULUS
L = FR.n_limbs  # 16-bit limbs per element


# ------------------------------------------------------------ elementwise ----


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, b, FR)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mod_add(a, b, FR)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mod_sub(a, b, FR)


def scale(a: torch.Tensor, scalar_mont: torch.Tensor) -> torch.Tensor:
    """a · s with s a [16, 1] Montgomery limb column."""
    return mul(a, scalar_mont.expand_as(a))


def rsub_scalar(a: torch.Tensor, scalar_mont: torch.Tensor) -> torch.Tensor:
    """s − a elementwise."""
    return sub(scalar_mont.expand_as(a), a)


def pow_const(a: torch.Tensor, exponent: int) -> torch.Tensor:
    return mont_pow(a, exponent, FR)


def inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse via Fermat (x^(p−2); zeros stay zero)."""
    return pow_const(a, P - 2)


def to_standard(a: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs -> the standard-form values' 16-bit limbs: one
    multiply by the literal 1 (montmul(v·R, 1) = v, canonical)."""
    one = torch.zeros((L, 1), dtype=torch.int32, device=a.device)
    one[0, 0] = 1
    return mul(a, one.expand_as(a))


# ---------------------------------------------------------------- reshape ----


def zeros(n: int, device=None) -> torch.Tensor:
    return torch.zeros((L, n), dtype=torch.int32, device=resolve(device))


def pad_to(a: torch.Tensor, n: int) -> torch.Tensor:
    cur = a.shape[1]
    if cur >= n:
        return a
    return torch.cat([a, zeros(n - cur, a.device)], dim=1)


def const_vec(value: int, n: int, device=None) -> torch.Tensor:
    """[16, n] Montgomery view of one repeated constant."""
    return mont_scalar(value, FR, device).expand(L, n)


# --------------------------------------------------------------- log-depth ----


def sum_limbs_raw(a: torch.Tensor) -> torch.Tensor:
    """Σ over the batch axis as raw per-limb sums -> [16, 1] int64, one
    device op.  int64 cannot wrap below 2^47 elements (each limb < 2^16);
    pair with :func:`limb_sums_to_int`."""
    return a.to(torch.int64).sum(dim=1, keepdim=True)


def limb_sums_to_int(sums) -> int:
    """[16, K] raw partial limb sums -> standard-form int of the Montgomery
    sum (exact host fold plus one Montgomery correction)."""
    arr = sums.cpu().numpy() if isinstance(sums, torch.Tensor) else np.asarray(sums)
    m = 0
    for t in range(L - 1, -1, -1):
        m = (m << 16) + int(arr[t].astype(np.int64).sum())
    return m % P * pow(FR.r, -1, P) % P


def sum_reduce(a: torch.Tensor) -> torch.Tensor:
    """Σ over the batch axis -> [16, 1] (halving tree of modular adds)."""
    n = a.shape[1]
    if n == 0:
        return zeros(1, a.device)
    while n > 1:
        half = n // 2
        red = add(a[:, :half], a[:, half : 2 * half])
        if n % 2:
            red = torch.cat([red, a[:, n - 1 :]], dim=1)
        a = red
        n = a.shape[1]
    return a


def suffix_sum(a: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """S_j = Σ_{t≥0} a_{j + t·stride}: a log-step (Hillis-Steele) scan of
    modular adds over the lanes ``stride`` apart."""
    n = a.shape[1]
    k = stride
    while k < n:
        a = torch.cat([add(a[:, : n - k], a[:, k:]), a[:, n - k :]], dim=1)
        k <<= 1
    return a


def divide_by_vanishing(a: torch.Tensor, ell: int):
    """(quotient [16, N − ell], remainder [16, ell]) of the [16, N]
    coefficient tensor's division by X^ell − 1: the remainder block is the
    sum of all blocks of ``ell`` coefficients and quotient block b the sum
    of the blocks above it, one strided suffix scan."""
    n = a.shape[1]
    if n <= ell:
        return a[:, :0], a
    k = -(-n // ell)  # blocks
    s = suffix_sum(pad_to(a, k * ell), stride=ell)
    return s[:, ell:n], s[:, :ell]


def divide_by_linear(a: torch.Tensor, z: int):
    """(quotient [16, N−1], remainder [16, 1]) of division by (X − z).

    Suffix-Horner: with w_t = c_t·z^t and S_j = Σ_{t≥j} w_t, the quotient is
    q_j = z^{−(j+1)}·S_{j+1} and the remainder is S_0 = p(z).  ``z`` is the
    standard-form point."""
    n = a.shape[1]
    if n == 0:
        return a, zeros(1, a.device)
    z = z % P
    if z == 0:
        return a[:, 1:], a[:, :1]
    s = suffix_sum(mul(a, powers_vec(z, n, a.device)))
    z_inv = pow(z, P - 2, P)
    inv_pows = scale(powers_vec(z_inv, n - 1, a.device), mont_scalar(z_inv, FR, a.device))
    return mul(s[:, 1:], inv_pows), s[:, :1]


def evaluate(a: torch.Tensor, z: int) -> torch.Tensor:
    """p(z) for a [16, N] coefficient tensor -> [16, 1] Montgomery result."""
    n = a.shape[1]
    if n == 0:
        return zeros(1, a.device)
    return sum_reduce(mul(a, powers_vec(z, n, a.device)))


def powers_vec(base: int, n: int, device=None) -> torch.Tensor:
    """[16, n] Montgomery tensor [1, z, z², …] by log-doubling (~log n muls)."""
    device = resolve(device)
    out = mont_scalar(1, FR, device)
    width = 1
    while width < n:
        step = min(width, n - width)
        top = mont_scalar(pow(base, width, P), FR, device)
        out = torch.cat([out, scale(out[:, :step], top)], dim=1)
        width += step
    return out[:, :n]


# ------------------------------------------------------------- transforms ----


def _sharded_devices(n: int):
    """The prover's devices when a transform of ``n`` points takes the
    sharded 4-step NTT (``ops.accel``), else None."""
    if not accel.use_sharded_ntt(n):
        return None
    from ..parallel import ntt_sharded

    devices = accel.prover_devices()
    if devices is None or not ntt_sharded.sharded_transform_supported(devices, n):
        return None
    return devices


def fft(a: torch.Tensor, n: int) -> torch.Tensor:
    """coefficients [16, ≤ n] -> evaluations [16, n] over the size-n domain
    (natural order, Montgomery in and out); sharded over the prover's
    devices when they are set and n reaches the threshold (equal values)."""
    ensure(a.shape[1] <= n, f"{a.shape[1]} coefficients exceed the domain of {n}")
    devices = _sharded_devices(n)
    if devices is not None:
        from ..parallel import ntt_sharded

        return ntt_sharded.sharded_transform(devices, pad_to(a, n))
    return get_ntt(n, a.device).fft_mont(pad_to(a, n))


def ifft(a: torch.Tensor, n: int) -> torch.Tensor:
    """evaluations [16, n] -> coefficients (1/n folded in); sharded as
    :func:`fft`."""
    devices = _sharded_devices(n)
    if devices is not None:
        from ..parallel import ntt_sharded

        return ntt_sharded.sharded_transform(devices, a, inverse=True)
    return get_ntt(n, a.device).ifft_mont(a)


# ------------------------------------------------------------ host bridge ----


def from_ints(values: Sequence[int], device=None) -> torch.Tensor:
    """Standard-form ints -> [16, N] Montgomery tensor on ``device``."""
    return to_mont(values, FR, device)


def to_ints(a: torch.Tensor) -> list[int]:
    """[16, N] Montgomery tensor -> standard-form ints (fetches)."""
    return from_mont(a, FR)


def scalar_to_int(col: torch.Tensor) -> int:
    """[16, 1] Montgomery column -> standard-form int (fetches)."""
    return limbs_to_ints(col)[0] * pow(FR.r, -1, P) % P
