"""The limb layout of field vectors on the device, and vectorised packers.

A field vector is a limb-major ``[L, B]`` ``torch.int32`` tensor of 16-bit
limbs, little-endian limb order, in Montgomery form with R = 2^(16 L)
(Fr: L = 16, R = 2^256; Fq: L = 24, R = 2^384) — the layout of the JAX
package's ``uint32`` arrays, value for value.

The packers go through ``int.to_bytes`` / ``np.frombuffer`` rather than a
per-limb Python loop, so a table of millions of elements packs in seconds.

:class:`DeviceField` is the reference's batched field surface over this
layout: a thin class whose ops are the field kernels of
:mod:`simpleworks_tpu_torch.ops.mont_mul` (their plain versions on CPU
tensors).  The reference's arrays are ``[..., L]``; here they are ``[L, B]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..device import resolve
from .bls12_377 import Fq, Fr
from .host import FieldParams

__all__ = [
    "LIMB_BITS", "LIMB_MASK", "LimbField", "FR", "FQ", "split_words", "ints_to_limbs",
    "limbs_to_ints", "to_mont", "from_mont", "to_limbs_tensor", "mont_scalar", "from_reference_limbs", "to_reference_limbs",
    "int_to_limbs", "limbs_to_int", "DeviceField",
]

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def split_words(value: int, n: int, bits: int) -> list[int]:
    mask = (1 << bits) - 1
    return [(value >> (bits * i)) & mask for i in range(n)]


class LimbField:
    """Constants of one prime field in the limb layout."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.modulus
        self.n_limbs = params.repr_bits // LIMB_BITS
        self.n_words = self.n_limbs // 2  # 32-bit words inside the kernels
        self.r = params.montgomery_r  # R mod p: Montgomery one
        self.p_limbs = split_words(self.p, self.n_limbs, LIMB_BITS)
        self.one_limbs = split_words(self.r, self.n_limbs, LIMB_BITS)
        self.n0_16 = (-pow(self.p, -1, 1 << 16)) % (1 << 16)
        self.n0_32 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        words = ctypes.c_uint32 * self.n_words
        self._p_words = words(*split_words(self.p, self.n_words, 32))
        self._one_words = words(*split_words(self.r, self.n_words, 32))
        self.p_words_ptr = ctypes.addressof(self._p_words)
        self.one_words_ptr = ctypes.addressof(self._one_words)

    def col(self, limbs: list[int], device, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(limbs, dtype=dtype, device=device).reshape(self.n_limbs, 1)

    def one(self, batch: int, device) -> torch.Tensor:
        """[L, batch] Montgomery one (an expanded view; copy before writing)."""
        return self.col(self.one_limbs, device).expand(self.n_limbs, batch)


FR = LimbField(Fr.PARAMS)
FQ = LimbField(Fq.PARAMS)


def ints_to_limbs(values: Sequence[int], n_limbs: int) -> np.ndarray:
    """Non-negative ints < 2^(16 n_limbs) -> [n_limbs, N] uint16 limbs."""
    nbytes = 2 * n_limbs
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs).T


def limbs_to_ints(limbs) -> list[int]:
    """[L, N] limbs (numpy or tensor, each < 2^16) -> N ints."""
    arr = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) else np.asarray(limbs)
    n_limbs = arr.shape[0]
    buf = np.ascontiguousarray(arr.T.astype("<u2")).tobytes()
    nbytes = 2 * n_limbs
    return [
        int.from_bytes(buf[i : i + nbytes], "little") for i in range(0, len(buf), nbytes)
    ]


def to_limbs_tensor(values: Sequence[int], field: LimbField, device=None) -> torch.Tensor:
    """Ints (already in the representation wanted) -> [L, N] int32 tensor."""
    arr = ints_to_limbs(values, field.n_limbs).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(resolve(device))


def to_mont(values: Sequence[int], field: LimbField, device=None) -> torch.Tensor:
    """Standard-form ints -> [L, N] Montgomery limb tensor."""
    p, r = field.p, field.r
    return to_limbs_tensor([int(v) % p * r % p for v in values], field, device)


def from_mont(t: torch.Tensor, field: LimbField) -> list[int]:
    """[L, N] Montgomery limb tensor -> standard-form ints."""
    p = field.p
    rinv = pow(field.r, -1, p)
    return [v * rinv % p for v in limbs_to_ints(t)]


def mont_scalar(value: int, field: LimbField = FR, device=None) -> torch.Tensor:
    """[L, 1] Montgomery limb column of one standard-form scalar."""
    return to_mont([value], field, device)


def from_reference_limbs(arr: np.ndarray, device=None) -> torch.Tensor:
    """The JAX package's [L, B] uint32 limb array -> the port's int32 tensor."""
    a = np.asarray(arr)
    if a.ndim != 2 or a.shape[0] not in (FR.n_limbs, FQ.n_limbs):
        raise ValueError(f"expected an [L, B] limb array with L in (16, 24), got {a.shape}")
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limbs must be 16-bit values")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(resolve(device))


def to_reference_limbs(t: torch.Tensor) -> np.ndarray:
    """The port's [L, B] int32 tensor -> the JAX package's uint32 layout."""
    return t.cpu().numpy().astype(np.uint32)


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    """One non-negative int < 2^(16 n_limbs) -> its [n_limbs] uint32 16-bit limbs."""
    return np.array(split_words(int(value), n_limbs, LIMB_BITS), dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """[L] 16-bit limbs (little-endian) -> the int they spell."""
    value = 0
    for limb in reversed(np.asarray(limbs, dtype=np.uint64).reshape(-1).tolist()):
        value = (value << LIMB_BITS) | int(limb)
    return value


class DeviceField:
    """Constants and batched ops of one prime field on ``[L, B]`` Montgomery
    limb tensors (R = 2^(16 L)).  ``add`` is the mod-add kernel, ``sub`` and
    ``neg`` the mod-sub kernel, ``mul``, ``square`` and ``mul_scalar_mont``
    the Montgomery-multiply kernel and ``pow_host_exponent`` the pow kernel;
    a ``[L, 1]`` operand broadcasts over the lanes."""

    def __init__(self, params: FieldParams):
        from ..ops import mont_mul

        self._k = mont_mul
        self.params = params
        self.field = next((f for f in (FR, FQ) if f.params == params), None) or LimbField(params)
        L = self.n_limbs = self.field.n_limbs
        p = self.p_int = params.modulus
        self.r_int = params.montgomery_r
        self.r2_int = self.r_int**2 % p
        self.p_limbs = int_to_limbs(p, L)
        self.r_limbs = int_to_limbs(self.r_int, L)
        self.r2_limbs = int_to_limbs(self.r2_int, L)
        self.n0 = self.field.n0_16  # −p⁻¹ mod 2^16, the REDC digit factor
        self.zero = np.zeros((L,), dtype=np.uint32)
        self.one_mont = int_to_limbs(self.r_int, L)

    # -- host <-> device ----------------------------------------------------

    def to_mont(self, values, device=None) -> torch.Tensor:
        """Standard-form ints -> [L, N] Montgomery tensor on ``device`` (the
        card by default)."""
        vals = values if isinstance(values, (list, tuple)) else np.atleast_1d(values).tolist()
        return to_mont(vals, self.field, device)

    def from_mont(self, t: torch.Tensor) -> list[int]:
        """[L, N] Montgomery tensor -> standard-form ints (fetches)."""
        return from_mont(t, self.field)

    # -- limb plumbing -------------------------------------------------------

    def normalize(self, t: torch.Tensor) -> torch.Tensor:
        """Carry-propagate [L, B] limb rows so every limb is < 2^16; the
        carry out of the top limb is dropped."""
        limbs, _carry = self._k._normalize(t.to(torch.int64))
        return limbs.to(torch.int32)

    # -- modular ops (Montgomery form in and out) ------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._k.mod_add(*torch.broadcast_tensors(a, b), self.field)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._k.mod_sub(*torch.broadcast_tensors(a, b), self.field)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        """p − a, and 0 for 0."""
        return self.sub(torch.zeros_like(a[:, :1]).expand_as(a), a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·R⁻¹ mod p."""
        return self._k.mont_mul(*torch.broadcast_tensors(a, b), self.field)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_scalar_mont(self, a: torch.Tensor, scalar_mont: torch.Tensor) -> torch.Tensor:
        """Every lane times one [L, 1] Montgomery scalar."""
        return self.mul(a, scalar_mont.reshape(self.n_limbs, 1).expand_as(a))

    def pow_host_exponent(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a fixed host exponent e ≥ 0.  Beyond the kernel's 384
        bits, e is taken mod p − 1 (a nonzero multiple as p − 1, so 0 stays
        0), which gives the same power of every element."""
        e = int(e)
        if e < 0:
            raise ValueError("the exponent must be non-negative")
        if e.bit_length() > 384:
            e = (e - 1) % (self.p_int - 1) + 1
        return self._k.mont_pow(a, e, self.field)

    def select(self, cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Lanewise cond ? a : b; ``cond`` a [B] bool tensor."""
        return torch.where(cond[None, :], a, b)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)
