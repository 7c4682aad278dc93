"""Exact host-side prime-field arithmetic (arbitrary-precision Python ints).

This is the framework's "scalar" field layer, used for circuit synthesis,
parameter generation, serialization and as the correctness oracle for the
batched limb kernels of :mod:`simpleworks_tpu_torch.ops.mont_mul`.

The reference delegates all field arithmetic to arkworks (`ark-ff`), see
reference ``Cargo.toml:14-30`` and SURVEY.md §2.3.  The semantics replicated
here:

* ``from_str`` decimal parsing reduces mod p (used for the Poseidon constants,
  reference ``src/hash/helpers.rs``).
* ``from_le_bytes_mod_order`` (reference ``src/schnorr_signature/schnorr.rs:114``).
* CanonicalSerialize: little-endian standard-representation bytes of size
  ceil(MODULUS_BITS/8) (reference ``src/fields/serialization.rs:5-16``).
* ``ToBytes``: full little-endian limb bytes (4 or 6 u64 limbs).
* ``UniformRand``: samples the *Montgomery representation* uniformly by
  drawing u64 limbs, masking the top ``REPR_SHAVE_BITS`` bits, and rejecting
  values >= p (ark-ff 0.3 behaviour; the field value is repr * R^-1 mod p).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache


@dataclass(frozen=True)
class FieldParams:
    """Static parameters of a prime field in arkworks 0.3 conventions."""

    name: str
    modulus: int
    n_u64_limbs: int  # BigInteger limb count (4 for 256-bit repr, 6 for 384)

    @property
    def modulus_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def byte_size(self) -> int:
        """CanonicalSerialize byte size = ceil(modulus_bits / 8)."""
        return (self.modulus_bits + 7) // 8

    @property
    def repr_bits(self) -> int:
        return 64 * self.n_u64_limbs

    @property
    def repr_shave_bits(self) -> int:
        return self.repr_bits - self.modulus_bits

    @property
    def montgomery_r(self) -> int:
        """R = 2^(64*limbs) mod p."""
        return (1 << self.repr_bits) % self.modulus

    @property
    def montgomery_r_inv(self) -> int:
        return pow(self.montgomery_r, -1, self.modulus)

    @property
    def two_adicity(self) -> int:
        s, t = 0, self.modulus - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        return s


class Fp:
    """A prime field element in standard (non-Montgomery) representation.

    Subclasses bind ``PARAMS`` (and optionally ``GENERATOR`` for two-adic
    domains).  Values are canonical: ``0 <= value < p``.
    """

    PARAMS: FieldParams
    GENERATOR: int | None = None  # multiplicative generator (arkworks convention)

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        p = self.PARAMS.modulus
        self.value = value % p

    # -- constructors ------------------------------------------------------

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_str(cls, s: str):
        """arkworks ``from_str``: decimal parse with mod-p reduction."""
        return cls(int(s) % cls.PARAMS.modulus)

    @classmethod
    def from_le_bytes_mod_order(cls, data: bytes):
        return cls(int.from_bytes(data, "little") % cls.PARAMS.modulus)

    @classmethod
    def from_be_bytes_mod_order(cls, data: bytes):
        return cls(int.from_bytes(data, "big") % cls.PARAMS.modulus)

    @classmethod
    def rand(cls, rng):
        """arkworks 0.3 ``UniformRand``: uniform Montgomery repr via
        limb sampling + top-bit masking + rejection."""
        params = cls.PARAMS
        shave_mask = (1 << (64 - params.repr_shave_bits)) - 1 if params.repr_shave_bits else (1 << 64) - 1
        while True:
            limbs = [rng.next_u64() for _ in range(params.n_u64_limbs)]
            limbs[-1] &= shave_mask
            repr_int = 0
            for i, limb in enumerate(limbs):
                repr_int |= limb << (64 * i)
            if repr_int < params.modulus:
                # repr_int IS the Montgomery representation; convert.
                return cls(repr_int * params.montgomery_r_inv % params.modulus)

    @classmethod
    def rand_vec(cls, rng, count: int) -> list[int]:
        """``count`` samples with byte-identical stream consumption to
        ``count`` sequential ``rand`` calls, but pulling the keystream in
        bulk (vectorized ChaCha) — used by the Marlin zk mask sampler."""
        params = cls.PARAMS
        mask = (1 << (params.repr_bits - params.repr_shave_bits)) - 1
        r_inv = params.montgomery_r_inv
        p = params.modulus
        nbytes = params.repr_bits // 8
        wpi = nbytes // 4  # keystream words per sampling attempt
        out: list[int] = []
        while len(out) < count:
            # each attempt consumes exactly wpi words; ~1.72 attempts/sample
            # for Fr (acceptance p/2^253 ≈ 0.58); over-draw and unget the rest
            attempts = max(32, int((count - len(out)) * 1.9) + 8)
            words = rng.take_words(attempts * wpi)
            buf = words.astype("<u4").tobytes()
            for i in range(attempts):
                repr_int = int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") & mask
                if repr_int < p:
                    out.append(repr_int * r_inv % p)
                    if len(out) == count:
                        if i + 1 < attempts:
                            rng.unget(words[(i + 1) * wpi :])
                        return out
        return out

    # -- serde -------------------------------------------------------------

    def serialize(self) -> bytes:
        """CanonicalSerialize: LE bytes, length ceil(modulus_bits/8)."""
        return self.value.to_bytes(self.PARAMS.byte_size, "little")

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) < cls.PARAMS.byte_size:
            raise ValueError(f"{cls.__name__}: need {cls.PARAMS.byte_size} bytes")
        v = int.from_bytes(data[: cls.PARAMS.byte_size], "little")
        if v >= cls.PARAMS.modulus:
            raise ValueError(f"{cls.__name__}: value >= modulus")
        return cls(v)

    def to_bytes_raw(self) -> bytes:
        """arkworks ``ToBytes``: full limb bytes (repr_bits/8 bytes, LE)."""
        return self.value.to_bytes(self.PARAMS.repr_bits // 8, "little")

    def serialize_with_flags(self, flags: int, flag_bits: int = 1) -> bytes:
        """CanonicalSerialize with ``flag_bits`` flag bits packed into the
        top of the final byte (an extra byte is appended only when the spare
        bits of the modulus byte-size don't fit them — arkworks semantics).
        ``flags`` is the final-byte OR-mask (e.g. 0x80 for a 1-bit flag)."""
        params = self.PARAMS
        output_bits = params.byte_size * 8
        if output_bits - params.modulus_bits < flag_bits:
            out = bytearray(self.value.to_bytes(params.byte_size + 1, "little"))
        else:
            out = bytearray(self.serialize())
        out[-1] |= flags
        return bytes(out)

    # -- arithmetic --------------------------------------------------------

    def __add__(self, other):
        return type(self)(self.value + other.value)

    def __sub__(self, other):
        return type(self)(self.value - other.value)

    def __mul__(self, other):
        return type(self)(self.value * other.value)

    def __neg__(self):
        return type(self)(-self.value)

    def __pow__(self, exponent: int):
        return type(self)(pow(self.value, exponent, self.PARAMS.modulus))

    def inverse(self):
        if self.value == 0:
            raise ZeroDivisionError("field inverse of zero")
        return type(self)(pow(self.value, -1, self.PARAMS.modulus))

    def __truediv__(self, other):
        return self * other.inverse()

    def double(self):
        return type(self)(self.value * 2)

    def square(self):
        return type(self)(self.value * self.value)

    def is_zero(self) -> bool:
        return self.value == 0

    def is_one(self) -> bool:
        return self.value == 1

    def legendre(self) -> int:
        """1 if QR, -1 if non-residue, 0 if zero."""
        if self.value == 0:
            return 0
        e = pow(self.value, (self.PARAMS.modulus - 1) // 2, self.PARAMS.modulus)
        return 1 if e == 1 else -1

    def sqrt(self):
        """Tonelli–Shanks square root; returns None for non-residues."""
        p = self.PARAMS.modulus
        if self.value == 0:
            return type(self)(0)
        if self.legendre() != 1:
            return None
        root = _tonelli_shanks(self.value, p, type(self))
        return type(self)(root)

    def is_odd(self) -> bool:
        return self.value % 2 == 1

    # "negative" in the arkworks sense: greater than -self (i.e. > (p-1)/2
    # is NOT the rule; arkworks compares self > -self on the standard repr).
    def is_greater_than_neg(self) -> bool:
        return self.value > (self.PARAMS.modulus - self.value) % self.PARAMS.modulus

    # -- dunder plumbing -----------------------------------------------------

    def __eq__(self, other):
        return isinstance(other, Fp) and self.PARAMS is other.PARAMS and self.value == other.value

    def __hash__(self):
        return hash((self.PARAMS.name, self.value))

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"

    def __int__(self):
        return self.value


@lru_cache(maxsize=None)
def _sqrt_precomp(p: int):
    """(s, t, z^t mod p) with p-1 = 2^s * t and z the smallest non-residue."""
    s, t = 0, p - 1
    while t % 2 == 0:
        s, t = s + 1, t // 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return s, t, pow(z, t, p)


def _tonelli_shanks(n: int, p: int, _cls) -> int:
    s, t, c = _sqrt_precomp(p)
    r = pow(n, (t + 1) // 2, p)
    u = pow(n, t, p)
    m = s
    while u != 1:
        # find least i with u^(2^i) == 1
        i, v = 0, u
        while v != 1:
            v = v * v % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        r = r * b % p
        c = b * b % p
        u = u * c % p
        m = i
    return r


def make_field(name: str, modulus: int, n_u64_limbs: int, generator: int | None = None):
    """Create a concrete field class bound to the given parameters."""
    params = FieldParams(name=name, modulus=modulus, n_u64_limbs=n_u64_limbs)
    cls = type(name, (Fp,), {"PARAMS": params, "GENERATOR": generator, "__slots__": ()})
    return cls
