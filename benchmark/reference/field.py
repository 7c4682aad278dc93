"""The scalar field Fr and base field Fq of BLS12-377 (the curve's published
parameters), and arkworks' uniform sampling of Fr."""

from __future__ import annotations

#: the BLS parameter x of BLS12-377
BLS_X = 0x8508C00000000001
#: the scalar field's modulus r = x^4 - x^2 + 1
R = BLS_X**4 - BLS_X**2 + 1
#: the base field's modulus q = (x - 1)^2 r / 3 + x
Q = (BLS_X - 1) ** 2 * R // 3 + BLS_X
assert R == 8444461749428370424248824938781546531375899335154063827935233455917409239041

#: Montgomery radix of Fr (four 64-bit words) and its inverse mod r
MONT_R = (1 << 256) % R
MONT_R_INV = pow(MONT_R, -1, R)
#: bits of r, and the top bits of its 256-bit representation always zero
R_BITS = R.bit_length()
SHAVE_BITS = 256 - R_BITS
#: r - 1 = 2^47 t with t odd; 22 generates Fr* (arkworks' GENERATOR)
TWO_ADICITY = 47
TWO_ADIC_ROOT = pow(22, (R - 1) >> TWO_ADICITY, R)


def root_of_unity(n: int) -> int:
    """The generator of the order-n subgroup that arkworks' radix-2 domain
    uses: the two-adic root squared down to order n (a power of two)."""
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n or log_n > TWO_ADICITY:
        raise ValueError(f"no radix-2 domain of size {n}")
    return pow(TWO_ADIC_ROOT, 1 << (TWO_ADICITY - log_n), R) if n > 1 else 1


def sample_fr(next_u64) -> int:
    """arkworks 0.3 ``UniformRand`` for Fr: four u64 words, little-endian,
    the top bits cleared, rejected while not below r; the words are the
    Montgomery representation, so the value is words * R^-1."""
    mask = (1 << (64 - SHAVE_BITS)) - 1
    while True:
        words = [next_u64() for _ in range(4)]
        words[3] &= mask
        value = sum(w << (64 * i) for i, w in enumerate(words))
        if value < R:
            return value * MONT_R_INV % R


def batch_inverse(values: list[int], modulus: int = R) -> list[int]:
    """Inverses of nonzero ``values`` with one exponentiation."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % modulus
    inv = pow(prefix[-1], -1, modulus)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % modulus
        inv = inv * values[i] % modulus
    return out


def next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n
