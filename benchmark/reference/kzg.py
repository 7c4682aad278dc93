"""KZG10 by its definition: the SRS is [tau^i]G, so a commitment to p is
[p(tau)]G.  The benchmark draws tau and gamma from the seed and gives both
to the setup under test, so the reference knows them and evaluates p at tau
instead of summing the SRS.

The coefficients arrive as the program's input tensor: [16, n] 16-bit limbs
(little-endian) of the Montgomery form c = a * 2^256 mod r of each value a.
p(tau) = 2^-256 * sum_i c_i tau^i, and the sum is one float64 matrix product
of limbs: sum_i c_ij t_ik for limb j of c_i and limb k of tau^i has
products below 2^32 and at most 2^20 terms a block, so every partial sum is
an integer below 2^53 and exact in any order."""

from __future__ import annotations

import numpy as np

from . import g1
from .field import MONT_R_INV, R, sample_fr

#: columns a block of the limb product (2^20 keeps partial sums below 2^52)
BLOCK = 1 << 20


def setup_scalars(next_u64) -> tuple[int, int]:
    """(tau, gamma) as the setup draws them from its rng: tau, then gamma."""
    tau = sample_fr(next_u64)
    gamma = sample_fr(next_u64)
    return tau, gamma


def power_limbs(x: int, n: int) -> np.ndarray:
    """[16, n] float64 16-bit limbs of x^0 .. x^(n-1) mod r."""
    powers = bytearray()
    acc = 1
    for _ in range(n):
        powers += acc.to_bytes(32, "little")
        acc = acc * x % R
    return np.frombuffer(bytes(powers), dtype="<u2").reshape(n, 16).T.astype(np.float64)


def mont_eval(limbs: np.ndarray, x_limbs: np.ndarray) -> int:
    """p(x) mod r for the [16, n] Montgomery limbs ``limbs`` (any integer
    dtype) against ``power_limbs(x, >= n)``."""
    n = limbs.shape[1]
    total = 0
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        block = np.asarray(limbs[:, lo:hi], dtype=np.float64) @ x_limbs[:, lo:hi].T
        for j in range(16):
            for k in range(16):
                total += int(block[j, k]) << (16 * (j + k))
    return total % R * MONT_R_INV % R


def commitment(limbs: np.ndarray, x_limbs: np.ndarray):
    """The expected commitment [p(tau)]G (Jacobian)."""
    return g1.mul(mont_eval(limbs, x_limbs), g1.GENERATOR)


def srs_power(tau: int, i: int):
    """The SRS's i-th power [tau^i]G."""
    return g1.mul(pow(tau, i, R), g1.GENERATOR)
