"""[p(tau)]G for polynomials too wide for one table of powers, as at
ZPrize's 2^26 bases: p(tau) is evaluated in two levels of blocks of B
coefficients,

    p(tau) = sum_j tau^(jB) * (sum_k c_(jB+k) tau^k),

from two tables of 16-bit limbs, tau^k for k < B and tau^(jB) for j <
ceil(n/B), each of them B or n/B Python products long instead of n.

Both levels are exact float64 limb products, as ``kzg.mont_eval``: a block's
inner sum over B = 2^13 coefficients of limb products below 2^32 is below
2^45; its 16 x 16 limb sums folded into 31 diagonals stay below 2^49; the
diagonals carried into 34 16-bit limbs (in int64) make the block's value
v_j without reducing it; and the outer sum over n/B blocks of limb products
v_j[t] * tau^(jB)[u] stays below 2^53 while n/B < 2^21 (2^45 at n = 2^26).
Every partial sum is an integer below 2^53, exact in any order."""

from __future__ import annotations

import numpy as np

from . import g1
from .field import MONT_R_INV, R
from .kzg import power_limbs

#: coefficients a block of the inner level
BLOCK = 1 << 13
#: coefficients converted to float64 at a time (128 MB of limbs)
CHUNK = 1 << 20
#: 16-bit limbs of a block's value: 31 diagonals of sums below 2^49
VALUE_LIMBS = 34


def power_tables(x: int, n: int, block: int = BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """(low [16, block], high [16, ceil(n / block)]) float64 limbs of x^k
    for k < block and of x^(j * block)."""
    return power_limbs(x, block), power_limbs(pow(x, block, R), -(-n // block))


def block_values(limbs: np.ndarray, low: np.ndarray) -> np.ndarray:
    """[16, n] Montgomery limbs -> [ceil(n / B), 34] int64: each block's
    sum_k c_(jB+k) x^k (x^k from ``low``) as unreduced 16-bit limbs."""
    block = low.shape[1]
    n = limbs.shape[1]
    step = max(block, CHUNK // block * block)
    low_t = np.ascontiguousarray(low.T)
    buf = np.empty((16, step), dtype=np.float64)
    out = np.zeros((-(-n // block), VALUE_LIMBS), dtype=np.int64)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        m = -(-(hi - lo) // block)
        chunk = buf[:, : m * block]
        chunk[:, : hi - lo] = limbs[:, lo:hi]
        chunk[:, hi - lo :] = 0
        # one 2-D product: row (a, j) is limb a of block j's coefficients
        inner = (chunk.reshape(16 * m, block) @ low_t).reshape(16, m, 16)  # [a, j, b]
        diag = np.zeros((m, 31), dtype=np.float64)
        for a in range(16):
            diag[:, a : a + 16] += inner[a]
        carry = np.zeros(m, dtype=np.int64)
        vals = out[lo // block : lo // block + m]
        for t in range(VALUE_LIMBS):
            total = carry + (diag[:, t].astype(np.int64) if t < 31 else 0)
            vals[:, t] = total & 0xFFFF
            carry = total >> 16
    return out


def mont_eval(limbs: np.ndarray, tables: tuple[np.ndarray, np.ndarray]) -> int:
    """p(x) mod r for the [16, n] Montgomery limbs ``limbs`` (any integer
    dtype) against ``power_tables(x, >= n)``."""
    low, high = tables
    if low.shape[1] > 1 << 17 or -(-limbs.shape[1] // low.shape[1]) > 1 << 21:
        raise ValueError("blocks too wide or too many for exact float64 sums")
    values = block_values(limbs, low).astype(np.float64)  # [blocks, 34]
    outer = values.T @ high[:, : values.shape[0]].T  # [34, 16]
    total = 0
    for t in range(VALUE_LIMBS):
        for u in range(16):
            total += int(outer[t, u]) << (16 * (t + u))
    return total % R * MONT_R_INV % R


def commitment(limbs: np.ndarray, tables: tuple[np.ndarray, np.ndarray]):
    """The expected commitment [p(tau)]G (Jacobian)."""
    return g1.mul(mont_eval(limbs, tables), g1.GENERATOR)
