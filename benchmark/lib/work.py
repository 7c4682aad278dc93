"""The yardstick of the MSM's roofline: operations and bytes counted from the
shape of the work alone, and the peaks they are held against.

Frozen copies of ``chip_smoke.product_ops`` and ``g1_ops`` (the counting
rule the repository's kernel bounds use), and a least count of bucket
Pippenger that does not read the program's own window width or schedule, so
that a change of window inside the program cannot move the yardstick.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM: device memory rate (data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: streaming multiprocessors of the H100 SXM
SMS = 132
#: 32-bit integer multiply-adds an SM issues a clock: the CUDA C Programming
#: Guide's arithmetic-throughput table, compute capability 9.0 (64 results a
#: clock an SM for 32-bit integer multiply and multiply-add).  Published and
#: not measured here; the card's power limit is printed beside every run.
IMAD_PER_SM_CLOCK = 64
#: the H100 SXM's maximum SM clock, MHz: used where nvidia-smi cannot say
DEFAULT_SM_CLOCK_MHZ = 1980.0

#: bits of a BLS12-377 scalar (r < 2^253)
SCALAR_BITS = 253
#: words of an Fq element on the card (377 bits in 32-bit words)
FQ_WORDS = 12
#: bytes of an affine G1 base (two 48-byte coordinates) and of a scalar
POINT_BYTES = 96
SCALAR_BYTES = 32
#: Fq products of one point add (multiplies, squarings): the mixed add
#: (madd-2007-bl) and the general add (add-2007-bl)
MIXED_ADD_PRODUCTS = (7, 4)
ADD_PRODUCTS = (11, 5)


def product_ops(words: int, multiplies: int, squarings: int) -> int:
    """32-bit multiply-adds of Montgomery products of ``words``-word values:
    2 N^2 a multiply (N^2 for a*b, N^2 for m*p) and N(N+1)/2 + N^2 a
    squaring (each cross product a_i a_j once), N = ``words``."""
    square = words * (words + 1) // 2 + words * words
    return multiplies * 2 * words * words + squarings * square


def g1_ops(products: tuple[int, int], lanes: int) -> int:
    """32-bit multiply-adds of the Fq products of ``lanes`` point adds that
    each run ``products`` = (multiplies, squarings)."""
    return lanes * product_ops(FQ_WORDS, *products)


def pippenger_ops(n: int, c: int) -> int:
    """Multiply-adds of bucket Pippenger over ``n`` bases at window width
    ``c``: ceil(253/c) windows, each n mixed adds into its buckets and
    2^(c+1) adds to sum them."""
    windows = math.ceil(SCALAR_BITS / c)
    return (g1_ops(MIXED_ADD_PRODUCTS, windows * n)
            + g1_ops(ADD_PRODUCTS, windows * (1 << (c + 1))))


def least_pippenger(n: int) -> tuple[int, int]:
    """(c, operations) of the smallest Pippenger count over every window
    width c from 1 to 32."""
    return min(((c, pippenger_ops(n, c)) for c in range(1, 33)), key=lambda t: (t[1], t[0]))


def msm_bytes(n: int) -> int:
    """Each base read once at 96 bytes and each scalar at 32."""
    return n * (POINT_BYTES + SCALAR_BYTES)


def msm_least_ms(n: int, clock_mhz: float) -> tuple[float, str]:
    """The least time of an MSM of ``n`` bases on one card, ms, and which
    bound sets it: the larger of the bytes over the memory rate and the
    least operations over the multiply-add rate at ``clock_mhz``."""
    t_bytes = msm_bytes(n) / HBM_BYTES_PER_S * 1e3
    t_ops = least_pippenger(n)[1] / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
