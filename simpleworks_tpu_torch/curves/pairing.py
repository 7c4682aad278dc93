"""BLS12-377 ate pairing (verifier-side; used only by KZG check —
SURVEY.md §2.3 and §3.3 'the only pairing use in the system').

Straightforward, host-exact implementation:

* untwist G2 points into Fq12 (D-twist: (x, y) ↦ (x·w², y·w³), w² = v)
* Miller loop over the BLS parameter X = 0x8508c00000000001 with affine
  line evaluations in Fq12
* final exponentiation: easy part (q⁶−1)(q²+1), then the hard part as a
  single big-exponent power f^((q⁴−q²+1)/r) — mathematically exact, not
  the optimized addition-chain (verifier-side cost is non-critical here).
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.bls12_377 import FQ_MODULUS, FR_MODULUS, X as BLS_X
from .bls12_377 import G1Point, G2Point
from .fq_tower import Fq2, Fq6, Fq12

Q = FQ_MODULUS
R = FR_MODULUS


def _fq12_from_fq2(c: Fq2, v_power: int, w_power: int) -> Fq12:
    """c · v^v_power · w^w_power as an Fq12 element (w_power in {0,1})."""
    coeffs0 = [Fq2.zero()] * 3
    coeffs1 = [Fq2.zero()] * 3
    if w_power == 0:
        coeffs0[v_power] = c
    else:
        coeffs1[v_power] = c
    return Fq12(Fq6(*coeffs0), Fq6(*coeffs1))


def _fq12_scalar(c: int) -> Fq12:
    return _fq12_from_fq2(Fq2(c, 0), 0, 0)


def _untwist(q: G2Point) -> tuple[Fq12, Fq12]:
    """(x', y') on the twist ↦ (x'·w², y'·w³) = (x'·v, y'·v·w) in Fq12."""
    x, y = q.to_affine()
    qx = _fq12_from_fq2(x, 1, 0)   # w² = v
    qy = _fq12_from_fq2(y, 1, 1)   # w³ = v·w
    return qx, qy


def miller_loop(p: G1Point, q: G2Point) -> Fq12:
    if p.is_identity() or q.is_identity():
        return Fq12.one()
    px, py = p.to_affine()
    pxf, pyf = _fq12_scalar(px), _fq12_scalar(py)
    qx, qy = _untwist(q)

    f = Fq12.one()
    tx, ty = qx, qy
    bits = bin(BLS_X)[3:]  # skip the MSB
    for bit in bits:
        # line through T, T (tangent): lambda = 3 tx^2 / (2 ty)
        lam = tx.square() * _fq12_scalar(3) * (ty * _fq12_scalar(2)).inverse()
        line = pyf - ty - lam * (pxf - tx)
        f = f.square() * line
        # T = 2T
        x3 = lam.square() - tx - tx
        y3 = lam * (tx - x3) - ty
        tx, ty = x3, y3
        if bit == "1":
            # line through T, Q
            lam = (qy - ty) * (qx - tx).inverse()
            line = pyf - ty - lam * (pxf - tx)
            f = f * line
            x3 = lam.square() - tx - qx
            y3 = lam * (tx - x3) - ty
            tx, ty = x3, y3
    return f


@lru_cache(maxsize=None)
def _hard_exponent() -> int:
    e = (Q**4 - Q**2 + 1) // R
    assert (Q**4 - Q**2 + 1) % R == 0
    return e


@lru_cache(maxsize=None)
def _hard_exp_digits() -> tuple[int, ...]:
    """Base-q digits of the hard exponent: e = Σ λ_i·q^i (λ_i < q).
    f^(λ·q^i) = frobenius^i(f)^λ, so the ~4500-bit single power becomes a
    4-exponent simultaneous exponentiation of ~377-bit digits."""
    e = _hard_exponent()
    digits = []
    while e:
        digits.append(e % Q)
        e //= Q
    return tuple(digits)


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((q^6 - 1)(q^2 + 1))
    f1 = f.conjugate() * f.inverse()          # f^(q^6 - 1)
    f2 = f1.frobenius_map(2) * f1             # ^(q^2 + 1)
    # hard part: Π_i frob^i(f2)^λ_i via Shamir's trick (shared squarings:
    # ~377 squarings + ≤377 mults vs ~4500+2250 for the naive big power)
    digits = _hard_exp_digits()
    k = len(digits)
    bases = [f2 if i == 0 else f2.frobenius_map(i) for i in range(k)]
    table = [Fq12.one()] * (1 << k)
    for s in range(1, 1 << k):
        low = s & (-s)
        table[s] = table[s ^ low] * bases[low.bit_length() - 1]
    result = Fq12.one()
    for bit in range(max(d.bit_length() for d in digits) - 1, -1, -1):
        result = result.square()
        s = 0
        for i, d in enumerate(digits):
            s |= ((d >> bit) & 1) << i
        if s:
            result = result * table[s]
    return result


def pairing(p: G1Point, q: G2Point) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: list[tuple[G1Point, G2Point]]) -> Fq12:
    """∏ e(P_i, Q_i) with a single shared final exponentiation."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)
