"""Dense univariate polynomials over Fr, backed by a device FrVec.

Port of ``simpleworks_tpu/poly/dense.py``: coefficients are a ``[16, N]``
Montgomery tensor on one device (trailing zeros trimmed, as the reference
trims), and every op runs there.  Products route through domain NTTs beyond
a schoolbook cutoff.
"""

from __future__ import annotations

from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS
from ..fields.frvec import FrVec
from .domain import Radix2Domain

P = FR_MODULUS

_SCHOOLBOOK_CUTOFF = 64


class DensePoly:
    __slots__ = ("vec",)

    def __init__(self, coeffs, device=None):
        """``coeffs``: a list of ints (put on ``device``), or an FrVec
        (trimmed either way; one small fetch)."""
        v = coeffs if isinstance(coeffs, FrVec) else FrVec.from_ints(list(coeffs), device)
        n = v.nonzero_length()
        self.vec = v if n == len(v) else v[:n]

    @property
    def device(self):
        return self.vec.device

    @property
    def coeffs(self) -> list[int]:
        """Standard-form coefficient list (fetches)."""
        return self.vec.to_ints()

    @staticmethod
    def zero(device=None) -> "DensePoly":
        return DensePoly(FrVec.zeros(0, device))

    @staticmethod
    def constant(c: int, device=None) -> "DensePoly":
        return DensePoly([c], device)

    def degree(self) -> int:
        return len(self.vec) - 1

    def is_zero(self) -> bool:
        return len(self.vec) == 0

    def evaluate(self, point: int) -> int:
        return dvec.scalar_to_int(dvec.evaluate(self.vec.t, point % P))

    def __add__(self, other: "DensePoly") -> "DensePoly":
        n = max(len(self.vec), len(other.vec))
        return DensePoly(self.vec.pad_to(n) + other.vec.pad_to(n))

    def __sub__(self, other: "DensePoly") -> "DensePoly":
        n = max(len(self.vec), len(other.vec))
        return DensePoly(self.vec.pad_to(n) - other.vec.pad_to(n))

    def scale(self, s: int) -> "DensePoly":
        return DensePoly(self.vec.scale(s % P))

    def __mul__(self, other: "DensePoly") -> "DensePoly":
        if self.is_zero() or other.is_zero():
            return DensePoly.zero(self.device)
        la, lb = len(self.vec), len(other.vec)
        if min(la, lb) <= _SCHOOLBOOK_CUTOFF and max(la, lb) <= 4 * _SCHOOLBOOK_CUTOFF:
            a, b = self.vec.to_ints(), other.vec.to_ints()
            out = [0] * (la + lb - 1)
            for i, x in enumerate(a):
                if x:
                    for j, y in enumerate(b):
                        out[i + j] = (out[i + j] + x * y) % P
            return DensePoly(out, self.device)
        domain = Radix2Domain.new_for(la + lb - 1)
        return DensePoly(domain.ifft_vec(domain.fft_vec(self.vec) * domain.fft_vec(other.vec)))

    def mul_by_vanishing(self, domain: Radix2Domain) -> "DensePoly":
        """p(X)·(X^n − 1)."""
        n = domain.size
        hi = self.vec.pad_to(len(self.vec) + n)
        shifted = FrVec.concat([FrVec.zeros(n, self.device), self.vec])
        return DensePoly(shifted - hi)

    def divide_by_linear(self, z: int) -> tuple["DensePoly", int]:
        """(quotient, remainder) of division by (X − z)."""
        if self.is_zero():
            return DensePoly.zero(self.device), 0
        quot, rem = dvec.divide_by_linear(self.vec.t, z % P)
        return DensePoly(FrVec(quot)), dvec.scalar_to_int(rem)

    @staticmethod
    def from_evals(domain: Radix2Domain, evals: FrVec) -> "DensePoly":
        return DensePoly(domain.ifft_vec(evals.pad_to(domain.size)))

    def __repr__(self):
        return f"DensePoly(deg={self.degree()})"
