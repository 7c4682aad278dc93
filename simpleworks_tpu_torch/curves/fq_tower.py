"""BLS12-377 extension-field tower: Fq2 = Fq[u]/(u²+5), Fq6 = Fq2[v]/(v³-u),
Fq12 = Fq6[w]/(w²-v) — the arithmetic under the pairing (verifier-side only;
SURVEY.md §2.3 'Curves': pairing needed by KZG verify).

Host-exact implementation (Python ints); performance non-critical.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.bls12_377 import FQ_MODULUS

Q = FQ_MODULUS

# Fq2 nonresidue: u^2 = -5
FQ2_NONRESIDUE = Q - 5


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0, self.c1 = c0 % Q, c1 % Q

    @staticmethod
    def zero():
        return Fq2(0)

    @staticmethod
    def one():
        return Fq2(1)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a0b0 = self.c0 * o.c0 % Q
        a1b1 = self.c1 * o.c1 % Q
        return Fq2(
            a0b0 + FQ2_NONRESIDUE * a1b1,
            (self.c0 + self.c1) * (o.c0 + o.c1) - a0b0 - a1b1,
        )

    def square(self):
        return self * self

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def inverse(self):
        # (c0 - c1 u) / (c0^2 + 5 c1^2)
        norm = (self.c0 * self.c0 - FQ2_NONRESIDUE * self.c1 * self.c1) % Q
        ninv = pow(norm, -1, Q)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def mul_by_nonresidue(self):
        """multiply by xi = u:  (c0 + c1 u)·u = -5 c1 + c0 u."""
        return Fq2(FQ2_NONRESIDUE * self.c1, self.c0)

    def pow(self, e: int):
        result, base = Fq2.one(), self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self):
        """a ↦ a^q: conjugation (since -5 is a nonresidue)."""
        return self.conjugate()

    def sqrt(self):
        """Square root in Fq2 (complex method); None if non-residue."""
        if self.is_zero():
            return self
        if self.c1 == 0:
            from .fq_sqrt import fq_sqrt

            r = fq_sqrt(self.c0)
            if r is not None:
                return Fq2(r, 0)
            # sqrt(c0) = t·u with t = sqrt(-c0/5)
            t = fq_sqrt(self.c0 * pow(FQ2_NONRESIDUE, -1, Q) % Q)
            if t is None:
                return None
            return Fq2(0, t)
        from .fq_sqrt import fq_sqrt

        # alpha = norm = c0^2 + 5 c1^2 must be a QR in Fq
        alpha = (self.c0 * self.c0 - FQ2_NONRESIDUE * self.c1 * self.c1) % Q
        n = fq_sqrt(alpha)
        if n is None:
            return None
        # x0 = sqrt((c0 + n)/2) (try both signs of n)
        inv2 = pow(2, -1, Q)
        for nn in (n, Q - n):
            x0sq = (self.c0 + nn) * inv2 % Q
            x0 = fq_sqrt(x0sq)
            if x0 is None or x0 == 0:
                continue
            x1 = self.c1 * inv2 % Q * pow(x0, -1, Q) % Q
            cand = Fq2(x0, x1)
            if cand.square() == self:
                return cand
        return None

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


class Fq6:
    """c0 + c1 v + c2 v², v³ = u."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """multiply by v: (c0, c1, c2) -> (u·c2, c0, c1)."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inverse(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_nonresidue()
        t1 = (c.square()).mul_by_nonresidue() - a * b
        t2 = b.square() - a * c
        t = ((c * t1 + b * t2).mul_by_nonresidue() + a * t0).inverse()
        return Fq6(t0 * t, t1 * t, t2 * t)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"


class Fq12:
    """c0 + c1 w, w² = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0b0 = self.c0 * o.c0
        a1b1 = self.c1 * o.c1
        c0 = a0b0 + a1b1.mul_by_nonresidue()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - a0b0 - a1b1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conjugate(self):
        """a ↦ a^(q^6): negate the w part (unitary inverse)."""
        return Fq12(self.c0, -self.c1)

    def inverse(self):
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inverse()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        result, base = Fq12.one(), self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius_map(self, power: int):
        """a ↦ a^(q^power) via coefficient-wise Frobenius + twist constants."""
        f = self
        for _ in range(power % 12):
            f = f._frobenius_once()
        return f

    def _frobenius_once(self):
        g1, g2 = _frobenius_coeffs()
        # apply Frobenius to each Fq2 coefficient, then multiply by v/w powers
        c0 = Fq6(
            self.c0.c0.frobenius(),
            self.c0.c1.frobenius() * g1[1],
            self.c0.c2.frobenius() * g1[2],
        )
        c1 = Fq6(
            self.c1.c0.frobenius() * g2[0],
            self.c1.c1.frobenius() * g2[1],
            self.c1.c2.frobenius() * g2[2],
        )
        return Fq12(c0, c1)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"


@lru_cache(maxsize=None)
def _frobenius_coeffs():
    """gamma1[i] = xi^(i(q-1)/3) for the v^i coefficients;
    gamma2[i] = xi^((2i+1)(q-1)/6) for the w·v^i coefficients."""
    xi = Fq2(0, 1)
    g1 = [Fq2.one(), xi.pow((Q - 1) // 3), xi.pow(2 * (Q - 1) // 3)]
    g2 = [xi.pow((Q - 1) // 6), xi.pow((Q - 1) // 2), xi.pow(5 * (Q - 1) // 6)]
    return g1, g2
