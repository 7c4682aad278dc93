"""BLS12-377 G1 and G2 groups (short Weierstrass, host-exact).

SURVEY.md §2.3 'Curves': G1 carries the KZG SRS and all commitment MSMs; G2
appears only in verification keys and the pairing check.

G1: y² = x³ + 1 over Fq.  Generator from the standard BLS12-377 spec,
verified on-curve and of order r in tests.

G2: y² = x³ + b2 over Fq2 with b2 = -u/5 (D-type twist: b/ξ, ξ = u).
The G2 generator is derived deterministically (first valid x, cofactor
cleared) — semantics identical to any fixed generator; byte-vectors differ
from arkworks' pinned constants (documented divergence, as for the Edwards
generator).

Jacobian coordinates for arithmetic; Python ints / Fq2 elements.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.bls12_377 import FQ_MODULUS, FR_MODULUS, X as BLS_X
from .fq_sqrt import fq_sqrt
from .fq_tower import Fq2

Q = FQ_MODULUS
R = FR_MODULUS

G1_B = 1
#: b2 = b/xi = 1/u = -u/5
G2_B = Fq2(0, (-pow(5, -1, Q)) % Q)

#: standard BLS12-377 G1 generator (verified on-curve + order r in tests)
G1_GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GENERATOR_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030

#: cofactors
G1_COFACTOR = (BLS_X - 1) ** 2 // 3
G2_COFACTOR = (BLS_X**8 - 4 * BLS_X**7 + 5 * BLS_X**6 - 4 * BLS_X**4 + 6 * BLS_X**3 - 4 * BLS_X**2 - 4 * BLS_X + 13) // 9


class G1Point:
    """Jacobian (X, Y, Z); identity encoded as Z = 0."""

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X: int, Y: int, Z: int = 1):
        self.X, self.Y, self.Z = X % Q, Y % Q, Z % Q

    @staticmethod
    def identity() -> "G1Point":
        return G1Point(1, 1, 0)

    @staticmethod
    def generator() -> "G1Point":
        return G1Point(G1_GENERATOR_X, G1_GENERATOR_Y)

    def is_identity(self) -> bool:
        return self.Z == 0

    def to_affine(self) -> tuple[int, int]:
        if self.Z == 0:
            raise ValueError("identity has no affine coords")
        zinv = pow(self.Z, -1, Q)
        z2 = zinv * zinv % Q
        return (self.X * z2 % Q, self.Y * z2 % Q * zinv % Q)

    def __eq__(self, other):
        if self.Z == 0 or other.Z == 0:
            return self.Z == other.Z
        z1sq, z2sq = self.Z * self.Z % Q, other.Z * other.Z % Q
        if self.X * z2sq % Q != other.X * z1sq % Q:
            return False
        return self.Y * z2sq % Q * other.Z % Q == other.Y * z1sq % Q * self.Z % Q

    def __hash__(self):
        return hash(self.to_affine() if self.Z else None)

    def double(self) -> "G1Point":
        if self.Z == 0 or self.Y == 0:
            return G1Point.identity()
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % Q
        B = Y1 * Y1 % Q
        C = B * B % Q
        D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q
        E = 3 * A % Q
        F = E * E % Q
        X3 = (F - 2 * D) % Q
        Y3 = (E * (D - X3) - 8 * C) % Q
        Z3 = 2 * Y1 * Z1 % Q
        return G1Point(X3, Y3, Z3)

    def add(self, other: "G1Point") -> "G1Point":
        if self.Z == 0:
            return other
        if other.Z == 0:
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1 * Z1 % Q
        Z2Z2 = Z2 * Z2 % Q
        U1 = X1 * Z2Z2 % Q
        U2 = X2 * Z1Z1 % Q
        S1 = Y1 * Z2 % Q * Z2Z2 % Q
        S2 = Y2 * Z1 % Q * Z1Z1 % Q
        if U1 == U2:
            if S1 != S2:
                return G1Point.identity()
            return self.double()
        H = (U2 - U1) % Q
        I = 4 * H * H % Q
        J = H * I % Q
        rr = 2 * (S2 - S1) % Q
        V = U1 * I % Q
        X3 = (rr * rr - J - 2 * V) % Q
        Y3 = (rr * (V - X3) - 2 * S1 * J) % Q
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q * H % Q
        return G1Point(X3, Y3, Z3)

    def neg(self) -> "G1Point":
        return G1Point(self.X, -self.Y, self.Z)

    def scalar_mul(self, k: int) -> "G1Point":
        k = int(k) % R
        result = G1Point.identity()
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result

    # -- serde (arkworks SW conventions: x + 2-bit flags in top bits) --------

    def serialize_compressed(self) -> bytes:
        from ..fields.bls12_377 import Fq

        if self.is_identity():
            out = bytearray(Fq(0).serialize())
            out[-1] |= 0x40  # infinity flag
            return bytes(out)
        x, y = self.to_affine()
        y_is_greatest = y > (Q - y) % Q
        return Fq(x).serialize_with_flags(0x80 if y_is_greatest else 0, flag_bits=2)

    @staticmethod
    def deserialize_compressed(data: bytes) -> "G1Point":
        from ..fields.bls12_377 import Fq

        buf = bytearray(data[: Fq.PARAMS.byte_size])
        flags = buf[-1] & 0xC0
        buf[-1] &= 0x3F
        if flags & 0x40:
            return G1Point.identity()
        x = int.from_bytes(bytes(buf), "little")
        y2 = (x * x % Q * x + G1_B) % Q
        y = fq_sqrt(y2)
        if y is None:
            raise ValueError("invalid G1 compressed point")
        neg = (Q - y) % Q
        big, small = (y, neg) if y > neg else (neg, y)
        return G1Point(x, big if flags & 0x80 else small)


class G2Point:
    """Jacobian over Fq2; identity encoded as Z = 0."""

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X: Fq2, Y: Fq2, Z: Fq2 | None = None):
        self.X, self.Y = X, Y
        self.Z = Z if Z is not None else Fq2.one()

    @staticmethod
    def identity() -> "G2Point":
        return G2Point(Fq2.one(), Fq2.one(), Fq2.zero())

    def is_identity(self) -> bool:
        return self.Z.is_zero()

    def to_affine(self) -> tuple[Fq2, Fq2]:
        zinv = self.Z.inverse()
        z2 = zinv * zinv
        return (self.X * z2, self.Y * z2 * zinv)

    def __eq__(self, other):
        if self.is_identity() or other.is_identity():
            return self.is_identity() == other.is_identity()
        z1sq, z2sq = self.Z.square(), other.Z.square()
        if self.X * z2sq != other.X * z1sq:
            return False
        return self.Y * z2sq * other.Z == other.Y * z1sq * self.Z

    def double(self) -> "G2Point":
        if self.is_identity() or self.Y.is_zero():
            return G2Point.identity()
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1.square()
        B = Y1.square()
        C = B.square()
        D = ((X1 + B).square() - A - C) * 2
        E = A * 3
        F = E.square()
        X3 = F - D * 2
        Y3 = E * (D - X3) - C * 8
        Z3 = Y1 * Z1 * 2
        return G2Point(X3, Y3, Z3)

    def add(self, other: "G2Point") -> "G2Point":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 != S2:
                return G2Point.identity()
            return self.double()
        H = U2 - U1
        I = (H + H).square()
        J = H * I
        rr = (S2 - S1) * 2
        V = U1 * I
        X3 = rr.square() - J - V * 2
        Y3 = rr * (V - X3) - S1 * J * 2
        Z3 = ((Z1 + Z2).square() - Z1Z1 - Z2Z2) * H
        return G2Point(X3, Y3, Z3)

    def neg(self) -> "G2Point":
        return G2Point(self.X, -self.Y, self.Z)

    def scalar_mul(self, k: int) -> "G2Point":
        return self.scalar_mul_unreduced(int(k) % R)

    # -- serde: x (two Fq limbs LE) with y-sign + infinity flags ---------------

    def serialize_compressed(self) -> bytes:
        from ..fields.bls12_377 import Fq

        if self.is_identity():
            out = bytearray(Fq(0).serialize() + Fq(0).serialize())
            out[-1] |= 0x40
            return bytes(out)
        x, y = self.to_affine()
        # y "greatest" by lexicographic (c1, c0) comparison
        ny = -y
        y_is_greatest = (y.c1, y.c0) > (ny.c1, ny.c0)
        out = bytearray(Fq(x.c0).serialize() + Fq(x.c1).serialize())
        if y_is_greatest:
            out[-1] |= 0x80
        return bytes(out)

    @staticmethod
    def deserialize_compressed(data: bytes) -> "G2Point":
        from ..fields.bls12_377 import Fq

        size = Fq.PARAMS.byte_size
        buf = bytearray(data[: 2 * size])
        flags = buf[-1] & 0xC0
        buf[-1] &= 0x3F
        if flags & 0x40:
            return G2Point.identity()
        c0 = int.from_bytes(bytes(buf[:size]), "little")
        c1 = int.from_bytes(bytes(buf[size:]), "little")
        x = Fq2(c0, c1)
        y2 = x * x * x + G2_B
        y = y2.sqrt()
        if y is None:
            raise ValueError("invalid G2 compressed point")
        ny = -y
        greatest = y if (y.c1, y.c0) > (ny.c1, ny.c0) else ny
        smallest = ny if greatest == y else y
        return G2Point(x, greatest if flags & 0x80 else smallest)

    @staticmethod
    @lru_cache(maxsize=None)
    def generator() -> "G2Point":
        """Deterministically derived prime-order generator."""
        x_c0 = 0
        while True:
            x_c0 += 1
            for x in (Fq2(x_c0, 0), Fq2(0, x_c0), Fq2(x_c0, 1)):
                y2 = x * x * x + G2_B
                y = y2.sqrt()
                if y is None:
                    continue
                p = G2Point(x, y)
                g = p.scalar_mul_unreduced(G2_COFACTOR)
                if not g.is_identity():
                    return g

    def scalar_mul_unreduced(self, k: int) -> "G2Point":
        result = G2Point.identity()
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result
