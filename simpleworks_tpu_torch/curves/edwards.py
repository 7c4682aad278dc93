"""ed-on-bls12-377 twisted Edwards curve (host exact arithmetic).

The curve underlying Pedersen hashing and Schnorr signatures in the reference
(``Cargo.toml:17`` ark-ed-on-bls12-377; SURVEY.md §2.3 'Curves').

Curve: a·x² + y² = 1 + d·x²·y² over Fq_ed = BLS12-377 Fr, with
a = -1, d = 3021, cofactor 4, prime subgroup order ``FR_ED_MODULUS``.

Arithmetic uses extended twisted Edwards coordinates (X:Y:Z:T with T=XY/Z)
and the complete a=-1 HWCD formulas, so no special cases are needed.

NOTE on the generator: arkworks pins specific affine generator constants; we
derive ours deterministically (smallest y with a valid x, cofactor-cleared,
verified to have order r_ed).  Semantics are identical; byte-level vectors
involving the generator differ from arkworks (documented divergence).

Port of ``simpleworks_tpu/curves/edwards.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..fields.bls12_377 import Fr, FrEd

# Base field of the Edwards curve IS BLS12-377 Fr (the key identity the
# reference relies on: src/gadgets/mod.rs:29).
Fq_ed = Fr

COEFF_A = Fq_ed.PARAMS.modulus - 1  # a = -1
COEFF_D = 3021
COFACTOR = 4
SUBGROUP_ORDER = FrEd.PARAMS.modulus

_P = Fq_ed.PARAMS.modulus


class EdwardsPoint:
    """Extended-coordinate point; normalized lazily."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % _P, Y % _P, Z % _P, T % _P

    # -- constructors ------------------------------------------------------

    @staticmethod
    def identity() -> "EdwardsPoint":
        return EdwardsPoint(0, 1, 1, 0)

    @staticmethod
    def from_affine(x: int, y: int) -> "EdwardsPoint":
        return EdwardsPoint(x, y, 1, x * y % _P)

    @staticmethod
    def is_on_curve_affine(x: int, y: int) -> bool:
        lhs = (COEFF_A * x * x + y * y) % _P
        rhs = (1 + COEFF_D * x % _P * x % _P * y % _P * y) % _P
        return lhs == rhs

    @staticmethod
    def get_point_from_y(y: int, greatest: bool):
        """x from y (arkworks ``get_point_from_y``): x² = (y²-1)/(d·y²-a);
        ``greatest`` picks the larger root by integer comparison.
        Returns None for non-residues."""
        num = (y * y - 1) % _P
        den = (COEFF_D * y % _P * y - COEFF_A) % _P
        if den == 0:
            return None
        x2 = Fq_ed(num) * Fq_ed(den).inverse()
        x = x2.sqrt()
        if x is None:
            return None
        xv = x.value
        neg = (_P - xv) % _P
        big, small = (xv, neg) if xv > neg else (neg, xv)
        return EdwardsPoint.from_affine(big if greatest else small, y)

    @staticmethod
    def rand(rng) -> "EdwardsPoint":
        """arkworks TE ``UniformRand``: random y + greatest flag, rejecting
        non-curve y, then cofactor-cleared."""
        while True:
            y = Fq_ed.rand(rng).value
            greatest = rng.gen_bool()
            p = EdwardsPoint.get_point_from_y(y, greatest)
            if p is not None:
                return p.scale_by_cofactor()

    # -- affine / comparison ---------------------------------------------------

    def to_affine(self) -> tuple[int, int]:
        if self.Z == 0:
            raise ValueError("invalid point (Z=0)")
        zinv = pow(self.Z, -1, _P)
        return (self.X * zinv % _P, self.Y * zinv % _P)

    def is_identity(self) -> bool:
        return self.X == 0 and (self.Y * pow(self.Z, -1, _P)) % _P == 1

    def __eq__(self, other):
        if not isinstance(other, EdwardsPoint):
            return NotImplemented
        # cross-multiplied comparison avoids inversions
        return (
            self.X * other.Z % _P == other.X * self.Z % _P
            and self.Y * other.Z % _P == other.Y * self.Z % _P
        )

    def __hash__(self):
        return hash(self.to_affine())

    def __repr__(self):
        x, y = self.to_affine()
        return f"EdwardsPoint({x}, {y})"

    # -- group law (HWCD complete formulas, a = -1) -------------------------------

    def add(self, other: "EdwardsPoint") -> "EdwardsPoint":
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % _P
        B = (Y1 + X1) * (Y2 + X2) % _P
        C = 2 * COEFF_D * T1 % _P * T2 % _P
        D = 2 * Z1 * Z2 % _P
        E = (B - A) % _P
        F = (D - C) % _P
        G = (D + C) % _P
        H = (B + A) % _P
        return EdwardsPoint(E * F, G * H, F * G, E * H)

    def double(self) -> "EdwardsPoint":
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % _P
        B = Y1 * Y1 % _P
        C = 2 * Z1 % _P * Z1 % _P
        D = (-A) % _P  # a = -1
        E = ((X1 + Y1) * (X1 + Y1) - A - B) % _P
        G = (D + B) % _P
        F = (G - C) % _P
        H = (D - B) % _P
        return EdwardsPoint(E * F, G * H, F * G, E * H)

    def neg(self) -> "EdwardsPoint":
        return EdwardsPoint(-self.X, self.Y, self.Z, -self.T)

    def scalar_mul(self, k: int) -> "EdwardsPoint":
        k = int(k)
        if k < 0:
            return self.neg().scalar_mul(-k)
        result = EdwardsPoint.identity()
        base = self
        while k:
            if k & 1:
                result = result.add(base)
            base = base.double()
            k >>= 1
        return result

    def scale_by_cofactor(self) -> "EdwardsPoint":
        return self.double().double()

    # -- serde (arkworks conventions) --------------------------------------------

    def to_bytes_raw(self) -> bytes:
        """``ToBytes``: x || y, each as full-limb LE bytes (32 + 32)."""
        x, y = self.to_affine()
        return Fq_ed(x).to_bytes_raw() + Fq_ed(y).to_bytes_raw()

    def serialize_compressed(self) -> bytes:
        """CanonicalSerialize: x with a y-sign flag in the top bit."""
        if self.is_identity():
            return Fq_ed(0).serialize_with_flags(0)
        x, y = self.to_affine()
        y_is_greatest = y > (_P - y) % _P
        return Fq_ed(x).serialize_with_flags(0x80 if y_is_greatest else 0)

    @staticmethod
    def deserialize_compressed(data: bytes) -> "EdwardsPoint":
        buf = bytearray(data[: Fq_ed.PARAMS.byte_size])
        flag = buf[-1] & 0x80
        buf[-1] &= 0x7F
        x = int.from_bytes(bytes(buf), "little")
        if x == 0 and flag == 0:
            return EdwardsPoint.identity()
        # y from x: y² = (1 - a·x²)/(1 - d·x²)
        num = (1 - COEFF_A * x * x) % _P
        den = (1 - COEFF_D * x % _P * x) % _P
        y2 = Fq_ed(num) * Fq_ed(den).inverse()
        y = y2.sqrt()
        if y is None:
            raise ValueError("invalid compressed point")
        yv = y.value
        neg = (_P - yv) % _P
        big, small = (yv, neg) if yv > neg else (neg, yv)
        return EdwardsPoint.from_affine(x, big if flag else small)


def _derive_generator() -> EdwardsPoint:
    """Deterministic prime-order generator: smallest y >= 2 giving a curve
    point whose cofactor-cleared image is non-identity (order checked in
    tests against SUBGROUP_ORDER)."""
    y = 2
    while True:
        p = EdwardsPoint.get_point_from_y(y, greatest=False)
        if p is not None:
            g = p.scale_by_cofactor()
            if not g.is_identity():
                return g
        y += 1


GENERATOR = _derive_generator()


def prime_subgroup_generator() -> EdwardsPoint:
    return GENERATOR
