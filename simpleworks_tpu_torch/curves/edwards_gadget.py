"""In-circuit ed-on-bls12-377 point arithmetic (the ``EdwardsVar`` slot).

Replaces ``ark_ed_on_bls12_377::constraints::EdwardsVar``
(reference ``src/merkle_tree/common.rs:9``, Schnorr verify gadget
``src/schnorr_signature/schnorr_signature_verify_gadget.rs:47-53``).

Affine coordinates with the complete twisted-Edwards addition law
(a = -1, d nonsquare ⇒ denominators never vanish):

  x3 = (x1·y2 + y1·x2) / (1 + d·x1·x2·y1·y2)
  y3 = (y1·y2 - a·x1·x2) / (1 - d·x1·x2·y1·y2)

Port of ``simpleworks_tpu/curves/edwards_gadget.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..gadgets.boolean import Boolean
from ..gadgets.field_var import FieldVar
from .edwards import COEFF_A, COEFF_D, EdwardsPoint


class EdwardsVar:
    __slots__ = ("cs", "x", "y")

    def __init__(self, cs, x: FieldVar, y: FieldVar):
        self.cs = cs
        self.x = x
        self.y = y

    # -- constructors ------------------------------------------------------

    @staticmethod
    def _alloc(cs, point: EdwardsPoint, mode: str) -> "EdwardsVar":
        ax, ay = point.to_affine()
        maker = FieldVar.new_witness if mode == "witness" else FieldVar.new_input
        x, y = maker(cs, ax), maker(cs, ay)
        # curve membership: a·x² + y² = 1 + d·x²·y²
        x2 = x.square()
        y2 = y.square()
        lhs = x2.mul_by_constant(COEFF_A).add(y2)
        rhs = FieldVar.constant(cs, 1).add(x2.mul(y2).mul_by_constant(COEFF_D))
        lhs.enforce_equal(rhs)
        return EdwardsVar(cs, x, y)

    @staticmethod
    def new_witness(cs, point: EdwardsPoint) -> "EdwardsVar":
        return EdwardsVar._alloc(cs, point, "witness")

    @staticmethod
    def new_input(cs, point: EdwardsPoint) -> "EdwardsVar":
        return EdwardsVar._alloc(cs, point, "input")

    @staticmethod
    def constant(cs, point: EdwardsPoint) -> "EdwardsVar":
        ax, ay = point.to_affine()
        return EdwardsVar(cs, FieldVar.constant(cs, ax), FieldVar.constant(cs, ay))

    @staticmethod
    def identity(cs) -> "EdwardsVar":
        return EdwardsVar(cs, FieldVar.constant(cs, 0), FieldVar.constant(cs, 1))

    # -- introspection --------------------------------------------------------

    def value(self) -> EdwardsPoint:
        return EdwardsPoint.from_affine(self.x.value(), self.y.value())

    # -- group law ---------------------------------------------------------------

    def add(self, other: "EdwardsVar") -> "EdwardsVar":
        cs = self.cs
        x1x2 = self.x.mul(other.x)
        y1y2 = self.y.mul(other.y)
        x1y2 = self.x.mul(other.y)
        y1x2 = self.y.mul(other.x)
        d_prod = x1x2.mul(y1y2).mul_by_constant(COEFF_D)
        one = FieldVar.constant(cs, 1)
        x3 = x1y2.add(y1x2).mul(one.add(d_prod).inverse())
        y3 = y1y2.sub(x1x2.mul_by_constant(COEFF_A)).mul(one.sub(d_prod).inverse())
        return EdwardsVar(cs, x3, y3)

    def double(self) -> "EdwardsVar":
        return self.add(self)

    def neg(self) -> "EdwardsVar":
        return EdwardsVar(self.cs, self.x.neg(), self.y)

    @staticmethod
    def conditionally_select(cond: Boolean, t: "EdwardsVar", f: "EdwardsVar") -> "EdwardsVar":
        return EdwardsVar(
            t.cs,
            FieldVar.conditionally_select(cond, t.x, f.x),
            FieldVar.conditionally_select(cond, t.y, f.y),
        )

    def add_conditionally(self, cond: Boolean, other: "EdwardsVar") -> "EdwardsVar":
        return EdwardsVar.conditionally_select(cond, self.add(other), self)

    def scalar_mul_le(self, scalar_bits_le: list[Boolean]) -> "EdwardsVar":
        """Variable-base scalar mul from LE scalar bits (the hot gadget of
        the Schnorr circuit; reference schnorr_signature_verify_gadget.rs:47-52)."""
        cs = self.cs
        acc = EdwardsVar.identity(cs)
        base = self
        for i, bit in enumerate(scalar_bits_le):
            acc = acc.add_conditionally(bit, base)
            if i + 1 < len(scalar_bits_le):
                base = base.double()
        return acc

    # -- equality ------------------------------------------------------------------

    def enforce_equal(self, other: "EdwardsVar") -> None:
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)

    def is_eq(self, other: "EdwardsVar") -> Boolean:
        return self.x.is_eq(other.x).and_(self.y.is_eq(other.y))

    def to_bytes(self) -> list:
        """x || y as byte gadgets (matches native ``ToBytes``: 32 + 32)."""
        return self.x.to_bytes() + self.y.to_bytes()
