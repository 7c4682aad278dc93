"""Field-element circuit gadget (the ``FpVar`` of this framework).

Reference binding: ``FieldGadget = FpVar<ConstraintF>``
(``src/gadgets/mod.rs:39``).  Linear operations are symbolic (carried as a
linear combination, no constraints); multiplication/inversion allocate a
witness plus one constraint, matching arkworks' cost model.

Port of ``simpleworks_tpu/gadgets/field_var.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..r1cs.constraint_system import ConstraintSystem, LinearCombination, ONE
from .boolean import Boolean


class FieldVar:
    """A field element in-circuit: value + linear combination over variables.

    ``is_const`` when the LC only touches One — mirroring arkworks'
    Constant/Var split without the enum.
    """

    __slots__ = ("cs", "lc", "_value")

    def __init__(self, cs, lc: LinearCombination, value: int):
        self.cs = cs
        self.lc = lc
        self._value = value % cs.field.PARAMS.modulus

    # -- constructors ------------------------------------------------------

    @staticmethod
    def constant(cs: ConstraintSystem, value) -> "FieldVar":
        v = int(value) % cs.field.PARAMS.modulus
        return FieldVar(cs, cs.lc((v, ONE)), v)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value) -> "FieldVar":
        v = int(value) % cs.field.PARAMS.modulus
        var = cs.new_witness_variable(v)
        return FieldVar(cs, cs.lc((1, var)), v)

    @staticmethod
    def new_input(cs: ConstraintSystem, value) -> "FieldVar":
        v = int(value) % cs.field.PARAMS.modulus
        var = cs.new_input_variable(v)
        return FieldVar(cs, cs.lc((1, var)), v)

    def value(self) -> int:
        return self._value

    def is_constant(self) -> bool:
        return all(v.kind == "one" for v in self.lc.terms)

    def is_witness(self) -> bool:
        """reference src/gadgets/field.rs:5-16."""
        return any(v.kind == "witness" for v in self.lc.terms)

    # -- arithmetic -----------------------------------------------------------

    def add(self, other: "FieldVar") -> "FieldVar":
        return FieldVar(self.cs, self.lc + other.lc, self._value + other._value)

    def sub(self, other: "FieldVar") -> "FieldVar":
        return FieldVar(self.cs, self.lc - other.lc, self._value - other._value)

    def neg(self) -> "FieldVar":
        p = self.cs.field.PARAMS.modulus
        return FieldVar(self.cs, self.lc * (p - 1), p - self._value)

    def mul(self, other: "FieldVar") -> "FieldVar":
        cs = self.cs
        p = cs.field.PARAMS.modulus
        if self.is_constant():
            return other.mul_by_constant(self._value)
        if other.is_constant():
            return self.mul_by_constant(other._value)
        out_val = self._value * other._value % p
        var = cs.new_witness_variable(out_val)
        out_lc = cs.lc((1, var))
        cs.enforce_constraint(self.lc, other.lc, out_lc)
        return FieldVar(cs, out_lc, out_val)

    def mul_by_constant(self, c) -> "FieldVar":
        c = int(c) % self.cs.field.PARAMS.modulus
        return FieldVar(self.cs, self.lc * c, self._value * c)

    def square(self) -> "FieldVar":
        return self.mul(self)

    def pow_by_constant(self, exponent: int) -> "FieldVar":
        """Square-and-multiply; exponent is a host constant (e.g. Poseidon α=17)."""
        assert exponent >= 1
        result = None
        base = self
        e = exponent
        while e > 0:
            if e & 1:
                result = base if result is None else result.mul(base)
            e >>= 1
            if e:
                base = base.square()
        return result

    def inverse(self) -> "FieldVar":
        cs = self.cs
        p = cs.field.PARAMS.modulus
        if self._value == 0:
            raise ZeroDivisionError("in-circuit inverse of zero")
        inv_val = pow(self._value, -1, p)
        var = cs.new_witness_variable(inv_val)
        inv_lc = cs.lc((1, var))
        cs.enforce_constraint(self.lc, inv_lc, cs.lc((1, ONE)))
        return FieldVar(cs, inv_lc, inv_val)

    # -- select / equality -------------------------------------------------------

    @staticmethod
    def conditionally_select(cond: Boolean, true_v: "FieldVar", false_v: "FieldVar") -> "FieldVar":
        cs = true_v.cs
        if cond.kind == "const":
            return true_v if cond.const_value else false_v
        out_val = true_v._value if cond.value() else false_v._value
        var = cs.new_witness_variable(out_val)
        out_lc = cs.lc((1, var))
        cs.enforce_constraint(cond.lc(), true_v.lc - false_v.lc, out_lc - false_v.lc)
        return FieldVar(cs, out_lc, out_val)

    def enforce_equal(self, other: "FieldVar") -> None:
        cs = self.cs
        cs.enforce_constraint(self.lc - other.lc, cs.lc((1, ONE)), cs.lc())

    def is_eq(self, other: "FieldVar") -> Boolean:
        """1 iff equal: standard is-zero gadget on the difference."""
        cs = self.cs
        p = cs.field.PARAMS.modulus
        diff_val = (self._value - other._value) % p
        is_equal = diff_val == 0
        out = Boolean._alloc_unchecked(cs, is_equal)
        # booleanity by construction via the two constraints below:
        # diff * inv = 1 - out   and   diff * out = 0
        inv_val = pow(diff_val, -1, p) if diff_val else 0
        inv_var = cs.new_witness_variable(inv_val)
        diff_lc = self.lc - other.lc
        one_lc = cs.lc((1, ONE))
        cs.enforce_constraint(diff_lc, cs.lc((1, inv_var)), one_lc - out.lc())
        cs.enforce_constraint(diff_lc, out.lc(), cs.lc())
        return out

    # -- bits / bytes -----------------------------------------------------------

    def to_bits_le(self, num_bits: int | None = None) -> list[Boolean]:
        """Bit-decompose with booleanity + recomposition constraint."""
        cs = self.cs
        p = cs.field.PARAMS.modulus
        n = num_bits or p.bit_length()
        bits = []
        recompose = cs.lc()
        v = self._value
        for i in range(n):
            b = Boolean.new_witness(cs, (v >> i) & 1 == 1)
            bits.append(b)
            recompose.accumulate(b.lc(), pow(2, i, p))
        cs.enforce_constraint(recompose - self.lc, cs.lc((1, ONE)), cs.lc())
        return bits

    def to_bytes(self) -> list:
        """LE bytes (full repr width), as UInt8 gadgets."""
        from .uint import UIntGadget

        n_bytes = self.cs.field.PARAMS.repr_bits // 8
        bits = self.to_bits_le(n_bytes * 8)
        return [
            UIntGadget.from_bits_le(8, bits[8 * i : 8 * i + 8]) for i in range(n_bytes)
        ]

    def __repr__(self):
        return f"FieldVar(value={self._value})"
