"""Signed 8-bit circuit gadget (two's complement).

Replaces the reference's from-scratch ``Int8`` (``src/gadgets/int8.rs``),
which has no ark-r1cs-std counterpart.  Exact semantics preserved:

* ``add``: wrapping two's-complement ripple-carry (int8.rs:247-282).
* ``sub``: native ``checked_sub`` guard (raises on i8 overflow), then
  complement-add-complement (int8.rs:284-310).
* ``mul``: shift-and-add over the multiplier bits (int8.rs:312-323).
* ``div``: sign-xor + absolute values + long division + re-complement
  (int8.rs:325-386), with native divide-by-zero / compare decisions.
* ``shift_right``: arithmetic shift replicating the MSB (int8.rs:489-542).
* ``compare``: native, unconstrained-witness (the reference's soundness gap).

Port of ``simpleworks_tpu/gadgets/int8.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..r1cs.constraint_system import ConstraintSystem
from .boolean import Boolean
from .uint import Comparison, compare_ord


def _wrap_i8(v: int) -> int:
    return ((v + 128) & 0xFF) - 128


class Int8Gadget:
    __slots__ = ("cs", "bits", "_value")

    WIDTH = 8

    def __init__(self, cs, bits: list[Boolean], value: int):
        assert len(bits) == 8
        self.cs = cs
        self.bits = bits  # little-endian two's complement
        self._value = _wrap_i8(value)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def _alloc(cs: ConstraintSystem, value: int, mode: str) -> "Int8Gadget":
        value = _wrap_i8(value)
        unsigned = value & 0xFF
        maker = Boolean.new_witness if mode == "witness" else Boolean.new_input
        bits = [maker(cs, (unsigned >> i) & 1 == 1) for i in range(8)]
        return Int8Gadget(cs, bits, value)

    @staticmethod
    def new_witness(cs, value: int) -> "Int8Gadget":
        return Int8Gadget._alloc(cs, value, "witness")

    @staticmethod
    def new_input(cs, value: int) -> "Int8Gadget":
        return Int8Gadget._alloc(cs, value, "input")

    @staticmethod
    def constant(cs, value: int) -> "Int8Gadget":
        value = _wrap_i8(value)
        unsigned = value & 0xFF
        bits = [Boolean.constant((unsigned >> i) & 1 == 1, cs) for i in range(8)]
        return Int8Gadget(cs, bits, value)

    @staticmethod
    def from_bits_le(bits: list[Boolean]) -> "Int8Gadget":
        assert len(bits) == 8, "Invalid array length, should be 8"
        unsigned = 0
        for i, b in enumerate(bits):
            if b.value():
                unsigned |= 1 << i
        cs = next((b.cs for b in bits if b.cs is not None), None)
        return Int8Gadget(cs, list(bits), _wrap_i8(unsigned))

    # -- introspection --------------------------------------------------------

    def value(self) -> int:
        return self._value

    def to_bits_le(self) -> list[Boolean]:
        return list(self.bits)

    def to_bits_be(self) -> list[Boolean]:
        return list(reversed(self.bits))

    def to_bytes(self):
        from .uint import UIntGadget

        return [UIntGadget.from_bits_le(8, self.bits)]

    def is_witness(self) -> bool:
        return self.to_bits_be()[0].is_witness()

    def to_field_elements(self) -> list[int]:
        return [1 if b.value() else 0 for b in self.bits]

    # -- bitwise -----------------------------------------------------------------

    def _zip(self, other, fn):
        bits = [fn(a, b) for a, b in zip(self.bits, other.bits)]
        return Int8Gadget.from_bits_le(bits)

    def and_(self, other):
        return self._zip(other, lambda a, b: a.and_(b))

    def or_(self, other):
        return self._zip(other, lambda a, b: a.or_(b))

    def xor(self, other):
        return self._zip(other, lambda a, b: a.xor(b))

    def nand(self, other):
        return self._zip(other, lambda a, b: a.and_(b).not_())

    def nor(self, other):
        return self._zip(other, lambda a, b: a.or_(b).not_())

    def not_(self):
        return Int8Gadget.from_bits_le([b.not_() for b in self.bits])

    # -- arithmetic ----------------------------------------------------------------

    def add(self, addend: "Int8Gadget") -> "Int8Gadget":
        sum_bits: list[Boolean] = []
        carry = Boolean.constant(False)
        for augend_bit, addend_bit in zip(self.bits, addend.bits):
            sum_bits.append(carry.xor(augend_bit).xor(addend_bit))
            carry = (carry.not_().and_(augend_bit.and_(addend_bit))).or_(
                carry.and_(augend_bit.or_(addend_bit))
            )
        return Int8Gadget.from_bits_le(sum_bits)

    def sub(self, subtrahend: "Int8Gadget") -> "Int8Gadget":
        # native checked_sub guard (reference int8.rs:288-291)
        if not (-128 <= self._value - subtrahend._value <= 127):
            raise ValueError("Subtraction underflow")
        minuend_as_augend = Int8Gadget.from_bits_le([b.not_() for b in self.bits])
        partial = minuend_as_augend.add(subtrahend)
        return Int8Gadget.from_bits_le([b.not_() for b in partial.bits])

    def mul(self, multiplicand: "Int8Gadget", cs: ConstraintSystem) -> "Int8Gadget":
        product = Int8Gadget.new_witness(cs, 0)
        for i, multiplier_bit in enumerate(self.bits):
            addend = multiplicand.shift_left(i, cs)
            product = Int8Gadget.conditionally_select(
                multiplier_bit, product.add(addend), product
            )
        return product

    def div(self, divisor: "Int8Gadget", cs: ConstraintSystem) -> "Int8Gadget":
        if divisor._value == 0:
            raise ValueError("attempt to divide by zero")
        quotient = self
        aux = Int8Gadget.new_witness(cs, 0)
        dividend_sign = self.to_bits_be()[0]
        divisor_sign = divisor.to_bits_be()[0]
        result_sign = divisor_sign.xor(dividend_sign)
        one = Int8Gadget.constant(cs, 1)

        dividend_abs = Int8Gadget.conditionally_select(
            dividend_sign, to_absolute_value(self, cs), self
        )
        divisor_abs = Int8Gadget.conditionally_select(
            divisor_sign, to_absolute_value(divisor, cs), divisor
        )

        for dividend_bit in dividend_abs.to_bits_be():
            quotient = quotient.shift_left(1, cs)
            aux = Int8Gadget.conditionally_select(
                dividend_bit,
                aux.shift_left(1, cs).or_(one),
                aux.shift_left(1, cs),
            )
            is_greater = compare_ord(
                cs, divisor_abs._value, aux._value, Comparison.GREATER_THAN
            )
            quotient = Int8Gadget.conditionally_select(
                is_greater, quotient, quotient.or_(one)
            )
            if not is_greater.value():
                aux = aux.sub(divisor_abs)

        quotient = Int8Gadget.conditionally_select(
            result_sign, to_two_complement(quotient, cs), quotient
        )
        return quotient

    def compare(self, other: "Int8Gadget", comparison: str, cs: ConstraintSystem) -> Boolean:
        return compare_ord(cs, self._value, other._value, comparison)

    # -- shifts / rotates -----------------------------------------------------------

    def rotate_left(self, positions: int, cs: ConstraintSystem) -> "Int8Gadget":
        be = self.to_bits_be()
        k = positions % 8
        rotated = be[k:] + be[:k]
        for i in range(8):
            a = be[(i + positions) % 8]
            b = rotated[i]
            cs.enforce_constraint(cs.lc(), cs.lc(), a.lc() - b.lc())
        return Int8Gadget.from_bits_le(list(reversed(rotated)))

    def rotate_right(self, positions: int, cs: ConstraintSystem) -> "Int8Gadget":
        return self.rotate_left(8 - (positions % 8), cs)

    def shift_left(self, positions: int, cs: ConstraintSystem) -> "Int8Gadget":
        if positions >= 8:
            shifted_val = 0
        else:
            shifted_val = _wrap_i8((self._value << positions) & 0xFF)
        shifted = Int8Gadget.new_witness(cs, shifted_val)
        shifted_be = shifted.to_bits_be()
        primitive_be = self.to_bits_be()
        if positions >= 8:
            for c in shifted_be:
                cs.enforce_constraint(cs.lc(), cs.lc(), c.lc())
        else:
            for c in shifted_be[8 - positions :]:
                cs.enforce_constraint(cs.lc(), cs.lc(), c.lc())
            for b, a in zip(shifted_be[:positions], primitive_be[positions:]):
                cs.enforce_constraint(cs.lc(), cs.lc(), a.lc() - b.lc())
        return shifted

    def shift_right(self, positions: int, cs: ConstraintSystem) -> "Int8Gadget":
        """Arithmetic shift right: MSB replicated (reference int8.rs:489-542)."""
        msb = self.to_bits_be()[0]
        if positions >= 8:
            shifted_val = -1 if msb.value() else 0
        else:
            shifted_val = self._value >> positions  # Python >> is arithmetic
        shifted = Int8Gadget.new_witness(cs, shifted_val)
        shifted_be = shifted.to_bits_be()
        primitive_be = self.to_bits_be()
        if positions >= 8:
            for c in shifted_be:
                cs.enforce_constraint(cs.lc(), cs.lc(), c.lc() - msb.lc())
        else:
            for c in shifted_be[:positions]:
                cs.enforce_constraint(cs.lc(), cs.lc(), c.lc() - msb.lc())
            for b, a in zip(shifted_be[positions:], primitive_be[: 8 - positions]):
                cs.enforce_constraint(cs.lc(), cs.lc(), a.lc() - b.lc())
        return shifted

    # -- select / equality ------------------------------------------------------------

    @staticmethod
    def conditionally_select(cond: Boolean, true_v: "Int8Gadget", false_v: "Int8Gadget") -> "Int8Gadget":
        bits = [
            Boolean.conditionally_select(cond, t, f)
            for t, f in zip(true_v.bits, false_v.bits)
        ]
        return Int8Gadget.from_bits_le(bits)

    def enforce_equal(self, other: "Int8Gadget") -> None:
        for a, b in zip(self.bits, other.bits):
            a.enforce_equal(b)

    def is_eq(self, other: "Int8Gadget") -> Boolean:
        xnors = [a.xor(b).not_() for a, b in zip(self.bits, other.bits)]
        return Boolean.kary_nand(xnors).not_()

    def __repr__(self):
        return f"Int8({self._value})"


def to_absolute_value(negative_number: Int8Gadget, cs: ConstraintSystem) -> Int8Gadget:
    """reference src/gadgets/helpers.rs:78-94: |x| = not(x - 1)."""
    one = Int8Gadget.constant(cs, 1)
    a = negative_number.sub(one)
    return Int8Gadget.from_bits_le([b.not_() for b in a.bits])


def to_two_complement(positive_number: Int8Gadget, cs: ConstraintSystem) -> Int8Gadget:
    """reference src/gadgets/helpers.rs:96-111: -x = not(x) + 1."""
    one = Int8Gadget.constant(cs, 1)
    a = Int8Gadget.from_bits_le([b.not_() for b in positive_number.bits])
    return a.add(one)
