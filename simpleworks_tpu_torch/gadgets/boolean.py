"""Boolean circuit gadget.

Replaces ``ark_r1cs_std::Boolean`` for this framework (SURVEY.md §2.3 'Base
gadget library'; reference usage throughout ``src/gadgets/``).  Three
variants, as in arkworks: a constant, an allocated bit, or the symbolic
negation of an allocated bit (NOT is free).  Allocation enforces booleanity
with the single constraint (1 - a) * a = 0.

Constraint shapes for AND/OR/XOR match arkworks':
  AND: a * b = c          OR: (1-a)(1-b) = 1-c        XOR: 2a * b = a + b - c

Port of ``simpleworks_tpu/gadgets/boolean.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..r1cs.constraint_system import ConstraintSystem, LinearCombination, Variable, ONE


class Boolean:
    __slots__ = ("cs", "kind", "variable", "const_value", "_value")

    def __init__(self, cs, kind, variable=None, const_value=None, value=None):
        self.cs = cs
        self.kind = kind  # 'const' | 'is' | 'not'
        self.variable = variable
        self.const_value = const_value
        self._value = value

    # -- constructors ------------------------------------------------------

    @staticmethod
    def constant(value: bool, cs=None) -> "Boolean":
        return Boolean(cs, "const", const_value=bool(value), value=bool(value))

    @staticmethod
    def _alloc(cs: ConstraintSystem, value: bool, mode: str) -> "Boolean":
        v = 1 if value else 0
        if mode == "witness":
            var = cs.new_witness_variable(v)
        else:
            var = cs.new_input_variable(v)
        # booleanity: (1 - a) * a = 0 (var is a new variable, never ONE)
        one_minus_a = LinearCombination(cs.field, {ONE: 1, var: cs.field.PARAMS.modulus - 1})
        cs.enforce_constraint(one_minus_a, LinearCombination(cs.field, {var: 1}),
                              LinearCombination(cs.field))
        return Boolean(cs, "is", variable=var, value=bool(value))

    @staticmethod
    def new_witness(cs: ConstraintSystem, value: bool) -> "Boolean":
        return Boolean._alloc(cs, value, "witness")

    @staticmethod
    def new_input(cs: ConstraintSystem, value: bool) -> "Boolean":
        return Boolean._alloc(cs, value, "input")

    # -- introspection -----------------------------------------------------

    def value(self) -> bool:
        return self._value

    def is_constant(self) -> bool:
        return self.kind == "const"

    def is_witness(self) -> bool:
        """reference src/gadgets/boolean.rs:6-19 — variable-kind inspection."""
        if self.kind == "const":
            return False
        return self.variable.kind == "witness"

    def lc(self) -> LinearCombination:
        cs = self.cs
        if self.kind == "const":
            field = cs.field if cs is not None else None
            if field is None:
                raise ValueError("constant Boolean with no cs context has no LC")
            return LinearCombination.from_terms(field, [(1, ONE)] if self.const_value else [])
        # the terms cs.lc((1, v)) and cs.lc((1, ONE)) - cs.lc((1, v)) give,
        # built directly (a synthesis makes millions of these)
        if self.kind == "is":
            return LinearCombination(cs.field, {self.variable: 1})
        if self.variable != ONE:
            minus_one = cs.field.PARAMS.modulus - 1
            return LinearCombination(cs.field, {ONE: 1, self.variable: minus_one})
        return cs.lc((1, ONE)) - cs.lc((1, self.variable))

    def _cs_of(self, other: "Boolean"):
        return self.cs if self.cs is not None else other.cs

    # -- logic ops -----------------------------------------------------------

    def not_(self) -> "Boolean":
        if self.kind == "const":
            return Boolean(self.cs, "const", const_value=not self.const_value, value=not self._value)
        flipped = "not" if self.kind == "is" else "is"
        return Boolean(self.cs, flipped, variable=self.variable, value=not self._value)

    def and_(self, other: "Boolean") -> "Boolean":
        cs = self._cs_of(other)
        if self.kind == "const":
            return other if self.const_value else Boolean.constant(False, cs)
        if other.kind == "const":
            return self if other.const_value else Boolean.constant(False, cs)
        out_val = self._value and other._value
        out = Boolean._alloc_unchecked(cs, out_val)
        cs.enforce_constraint(self.lc(), other.lc(), out.lc())
        return out

    def or_(self, other: "Boolean") -> "Boolean":
        cs = self._cs_of(other)
        if self.kind == "const":
            return Boolean.constant(True, cs) if self.const_value else other
        if other.kind == "const":
            return Boolean.constant(True, cs) if other.const_value else self
        return self.not_().and_(other.not_()).not_()

    def xor(self, other: "Boolean") -> "Boolean":
        cs = self._cs_of(other)
        if self.kind == "const":
            return other if not self.const_value else other.not_()
        if other.kind == "const":
            return self if not other.const_value else self.not_()
        out_val = self._value != other._value
        out = Boolean._alloc_unchecked(cs, out_val)
        # 2a * b = a + b - c (the terms and order of lc + lc and of
        # lc + lc - lc, summed in place)
        two_a = self.lc() * 2
        rhs = self.lc()
        rhs.accumulate(other.lc())
        rhs.accumulate(out.lc(), -1)
        cs.enforce_constraint(two_a, other.lc(), rhs)
        return out

    def nand(self, other: "Boolean") -> "Boolean":
        return self.and_(other).not_()

    def nor(self, other: "Boolean") -> "Boolean":
        return self.or_(other).not_()

    @staticmethod
    def kary_nand(bits: list["Boolean"]) -> "Boolean":
        """NOT(AND(bits...)) — reference src/gadgets/boolean.rs kary_nand."""
        assert bits
        acc = bits[0]
        for b in bits[1:]:
            acc = acc.and_(b)
        return acc.not_()

    @staticmethod
    def _alloc_unchecked(cs: ConstraintSystem, value: bool) -> "Boolean":
        """Allocate a bit without the booleanity constraint (results of
        AND/XOR are boolean by construction, as in arkworks)."""
        var = cs.new_witness_variable(1 if value else 0)
        return Boolean(cs, "is", variable=var, value=bool(value))

    # -- select / equality ----------------------------------------------------

    @staticmethod
    def conditionally_select(cond: "Boolean", true_v: "Boolean", false_v: "Boolean") -> "Boolean":
        cs = cond.cs or true_v.cs or false_v.cs
        if cond.kind == "const":
            return true_v if cond.const_value else false_v
        out_val = true_v._value if cond._value else false_v._value
        out = Boolean._alloc_unchecked(cs, out_val)
        # cond * (t - f) = out - f
        cs.enforce_constraint(cond.lc(), true_v.lc() - false_v.lc(), out.lc() - false_v.lc())
        return out

    def is_eq(self, other: "Boolean") -> "Boolean":
        return self.xor(other).not_()

    def enforce_equal(self, other: "Boolean") -> None:
        cs = self._cs_of(other)
        if cs is None:
            if self.const_value != other.const_value:
                raise ValueError("unsatisfiable: unequal constant booleans")
            return
        # (a - b) * 1 = 0
        cs.enforce_constraint(self.lc() - other.lc(), cs.lc((1, ONE)), cs.lc())

    def __repr__(self):
        return f"Boolean({self.kind}, value={self._value})"


TRUE = Boolean.constant(True)
FALSE = Boolean.constant(False)
