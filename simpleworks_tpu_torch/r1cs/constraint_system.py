"""R1CS constraint-system core.

Port of ``simpleworks_tpu/r1cs/constraint_system.py`` (pure Python, copied
so the port imports nothing of the JAX package): the replacement for
``ark-relations``' ``ConstraintSystem``, exercised by reference
``examples/manual-constraints.rs:21-28``.  The system runs on the host
during circuit synthesis and produces sparse A/B/C matrices; satisfiability
is checked exactly on the host.

Variable/column conventions match arkworks: column 0 is the constant ``One``,
columns ``1..num_instance`` are the public inputs, witnesses follow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Variable(NamedTuple):
    """A variable handle: kind in {'one', 'instance', 'witness'}."""

    kind: str
    index: int


ONE = Variable("one", 0)


class LinearCombination:
    """Sparse linear combination: {Variable: coeff (field int, canonical)}.

    Construct with ``LinearCombination(field_cls)`` (empty, the ``lc!()`` of
    arkworks) or via ``ConstraintSystem.lc(...)``.  Supports +, -, and
    scalar multiplication by field elements/ints.
    """

    __slots__ = ("field", "terms")

    def __init__(self, field_cls, terms: Optional[dict[Variable, int]] = None):
        self.field = field_cls
        self.terms: dict[Variable, int] = terms or {}

    @classmethod
    def from_terms(cls, field_cls, pairs):
        p = field_cls.PARAMS.modulus
        terms: dict[Variable, int] = {}
        for coeff, var in pairs:
            c = int(coeff) % p
            if c:
                nc = (terms.get(var, 0) + c) % p
                if nc:
                    terms[var] = nc
                else:
                    del terms[var]
        return cls(field_cls, terms)

    def accumulate(self, other, scale: int = 1) -> None:
        """self += scale·other, in place: the update ``+`` and ``-`` make on
        a copy, and ``self + other * scale`` for a scale that is not 0 mod p
        (the same terms in the same order).  A sum of many terms built this
        way costs one update a term, where ``lc = lc + term`` copies the
        growing dict every time."""
        if isinstance(other, Variable):
            other = LinearCombination.from_terms(self.field, [(1, other)])
        out = self.terms
        p = self.field.PARAMS.modulus
        for var, c in other.terms.items():
            nc = (out.get(var, 0) + scale * c) % p
            if nc:
                out[var] = nc
            elif var in out:
                del out[var]

    def _combine(self, other, sign: int):
        out = LinearCombination(self.field, dict(self.terms))
        out.accumulate(other, sign)
        return out

    def __add__(self, other):
        return self._combine(other, 1)

    def __sub__(self, other):
        return self._combine(other, -1)

    def __mul__(self, scalar: int):
        p = self.field.PARAMS.modulus
        s = int(scalar) % p
        out = {}
        for v, c in self.terms.items():
            cs = c * s % p
            if cs:
                out[v] = cs
        return LinearCombination(self.field, out)

    def is_zero(self) -> bool:
        return not self.terms

    def __repr__(self):
        return f"LC({self.terms})"


class ConstraintSystem:
    """Host-side R1CS constraint system with assigned values.

    Mirrors the API surface the reference uses: ``new_input_variable``,
    ``new_witness_variable``, ``enforce_constraint``, ``is_satisfied``,
    ``which_is_unsatisfied`` (reference examples/test-circuit.rs:38-44).
    """

    def __init__(self, field_cls):
        self.field = field_cls
        self.instance_assignment: list[int] = [1]  # One at index 0
        self.witness_assignment: list[int] = []
        self.a: list[LinearCombination] = []
        self.b: list[LinearCombination] = []
        self.c: list[LinearCombination] = []
        self.constraint_names: list[str] = []
        self._namespace_stack: list[str] = []

    # -- allocation ----------------------------------------------------------

    def new_input_variable(self, value) -> Variable:
        v = int(value) % self.field.PARAMS.modulus
        self.instance_assignment.append(v)
        return Variable("instance", len(self.instance_assignment) - 1)

    def new_witness_variable(self, value) -> Variable:
        v = int(value) % self.field.PARAMS.modulus
        self.witness_assignment.append(v)
        return Variable("witness", len(self.witness_assignment) - 1)

    # -- namespaces (the `ns!` vocabulary, used for constraint attribution) --

    def push_namespace(self, name: str) -> None:
        self._namespace_stack.append(name)

    def pop_namespace(self) -> None:
        self._namespace_stack.pop()

    class _Namespace:
        def __init__(self, cs, name):
            self.cs, self.name = cs, name

        def __enter__(self):
            self.cs.push_namespace(self.name)
            return self.cs

        def __exit__(self, *exc):
            self.cs.pop_namespace()
            return False

    def namespace(self, name: str):
        return self._Namespace(self, name)

    # -- constraints -----------------------------------------------------------

    def lc(self, *pairs) -> LinearCombination:
        """Build an LC from (coeff, Variable) pairs; ``cs.lc()`` == ``lc!()``."""
        if len(pairs) == 1:  # the common case, without from_terms' loop
            coeff, var = pairs[0]
            c = int(coeff) % self.field.PARAMS.modulus
            return LinearCombination(self.field, {var: c} if c else None)
        return LinearCombination.from_terms(self.field, pairs)

    def enforce_constraint(
        self, a: LinearCombination, b: LinearCombination, c: LinearCombination
    ) -> None:
        self.a.append(a)
        self.b.append(b)
        self.c.append(c)
        self.constraint_names.append("/".join(self._namespace_stack))

    # -- stats ------------------------------------------------------------------

    @property
    def num_constraints(self) -> int:
        return len(self.a)

    @property
    def num_instance_variables(self) -> int:
        return len(self.instance_assignment)

    @property
    def num_witness_variables(self) -> int:
        return len(self.witness_assignment)

    def num_nonzero(self) -> int:
        """max nnz over A/B/C (the Marlin SRS sizing convention)."""
        return max(
            sum(len(lc.terms) for lc in m) for m in (self.a, self.b, self.c)
        )

    # -- evaluation ---------------------------------------------------------------

    def assigned_value(self, var: Variable) -> int:
        if var.kind == "one":
            return 1
        if var.kind == "instance":
            return self.instance_assignment[var.index]
        return self.witness_assignment[var.index]

    def eval_lc(self, lc: LinearCombination) -> int:
        p = self.field.PARAMS.modulus
        acc = 0
        for var, coeff in lc.terms.items():
            acc += coeff * self.assigned_value(var)
        return acc % p

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self) -> Optional[str]:
        """Index/namespace of the first unsatisfied constraint, or None."""
        p = self.field.PARAMS.modulus
        for i in range(self.num_constraints):
            av = self.eval_lc(self.a[i])
            bv = self.eval_lc(self.b[i])
            cv = self.eval_lc(self.c[i])
            if av * bv % p != cv:
                name = self.constraint_names[i]
                return f"{i}:{name}" if name else str(i)
        return None

    # -- matrix extraction -----------------------------------------------------------

    def variable_column(self, var: Variable) -> int:
        if var.kind == "one":
            return 0
        if var.kind == "instance":
            return var.index
        return self.num_instance_variables + var.index

    def to_matrices(self):
        """Sparse COO (rows, cols, coeffs) for A, B, C plus the z layout.

        Column order: [1, instances..., witnesses...] (arkworks convention,
        consumed by the Marlin indexer and prover).
        """
        matrices = []
        for m in (self.a, self.b, self.c):
            rows, cols, coeffs = [], [], []
            for i, lc in enumerate(m):
                for var, coeff in sorted(
                    lc.terms.items(), key=lambda kv: self.variable_column(kv[0])
                ):
                    rows.append(i)
                    cols.append(self.variable_column(var))
                    coeffs.append(coeff)
            matrices.append((rows, cols, coeffs))
        return matrices

    def full_assignment(self) -> list[int]:
        """z = [1, instances..., witnesses...]"""
        return list(self.instance_assignment) + list(self.witness_assignment)
