"""The ``test-circuit`` workload (reference ``examples/test-circuit.rs``).

Two private UInt8 witnesses constrained equal — the minimal gadget circuit
and the reference's first end-to-end milestone (satisfiability before
proving, SURVEY.md §7 PR1).

Port of ``simpleworks_tpu/examples/test_circuit.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bls12_377 import ConstraintF
from ..gadgets import UInt8Gadget
from ..r1cs.constraint_system import ConstraintSystem


@dataclass
class TestCircuit:
    """reference examples/test-circuit.rs:13-26."""

    a: int
    b: int

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        a = UInt8Gadget.new_witness(cs, self.a)
        b = UInt8Gadget.new_witness(cs, self.b)
        a.enforce_equal(b)


def synthesize(a: int, b: int) -> ConstraintSystem:
    cs = ConstraintSystem(ConstraintF)
    TestCircuit(a, b).generate_constraints(cs)
    return cs
